"""Deployment entry point — Grand-Challenge algorithm contract.

    python -m bodyct_dram_emph_subtype_tpu_torch.inference \
        --scan_path /input/images/ct/ \
        --lobe_path /input/images/pulmonary-lobes/ --output_path /output

Same flags and defaults as the repository's root ``processor.py`` (the
reference ``processor.py:55-74``); ``--host_preprocess`` takes the host
path for every scan; ``--gated_frac`` sizes the device path's gated CT
stream (a scan over it falls back alone to the host path).  The port runs
on one CUDA device (``--device cpu`` on request); the flags of paths it
has not ported yet are accepted and refused with a message when set to
anything but their defaults.
"""
import logging
import re
from argparse import ArgumentParser


def _size(value):
    nums = re.findall(r"-?\d+", str(value))
    if not nums:
        raise ValueError(f"cannot parse size from {value!r}")
    return tuple(int(n) for n in nums)


def main(argv=None):
    parser = ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--ngpus", "--nchips", dest="nchips", default=None,
                        type=int, help="devices; the port runs on one")
    parser.add_argument("--mesh", default=None, type=str,
                        help="not ported: the port runs on one device")
    parser.add_argument("--model_arch", default="med3ddram", type=str)
    parser.add_argument("--workers", default=0, type=int)
    parser.add_argument("--batch_size", default=2, type=int)
    parser.add_argument("--target_size", default=(128, 224, 288), type=_size)
    parser.add_argument("--scan_path", default="/input/images/ct/", type=str)
    parser.add_argument("--lobe_path",
                        default="/input/images/pulmonary-lobes/", type=str)
    parser.add_argument("--output_path", default="/output", type=str)
    parser.add_argument("--ckp", default="best.ckpt", type=str,
                        help="reference torch .ckpt/.pth weights")
    parser.add_argument("--compute_dtype", default="bfloat16",
                        choices=["float32", "bfloat16"])
    parser.add_argument("--device_preprocess", action="store_true",
                        default=True,
                        help="the default: window/standardize/resize/ess "
                             "run on the device")
    parser.add_argument("--host_preprocess", action="store_true",
                        help="preprocess every scan on the host (the strict "
                             "reference-parity path)")
    parser.add_argument("--pad_shape", default=(160, 288, 384), type=_size,
                        help="in-plane upload buffer of the device path; "
                             "larger crops fall back per scan to the host "
                             "path")
    parser.add_argument("--gated_frac", default=0.8, type=float,
                        help="capacity of the device path's block-gated CT "
                             "stream as a fraction of the upload buffer's "
                             "blocks; a scan with more live blocks falls "
                             "back to the host path")
    parser.add_argument("--device", default=None, type=str,
                        help="torch device (default cuda; without a card "
                             "pass --device cpu, which runs the kernels' "
                             "plain versions)")
    parser.add_argument("--seed", default=0, type=int,
                        help="seed of the random weights used when --ckp "
                             "does not exist")
    parser.add_argument("--local_rank", default=0, type=int,
                        help="this argument is not used and should be ignored")
    args = parser.parse_args(argv)
    if (args.nchips or 1) != 1 or args.mesh:
        parser.error("the PyTorch port runs on one device (--nchips 1, no "
                     "--mesh)")

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s [%(levelname)s] %(message)s")
    from .processor import run_inference

    results = run_inference(
        scan_path=args.scan_path, lobe_path=args.lobe_path,
        output_path=args.output_path, model_arch=args.model_arch,
        ckp_path=args.ckp, target_size=args.target_size,
        batch_size=args.batch_size, workers=args.workers,
        compute_dtype=args.compute_dtype,
        device_preprocess=not args.host_preprocess,
        pad_shape=args.pad_shape, gated_frac=args.gated_frac,
        device=args.device, seed=args.seed)
    print("results:", results)


if __name__ == "__main__":
    main()
