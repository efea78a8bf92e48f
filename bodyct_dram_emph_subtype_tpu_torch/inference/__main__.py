"""Deployment entry point — Grand-Challenge algorithm contract.

    python -m bodyct_dram_emph_subtype_tpu_torch.inference \
        --scan_path /input/images/ct/ \
        --lobe_path /input/images/pulmonary-lobes/ --output_path /output

Same flags and defaults as the repository's root ``processor.py`` (the
reference ``processor.py:55-74``).  The port runs on one device; the
flags of paths it has not ported yet are accepted and refused with a
message when set to anything but their defaults.
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
                        help="always on: window/standardize/resize/ess run "
                             "on the device")
    parser.add_argument("--host_preprocess", action="store_true",
                        help="not ported yet: the host-preprocess path")
    parser.add_argument("--pad_shape", default=(160, 288, 384), type=_size,
                        help="in-plane upload buffer; a larger lung crop "
                             "raises")
    parser.add_argument("--gated_frac", default=0.8, type=float,
                        help="unused: the block-gated transport is not "
                             "ported (the upload is the raw int16 planes)")
    parser.add_argument("--device", default=None, type=str,
                        help="torch device (default: cuda if available)")
    parser.add_argument("--seed", default=0, type=int,
                        help="seed of the random weights used when --ckp "
                             "does not exist")
    parser.add_argument("--local_rank", default=0, type=int,
                        help="this argument is not used and should be ignored")
    args = parser.parse_args(argv)
    if (args.nchips or 1) != 1 or args.mesh:
        parser.error("the PyTorch port runs on one device (--nchips 1, no "
                     "--mesh)")
    if args.host_preprocess:
        parser.error("--host_preprocess is not ported to the PyTorch "
                     "package yet")

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s [%(levelname)s] %(message)s")
    from .processor import run_inference

    results = run_inference(
        scan_path=args.scan_path, lobe_path=args.lobe_path,
        output_path=args.output_path, model_arch=args.model_arch,
        ckp_path=args.ckp, target_size=args.target_size,
        batch_size=args.batch_size, workers=args.workers,
        compute_dtype=args.compute_dtype, pad_shape=args.pad_shape,
        device=args.device, seed=args.seed)
    print("results:", results)


if __name__ == "__main__":
    main()
