"""Deployment entry point — Grand-Challenge algorithm contract.

    python -m bodyct_dram_emph_subtype_tpu_torch.inference \
        --scan_path /input/images/ct/ \
        --lobe_path /input/images/pulmonary-lobes/ --output_path /output

Same flags and defaults as the repository's root ``processor.py`` (the
reference ``processor.py:55-74``); ``--host_preprocess`` takes the host
path for every scan; ``--gated_frac`` sizes the device path's gated CT
stream (a scan over it falls back alone to the host path).  ``--ckp``: a
``.ckpt``/``.pth``/``.pt``/``.npz`` weights file, or the port trainer's
checkpoint directory (its newest epoch); a path that does not exist gives
random weights from ``--seed``.

Data parallelism (``parallel/mesh.py``): ``--ngpus N`` or ``--mesh
data=N`` starts N ranks on this host, one per card (neither flag: every
visible card; ``--device cpu``: one process unless asked, gloo CPU ranks
when asked); ``--multihost`` joins torchrun's process group (``torchrun
--nproc_per_node N -m bodyct_dram_emph_subtype_tpu_torch.inference
--multihost ...``).  ``--batch_size`` is per rank.  Each rank scores its
shard of the scans and writes their heatmaps; rank 0 writes the JSONs and
prints the results and the run's statistics.  A ``--mesh`` with a
``spatial`` or ``model`` axis above 1 raises ``NotImplementedError``.  It
runs on the CUDA card and refuses to start without one unless given
``--device cpu``.
"""
import json
import logging
import re
from argparse import ArgumentParser

from ..parallel.mesh import add_distributed_args, distributed


def _size(value):
    nums = re.findall(r"-?\d+", str(value))
    if not nums:
        raise ValueError(f"cannot parse size from {value!r}")
    return tuple(int(n) for n in nums)


def main(argv=None):
    parser = ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--ngpus", "--nchips", dest="nchips", default=None,
                        type=int, help="data-parallel ranks on this host, "
                                       "one per card (default: every "
                                       "visible card)")
    parser.add_argument("--mesh", default=None, type=str,
                        help="data=N (the spatial and model axes are not "
                             "ported)")
    parser.add_argument("--model_arch", default="med3ddram", type=str)
    parser.add_argument("--workers", default=0, type=int)
    parser.add_argument("--batch_size", default=2, type=int)
    parser.add_argument("--target_size", default=(128, 224, 288), type=_size)
    parser.add_argument("--scan_path", default="/input/images/ct/", type=str)
    parser.add_argument("--lobe_path",
                        default="/input/images/pulmonary-lobes/", type=str)
    parser.add_argument("--output_path", default="/output", type=str)
    parser.add_argument("--ckp", default="best.ckpt", type=str,
                        help="a .ckpt/.pth/.pt/.npz weights file or the "
                             "trainer's checkpoint directory")
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
    add_distributed_args(parser)
    parser.add_argument("--local_rank", default=0, type=int,
                        help="this argument is not used and should be ignored")
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s [%(levelname)s] %(message)s")
    with distributed("bodyct_dram_emph_subtype_tpu_torch.inference", args,
                     argv) as place:
        if place is None:
            return
        device, rank = place
        from .processor import run_inference
        stats = {}
        results = run_inference(
            scan_path=args.scan_path, lobe_path=args.lobe_path,
            output_path=args.output_path, model_arch=args.model_arch,
            ckp_path=args.ckp, target_size=args.target_size,
            batch_size=args.batch_size, workers=args.workers,
            compute_dtype=args.compute_dtype,
            device_preprocess=not args.host_preprocess,
            pad_shape=args.pad_shape, gated_frac=args.gated_frac,
            device=device, seed=args.seed, stats=stats)
        if rank == 0:
            print("results:", results)
            print("stats:", json.dumps(stats))


if __name__ == "__main__":
    main()
