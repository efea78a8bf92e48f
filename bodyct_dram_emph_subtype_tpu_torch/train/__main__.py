"""Training entry point of the PyTorch package:

    python -m bodyct_dram_emph_subtype_tpu_torch.train --model_arch med3ddram \\
        --data_path <archive> --train_csv <csv> --valid_csv <csv> \\
        --test_csv <csv> --model_path ./models --batch_size 2 \\
        --compute_dtype bfloat16

The flags of the root ``train.py`` that this slice supports, and the same
flow (``train.py:123-133``): ``init_state`` -> ``setup_checkpointing`` ->
``try_resume`` -> ``fit`` -> ``restore_best`` -> ``evaluate("test")``.
Both strategies run: dRAM regression for the ``med3ddram*`` archs, the
classification strategy (weighted cross entropy, adaptive class
re-weighting) for ``med3d``, ``med3d18``, ``med3d50`` and ``med3dtiny``.
``--input_pipeline device --pad_shape D,H,W`` trains and evaluates on raw
int16 volumes padded to ``pad_shape``, preprocessed on the device (without
``--pad_shape`` it raises ``ValueError``).

Data parallelism (``parallel/mesh.py``): ``--ngpus N`` or ``--mesh
data=N`` starts N ranks on this host, one per card (without either flag,
every visible card); ``--multihost`` joins the process group that
torchrun's environment describes (``torchrun --nproc_per_node 8 -m
bodyct_dram_emph_subtype_tpu_torch.train --multihost ...``).  NCCL on the
cards, gloo with ``--device cpu`` or when a host runs more ranks than it
has cards.  ``--batch_size`` is per rank.  Rank 0 alone writes the
checkpoints, CSVs, ``metrics.jsonl``, ``debug.log`` and the artifacts:
``confusion_matrices/``, ``debug_input_data/`` (heatmap tiles),
``tb_logs/`` (TensorBoard); ``--profile`` writes one ``torch.profiler``
Chrome trace of epoch 0 per rank to ``profile/rank<r>.json``;
``--debug_nans`` turns on anomaly detection and raises
``FloatingPointError`` at the first non-finite loss or gradient.

Refused with ``NotImplementedError``: a ``--mesh`` with a ``spatial`` or
``model`` axis above 1, ``--grad_accum`` above 1 on more than one rank,
``--remat`` other than ``none`` and ``--noise_rng rbg``; the plain
``resnet34``/``resnet50`` raise ``ValueError`` (no lung mask: the JAX
trainer cannot train them either).  ``--packed_decoder`` reaches the model
(under conv mode ``roll`` its decoder convs then run on kernels A/D, as
the JAX packed decoder's run on its roll kernels; outside ``roll`` on
cuDNN, as JAX's run on XLA; without the flag the decoder runs on cuDNN).
The conv mode comes from ``$BODYCT_CONV3D_MODE`` (default ``roll``).  It
runs on the CUDA card and refuses to start without one unless given
``--device cpu``, which runs every kernel site's plain version.
"""
import contextlib
import logging
from argparse import ArgumentParser
from pathlib import Path
from typing import Optional, Sequence

from ..parallel.mesh import add_distributed_args, distributed  # noqa: F401


def parse_size(text: str):
    return tuple(int(v) for v in text.replace("x", ",").split(","))


@contextlib.contextmanager
def logging_to(exp_path: Path, to_file: bool = True):
    """Root logging at INFO to ``exp_path/debug.log`` (``to_file``: rank 0)
    and the console while the block runs (the reference's ``debug.log``)."""
    exp_path.mkdir(parents=True, exist_ok=True)
    root = logging.getLogger()
    handlers = [logging.StreamHandler()]
    if to_file:
        handlers.append(logging.FileHandler(exp_path / "debug.log"))
    for handler in handlers:
        handler.setFormatter(logging.Formatter(
            "%(asctime)s [%(levelname)s] %(message)s"))
        root.addHandler(handler)
    if root.level > logging.INFO or root.level == logging.NOTSET:
        root.setLevel(logging.INFO)
    try:
        yield
    finally:
        for handler in handlers:
            root.removeHandler(handler)
            handler.close()


def build_parser() -> ArgumentParser:
    p = ArgumentParser(prog="python -m bodyct_dram_emph_subtype_tpu_torch."
                            "train")
    p.add_argument("--model_arch", default="med3ddram50", type=str)
    p.add_argument("--lr", "--learning-rate", default=0.0001, type=float)
    p.add_argument("--ngpus", "--nchips", dest="nchips", default=None,
                   type=int, help="data-parallel ranks on this host, one "
                                  "per card (default: every visible card)")
    p.add_argument("--mesh", default=None, type=str,
                   help="data=N (the spatial and model axes are not "
                        "ported)")
    p.add_argument("--momentum", default=None, type=float,
                   help="ignored (reference parity: Adam uses lr only)")
    p.add_argument("--reload_only_weights", default=1, type=int)
    p.add_argument("--weight_decay", default=None, type=float,
                   help="ignored (reference parity: Adam uses lr only)")
    p.add_argument("--ckp", type=str, default=None)
    p.add_argument("--target_size", default=(128, 224, 288),
                   type=parse_size)
    p.add_argument("--data_path", default="./COPDGene_cache/", type=str)
    p.add_argument("--train_csv", default="./COPDGene_cache/merged.csv")
    p.add_argument("--valid_csv", default="./COPDGene_cache/merged.csv")
    p.add_argument("--test_csv", default="./COPDGene_cache/merged.csv")
    p.add_argument("--model_path", default="./models/", type=str)
    p.add_argument("--workers", default=2, type=int)
    p.add_argument("--batch_size", default=1, type=int)
    p.add_argument("--num_samples", default=128, type=int)
    p.add_argument("--max_epochs", default=120, type=int)
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--sampler_seed", default=None, type=int,
                   help="fixed sampler seed (default: wall clock, as the "
                        "reference)")
    p.add_argument("--compute_dtype", default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--input_pipeline", default="host",
                   choices=["host", "device"],
                   help="host: the loader threads preprocess; device: they "
                        "pad raw int16 volumes to --pad_shape and the card "
                        "preprocesses them in the train and eval steps")
    p.add_argument("--pad_shape", default=None, type=parse_size,
                   help="D,H,W buffer of --input_pipeline device; a larger "
                        "scan raises ValueError")
    add_distributed_args(p)
    p.add_argument("--profile", action="store_true",
                   help="torch.profiler trace of epoch 0 per rank, under "
                        "<model_path>/subtyping_<arch>/profile")
    p.add_argument("--debug_nans", action="store_true",
                   help="anomaly detection; FloatingPointError at the first "
                        "non-finite loss or gradient")
    p.add_argument("--remat", default="none", type=str,
                   help="only 'none' is ported")
    p.add_argument("--noise_rng", default="threefry",
                   choices=["threefry", "rbg"])
    p.add_argument("--grad_accum", default=1, type=int)
    p.add_argument("--packed_decoder", action="store_true",
                   help="the JAX packed decoder's routing: its convs on "
                        "kernels A/D under conv mode roll, on cuDNN "
                        "outside it")
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; without a card pass "
                        "--device cpu, which runs the kernels' plain "
                        "versions)")
    p.add_argument("--local_rank", default=0, type=int,
                   help="this argument is not used and should be ignored")
    return p


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    with distributed("bodyct_dram_emph_subtype_tpu_torch.train", args,
                     argv) as place:
        if place is not None:
            train(args, *place)
    return 0


def make_config(args, device: Optional[str]):
    """The :class:`~.loop.TrainerConfig` of the parsed flags, on
    ``device``."""
    from .loop import TrainerConfig
    return TrainerConfig(
        model_arch=args.model_arch, lr=args.lr, max_epochs=args.max_epochs,
        batch_size=args.batch_size, num_samples=args.num_samples,
        target_size=tuple(args.target_size), workers=args.workers,
        data_path=args.data_path, train_csv=args.train_csv,
        valid_csv=args.valid_csv, test_csv=args.test_csv,
        model_path=args.model_path, nchips=args.nchips, seed=args.seed,
        sampler_seed=args.sampler_seed, compute_dtype=args.compute_dtype,
        input_pipeline=args.input_pipeline, pad_shape=args.pad_shape,
        mesh=args.mesh,
        remat=args.remat, noise_rng=args.noise_rng,
        grad_accum=args.grad_accum, packed_decoder=args.packed_decoder,
        profile=args.profile, debug_nans=args.debug_nans, device=device)


def train(args, device: Optional[str], rank: int) -> None:
    """``train.py``'s flow on this rank."""
    from .loop import SubtypeTrainer
    config = make_config(args, device)
    trainer = SubtypeTrainer(config)
    with logging_to(config.exp_path, to_file=rank == 0):
        if args.momentum is not None or args.weight_decay is not None:
            logging.warning("--momentum/--weight_decay are ignored: the "
                            "optimizer is Adam(lr), as in the reference")
        trainer.init_state()
        trainer.setup_checkpointing()
        trainer.try_resume(reload_only_weights=bool(args.reload_only_weights),
                           ckp=args.ckp)
        trainer.fit()
        best_epoch = trainer.restore_best()
        trainer.evaluate("test", epoch=best_epoch)
        trainer.close()


if __name__ == "__main__":
    raise SystemExit(main())
