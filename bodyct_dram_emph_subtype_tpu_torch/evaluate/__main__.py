"""Evaluation entry point of the PyTorch package, the counterpart of the
root ``test.py`` (reference ``test.py:18-87``):

    python -m bodyct_dram_emph_subtype_tpu_torch.evaluate --model_arch med3d \\
        --ckp 3 --data_path <archive> --test_csv <csv> --model_path ./models

``--ckp``: an epoch number restores that epoch's checkpoint under
``<model_path>/subtyping_<arch>/checkpoints``; a ``.ckpt``/``.pth``/
``.pt``/``.npz`` path loads its weights greedily (``try_resume(ckp=...)``;
a ``.pt`` is the trainer's own checkpoint), evaluated as epoch 0, as the
reference does; no ``--ckp`` takes the newest epoch's weights.  Then the
test split runs through the trainer's eval step (both strategies) and
writes ``predicts/test/<epoch>_predicts.csv``, ``metrics.jsonl``, the
confusion-matrix PNGs, the heatmap tiles and TensorBoard scalars.

The flags of ``test.py``, plus the port's ``--packed_decoder`` (the
decoder's routing, as in the training CLI), ``--device``, and the
trainer's ``--multihost``.  ``--ngpus N`` (as
``test.py:17``) evaluates on N ranks, one per card: each evaluates its
shard of the test set, rank 0 gathers them and writes the outputs.  It
runs on the CUDA card and refuses to start without one unless given
``--device cpu``.
"""
from argparse import ArgumentParser
from pathlib import Path
from typing import Optional, Sequence

from ..parallel.mesh import add_distributed_args, distributed
from ..train.__main__ import logging_to, parse_size


def build_parser() -> ArgumentParser:
    p = ArgumentParser(prog="python -m bodyct_dram_emph_subtype_tpu_torch."
                            "evaluate")
    p.add_argument("--model_arch", default="med3d", type=str)
    p.add_argument("--ngpus", "--nchips", dest="nchips", default=None,
                   type=int, help="ranks on this host, one per card "
                                  "(default: every visible card)")
    p.add_argument("--ckp", type=str, default=None,
                   help="epoch number, or a .ckpt/.pth/.pt/.npz path")
    p.add_argument("--data_path", default="./COPDGene_cache/", type=str)
    p.add_argument("--train_csv", default="./COPDGene_cache/merged.csv")
    p.add_argument("--valid_csv", default="./COPDGene_cache/merged.csv")
    p.add_argument("--test_csv", default="./COPDGene_cache/merged.csv")
    p.add_argument("--model_path", default="./models/", type=str)
    p.add_argument("--target_size", default=(128, 224, 288),
                   type=parse_size)
    p.add_argument("--workers", default=2, type=int)
    p.add_argument("--batch_size", default=4, type=int)
    p.add_argument("--compute_dtype", default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--packed_decoder", action="store_true",
                   help="the JAX packed decoder's routing: its convs on "
                        "kernel A under conv mode roll")
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; without a card pass "
                        "--device cpu, which runs the kernels' plain "
                        "versions)")
    add_distributed_args(p)
    p.add_argument("--local_rank", default=0, type=int,
                   help="this argument is not used and should be ignored")
    return p


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Run the test evaluation; returns its metrics (on rank 0; ``{}`` on
    other ranks and in the process that started the ranks)."""
    args = build_parser().parse_args(argv)
    with distributed("bodyct_dram_emph_subtype_tpu_torch.evaluate", args,
                     argv) as place:
        return {} if place is None else evaluate(args, *place)


def evaluate(args, device, rank: int) -> dict:
    from ..models.torch_import import WEIGHT_FILES
    from ..train.loop import TEST_PHASE, SubtypeTrainer, TrainerConfig
    config = TrainerConfig(
        model_arch=args.model_arch, batch_size=args.batch_size,
        target_size=tuple(args.target_size), workers=args.workers,
        data_path=args.data_path, train_csv=args.train_csv,
        valid_csv=args.valid_csv, test_csv=args.test_csv,
        model_path=args.model_path, nchips=args.nchips,
        compute_dtype=args.compute_dtype,
        packed_decoder=args.packed_decoder, device=device)
    trainer = SubtypeTrainer(config)
    with logging_to(config.exp_path, to_file=rank == 0):
        trainer.init_state()
        trainer.setup_checkpointing()
        epoch = 0
        if args.ckp is not None and Path(args.ckp).suffix in WEIGHT_FILES:
            trainer.try_resume(ckp=args.ckp)
        elif args.ckp is not None:
            epoch = int(args.ckp)
            trainer.model.load_state_dict(
                trainer.ckpt.restore(epoch)["model"])
        else:
            trainer.try_resume(reload_only_weights=True)
            epoch = trainer.ckpt.latest_epoch() or 0
        metrics = trainer.evaluate(TEST_PHASE, epoch=epoch)
        trainer.close()
        return metrics


if __name__ == "__main__":
    main()
