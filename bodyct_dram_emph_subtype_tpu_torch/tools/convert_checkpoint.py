"""Checkpoint interop: a torch ``.ckpt``/``.pth`` to a flat ``.npz`` or to
the port trainer's checkpoint directory.

Counterpart of the root ``tools/convert_checkpoint.py``:

- ``--to_npz``: the checkpoint's state dict (a Lightning ``state_dict``
  envelope unwrapped, keys ``model.*`` kept, reference ``models.py:408``)
  as a flat ``.npz`` of numpy arrays (bfloat16 widened to float32), which
  ``--ckp`` of the processor and the trainers loads greedily;
- ``--to_port DIR --arch A [--epoch N]``, in place of the JAX tool's
  ``--to_orbax``: the checkpoint loaded greedily into a fresh ``A`` model
  (weights from seed 0 where it has no entry), written with a fresh Adam
  state and uniform class weights as ``DIR/epoch_<N>.pt`` through the
  trainer's ``CheckpointManager``.  The processor given ``--ckp DIR``
  restores it ("train -> deploy"), and the trainer resumes from it when
  ``DIR`` is its ``<model_path>/subtyping_<arch>/checkpoints``.

    python -m bodyct_dram_emph_subtype_tpu_torch.tools.convert_checkpoint \\
        --src best.ckpt --to_npz best.npz
    python -m bodyct_dram_emph_subtype_tpu_torch.tools.convert_checkpoint \\
        --src best.ckpt --arch med3ddram \\
        --to_port models/subtyping_med3ddram/checkpoints

The source is a pickle (``torch.load(weights_only=False)``, as the
reference loads it): convert only checkpoints from a trusted source.
"""
import argparse
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..models.registry import get_model_by_name
from ..models.torch_import import (load_state_dict_greedy,
                                   read_torch_state_dict)
from ..train.checkpoint import CheckpointManager
from ..train.state import make_optimizer


def state_dict_arrays(path: str) -> Dict[str, np.ndarray]:
    """The tensors of the checkpoint's state dict as numpy arrays."""
    return {k: (v.float() if v.dtype == torch.bfloat16 else v).numpy()
            for k, v in read_torch_state_dict(path).items()
            if isinstance(v, torch.Tensor)}


def main(argv: Optional[Sequence[str]] = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--src", required=True,
                        help="torch .ckpt/.pth checkpoint")
    parser.add_argument("--to_npz", type=str)
    parser.add_argument("--to_port", type=str,
                        help="the port trainer's checkpoint directory")
    parser.add_argument("--arch", default="med3ddram")
    parser.add_argument("--epoch", default=0, type=int)
    args = parser.parse_args(argv)

    state_dict = state_dict_arrays(args.src)
    print(f"loaded {len(state_dict)} entries from {args.src}")
    if args.to_npz:
        np.savez_compressed(args.to_npz, **state_dict)
        print(f"wrote {args.to_npz}")
    if args.to_port:
        model = get_model_by_name(
            args.arch, generator=torch.Generator().manual_seed(0))
        report = load_state_dict_greedy(model, state_dict)
        print("conversion report:", report)
        path = CheckpointManager(args.to_port).save(
            args.epoch, model, make_optimizer(model.parameters()),
            np.ones(6) / 6, np.ones(3) / 3)
        print(f"wrote {path}")


if __name__ == "__main__":
    main()
