"""Every-epoch checkpoints of the trainer.

Counterpart of ``bodyct_dram_emph_subtype_tpu/train/checkpoint.py``
(reference ``ModelCheckpoint(save_top_k=-1, every_n_epochs=1)``,
``train.py:92-99``): each epoch ``torch.save``s the model state, the
optimizer state, the epoch, the class weights and the epoch's train
metrics to
``<directory>/epoch_<n>.pt``; :meth:`CheckpointManager.latest_epoch` and
:meth:`CheckpointManager.restore` serve the auto-resume and
``restore_best`` of the trainer.  The files hold tensors and plain Python
values only and are read back with ``weights_only=True``.
"""
from __future__ import annotations

import os
import re
from pathlib import Path
from typing import Any, Dict, Optional, Sequence

import torch

_NAME = re.compile(r"epoch_(\d+)\.pt")


def _state(obj):
    return obj if isinstance(obj, dict) else obj.state_dict()


class CheckpointManager:
    def __init__(self, directory):
        self.directory = Path(directory).absolute()
        self.directory.mkdir(parents=True, exist_ok=True)

    def path(self, epoch: int) -> Path:
        return self.directory / f"epoch_{int(epoch):04d}.pt"

    def save(self, epoch: int, model, optimizer,
             cle_class_weights: Sequence[float],
             pse_class_weights: Sequence[float],
             metrics: Optional[Dict[str, float]] = None) -> Path:
        """``model`` and ``optimizer``: the module and optimizer, or their
        state dicts (a model-axis rank passes the gathered full ones)."""
        payload = {"epoch": int(epoch), "model": _state(model),
                   "optimizer": _state(optimizer),
                   "cle_class_weights": [float(w) for w in cle_class_weights],
                   "pse_class_weights": [float(w) for w in pse_class_weights],
                   "metrics": {k: float(v)
                               for k, v in (metrics or {}).items()}}
        target = self.path(epoch)
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        torch.save(payload, tmp)
        os.replace(tmp, target)
        return target

    def epochs(self):
        found = (_NAME.fullmatch(p.name) for p in self.directory.iterdir())
        return sorted(int(m.group(1)) for m in found if m)

    def latest_epoch(self) -> Optional[int]:
        epochs = self.epochs()
        return epochs[-1] if epochs else None

    def restore(self, epoch: Optional[int] = None) -> Dict[str, Any]:
        """The saved payload of ``epoch`` (default the latest), on the
        CPU."""
        epoch = self.latest_epoch() if epoch is None else epoch
        if epoch is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        return torch.load(self.path(epoch), map_location="cpu",
                          weights_only=True)
