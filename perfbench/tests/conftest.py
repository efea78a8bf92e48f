import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


@pytest.fixture(autouse=True)
def _no_tensorboard(monkeypatch):
    """The trainer's TensorBoard writer imports TensorFlow where it is
    installed: slow, and nothing here reads it."""
    from bodyct_dram_emph_subtype_tpu_torch.train import loop
    monkeypatch.setattr(loop.SubtypeTrainer, "tb_writer",
                        property(lambda self: None))
