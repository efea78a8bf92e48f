"""Training of both strategies (dRAM regression, classification): steps,
checkpoints, the trainer and its CLI (``python -m
bodyct_dram_emph_subtype_tpu_torch.train``), and the deployment predict
step."""
from .steps import make_predict_step

__all__ = ["make_predict_step"]
