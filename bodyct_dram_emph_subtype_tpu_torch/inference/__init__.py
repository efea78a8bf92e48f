"""Deployment inference (``run_inference``; CLI: ``python -m
bodyct_dram_emph_subtype_tpu_torch.inference``)."""
from .processor import build_model, run_inference

__all__ = ["build_model", "run_inference"]
