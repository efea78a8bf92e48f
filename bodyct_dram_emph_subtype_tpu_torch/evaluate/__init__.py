"""Evaluation of a trained checkpoint on the test split (CLI: ``python -m
bodyct_dram_emph_subtype_tpu_torch.evaluate``)."""
