"""Training of the dRAM regression model: steps, checkpoints, the trainer
and its CLI (``python -m bodyct_dram_emph_subtype_tpu_torch.train``)."""
