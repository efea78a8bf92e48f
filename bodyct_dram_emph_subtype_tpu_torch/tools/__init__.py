"""The repository's tools on the port's host layer and torch, without
JAX: ``python -m bodyct_dram_emph_subtype_tpu_torch.tools.<name>`` with
``build_cache``, ``convert_checkpoint``, ``compute_label_statistics`` and
``compute_computation_complexity`` (counterparts of the root ``tools/``)."""
