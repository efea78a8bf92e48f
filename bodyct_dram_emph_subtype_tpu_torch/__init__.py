"""PyTorch + CUDA port of the emphysema-subtyping (dRAM) system for NVIDIA
Hopper GPUs.

It stands beside the JAX package ``bodyct_dram_emph_subtype_tpu`` (the
reference, which it never imports) and mirrors its subpackages and module
names, so each function's counterpart is found under the same path:

- :mod:`.ops` — the hand-written CUDA kernels (``csrc/``) with their
  plain PyTorch versions, and the plain tensor ops around them;
- :mod:`.models` — the med3d ResNet / dRAM model as ``nn.Module``s whose
  state-dict keys are the reference checkpoint's;
- :mod:`.data` — the numpy host layer (MetaImage codec, loader, datasets);
- :mod:`.inference` — the deployment processor (``run_inference`` and
  ``python -m bodyct_dram_emph_subtype_tpu_torch.inference``).

Public functions keep the JAX package's NDHWC layout.
"""

__version__ = "0.1.0"
