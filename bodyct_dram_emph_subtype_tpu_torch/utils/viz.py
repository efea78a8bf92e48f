"""Host visualization helpers (numpy).

Copy of ``bodyct_dram_emph_subtype_tpu/utils/viz.py::windowing``
(reference ``utils.py:28-37``); the heatmap tiles and confusion matrices
come with the eval slice.
"""
from __future__ import annotations

import numpy as np


def windowing(image: np.ndarray, from_span=(-1150, 350), to_span=(0, 255)
              ) -> np.ndarray:
    """NumPy HU windowing (``utils.py:28-37``)."""
    if from_span is None:
        lo, hi = np.min(image), np.max(image)
    else:
        lo, hi = from_span
    image = np.clip(image, lo, hi)
    return ((image - lo) / float(hi - lo)) * (to_span[1] - to_span[0]) + to_span[0]
