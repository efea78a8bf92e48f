"""The device an entry point runs on."""
from __future__ import annotations

from typing import Optional, Union

import torch


def entry_device(device: Optional[Union[str, torch.device]]) -> torch.device:
    """``device`` as given, else ``cuda``.  Without a CUDA device and
    without an explicit ``device`` this raises: an entry point never moves
    to the CPU unless the caller asks for it."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device (torch.cuda.is_available() is False): pass "
            "device='cpu' (--device cpu on the command line) to run on the "
            "CPU with the kernels' plain versions")
    return torch.device("cuda")
