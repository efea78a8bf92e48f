"""Operations and bytes of a cell's work, counted on the plain reference.

The count is taken from ``reference/model.py`` at the cell's shapes, never
from the program, so a roofline or an MFU reads the same work whatever
implements it.

- :func:`model_flops`: ``FlopCounterMode`` over the reference forward (and
  for training a backward of its outputs) on fake tensors: shapes only, no
  memory.  It counts the convolutions and their gradients (the resizes are
  not matrix products in the reference, and elementwise work is not
  counted).
- :func:`conv_ops`: every convolution of one forward (training: forward,
  input gradient and weight gradient) with its FLOPs and the bytes it must
  move at least: each input read once and each output written once, in the
  compute dtype.
- :func:`roofline_seconds`: the least time of a list of ops on a chip with
  the given peaks: per op the larger of FLOPs over the FLOP peak and bytes
  over the memory peak, summed.
"""
from __future__ import annotations

import functools
import math
from typing import Dict, List, Sequence, Tuple

import torch

from .reference import model as ref_model


@functools.lru_cache(maxsize=None)
def model_flops(arch: str, shape: Tuple[int, ...], train: bool) -> float:
    """FLOPs of one reference forward (``train``: forward and backward,
    batch statistics) at input ``shape`` (B, 1, D, H, W)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    with FakeTensorMode():
        params = {}
        for key, c, o, k, _, _, _, bias, bn in ref_model.conv_table(arch):
            params[f"{key}.weight"] = torch.empty((o, c, k, k, k),
                                                  requires_grad=train)
            if bias:
                params[f"{key}.bias"] = torch.empty(o, requires_grad=train)
            if bn:
                for name in ("weight", "bias"):
                    params[f"{bn}.{name}"] = torch.empty(
                        o, requires_grad=train)
                params[f"{bn}.running_mean"] = torch.empty(o)
                params[f"{bn}.running_var"] = torch.empty(o)
        x = torch.empty(shape)
        lung = torch.empty(shape)
        counter = FlopCounterMode(display=False)
        with counter:
            if train:
                dense, fracs = ref_model.forward(params, arch, x, lung,
                                                 train=True)
                (sum(d.sum() for d in dense) + sum(f.sum() for f in fracs)
                 ).backward()
            else:
                with torch.no_grad():
                    ref_model.forward(params, arch, x, lung)
        return float(counter.get_total_flops())


def _conv_out(n: int, k: int, s: int, p: int, d: int) -> int:
    return (n + 2 * p - d * (k - 1) - 1) // s + 1


def conv_ops(arch: str, shape: Sequence[int], train: bool,
             itemsize: int = 2) -> List[Dict[str, float]]:
    """``[{"name", "kind", "flops", "bytes"}]`` of every convolution of
    one forward at input ``shape`` (B, 1, D, H, W); ``train`` adds each
    conv's ``dgrad`` (not the stem's: the input takes no gradient) and
    ``wgrad``.  The spatial sizes follow the reference
    network (stem /2, pool /2, layer2 /2, decoder x2 x2)."""
    b, _, *size = shape
    size = tuple(size)
    sizes = {}
    stem = tuple(_conv_out(n, 7, 2, 3, 1) for n in size)
    pooled = tuple(_conv_out(n, 3, 2, 1, 1) for n in stem)
    ops = []
    cur = size
    for key, c, o, k, s, p, d, _, _ in ref_model.conv_table(arch):
        if key == "conv1":
            cur = size
        elif key == "layer1.0.conv1":
            cur = pooled
        elif key == "us1.conv_blocks.0.0":
            cur = tuple(2 * n for n in sizes["x4"])
        elif key == "us2.conv_blocks.0.0":
            cur = stem
        out = tuple(_conv_out(n, k, s, p, d) for n in cur)
        vin, vout = b * math.prod(cur), b * math.prod(out)
        flops = 2.0 * vout * o * c * k ** 3
        x_b, w_b, y_b = vin * c * itemsize, o * c * k ** 3 * itemsize, \
            vout * o * itemsize
        ops.append({"name": key, "kind": "fprop", "flops": flops,
                    "bytes": float(x_b + w_b + y_b)})
        if train and key != "conv1":     # the input takes no gradient
            ops.append({"name": key, "kind": "dgrad", "flops": flops,
                        "bytes": float(y_b + w_b + x_b)})
        if train:
            ops.append({"name": key, "kind": "wgrad", "flops": flops,
                        "bytes": float(x_b + y_b + w_b)})
        cur = out
        if key.startswith("layer"):
            sizes["x4"] = out
    return ops


def roofline_seconds(ops, peak_flops: float, peak_bytes: float
                     ) -> Tuple[float, float]:
    """(least seconds, the share of them bound by compute)."""
    total = compute = 0.0
    for op in ops:
        t_c, t_m = op["flops"] / peak_flops, op["bytes"] / peak_bytes
        total += max(t_c, t_m)
        compute += t_c if t_c >= t_m else 0.0
    return total, (compute / total if total else 0.0)
