"""Plain PyTorch reference of the dRAM segmentation-regression model.

The reference ``med3d.py`` ResNet-34/50 seg-reg networks (``conf/
med3ddram.yaml``: ``resnet34segreg``; ``conf/med3ddram50.yaml``:
``resnet50segreg``), written as functions of a state dict whose keys are
the reference checkpoint's: conv1 k7 s2 -> BN -> ReLU -> max-pool k3 s2
-> layer1 (64) -> layer2 (128, stride 2) -> layer3 (256, dilation 2) ->
layer4 (512, dilation 4), shortcut type 'A' (strided subsample, channels
zero-padded); us1 (x2 trilinear, align_corners, crop-concat with layer1,
two conv-BN-ReLU), us2 (x2, concat with the stem, two conv-BN-ReLU), us3
(conv 64->32, BN, ReLU), two 1x1x1 sigmoid heads at half the input
resolution, and the lung-masked lesion fractions (the lung nearest-resized
to the maps).  NCDHW, float32, TF32 off (:func:`strict_float32`).

``prec``: ``"f32"`` (the reference); ``"bf16"`` (every conv in bfloat16,
its output rounded to bfloat16, and in training its backward in bfloat16:
the configurations' precision, a witness of its rounding); ``"fp8"`` (the
control: every conv reads its input and weight rounded to float8 e4m3 with
one scale per tensor, accumulates in float32 and rounds its output to
bfloat16; in training the gradient reaching each conv's output is rounded
to float8 e5m2 with one scale per tensor, and the rounding of the forward
passes the gradient straight through).

:func:`calibrate_bn`: the BatchNorm running statistics of untrained
weights set to the batch statistics of one input, as training would leave
them, so that the eval forward's activations are normalised and its
sigmoid maps are neither saturated nor flat whatever the seed.

Nothing here imports the program under test.
"""
from __future__ import annotations

import contextlib
import functools
import math
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

# factory -> (block, blocks per layer); the reference's arch names map to
# the factories as in conf/*.yaml
ARCHS = {
    "resnet18segreg": ("basic", (2, 2, 2, 2)),
    "resnet34segreg": ("basic", (3, 4, 6, 3)),
    "resnet50segreg": ("bottleneck", (3, 4, 6, 3)),
    "resnettinysegreg": ("basic", (1, 1, 1, 1)),
}
ARCH_FACTORY = {"med3ddram": "resnet34segreg", "med3ddram18": "resnet18segreg",
                "med3ddram50": "resnet50segreg",
                "med3ddramtiny": "resnettinysegreg"}
LAYERS = ((64, 1, 1), (128, 2, 1), (256, 1, 2), (512, 1, 4))
BN_EPS = 1e-5
FP8_MAX = 448.0


@contextlib.contextmanager
def strict_float32():
    """Float32 convolutions and matmuls in float32, not TF32, inside the
    block; the flags as they were after it."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


def conv_table(arch: str) -> List[Tuple[str, int, int, int, int, int, int,
                                        bool, str]]:
    """Every conv of ``arch`` in forward order: (key prefix, C, O, kernel,
    stride, padding, dilation, bias, BN key prefix or '')."""
    block, counts = ARCHS[ARCH_FACTORY.get(arch, arch)]
    exp = 4 if block == "bottleneck" else 1
    out = [("conv1", 1, 64, 7, 2, 3, 1, False, "bn1")]
    inplanes = 64
    for li, (planes, stride, dil) in enumerate(LAYERS):
        for i in range(counts[li]):
            s = stride if i == 0 else 1
            pre = f"layer{li + 1}.{i}"
            if block == "basic":
                out += [(f"{pre}.conv1", inplanes, planes, 3, s, dil, dil,
                         False, f"{pre}.bn1"),
                        (f"{pre}.conv2", planes, planes, 3, 1, dil, dil,
                         False, f"{pre}.bn2")]
            else:
                out += [(f"{pre}.conv1", inplanes, planes, 1, 1, 0, 1, False,
                         f"{pre}.bn1"),
                        (f"{pre}.conv2", planes, planes, 3, s, dil, dil,
                         False, f"{pre}.bn2"),
                        (f"{pre}.conv3", planes, planes * 4, 1, 1, 0, 1,
                         False, f"{pre}.bn3")]
            inplanes = planes * exp
    cat = 512 * exp + 64 * exp
    out += [("us1.conv_blocks.0.0", cat, 64, 3, 1, 1, 1, True,
             "us1.conv_blocks.0.1"),
            ("us1.conv_blocks.1.0", 64, 64, 3, 1, 1, 1, True,
             "us1.conv_blocks.1.1"),
            ("us2.conv_blocks.0.0", 128, 64, 3, 1, 1, 1, True,
             "us2.conv_blocks.0.1"),
            ("us2.conv_blocks.1.0", 64, 64, 3, 1, 1, 1, True,
             "us2.conv_blocks.1.1"),
            ("us3.0", 64, 32, 3, 1, 1, 1, True, "us3.1"),
            ("fcs.0", 32, 1, 1, 1, 0, 1, True, ""),
            ("fcs.1", 32, 1, 1, 1, 0, 1, True, "")]
    return out


def make_weights(arch: str, seed: int, device, head_std: float,
                 head_bias: float = 0.0) -> Dict[str, torch.Tensor]:
    """A state dict for ``arch`` drawn from ``seed`` on ``device`` in one
    call: conv kernels He-normal over fan-out (the reference init), biases
    zero, BatchNorm identity; the two 1x1x1 heads N(0, ``head_std``) less
    their mean over the 32 inputs (us3's outputs, after a ReLU, share a
    positive part that a head's weight sum would carry into every logit),
    with the bias ``head_bias``."""
    table = conv_table(arch)
    shapes = [(o, c, k, k, k) for _, c, o, k, *_ in table]
    sizes = [math.prod(s) for s in shapes]
    gen = torch.Generator(device).manual_seed(int(seed))
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    sd: Dict[str, torch.Tensor] = {}
    for (key, c, o, k, _, _, _, bias, bn), shape, chunk in zip(
            table, shapes, torch.split(flat, sizes)):
        std = head_std if key.startswith("fcs.") else math.sqrt(
            2.0 / (o * k ** 3))
        w = chunk * std
        if key.startswith("fcs."):
            w = w - w.mean()
        sd[f"{key}.weight"] = w.reshape(shape)
        if bias:
            sd[f"{key}.bias"] = torch.full(
                (o,), head_bias if key.startswith("fcs.") else 0.0,
                device=device)
        if bn:
            sd[f"{bn}.weight"] = torch.ones(o, device=device)
            sd[f"{bn}.bias"] = torch.zeros(o, device=device)
            sd[f"{bn}.running_mean"] = torch.zeros(o, device=device)
            sd[f"{bn}.running_var"] = torch.ones(o, device=device)
            sd[f"{bn}.num_batches_tracked"] = torch.zeros(
                (), dtype=torch.long, device=device)
    return sd


def _round8(t: torch.Tensor, dtype, top: float) -> torch.Tensor:
    scale = t.abs().amax().clamp_min(1e-30) / top
    return (t / scale).to(dtype).to(t.dtype) * scale


def _fp8(t: torch.Tensor) -> torch.Tensor:
    return t + (_round8(t.detach(), torch.float8_e4m3fn, FP8_MAX)
                - t).detach()


class _GradFp8(torch.autograd.Function):
    """Identity forward; the gradient rounded to float8 e5m2 (one scale
    per tensor) on its way back."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _round8(g, torch.float8_e5m2, 57344.0)


def conv(x, w, b, stride, pad, dil, prec: str):
    if prec == "fp8":
        y = F.conv3d(_fp8(x), _fp8(w), None, stride, pad, dil)
        y = y + (y.to(torch.bfloat16).to(y.dtype) - y).detach()
        if y.requires_grad:
            y = _GradFp8.apply(y)
    elif prec == "bf16":
        y = F.conv3d(x.to(torch.bfloat16), w.to(torch.bfloat16), None,
                     stride, pad, dil).float()
    else:
        y = F.conv3d(x, w, None, stride, pad, dil)
    return y if b is None else y + b.view(1, -1, 1, 1, 1)


def batch_norm(x, p, key: str, train: bool, record=None):
    """Eval: running statistics.  Train: the batch's float32 moments
    (biased variance), as the reference's SyncBatchNorm normalises
    (``record``, if given, keeps them by key)."""
    w, b = p[f"{key}.weight"], p[f"{key}.bias"]
    if train:
        dims = (0, 2, 3, 4)
        mean = x.mean(dims)
        var = (x * x).mean(dims) - mean * mean
        if record is not None:
            record[key] = (mean.detach(), var.detach())
    else:
        mean, var = p[f"{key}.running_mean"], p[f"{key}.running_var"]
    mul = w * torch.rsqrt(var + BN_EPS)
    return x * mul.view(1, -1, 1, 1, 1) + (b - mean * mul).view(1, -1, 1, 1, 1)


def _conv_bn(x, p, spec, train, prec, relu=True, record=None):
    key, _, _, _, stride, pad, dil, bias, bn = spec
    y = conv(x, p[f"{key}.weight"], p.get(f"{key}.bias") if bias else None,
             stride, pad, dil, prec)
    y = batch_norm(y, p, bn, train, record)
    return torch.relu(y) if relu else y


def _shortcut_a(x, planes: int, stride: int):
    if stride != 1:
        x = x[:, :, ::stride, ::stride, ::stride]
    if planes > x.shape[1]:
        x = F.pad(x, (0, 0, 0, 0, 0, 0, 0, planes - x.shape[1]))
    return x


def _crop_concat(up, skip):
    sl = [slice(None), slice(None)]
    for a, b in zip(up.shape[2:], skip.shape[2:]):
        off = -((a - b) // 2)
        sl.append(slice(off, off + a))
    return torch.cat([up, skip[tuple(sl)]], 1)


def _up2(x):
    return F.interpolate(x, size=tuple(2 * s for s in x.shape[2:]),
                         mode="trilinear", align_corners=True)


def nearest_resize(x: torch.Tensor, size: Sequence[int]) -> torch.Tensor:
    """torch 'nearest' over the last three axes as the integer floor
    ``i * n // out``."""
    for axis, out in zip(range(x.ndim - 3, x.ndim), size):
        n = x.shape[axis]
        idx = torch.div(torch.arange(out, device=x.device) * n, out,
                        rounding_mode="floor")
        x = x.index_select(axis, idx)
    return x


def forward(p: Dict[str, torch.Tensor], arch: str, x: torch.Tensor,
            lung: torch.Tensor, train: bool = False, prec: str = "f32",
            record=None):
    """``x``, ``lung``: (B, 1, D, H, W) float32.  Returns (dense maps, two
    (B, 1, D/2, H/2, W/2) sigmoid maps; lesion fractions, two (B,)).
    ``record``: a dict that keeps each train BatchNorm's moments."""
    table = conv_table(arch)
    cb = functools.partial(_conv_bn, train=train, prec=prec, record=record)
    block, counts = ARCHS[ARCH_FACTORY.get(arch, arch)]
    per = 2 if block == "basic" else 3
    it = iter(table)
    stem = cb(x, p, next(it))
    h = F.max_pool3d(stem, 3, 2, 1)
    x1 = None
    for li, (planes, stride, _) in enumerate(LAYERS):
        for i in range(counts[li]):
            specs = [next(it) for _ in range(per)]
            out = h
            for j, spec in enumerate(specs):
                out = cb(out, p, spec, relu=j < per - 1)
            s = stride if i == 0 else 1
            h = torch.relu(out + _shortcut_a(h, out.shape[1], s))
        if li == 0:
            x1 = h
    u = _crop_concat(_up2(h), x1)
    u = cb(cb(u, p, next(it)), p, next(it))
    u = _crop_concat(_up2(u), stem)
    u = cb(cb(u, p, next(it)), p, next(it))
    y = cb(u, p, next(it))
    dense = []
    for spec in (next(it), next(it)):
        key = spec[0]
        dense.append(torch.sigmoid(conv(y, p[f"{key}.weight"],
                                        p[f"{key}.bias"], 1, 0, 1, prec)))
    lung_r = nearest_resize(lung, dense[0].shape[2:])
    den = lung_r.sum((1, 2, 3, 4))
    fracs = [(d * lung_r).sum((1, 2, 3, 4)) / den for d in dense]
    return dense, fracs


@torch.no_grad()
def calibrate_bn(p: Dict[str, torch.Tensor], arch: str, x: torch.Tensor,
                 lung: torch.Tensor) -> None:
    """Set every BatchNorm's running mean and (biased) variance in ``p`` to
    its batch moments on ``x``."""
    record: Dict = {}
    forward(p, arch, x, lung, train=True, record=record)
    for key, (mean, var) in record.items():
        p[f"{key}.running_mean"].copy_(mean)
        p[f"{key}.running_var"].copy_(var)
