"""Building blocks of the 3-D ResNet zoo, NDHWC activations.

Counterpart of the logical (non-packed) parts of
``bodyct_dram_emph_subtype_tpu/models/blocks.py``; reference ``med3d.py``:
``conv3x3x3`` (:91-100), ``downsample_basic_block`` (shortcut 'A',
:103-112), the 1x1x1 conv + BN shortcut 'B' (:250-260), ``BasicBlock``
(:115-144), ``Bottleneck`` (:147-184),
``crop_concat_5d`` (:39-48) and ``UpsampleConvBlock5d`` (:50-89).

Parameters are ``nn.Conv3d`` / ``nn.BatchNorm3d`` under the reference's
module names, so a reference state dict loads unchanged.  Activations stay
NDHWC (channels last) as in the JAX package.  Compute runs in the
activation dtype (float32 or bfloat16); weights are cast to it at use.

The 3-D conv lowering mode (:func:`set_conv3d_mode`, read from
``$BODYCT_CONV3D_MODE`` at import; the port's default is ``roll``, the
JAX package's ``direct``) picks the kernels, as ``conv3d_apply`` does in
the JAX package (blocks.py:150-234):

- ``roll``: the kernel sites are chosen per module (fused layer1 stacks
  on kernels A/C, ``roll_conv_packed`` for layer1 in training, and for the
  packed decoder its stages and heads on kernels A/B, ``roll_conv_packed``
  in training); :func:`conv3d_apply` sends every other conv to cuDNN.
- ``pallas``, ``tapmm``, ``flat``: :func:`conv3d_apply` sends each
  stride-1 3^3 conv whose JAX gate passes (``ops/pallas_conv.py``,
  ``tap_conv.py``, ``flat_conv.py``) to kernel A, every other conv to
  cuDNN; no module-level kernel site is taken.  The gate judges the shape
  the JAX package convolves: for a dilation-d conv, the space-to-batch
  subgrid shape (B*d^3, D/d, H/d, W/d, C) with the dims rounded up to
  multiples of d (``DilatedConv3d``, blocks.py:370).  The port runs the
  same numbers as a dilated conv on the logical tensor: space-to-batch and
  the subgrid W-merge are TPU layouts and are not ported.
- ``direct``, ``d2sum``, ``d2cat``, ``packw``: every conv on cuDNN (the
  TPU lowerings of those names compute the same conv).

Outside the roll module sites a conv is rounded to the compute dtype and
its bias added in it (``Conv3d.__call__``, blocks.py:257-262), BatchNorm
rounds its output, and the residual add runs in the compute dtype
(blocks.py:544): the JAX package's unpacked rounding chain.  Eval
BatchNorm is folded to a per-channel float32 ``mul``/``add`` (eps 1e-5,
``packed.py:355-361``); training BatchNorm is :func:`batch_norm_train`.
"""
from __future__ import annotations

import math
import os
from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.flat_conv import flat_conv3d, supports_flat_conv
from ..ops.pallas_conv import pallas_conv3d, supports_pallas_conv3d
from ..ops.resize import resize_linear_matmul
from ..ops.roll_conv import roll_conv_affine_relu, roll_conv_packed
from ..ops.tap_conv import supports_tap_conv3d, tap_conv3d

CONV3D_MODES = ("direct", "d2sum", "d2cat", "pallas", "tapmm", "packw",
                "roll", "flat")
_CONV3D_MODE = os.environ.get("BODYCT_CONV3D_MODE", "roll")

# mode -> (JAX gate on (shape, kernel shape, itemsize), the port's op)
_MODE_OPS = {
    "pallas": (lambda s, k, i: supports_pallas_conv3d(s, k, (1, 1, 1), i),
               pallas_conv3d),
    "tapmm": (lambda s, k, i: supports_tap_conv3d(s, k, (1, 1, 1), i),
              tap_conv3d),
    "flat": (supports_flat_conv, flat_conv3d),
}


def set_conv3d_mode(mode: str) -> None:
    """Set the 3-D conv lowering mode (one of :data:`CONV3D_MODES`; the
    port's default is ``roll``, the JAX package's ``direct``).  Takes
    effect at the next forward.  Unlike the JAX setter, which refuses
    ``flat`` though its ``conv3d_apply`` runs it, every mode that
    ``conv3d_apply`` understands is accepted."""
    global _CONV3D_MODE
    if mode not in CONV3D_MODES:
        raise ValueError(f"unknown conv3d mode {mode!r}; known: "
                         f"{CONV3D_MODES}")
    _CONV3D_MODE = mode


def get_conv3d_mode() -> str:
    return _CONV3D_MODE


def jax_conv_shape(x_shape: Sequence[int], dilation: int
                   ) -> Tuple[int, ...]:
    """The activation shape the JAX package convolves for a 3^3 conv of
    dilation ``dilation`` on NDHWC ``x_shape``: the space-to-batch subgrid
    (B*d^3, ceil(D/d), ceil(H/d), ceil(W/d), C), or ``x_shape`` itself at
    d = 1."""
    b, d, h, w, c = x_shape
    n = dilation
    return (b * n ** 3, -(-d // n), -(-h // n), -(-w // n), c)


def mode_conv_op(mode: str, x_shape: Sequence[int],
                 kernel_shape: Sequence[int], stride: Sequence[int],
                 dilation: int, itemsize: int):
    """The op (``pallas_conv3d``, ``tap_conv3d``, ``flat_conv3d``) that a
    conv of NDHWC input ``x_shape``, (kd, kh, kw, C, O) ``kernel_shape``,
    ``stride`` and ``dilation`` (padding = dilation) runs on under
    ``mode``, or None for cuDNN: the JAX routing of ``conv3d_apply``
    (blocks.py:174-205) with its gates on :func:`jax_conv_shape`."""
    if mode not in _MODE_OPS or tuple(kernel_shape[:3]) != (3, 3, 3) \
            or tuple(stride) != (1, 1, 1):
        return None
    gate, op = _MODE_OPS[mode]
    if not gate(jax_conv_shape(x_shape, dilation), tuple(kernel_shape),
                itemsize):
        return None
    return op


def bn_affine(bn: nn.BatchNorm3d) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eval BatchNorm as ``y = x*mul + add`` (float32 per-channel)."""
    mul = bn.weight.float() * torch.rsqrt(bn.running_var.float() + bn.eps)
    add = bn.bias.float() - bn.running_mean.float() * mul
    return mul, add


def kernel_dhwio(conv: nn.Conv3d) -> torch.Tensor:
    """OIDHW conv weight as the kernels' (kd, kh, kw, C, O) layout."""
    return conv.weight.permute(2, 3, 4, 1, 0)


def conv3d_ndhwc(x: torch.Tensor, conv: nn.Conv3d) -> torch.Tensor:
    """``conv`` (its stride, padding, dilation) on NDHWC ``x`` via cuDNN,
    rounded to ``x.dtype``, then its bias added in ``x.dtype``; returns
    contiguous NDHWC."""
    y = F.conv3d(x.permute(0, 4, 1, 2, 3), conv.weight.to(x.dtype), None,
                 conv.stride, conv.padding, conv.dilation)
    y = y.permute(0, 2, 3, 4, 1).contiguous()
    if conv.bias is not None:
        y = y + conv.bias.to(x.dtype)
    return y


def conv3d_apply(x: torch.Tensor, conv: nn.Conv3d,
                 mode: Optional[str] = None) -> torch.Tensor:
    """``conv`` on NDHWC ``x`` under conv mode ``mode`` (default: the
    global mode): a stride-1 3^3 conv whose JAX gate passes runs on its
    mode op (kernel A; on a CPU tensor its plain version), everything else
    on cuDNN.  The conv is rounded to ``x.dtype``, then the bias added in
    it."""
    op = None
    if tuple(conv.padding) == tuple(conv.dilation):
        op = mode_conv_op(mode or _CONV3D_MODE, tuple(x.shape),
                          tuple(conv.kernel_size) + (conv.in_channels,
                                                     conv.out_channels),
                          conv.stride, conv.dilation[0], x.element_size())
    if op is None:
        return conv3d_ndhwc(x, conv)
    y = op(x, kernel_dhwio(conv).to(x.dtype), dilation=conv.dilation[0])
    if conv.bias is not None:
        y = y + conv.bias.to(x.dtype)
    return y


def batch_norm_train(x: torch.Tensor, bn: nn.BatchNorm3d) -> torch.Tensor:
    """Train-mode BatchNorm over (B, D, H, W) of NDHWC ``x``, as the JAX
    package's ``_PackedBN`` and flax ``nn.BatchNorm`` compute it: float32
    moments of ``x`` (already in the compute dtype), ``var = E[x^2] -
    mean^2``, the result back in ``x.dtype``.  The running statistics take
    the BIASED variance with momentum ``bn.momentum`` (torch 0.1 == flax
    0.9), updated explicitly under ``no_grad`` —
    ``F.batch_norm(training=True)`` would store the unbiased n/(n-1)
    variance."""
    xf = x.float()
    dims = tuple(range(x.ndim - 1))
    mean = xf.mean(dims)
    var = (xf * xf).mean(dims) - mean * mean
    with torch.no_grad():
        bn.running_mean.mul_(1.0 - bn.momentum).add_(bn.momentum * mean)
        bn.running_var.mul_(1.0 - bn.momentum).add_(bn.momentum * var)
        bn.num_batches_tracked += 1
    mul = bn.weight.float() * torch.rsqrt(var + bn.eps)
    add = bn.bias.float() - mean * mul
    return (xf * mul + add).to(x.dtype)


def decoder_conv(x: torch.Tensor, conv: nn.Conv3d,
                 packed: bool) -> torch.Tensor:
    """A decoder conv off the kernels (:func:`decoder_kernels` false): the
    packed decoder's convs go to cuDNN, the unpacked decoder's through
    :func:`conv3d_apply` (cuDNN too under ``roll``)."""
    return conv3d_ndhwc(x, conv) if packed else conv3d_apply(x, conv)


def roll_conv_bias(x: torch.Tensor, conv: nn.Conv3d) -> torch.Tensor:
    """Training 3x3x3 stride-1 conv through ``roll_conv_packed``: output
    rounded to ``x.dtype`` first, then the conv bias added in that dtype
    (``packed.py:318-330``)."""
    y = roll_conv_packed(x, kernel_dhwio(conv).to(x.dtype))
    if conv.bias is not None:
        y = y + conv.bias.to(x.dtype)
    return y


def max_pool3d_ndhwc(x: torch.Tensor) -> torch.Tensor:
    """k3 s2 p1 max-pool of NDHWC ``x`` (cuDNN; the training pool)."""
    y = F.max_pool3d(x.permute(0, 4, 1, 2, 3), 3, 2, 1)
    return y.permute(0, 2, 3, 4, 1).contiguous()


def affine(y: torch.Tensor, bn: nn.BatchNorm3d,
           relu: bool = False) -> torch.Tensor:
    """Folded eval BN (+ ReLU) in float32, rounded back to y.dtype."""
    mul, add = bn_affine(bn)
    out = y.float() * mul + add
    if relu:
        out = torch.relu(out)
    return out.to(y.dtype)


def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """The JAX package's init, drawn from ``generator``: conv kernels
    He-normal over fan-out (``kaiming_normal_fan_out``), conv biases zero,
    BatchNorm identity (weight 1, bias 0, running mean 0, var 1)."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, nn.Conv3d):
                fan_out = m.out_channels * math.prod(m.kernel_size)
                std = math.sqrt(2.0 / fan_out)
                m.weight.copy_(torch.randn(m.weight.shape,
                                           generator=generator) * std)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.BatchNorm3d):
                m.reset_parameters()


def downsample_shortcut_a(x: torch.Tensor, planes: int,
                          stride: int) -> torch.Tensor:
    """Shortcut type 'A' (``med3d.py:103-112``): strided subsample, then
    zero-pad channels up to ``planes``."""
    if stride != 1:
        x = x[:, ::stride, ::stride, ::stride, :]
    pad_c = planes - x.shape[-1]
    if pad_c > 0:
        x = F.pad(x, (0, pad_c))
    return x


class DownsampleB(nn.Sequential):
    """Shortcut type 'B' (``med3d.py:250-260``): a 1x1x1 conv with stride
    ``stride`` and no bias (cuDNN, rounded to the compute dtype), then
    BatchNorm; the reference's children ``downsample.0`` / ``downsample.1``.
    Pointwise, so the JAX package's space-to-batch domain of layer3/4
    computes the same numbers on the logical tensor."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1):
        super().__init__(nn.Conv3d(inplanes, planes, 1, stride, bias=False),
                         nn.BatchNorm3d(planes))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        conv, bn = self
        bn_fn = batch_norm_train if self.training else affine
        return bn_fn(conv3d_apply(x, conv), bn)


def _shortcut(block: nn.Module, inplanes: int, planes: int, stride: int,
              shortcut_type: str) -> None:
    """Set ``block.use_downsample`` by the JAX rule (``need_ds``,
    ``resnet3d.py:228-229``: a stride or a change of width) and, for
    shortcut type 'B', its ``downsample`` module."""
    if shortcut_type not in ("A", "B"):
        raise ValueError(f"shortcut_type must be 'A' or 'B', not "
                         f"{shortcut_type!r}")
    block.planes, block.stride = planes, stride
    block.use_downsample = stride != 1 or inplanes != planes
    block.shortcut_type = shortcut_type
    if block.use_downsample and shortcut_type == "B":
        block.downsample = DownsampleB(inplanes, planes, stride)


def _residual(block: nn.Module, x: torch.Tensor) -> torch.Tensor:
    if not block.use_downsample:
        return x
    if block.shortcut_type == "B":
        return block.downsample(x)
    return downsample_shortcut_a(x, block.planes, block.stride)


class BasicBlock(nn.Module):
    """Two 3x3x3 convs + identity / type-'A' or 'B' shortcut
    (``med3d.py:115-144``).

    In eval mode under conv mode ``roll`` the identity blocks of layer1 and
    the layer2 tail run through ``ops/layer1_kernel.py`` (kernel A); this
    ``forward`` serves every other block, each conv through
    :func:`conv3d_apply`, with the JAX package's unpacked rounding chain.
    In training under ``roll`` a block with ``roll_train`` set (the trunk
    sets it on layer1) runs both convs through ``roll_conv_packed``."""
    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 dilation: int = 1, shortcut_type: str = "A"):
        super().__init__()
        self.roll_train = False
        self.conv1 = nn.Conv3d(inplanes, planes, 3, stride, dilation,
                               dilation, bias=False)
        self.bn1 = nn.BatchNorm3d(planes)
        self.conv2 = nn.Conv3d(planes, planes, 3, 1, dilation, dilation,
                               bias=False)
        self.bn2 = nn.BatchNorm3d(planes)
        _shortcut(self, inplanes, planes, stride, shortcut_type)

    def _conv(self, x: torch.Tensor, conv: nn.Conv3d) -> torch.Tensor:
        if self.training and self.roll_train and _CONV3D_MODE == "roll":
            return roll_conv_bias(x, conv)
        return conv3d_apply(x, conv)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bn = batch_norm_train if self.training else affine
        out = torch.relu(bn(self._conv(x, self.conv1), self.bn1))
        out = bn(self._conv(out, self.conv2), self.bn2)
        return torch.relu(out + _residual(self, x))

    def fused_params(self):
        """(kernels, muls, adds) of both convs for ``fused_layer1``."""
        m1, a1 = bn_affine(self.bn1)
        m2, a2 = bn_affine(self.bn2)
        return ([kernel_dhwio(self.conv1), kernel_dhwio(self.conv2)],
                [m1, m2], [a1, a2])


class Bottleneck(nn.Module):
    """1-3-1 bottleneck, expansion 4 (``med3d.py:147-184``): each conv
    through :func:`conv3d_apply`, the JAX unpacked rounding chain."""
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 dilation: int = 1, shortcut_type: str = "A"):
        super().__init__()
        self.conv1 = nn.Conv3d(inplanes, planes, 1, bias=False)
        self.bn1 = nn.BatchNorm3d(planes)
        self.conv2 = nn.Conv3d(planes, planes, 3, stride, dilation, dilation,
                               bias=False)
        self.bn2 = nn.BatchNorm3d(planes)
        self.conv3 = nn.Conv3d(planes, planes * 4, 1, bias=False)
        self.bn3 = nn.BatchNorm3d(planes * 4)
        _shortcut(self, inplanes, planes * 4, stride, shortcut_type)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bn = batch_norm_train if self.training else affine
        out = torch.relu(bn(conv3d_apply(x, self.conv1), self.bn1))
        out = torch.relu(bn(conv3d_apply(out, self.conv2), self.bn2))
        out = bn(conv3d_apply(out, self.conv3), self.bn3)
        return torch.relu(out + _residual(self, x))


def crop_concat(t1: torch.Tensor, t2: torch.Tensor) -> torch.Tensor:
    """Center-crop ``t2`` spatially to ``t1`` and concat channels
    (``med3d.py:39-48``; offset = ceil((b-a)/2) per axis).  NDHWC."""
    slices = [slice(None)]
    for a, b in zip(t1.shape[1:4], t2.shape[1:4]):
        off = -((a - b) // 2)
        slices.append(slice(off, a + off))
    slices.append(slice(None))
    return torch.cat([t1, t2[tuple(slices)]], dim=-1)


def decoder_kernels(packed: bool) -> bool:
    """True where a decoder stage runs on the kernels: the packed decoder
    under conv mode ``roll``, as the JAX package takes its roll kernels
    only in the packed decoder (``packed.py::PackedConv3``,
    ``packed_stage``); its unpacked decoder runs ``conv3d_apply``, which
    under ``roll`` is the XLA conv (blocks.py:159-166)."""
    return packed and _CONV3D_MODE == "roll"


def decoder_stage(x: torch.Tensor, conv: nn.Conv3d, bn: nn.BatchNorm3d,
                  packed: bool, training: bool) -> torch.Tensor:
    """One decoder stage ``relu(bn(conv(x)))`` (``packed.py::packed_stage``
    and the unpacked ``UpsampleConvBlock`` / us3 stages).  For the packed
    decoder under conv mode ``roll`` (:func:`decoder_kernels`) an eval stage
    is one launch of kernel A with the conv bias and eval BN folded into its
    epilogue, and a training stage is ``roll_conv_packed`` + bias, train BN,
    ReLU.  Otherwise conv, BN, ReLU with the JAX unpacked rounding chain,
    the conv through :func:`conv3d_apply` (cuDNN under ``roll``; kernel A
    where a conv mode's gate passes) or, for the packed decoder outside
    ``roll`` (``PackedConv3`` calls XLA's conv there, packed.py:318-328),
    on cuDNN."""
    kernels = decoder_kernels(packed)
    if training or not kernels:
        bn_fn = batch_norm_train if training else affine
        y = (roll_conv_bias(x, conv) if kernels
             else decoder_conv(x, conv, packed))
        return torch.relu(bn_fn(y, bn))
    mul, add = bn_affine(bn)
    return roll_conv_affine_relu(x, kernel_dhwio(conv), mul,
                                 conv.bias.float() * mul + add)


class UpsampleConvBlock(nn.Module):
    """x2 trilinear (align_corners=True) upsample as interpolation-matrix
    products + crop-concat + conv-BN-ReLU stages (``med3d.py:50-89``),
    each a :func:`decoder_stage`."""

    def __init__(self, in_chs: int, base_chs: Sequence[int] = (64, 64),
                 scale_factor: int = 2):
        super().__init__()
        self.scale_factor = scale_factor
        blocks = []
        for ch in base_chs:
            blocks.append(nn.Sequential(nn.Conv3d(in_chs, ch, 3, padding=1,
                                                  bias=True),
                                        nn.BatchNorm3d(ch), nn.ReLU()))
            in_chs = ch
        self.conv_blocks = nn.ModuleList(blocks)

    def forward(self, inputs: torch.Tensor, cats: torch.Tensor,
                packed: bool = False) -> torch.Tensor:
        s = self.scale_factor
        d, h, w = inputs.shape[1:4]
        up = resize_linear_matmul(inputs, (d * s, h * s, w * s), (1, 2, 3),
                                  align_corners=True).to(inputs.dtype)
        x = crop_concat(up, cats.to(inputs.dtype)).contiguous()
        for conv, bn, _ in self.conv_blocks:
            x = decoder_stage(x, conv, bn, packed, self.training)
        return x
