"""Building blocks of the 3-D ResNet zoo, NDHWC activations.

Counterpart of the logical (non-packed) parts of
``bodyct_dram_emph_subtype_tpu/models/blocks.py``; reference ``med3d.py``:
``conv3x3x3`` (:91-100), ``downsample_basic_block`` (shortcut 'A',
:103-112), ``BasicBlock`` (:115-144), ``Bottleneck`` (:147-184),
``crop_concat_5d`` (:39-48) and ``UpsampleConvBlock5d`` (:50-89).

Parameters are ``nn.Conv3d`` / ``nn.BatchNorm3d`` under the reference's
module names, so a reference state dict loads unchanged.  Activations stay
NDHWC (channels last) as in the JAX package; the convs that no kernel of
this port serves go to cuDNN through ``F.conv3d`` on a channels-last-3d
view (dilated layer3/4 with native dilation — the TPU's space-to-batch and
subgrid W-merge are layouts and are not ported).  Compute runs in the
activation dtype (float32 or bfloat16); weights are cast to it at use.

``forward`` dispatches on ``self.training``.  Eval BatchNorm is folded to
a per-channel float32 ``mul``/``add`` (eps 1e-5, ``packed.py:355-361``).
Training BatchNorm is :func:`batch_norm_train`; the 3x3x3 stride-1 convs
that the JAX package routes through ``roll_conv_packed`` in training (the
identity blocks of layer1 and the decoder stages) run on the port's
``roll_conv_packed`` (kernels A and D), every other conv on cuDNN.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.resize import resize_linear_matmul
from ..ops.roll_conv import roll_conv_affine_relu, roll_conv_packed


def bn_affine(bn: nn.BatchNorm3d) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eval BatchNorm as ``y = x*mul + add`` (float32 per-channel)."""
    mul = bn.weight.float() * torch.rsqrt(bn.running_var.float() + bn.eps)
    add = bn.bias.float() - bn.running_mean.float() * mul
    return mul, add


def kernel_dhwio(conv: nn.Conv3d) -> torch.Tensor:
    """OIDHW conv weight as the kernels' (kd, kh, kw, C, O) layout."""
    return conv.weight.permute(2, 3, 4, 1, 0)


def conv3d_ndhwc(x: torch.Tensor, conv: nn.Conv3d) -> torch.Tensor:
    """``conv`` (its stride, padding, dilation, bias) on NDHWC ``x`` via
    cuDNN, in ``x.dtype``; returns contiguous NDHWC."""
    bias = None if conv.bias is None else conv.bias.to(x.dtype)
    y = F.conv3d(x.permute(0, 4, 1, 2, 3), conv.weight.to(x.dtype), bias,
                 conv.stride, conv.padding, conv.dilation)
    return y.permute(0, 2, 3, 4, 1).contiguous()


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


def affine(y: torch.Tensor, bn: nn.BatchNorm3d, relu: bool,
           residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Folded eval BN (+ residual) (+ ReLU) in float32, back to y.dtype."""
    mul, add = bn_affine(bn)
    out = y.float() * mul + add
    if residual is not None:
        out = out + residual.float()
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


class BasicBlock(nn.Module):
    """Two 3x3x3 convs + identity / type-'A' shortcut (``med3d.py:115-144``).

    In eval mode the identity blocks of layer1 and the layer2 tail run
    through ``ops/layer1_kernel.py`` (kernel A); this ``forward`` serves the
    rest (strided, channel-changing and dilated blocks) through cuDNN.  In
    training a block with ``roll_train`` set (the trunk sets it on layer1)
    runs both convs through ``roll_conv_packed``, the others on cuDNN."""
    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 dilation: int = 1):
        super().__init__()
        self.planes = planes
        self.stride = stride
        self.use_downsample = stride != 1 or inplanes != planes
        self.roll_train = False
        self.conv1 = nn.Conv3d(inplanes, planes, 3, stride, dilation,
                               dilation, bias=False)
        self.bn1 = nn.BatchNorm3d(planes)
        self.conv2 = nn.Conv3d(planes, planes, 3, 1, dilation, dilation,
                               bias=False)
        self.bn2 = nn.BatchNorm3d(planes)

    def _train_forward(self, x: torch.Tensor) -> torch.Tensor:
        conv = roll_conv_bias if self.roll_train else conv3d_ndhwc
        out = torch.relu(batch_norm_train(conv(x, self.conv1), self.bn1))
        out = batch_norm_train(conv(out, self.conv2), self.bn2)
        residual = (downsample_shortcut_a(x, self.planes, self.stride)
                    if self.use_downsample else x)
        return torch.relu(out + residual)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            return self._train_forward(x)
        out = affine(conv3d_ndhwc(x, self.conv1), self.bn1, relu=True)
        residual = (downsample_shortcut_a(x, self.planes, self.stride)
                    if self.use_downsample else x)
        return affine(conv3d_ndhwc(out, self.conv2), self.bn2, relu=True,
                      residual=residual)

    def fused_params(self):
        """(kernels, muls, adds) of both convs for ``fused_layer1``."""
        m1, a1 = bn_affine(self.bn1)
        m2, a2 = bn_affine(self.bn2)
        return ([kernel_dhwio(self.conv1), kernel_dhwio(self.conv2)],
                [m1, m2], [a1, a2])


class Bottleneck(nn.Module):
    """1-3-1 bottleneck, expansion 4 (``med3d.py:147-184``), via cuDNN."""
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 dilation: int = 1):
        super().__init__()
        self.planes = planes
        self.stride = stride
        self.use_downsample = stride != 1 or inplanes != planes * 4
        self.conv1 = nn.Conv3d(inplanes, planes, 1, bias=False)
        self.bn1 = nn.BatchNorm3d(planes)
        self.conv2 = nn.Conv3d(planes, planes, 3, stride, dilation, dilation,
                               bias=False)
        self.bn2 = nn.BatchNorm3d(planes)
        self.conv3 = nn.Conv3d(planes, planes * 4, 1, bias=False)
        self.bn3 = nn.BatchNorm3d(planes * 4)

    def _train_forward(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.relu(batch_norm_train(conv3d_ndhwc(x, self.conv1),
                                          self.bn1))
        out = torch.relu(batch_norm_train(conv3d_ndhwc(out, self.conv2),
                                          self.bn2))
        out = batch_norm_train(conv3d_ndhwc(out, self.conv3), self.bn3)
        residual = (downsample_shortcut_a(x, self.planes * 4, self.stride)
                    if self.use_downsample else x)
        return torch.relu(out + residual)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            return self._train_forward(x)
        out = affine(conv3d_ndhwc(x, self.conv1), self.bn1, relu=True)
        out = affine(conv3d_ndhwc(out, self.conv2), self.bn2, relu=True)
        residual = (downsample_shortcut_a(x, self.planes * 4, self.stride)
                    if self.use_downsample else x)
        return affine(conv3d_ndhwc(out, self.conv3), self.bn3, relu=True,
                      residual=residual)


def crop_concat(t1: torch.Tensor, t2: torch.Tensor) -> torch.Tensor:
    """Center-crop ``t2`` spatially to ``t1`` and concat channels
    (``med3d.py:39-48``; offset = ceil((b-a)/2) per axis).  NDHWC."""
    slices = [slice(None)]
    for a, b in zip(t1.shape[1:4], t2.shape[1:4]):
        off = -((a - b) // 2)
        slices.append(slice(off, a + off))
    slices.append(slice(None))
    return torch.cat([t1, t2[tuple(slices)]], dim=-1)


class UpsampleConvBlock(nn.Module):
    """x2 trilinear (align_corners=True) upsample as interpolation-matrix
    products + crop-concat + conv-BN-ReLU stages (``med3d.py:50-89``).
    In eval mode each stage is one launch of kernel A with the conv bias
    and eval BN folded into its epilogue (``packed.py::packed_stage``); in
    training each stage is ``roll_conv_packed`` + bias, train BN, ReLU."""

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

    def forward(self, inputs: torch.Tensor, cats: torch.Tensor
                ) -> torch.Tensor:
        s = self.scale_factor
        d, h, w = inputs.shape[1:4]
        up = resize_linear_matmul(inputs, (d * s, h * s, w * s), (1, 2, 3),
                                  align_corners=True).to(inputs.dtype)
        x = crop_concat(up, cats.to(inputs.dtype)).contiguous()
        if self.training:
            for conv, bn, _ in self.conv_blocks:
                x = torch.relu(batch_norm_train(roll_conv_bias(x, conv), bn))
            return x
        for conv, bn, _ in self.conv_blocks:
            mul, add = bn_affine(bn)
            x = roll_conv_affine_relu(x, kernel_dhwio(conv), mul,
                                      conv.bias.float() * mul + add)
        return x
