"""The dRAM regression model (``ResNetSegReg``), NDHWC.

Counterpart of ``bodyct_dram_emph_subtype_tpu/models/resnet3d.py``
(``_Trunk``, ``_Decoder``, ``ResNetSegReg``; reference ``med3d.py:288-388``):
conv1 k7 s2 -> max-pool k3 s2 -> layer1 (64) -> layer2 (128, s2) ->
layer3 (256, dilation 2) -> layer4 (512, dilation 4); us1 (x2 up + concat
layer1 + 2 convs), us2 (x2 up + concat stem + 2 convs), us3 (conv 64->32)
and two 1x1x1 sigmoid heads at half the input resolution, reduced to
lung-masked lesion fractions.

Module names equal the reference checkpoint's keys (``conv1``, ``bn1``,
``layerN.i.convK/bnK``, ``us1.conv_blocks.i.0/1``, ``us3.0/1``,
``fcs.i``), so a reference ``best.ckpt`` state dict (``model.`` prefix
stripped) loads with ``load_state_dict`` (``models/torch_import.py``).

``forward`` dispatches on ``self.training`` and on the conv mode
(``blocks.set_conv3d_mode``).  The eval kernel sites under ``roll`` (the
port's default; always taken on a CUDA tensor, plain versions on CPU;
:func:`roll_eval_sites`):

- stem max-pool + layer1 -> ``fused_pool_layer1`` (kernel C + 6 x A),
- layer2 blocks 1..n-1 -> ``fused_layer1`` (6 x A),
- us1 and us2 conv stages -> ``roll_conv_affine_relu`` (4 x A),
- us3 + heads + sigmoid -> ``roll_conv_heads_sigmoid`` (1 x B).

In every mode, eval and training, the lesion fractions of both maps are
one ``lung_masked_fraction`` call (1 x F, ``ops/pallas_kernels.py``).

The stem conv, layer2 block 0 and the dilated layer3/4 run on cuDNN.
With the quad stem on (``set_quad_stem_enable``, ``models/experimental.py``;
eval, ``roll``, ``packed_decoder``) the stem conv, BN, ReLU and pool run
as one launch of kernel E and layer1 as ``fused_layer1``.

The training forward under ``roll`` follows the JAX package's train-mode
routing (``packed_decoder=True``): every 3x3x3 conv of the layer1
identity blocks and of us1/us2/us3 goes through ``roll_conv_packed``
(kernel A forward and dgrad, kernel D wgrad) — :data:`TRAIN_ROLL_SITES`
lists them — while the stem conv, layer2-4 (layer2 has stride 2, so the
JAX package never packs it in training) and the heads run on cuDNN / ATen,
the pool is ``F.max_pool3d`` (JAX: ``nn.max_pool``), BatchNorm uses batch
statistics (``blocks.batch_norm_train``) and the heads are
``sigmoid(conv1x1(x).float())``.

Under the conv modes ``pallas``, ``tapmm`` and ``flat`` (eval and
training) no module-level kernel site is taken, as in the JAX package,
where every packed and fused route needs ``roll`` (``packed.py:481, 496,
512, 527``): the pool is ``F.max_pool3d``, every block runs unpacked, the
heads are unfused, and each 3^3 conv that the mode's JAX gate accepts runs
on kernel A through ``blocks.conv3d_apply`` — :func:`mode_conv_sites`
lists them.  ``packed_decoder`` matters only there: the packed decoder's
convs go to cuDNN (``packed.py:318-328``).

The JAX package's W-pair packing, space-to-depth stem, pair stem and
``remat_scopes`` are TPU layouts and knobs and are not ported.
``ResNetSegCls`` and ``ResNet`` come with a later slice.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple, Type

import torch
import torch.nn as nn

from ..ops.layer1_kernel import fused_layer1, fused_pool_layer1
from ..ops.masked_pool import lung_masked_fraction
from ..ops.maxpool_kernel import max_pool_k3s2p1
from ..ops.roll_conv import roll_conv_heads_sigmoid
from ..ops.stem_kernel import fused_stem_pool, supports_fused_stem
from . import blocks
from .blocks import (BasicBlock, UpsampleConvBlock, affine, batch_norm_train,
                     bn_affine, conv3d_ndhwc, decoder_conv, init_weights,
                     kernel_dhwio, max_pool3d_ndhwc, mode_conv_op,
                     roll_conv_bias)
from .experimental import (set_quad_stem_enable,  # noqa: F401 (re-export)
                           use_quad_stem)

# The training sites of ``roll_conv_packed`` in med3ddram (resnet34segreg):
# (module name of the conv, spatial divisor of its input against the model
# input, C, O).  The JAX package routes exactly these through its kernels 6
# (forward + dgrad) and 7 (wgrad, all but us3, whose 2*32 packed gradient
# lanes go to XLA) at the deployment shape; the port sends all 11 through
# kernels A and D.
TRAIN_ROLL_SITES: Tuple[Tuple[str, int, int, int], ...] = tuple(
    (f"layer1.{i}.conv{j}", 4, 64, 64) for i in range(3) for j in (1, 2)
) + (("us1.conv_blocks.0.0", 4, 576, 64), ("us1.conv_blocks.1.0", 4, 64, 64),
     ("us2.conv_blocks.0.0", 2, 128, 64), ("us2.conv_blocks.1.0", 2, 64, 64),
     ("us3.0", 2, 64, 32))


def train_roll_site_shapes(batch: int, size: Sequence[int]):
    """``[(name, input shape (B, D, H, W, C), O)]`` of
    :data:`TRAIN_ROLL_SITES` for a (batch, *size) model input."""
    return [(name, (batch, *(s // div for s in size), c), o)
            for name, div, c, o in TRAIN_ROLL_SITES]


def roll_eval_sites(layers: Sequence[int], quad: bool = False
                    ) -> List[Tuple[str, str, Dict[str, int]]]:
    """The kernel sites of a BasicBlock ``ResNetSegReg`` eval forward
    under conv mode ``roll`` where every JAX gate passes (the deployment
    shape): ``[(site, JAX kernel module, {port kernel: launches})]``, one
    entry per JAX ``pallas_call`` site.  ``quad``: the quad stem on and
    ``supports_fused_stem`` holding (kernel E)."""
    a = "conv3x3x3_affine"
    if quad:
        head = [("conv1+bn1+pool", "stem_kernel", {"stem_pool": 1}),
                ("layer1", "layer1_kernel", {a: 2 * layers[0]})]
    else:
        head = [("pool+layer1", "layer1_kernel",
                 {"max_pool3d_k3s2p1": 1, a: 2 * layers[0]})]
    return head + [("layer2.tail", "layer1_kernel", {a: 2 * (layers[1] - 1)})] \
        + [(f"us{i}.conv_blocks.{j}.0", "roll_conv", {a: 1})
           for i in (1, 2) for j in (0, 1)] \
        + [("us3+heads", "roll_conv", {"conv3x3x3_heads_sigmoid": 1})]


def _ceil_div(shape: Sequence[int], s: int) -> Tuple[int, ...]:
    return tuple(-(-n // s) for n in shape)


def conv3d_apply_sites(model: "ResNetSegReg", batch: int,
                       size: Sequence[int]
                       ) -> List[Tuple[str, Tuple[int, ...], nn.Conv3d]]:
    """``[(module name, NDHWC input shape, conv)]`` of every conv that the
    forward outside conv mode ``roll`` sends through ``blocks.conv3d_apply``
    for a (batch, *size) input, in forward order: every conv of the
    residual layers and, for a model with the unpacked decoder, the five
    decoder convs.  The stem conv and the heads never go through it."""
    sites = []
    s = _ceil_div(_ceil_div(size, 2), 2)          # stem, pool
    outs = []
    for lname in ("layer1", "layer2", "layer3", "layer4"):
        for i, blk in enumerate(getattr(model, lname)):
            for cname, conv in blk.named_children():
                if not isinstance(conv, nn.Conv3d):
                    continue
                sites.append((f"{lname}.{i}.{cname}",
                              (batch, *s, conv.in_channels), conv))
                s = _ceil_div(s, conv.stride[0])
        outs.append(s)
    if not model.packed_decoder:
        s = tuple(2 * n for n in outs[3])
        for us in ("us1", "us2"):
            for j, (conv, _, _) in enumerate(getattr(model, us).conv_blocks):
                sites.append((f"{us}.conv_blocks.{j}.0",
                              (batch, *s, conv.in_channels), conv))
            s = tuple(2 * n for n in s)
        s = tuple(n // 2 for n in s)
        sites.append(("us3.0", (batch, *s, model.us3[0].in_channels),
                      model.us3[0]))
    return sites


def mode_conv_sites(model: "ResNetSegReg", mode: str, batch: int,
                    size: Sequence[int], dtype: torch.dtype
                    ) -> List[Tuple[str, Tuple[int, ...], Tuple[int, ...],
                                    int, str]]:
    """The convs that conv mode ``mode`` runs on kernel A in one forward
    (eval or training) of a (batch, *size) input in ``dtype``:
    ``[(module name, NDHWC input shape, kernel shape (3,3,3,C,O),
    dilation, op name)]``, the sites of the JAX package's ``pallas_call``
    for that mode."""
    out = []
    for name, shape, conv in conv3d_apply_sites(model, batch, size):
        kshape = tuple(conv.kernel_size) + (conv.in_channels,
                                            conv.out_channels)
        op = mode_conv_op(mode, shape, kshape, conv.stride,
                          conv.dilation[0], dtype.itemsize)
        if op is not None:
            out.append((name, shape, kshape, conv.dilation[0], op.__name__))
    return out


def _stack_params(blocks: Sequence[BasicBlock]):
    ks, ms, ads = [], [], []
    for blk in blocks:
        k, m, a = blk.fused_params()
        ks += k
        ms += m
        ads += a
    return ks, ms, ads


class _Trunk(nn.Module):
    """Encoder trunk: ``trunk(x)`` returns (stem, layer1, layer4)
    activations, NDHWC in ``x.dtype``."""

    def __init__(self, block: Type[nn.Module], layers: Sequence[int]):
        super().__init__()
        self.block = block
        self.conv1 = nn.Conv3d(1, 64, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm3d(64)
        self.inplanes = 64
        self.layer1 = self._make_layer(block, 64, layers[0], 1, 1)
        self.layer2 = self._make_layer(block, 128, layers[1], 2, 1)
        self.layer3 = self._make_layer(block, 256, layers[2], 1, 2)
        self.layer4 = self._make_layer(block, 512, layers[3], 1, 4)
        if block is BasicBlock:
            # identity blocks: the training convs go through the kernels
            for blk in self.layer1:
                blk.roll_train = True

    def _make_layer(self, block, planes, blocks, stride, dilation):
        mods = [block(self.inplanes, planes, stride, dilation)]
        self.inplanes = planes * block.expansion
        mods += [block(self.inplanes, planes, 1, dilation)
                 for _ in range(1, blocks)]
        return nn.Sequential(*mods)

    def trunk(self, x: torch.Tensor):
        if self.training or blocks.get_conv3d_mode() != "roll":
            bn = batch_norm_train if self.training else affine
            stem = torch.relu(bn(conv3d_ndhwc(x, self.conv1), self.bn1))
            x1 = self.layer1(max_pool3d_ndhwc(stem))
            return stem, x1, self.layer4(self.layer3(self.layer2(x1)))
        if use_quad_stem(x.shape, False, self.packed_decoder, x.dtype):
            stem, pooled = self._quad_stem(x)
            x1 = (fused_layer1(pooled, *_stack_params(self.layer1))
                  if self.block is BasicBlock else self.layer1(pooled))
        elif self.block is BasicBlock:
            # identity blocks: pool + the whole layer1 stack on kernels C, A
            stem = affine(conv3d_ndhwc(x, self.conv1), self.bn1, relu=True)
            x1 = fused_pool_layer1(stem, *_stack_params(self.layer1))
        else:
            stem = affine(conv3d_ndhwc(x, self.conv1), self.bn1, relu=True)
            x1 = self.layer1(max_pool_k3s2p1(stem))
        x2 = self.layer2[0](x1)
        if self.block is BasicBlock:
            x2 = fused_layer1(x2, *_stack_params(self.layer2[1:]))
        else:
            for blk in self.layer2[1:]:
                x2 = blk(x2)
        x4 = self.layer4(self.layer3(x2))
        return stem, x1, x4

    def _quad_stem(self, x: torch.Tensor):
        """(stem, pooled) of the quad stem path: one launch of kernel E
        where the JAX gate ``supports_fused_stem`` holds, else the cuDNN
        conv, BN and ReLU and kernel C (``experimental.py:139-150``)."""
        mul, add = bn_affine(self.bn1)
        if supports_fused_stem(tuple(x.shape), 64, x.element_size()):
            return fused_stem_pool(x, kernel_dhwio(self.conv1), mul, add)
        stem = affine(conv3d_ndhwc(x, self.conv1), self.bn1, relu=True)
        return stem, max_pool_k3s2p1(stem)


class ResNetSegReg(_Trunk):
    """dRAM regression variant: ``forward(x, lungs)`` -> (dense_outs,
    reg_outs) with ``dense_outs`` two float32 (B, D/2, H/2, W/2, 1) sigmoid
    maps and ``reg_outs`` two (B,) lung-masked lesion fractions.

    ``x`` is (B, D, H, W, 1) in the compute dtype (float32 or bfloat16);
    ``lungs`` (B, D', H', W', 1) at any resolution, or None for all-lung.
    Weights are drawn from ``generator`` (default: a generator seeded 0);
    the model is built in eval mode.  Under ``.train()`` the forward uses
    and updates the BatchNorm batch statistics and is differentiable.
    ``packed_decoder`` is the JAX model's attribute (the bf16 processor
    sets it): outside conv mode ``roll`` it sends the decoder convs to
    cuDNN, and under ``roll`` it is a gate of the quad stem; it adds no
    parameter.
    """

    def __init__(self, block: Type[nn.Module] = BasicBlock,
                 layers: Sequence[int] = (3, 4, 6, 3),
                 generator: Optional[torch.Generator] = None,
                 packed_decoder: bool = False):
        super().__init__(block, layers)
        self.packed_decoder = packed_decoder
        exp = block.expansion
        self.us1 = UpsampleConvBlock(512 * exp + 64 * exp, (64, 64))
        self.us2 = UpsampleConvBlock(64 + 64, (64, 64))
        self.us3 = nn.Sequential(nn.Conv3d(64, 32, 3, padding=1, bias=True),
                                 nn.BatchNorm3d(32), nn.ReLU())
        self.fcs = nn.ModuleList([nn.Conv3d(32, 1, 1, bias=True)
                                  for _ in range(2)])
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        init_weights(self, generator)
        self.eval()

    def _decoder_heads(self, x4, x1, stem) -> torch.Tensor:
        packed = self.packed_decoder
        xup1 = self.us1(x4, x1, packed)
        xup2 = self.us2(xup1, stem, packed)
        conv, bn, _ = self.us3
        roll = blocks.get_conv3d_mode() == "roll"
        if self.training or not roll:
            bn_fn = batch_norm_train if self.training else affine
            y = (roll_conv_bias(xup2, conv) if roll
                 else decoder_conv(xup2, conv, packed))
            x = torch.relu(bn_fn(y, bn))
            dt = x.dtype
            # 1x1x1 heads: logits rounded to the compute dtype, bias added
            # in it, sigmoid in float32 (JAX resnet3d.py:413-419)
            return torch.cat(
                [torch.sigmoid((torch.matmul(x, fc.weight.reshape(1, -1).t()
                                             .to(dt)) + fc.bias.to(dt))
                               .float()) for fc in self.fcs], dim=-1)
        mul, add = bn_affine(bn)
        head_w = torch.cat([fc.weight.reshape(1, -1).t() for fc in self.fcs],
                           dim=1)
        head_b = torch.cat([fc.bias for fc in self.fcs])
        return roll_conv_heads_sigmoid(xup2, kernel_dhwio(conv), mul,
                                       conv.bias.float() * mul + add,
                                       head_w, head_b)

    def forward(self, x: torch.Tensor, lungs: Optional[torch.Tensor] = None
                ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        stem, x1, x4 = self.trunk(x)
        dense = self._decoder_heads(x4, x1, stem)
        dense_outs = [dense[..., i:i + 1] for i in range(dense.shape[-1])]
        if lungs is None:
            lungs = torch.ones(x.shape[:1] + dense.shape[1:4] + (1,),
                               dtype=torch.float32, device=x.device)
        # one masked-sums call on both maps: the per-channel sums are
        # independent, so this is the JAX model's per-map reduction
        regs = lung_masked_fraction(dense, lungs)
        return dense_outs, [regs[:, i] for i in range(regs.shape[1])]
