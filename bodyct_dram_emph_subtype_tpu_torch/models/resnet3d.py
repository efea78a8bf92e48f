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

``forward`` dispatches on ``self.training``.  The eval kernel sites
(always taken on a CUDA tensor, plain versions on CPU):

- stem max-pool + layer1 -> ``fused_pool_layer1`` (kernel C + 6 x A),
- layer2 blocks 1..n-1 -> ``fused_layer1`` (6 x A),
- us1 and us2 conv stages -> ``roll_conv_affine_relu`` (4 x A),
- us3 + heads + sigmoid -> ``roll_conv_heads_sigmoid`` (1 x B).

The stem conv, layer2 block 0 and the dilated layer3/4 run on cuDNN.

The training forward follows the JAX package's train-mode routing
(``packed_decoder=True``, conv mode ``roll``): every 3x3x3 conv of the
layer1 identity blocks and of us1/us2/us3 goes through ``roll_conv_packed``
(kernel A forward and dgrad, kernel D wgrad) — :data:`TRAIN_ROLL_SITES`
lists them — while the stem conv, layer2-4 (layer2 has stride 2, so the
JAX package never packs it in training) and the heads run on cuDNN / ATen,
the pool is ``F.max_pool3d`` (JAX: ``nn.max_pool``), BatchNorm uses batch
statistics (``blocks.batch_norm_train``) and the heads are
``sigmoid(conv1x1(x).float())``.

The JAX package's W-pair packing, space-to-depth stem, quad/pair stems,
``remat_scopes`` and conv-mode switches are TPU layouts and knobs and are
not ported.  ``ResNetSegCls`` and ``ResNet`` come with a later slice.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Type

import torch
import torch.nn as nn

from ..ops.layer1_kernel import fused_layer1, fused_pool_layer1
from ..ops.masked_pool import lung_masked_fraction
from ..ops.maxpool_kernel import max_pool_k3s2p1
from ..ops.roll_conv import roll_conv_heads_sigmoid
from .blocks import (BasicBlock, UpsampleConvBlock, affine, batch_norm_train,
                     bn_affine, conv3d_ndhwc, init_weights, kernel_dhwio,
                     max_pool3d_ndhwc, roll_conv_bias)

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
        if self.training:
            stem = torch.relu(batch_norm_train(conv3d_ndhwc(x, self.conv1),
                                               self.bn1))
            x1 = self.layer1(max_pool3d_ndhwc(stem))
            return stem, x1, self.layer4(self.layer3(self.layer2(x1)))
        stem = affine(conv3d_ndhwc(x, self.conv1), self.bn1, relu=True)
        if self.block is BasicBlock:
            # identity blocks: pool + the whole layer1 stack on kernels C, A
            x1 = fused_pool_layer1(stem, *_stack_params(self.layer1))
        else:
            x1 = self.layer1(max_pool_k3s2p1(stem))
        x2 = self.layer2[0](x1)
        if self.block is BasicBlock:
            x2 = fused_layer1(x2, *_stack_params(self.layer2[1:]))
        else:
            for blk in self.layer2[1:]:
                x2 = blk(x2)
        x4 = self.layer4(self.layer3(x2))
        return stem, x1, x4


class ResNetSegReg(_Trunk):
    """dRAM regression variant: ``forward(x, lungs)`` -> (dense_outs,
    reg_outs) with ``dense_outs`` two float32 (B, D/2, H/2, W/2, 1) sigmoid
    maps and ``reg_outs`` two (B,) lung-masked lesion fractions.

    ``x`` is (B, D, H, W, 1) in the compute dtype (float32 or bfloat16);
    ``lungs`` (B, D', H', W', 1) at any resolution, or None for all-lung.
    Weights are drawn from ``generator`` (default: a generator seeded 0);
    the model is built in eval mode.  Under ``.train()`` the forward uses
    and updates the BatchNorm batch statistics and is differentiable.
    """

    def __init__(self, block: Type[nn.Module] = BasicBlock,
                 layers: Sequence[int] = (3, 4, 6, 3),
                 generator: Optional[torch.Generator] = None):
        super().__init__(block, layers)
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
        xup1 = self.us1(x4, x1)
        xup2 = self.us2(xup1, stem)
        conv, bn, _ = self.us3
        if self.training:
            x = torch.relu(batch_norm_train(roll_conv_bias(xup2, conv), bn))
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
        reg_outs = [lung_masked_fraction(d, lungs)[:, 0] for d in dense_outs]
        return dense_outs, reg_outs
