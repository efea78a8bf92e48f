"""The 3-D ResNet models, NDHWC: ``ResNetSegReg`` (dRAM regression),
``ResNetSegCls`` (classification) and the plain ``ResNet``.

Counterpart of ``bodyct_dram_emph_subtype_tpu/models/resnet3d.py``
(``_Trunk``, ``_Decoder``, ``ResNetSegReg``, ``ResNetSegCls``, ``ResNet``;
reference ``med3d.py:187-501``): conv1 k7 s2 -> max-pool k3 s2 -> layer1
(64) -> layer2 (128, s2) -> layer3 (256, dilation 2) -> layer4 (512,
dilation 4).  The two Seg models share the trunk and the decoder
(:class:`_SegNet`): us1 (x2 up + concat layer1 + 2 convs), us2 (x2 up +
concat stem + 2 convs), us3 (conv 64->32), then 1x1x1 heads at half the
input resolution.  ``ResNetSegReg``: two sigmoid heads reduced to
lung-masked lesion fractions.  ``ResNetSegCls``: two logit heads (6 and
3 classes) averaged over the volume.  ``ResNet``: the trunk and one
1x1x1 head on layer4, averaged.  Every block takes the shortcut type 'A'
(zero-padded subsample) or 'B' (1x1x1 conv + BN, ``blocks.DownsampleB``).

Module names equal the reference checkpoint's keys (``conv1``, ``bn1``,
``layerN.i.convK/bnK``, ``layerN.i.downsample.0/1``,
``us1.conv_blocks.i.0/1``, ``us3.0/1``, ``fcs.i``, ``fc``), so a reference
``best.ckpt`` state dict (``model.`` prefix stripped) loads with
``load_state_dict`` (``models/torch_import.py``).

``forward`` dispatches on ``self.training``, on the conv mode
(``blocks.set_conv3d_mode``) and on ``packed_decoder``, as the JAX model
routes (``resnet3d.py:96-118, 160-245, 399-402``, ``packed.py``).  The
eval kernel sites under ``roll`` (the port's default; taken on a CUDA
tensor, plain versions on CPU; :func:`roll_eval_sites`):

- BasicBlock archs: stem max-pool + layer1 -> ``fused_pool_layer1``
  (kernel C + 2 x A per block), and layer2 blocks 1..n-1 ->
  ``fused_layer1`` (2 x A per block); Bottleneck archs: the pool alone on
  kernel C.  These trunk sites do not depend on the decoder.
- The packed decoder only (``packed_decoder=True``, which the bf16
  processor builds): us1 and us2 conv stages -> ``roll_conv_affine_relu``
  (4 x A); for ``ResNetSegReg`` us3 + heads + sigmoid ->
  ``roll_conv_heads_sigmoid`` (1 x B), for ``ResNetSegCls`` us3 ->
  ``roll_conv_affine_relu`` (1 x A, O = 32) and its plain logit heads
  (``packed_stage``, JAX ``packed.py:395-418``).  The unpacked decoder
  (the trainers' default, the float32 processor) runs each stage as conv
  (cuDNN), eval BN and ReLU with the JAX unpacked rounding chain, and
  unfused heads.
- ``ResNet`` takes the trunk's sites only.

In every mode, eval and training, the lesion fractions of both dRAM maps
are one ``lung_masked_fraction`` call (1 x F, ``ops/pallas_kernels.py``);
the classification models have no lesion fraction and no F.

The stem conv, layer2 block 0 and the dilated layer3/4 run on cuDNN.
With the quad stem on (``set_quad_stem_enable``, ``models/experimental.py``;
eval, ``roll``, ``packed_decoder``) the stem conv, BN, ReLU and pool run
as one launch of kernel E and layer1 as ``fused_layer1``.

The training forward under ``roll`` sends through ``roll_conv_packed``
(kernel A forward and dgrad, kernel D wgrad) the convs that the JAX train
step sends through its kernels 6/7 (:func:`train_roll_sites`): every
3x3x3 conv of the layer1 identity BasicBlocks, whatever the decoder, and
the five us1/us2/us3 convs for the packed decoder only
(:data:`TRAIN_ROLL_SITES`: med3ddram's 11, and med3d's, whose us3 trains
as the dRAM model's does).  The stem conv, layer2-4 (layer2 has stride 2,
so the JAX package never packs it in training), the shortcut-'B' convs,
the unpacked decoder and the heads run on cuDNN / ATen, the pool is
``F.max_pool3d`` (JAX: ``nn.max_pool``), BatchNorm uses batch statistics
(``blocks.batch_norm_train``) and the heads are 1x1x1 convs as matmuls,
rounded to the compute dtype (then ``sigmoid(.float())`` for dRAM).

The JAX package gates its kernels further on TPU budgets: VMEM plans
(``supports_fused_pool_layer1``, ``supports_fused_layer1``,
``supports_roll_conv``, ``supports_roll_heads``,
``supports_maxpool_pallas``) and a size floor, ``_ROLL_MIN_ELEMS``
(``packed.py:259-295``, measured on the v5e: its roll kernels lost to XLA
on small stages).  The port deliberately does not copy them: its kernels
have no VMEM plan and take every shape, so where such a gate fails the
port takes its kernels and the JAX package XLA: off the deployment shape,
and at it for med3ddram50's us1.conv0, whose C = 2048 + 256 = 2304 input
outgrows the roll kernel's VMEM plan.  The numbers agree within the
calibrated bf16 bounds (``tests/test_torch_routing.py``); every other
route is the same at the deployment shape (``tests/test_torch_routing.py``,
``test_torch_train_sites.py``, ``test_torch_conv_mode_sites.py``).  Only
the quad stem copies its JAX gates (``supports_fused_stem``,
``experimental.stem_quad_supported``), as an opt-in switch.

Under the conv modes ``pallas``, ``tapmm`` and ``flat`` (eval and
training) no module-level kernel site is taken, as in the JAX package,
where every packed and fused route needs ``roll`` (``packed.py:481, 496,
512, 527``): the pool is ``F.max_pool3d``, every block runs unpacked, the
heads are unfused, and each 3^3 conv that the mode's JAX gate accepts runs
on kernel A through ``blocks.conv3d_apply`` — :func:`mode_conv_sites`
lists them.  There the packed decoder's convs go to cuDNN
(``packed.py:318-328``).

The JAX package's W-pair packing, space-to-depth stem, pair stem and
``remat_scopes`` are TPU layouts and knobs and are not ported.
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
                     bn_affine, conv3d_ndhwc, decoder_kernels, decoder_stage,
                     init_weights, kernel_dhwio, max_pool3d_ndhwc,
                     mode_conv_op)
from .experimental import (set_quad_stem_enable,  # noqa: F401 (re-export)
                           use_quad_stem)

def train_roll_sites(layers: Sequence[int] = (3, 4, 6, 3),
                     block: Type[nn.Module] = BasicBlock,
                     packed_decoder: bool = True
                     ) -> Tuple[Tuple[str, int, int, int], ...]:
    """The training sites of ``roll_conv_packed`` under conv mode ``roll``:
    (module name of the conv, spatial divisor of its input against the
    model input, C, O).  As in the JAX train step: every 3x3x3 conv of the
    layer1 identity BasicBlocks (``supports_packed_layer``, whatever the
    decoder), and the five decoder convs only for the packed decoder
    (``PackedConv3``).  The JAX package runs kernels 6 (forward + dgrad)
    at each and kernel 7 (wgrad) at all but us3, whose 2*32 packed
    gradient lanes go to XLA; the port sends every wgrad to kernel D."""
    sites: Tuple[Tuple[str, int, int, int], ...] = ()
    if block is BasicBlock:
        sites += tuple((f"layer1.{i}.conv{j}", 4, 64, 64)
                       for i in range(layers[0]) for j in (1, 2))
    if packed_decoder:
        cat = (512 + 64) * block.expansion      # layer4 + layer1 channels
        sites += (("us1.conv_blocks.0.0", 4, cat, 64),
                  ("us1.conv_blocks.1.0", 4, 64, 64),
                  ("us2.conv_blocks.0.0", 2, 128, 64),
                  ("us2.conv_blocks.1.0", 2, 64, 64), ("us3.0", 2, 64, 32))
    return sites


# med3ddram (resnet34segreg) with the packed decoder: the 11 sites
TRAIN_ROLL_SITES = train_roll_sites()


def train_roll_site_shapes(batch: int, size: Sequence[int],
                           sites: Sequence[Tuple[str, int, int, int]]
                           = TRAIN_ROLL_SITES):
    """``[(name, input shape (B, D, H, W, C), O)]`` of ``sites`` (default
    :data:`TRAIN_ROLL_SITES`) for a (batch, *size) model input."""
    return [(name, (batch, *(s // div for s in size), c), o)
            for name, div, c, o in sites]


def train_roll_launches(sites: Sequence[Tuple[str, int, int, int]]
                        ) -> Dict[str, int]:
    """Kernel launches of one train step's ``roll_conv_packed`` sites: A
    forward + A dgrad and one D each."""
    return {"conv3x3x3_affine": 2 * len(sites),
            "conv3x3x3_wgrad": len(sites)}


def roll_eval_sites(layers: Sequence[int], quad: bool = False,
                    packed_decoder: bool = True,
                    block: Type[nn.Module] = BasicBlock, kind: str = "reg"
                    ) -> List[Tuple[str, str, Dict[str, int]]]:
    """The kernel sites of an eval forward under conv mode ``roll`` where
    every JAX shape gate passes (the deployment shape): ``[(site, JAX
    kernel module, {port kernel: launches})]``, one entry per JAX
    ``pallas_call`` site.  ``kind``: ``"reg"`` (``ResNetSegReg``),
    ``"cls"`` (``ResNetSegCls``) or ``"plain"`` (``ResNet``: the trunk
    alone, never the quad stem).  ``quad``: the quad stem on and
    ``supports_fused_stem`` holding (kernel E).  The trunk's sites do not
    depend on the decoder; the decoder's stages are taken only for the
    packed decoder (JAX ``resnet3d.py:399-402``), where us3 is one more A
    for ``cls`` and fused with the heads into B for ``reg``."""
    if kind not in ("reg", "cls", "plain"):
        raise ValueError(f"kind must be 'reg', 'cls' or 'plain', not "
                         f"{kind!r}")
    a = "conv3x3x3_affine"
    basic = block is BasicBlock
    if quad and kind != "plain":
        head = [("conv1+bn1+pool", "stem_kernel", {"stem_pool": 1})]
        if basic:
            head.append(("layer1", "layer1_kernel", {a: 2 * layers[0]}))
    elif basic:
        head = [("pool+layer1", "layer1_kernel",
                 {"max_pool3d_k3s2p1": 1, a: 2 * layers[0]})]
    else:
        head = [("stem.pool", "maxpool_kernel", {"max_pool3d_k3s2p1": 1})]
    if basic and layers[1] > 1:
        head.append(("layer2.tail", "layer1_kernel",
                     {a: 2 * (layers[1] - 1)}))
    if kind == "plain" or not packed_decoder:
        return head
    us3 = (("us3", "roll_conv", {a: 1}) if kind == "cls" else
           ("us3+heads", "roll_conv", {"conv3x3x3_heads_sigmoid": 1}))
    return head + [(f"us{i}.conv_blocks.{j}.0", "roll_conv", {a: 1})
                   for i in (1, 2) for j in (0, 1)] + [us3]


def site_launches(sites: Sequence[Tuple[str, str, Dict[str, int]]]
                  ) -> Dict[str, int]:
    """The port's kernel launches over :func:`roll_eval_sites` ``sites``."""
    total: Dict[str, int] = {}
    for _, _, counts in sites:
        for k, n in counts.items():
            total[k] = total.get(k, 0) + n
    return total


def _ceil_div(shape: Sequence[int], s: int) -> Tuple[int, ...]:
    return tuple(-(-n // s) for n in shape)


def conv3d_apply_sites(model: "_Trunk", batch: int,
                       size: Sequence[int]
                       ) -> List[Tuple[str, Tuple[int, ...], nn.Conv3d]]:
    """``[(module name, NDHWC input shape, conv)]`` of every conv that the
    forward outside conv mode ``roll`` sends through ``blocks.conv3d_apply``
    for a (batch, *size) input, in forward order: every conv of the
    residual layers (the shortcut-'B' 1x1x1 convs too) and, for a Seg
    model with the unpacked decoder, the five decoder convs.  The stem
    conv and the heads never go through it."""
    sites = []
    s = _ceil_div(_ceil_div(size, 2), 2)          # stem, pool
    outs = []
    for lname in ("layer1", "layer2", "layer3", "layer4"):
        for i, blk in enumerate(getattr(model, lname)):
            s_in = s
            for cname, conv in blk.named_modules():
                if not isinstance(conv, nn.Conv3d):
                    continue
                shape = s if cname.startswith("conv") else s_in
                sites.append((f"{lname}.{i}.{cname}",
                              (batch, *shape, conv.in_channels), conv))
                if cname.startswith("conv"):
                    s = _ceil_div(s, conv.stride[0])
        outs.append(s)
    if isinstance(model, _SegNet) and not model.packed_decoder:
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


def mode_conv_sites(model: "_Trunk", mode: str, batch: int,
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

    def __init__(self, block: Type[nn.Module], layers: Sequence[int],
                 shortcut_type: str = "A"):
        super().__init__()
        self.block = block
        self.conv1 = nn.Conv3d(1, 64, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm3d(64)
        self.inplanes = 64
        self.shortcut_type = shortcut_type
        self.layer1 = self._make_layer(block, 64, layers[0], 1, 1)
        self.layer2 = self._make_layer(block, 128, layers[1], 2, 1)
        self.layer3 = self._make_layer(block, 256, layers[2], 1, 2)
        self.layer4 = self._make_layer(block, 512, layers[3], 1, 4)
        if block is BasicBlock:
            # identity blocks: the training convs go through the kernels
            for blk in self.layer1:
                blk.roll_train = True

    def _make_layer(self, block, planes, blocks, stride, dilation):
        mods = [block(self.inplanes, planes, stride, dilation,
                      self.shortcut_type)]
        self.inplanes = planes * block.expansion
        mods += [block(self.inplanes, planes, 1, dilation)
                 for _ in range(1, blocks)]
        return nn.Sequential(*mods)

    def trunk(self, x: torch.Tensor, packed_decoder: bool = False):
        """``packed_decoder``: the Seg model's, which gates the quad stem
        (``ResNet`` passes none, as the JAX model gives its trunk no quad
        stem)."""
        if self.training or blocks.get_conv3d_mode() != "roll":
            bn = batch_norm_train if self.training else affine
            stem = torch.relu(bn(conv3d_ndhwc(x, self.conv1), self.bn1))
            x1 = self.layer1(max_pool3d_ndhwc(stem))
            return stem, x1, self.layer4(self.layer3(self.layer2(x1)))
        if use_quad_stem(x.shape, False, packed_decoder, x.dtype):
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
        if self.block is BasicBlock and len(self.layer2) > 1:
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


def _head_logits(x: torch.Tensor, fc: nn.Conv3d) -> torch.Tensor:
    """A 1x1x1 head conv on NDHWC ``x`` as a matmul: logits rounded to
    ``x.dtype``, the bias added in it (JAX ``conv3d(n, 1, bias=True)``;
    ``resnet3d.py:413-419``)."""
    dt = x.dtype
    w = fc.weight.reshape(fc.out_channels, -1).t().to(dt)
    return torch.matmul(x, w) + fc.bias.to(dt)


class _SegNet(_Trunk):
    """The trunk and the us1/us2/us3 decoder that ``ResNetSegReg`` and
    ``ResNetSegCls`` share, with one 1x1x1 head of ``n`` outputs per entry
    of ``heads`` (``fcs.i``).  ``packed_decoder`` is the JAX model's
    attribute (the bf16 processor sets it): outside conv mode ``roll`` it
    sends the decoder convs to cuDNN, and under ``roll`` it gates the
    decoder's kernels (``blocks.decoder_kernels``) and the quad stem; it
    adds no parameter.  Weights are drawn from ``generator`` (default: a
    generator seeded 0); the model is built in eval mode.  Under
    ``.train()`` the forward uses and updates the BatchNorm batch
    statistics and is differentiable."""

    def __init__(self, block: Type[nn.Module], layers: Sequence[int],
                 heads: Sequence[int],
                 generator: Optional[torch.Generator] = None,
                 packed_decoder: bool = False, shortcut_type: str = "A"):
        super().__init__(block, layers, shortcut_type)
        self.packed_decoder = packed_decoder
        exp = block.expansion
        self.us1 = UpsampleConvBlock(512 * exp + 64 * exp, (64, 64))
        self.us2 = UpsampleConvBlock(64 + 64, (64, 64))
        self.us3 = nn.Sequential(nn.Conv3d(64, 32, 3, padding=1, bias=True),
                                 nn.BatchNorm3d(32), nn.ReLU())
        self.fcs = nn.ModuleList([nn.Conv3d(32, n, 1, bias=True)
                                  for n in heads])
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        init_weights(self, generator)
        self.eval()

    def _up2(self, x: torch.Tensor) -> torch.Tensor:
        """The trunk, us1 and us2: the decoder's 64-channel output."""
        stem, x1, x4 = self.trunk(x, self.packed_decoder)
        xup1 = self.us1(x4, x1, self.packed_decoder)
        return self.us2(xup1, stem, self.packed_decoder)

    def _us3(self, xup2: torch.Tensor) -> torch.Tensor:
        conv, bn, _ = self.us3
        return decoder_stage(xup2, conv, bn, self.packed_decoder,
                             self.training)


class ResNetSegReg(_SegNet):
    """dRAM regression variant: ``forward(x, lungs)`` -> (dense_outs,
    reg_outs) with ``dense_outs`` two float32 (B, D/2, H/2, W/2, 1) sigmoid
    maps and ``reg_outs`` two (B,) lung-masked lesion fractions.

    ``x`` is (B, D, H, W, 1) in the compute dtype (float32 or bfloat16);
    ``lungs`` (B, D', H', W', 1) at any resolution, or None for all-lung.
    See :class:`_SegNet` for the weights, the modes and ``packed_decoder``.
    """

    def __init__(self, block: Type[nn.Module] = BasicBlock,
                 layers: Sequence[int] = (3, 4, 6, 3),
                 generator: Optional[torch.Generator] = None,
                 packed_decoder: bool = False, shortcut_type: str = "A"):
        super().__init__(block, layers, (1, 1), generator, packed_decoder,
                         shortcut_type)

    def _decoder_heads(self, xup2: torch.Tensor) -> torch.Tensor:
        if self.training or not decoder_kernels(self.packed_decoder):
            # sigmoid in float32 of the compute-dtype logits
            x = self._us3(xup2)
            return torch.cat([torch.sigmoid(_head_logits(x, fc).float())
                              for fc in self.fcs], dim=-1)
        conv, bn, _ = self.us3
        mul, add = bn_affine(bn)
        head_w = torch.cat([fc.weight.reshape(1, -1).t() for fc in self.fcs],
                           dim=1)
        head_b = torch.cat([fc.bias for fc in self.fcs])
        return roll_conv_heads_sigmoid(xup2, kernel_dhwio(conv), mul,
                                       conv.bias.float() * mul + add,
                                       head_w, head_b)

    def forward(self, x: torch.Tensor, lungs: Optional[torch.Tensor] = None
                ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        dense = self._decoder_heads(self._up2(x))
        dense_outs = [dense[..., i:i + 1] for i in range(dense.shape[-1])]
        if lungs is None:
            lungs = torch.ones(x.shape[:1] + dense.shape[1:4] + (1,),
                               dtype=torch.float32, device=x.device)
        # one masked-sums call on both maps: the per-channel sums are
        # independent, so this is the JAX model's per-map reduction
        regs = lung_masked_fraction(dense, lungs)
        return dense_outs, [regs[:, i] for i in range(regs.shape[1])]


class ResNetSegCls(_SegNet):
    """Classification variant (``med3d.py:187-285``): ``forward(x,
    lungs=None)`` -> (dense_outs, cls_outs) with ``dense_outs`` one
    (B, D/2, H/2, W/2, n) logit map per entry of ``n_classes``, in the
    compute dtype, and ``cls_outs`` their (B, n) float32 means over the
    volume.  ``lungs`` is accepted and unused, as in the JAX model.  See
    :class:`_SegNet` for the weights, the modes and ``packed_decoder``."""

    def __init__(self, block: Type[nn.Module] = BasicBlock,
                 layers: Sequence[int] = (3, 4, 6, 3),
                 n_classes: Sequence[int] = (6, 3),
                 generator: Optional[torch.Generator] = None,
                 packed_decoder: bool = False, shortcut_type: str = "A"):
        super().__init__(block, layers, tuple(n_classes), generator,
                         packed_decoder, shortcut_type)

    def forward(self, x: torch.Tensor, lungs: Optional[torch.Tensor] = None
                ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        xup3 = self._us3(self._up2(x))
        dense_outs = [_head_logits(xup3, fc) for fc in self.fcs]
        # a float32 mean over ~2 M voxels per sample, never a bf16 sum
        return dense_outs, [d.float().mean((1, 2, 3)) for d in dense_outs]


class ResNet(_Trunk):
    """Plain classifier baseline (``med3d.py:427-501``): the trunk, a
    1x1x1 head ``fc`` of ``n_classes`` outputs on layer4 and its volume
    mean.  ``forward(x)`` -> (logits (B, n) float32, dense (B, D/8, H/8,
    W/8, n) in the compute dtype).  No decoder, so no quad stem.  Weights
    and modes as in :class:`_SegNet`."""

    def __init__(self, block: Type[nn.Module] = BasicBlock,
                 layers: Sequence[int] = (3, 4, 6, 3), n_classes: int = 6,
                 generator: Optional[torch.Generator] = None,
                 shortcut_type: str = "A"):
        super().__init__(block, layers, shortcut_type)
        self.fc = nn.Conv3d(512 * block.expansion, n_classes, 1, bias=True)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        init_weights(self, generator)
        self.eval()

    def forward(self, x: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        _, _, x4 = self.trunk(x)
        dense = _head_logits(x4, self.fc)
        return dense.float().mean((1, 2, 3)), dense
