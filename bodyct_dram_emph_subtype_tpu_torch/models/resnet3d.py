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

With the pair stem on (``set_pair_stem_enable``; eval, ``roll``,
``packed_decoder``) the route is the default one: the JAX pair stem
changes only the TPU layout of the stem activation that its pool + layer1
kernel reads (``ops/layer1_kernel.py:370`` into ``:388``), so in the
logical layout it is the stem conv, BN, ReLU and ``fused_pool_layer1``
(C + 2 x A per block).  For a Bottleneck arch JAX's pair path still builds
a BasicBlock layer1 and fails on the model's variables; the port raises
``ValueError``.

Activation checkpointing (``remat``, :func:`remat_scopes`; JAX
``resnet3d.py:40-53, 187-196, 285-311``): in the training forward each
residual block of a named layer, and for ``decoder`` the us1 and us2
stages (not us3, not the stem), run under ``blocks.checkpointed``, one
block or stage at a time.  The backward recomputes their forward, so the
``roll_conv_packed`` sites inside them launch kernel A once more
(:func:`train_remat_sites`); values, gradients and the BatchNorm
running statistics are those of the run without it.  The eval forward
ignores ``remat``.

On H slabs (``parallel/spatial.py``, inside ``spatial.sharded``) every
route above runs on this rank's slab with its halos (``models/blocks.py``,
``ops/layer1_kernel.py``): the kernels' launches per rank are those of one
process.  The heads' kernel B takes a one-row halo, the lesion fractions
sum their partial sums over the spatial group, and ``ResNetSegCls`` and
``ResNet`` sum their volume means over it.  On a model axis
(``parallel/tensor.py``) every conv whose O divides by M runs its O-slice
and each stage's output is gathered; kernel B runs whole on every model
rank with us3's weights and BatchNorm gathered.  The quad and pair stems
are off on either axis, with one warning, as JAX's gate turns its fast
path off on a spatial or model mesh (``mesh.py:129-133``,
``experimental.py:61-62``).

The JAX package's W-pair packing and space-to-depth stem are TPU layouts
and are not ported.

Under a running ``torch.profiler`` the Seg models' stages are spans
(``utils/spans.py``): ``trunk`` (``stem``, ``layer1``-``layer4``) and
``decoder`` (``us1``, ``us2`` and ``heads``: us3 and the heads); with no
profiler they record nothing.  A Seg model's ``forward(x, lungs,
mark=None)`` calls ``mark("decoder")``, if given, between the two: the
processor's device-side boundary (``inference/processor.py::
_StageClock``).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple, Type

import torch
import torch.nn as nn

from ..ops.layer1_kernel import fused_layer1, fused_pool_layer1, pool_k3s2p1
from ..ops.masked_pool import lung_masked_fraction
from ..ops.roll_conv import roll_conv_heads_sigmoid
from ..parallel import spatial, tensor
from ..parallel.mesh import all_sum
from ..ops.stem_kernel import fused_stem_pool, supports_fused_stem
from ..utils.spans import span
from . import blocks
from .blocks import (BasicBlock, UpsampleConvBlock, affine, batch_norm_train,
                     bn_affine, checkpointed, conv3d_ndhwc, decoder_kernels,
                     decoder_stage, init_weights, kernel_dhwio,
                     max_pool3d_ndhwc, mode_conv_op)
from .experimental import (set_pair_stem_enable,  # noqa: F401 (re-export)
                           set_quad_stem_enable, use_pair_stem,
                           use_quad_stem)

REMAT_SCOPES = frozenset({"layer1", "layer2", "layer3", "layer4", "decoder"})


def remat_scopes(remat) -> frozenset:
    """The scopes that ``remat`` checkpoints (JAX ``resnet3d.py:40-53``):
    ``True``/``"all"`` every residual layer and the decoder;
    ``False``/``None``/``"none"`` nothing; otherwise a comma list of
    scopes from {layer1..layer4, decoder}, stripped."""
    if remat is True or remat == "all":
        return REMAT_SCOPES
    if not remat or remat == "none":
        return frozenset()
    return frozenset(s.strip() for s in str(remat).split(",") if s.strip())


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


def train_remat_sites(sites: Sequence[Tuple[str, int, int, int]], remat
                      ) -> Tuple[Tuple[str, int, int, int], ...]:
    """The ``sites`` whose forward the backward recomputes under
    ``remat``: those in a checkpointed layer, and us1/us2's for
    ``decoder`` (us3 is never checkpointed)."""
    scopes = remat_scopes(remat)
    return tuple(s for s in sites if s[0].split(".")[0] in scopes
                 or ("decoder" in scopes and s[0].startswith(("us1.",
                                                               "us2."))))


def train_roll_launches(sites: Sequence[Tuple[str, int, int, int]],
                        remat=None) -> Dict[str, int]:
    """Kernel launches of one train step's ``roll_conv_packed`` sites: A
    forward + A dgrad and one D each, and one more A forward per site that
    ``remat`` recomputes (:func:`train_remat_sites`)."""
    return {"conv3x3x3_affine": (2 * len(sites)
                                 + len(train_remat_sites(sites, remat))),
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
                 shortcut_type: str = "A", remat=False):
        super().__init__()
        self.block = block
        self.remat = remat
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

    def _layer(self, name: str, x: torch.Tensor) -> torch.Tensor:
        """Layer ``name`` on ``x``; in training, each block checkpointed
        where ``remat`` names the layer."""
        layer = getattr(self, name)
        if not (self.training and name in remat_scopes(self.remat)):
            return layer(x)
        for blk in layer:
            x = checkpointed(blk, x)
        return x

    def trunk(self, x: torch.Tensor, packed_decoder: bool = False):
        """``packed_decoder``: the Seg model's, which gates the quad and
        pair stems (``ResNet`` passes none, as the JAX model gives its
        trunk neither)."""
        if self.training or blocks.get_conv3d_mode() != "roll":
            bn = batch_norm_train if self.training else affine
            with span("stem"):
                stem = tensor.gather_if(torch.relu(
                    bn(conv3d_ndhwc(x, self.conv1), self.bn1)), self.conv1)
            with span("layer1"):
                x = self._layer("layer1", max_pool3d_ndhwc(stem))
            x1 = x
            for name in ("layer2", "layer3", "layer4"):
                with span(name):
                    x = self._layer(name, x)
            return stem, x1, x
        quad = use_quad_stem(x.shape, False, packed_decoder, x.dtype)
        if (not quad and self.block is not BasicBlock
                and use_pair_stem(x.shape, False, packed_decoder, x.dtype,
                                  len(self.layer1))):
            raise ValueError(
                "the pair stem fuses the pool with a BasicBlock layer1; "
                "a Bottleneck arch cannot take it (the JAX pair path fails "
                "on its variables)")
        if quad:
            with span("stem"):
                stem, pooled = self._quad_stem(x)
            with span("layer1"):
                x1 = (fused_layer1(pooled, *_stack_params(self.layer1))
                      if self.block is BasicBlock else self.layer1(pooled))
        elif self.block is BasicBlock:
            # identity blocks: pool + the whole layer1 stack on kernels C, A
            with span("stem"):
                stem = self._stem(x)
            with span("layer1"):
                x1 = fused_pool_layer1(stem, *_stack_params(self.layer1))
        else:
            with span("stem"):
                stem = self._stem(x)
            with span("layer1"):
                x1 = self.layer1(pool_k3s2p1(stem))
        with span("layer2"):
            x2 = self.layer2[0](x1)
            if self.block is BasicBlock and len(self.layer2) > 1:
                x2 = fused_layer1(x2, *_stack_params(self.layer2[1:]))
            else:
                for blk in self.layer2[1:]:
                    x2 = blk(x2)
        with span("layer3"):
            x3 = self.layer3(x2)
        with span("layer4"):
            x4 = self.layer4(x3)
        return stem, x1, x4

    def _stem(self, x: torch.Tensor) -> torch.Tensor:
        """The eval stem conv (cuDNN), BN and ReLU, gathered on a model
        axis."""
        return tensor.gather_if(
            affine(conv3d_ndhwc(x, self.conv1), self.bn1, relu=True),
            self.conv1)

    def _quad_stem(self, x: torch.Tensor):
        """(stem, pooled) of the quad stem path: one launch of kernel E
        where the JAX gate ``supports_fused_stem`` holds, else the cuDNN
        conv, BN and ReLU and kernel C (``experimental.py:139-150``)."""
        mul, add = bn_affine(self.bn1)
        if supports_fused_stem(tuple(x.shape), 64, x.element_size()):
            return fused_stem_pool(x, kernel_dhwio(self.conv1), mul, add)
        stem = affine(conv3d_ndhwc(x, self.conv1), self.bn1, relu=True)
        return stem, pool_k3s2p1(stem)


def volume_mean(d: torch.Tensor) -> torch.Tensor:
    """The float32 mean of NDHWC ``d`` over (D, H, W): on H slabs the
    partial sums summed over the spatial group (differentiably)."""
    if not spatial.active():
        return d.float().mean((1, 2, 3))
    n = d.shape[1] * d.shape[2] * d.shape[3] * spatial.size()
    return all_sum(d.float().sum((1, 2, 3)), "spatial") / n


def _head_logits(x: torch.Tensor, fc: nn.Conv3d) -> torch.Tensor:
    """A 1x1x1 head conv on NDHWC ``x`` as a matmul: logits rounded to
    ``x.dtype``, the bias added in it (JAX ``conv3d(n, 1, bias=True)``;
    ``resnet3d.py:413-419``).  On a model axis a sliced head's logits are
    gathered; either way what follows is repeated whole on every model
    rank (``tensor.replicated``)."""
    dt = x.dtype
    w = fc.weight.reshape(fc.weight.shape[0], -1).t().to(dt)
    if tensor.sliced(fc):
        return tensor.replicated(tensor.gather_channels(
            torch.matmul(x, w) + fc.bias.to(dt)))
    return torch.matmul(tensor.replicated(x), w) + fc.bias.to(dt)


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
                 packed_decoder: bool = False, shortcut_type: str = "A",
                 remat=False):
        super().__init__(block, layers, shortcut_type, remat)
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

    def _encode(self, x: torch.Tensor, mark: Optional[Callable[[str], None]]
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """The trunk's (stem, layer1, layer4), then ``mark("decoder")`` if
        ``mark`` is given."""
        with span("trunk"):
            feats = self.trunk(x, self.packed_decoder)
        if mark is not None:
            mark("decoder")
        return feats

    def _up2(self, stem: torch.Tensor, x1: torch.Tensor, x4: torch.Tensor
             ) -> torch.Tensor:
        """us1 and us2: the decoder's 64-channel output.  In training us1
        and us2 are checkpointed where ``remat`` names the decoder."""
        run = (checkpointed if self.training
               and "decoder" in remat_scopes(self.remat)
               else lambda stage, *args: stage(*args))
        with span("us1"):
            xup1 = run(self.us1, x4, x1, self.packed_decoder)
        with span("us2"):
            return run(self.us2, xup1, stem, self.packed_decoder)

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
                 packed_decoder: bool = False, shortcut_type: str = "A",
                 remat=False):
        super().__init__(block, layers, (1, 1), generator, packed_decoder,
                         shortcut_type, remat)

    def _decoder_heads(self, xup2: torch.Tensor) -> torch.Tensor:
        if self.training or not decoder_kernels(self.packed_decoder):
            # sigmoid in float32 of the compute-dtype logits
            x = self._us3(xup2)
            return torch.cat([torch.sigmoid(_head_logits(x, fc).float())
                              for fc in self.fcs], dim=-1)
        conv, bn, _ = self.us3
        mul, add = bn_affine(bn)
        kernel, shift = kernel_dhwio(conv), conv.bias.float() * mul + add
        if tensor.sliced(conv):     # B runs whole: its heads need every
            # channel of us3 (about 55 k weights gathered)
            kernel, mul, shift = (tensor.gather_channels(t)
                                  for t in (kernel, mul, shift))
        head_w = torch.cat([fc.weight.reshape(1, -1).t() for fc in self.fcs],
                           dim=1)
        head_b = torch.cat([fc.bias for fc in self.fcs])
        return spatial.halo_apply(
            lambda x: roll_conv_heads_sigmoid(x, kernel, mul, shift, head_w,
                                              head_b), xup2, 3, 1, 1, 1)

    def forward(self, x: torch.Tensor, lungs: Optional[torch.Tensor] = None,
                mark: Optional[Callable[[str], None]] = None
                ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        feats = self._encode(x, mark)
        with span("decoder"):
            xup2 = self._up2(*feats)
            with span("heads"):     # us3 and the heads (packed: kernel B)
                dense = self._decoder_heads(xup2)
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
                 packed_decoder: bool = False, shortcut_type: str = "A",
                 remat=False):
        super().__init__(block, layers, tuple(n_classes), generator,
                         packed_decoder, shortcut_type, remat)

    def forward(self, x: torch.Tensor, lungs: Optional[torch.Tensor] = None,
                mark: Optional[Callable[[str], None]] = None
                ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        feats = self._encode(x, mark)
        with span("decoder"):
            xup2 = self._up2(*feats)
            with span("heads"):     # us3 and the heads
                xup3 = self._us3(xup2)
                dense_outs = [_head_logits(xup3, fc) for fc in self.fcs]
        # a float32 mean over ~2 M voxels per sample, never a bf16 sum
        return dense_outs, [volume_mean(d) for d in dense_outs]


class ResNet(_Trunk):
    """Plain classifier baseline (``med3d.py:427-501``): the trunk, a
    1x1x1 head ``fc`` of ``n_classes`` outputs on layer4 and its volume
    mean.  ``forward(x)`` -> (logits (B, n) float32, dense (B, D/8, H/8,
    W/8, n) in the compute dtype).  No decoder, so no quad stem.  Weights
    and modes as in :class:`_SegNet`."""

    def __init__(self, block: Type[nn.Module] = BasicBlock,
                 layers: Sequence[int] = (3, 4, 6, 3), n_classes: int = 6,
                 generator: Optional[torch.Generator] = None,
                 shortcut_type: str = "A", remat=False):
        super().__init__(block, layers, shortcut_type, remat)
        self.fc = nn.Conv3d(512 * block.expansion, n_classes, 1, bias=True)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        init_weights(self, generator)
        self.eval()

    def forward(self, x: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        _, _, x4 = self.trunk(x)
        dense = _head_logits(x4, self.fc)
        return volume_mean(dense), dense
