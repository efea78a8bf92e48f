"""3x3x3 conv + fused epilogues: kernels A and B of the port.

Counterpart of ``bodyct_dram_emph_subtype_tpu/ops/roll_conv.py``:

- :func:`roll_conv_affine_relu` — ``relu?(conv(x)*scale + shift [+ res])``,
  kernel A (``csrc/conv3x3x3.cu::conv3x3x3_affine``).  Replaces the Pallas
  rolling-ring kernel ``_roll_conv_impl`` (roll_conv.py:311) at the decoder
  us1/us2 stages and, with the residual epilogue, every conv of the
  residual stacks that ``ops/layer1_kernel.py`` fuses.
- :func:`roll_conv_heads_sigmoid` — the us3 stage plus the 1x1x1 task
  heads and sigmoid, kernel B (``csrc/conv3x3x3.cu::
  conv3x3x3_heads_sigmoid``).  Replaces ``roll_conv_heads_sigmoid``
  (roll_conv.py:502): only the f32 maps are written, the us3 activation
  never reaches device memory.

- :func:`roll_conv_packed` — the training conv (no epilogue) as a
  ``torch.autograd.Function``: forward and input gradient (dgrad: the same
  conv on the output gradient with spatially flipped, I/O-transposed
  weights) on kernel A with an identity epilogue, weight gradient on
  kernel D (``csrc/conv3x3x3_wgrad.cu::conv3x3x3_wgrad``), rounded to the
  weights' dtype as ``_bwd`` rounds it (roll_conv.py:821).  Replaces the
  custom VJP ``roll_conv_packed`` (roll_conv.py:771-831) and its wgrad
  kernel ``roll_conv_wgrad`` (roll_conv.py:682).  The JAX VJP's
  ``_pad_pair_lanes`` is a TPU lane trick: the port's us3 dgrad is an
  ordinary kernel-A launch with C=32, O=64.
- :func:`identity_conv3d` — the conv of the opt-in conv modes ``pallas``,
  ``tapmm`` and ``flat`` (``ops/pallas_conv.py``, ``tap_conv.py``,
  ``flat_conv.py``): forward on kernel A with an identity epilogue at
  dilation 1, 2 or 4, backward through cuDNN as the JAX custom VJPs run
  theirs on the XLA conv (pallas_conv.py:127-130).

All take logical NDHWC activations and (3,3,3,C,O) weights — the JAX
kernels' W-pair packed layout and per-packed-channel vectors are a TPU
lane layout; ``pack_w``/``unpack_w`` and ``jnp.tile(v, 2)`` map one onto
the other.

Kernels A, B and D are bound by arithmetic.  In bfloat16 they run on the
tensor cores: one main loop (``csrc/mma_bf16.cuh``) of ``mma.sync``
m16n8k16 with float32 accumulators, fed by a 4-stage ``cp.async`` ring
in K steps of :data:`MMA_BK` elements; A and B tile the output in 128
voxels by :func:`conv_tile_n` channels, D tiles 27*C rows by O columns in
:data:`WGRAD_ROWS` x :data:`WGRAD_COLS` over :func:`wgrad_splits` voxel
ranges.  In float32 they run an FMA loop on the CUDA cores (the tensor
cores would round float32 operands to TF32).  The CUDA sources' headers
say more.

A wrapper given a CPU tensor runs the plain PyTorch version beside it
(``*_plain``, built on ``F.conv3d``); given a CUDA tensor it launches the
kernel or raises.  ``chip_smoke.py`` holds each kernel against its plain
version on the card.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from . import cuda_build

# The CUDA sources' tile constants (tests/test_torch_conv_tile_plan.py
# holds these against the constexpr values there).
MMA_BK, MMA_STAGES = 32, 4       # mma_bf16.cuh: K step, cp.async ring depth
CONV_TILE_M = 128                # kernels A, B: output voxels per block
CONV_TILE_N_SMALL, CONV_TILE_N_LARGE = 64, 128   # output channels per block
HEADS_MAX_OUT = CONV_TILE_N_SMALL  # kernel B keeps O in one column tile
HEADS_MAX = 8                    # kernel B's kMaxHeads
WGRAD_ROWS, WGRAD_COLS, WGRAD_K = 128, 64, 32   # kernel D's block tile
WGRAD_TARGET_BLOCKS = 2 * 132    # one wave at 2 blocks per H100 SM


def _dtype_code(t: torch.Tensor) -> int:
    if t.dtype == torch.float32:
        return 0
    if t.dtype == torch.bfloat16:
        return 1
    raise TypeError(f"kernel takes float32 or bfloat16, got {t.dtype}")


def _on_cuda(x: torch.Tensor) -> bool:
    """True: launch the kernel.  False: the tensor lies on the CPU and the
    plain version runs.  Any other device raises."""
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise RuntimeError(f"no kernel or plain version for device {x.device}")


def _require(t: torch.Tensor, shape, dtype, device, name: str) -> None:
    """Raise unless ``t`` is what a kernel takes: shape, dtype, device,
    contiguous."""
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name}: expected device {device}, got {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def conv3x3x3_f32(x: torch.Tensor, kernel: torch.Tensor,
                  dilation: int = 1) -> torch.Tensor:
    """Plain stride-1 3^3 conv with dilation and zero padding ``dilation``,
    NDHWC x (3,3,3,C,O) -> f32 NDHWC, computed in float32 from the
    (exactly widened) inputs."""
    y = F.conv3d(x.float().permute(0, 4, 1, 2, 3),
                 kernel.float().permute(4, 3, 0, 1, 2), padding=dilation,
                 dilation=dilation)
    return y.permute(0, 2, 3, 4, 1)


def roll_conv_affine_relu_plain(x, kernel, scale, shift, residual=None,
                                relu: bool = True,
                                dilation: int = 1) -> torch.Tensor:
    """Plain version of kernel A (weights rounded to ``x.dtype`` as the
    kernel takes them, f32 accumulate, one rounding at the end)."""
    y = (conv3x3x3_f32(x, kernel.to(x.dtype), dilation) * scale.float()
         + shift.float())
    if residual is not None:
        y = y + residual.float()
    if relu:
        y = torch.relu(y)
    return y.to(x.dtype).contiguous()


def roll_conv_affine_relu(x: torch.Tensor, kernel: torch.Tensor,
                          scale: torch.Tensor, shift: torch.Tensor,
                          residual: Optional[torch.Tensor] = None,
                          relu: bool = True, dilation: int = 1,
                          op: Optional[str] = None) -> torch.Tensor:
    """``relu?(conv3x3x3(x, kernel) * scale + shift [+ residual])``.

    ``x``: (B, D, H, W, C) float32 or bfloat16, contiguous; ``kernel``:
    (3, 3, 3, C, O); ``scale``/``shift``: (O,) — eval BatchNorm and conv
    bias folded by the caller; ``residual``: optional (B, D, H, W, O) in
    ``x.dtype``, added in float32 before the ReLU (the PackedBasicBlock
    order); ``dilation``: tap spacing and zero padding of the conv.
    Accumulates in float32, returns ``x.dtype``.  ``op`` names the
    conv-mode op a launch serves, for ``cuda_build.OP_LAUNCHES``."""
    if not _on_cuda(x):
        return roll_conv_affine_relu_plain(x, kernel, scale, shift,
                                           residual, relu, dilation)
    b, d, h, w, c = x.shape
    o = kernel.shape[-1]
    dev = x.device
    code = _dtype_code(x)
    _require(x, (b, d, h, w, c), x.dtype, dev, "x")
    kernel = kernel.to(device=dev, dtype=x.dtype).contiguous()
    scale = scale.to(device=dev, dtype=torch.float32).contiguous()
    shift = shift.to(device=dev, dtype=torch.float32).contiguous()
    _require(kernel, (3, 3, 3, c, o), x.dtype, dev, "kernel")
    _require(scale, (o,), torch.float32, dev, "scale")
    _require(shift, (o,), torch.float32, dev, "shift")
    if residual is not None:
        _require(residual, (b, d, h, w, o), x.dtype, dev, "residual")
    out = torch.empty((b, d, h, w, o), dtype=x.dtype, device=dev)
    with torch.cuda.device(dev):
        err = cuda_build.library().conv3x3x3_affine(
            code, x.data_ptr(), kernel.data_ptr(), scale.data_ptr(),
            shift.data_ptr(),
            None if residual is None else residual.data_ptr(),
            out.data_ptr(), b, d, h, w, c, o, int(relu), int(dilation),
            _stream(x))
    cuda_build.check(err, "conv3x3x3_affine")
    cuda_build.launched("conv3x3x3_affine", op)
    return out


def roll_conv_heads_sigmoid_plain(x, kernel, scale, shift, head_w,
                                  head_b) -> torch.Tensor:
    """Plain version of kernel B, with the rounding chain of the JAX
    kernel (roll_conv.py:466-474): activation rounded to the compute
    dtype, head logit and bias add in the compute dtype, f32 sigmoid."""
    dt = x.dtype
    act = torch.relu(conv3x3x3_f32(x, kernel.to(dt)) * scale.float()
                     + shift.float())
    act = act.to(dt).float()
    logit = torch.matmul(act, head_w.to(dt).float()).to(dt)
    logit = logit + head_b.float().to(dt)
    return torch.sigmoid(logit.float()).contiguous()


def roll_conv_heads_sigmoid(x: torch.Tensor, kernel: torch.Tensor,
                            scale: torch.Tensor, shift: torch.Tensor,
                            head_w: torch.Tensor,
                            head_b: torch.Tensor) -> torch.Tensor:
    """``sigmoid(heads(relu(conv3x3x3(x) * scale + shift)))``.

    ``x``: (B, D, H, W, C); ``kernel``: (3, 3, 3, C, O) with O <= 64;
    ``scale``/``shift``: (O,); ``head_w``: (O, HN) logical 1x1x1 head
    weights; ``head_b``: (HN,).  Returns float32 (B, D, H, W, HN) maps."""
    if not _on_cuda(x):
        return roll_conv_heads_sigmoid_plain(x, kernel, scale, shift,
                                             head_w, head_b)
    b, d, h, w, c = x.shape
    o = kernel.shape[-1]
    hn = head_w.shape[-1]
    if o > HEADS_MAX_OUT or not 0 < hn <= HEADS_MAX:
        raise ValueError(f"heads kernel takes O <= {HEADS_MAX_OUT} and "
                         f"1..{HEADS_MAX} heads, got O={o}, {hn} heads")
    dev = x.device
    code = _dtype_code(x)
    _require(x, (b, d, h, w, c), x.dtype, dev, "x")
    kernel = kernel.to(device=dev, dtype=x.dtype).contiguous()
    scale = scale.to(device=dev, dtype=torch.float32).contiguous()
    shift = shift.to(device=dev, dtype=torch.float32).contiguous()
    head_w = head_w.to(device=dev, dtype=x.dtype).contiguous()
    head_b = head_b.to(device=dev, dtype=torch.float32).contiguous()
    _require(kernel, (3, 3, 3, c, o), x.dtype, dev, "kernel")
    _require(scale, (o,), torch.float32, dev, "scale")
    _require(shift, (o,), torch.float32, dev, "shift")
    _require(head_w, (o, hn), x.dtype, dev, "head_w")
    _require(head_b, (hn,), torch.float32, dev, "head_b")
    out = torch.empty((b, d, h, w, hn), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = cuda_build.library().conv3x3x3_heads_sigmoid(
            code, x.data_ptr(), kernel.data_ptr(), scale.data_ptr(),
            shift.data_ptr(), head_w.data_ptr(), head_b.data_ptr(),
            out.data_ptr(), hn, b, d, h, w, c, o, _stream(x))
    cuda_build.check(err, "conv3x3x3_heads_sigmoid")
    cuda_build.launched("conv3x3x3_heads_sigmoid")
    return out


def conv3x3x3_dgrad_plain(g: torch.Tensor, kernel: torch.Tensor,
                          dilation: int = 1) -> torch.Tensor:
    """Plain input gradient of the stride-1 3^3 conv (dilation and zero
    padding ``dilation``): (B,D,H,W,O) ``g`` x (3,3,3,C,O) -> (B,D,H,W,C)
    in ``g.dtype``, computed in float32 from ``g`` and the weights rounded
    to ``g.dtype`` (as the kernel takes them), one rounding at the end."""
    b, d, h, w, _ = g.shape
    c = kernel.shape[3]
    dx = torch.nn.grad.conv3d_input(
        (b, c, d, h, w), kernel.to(g.dtype).float().permute(4, 3, 0, 1, 2),
        g.float().permute(0, 4, 1, 2, 3), padding=dilation,
        dilation=dilation)
    return dx.permute(0, 2, 3, 4, 1).to(g.dtype).contiguous()


def conv3x3x3_wgrad_plain(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Plain weight gradient: (B,D,H,W,C) ``x`` and (B,D,H,W,O) ``g`` ->
    float32 (3,3,3,C,O), computed in float32 from the exactly widened
    operands."""
    c, o = x.shape[-1], g.shape[-1]
    dw = torch.nn.grad.conv3d_weight(
        x.float().permute(0, 4, 1, 2, 3), (o, c, 3, 3, 3),
        g.float().permute(0, 4, 1, 2, 3), padding=1)
    return dw.permute(2, 3, 4, 1, 0).contiguous()


def conv3x3x3_dgrad(g: torch.Tensor, kernel: torch.Tensor,
                    dilation: int = 1) -> torch.Tensor:
    """Input gradient of the stride-1 3^3 conv (dilation and zero padding
    ``dilation``) (B,D,H,W,O) -> (B,D,H,W,C): on a CUDA tensor one launch
    of kernel A with an identity epilogue on the flipped, I/O-transposed
    weights at the same dilation; on a CPU tensor
    :func:`conv3x3x3_dgrad_plain`."""
    if not _on_cuda(g):
        return conv3x3x3_dgrad_plain(g, kernel, dilation)
    kt = kernel.flip((0, 1, 2)).transpose(3, 4).contiguous()
    return _identity_a(g, kt, dilation)


def conv_tile_n(o: int) -> int:
    """Kernel A's output channels per block in bfloat16 (``tile_n`` in
    ``csrc/conv3x3x3.cu``): 128 where that pads ``o`` to no more columns
    than 64 would (O = 70, 128, 256, 512), else 64."""
    small, large = CONV_TILE_N_SMALL, CONV_TILE_N_LARGE
    fits = -(-o // large) * large == -(-o // small) * small
    return large if o > small and fits else small


def wgrad_splits(m: int, c: int, o: int) -> int:
    """Kernel D's number S of voxel ranges for ``m`` voxels: as many as
    fill one wave of :data:`WGRAD_TARGET_BLOCKS` blocks without starting a
    second, at least 4 K steps per range."""
    tiles = -(-27 * c // WGRAD_ROWS) * -(-o // WGRAD_COLS)
    return max(1, min(WGRAD_TARGET_BLOCKS // tiles,
                      -(-m // (4 * WGRAD_K)), 65535))


def wgrad_chunk(m: int, splits: int) -> int:
    """Voxels per range of kernel D's ``splits`` ranges over ``m`` voxels,
    a multiple of the K step (``launch_wgrad`` in
    ``csrc/conv3x3x3_wgrad.cu``); the last ranges may be short or
    empty."""
    per = -(-m // splits)
    return -(-per // WGRAD_K) * WGRAD_K


def conv3x3x3_wgrad(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Weight gradient ``dW[kd,kh,kw,c,o] = sum x[b,d+kd-1,h+kh-1,w+kw-1,c]
    * g[b,d,h,w,o]`` (x zero outside the volume): (B,D,H,W,C) ``x`` and
    (B,D,H,W,O) ``g``, both float32 or both bfloat16 and contiguous ->
    float32 (3,3,3,C,O).  On a CUDA tensor kernel D (partials over
    :func:`wgrad_splits` voxel ranges, summed in a fixed order); on a CPU
    tensor :func:`conv3x3x3_wgrad_plain`."""
    if not _on_cuda(x):
        return conv3x3x3_wgrad_plain(x, g)
    b, d, h, w, c = x.shape
    o = g.shape[-1]
    dev = x.device
    code = _dtype_code(x)
    _require(x, (b, d, h, w, c), x.dtype, dev, "x")
    _require(g, (b, d, h, w, o), x.dtype, dev, "g")
    splits = wgrad_splits(b * d * h * w, c, o)
    out = torch.empty((3, 3, 3, c, o), dtype=torch.float32, device=dev)
    ws = (torch.empty((splits, 27 * c, o), dtype=torch.float32, device=dev)
          if splits > 1 else None)
    with torch.cuda.device(dev):
        err = cuda_build.library().conv3x3x3_wgrad(
            code, x.data_ptr(), g.data_ptr(),
            None if ws is None else ws.data_ptr(), out.data_ptr(),
            b, d, h, w, c, o, splits, _stream(x))
    cuda_build.check(err, "conv3x3x3_wgrad")
    cuda_build.launched("conv3x3x3_wgrad")
    return out


def _identity_a(x: torch.Tensor, kernel: torch.Tensor, dilation: int = 1,
                op: Optional[str] = None) -> torch.Tensor:
    """Kernel A with an identity epilogue (scale 1, shift 0, no ReLU)."""
    o = kernel.shape[-1]
    one = torch.ones(o, dtype=torch.float32, device=x.device)
    zero = torch.zeros(o, dtype=torch.float32, device=x.device)
    return roll_conv_affine_relu(x, kernel, one, zero, relu=False,
                                 dilation=dilation, op=op)


class _RollConvPacked(torch.autograd.Function):
    """Forward: kernel A, identity epilogue.  Backward: dgrad on kernel A,
    wgrad on kernel D rounded to the weights' dtype (roll_conv.py:821)."""

    @staticmethod
    def forward(ctx, x, kernel):
        x = x.contiguous()
        ctx.save_for_backward(x, kernel)
        return _identity_a(x, kernel)

    @staticmethod
    def backward(ctx, g):
        x, kernel = ctx.saved_tensors
        g = g.contiguous()
        dx = conv3x3x3_dgrad(g, kernel) if ctx.needs_input_grad[0] else None
        dw = (conv3x3x3_wgrad(x, g).to(kernel.dtype)
              if ctx.needs_input_grad[1] else None)
        return dx, dw


def roll_conv_packed(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Differentiable stride-1 pad-1 3^3 conv without bias or epilogue:
    NDHWC ``x`` (B,D,H,W,C) in the compute dtype x (3,3,3,C,O) ``kernel``
    in the same dtype -> (B,D,H,W,O) in that dtype (float32 accumulation,
    one rounding).  Each call runs one kernel-A launch forward and, in the
    backward, one kernel-A launch (dgrad) and one kernel-D launch
    (wgrad)."""
    if x.dtype != kernel.dtype:
        raise TypeError(f"x is {x.dtype} but kernel is {kernel.dtype}: cast "
                        f"the weights to the compute dtype first")
    return _RollConvPacked.apply(x, kernel)


class _IdentityConv3d(torch.autograd.Function):
    """Forward: kernel A, identity epilogue, at ``dilation``.  Backward:
    the conv's input and weight gradients through cuDNN in the dtypes of
    ``x`` and of the kernel, as the JAX custom VJPs differentiate
    ``_direct_conv3d`` (pallas_conv.py:127-130, tap_conv.py:181-184,
    flat_conv.py:200-203)."""

    @staticmethod
    def forward(ctx, x, kernel, dilation, op):
        x = x.contiguous()
        ctx.save_for_backward(x, kernel)
        ctx.dilation = dilation
        return _identity_a(x, kernel, dilation, op)

    @staticmethod
    def backward(ctx, g):
        x, kernel = ctx.saved_tensors
        d = ctx.dilation
        xt = x.permute(0, 4, 1, 2, 3)
        kt = kernel.permute(4, 3, 0, 1, 2)
        gt = g.permute(0, 4, 1, 2, 3)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = torch.nn.grad.conv3d_input(xt.shape, kt, gt, padding=d,
                                            dilation=d)
            dx = dx.permute(0, 2, 3, 4, 1).contiguous()
        if ctx.needs_input_grad[1]:
            dw = torch.nn.grad.conv3d_weight(xt, kt.shape, gt, padding=d,
                                             dilation=d)
            dw = dw.permute(2, 3, 4, 1, 0).contiguous()
        return dx, dw, None, None


def identity_conv3d(x: torch.Tensor, kernel: torch.Tensor,
                    dilation: int = 1, op: Optional[str] = None
                    ) -> torch.Tensor:
    """Differentiable stride-1 3^3 conv without bias or epilogue, tap
    spacing and zero padding ``dilation``: NDHWC ``x`` (B,D,H,W,C) x
    (3,3,3,C,O) ``kernel``, both in the compute dtype -> (B,D,H,W,O) in it
    (float32 accumulation, one rounding).  One kernel-A launch forward
    (counted for ``op`` too); the backward runs on cuDNN."""
    if x.dtype != kernel.dtype:
        raise TypeError(f"x is {x.dtype} but kernel is {kernel.dtype}: cast "
                        f"the weights to the compute dtype first")
    return _IdentityConv3d.apply(x, kernel, dilation, op)
