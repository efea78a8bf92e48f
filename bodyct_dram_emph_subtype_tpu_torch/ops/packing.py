"""10- and 12-bit CT packing for the host-to-device upload.

Counterpart of ``bodyct_dram_emph_subtype_tpu/ops/packing.py``: the host
packers are numpy copies of the JAX package's, byte for byte; the device
unpackers are torch and run on the packed tensor's device.

- 12-bit planar pack (``pack12_host`` / ``unpack12_device``): the flat
  volume's halves ``v0``, ``v1`` (HU + 2048, clipped to 0..4095) travel as
  three byte planes ``v0 & 0xFF``, ``(v0 >> 8) | ((v1 & 0xF) << 4)``,
  ``v1 >> 4``: 1.5 bytes per voxel, exact for HU in -2048..2047.
- 10-bit window-domain pack (``pack10_host`` / ``unpack10_device``): every
  consumer of the raw CT on the device clips it to the HU window
  ``WINDOW_LO..WINDOW_HI`` first, and both emphysema thresholds (-950,
  -910) lie strictly inside it, so clamping on the host before packing
  changes no number downstream.  The 851 levels travel as the low 8 bits
  (N bytes) and the 2 high bits of the four N/4-voxel quarters packed into
  N/4 bytes (quarter k in bits 2k..2k+1): 1.25 bytes per voxel.
- block-gated 10-bit stream (``pack10_gated_host`` /
  ``unpack10_gated_device``): only the ``block``-voxel flat blocks with a
  live voxel (``> WINDOW_LO``) travel, whole and window-clamped, in flat
  order into a static ``budget``-voxel stream, plus one gate bit per
  block; a dropped block holds only voxels at or below the window floor,
  which clamp to ``WINDOW_LO`` — exactly what the device writes there.
  The device takes each live block's stream slot as the exclusive prefix
  sum of the gate bits and gathers whole blocks.

The device unpackers work in integers up to the final float32 cast, so
their results are bit-equal to the JAX package's.
"""
from __future__ import annotations

import numpy as np
import torch

OFFSET = 2048

# The transport window, equal to ops.preprocess.WINDOW (pinned by a test)
WINDOW_LO = -1150
WINDOW_HI = -300

# Gate block in voxels: the JAX package's default, chosen there from the
# bytes-against-unpack balance of 128 and 64 (ops/packing.py:106-113)
GATE_BLOCK = 128


def pack12_host(hu: np.ndarray) -> np.ndarray:
    """(B, ...) int16 HU -> (B, 3, N/2) uint8 planes; N (voxels per sample)
    must be even."""
    squeeze = hu.ndim == 1
    flat = hu.reshape(1, -1) if squeeze else hu.reshape(hu.shape[0], -1)
    n = flat.shape[-1]
    assert n % 2 == 0, "voxel count must be even for 12-bit packing"
    # 16-bit throughout: clip-then-offset equals offset-then-clip for int16
    v = (np.clip(flat, -OFFSET, 4095 - OFFSET) + OFFSET).astype(np.uint16)
    v0 = v[:, :n // 2]
    v1 = v[:, n // 2:]
    out = np.empty((flat.shape[0], 3, n // 2), np.uint8)
    out[:, 0] = v0 & 0xFF
    out[:, 1] = ((v0 >> 8) | ((v1 & 0xF) << 4)).astype(np.uint8)
    out[:, 2] = (v1 >> 4).astype(np.uint8)
    return out[0] if squeeze else out


def pack10_host(hu: np.ndarray) -> np.ndarray:
    """(B, ...) int16 HU -> (B, N + N/4) uint8 window-domain 10-bit pack:
    values clamped to ``WINDOW_LO..WINDOW_HI`` and shifted to 0..850; the
    first N bytes are the low 8 bits, the last N/4 hold the 2 high bits of
    the four N/4-sized quarters.  N must be divisible by 4."""
    squeeze = hu.ndim == 1
    flat = hu.reshape(1, -1) if squeeze else hu.reshape(hu.shape[0], -1)
    n = flat.shape[-1]
    assert n % 4 == 0, "voxel count must be divisible by 4 for 10-bit pack"
    q = n // 4
    v = (np.clip(flat, WINDOW_LO, WINDOW_HI)
         - np.int16(WINDOW_LO)).astype(np.uint16)
    out = np.empty((flat.shape[0], n + q), np.uint8)
    out[:, :n] = v & 0xFF
    hi = (v >> 8).astype(np.uint8)      # values 0..3
    acc = hi[:, :q]
    for k in range(1, 4):
        acc = acc | (hi[:, k * q:(k + 1) * q] << (2 * k))
    out[:, n:] = acc
    return out[0] if squeeze else out


def pick_gate_block(n_vox: int, candidates=(128, 64)) -> int:
    """The first candidate block whose block count is a whole number of
    gate bytes (``n_vox % (block * 8) == 0``), or 0 when none is: the
    caller must then not take the gated transport."""
    for b in candidates:
        if n_vox % (b * 8) == 0:
            return b
    return 0


def gate_blocks_np(gate: np.ndarray, block: int = GATE_BLOCK) -> np.ndarray:
    """Per-voxel gate (B, ...) bool -> per-block any (B, nblk)."""
    g = gate.reshape(gate.shape[0], -1)
    assert g.shape[1] % block == 0, (g.shape, block)
    return g.reshape(g.shape[0], -1, block).any(-1)


def gated_budget(block_counts, block: int = GATE_BLOCK,
                 multiple: int = 8) -> int:
    """Stream capacity in voxels for :func:`pack10_gated_host`: the largest
    live-block count, rounded up to ``multiple`` blocks, times ``block``."""
    m = int(np.max(block_counts)) if len(np.atleast_1d(block_counts)) else 1
    nb = max(((m + multiple - 1) // multiple) * multiple, multiple)
    return nb * block


def pack10_gated_host(hu: np.ndarray, gate_blk: np.ndarray, budget: int,
                      block: int = GATE_BLOCK):
    """Block-gated window-domain transport (exact).

    ``hu``: (B, ...) int16; ``gate_blk``: (B, nblk) bool from
    :func:`gate_blocks_np` over a gate containing ``{hu > WINDOW_LO}``;
    ``budget``: voxel capacity (:func:`gated_budget`), divisible by
    ``block`` and by 4.  Returns ``(packed,
    blk_bits)``: the (B, budget * 5 / 4) uint8 10-bit stream (live blocks
    in flat order, ``WINDOW_LO`` after them) and the little-endian
    packbits of the block gate (B, nblk / 8).  Raises ``ValueError`` when
    a sample's live blocks exceed the budget."""
    assert budget % block == 0 and budget % 4 == 0, (budget, block)
    flat = hu.reshape(hu.shape[0], -1)
    n = flat.shape[1]
    assert n % block == 0, (n, block)
    nblk = n // block
    gb = np.asarray(gate_blk, bool).reshape(hu.shape[0], nblk)
    assert nblk % 8 == 0, "block count must be %8 for packbits"
    vals = np.full((flat.shape[0], budget), WINDOW_LO, np.int16)
    for b in range(flat.shape[0]):
        sel = flat[b].reshape(nblk, block)[gb[b]]
        if sel.size > budget:
            raise ValueError(
                f"gated voxel count {sel.size} exceeds budget {budget}")
        vals[b, :sel.size] = sel.ravel()
    blk_bits = np.packbits(gb, axis=-1, bitorder="little")
    return pack10_host(vals), blk_bits


def _unpack10_int(packed: torch.Tensor, n: int) -> torch.Tensor:
    """(B, n + n/4) uint8 window-domain pack -> (B, n) int32 clamped HU."""
    lo = packed[:, :n].to(torch.int32)
    hi = packed[:, n:].to(torch.int32)
    hi_parts = torch.cat([(hi >> (2 * k)) & 3 for k in range(4)], dim=-1)
    return lo + (hi_parts << 8) + WINDOW_LO


def _unpack10_flat(packed: torch.Tensor, n: int) -> torch.Tensor:
    """(B, n + n/4) uint8 window-domain pack -> (B, n) float32 clamped
    HU."""
    return _unpack10_int(packed, n).to(torch.float32)


def unpack10_device(packed: torch.Tensor, out_shape) -> torch.Tensor:
    """(B, N + N/4) uint8 window-domain pack -> (B, *out_shape) float32
    clamped HU (the inverse of :func:`pack10_host`)."""
    squeeze = packed.ndim == 1
    if squeeze:
        packed = packed[None]
    n = int(np.prod(out_shape))
    out = _unpack10_flat(packed, n).reshape(packed.shape[0], *out_shape)
    return out[0] if squeeze else out


def unpack10_gated_device(packed: torch.Tensor, blk_bits: torch.Tensor,
                          out_shape, block: int = GATE_BLOCK
                          ) -> torch.Tensor:
    """Inverse of :func:`pack10_gated_host`: (B, budget * 5 / 4) uint8
    stream + (B, nblk / 8) gate bytes -> (B, *out_shape) float32 clamped
    HU, ``WINDOW_LO`` in the dropped blocks.  A live block's stream slot is
    the exclusive prefix sum of the gate bits before it; the gather moves
    whole ``block``-voxel slices."""
    squeeze = packed.ndim == 1
    if squeeze:
        packed, blk_bits = packed[None], blk_bits[None]
    b = packed.shape[0]
    n = int(np.prod(out_shape))
    assert n % block == 0, (out_shape, block)
    nblk = n // block
    budget = packed.shape[-1] * 4 // 5
    nb_budget = budget // block
    stream = _unpack10_int(packed, budget).reshape(b, nb_budget, block)
    shifts = torch.arange(8, dtype=torch.int32, device=packed.device)
    bits = ((blk_bits.to(torch.int32)[..., None] >> shifts) & 1
            ).reshape(b, nblk)
    idx = torch.cumsum(bits, dim=-1) - bits            # exclusive prefix
    idx = idx.clamp(0, nb_budget - 1)[..., None].expand(b, nblk, block)
    flat = torch.gather(stream, 1, idx).masked_fill(bits[..., None] == 0,
                                                    WINDOW_LO)
    out = flat.to(torch.float32).reshape(b, *out_shape)
    return out[0] if squeeze else out


def unpack12_device(packed: torch.Tensor, out_shape) -> torch.Tensor:
    """(B, 3, N/2) uint8 planes -> (B, *out_shape) float32 HU."""
    squeeze = packed.ndim == 2
    if squeeze:
        packed = packed[None]
    p = packed.to(torch.int32)
    b0, b1, b2 = p[:, 0], p[:, 1], p[:, 2]
    v0 = b0 | ((b1 & 0xF) << 8)
    v1 = (b1 >> 4) | (b2 << 4)
    flat = torch.cat([v0, v1], dim=-1) - OFFSET
    out = flat.to(torch.float32).reshape(packed.shape[0], *out_shape)
    return out[0] if squeeze else out
