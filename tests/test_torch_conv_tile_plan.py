"""The Python mirror of the CUDA kernels' tile plan, held against the
sources.

``ops/roll_conv.py`` repeats the block tiles of kernels A, B and D and the
rules built on them (``conv_tile_n``, ``wgrad_splits``, ``wgrad_chunk``);
the kernels themselves run only on a card.  These tests read the
``constexpr int`` values out of ``csrc/`` and check that the mirror agrees,
and that the rules give what the kernels rely on: a split's voxel range is
a multiple of the K step, and kernel D's grid fills one wave of the card
at every training site.
"""
import re
from pathlib import Path

import pytest

from bodyct_dram_emph_subtype_tpu_torch.models.blocks import Bottleneck
from bodyct_dram_emph_subtype_tpu_torch.models.resnet3d import (
    train_roll_site_shapes, train_roll_sites)
from bodyct_dram_emph_subtype_tpu_torch.ops import roll_conv as rc
from bodyct_dram_emph_subtype_tpu_torch.ops import stem_kernel as sk

CSRC = Path(rc.__file__).resolve().parents[1] / "csrc"
H100_SMS = 132
SMEM_PER_SM = 228 * 1024          # H100: 228 KB of shared memory per SM
SMEM_PER_BLOCK = 227 * 1024


def constants(name: str) -> dict:
    text = (CSRC / name).read_text()
    return {k: int(v) for k, v in
            re.findall(r"constexpr int (\w+) = (\d+);", text)}


MMA = constants("mma_bf16.cuh")
CONV = constants("conv3x3x3.cu")
WGRAD = constants("conv3x3x3_wgrad.cu")
STEM = constants("stem_pool.cu")


@pytest.mark.parametrize("mirror,source", [
    (rc.MMA_BK, MMA["BK"]), (rc.MMA_STAGES, MMA["STAGES"]),
    (rc.CONV_TILE_M, CONV["kTileM"]),
    (rc.CONV_TILE_N_SMALL, CONV["kTileNSmall"]),
    (rc.CONV_TILE_N_LARGE, CONV["kTileNLarge"]),
    (rc.HEADS_MAX_OUT, CONV["kTileNSmall"]),
    (rc.HEADS_MAX_OUT, CONV["FBN"]),
    (rc.HEADS_MAX, CONV["kMaxHeads"]),
    (rc.WGRAD_ROWS, WGRAD["WM"]), (rc.WGRAD_COLS, WGRAD["WN"]),
    (rc.WGRAD_K, WGRAD["WK"]), (rc.WGRAD_K, MMA["BK"]),
    (sk.STEM_POOL_TILE, STEM["kPoolTile"]), (sk.STEM_RING, STEM["kRing"]),
    (sk.STEM_K, 8 * STEM["kTaps"]), (sk.FEATURES, STEM["F"]),
])
def test_mirror_equals_cuda_constexpr(mirror, source):
    assert mirror == source


def test_stem_tile_plan():
    """Kernel E's bf16 plan: its shared memory leaves room for the block
    on an SM, the 19 m16 fragments of the 17 x 17 stem tile are covered by
    the warps, and the recomputed (H, W) halo stays under 15% of the stem
    voxels the block owns."""
    assert sk.stem_smem_bytes() <= SMEM_PER_BLOCK
    assert STEM["kWarpsM"] * STEM["kWarpFrags"] * 16 \
        >= (2 * sk.STEM_POOL_TILE + 1) ** 2
    halo = (2 * sk.STEM_POOL_TILE + 1) ** 2 / (2 * sk.STEM_POOL_TILE) ** 2
    assert halo - 1 <= 0.15
    # 32 k16 steps per output: no promotion of the sums needed
    assert sk.STEM_K // 16 <= MMA["PROMOTE_STEPS"]


@pytest.mark.parametrize("o,cols", [
    (13, 64), (32, 64), (64, 64),         # one small tile
    (70, 128), (128, 128), (256, 128), (512, 128),
    (136, 64),                            # 3 small tiles pad less than 2
    (576, 64),                            # us1.conv0's dgrad: 9 x 64
])
def test_conv_tile_n(o, cols):
    assert rc.conv_tile_n(o) == cols


def test_conv_tile_n_never_pads_more_than_the_small_tile():
    for o in range(1, 1025):
        n = rc.conv_tile_n(o)
        assert n in (rc.CONV_TILE_N_SMALL, rc.CONV_TILE_N_LARGE)
        padded = -(-o // n) * n
        assert padded == -(-o // rc.CONV_TILE_N_SMALL) * rc.CONV_TILE_N_SMALL


@pytest.mark.parametrize("rows,cols,promotes", [
    (rc.CONV_TILE_M, rc.CONV_TILE_N_SMALL, True),
    (rc.CONV_TILE_M, rc.CONV_TILE_N_LARGE, False),
    (rc.WGRAD_ROWS, rc.WGRAD_COLS, True)])
def test_shared_memory_fits_two_blocks_per_sm(rows, cols, promotes):
    """Each tensor-core instantiation's shared memory: the cp.async ring,
    and where it promotes its sums, one float32 per accumulator of its 256
    threads (the 8 warps' tiles cover the block tile once); two blocks
    share an SM, as ``__launch_bounds__`` asks.  Kernel B's activation
    tile reuses the 64-column ring."""
    assert MMA["NT"] == 256
    ring = rc.MMA_STAGES * (rows + cols) * rc.MMA_BK * 2
    smem = ring + (rows * cols * 4 if promotes else 0)
    assert 2 * smem <= SMEM_PER_SM and smem <= SMEM_PER_BLOCK
    heads = rc.CONV_TILE_M * (rc.HEADS_MAX_OUT + 1) * 4
    assert cols != rc.HEADS_MAX_OUT or heads <= ring


SITES = train_roll_site_shapes(2, (128, 224, 288))
# med3ddram50 with the packed decoder: its us1.conv0 takes C = 2304
SITES50 = train_roll_site_shapes(2, (128, 224, 288),
                                 train_roll_sites(block=Bottleneck))


@pytest.mark.parametrize("m,c,o", [
    (2 * 5 * 7 * 9, 20, 13), (1 * 4 * 6 * 10, 64, 32), (1 * 6 * 8 * 12, 72, 70),
    (1, 8, 8), (31, 64, 64), (33, 64, 64), (10 ** 6 + 7, 16, 8),
] + [(s[0] * s[1] * s[2] * s[3], s[4], o) for _, s, o in SITES + SITES50])
def test_wgrad_splits_give_whole_k_steps(m, c, o):
    s = rc.wgrad_splits(m, c, o)
    chunk = rc.wgrad_chunk(m, s)
    assert 1 <= s <= 65535
    assert chunk % rc.WGRAD_K == 0 and chunk > 0
    assert chunk * s >= m            # the ranges cover every voxel
    assert chunk * (s - 1) < m or s == 1


@pytest.mark.parametrize("name,shape,o", SITES, ids=[s[0] for s in SITES])
def test_wgrad_splits_fill_one_wave_at_train_sites(name, shape, o):
    m = shape[0] * shape[1] * shape[2] * shape[3]
    c = shape[4]
    tiles = -(-27 * c // rc.WGRAD_ROWS) * -(-o // rc.WGRAD_COLS)
    blocks = tiles * rc.wgrad_splits(m, c, o)
    assert H100_SMS <= blocks <= rc.WGRAD_TARGET_BLOCKS


def test_wgrad_c2304_is_one_split():
    """med3ddram50's us1.conv0 (C = 2304): 486 row tiles already exceed
    the one-wave target, so kernel D runs one split: each block sums all
    258048 voxels, 8064 K steps."""
    name, shape, o = SITES50[0]
    assert name == "us1.conv_blocks.0.0" and shape[-1] == 2304
    m = shape[0] * shape[1] * shape[2] * shape[3]
    tiles = -(-27 * shape[-1] // rc.WGRAD_ROWS) * -(-o // rc.WGRAD_COLS)
    assert tiles == 486 > rc.WGRAD_TARGET_BLOCKS
    assert rc.wgrad_splits(m, shape[-1], o) == 1
    assert rc.wgrad_chunk(m, 1) // rc.WGRAD_K == 8064
