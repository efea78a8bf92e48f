"""The port's CT packing (``ops/packing.py``) against the JAX package's.

The host packers (numpy) must give the same bytes as JAX's on the same
seeded int16 volumes, values outside -2048..2047 and outside the HU window
included; the torch unpackers must give JAX's device unpack bit for bit
(float32 of integer HU, compared with ``assert_array_equal``); the gated
round trip equals the ungated window clamp exactly.  No tolerance is
involved anywhere: every comparison is exact.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bodyct_dram_emph_subtype_tpu.ops import packing as jpk
from bodyct_dram_emph_subtype_tpu_torch.ops import packing as tpk
from bodyct_dram_emph_subtype_tpu_torch.ops.preprocess import WINDOW

SHAPE = (4, 16, 32)          # 2048 voxels: 16 gate blocks of 128


def _volumes(seed, b=2, shape=SHAPE):
    """int16 HU across the full int16 range, the window edges and a
    background of -2048 in some blocks (so the gate drops them)."""
    rng = np.random.RandomState(seed)
    hu = rng.randint(-32768, 32767, (b, *shape)).astype(np.int16)
    window = rng.randint(-1300, -200, (b, *shape)).astype(np.int16)
    pick = rng.rand(b, *shape) < 0.6
    hu[pick] = window[pick]
    flat = hu.reshape(b, -1)
    flat[0, :256] = -2048                 # two dead blocks in sample 0
    flat[1, 512:640] = -1150              # a block at the window floor
    flat[1, 1024:1152] = -1151
    flat[0, 700] = -1150
    flat[0, 701] = -300
    flat[1, 5] = 2047
    flat[1, 6] = -2049
    return hu


def test_constants_equal_jax():
    assert (tpk.OFFSET, tpk.WINDOW_LO, tpk.WINDOW_HI, tpk.GATE_BLOCK) == \
        (jpk.OFFSET, jpk.WINDOW_LO, jpk.WINDOW_HI, jpk.GATE_BLOCK)
    assert (tpk.WINDOW_LO, tpk.WINDOW_HI) == tuple(int(v) for v in WINDOW)


@pytest.mark.parametrize("squeeze", [False, True])
def test_pack12_and_pack10_bytes_equal_jax(squeeze):
    hu = _volumes(0)
    if squeeze:
        hu = hu[0].reshape(-1)
    for name in ("pack12_host", "pack10_host"):
        got, want = getattr(tpk, name)(hu), getattr(jpk, name)(hu)
        assert got.dtype == want.dtype == np.uint8
        np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("n_vox", [1536, 4096, 640 * 8, 64 * 8 * 3, 1000,
                                   12, 0])
def test_pick_gate_block_equals_jax(n_vox):
    assert tpk.pick_gate_block(n_vox) == jpk.pick_gate_block(n_vox)


@pytest.mark.parametrize("block", [128, 64])
def test_gate_blocks_and_budget_equal_jax(block):
    hu = _volumes(1)
    gate = hu > tpk.WINDOW_LO
    got, want = tpk.gate_blocks_np(gate, block), jpk.gate_blocks_np(gate,
                                                                     block)
    np.testing.assert_array_equal(got, want)
    counts = got.sum(-1)
    for c in ([], counts, [0], [int(counts.max()) + 9]):
        assert tpk.gated_budget(c, block) == jpk.gated_budget(c, block)


@pytest.mark.parametrize("block", [128, 64])
def test_pack10_gated_bytes_equal_jax_and_raise_over_budget(block):
    hu = _volumes(2)
    gate = tpk.gate_blocks_np(hu > tpk.WINDOW_LO, block)
    budget = tpk.gated_budget(gate.sum(-1), block)
    got = tpk.pack10_gated_host(hu, gate, budget, block)
    want = jpk.pack10_gated_host(hu, gate, budget, block)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert got[0].shape == (2, budget * 5 // 4)
    assert got[1].shape == (2, gate.shape[1] // 8)
    small = tpk.gated_budget([int(gate.sum(-1).max()) - 8 - 1], block)
    assert small < int(gate.sum(-1).max()) * block
    for pk in (tpk, jpk):
        with pytest.raises(ValueError, match="exceeds budget"):
            pk.pack10_gated_host(hu, gate, small, block)


def test_unpackers_equal_jax_bit_for_bit():
    hu = _volumes(3)
    p12, p10 = tpk.pack12_host(hu), tpk.pack10_host(hu)
    got = tpk.unpack12_device(torch.from_numpy(p12), SHAPE)
    want = np.asarray(jpk.unpack12_device(jnp.asarray(p12), SHAPE))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        got.numpy(), np.clip(hu, -2048, 2047).astype(np.float32))
    got = tpk.unpack10_device(torch.from_numpy(p10), SHAPE)
    want = np.asarray(jpk.unpack10_device(jnp.asarray(p10), SHAPE))
    np.testing.assert_array_equal(got.numpy(), want)
    # the squeezed (one sample) forms
    np.testing.assert_array_equal(
        tpk.unpack10_device(torch.from_numpy(p10[1]), SHAPE).numpy(),
        want[1])
    np.testing.assert_array_equal(
        tpk.unpack12_device(torch.from_numpy(p12[0]), SHAPE).numpy(),
        np.asarray(jpk.unpack12_device(jnp.asarray(p12[0]), SHAPE)))


@pytest.mark.parametrize("block", [128, 64])
@pytest.mark.parametrize("spare_blocks", [0, 16])
def test_gated_round_trip_equals_ungated_clamp(block, spare_blocks):
    """The gated unpack equals JAX's and the window clamp of the raw
    volume, bit for bit, with the stream exactly full or with room."""
    hu = _volumes(4)
    gate = tpk.gate_blocks_np(hu > tpk.WINDOW_LO, block)
    budget = tpk.gated_budget(gate.sum(-1), block) + spare_blocks * block
    packed, bits = tpk.pack10_gated_host(hu, gate, budget, block)
    got = tpk.unpack10_gated_device(torch.from_numpy(packed),
                                    torch.from_numpy(bits), SHAPE, block)
    want = np.asarray(jpk.unpack10_gated_device(
        jnp.asarray(packed), jnp.asarray(bits), SHAPE, block))
    assert got.dtype == torch.float32 and got.shape == (2, *SHAPE)
    np.testing.assert_array_equal(got.numpy(), want)
    clamp = np.clip(hu, tpk.WINDOW_LO, tpk.WINDOW_HI).astype(np.float32)
    np.testing.assert_array_equal(got.numpy(), clamp)
    ungated = tpk.unpack10_device(torch.from_numpy(tpk.pack10_host(hu)),
                                  SHAPE)
    np.testing.assert_array_equal(got.numpy(), ungated.numpy())
    one = tpk.unpack10_gated_device(torch.from_numpy(packed[1]),
                                    torch.from_numpy(bits[1]), SHAPE, block)
    np.testing.assert_array_equal(one.numpy(), clamp[1])
