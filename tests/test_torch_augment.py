"""The port's training augmentation against the JAX primitives.

``jax.random`` and torch draw different numbers, so the chain is held in
two parts: the drawn parameters fall in the distributions' ranges of the
JAX ``_augment_one``, and the deterministic apply step on explicit draws
equals the JAX primitives composed in the same order
(``gaussian_additive_noise(eps=)``, ``box_cutout``, ``flip_crop_resize``
with ``out_sizes`` for the masks).  Masks are compared bit for bit (they
are nearest taps of 0/1 volumes, and the tap coordinates follow the JAX
float32 arithmetic operation by operation, ties included); the image
holds rtol 1e-6 / atol 1e-6 (two linear taps summed in float32, with or
without a fused multiply-add).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bodyct_dram_emph_subtype_tpu.ops import grid_sample as jgs
from bodyct_dram_emph_subtype_tpu.ops import intensity as jint
from bodyct_dram_emph_subtype_tpu_torch.ops.grid_sample import _base_grid_1d
from bodyct_dram_emph_subtype_tpu_torch.transforms.batch_augment import (
    MAX_CUTOUT_BOXES, augment_batch, draw_augment_params)

SHAPE = (16, 20, 24)


def _jax_chain(img, lung, em, d, i, mask_out):
    g = d["gates"][i]
    noisy = jint.gaussian_additive_noise(
        jnp.asarray(img), None, jnp.float32(d["sigma"][i]),
        eps=jnp.asarray(d["eps"][i]))
    img = jnp.where(g[0], noisy, jnp.asarray(img))
    img = jint.box_cutout(img, jnp.asarray(d["centers"][i]),
                          jnp.asarray(d["sizes"][i]),
                          jnp.asarray(d["valid"][i]))
    args = (jnp.asarray(d["crop_center"][i]), jnp.asarray(d["crop_size"][i]),
            jnp.asarray(d["flip_axis"][i]), jnp.asarray(g[3]))
    img = jgs.flip_crop_resize(img, *args, is_mask=False, align_corners=True)
    masks = [jgs.flip_crop_resize(jnp.asarray(m, jnp.float32), *args,
                                  is_mask=True, out_sizes=mask_out)
             for m in (lung, em)]
    return [np.asarray(a) for a in (img, *masks)]


@pytest.mark.parametrize("seed,all_on,mask_out", [
    (0, False, (8, 10, 12)), (1, True, (8, 10, 12)), (2, True, None)])
def test_augment_batch_matches_jax_primitives(seed, all_on, mask_out):
    rng = np.random.RandomState(seed)
    b = 3
    images = rng.randn(b, *SHAPE).astype(np.float32)
    lungs = (rng.rand(b, *SHAPE) > 0.4).astype(np.float32)
    ems = (rng.rand(b, *SHAPE) > 0.8).astype(np.float32)
    draws = draw_augment_params(torch.Generator().manual_seed(seed), b,
                                SHAPE)
    if all_on:      # every stage and the flips, so the crop taps run
        draws["gates"][:] = True
        draws["valid"][:, :3] = True
        draws["flip_axis"][:, :2] = True
    got = augment_batch(torch.from_numpy(images), torch.from_numpy(lungs),
                        torch.from_numpy(ems), draws, mask_out)
    d = {k: v.numpy() for k, v in draws.items()}
    for i in range(b):
        want = _jax_chain(images[i], lungs[i], ems[i], d, i, mask_out)
        np.testing.assert_allclose(got[0][i].numpy(), want[0], rtol=1e-6,
                                   atol=1e-6)
        for k in (1, 2):
            assert got[k][i].dtype == torch.float32
            np.testing.assert_array_equal(got[k][i].numpy(), want[k])


def test_base_grid_is_bitwise_the_jax_one():
    for n in list(range(1, 40)) + [56, 64, 72, 112, 128, 144, 224, 288]:
        np.testing.assert_array_equal(_base_grid_1d(n),
                                      np.asarray(jgs._base_grid_1d(n)),
                                      err_msg=str(n))


def test_drawn_parameters_fall_in_the_jax_ranges():
    b = 400
    d = draw_augment_params(torch.Generator().manual_seed(3), b, (4, 5, 6))
    assert d["gates"].dtype == torch.bool and d["gates"].shape == (b, 4)
    frac = d["gates"].float().mean(0)
    assert torch.all((frac > 0.4) & (frac < 0.6))
    for key, lo, hi in (("sigma", 0.03, 0.06), ("centers", 0.2, 0.8),
                        ("sizes", 0.01, 0.06), ("crop_center", 0.45, 0.55),
                        ("crop_size", 0.95, 1.0)):
        v = d[key]
        assert v.min() >= lo and v.max() < hi, key
        assert v.max() - v.min() > 0.8 * (hi - lo), key
    n_valid = d["valid"].sum(1)
    on = d["gates"][:, 1]
    assert torch.all(n_valid[~on] == 0)
    assert n_valid[on].min() >= 1 and n_valid[on].max() <= MAX_CUTOUT_BOXES
    assert set(n_valid[on].tolist()) == set(range(1, MAX_CUTOUT_BOXES + 1))
    # valid boxes are a prefix of the 10 (arange(10) < n_boxes)
    assert torch.all(d["valid"][:, 1:] <= d["valid"][:, :-1])
    n_flip = d["flip_axis"].sum(1)
    assert torch.all(n_flip[~d["gates"][:, 2]] == 0)
    assert set(n_flip[d["gates"][:, 2]].tolist()) == {1, 2}
    assert d["flip_axis"].float().mean(0).min() > 0.1   # every axis flips
    eps = d["eps"]
    assert eps.shape == (b, 4, 5, 6)
    assert abs(eps.mean().item()) < 0.02 and abs(eps.std().item() - 1) < 0.02


def test_rows_draw_the_same_numbers_at_any_offset():
    """Row i's draws depend on the seed and its global row index only: rows
    [1, 3) drawn alone equal rows 1-2 of the batch of 4 (a rank's rows of a
    global batch)."""
    full = draw_augment_params(torch.Generator().manual_seed(7), 4, SHAPE)
    part = draw_augment_params(torch.Generator().manual_seed(7), 2, SHAPE,
                               first_row=1)
    assert set(part) == set(full)
    for k, v in part.items():
        assert torch.equal(v, full[k][1:3]), k
