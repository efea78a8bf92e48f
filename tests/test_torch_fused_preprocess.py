"""The port's full-volume fused preprocess (``ops/preprocess.py::
fused_preprocess``, the training device input pipeline's) against the JAX
package's, on the CPU.

Three ragged int16 volumes in one padded buffer (seeded numpy), at the
training (-950) and inference (-910) thresholds:

- against JAX ``fused_preprocess``: image max|d| <= 1e-5 (the float32
  standardize sums run in another order), lung and emphysema masks
  bit-equal;
- against the host chain ``preprocess_sample`` (the JAX package's own
  bound, ``tests/test_fused_preprocess.py``): image within 1e-4, masks
  bit-equal;
- the preselected path (host depth selection, exact-integer moments,
  nearest-preselected lung) against the full-volume path, as JAX's
  ``test_preselected_matches_fused``: masks bit-equal, image within 2e-5;
- ``in_sizes`` given as host ints or as a tensor, and ``preprocess_one``
  on one volume: the same output bit for bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bodyct_dram_emph_subtype_tpu.data.host_preprocess import \
    preprocess_sample
from bodyct_dram_emph_subtype_tpu.ops import preprocess as jpre
from bodyct_dram_emph_subtype_tpu_torch.data.host_preprocess import (
    depth_indices_np, resize_nearest_np, window_moments_np)
from bodyct_dram_emph_subtype_tpu_torch.ops import preprocess as tpre

TARGET = (16, 24, 32)
PAD = (40, 48, 56)


def _ragged(seed, lung_dtype=np.uint8):
    rng = np.random.RandomState(seed)
    imgs = np.full((3, *PAD), -2048, np.int16)
    lungs = np.zeros((3, *PAD), lung_dtype)
    sizes = np.zeros((3, 3), np.int32)
    raw = []
    for b in range(3):
        shape = (40 - 4 * b, 48 - 6 * b, 56 - 8 * b)
        img = rng.randint(-1250, -350, shape).astype(np.int16)
        lung = (rng.rand(*shape) > 0.4).astype(lung_dtype)
        imgs[b, :shape[0], :shape[1], :shape[2]] = img
        lungs[b, :shape[0], :shape[1], :shape[2]] = lung
        sizes[b] = shape
        raw.append((img, lung))
    return imgs, lungs, sizes, raw


@pytest.mark.parametrize("threshold", [-950.0, -910.0])
@pytest.mark.parametrize("lung_dtype", [np.uint8, np.int8])
def test_fused_preprocess_matches_jax(threshold, lung_dtype):
    imgs, lungs, sizes, _ = _ragged(0, lung_dtype)
    want = jpre.fused_preprocess(jnp.asarray(imgs), jnp.asarray(lungs),
                                 jnp.asarray(sizes), target_size=TARGET,
                                 em_threshold=threshold)
    got = tpre.fused_preprocess(torch.from_numpy(imgs),
                                torch.from_numpy(lungs),
                                torch.from_numpy(sizes), target_size=TARGET,
                                em_threshold=threshold)
    assert got["image"].shape == (3, *TARGET)
    assert all(v.dtype == torch.float32 for v in got.values())
    err = np.abs(got["image"].numpy() - np.asarray(want["image"])).max()
    assert err <= 1e-5, err
    for key in ("lung_mask", "em_mask"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]),
                                      err_msg=key)
    assert 0 < got["em_mask"].sum() < got["lung_mask"].sum()


def test_fused_preprocess_matches_host_chain():
    imgs, lungs, sizes, raw = _ragged(1)
    got = tpre.fused_preprocess(torch.from_numpy(imgs),
                                torch.from_numpy(lungs), sizes.tolist(),
                                target_size=TARGET, em_threshold=-950.0)
    for b, (img, lung) in enumerate(raw):
        want = preprocess_sample({"image": img, "lung_mask": lung,
                                  "em_mask": (img < -950) & (lung > 0)},
                                 TARGET)
        np.testing.assert_allclose(got["image"][b].numpy(), want["image"],
                                   rtol=1e-4, atol=1e-4)
        for key in ("lung_mask", "em_mask"):
            np.testing.assert_array_equal(got[key][b].numpy(), want[key],
                                          err_msg=key)


def test_preselected_matches_fused():
    imgs, lungs, sizes, raw = _ragged(2)
    sel_imgs = np.zeros((3, TARGET[0], *PAD[1:]), np.int16)
    sel_lungs = np.zeros((3, *TARGET), np.uint8)
    moments = np.zeros((3, 2), np.float32)
    for b, (img, lung) in enumerate(raw):
        idx = depth_indices_np(img.shape[0], TARGET[0])
        sel_imgs[b] = imgs[b, idx]
        sel_lungs[b] = resize_nearest_np(lung[idx], TARGET[1:], (1, 2))
        moments[b] = window_moments_np(img)
    ref = tpre.fused_preprocess(torch.from_numpy(imgs),
                                torch.from_numpy(lungs),
                                torch.from_numpy(sizes), target_size=TARGET,
                                em_threshold=-910.0)
    got = tpre.fused_preprocess_preselected(
        torch.from_numpy(sel_imgs), torch.from_numpy(sel_lungs),
        torch.from_numpy(sizes), torch.from_numpy(moments),
        target_size=TARGET, em_threshold=-910.0)
    for key in ("lung_mask", "em_mask"):
        np.testing.assert_array_equal(got[key].numpy(), ref[key].numpy(),
                                      err_msg=key)
    np.testing.assert_allclose(got["image"].numpy(), ref["image"].numpy(),
                               rtol=2e-5, atol=2e-5)


def test_in_sizes_forms_and_preprocess_one_agree():
    imgs, lungs, sizes, _ = _ragged(3)
    args = (torch.from_numpy(imgs), torch.from_numpy(lungs))
    a = tpre.fused_preprocess(*args, torch.from_numpy(sizes), TARGET, -950.0)
    b = tpre.fused_preprocess(*args, sizes.tolist(), TARGET, -950.0)
    one = tpre.preprocess_one(args[0][1], args[1][1], sizes[1].tolist(),
                              TARGET, -950.0)
    for key in a:
        assert torch.equal(a[key], b[key]), key
        np.testing.assert_allclose(one[key].numpy(), a[key][1].numpy(),
                                   rtol=0, atol=1e-6, err_msg=key)
