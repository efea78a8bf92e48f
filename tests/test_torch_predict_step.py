"""The port's ``make_predict_step`` against the JAX package's, in both
normalisations: ``med3ddramtiny`` on the same weights (JAX init ->
``state_dict_from_jax``) and the same numpy inputs, JAX under
``jax.default_matmul_precision("highest")``.  Full-resolution masked maps
within rtol 1e-5 / atol 1e-6 (zeros outside ess on both sides), lesion
percentages within rtol 1e-5 (float32 sums in another order).  Then the
port's own form of ``tests/test_models.py``'s volume-ratio test."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bodyct_dram_emph_subtype_tpu.models import get_model_by_name as jax_model
from bodyct_dram_emph_subtype_tpu.train.state import TrainState, make_optimizer
from bodyct_dram_emph_subtype_tpu.train.steps import \
    make_predict_step as jax_make_predict_step
from bodyct_dram_emph_subtype_tpu_torch.models.registry import \
    get_model_by_name
from bodyct_dram_emph_subtype_tpu_torch.models.torch_import import \
    state_dict_from_jax
from bodyct_dram_emph_subtype_tpu_torch.train import make_predict_step

SHAPE = (2, 16, 24, 32)
KEYS = ("cle_dense_outs", "pse_dense_outs", "cle_precentages",
        "pse_precentages")


def _batch(seed=0):
    """Standardized-like images, two lungs of different volumes, ess a
    random half of each lung."""
    rng = np.random.RandomState(seed)
    x = rng.randn(*SHAPE).astype(np.float32)
    lungs = np.zeros(SHAPE, np.float32)
    lungs[0, 2:14, 4:20, 4:28] = 1.0
    lungs[1, 4:10, 6:16, 8:20] = 1.0
    ess = (rng.rand(*SHAPE) > 0.5).astype(np.float32) * lungs
    return x, lungs, ess


@pytest.mark.parametrize("batch_lung_norm", [False, True])
def test_predict_step_matches_jax(batch_lung_norm):
    x, lungs, ess = _batch()
    model = jax_model("med3ddramtiny")
    init = jax.jit(functools.partial(model.init, train=False))
    variables = jax.tree.map(np.asarray, dict(init(
        jax.random.PRNGKey(0), jnp.asarray(x)[..., None],
        jnp.asarray(lungs)[..., None])))
    state = TrainState.create(variables, make_optimizer())
    with jax.default_matmul_precision("highest"):
        want = jax_make_predict_step(model, batch_lung_norm)(
            state, x, lungs, ess)
    port = get_model_by_name("med3ddramtiny")
    port.load_state_dict(state_dict_from_jax(variables), strict=True)
    marks = []
    got = make_predict_step(port, batch_lung_norm, device="cpu")(
        x, lungs, ess, mark=marks.append)
    assert marks == ["forward", "reduction", "done"]
    assert set(got) == set(KEYS)
    for key in KEYS[:2]:
        assert got[key].shape == SHAPE
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=1e-5, atol=1e-6)
        assert np.all(got[key].numpy()[ess == 0] == 0)
    for key in KEYS[2:]:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=1e-5)


def test_predict_step_batch_lung_norm_modes():
    """``batch_lung_norm=True`` divides by the whole batch's lung volume,
    so it relates to the per-sample mode by the volume ratio; at batch 1
    the two modes give the same percentages."""
    x, lungs, ess = _batch(seed=1)
    model = get_model_by_name("med3ddramtiny")
    per_sample = make_predict_step(model, device="cpu")(x, lungs, ess)
    whole = make_predict_step(model, batch_lung_norm=True, device="cpu")(
        x, lungs, ess)
    vol = lungs.reshape(2, -1).sum(1)
    for key in ("cle_precentages", "pse_precentages"):
        got = whole[key].numpy()
        want = per_sample[key].numpy() * vol / vol.sum()
        np.testing.assert_allclose(got, want, rtol=1e-5)
        assert not np.allclose(got, per_sample[key].numpy())
    one = make_predict_step(model, device="cpu")(x[:1], lungs[:1], ess[:1])
    one_b = make_predict_step(model, batch_lung_norm=True, device="cpu")(
        x[:1], lungs[:1], ess[:1])
    for key in ("cle_precentages", "pse_precentages"):
        np.testing.assert_allclose(one[key].numpy(), one_b[key].numpy(),
                                   rtol=1e-6)
