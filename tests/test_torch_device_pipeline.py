"""The training device input pipeline of the port against the JAX
package's, on the CPU.

- ``RawPaddedView``: the same arrays as JAX's for ragged samples (padding
  -2048 / 0, ``in_sizes``, labels, index), and ``ValueError`` for a sample
  larger than the pad.
- ``prefetch_to_device``: the same order of ``put_fn`` calls and yields as
  JAX's, and the same end, for iterators shorter and longer than the
  prefetch depth; ``DeviceUploader`` on the CPU turns host arrays into
  tensors without a copy.
- One train step with ``fused_input=True`` (raw padded int16 volumes of
  two true extents, preprocessed in the step): ``med3ddramtiny`` (reg) and
  ``med3dtiny`` (CLS), float32, B=2, target 16x24x32, augmentation off,
  weights carried from JAX, against the JAX steps with
  ``fused_input=True`` under ``default_matmul_precision("highest")``,
  within ``tests/test_torch_train_step.py``'s bounds: the losses rtol
  1e-5 (coverage and total 5e-5), every gradient rtol 1e-4 with atol 1e-6
  plus 3e-3 of its peak, BN running statistics rtol 1e-5, labels equal.
  The fused eval step against JAX's: labels equal, dense maps (dRAM
  sigmoid maps, CLS per-voxel logits) within rtol 1e-4, atol 2e-5: the
  input's float32 order noise (at most 1e-5, the moments' sums) carried
  through the eval forward.
- The CLI: one epoch of ``med3ddramtiny`` with ``--input_pipeline device
  --pad_shape`` over a ragged archive writes its checkpoint, metrics and
  test predictions; without ``--pad_shape`` it raises ``ValueError``.
"""
import functools
import json
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from bodyct_dram_emph_subtype_tpu.data import COPDGeneSubtyping as JDataset
from bodyct_dram_emph_subtype_tpu.data.host_preprocess import \
    RawPaddedView as JRawPaddedView
from bodyct_dram_emph_subtype_tpu.data.loader import \
    prefetch_to_device as j_prefetch
from bodyct_dram_emph_subtype_tpu.models import get_model_by_name as jax_model
from bodyct_dram_emph_subtype_tpu.train.state import TrainState
from bodyct_dram_emph_subtype_tpu.train.steps import \
    make_cls_train_step as jax_cls_step
from bodyct_dram_emph_subtype_tpu.train.steps import \
    make_eval_step as jax_eval_step
from bodyct_dram_emph_subtype_tpu.train.steps import \
    make_reg_train_step as jax_reg_step
from bodyct_dram_emph_subtype_tpu_torch.data.datasets import \
    COPDGeneSubtyping
from bodyct_dram_emph_subtype_tpu_torch.data.host_preprocess import \
    RawPaddedView
from bodyct_dram_emph_subtype_tpu_torch.data.loader import (
    DeviceUploader, prefetch_to_device)
from bodyct_dram_emph_subtype_tpu_torch.models.registry import \
    get_model_by_name
from bodyct_dram_emph_subtype_tpu_torch.models.torch_import import (
    flax_path_to_torch_key, state_dict_from_jax)
from bodyct_dram_emph_subtype_tpu_torch.train.__main__ import main
from bodyct_dram_emph_subtype_tpu_torch.train.checkpoint import \
    CheckpointManager
from bodyct_dram_emph_subtype_tpu_torch.train.state import make_optimizer
from bodyct_dram_emph_subtype_tpu_torch.train.steps import (
    make_cls_train_step, make_eval_step, make_reg_train_step)
from tests.test_torch_train_step import (GRAD_PEAK_ATOL, SEG_RTOL, _flat,
                                         _grad_keeper, _to_torch_layout)

TARGET = (16, 24, 32)
PAD = (22, 30, 38)
EXTENTS = ((22, 30, 38), (19, 26, 33))
CW_CLE = np.asarray([0.2, 0.25, 0.15, 0.2, 0.1, 0.1], np.float32)
CW_PSE = np.asarray([0.3, 0.5, 0.2], np.float32)
# the decoder conv biases that feed a train BatchNorm (zero gradient in
# exact arithmetic; tests/test_torch_cls_train.py)
PRE_BN_BIAS = re.compile(r"us[12]\.conv_blocks\.\d\.0\.bias|us3\.0\.bias")


def _write_archive(root, extents, seed=0, labels=None):
    """``{uid}.npz`` scans of the given extents (int16 CT around -850 HU,
    a random lung) and ``merged.csv``."""
    rng = np.random.RandomState(seed)
    rows = ["SeriesInstanceUID,CT_Visual_Emph_Severity_P1,"
            "CT_Visual_Emph_Paraseptal_P1"]
    for i, shape in enumerate(extents):
        cle, pse = labels[i] if labels else (i % 6, i % 3)
        img = (rng.randn(*shape) * 150 - 850).astype(np.int16)
        lung = rng.rand(*shape) > 0.4
        np.savez(root / f"scan{i}.npz", image=img, lung_mask=lung,
                 cls_label=cle, pse_label=pse)
        rows.append(f"scan{i},{cle},{pse}")
    (root / "merged.csv").write_text("\n".join(rows) + "\n")
    return str(root / "merged.csv")


def _raw_batch(seed):
    """Two raw padded volumes of the EXTENTS, their lungs, extents and
    labels, as the device pipeline's loader stacks them."""
    rng = np.random.RandomState(seed)
    image = np.full((2, *PAD), -2048, np.int16)
    lung = np.zeros((2, *PAD), np.uint8)
    for b, shape in enumerate(EXTENTS):
        sl = (b,) + tuple(slice(0, s) for s in shape)
        image[sl] = (rng.randn(*shape) * 150 - 850).astype(np.int16)
        lung[sl] = rng.rand(*shape) > 0.35
    return {"image_raw": image, "lung_raw": lung,
            "in_sizes": np.asarray(EXTENTS, np.int32),
            "cls_label": np.asarray([3, 5], np.int32),
            "pse_label": np.asarray([1, 2], np.int32)}


def test_raw_padded_view_equals_jax(tmp_path):
    csv = _write_archive(tmp_path, [(20, 28, 36), (17, 28, 30), (20, 21, 36)])
    uids = COPDGeneSubtyping.get_series_uids(csv)
    view = RawPaddedView(COPDGeneSubtyping(str(tmp_path), uids), (20, 28, 36))
    jview = JRawPaddedView(JDataset(str(tmp_path), uids), (20, 28, 36))
    assert len(view) == len(jview) == 3
    for i in range(3):
        a, b = view[i], jview[i]
        assert set(a) == set(b) == {"image_raw", "lung_raw", "in_sizes",
                                    "cls_label", "pse_label", "index"}
        for k in a:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                          err_msg=k)
        assert a["image_raw"].dtype == np.int16
        assert a["lung_raw"].dtype == np.uint8
    assert view.series_uids == uids          # attributes pass through
    small = RawPaddedView(COPDGeneSubtyping(str(tmp_path), uids), (20, 27, 36))
    with pytest.raises(ValueError, match="exceeds pad_shape"):
        small[0]


@pytest.mark.parametrize("n", [0, 1, 2, 5])
@pytest.mark.parametrize("size", [1, 2, 3])
def test_prefetch_to_device_order_and_end_equal_jax(n, size):
    logs = {}
    for name, fn in (("port", prefetch_to_device), ("jax", j_prefetch)):
        log = []

        def put(x, log=log):
            log.append(("put", x))
            return x * 10

        for y in fn(iter(range(n)), put, size=size):
            log.append(("yield", y))
        logs[name] = log
    assert logs["port"] == logs["jax"]
    assert [y for e, y in logs["port"] if e == "yield"] == \
        [10 * i for i in range(n)]


def test_device_uploader_on_the_cpu_shares_the_arrays():
    arrays = {"image_raw": np.arange(24, dtype=np.int16).reshape(2, 3, 4),
              "in_sizes": np.asarray([[1, 2, 3], [2, 3, 4]], np.int32)}
    upload = DeviceUploader("cpu")(arrays)
    got = upload.ready()
    assert set(got) == set(arrays)
    for k, v in arrays.items():
        assert got[k].dtype == torch.from_numpy(v).dtype
        np.testing.assert_array_equal(got[k].numpy(), v)
    assert np.shares_memory(got["image_raw"].numpy(), arrays["image_raw"])


def _variables(arch, seed):
    model = jax_model(arch, packed_decoder=True)
    x0 = jnp.zeros((1, *TARGET, 1), jnp.float32)
    init = jax.jit(functools.partial(model.init, train=False))
    variables = jax.tree.map(np.asarray, dict(init(jax.random.PRNGKey(seed),
                                                   x0, x0)))
    if arch == "med3ddramtiny":
        # keep both maps off the coverage loss's clip edge, as
        # tests/test_torch_train_step.py does
        for i in range(2):
            fc = variables["params"][f"fc{i}"]
            fc["kernel"] = fc["kernel"] * np.float32(0.05)
            fc["bias"] = np.full_like(fc["bias"], -1.5)
    return model, variables


STEPS = {"reg": ("med3ddramtiny", 3, jax_reg_step, make_reg_train_step),
         "cls": ("med3dtiny", 5, jax_cls_step, make_cls_train_step)}


@pytest.mark.parametrize("kind", ["reg", "cls"])
def test_fused_input_train_step_matches_jax(kind):
    arch, seed, jax_step, port_step = STEPS[kind]
    model, variables = _variables(arch, seed)
    batch = _raw_batch(seed)
    tx = _grad_keeper()
    step = jax_step(model, tx, augment=False, fused_input=True,
                    target_size=TARGET)
    with jax.default_matmul_precision("highest"):
        new_state, j_metrics, j_preds = step(
            TrainState.create(variables, tx),
            {k: jnp.asarray(v) for k, v in batch.items()}, jnp.asarray(0.0),
            jnp.asarray(CW_CLE), jnp.asarray(CW_PSE), jax.random.PRNGKey(0))
    port = get_model_by_name(arch, packed_decoder=True)
    port.load_state_dict(state_dict_from_jax(variables), strict=True)
    marks = []
    metrics, preds = port_step(
        port, make_optimizer(port.parameters()), augment=False,
        fused_input=True, target_size=TARGET)(
            {k: torch.from_numpy(v) for k, v in batch.items()}, 0.0, CW_CLE,
            CW_PSE, mark=marks.append)
    assert marks[:2] == ["preprocess", "forward"]
    assert set(metrics) == set(j_metrics)
    for k, want in j_metrics.items():
        np.testing.assert_allclose(
            float(metrics[k]), float(want),
            rtol=SEG_RTOL if k in ("seg_loss", "loss") else 1e-5, err_msg=k)
    params = dict(port.named_parameters())
    grads = {flax_path_to_torch_key("params", path): _to_torch_layout(g)
             for path, g in _flat(jax.tree.map(np.asarray,
                                               new_state.opt_state)).items()}
    assert set(grads) == set(params)
    for key, g in grads.items():
        got = params[key].grad.numpy()
        if kind == "cls" and PRE_BN_BIAS.fullmatch(key):
            w = grads[key.replace(".bias", ".weight")]
            bound = 1e-6 + GRAD_PEAK_ATOL * np.abs(w).max()
            assert np.abs(got).max() <= bound and np.abs(g).max() <= bound
            continue
        np.testing.assert_allclose(
            got, g, rtol=1e-4, atol=1e-6 + GRAD_PEAK_ATOL * np.abs(g).max(),
            err_msg=key)
    buffers = dict(port.named_buffers())
    for path, v in _flat(jax.tree.map(np.asarray,
                                      new_state.batch_stats)).items():
        key = flax_path_to_torch_key("batch_stats", path)
        np.testing.assert_allclose(buffers[key].numpy(), v, rtol=1e-5,
                                   atol=1e-6, err_msg=key)
    for k in ("pred_cle_labels", "pred_pse_labels", "cle_labels",
              "pse_labels"):
        np.testing.assert_array_equal(preds[k].numpy(),
                                      np.asarray(j_preds[k]), err_msg=k)


@pytest.mark.parametrize("kind", ["reg", "cls"])
def test_fused_eval_step_matches_jax(kind):
    arch, seed = STEPS[kind][:2]
    model, variables = _variables(arch, seed)
    batch = _raw_batch(seed + 1)
    step = jax_eval_step(model, kind, fused_input=True, target_size=TARGET)
    with jax.default_matmul_precision("highest"):
        want = step(TrainState.create(variables, optax.sgd(0.0)),
                    {k: jnp.asarray(v) for k, v in batch.items()})
    port = get_model_by_name(arch, packed_decoder=True)
    port.load_state_dict(state_dict_from_jax(variables), strict=True)
    got = make_eval_step(port, kind, fused_input=True,
                         target_size=TARGET)(batch)
    for k in ("pred_cle_labels", "pred_pse_labels", "cle_labels",
              "pse_labels"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    for k in ("dense_cle", "dense_pse"):
        assert got[k].shape == want[k].shape
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-4, atol=2e-5, err_msg=k)


def test_cli_device_pipeline_trains_and_tests(tmp_path):
    csv = _write_archive(tmp_path, [(16, 20, 24), (14, 18, 24), (16, 17, 21),
                                    (12, 20, 22)],
                         labels=[(0, 0), (1, 1), (0, 2), (1, 0)])
    out = tmp_path / "models"
    argv = ["--model_arch", "med3ddramtiny", "--lr", "1e-3",
            "--max_epochs", "1", "--batch_size", "2", "--num_samples", "2",
            "--target_size", "16,24,32", "--workers", "2",
            "--data_path", str(tmp_path), "--train_csv", csv,
            "--valid_csv", csv, "--test_csv", csv,
            "--model_path", str(out), "--seed", "0", "--sampler_seed", "0",
            "--input_pipeline", "device", "--device", "cpu"]
    with pytest.raises(ValueError, match="needs pad_shape"):
        main(argv)
    assert main(argv + ["--pad_shape", "16,20,24"]) == 0
    exp = out / "subtyping_med3ddramtiny"
    ckpt = CheckpointManager(exp / "checkpoints")
    assert ckpt.epochs() == [0]
    m = ckpt.restore(0)["metrics"]
    assert m and all(np.isfinite(v) for v in m.values())
    lines = [json.loads(x) for x in
             (exp / "metrics.jsonl").read_text().splitlines()]
    assert [e["phase"] for e in lines] == ["train", "validate", "test"]
    rows = (exp / "predicts" / "test" / "0_predicts.csv").read_text() \
        .strip().splitlines()
    assert len(rows) == 1 + 4
