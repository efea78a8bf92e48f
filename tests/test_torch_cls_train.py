"""The classification (CLS) strategy of the port against the JAX package's,
on the CPU.

- One CLS train step of ``med3dtiny`` (float32, B=2, 16x24x32, the packed
  decoder on both sides, augmentation off, ``accum_steps`` 1 and 2)
  against JAX ``make_cls_train_step`` on the same weights, under
  ``default_matmul_precision("highest")``: the loss and its two
  components rtol 1e-5; every gradient rtol 1e-4, atol 1e-6 plus 3e-3 of
  the tensor's peak (``test_torch_train_step.py``'s bound); the updated
  BatchNorm running statistics rtol 1e-5; the predicted labels equal.
  Gradients are read as in ``test_torch_train_step.py``.  The five
  decoder conv biases feed a train BatchNorm, which removes them: their
  gradient is zero in exact arithmetic, and each side's float32 residue
  (the CLS loss's gradients are small: a mean over every voxel) must lie
  within the bound of the same conv's weight gradient.  The gradient
  compare is float32 against float32, so a pre-ReLU value within
  rounding of zero can take the other side of a ReLU in one framework and
  move the gradients upstream of it well past the bound; on other draws
  of this batch that happens in us2, where the port run in float64 agrees
  with the JAX step in float64.  On this draw every gradient holds the
  bound.
- The eval step in ``mode="cls"``: labels equal to JAX's.
- :func:`reweight_classes` against JAX ``SubtypeTrainer.
  _log_confusion_matrix`` (called as an unbound method on a stand-in):
  all correct, a class never seen, a mixed confusion.
- ``COPDGeneSubtyping`` over reference ``{uid}.pth`` caches written with
  ``torch.save`` in the schema of ``tests/test_torch_pickle.py``: the
  same items as the JAX dataset (which reads them torch-free).
- The CLIs: ``med3dtiny`` trains 2 epochs on the CPU, the class weights of
  each epoch's checkpoint are the re-weighting of the previous ones by
  that epoch's train predictions, and ``python -m
  bodyct_dram_emph_subtype_tpu_torch.evaluate`` restores epoch 1 by number
  and by path and writes the test CSV; without a card and without
  ``--device cpu`` it refuses to start; the trainer refuses the plain
  ``ResNet``.
"""
import csv
import functools
import re
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from bodyct_dram_emph_subtype_tpu.data import COPDGeneSubtyping as JDataset
from bodyct_dram_emph_subtype_tpu.models import get_model_by_name as jax_model
from bodyct_dram_emph_subtype_tpu.train.loop import \
    SubtypeTrainer as JaxTrainer
from bodyct_dram_emph_subtype_tpu.train.state import TrainState
from bodyct_dram_emph_subtype_tpu.train.steps import \
    make_cls_train_step as jax_cls_step
from bodyct_dram_emph_subtype_tpu.train.steps import \
    make_eval_step as jax_eval_step
from bodyct_dram_emph_subtype_tpu_torch.data.datasets import \
    COPDGeneSubtyping
from bodyct_dram_emph_subtype_tpu_torch.evaluate.__main__ import \
    main as evaluate_main
from bodyct_dram_emph_subtype_tpu_torch.models.registry import \
    get_model_by_name
from bodyct_dram_emph_subtype_tpu_torch.models.torch_import import (
    flax_path_to_torch_key, state_dict_from_jax)
from bodyct_dram_emph_subtype_tpu_torch.train.__main__ import \
    main as train_main
from bodyct_dram_emph_subtype_tpu_torch.train.checkpoint import \
    CheckpointManager
from bodyct_dram_emph_subtype_tpu_torch.train.loop import (SubtypeTrainer,
                                                           TrainerConfig,
                                                           reweight_classes)
from bodyct_dram_emph_subtype_tpu_torch.train.state import make_optimizer
from bodyct_dram_emph_subtype_tpu_torch.train.steps import (
    CLS_METRICS, make_cls_train_step, make_eval_step)
from tests.test_data import make_training_archive
from tests.test_torch_train_step import (GRAD_PEAK_ATOL, _flat,
                                         _grad_keeper, _to_torch_layout)

SHAPE = (16, 24, 32)
# the decoder conv biases that feed a train BatchNorm, which removes them
PRE_BN_BIAS = re.compile(r"us[12]\.conv_blocks\.\d\.0\.bias|us3\.0\.bias")
CW_CLE = np.asarray([0.2, 0.25, 0.15, 0.2, 0.1, 0.1], np.float32)
CW_PSE = np.asarray([0.3, 0.5, 0.2], np.float32)


@pytest.fixture(scope="module")
def setup():
    model = jax_model("med3dtiny", packed_decoder=True)
    x0 = jnp.zeros((1, *SHAPE, 1), jnp.float32)
    init = jax.jit(functools.partial(model.init, train=False))
    variables = jax.tree.map(np.asarray, dict(init(jax.random.PRNGKey(5),
                                                   x0, x0)))
    rng = np.random.RandomState(8)
    batch = {
        "image": rng.randn(2, *SHAPE).astype(np.float32),
        "lung_mask": (rng.rand(2, *SHAPE) > 0.3).astype(np.float32),
        "em_mask": (rng.rand(2, *SHAPE) > 0.8).astype(np.float32),
        "cls_label": np.asarray([3, 5], np.int32),
        "pse_label": np.asarray([1, 2], np.int32),
    }
    return model, variables, batch


def _port(variables):
    port = get_model_by_name("med3dtiny", packed_decoder=True)
    port.load_state_dict(state_dict_from_jax(variables), strict=True)
    return port


@pytest.mark.parametrize("accum_steps", [1, 2])
def test_cls_train_step_matches_jax(setup, accum_steps):
    model, variables, batch = setup
    tx = _grad_keeper()
    step = jax_cls_step(model, tx, augment=False, accum_steps=accum_steps)
    with jax.default_matmul_precision("highest"):
        new_state, j_metrics, j_preds = step(
            TrainState.create(variables, tx),
            {k: jnp.asarray(v) for k, v in batch.items()}, jnp.asarray(0.0),
            jnp.asarray(CW_CLE), jnp.asarray(CW_PSE), jax.random.PRNGKey(0))
    port = _port(variables)
    port_step = make_cls_train_step(port, make_optimizer(port.parameters()),
                                    augment=False, accum_steps=accum_steps)
    metrics, preds = port_step(batch, 0.0, CW_CLE, CW_PSE)
    assert set(metrics) == set(j_metrics) == set(CLS_METRICS)
    for k, want in j_metrics.items():
        np.testing.assert_allclose(float(metrics[k]), float(want), rtol=1e-5,
                                   err_msg=k)
    params = dict(port.named_parameters())
    grads = {flax_path_to_torch_key("params", path): _to_torch_layout(g)
             for path, g in _flat(jax.tree.map(np.asarray,
                                               new_state.opt_state)).items()}
    assert set(grads) == set(params)
    for key, g in grads.items():
        got = params[key].grad.numpy()
        if PRE_BN_BIAS.fullmatch(key):
            # zero in exact arithmetic: both sides hold the bound of the
            # same conv's weight gradient
            w = grads[key.replace(".bias", ".weight")]
            bound = 1e-6 + GRAD_PEAK_ATOL * np.abs(w).max()
            assert np.abs(got).max() <= bound and np.abs(g).max() <= bound
            continue
        np.testing.assert_allclose(
            got, g, rtol=1e-4, atol=1e-6 + GRAD_PEAK_ATOL * np.abs(g).max(),
            err_msg=key)
    buffers = dict(port.named_buffers())
    stats = _flat(jax.tree.map(np.asarray, new_state.batch_stats))
    for path, v in stats.items():
        key = flax_path_to_torch_key("batch_stats", path)
        np.testing.assert_allclose(buffers[key].numpy(), v, rtol=1e-5,
                                   atol=1e-6, err_msg=key)
    for k in ("pred_cle_labels", "pred_pse_labels", "cle_labels",
              "pse_labels"):
        np.testing.assert_array_equal(preds[k].numpy(),
                                      np.asarray(j_preds[k]), err_msg=k)


def test_cls_eval_step_matches_jax(setup):
    model, variables, batch = setup
    step = jax_eval_step(model, "cls")
    eval_batch = {k: jnp.asarray(batch[k]) for k in
                  ("image", "lung_mask", "cls_label", "pse_label")}
    with jax.default_matmul_precision("highest"):
        want = step(TrainState.create(variables, optax.sgd(0.0)), eval_batch)
    got = make_eval_step(_port(variables), "cls")(batch)
    for k in ("pred_cle_labels", "pred_pse_labels", "cle_labels",
              "pse_labels"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    assert got["dense_cle"].shape == (2, 8, 12, 16, 6)
    with pytest.raises(ValueError, match="mode"):
        make_eval_step(_port(variables), "seg")


REWEIGHT_CASES = {
    # every class seen and always right: 1 - acc is 0, weights kept
    "all correct": ([0, 1, 2, 3, 4, 5, 2], [0, 1, 2, 3, 4, 5, 2],
                    [0, 1, 2, 0, 1, 2, 2], [0, 1, 2, 0, 1, 2, 2]),
    # classes 4, 5 (CLE) and 2 (PSE) never seen: their 0/0 accuracy is 0
    "class never seen": ([0, 1, 2, 3, 0, 1], [0, 2, 2, 3, 1, 1],
                         [0, 1, 0, 1, 0, 1], [1, 1, 0, 0, 0, 1]),
    "mixed": ([0, 1, 2, 3, 4, 5, 5, 3, 2, 0], [0, 2, 2, 1, 4, 3, 5, 3, 0, 1],
              [0, 1, 2, 2, 1, 0, 0, 2, 1, 1], [0, 1, 2, 1, 1, 0, 2, 2, 0, 1]),
}


@pytest.mark.parametrize("case", list(REWEIGHT_CASES))
def test_reweight_classes_matches_jax(case, tmp_path):
    cle_true, cle_pred, pse_true, pse_pred = map(np.asarray,
                                                 REWEIGHT_CASES[case])
    stand_in = types.SimpleNamespace(
        config=types.SimpleNamespace(exp_path=tmp_path), tb_writer=None,
        mode="cls", cle_class_weights=np.asarray(CW_CLE, np.float64) * 3,
        pse_class_weights=np.asarray([0.2, 0.8, 0.8]))
    want = {"cle": stand_in.cle_class_weights.copy(),
            "pse": stand_in.pse_class_weights.copy()}
    got = {name: reweight_classes(want[name], y_true, y_pred)
           for name, y_true, y_pred in (("cle", cle_true, cle_pred),
                                        ("pse", pse_true, pse_pred))}
    JaxTrainer._log_confusion_matrix(stand_in, cle_pred, cle_true, "train",
                                     "cle", 6, 0)
    JaxTrainer._log_confusion_matrix(stand_in, pse_pred, pse_true, "train",
                                     "pse", 3, 0)
    for name in ("cle", "pse"):
        jax_new = np.asarray(getattr(stand_in, f"{name}_class_weights"))
        np.testing.assert_allclose(got[name], jax_new, rtol=1e-12,
                                   err_msg=name)
        if case == "all correct":
            np.testing.assert_array_equal(got[name], want[name])
        else:
            assert got[name].sum() == pytest.approx(1.0)
    if case == "class never seen":
        # unseen classes keep their share: 0/0 accuracy counts as 0
        assert got["cle"][4] > 0 and got["cle"][5] > 0 and got["pse"][2] > 0


def test_pth_dataset_equals_jax(tmp_path):
    """``{uid}.pth`` caches in the reference schema (int16 image, bool lung
    mask, int labels; one with a bfloat16 image) yield the same items in
    the port and in the JAX package; a uid with neither cache names both
    paths."""
    rng = np.random.RandomState(0)
    rows = ["SeriesInstanceUID,CT_Visual_Emph_Severity_P1,"
            "CT_Visual_Emph_Paraseptal_P1"]
    for i, (cle, pse) in enumerate(((3, 1), (0, 2), (5, 0))):
        img = rng.randint(-1200, 400, (20, 30, 40)).astype(np.int16)
        image = torch.from_numpy(img)
        if i == 2:
            image = image.to(torch.bfloat16)
        torch.save({"image": image,
                    "lung_mask": torch.from_numpy(rng.rand(20, 30, 40) > 0.5),
                    "cls_label": cle, "pse_label": pse},
                   tmp_path / f"uid{i}.pth")
        rows.append(f"uid{i},{cle},{pse}")
    rows.append("missing,0,0")
    (tmp_path / "merged.csv").write_text("\n".join(rows) + "\n")
    uids = ["uid0", "uid1", "uid2"]
    ds, jds = COPDGeneSubtyping(str(tmp_path), uids), \
        JDataset(str(tmp_path), uids)
    for i in range(3):
        a, b = ds[i], jds[i]
        assert set(a) == set(b) == {"image", "lung_mask", "cls_label",
                                    "pse_label", "em_mask", "index"}
        for k in a:
            assert isinstance(a[k], (np.ndarray, int)), k
            np.testing.assert_array_equal(
                np.asarray(a[k]), np.asarray(b[k]).astype(
                    np.asarray(a[k]).dtype), err_msg=k)
        assert type(a["cls_label"]) is int and a["em_mask"].any()
    assert ds[2]["image"].dtype == np.float32
    with pytest.raises(FileNotFoundError, match=r"missing\.npz.*missing\.pth"):
        COPDGeneSubtyping(str(tmp_path), ["missing"])[0]


@pytest.fixture
def archive(tmp_path):
    uids = make_training_archive(tmp_path, n=24, shape=(16, 20, 24))
    header = ("SeriesInstanceUID,CT_Visual_Emph_Severity_P1,"
              "CT_Visual_Emph_Paraseptal_P1")
    train = [f"{u},{i % 6},{i % 3}" for i, u in enumerate(uids)
             if i % 6 in (0, 1)]
    (tmp_path / "train.csv").write_text("\n".join([header] + train) + "\n")
    test = [f"{u},{i % 6},{i % 3}" for i, u in enumerate(uids[:5])]
    (tmp_path / "test.csv").write_text("\n".join([header] + test) + "\n")
    return tmp_path


def _argv(archive, out, arch="med3dtiny"):
    return ["--model_arch", arch, "--batch_size", "2",
            "--target_size", "16,24,32", "--workers", "2",
            "--data_path", str(archive),
            "--train_csv", str(archive / "train.csv"),
            "--valid_csv", str(archive / "train.csv"),
            "--test_csv", str(archive / "test.csv"),
            "--model_path", str(out)]


def _predicts(path):
    with open(path) as f:
        rows = list(csv.DictReader(f))
    return {k: np.asarray([int(r[k]) for r in rows])
            for k in ("y_preds_cle", "y_preds_pse", "y_cle", "y_pse")}, \
        [r["uid"] for r in rows]


def test_cls_cli_trains_reweights_and_evaluates(archive, tmp_path):
    out = tmp_path / "models"
    assert train_main(_argv(archive, out) + [
        "--lr", "1e-3", "--max_epochs", "2", "--num_samples", "2",
        "--seed", "0", "--sampler_seed", "0", "--device", "cpu"]) == 0
    exp = out / "subtyping_med3dtiny"
    ckpt = CheckpointManager(exp / "checkpoints")
    assert ckpt.epochs() == [0, 1]
    cfg = TrainerConfig(model_arch="med3dtiny", num_samples=2,
                        data_path=str(archive), sampler_seed=0,
                        train_csv=str(archive / "train.csv"), device="cpu")
    trainer = SubtypeTrainer(cfg)
    assert trainer.mode == "cls"
    trainer._dataset("train")
    weights = {"cle": trainer.cle_class_weights,
               "pse": trainer.pse_class_weights}
    for epoch in (0, 1):
        payload = ckpt.restore(epoch)
        assert set(payload["metrics"]) == set(CLS_METRICS)
        assert all(np.isfinite(v) for v in payload["metrics"].values())
        train, _ = _predicts(exp / "predicts" / "train"
                             / f"{epoch}_predicts.csv")
        for name in ("cle", "pse"):
            new = reweight_classes(weights[name], train[f"y_{name}"],
                                   train[f"y_preds_{name}"])
            saved = np.asarray(payload[f"{name}_class_weights"])
            np.testing.assert_allclose(saved, new, rtol=1e-12)
            if new.sum() > 0 and epoch == 0:
                # the sampler's clipped weights sum to 3: they moved
                assert saved.sum() == pytest.approx(1.0)
                assert not np.allclose(saved, weights[name])
            weights[name] = saved
    # the evaluation entry point: epoch 1 by number and by path
    by_number = evaluate_main(_argv(archive, out) + ["--ckp", "1",
                                                     "--device", "cpu"])
    rows1, uids = _predicts(exp / "predicts" / "test" / "1_predicts.csv")
    assert uids == [f"series{i:03d}" for i in range(5)]
    by_path = evaluate_main(_argv(archive, out) + [
        "--ckp", str(ckpt.path(1)), "--device", "cpu"])
    rows0, _ = _predicts(exp / "predicts" / "test" / "0_predicts.csv")
    assert by_number == by_path
    for k in rows1:
        np.testing.assert_array_equal(rows0[k], rows1[k], err_msg=k)
    assert 0.0 <= by_number["epoch_test_acc_cle"] <= 1.0


def test_entry_points_refuse(archive, tmp_path, monkeypatch):
    """No card and no ``--device cpu``: the evaluation entry point refuses
    to start; the trainer refuses the plain ``ResNet``."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        evaluate_main(_argv(archive, tmp_path / "m"))
    with pytest.raises(RuntimeError, match="--device cpu"):
        train_main(_argv(archive, tmp_path / "m") + ["--max_epochs", "1"])
    with pytest.raises(ValueError, match="plain ResNet"):
        train_main(_argv(archive, tmp_path / "m", "resnet34")
                   + ["--device", "cpu"])
