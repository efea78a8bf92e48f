"""The trainer's epoch-end artifacts, ``--profile``, ``--debug_nans`` and
``check_val_every_n_epoch`` of the port against the JAX package's, on the
CPU.

- ``ops/resize.py::resize_linear`` against JAX's, float32, both corner
  conventions, static and tensor input sizes: rtol 1e-6, atol 1e-6 (the
  same float64 index tables and float32 lerp; the tensor-size branch
  computes its positions in float32 on both sides).
- ``_host_view_of_raw_batch`` of a raw padded batch against JAX's: equal
  arrays (the same numpy host preprocess).
- ``_draw_predictions`` of one eval batch, reg and CLS maps, against JAX's
  (both called on a stand-in trainer): the same JPEG file names, and the
  decoded tiles equal.
- The training CLI on ``med3ddramtiny`` (1 epoch with validation and
  test, ``--profile``) against the JAX trainer on the same archive and
  flow: the confusion-matrix PNG paths equal; the heatmap tiles under
  JAX's names (``debug_input_data/<epoch>/<phase>/<uid>_label_<cle>_<pred
  cle>_<pse>_<pred pse>.jpg``) for the same scans and true labels (the
  predictions differ: each side draws its own weights); the TensorBoard
  tag set equal to the one the JAX trainer writes; the Chrome trace
  ``profile/rank0.json`` holds a ``forward``, ``backward`` and
  ``optimizer`` span per step.
- ``check_val_every_n_epoch=2`` validates after the second epoch only.
- ``debug_nans``: a NaN in a weight raises ``FloatingPointError`` naming
  the loss.
"""
import json
import re
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from tests.test_data import make_training_archive

SHAPE = (16, 24, 32)


@pytest.mark.parametrize("align_corners", [False, True])
@pytest.mark.parametrize("tensor_sizes", [False, True])
def test_resize_linear_equals_jax(align_corners, tensor_sizes):
    import jax.numpy as jnp

    from bodyct_dram_emph_subtype_tpu.ops.resize import \
        resize_linear as jax_resize
    from bodyct_dram_emph_subtype_tpu_torch.ops.resize import resize_linear
    x = np.random.RandomState(0).rand(2, 7, 12, 9, 2).astype(np.float32)
    out, axes = (16, 23, 40), (1, 2, 3)
    in_sizes = (5, 12, 8) if tensor_sizes else None
    want = jax_resize(jnp.asarray(x), out, axes, align_corners,
                      in_sizes=None if in_sizes is None
                      else [jnp.asarray(n) for n in in_sizes])
    got = resize_linear(torch.from_numpy(x), out, axes, align_corners,
                        in_sizes=None if in_sizes is None
                        else [torch.tensor(n) for n in in_sizes])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def _stub(tmp_path, mode, target_size=SHAPE):
    return types.SimpleNamespace(
        config=types.SimpleNamespace(exp_path=tmp_path,
                                     target_size=target_size),
        datasets={}, mode=mode, _missing=None)


def _raw_batch(rng):
    sizes = np.asarray([[20, 30, 26], [18, 24, 36]], np.int32)
    raw = np.full((2, 24, 32, 40), -1000, np.int16)
    lung = np.zeros((2, 24, 32, 40), np.uint8)
    for i, s in enumerate(sizes):
        sl = tuple(slice(0, int(n)) for n in s)
        raw[i][sl] = (rng.randn(*s) * 150 - 880).astype(np.int16)
        lung[i][sl] = rng.rand(*s) > 0.3
    return {"image_raw": raw, "lung_raw": lung, "in_sizes": sizes,
            "index": np.asarray([[4], [1]])}


def test_host_view_of_raw_batch_equals_jax(tmp_path):
    from bodyct_dram_emph_subtype_tpu.train.loop import \
        SubtypeTrainer as JTrainer
    from bodyct_dram_emph_subtype_tpu_torch.train.loop import SubtypeTrainer
    batch = _raw_batch(np.random.RandomState(1))
    got = SubtypeTrainer._host_view_of_raw_batch(_stub(tmp_path, "reg"),
                                                 batch)
    want = JTrainer._host_view_of_raw_batch(_stub(tmp_path, "reg"), batch)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]),
                                      np.asarray(want[k]), err_msg=k)


@pytest.mark.parametrize("mode", ["reg", "cls"])
def test_draw_predictions_equal_jax(tmp_path, mode):
    import cv2

    from bodyct_dram_emph_subtype_tpu.train.loop import \
        SubtypeTrainer as JTrainer
    from bodyct_dram_emph_subtype_tpu_torch.train.loop import SubtypeTrainer
    rng = np.random.RandomState(2)
    batch = {"image": rng.randn(2, *SHAPE).astype(np.float32),
             "lung_mask": (rng.rand(2, *SHAPE) > 0.3).astype(np.float32),
             "em_mask": (rng.rand(2, *SHAPE) > 0.8).astype(np.float32),
             "index": np.asarray([[3], [0]])}
    dense = (8, 12, 16)
    channels = (1, 1) if mode == "reg" else (6, 3)
    res = {"dense_cle": rng.rand(2, *dense, channels[0]).astype(np.float32),
           "dense_pse": rng.rand(2, *dense, channels[1]).astype(np.float32),
           "cle_labels": np.asarray([3, 0]), "pse_labels": np.asarray([1, 2]),
           "pred_cle_labels": np.asarray([2, 0]),
           "pred_pse_labels": np.asarray([1, 1])}
    if mode == "cls":
        res["dense_cle"] -= 0.3
        res["dense_pse"] -= 0.3
    SubtypeTrainer._draw_predictions(_stub(tmp_path / "port", mode), batch,
                                     res, "test", 0)
    JTrainer._draw_predictions(_stub(tmp_path / "jax", mode), batch, res,
                               "test", 0)
    names = sorted(p.name for p in
                   (tmp_path / "jax" / "debug_input_data" / "0" / "test")
                   .iterdir())
    assert names == ["0_label_0_0_2_1.jpg", "3_label_3_2_1_1.jpg"]
    for name in names:
        got = cv2.imread(str(tmp_path / "port" / "debug_input_data" / "0"
                             / "test" / name))
        want = cv2.imread(str(tmp_path / "jax" / "debug_input_data" / "0"
                              / "test" / name))
        np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.fixture(scope="module")
def archive(tmp_path_factory):
    root = tmp_path_factory.mktemp("archive")
    uids = make_training_archive(root, n=12, shape=(16, 20, 24))
    header = ("SeriesInstanceUID,CT_Visual_Emph_Severity_P1,"
              "CT_Visual_Emph_Paraseptal_P1")
    for name, rows in (("train", [i for i in range(12) if i % 6 < 2]),
                       ("test", range(5))):
        (root / f"{name}.csv").write_text("\n".join(
            [header] + [f"{uids[i]},{i % 6},{i % 3}" for i in rows]) + "\n")
    return root


class _TagRecorder:
    """The JAX trainer's ``tb_writer`` stand-in: records the tags."""

    def __init__(self):
        self.tags = set()

    def scalar(self, tag, value, step):
        self.tags.add(tag)

    def image(self, tag, image, step):
        self.tags.add(tag)


def _tiles(exp: Path):
    """(epoch, phase, uid, true cle, true pse) of each tile; the names
    must follow JAX's pattern."""
    out = set()
    for p in (exp / "debug_input_data").rglob("*.jpg"):
        m = re.fullmatch(r"(series\d+)_label_(\d)_(\d)_(\d)_(\d)\.jpg",
                         p.name)
        assert m, p.name
        out.add((p.parent.parent.name, p.parent.name, m[1], m[2], m[4]))
    return out


def _pngs(exp: Path):
    return {str(p.relative_to(exp))
            for p in (exp / "confusion_matrices").rglob("*.png")}


def test_cli_artifacts_equal_jax(archive, tmp_path):
    from tensorboard.backend.event_processing.event_accumulator import \
        EventAccumulator

    from bodyct_dram_emph_subtype_tpu.train.loop import (
        SubtypeTrainer as JTrainer, TrainerConfig as JConfig)
    from bodyct_dram_emph_subtype_tpu_torch.train.__main__ import main
    from tests.test_torch_trainer import _argv
    argv = _argv(archive, tmp_path / "port", 1)
    assert main(argv + ["--profile", "--workers", "1"]) == 0
    exp = tmp_path / "port" / "subtyping_med3ddramtiny"

    cfg = JConfig(model_arch="med3ddramtiny", lr=1e-3, max_epochs=1,
                  batch_size=2, num_samples=2, target_size=SHAPE, workers=1,
                  data_path=str(archive),
                  train_csv=str(archive / "train.csv"),
                  valid_csv=str(archive / "train.csv"),
                  test_csv=str(archive / "test.csv"),
                  model_path=str(tmp_path / "jax"), nchips=1,
                  sampler_seed=0)
    jt = JTrainer(cfg)
    jt._tb = _TagRecorder()
    jt.init_state()
    jt.setup_checkpointing()
    jt.fit()
    jt.evaluate("test", epoch=jt.restore_best())

    assert _pngs(exp) == _pngs(cfg.exp_path) and _pngs(exp)
    assert _tiles(exp) == _tiles(cfg.exp_path) and _tiles(exp)
    acc = EventAccumulator(str(exp / "tb_logs"),
                           size_guidance={"scalars": 0, "images": 0})
    acc.Reload()
    tags = set(acc.Tags()["scalars"]) | set(acc.Tags()["images"])
    assert tags == jt._tb.tags

    trace = json.loads((exp / "profile" / "rank0.json").read_text())
    spans = [e["name"] for e in trace["traceEvents"]
             if e.get("cat") == "user_annotation"]
    steps = 2                     # 2 classes x num_samples 2 / batch 2
    for stage in ("augment", "forward", "backward", "optimizer"):
        assert spans.count(stage) == steps, (stage, spans)


@pytest.fixture
def trainer_config(archive, tmp_path):
    from bodyct_dram_emph_subtype_tpu_torch.train.loop import TrainerConfig

    def make(**kw):
        return TrainerConfig(**{
            "model_arch": "med3ddramtiny", "lr": 1e-3, "max_epochs": 2,
            "batch_size": 2, "num_samples": 2, "target_size": SHAPE,
            "workers": 1, "data_path": str(archive),
            "train_csv": str(archive / "train.csv"),
            "valid_csv": str(archive / "test.csv"),
            "model_path": str(tmp_path / "m"), "sampler_seed": 0,
            "debug_draw_batches": 0, "device": "cpu", **kw})

    return make


def test_check_val_every_n_epoch(trainer_config):
    from bodyct_dram_emph_subtype_tpu_torch.train.loop import SubtypeTrainer
    cfg = trainer_config(check_val_every_n_epoch=2)
    SubtypeTrainer(cfg).fit()
    lines = [json.loads(line) for line in
             (cfg.exp_path / "metrics.jsonl").read_text().splitlines()]
    assert [(e["epoch"], e["phase"]) for e in lines] == [
        (0, "train"), (1, "train"), (1, "validate")]
    assert not (cfg.exp_path / "debug_input_data").exists()


def test_debug_nans_raises_on_a_nan(trainer_config):
    from bodyct_dram_emph_subtype_tpu_torch.train.loop import SubtypeTrainer
    trainer = SubtypeTrainer(trainer_config(debug_nans=True, max_epochs=1))
    trainer.init_state()
    with torch.no_grad():
        trainer.model.conv1.weight[0, 0, 0, 0, 0] = float("nan")
    with pytest.raises(FloatingPointError, match="non-finite loss"):
        trainer.fit()
    assert not torch.is_anomaly_enabled()
