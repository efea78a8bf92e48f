"""The port's training entry point end to end on the CPU, over a synthetic
archive (``tests/test_data.py::make_training_archive``): ``main(argv)`` of
``python -m bodyct_dram_emph_subtype_tpu_torch.train`` runs
``med3ddramtiny`` for 2 epochs x 2 steps with augmentation, writes a
checkpoint per epoch, restores the best epoch and evaluates the test
split; a second run resumes from the checkpoints.  The host layer
(sampler, index sharding, ``PreprocessedView``) equals the JAX package's
for the same seed.
"""
import json

import numpy as np
import pytest
import torch

from bodyct_dram_emph_subtype_tpu.data import COPDGeneSubtyping as JDataset
from bodyct_dram_emph_subtype_tpu.data import \
    SubtypingStratifiedSampler as JSampler
from bodyct_dram_emph_subtype_tpu.data import shard_indices as j_shard
from bodyct_dram_emph_subtype_tpu.data.host_preprocess import \
    PreprocessedView as JView
from bodyct_dram_emph_subtype_tpu_torch.data.datasets import \
    COPDGeneSubtyping
from bodyct_dram_emph_subtype_tpu_torch.data.host_preprocess import \
    PreprocessedView
from bodyct_dram_emph_subtype_tpu_torch.data.samplers import (
    SubtypingStratifiedSampler, shard_indices)
from bodyct_dram_emph_subtype_tpu_torch.models.registry import \
    get_model_by_name
from bodyct_dram_emph_subtype_tpu_torch.train.__main__ import main
from bodyct_dram_emph_subtype_tpu_torch.train.checkpoint import \
    CheckpointManager
from bodyct_dram_emph_subtype_tpu_torch.train.loop import (SubtypeTrainer,
                                                           TrainerConfig)
from bodyct_dram_emph_subtype_tpu_torch.train.state import epoch_lr
from tests.test_data import make_training_archive

LR = 1e-3


@pytest.fixture
def archive(tmp_path):
    uids = make_training_archive(tmp_path, n=24, shape=(16, 20, 24))
    header = ("SeriesInstanceUID,CT_Visual_Emph_Severity_P1,"
              "CT_Visual_Emph_Paraseptal_P1")
    # CLE classes 0 and 1 only: 2 classes x num_samples 2 = 4 samples,
    # 2 steps of batch 2 per epoch
    train = [f"{u},{i % 6},{i % 3}" for i, u in enumerate(uids)
             if i % 6 in (0, 1)]
    (tmp_path / "train.csv").write_text("\n".join([header] + train) + "\n")
    test = [f"{u},{i % 6},{i % 3}" for i, u in enumerate(uids[:5])]
    (tmp_path / "test.csv").write_text("\n".join([header] + test) + "\n")
    return tmp_path


def _argv(archive, out, epochs, reload_only_weights=1):
    return ["--model_arch", "med3ddramtiny", "--lr", str(LR),
            "--max_epochs", str(epochs), "--batch_size", "2",
            "--num_samples", "2", "--target_size", "16,24,32",
            "--workers", "2", "--data_path", str(archive),
            "--train_csv", str(archive / "train.csv"),
            "--valid_csv", str(archive / "train.csv"),
            "--test_csv", str(archive / "test.csv"),
            "--model_path", str(out), "--seed", "0", "--sampler_seed", "0",
            "--reload_only_weights", str(reload_only_weights),
            "--device", "cpu"]


def test_cli_trains_checkpoints_resumes_and_tests(archive, tmp_path):
    out = tmp_path / "models"
    assert main(_argv(archive, out, 2)) == 0
    exp = out / "subtyping_med3ddramtiny"
    ckpt = CheckpointManager(exp / "checkpoints")
    assert ckpt.epochs() == [0, 1]
    init = get_model_by_name("med3ddramtiny",
                             generator=torch.Generator().manual_seed(0))
    p0 = init.state_dict()
    for epoch in (0, 1):
        payload = ckpt.restore(epoch)
        assert payload["epoch"] == epoch
        m = payload["metrics"]
        assert set(m) == {"loss", "loss_cle", "loss_pse", "mul_loss",
                          "seg_loss"}
        assert all(np.isfinite(v) for v in m.values())
        sd = payload["model"]
        assert all(torch.isfinite(v.float()).all() for v in sd.values())
        moved = max((sd[k] - p0[k]).abs().max().item() for k in p0
                    if k.endswith("weight"))
        assert moved > 0
        # lr of the epoch is epoch_lr; Adam took 2 steps per epoch
        opt = payload["optimizer"]
        assert opt["param_groups"][0]["lr"] == pytest.approx(
            epoch_lr(LR, epoch), rel=1e-12)
        assert float(opt["state"][0]["step"]) == 2 * (epoch + 1)
    # BN running statistics moved off their init
    rv = ckpt.restore(1)["model"]["layer4.0.bn2.running_var"]
    assert not torch.allclose(rv, torch.ones_like(rv))
    lines = [json.loads(x) for x in
             (exp / "metrics.jsonl").read_text().splitlines()]
    phases = [e["phase"] for e in lines]
    assert phases.count("train") == 2 and phases.count("validate") == 2
    assert phases[-1] == "test"
    assert 0.0 <= lines[-1]["epoch_test_acc_cle"] <= 1.0
    csv = (exp / "predicts" / "test").glob("*_predicts.csv")
    rows = next(csv).read_text().strip().splitlines()
    assert len(rows) == 1 + 5          # wrap-around duplicates dropped
    assert (exp / "debug.log").exists()

    # resume: weights, Adam state and the next epoch come back
    cfg = TrainerConfig(model_arch="med3ddramtiny", lr=LR, max_epochs=3,
                        batch_size=2, num_samples=2,
                        target_size=(16, 24, 32), data_path=str(archive),
                        train_csv=str(archive / "train.csv"),
                        model_path=str(out), sampler_seed=0, device="cpu")
    trainer = SubtypeTrainer(cfg)
    trainer.init_state()
    trainer.setup_checkpointing()
    assert trainer.try_resume(reload_only_weights=False)
    assert trainer.epoch == 2
    last = ckpt.restore(1)
    for k, v in trainer.model.state_dict().items():
        assert torch.equal(v, last["model"][k]), k
    st = trainer.optimizer.state_dict()["state"]
    assert float(st[0]["step"]) == 4
    assert torch.equal(st[0]["exp_avg"], last["optimizer"]["state"][0]
                       ["exp_avg"])
    # the CLI run of a third epoch continues from there
    assert main(_argv(archive, out, 3, reload_only_weights=0)) == 0
    assert ckpt.epochs() == [0, 1, 2]
    third = ckpt.restore(2)["optimizer"]
    assert float(third["state"][0]["step"]) == 6
    assert third["param_groups"][0]["lr"] == pytest.approx(epoch_lr(LR, 2))


@pytest.mark.parametrize("flag", [["--input_pipeline", "device"],
                                  ["--remat", "all"], ["--mesh", "data=2"],
                                  ["--ngpus", "2"], ["--noise_rng", "rbg"],
                                  ["--multihost"]])
def test_cli_refuses_what_is_not_ported(archive, tmp_path, flag):
    argv = _argv(archive, tmp_path / "m", 1) + flag
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        main(argv)


def test_sampler_and_preprocessed_view_equal_jax(archive):
    csv = str(archive / "merged.csv")
    uids = COPDGeneSubtyping.get_series_uids(csv)
    assert uids == JDataset.get_series_uids(csv)
    ds, jds = COPDGeneSubtyping(str(archive), uids), \
        JDataset(str(archive), uids)
    s, js = SubtypingStratifiedSampler(ds, 3, seed=5), JSampler(jds, 3,
                                                                 seed=5)
    np.testing.assert_array_equal(s.cle_class_weights, js.cle_class_weights)
    np.testing.assert_array_equal(s.pse_class_weights, js.pse_class_weights)
    idx, jidx = list(iter(s)), list(iter(js))
    assert idx == jidx and len(idx) == 18
    for epoch in (0, 3):
        np.testing.assert_array_equal(
            shard_indices(idx, 1, 0, shuffle=True, epoch=epoch),
            j_shard(jidx, 1, 0, shuffle=True, epoch=epoch))
    view, jview = PreprocessedView(ds, (16, 24, 32)), \
        JView(jds, (16, 24, 32))
    for i in (0, 7):
        a, b = view[i], jview[i]
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(np.asarray(a[k]),
                                          np.asarray(b[k]), err_msg=k)
