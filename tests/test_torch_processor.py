"""The port's deployment processor against the JAX package's, end to end:
the ``tests/test_processor.py`` synthetic scans, ``med3ddramtiny`` with one
set of weights, target (32, 48, 64), float32, through both
``run_inference``s, on the device path, the host-preprocess path and the
per-scan fallback between them.  Score JSONs equal, percentages within
1e-4, heatmaps within one uint8 count."""
import functools
import json
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bodyct_dram_emph_subtype_tpu.data import read_mha
from bodyct_dram_emph_subtype_tpu.inference import \
    run_inference as jax_run_inference
from bodyct_dram_emph_subtype_tpu.models import get_model_by_name as jax_model
from bodyct_dram_emph_subtype_tpu.train.state import TrainState, make_optimizer
from bodyct_dram_emph_subtype_tpu_torch.inference import run_inference
from bodyct_dram_emph_subtype_tpu_torch.models.registry import \
    get_model_by_name
from bodyct_dram_emph_subtype_tpu_torch.models.torch_import import \
    state_dict_from_jax
from test_processor import _write_case

TARGET = (32, 48, 64)
HEATMAPS = ("centrilobular-emphysema-heatmap", "paraseptal-emphysema-heatmap")
SCORE_JSONS = ("centrilobular-emphysema-score.json",
               "araseptal-emphysema-score.json")


@pytest.fixture
def cases(tmp_path):
    scans, lobes = tmp_path / "ct", tmp_path / "lobes"
    scans.mkdir()
    lobes.mkdir()
    _write_case(scans, lobes, "case1")
    _write_case(scans, lobes, "case2", shape=(40, 56, 72), seed=1)
    return tmp_path, scans, lobes


def _shared_weights():
    model = jax_model("med3ddramtiny")
    x = jnp.zeros((1, *TARGET, 1), jnp.float32)
    init = jax.jit(functools.partial(model.init, train=False))
    return jax.tree.map(np.asarray, dict(init(jax.random.PRNGKey(0), x, x)))


def _assert_matches_jax(tres, jres, tout, jout):
    uids = [r["entity"] for r in jres]
    assert [r["entity"] for r in tres] == uids == ["case1", "case2"]
    for t, j in zip(tres, jres):
        assert set(t["metrics"]) == set(j["metrics"])
        for name in ("cle", "pse"):
            key = f"{name}_lesion_percentage_per_lung"
            assert abs(float(t["metrics"][key]) - float(j["metrics"][key])) \
                <= 1e-4
            key = f"{name}_severity_score"
            assert t["metrics"][key] == j["metrics"][key]
    for fname in SCORE_JSONS:
        assert json.loads((tout / fname).read_text()) == \
            json.loads((jout / fname).read_text())
    assert len(json.loads((tout / "results.json").read_text())) == 2
    for sub in HEATMAPS:
        for uid in uids:
            t = read_mha(tout / "images" / sub / f"{uid}.mha")
            j = read_mha(jout / "images" / sub / f"{uid}.mha")
            assert t.array.dtype == np.uint8
            assert t.array.shape == j.array.shape
            assert (t.spacing, t.origin) == (j.spacing, j.origin)
            diff = np.abs(t.array.astype(int) - j.array.astype(int))
            assert diff.max() <= 1


def _run_both(root, scans, lobes, batch_size=2, **kw):
    """Both packages' ``run_inference`` on the same weights; the port's
    ``stats`` come back too."""
    variables = _shared_weights()
    jout, tout = root / "jax_out", root / "torch_out"
    jres = jax_run_inference(
        str(scans), str(lobes), str(jout), model_arch="med3ddramtiny",
        ckp_path=None, target_size=TARGET, batch_size=1, workers=1,
        nchips=1, state=TrainState.create(variables, make_optimizer()), **kw)
    port = get_model_by_name("med3ddramtiny")
    port.load_state_dict(state_dict_from_jax(variables), strict=True)
    stats = {}
    tres = run_inference(str(scans), str(lobes), str(tout),
                         target_size=TARGET, batch_size=batch_size,
                         workers=1, model=port, device="cpu", stats=stats,
                         **kw)
    _assert_matches_jax(tres, jres, tout, jout)
    return stats


def test_processor_matches_jax_processor(cases):
    stats = _run_both(*cases)
    assert stats["batches"] == 1 and stats["scans"] == 2
    assert stats["host_scans"] == []
    assert set(stats["stage_ms"]) == {"upload", "preprocess", "forward",
                                      "reduction", "download", "postprocess"}


def test_oversized_crop_falls_back_per_scan(cases, caplog):
    """case1's lung crop (55 x 71 in-plane) is taller than the pad, case2's
    (49 x 67) fits: only case1 runs the host path, as in the JAX package,
    and the results keep the cohort order."""
    with caplog.at_level(logging.WARNING,
                         logger="bodyct_dram_emph_subtype_tpu_torch"):
        stats = _run_both(*cases, batch_size=1, pad_shape=(160, 52, 384))
    assert stats["host_scans"] == ["case1"]
    assert stats["batches"] == 3      # two device-path batches, one host
    warned = [r.getMessage() for r in caplog.records
              if r.name.startswith("bodyct_dram_emph_subtype_tpu_torch")
              and "exceeds in-plane pad" in r.getMessage()]
    assert len(warned) == 1 and "case1" in warned[0]


def test_host_preprocess_matches_jax_host_path(cases):
    stats = _run_both(*cases, device_preprocess=False)
    assert stats["host_scans"] == ["case1", "case2"]
    assert stats["batches"] == 1
    assert set(stats["fractions"]) == {"case1", "case2"}


def test_cli_writes_the_output_contract(cases):
    from bodyct_dram_emph_subtype_tpu_torch.inference.__main__ import main
    root, scans, lobes = cases
    out = root / "cli_out"
    main(["--scan_path", str(scans), "--lobe_path", str(lobes),
          "--output_path", str(out), "--model_arch", "med3ddramtiny",
          "--ckp", str(root / "missing.ckpt"), "--target_size", "16,24,32",
          "--compute_dtype", "float32", "--device", "cpu"])
    for fname in SCORE_JSONS:
        assert set(json.loads((out / fname).read_text())) == \
            {"score", "percentage"}
    for sub in HEATMAPS:
        assert (out / "images" / sub / "case2.mha").exists()
    with pytest.raises(SystemExit):
        main(["--nchips", "2"])


def test_cli_host_preprocess(cases):
    from bodyct_dram_emph_subtype_tpu_torch.inference.__main__ import main
    root, scans, lobes = cases
    out = root / "cli_host_out"
    main(["--scan_path", str(scans), "--lobe_path", str(lobes),
          "--output_path", str(out), "--model_arch", "med3ddramtiny",
          "--ckp", str(root / "missing.ckpt"), "--target_size", "16,24,32",
          "--compute_dtype", "float32", "--device", "cpu",
          "--host_preprocess"])
    results = json.loads((out / "results.json").read_text())
    assert [r["entity"] for r in results] == ["case1", "case2"]
    for sub in HEATMAPS:
        assert (out / "images" / sub / "case1.mha").exists()


@pytest.mark.parametrize("entry", ["run_inference", "SubtypeTrainer"])
def test_entry_points_need_a_card_unless_asked(cases, monkeypatch, entry):
    """Without a CUDA device an entry point given no device raises and says
    how to ask for the CPU; it never moves to the CPU by itself."""
    from bodyct_dram_emph_subtype_tpu_torch.train.loop import (
        SubtypeTrainer, TrainerConfig)
    root, scans, lobes = cases
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        if entry == "run_inference":
            run_inference(str(scans), str(lobes), str(root / "out"),
                          model_arch="med3ddramtiny", ckp_path=None,
                          target_size=(16, 24, 32))
        else:
            SubtypeTrainer(TrainerConfig(model_arch="med3ddramtiny"))
