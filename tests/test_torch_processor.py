"""The port's deployment processor against the JAX package's, end to end:
the ``tests/test_processor.py`` synthetic scans, ``med3ddramtiny`` with one
set of weights, target (32, 48, 64), float32, through both
``run_inference``s, on the device path (both ship the block-gated 10-bit
CT stream), the host-preprocess path and the per-scan fallbacks between
them (a crop over the pad, a gated stream over its budget).  Score JSONs
equal, percentages within 1e-4, heatmaps within one uint8 count.

At the default pad the upload buffer is 32 x 288 x 384 (27648 blocks of
128); case1 has 1072 live blocks, case2 970, so ``gated_frac`` 0.0362 (a
budget of 1000 blocks) sends case1 alone to the host path."""
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
from bodyct_dram_emph_subtype_tpu_torch.data.datasets import \
    SubtypingInference
from bodyct_dram_emph_subtype_tpu_torch.inference import run_inference
from bodyct_dram_emph_subtype_tpu_torch.inference.processor import (
    _RawPredictView, gate_plan)
from bodyct_dram_emph_subtype_tpu_torch.models.registry import \
    get_model_by_name
from bodyct_dram_emph_subtype_tpu_torch.models.torch_import import \
    state_dict_from_jax
from test_processor import _write_case

TARGET = (32, 48, 64)
HEATMAPS = ("centrilobular-emphysema-heatmap", "paraseptal-emphysema-heatmap")
SCORE_JSONS = ("centrilobular-emphysema-score.json",
               "araseptal-emphysema-score.json")
OVER_BUDGET_FRAC = 0.0362       # 1000 blocks: case1 (1072) over, case2 under


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


def _assert_matches_jax(tres, jres, tout, jout, want=("case1", "case2")):
    uids = [r["entity"] for r in jres]
    assert [r["entity"] for r in tres] == uids == list(want)
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
    assert [r["entity"] for r in
            json.loads((tout / "results.json").read_text())] == uids
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


def _live_blocks(scans, lobes, pad_shape=(160, 288, 384)):
    up_shape, block, _ = gate_plan(TARGET, pad_shape)
    ds = SubtypingInference(str(scans), str(lobes), keep_original=False,
                            compute_ess=False)
    view = _RawPredictView(ds, up_shape, TARGET, 10 ** 12, block)
    return {ds[i]["uid"]: int(view[i]["gate_blocks"].sum())
            for i in range(len(ds))}


def test_gated_upload_is_the_planned_stream(cases):
    """The device path uploads the gated stream of ``gate_plan`` (stream,
    gate bits, lung bits, extents, moments) and matches the JAX device
    path; ``gate_plan`` sizes the budget as JAX ``processor.py:373-379``."""
    root, scans, lobes = cases
    stats = _run_both(root, scans, lobes, gated_frac=0.5)
    up_shape, block, budget = gate_plan(TARGET, (160, 288, 384), 0.5)
    assert (up_shape, block) == ((32, 288, 384), 128)
    assert budget == 13824 * 128           # 27648 blocks x 0.5
    per_batch = 2 * (budget * 5 // 4 + 27648 // 8
                     + int(np.prod(TARGET)) // 8 + 3 * 4 + 2 * 4)
    assert stats["upload_bytes"] == per_batch * stats["batches"]
    assert stats["pack_ms"] > 0 and stats["host_scans"] == []


def test_gated_budget_overflow_falls_back_per_scan(cases, caplog):
    """A scan whose live blocks exceed the budget falls back alone, as in
    the JAX package (its ``oversized``), with a warning that names it."""
    root, scans, lobes = cases
    live = _live_blocks(scans, lobes)
    _, block, budget = gate_plan(TARGET, (160, 288, 384), OVER_BUDGET_FRAC)
    assert live["case2"] * block <= budget < live["case1"] * block
    with caplog.at_level(logging.WARNING,
                         logger="bodyct_dram_emph_subtype_tpu_torch"):
        stats = _run_both(root, scans, lobes, batch_size=1,
                          gated_frac=OVER_BUDGET_FRAC)
    assert stats["host_scans"] == ["case1"]
    assert stats["batches"] == 3
    warned = [r.getMessage() for r in caplog.records
              if r.name.startswith("bodyct_dram_emph_subtype_tpu_torch")
              and "exceeds budget" in r.getMessage()]
    assert len(warned) == 1 and "case1" in warned[0]


def test_pad_without_gate_block_takes_the_host_path(cases, caplog):
    """An upload buffer of 32 x 60 x 74 voxels (not a multiple of 8 blocks
    of 64) has no gate block: the run warns and takes the host path, as the
    JAX processor does, and ``gate_plan`` refuses it instead of dividing by
    0."""
    root, scans, lobes = cases
    with pytest.raises(ValueError, match="no gate block"):
        gate_plan(TARGET, (160, 60, 74))
    with caplog.at_level(logging.WARNING,
                         logger="bodyct_dram_emph_subtype_tpu_torch"):
        stats = _run_both(root, scans, lobes, pad_shape=(160, 60, 74))
    assert stats["host_scans"] == ["case1", "case2"]
    assert stats["upload_bytes"] == 0
    assert any("gate block" in r.getMessage() for r in caplog.records
               if r.name.startswith("bodyct_dram_emph_subtype_tpu_torch"))


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
    # a spatial axis is not ported (the data axis is,
    # tests/test_torch_processor_ddp.py)
    with pytest.raises(NotImplementedError, match="spatial"):
        main(["--mesh", "data=1,spatial=2", "--device", "cpu"])


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


def test_cli_gated_frac_reaches_the_budget(cases, caplog):
    from bodyct_dram_emph_subtype_tpu_torch.inference.__main__ import main
    root, scans, lobes = cases
    out = root / "cli_gated_out"
    with caplog.at_level(logging.WARNING,
                         logger="bodyct_dram_emph_subtype_tpu_torch"):
        main(["--scan_path", str(scans), "--lobe_path", str(lobes),
              "--output_path", str(out), "--model_arch", "med3ddramtiny",
              "--ckp", str(root / "missing.ckpt"), "--target_size",
              ",".join(map(str, TARGET)), "--compute_dtype", "float32",
              "--device", "cpu", "--gated_frac", str(OVER_BUDGET_FRAC)])
    warned = [r.getMessage() for r in caplog.records
              if "exceeds budget" in r.getMessage()]
    assert len(warned) == 1 and "case1" in warned[0]
    results = json.loads((out / "results.json").read_text())
    assert [r["entity"] for r in results] == ["case1", "case2"]


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


# --------------------------------------------- --ckp: what build_model loads
def _port_results(root, scans, lobes, name, **kw):
    """The port's ``run_inference`` of ``med3ddramtiny`` into
    ``root/name``; returns (results, fractions, output directory)."""
    stats, out = {}, root / name
    res = run_inference(str(scans), str(lobes), str(out),
                        model_arch="med3ddramtiny", target_size=TARGET,
                        batch_size=2, workers=1, device="cpu", stats=stats,
                        **kw)
    return res, stats["fractions"], out


def _same_outputs(a, b):
    """Two port runs wrote the same results and the same heatmaps, bit for
    bit."""
    assert a[0] == b[0] and a[1] == b[1]
    for sub in HEATMAPS:
        for uid in a[1]:
            x = read_mha(a[2] / "images" / sub / f"{uid}.mha").array
            y = read_mha(b[2] / "images" / sub / f"{uid}.mha").array
            assert np.array_equal(x, y)


def test_ckp_directory_restores_the_newest_epoch(cases, caplog):
    """A checkpoint directory of the port trainer (two epochs) restores its
    newest epoch ("train -> deploy", JAX ``processor.py:583-590``): the
    results equal those of that epoch's model passed in."""
    from bodyct_dram_emph_subtype_tpu_torch.train.checkpoint import \
        CheckpointManager
    from bodyct_dram_emph_subtype_tpu_torch.train.state import \
        make_optimizer as torch_optimizer
    root, scans, lobes = cases
    mgr = CheckpointManager(root / "checkpoints")
    models = [get_model_by_name("med3ddramtiny",
                                generator=torch.Generator().manual_seed(s))
              for s in (1, 2)]
    for epoch, model in enumerate(models):
        mgr.save(epoch, model, torch_optimizer(model.parameters(), 1e-4),
                 np.ones(6) / 6, np.ones(3) / 3)
    with caplog.at_level(logging.INFO,
                         logger="bodyct_dram_emph_subtype_tpu_torch"):
        got = _port_results(root, scans, lobes, "from_dir",
                            ckp_path=str(root / "checkpoints"))
    assert any("epoch 1" in r.getMessage() for r in caplog.records)
    _same_outputs(got, _port_results(root, scans, lobes, "newest",
                                     model=models[1].eval()))
    assert got[1] != _port_results(root, scans, lobes, "oldest",
                                   model=models[0].eval())[1]


def test_ckp_npz_matches_jax_processor(cases):
    """A ``.npz`` of ``state_dict_from_jax(variables)`` loads greedily
    (JAX ``train/checkpoint.py:72-79``): the results equal the JAX
    processor's with those variables, in the bounds of
    :func:`_assert_matches_jax`."""
    root, scans, lobes = cases
    variables = _shared_weights()
    npz = root / "weights.npz"
    np.savez(npz, **{k: v.numpy() for k, v in
                     state_dict_from_jax(variables).items()})
    jout = root / "jax_out"
    jres = jax_run_inference(
        str(scans), str(lobes), str(jout), model_arch="med3ddramtiny",
        ckp_path=None, target_size=TARGET, batch_size=1, workers=1,
        nchips=1, state=TrainState.create(variables, make_optimizer()))
    tres, _, tout = _port_results(root, scans, lobes, "torch_out",
                                  ckp_path=str(npz))
    _assert_matches_jax(tres, jres, tout, jout)


def test_ckp_unknown_suffix_raises(tmp_path):
    """An existing weights file of another suffix raises ``ValueError``, as
    JAX ``greedy_restore_variables`` does."""
    from bodyct_dram_emph_subtype_tpu_torch.inference import build_model
    path = tmp_path / "weights.txt"
    path.write_text("not weights")
    with pytest.raises(ValueError, match="unsupported weights file"):
        build_model("med3ddramtiny", ckp_path=str(path))


@pytest.mark.parametrize("name", ["missing.ckpt", "missing_checkpoints"])
def test_ckp_missing_path_warns_and_uses_the_seed(tmp_path, caplog, name):
    """A path that does not exist (a file or a directory name) warns and
    gives the seed's random weights; no directory is created."""
    from bodyct_dram_emph_subtype_tpu_torch.inference import build_model
    path = tmp_path / name
    with caplog.at_level(logging.WARNING,
                         logger="bodyct_dram_emph_subtype_tpu_torch"):
        model = build_model("med3ddramtiny", ckp_path=str(path), seed=3)
    assert any("random weights (seed 3)" in r.getMessage()
               for r in caplog.records)
    assert not path.exists()
    want = get_model_by_name("med3ddramtiny",
                             generator=torch.Generator().manual_seed(3))
    got = model.state_dict()
    assert all(torch.equal(got[k], v) for k, v in want.state_dict().items())
