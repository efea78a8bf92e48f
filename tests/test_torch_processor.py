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
import threading
import zlib

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
from bodyct_dram_emph_subtype_tpu_torch.data import datasets, mha
from bodyct_dram_emph_subtype_tpu_torch.data.datasets import \
    SubtypingInference
from bodyct_dram_emph_subtype_tpu_torch.inference import processor, \
    run_inference
from bodyct_dram_emph_subtype_tpu_torch.inference.processor import (
    _finalize_scan, _RawPredictView, gate_plan, pool_width)
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


def _assert_zlib_stats(stats, out):
    """``stats["zlib"]`` counts every slab of the heatmaps written under
    ``out``, at the pool's width, and each file's payload decodes with
    plain ``zlib.decompress`` to its voxels."""
    slabs = 0
    for sub in HEATMAPS:
        for path in sorted((out / "images" / sub).glob("*.mha")):
            raw = path.read_bytes()
            payload = raw[raw.index(b"ElementDataFile = LOCAL\n") + 24:]
            img = read_mha(path)
            assert zlib.decompress(payload) == img.array.tobytes()
            slabs += len(mha.slab_bounds(img.array.shape, np.uint8)) - 1
    assert slabs >= 4
    z = stats["zlib"]
    assert z["threads"] == pool_width() >= 1
    assert z["slabs"] == slabs and z["work_ms"] > 0


def test_finalize_writes_uint8_whatever_the_crops_hold(tmp_path):
    """Crops of another dtype are written as uint8, cast as the uint8
    canvas cast them before the writer pasted the crops itself."""
    rng = np.random.default_rng(0)
    crop = rng.uniform(0, 255, (2, 3, 3))
    rec = {"crop_slice": [(1, 3), (0, 3), (2, 5)], "original_size": (4, 3, 6),
           "cle_dense": crop, "pse_dense": (crop * 0.9).astype(np.float32),
           "cle_pct": 0.1, "pse_pct": 0.2}
    meta = {"origin": (0.0, 0.0, 0.0), "spacing": (1.0, 1.0, 1.0),
            "direction": np.eye(3).ravel()}
    dataset = type("D", (), {"scan_meta_cache": {"s": meta}})
    out = {n: tmp_path / n for n in ("cle", "pse")}
    for d in out.values():
        d.mkdir()
    _finalize_scan("s", rec, dataset=dataset, out_cle=out["cle"],
                   out_pse=out["pse"])
    for name in out:
        path = out[name] / "s.mha"
        assert b"ElementType = MET_UCHAR" in path.read_bytes()
        want = np.zeros((4, 3, 6), np.uint8)
        want[1:3, :, 2:5] = rec[f"{name}_dense"]
        assert np.array_equal(read_mha(path).array, want)


def _host_threads():
    """The names of the processor's live host threads: its completion and
    postprocess stages and its slab pool."""
    return sorted(t.name for t in threading.enumerate()
                  if t.name.startswith("proc-"))


def _run_watching_threads(cases, monkeypatch, fail=None):
    """A CPU ``run_inference`` of both scans in one batch on a slab pool
    of 3 threads, ``_finalize_scan`` raising for the uid ``fail``; returns
    the host threads seen alive where the completion stage handed the
    batch on and after each scan's files were written."""
    root, scans, lobes = cases
    seen, finalize, complete = [], processor._finalize_scan, \
        processor._complete

    def complete_watched(*a):
        complete(*a)
        seen.append(_host_threads())

    def finalize_watched(uid, rec, **kw):
        if uid == fail:
            raise RuntimeError(f"finalize {uid}")
        out = finalize(uid, rec, **kw)
        seen.append(_host_threads())
        return out

    monkeypatch.setattr(processor, "_finalize_scan", finalize_watched)
    monkeypatch.setattr(processor, "_complete", complete_watched)
    monkeypatch.setattr(processor, "pool_width", lambda: 3)
    run_inference(str(scans), str(lobes), str(root / "out"),
                  target_size=TARGET, batch_size=2, workers=1,
                  model=get_model_by_name("med3ddramtiny"), device="cpu")
    return seen


def test_postprocess_error_reaches_the_caller(cases, monkeypatch):
    """An error in the postprocess stage (``_finalize_scan`` of the
    second scan, after the first scan's slabs ran on the pool) re-raises
    in the caller of ``run_inference``, and neither stage thread nor any
    slab thread is left alive."""
    assert _host_threads() == []
    with pytest.raises(RuntimeError, match="finalize case2"):
        _run_watching_threads(cases, monkeypatch, fail="case2")
    assert _host_threads() == []


def test_no_host_thread_outlives_a_run(cases, monkeypatch):
    """While a run writes its heatmaps both stages and the slab pool are
    alive; after ``run_inference`` returns, none of their threads is."""
    seen = _run_watching_threads(cases, monkeypatch)
    assert len(seen) == 3 and all("proc-post" in names for names in seen)
    assert any("proc-complete" in names for names in seen)
    assert sum(any(n.startswith("proc-deflate") for n in names)
               for names in seen) >= 2
    assert _host_threads() == []


def test_prepare_pool_fills_its_stats(cases, monkeypatch):
    """The device path prepares each scan in slabs on the run's prepare
    pool, of ``pool_width()`` threads, counted in ``stats["prepare"]``;
    none of its threads outlives the run.  At width 1 the same slabs run
    in turn on the loader thread and the heatmaps are the same bytes."""
    root, scans, lobes = cases
    names, crop_slab = [], datasets._crop_slab

    def crop_slab_watched(*a):
        names.append(threading.current_thread().name)
        return crop_slab(*a)

    monkeypatch.setattr(datasets, "_crop_slab", crop_slab_watched)
    model = get_model_by_name("med3ddramtiny")
    runs = []
    for width in (3, 1):
        monkeypatch.setattr(processor, "pool_width", lambda w=width: w)
        names.clear()
        stats, out = {}, root / f"out{width}"
        run_inference(str(scans), str(lobes), str(out), target_size=TARGET,
                      batch_size=2, workers=1, model=model, device="cpu",
                      stats=stats)
        assert _host_threads() == []
        assert stats["prepare"]["threads"] == processor.pool_width() \
            == width
        assert stats["prepare"]["slabs"] > len(names) > 0
        assert stats["prepare"]["work_ms"] > 0
        assert all(n.startswith("proc-prepare") == (width > 1)
                   for n in names)
        runs.append((stats["prepare"]["slabs"], sorted(
            p.read_bytes() for p in (out / "images").rglob("*.mha"))))
    assert runs[0] == runs[1]


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
    _assert_zlib_stats(stats, cases[0] / "torch_out")
    assert stats["batches"] == 1 and stats["scans"] == 2
    assert stats["host_scans"] == []
    assert set(stats["stage_ms"]) == {
        "upload", "preprocess", "forward", "reduction", "heatmap", "download",
        "trunk", "decoder", "postprocess", "wait.loader", "wait.post", "io.read", "io.prepare",
        "post.upsample", "post.uncrop", "post.quantise", "post.zlib",
        "post.write"}


@pytest.mark.parametrize("device_preprocess", [True, False],
                         ids=["device_path", "host_path"])
def test_heatmaps_are_the_numpy_postprocess_bytes(cases, monkeypatch,
                                                  device_preprocess):
    """A CPU run writes every heatmap byte of the numpy postprocess that
    kernel G replaced, fed the same model outputs: on the device path the
    f16 half maps ``resize_linear_matmul_np``-ed to the model size and
    zeroed outside the ess mask, on the host path the predict step's
    masked maps; then ``resize_linear_matmul_np`` to the crop,
    ``windowing(x, (0, 1))`` as uint8, pasted into a zero canvas.  No
    crop came from a card.  Slabs of 16 KiB make each heatmap's stream
    several slabs long."""
    from bodyct_dram_emph_subtype_tpu_torch.inference import processor
    from bodyct_dram_emph_subtype_tpu_torch.parallel import spatial
    from bodyct_dram_emph_subtype_tpu_torch.data.host_preprocess import \
        resize_linear_matmul_np
    from bodyct_dram_emph_subtype_tpu_torch.utils.viz import windowing
    root, scans, lobes = cases
    seen = {"uids": [], "dense": [], "ess": [], "full": []}
    plan, forward = processor._heat_plan, spatial.forward_slabs
    preprocess, make_step = (processor.fused_preprocess_preselected,
                             processor.make_predict_step)

    def heat_plan(batch, owned):
        seen["uids"].append(list(batch["uid"]))
        return plan(batch, owned)

    def forward_slabs(*a):
        dense, heads = forward(*a)
        seen["dense"].append([d.clone() for d in dense])
        return dense, heads

    def fused_preprocess(*a, **k):
        out = preprocess(*a, **k)
        seen["ess"].append(out["em_mask"].clone())
        return out

    def make_predict_step(*a, **k):
        step = make_step(*a, **k)

        def run(*a, **k):
            out = step(*a, **k)
            seen["full"].append([out[f"{n}_dense_outs"].clone()
                                 for n in ("cle", "pse")])
            return out
        return run

    monkeypatch.setattr(processor, "_heat_plan", heat_plan)
    monkeypatch.setattr(spatial, "forward_slabs", forward_slabs)
    monkeypatch.setattr(processor, "fused_preprocess_preselected",
                        fused_preprocess)
    monkeypatch.setattr(processor, "make_predict_step", make_predict_step)
    monkeypatch.setattr(mha, "_SLAB_BYTES", 16 << 10)
    stats, out = {}, root / "out"
    run_inference(str(scans), str(lobes), str(out), target_size=TARGET,
                  batch_size=2, workers=1,
                  model=get_model_by_name("med3ddramtiny"), device="cpu",
                  stats=stats, device_preprocess=device_preprocess)
    assert stats["device_heatmaps"] == 0
    _assert_zlib_stats(stats, out)
    assert stats["zlib"]["slabs"] > 4
    ds = SubtypingInference(str(scans), str(lobes), keep_original=False,
                            compute_ess=False)
    meta = {d["uid"]: d for d in (ds[i] for i in range(len(ds)))}
    assert [u for uids in seen["uids"] for u in uids] == ["case1", "case2"]
    for b, uids in enumerate(seen["uids"]):
        for i, uid in enumerate(uids):
            if device_preprocess:
                ess = seen["ess"][b][i].numpy()
                maps = []
                for d in seen["dense"][b]:
                    up = resize_linear_matmul_np(
                        d[i, ..., 0].to(torch.float16).numpy().astype(
                            np.float32), TARGET, (0, 1, 2),
                        align_corners=True)
                    up[ess == 0] = 0.0
                    maps.append(up)
            else:
                maps = [f[i].numpy() for f in seen["full"][b]]
            crop = np.asarray(meta[uid]["crop_slice"])
            paste = tuple(slice(int(a), int(e)) for a, e in crop)
            for sub, m in zip(HEATMAPS, maps):
                want = np.zeros(tuple(int(s) for s in
                                      meta[uid]["original_size"]), np.uint8)
                want[paste] = windowing(resize_linear_matmul_np(
                    m, [int(e - a) for a, e in crop], (0, 1, 2),
                    align_corners=True), from_span=(0, 1)).astype(np.uint8)
                got = read_mha(out / "images" / sub / f"{uid}.mha").array
                assert got.dtype == np.uint8 and np.array_equal(got, want)
                assert want.any()


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
