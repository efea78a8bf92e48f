"""The port's span helper (``utils/spans.py``) and the processor's spans
and counters (``stats["stage_ms"]``): the counters add up and lose no
update across threads, ``record_function`` runs only under a profiler,
and a CPU ``run_inference`` on both paths fills every counter the path
runs and shows its spans in a main-thread and an all-threads profile."""
import sys
import threading

import numpy as np
import pytest
import torch

from bodyct_dram_emph_subtype_tpu_torch.data.mha import (
    read_mha, slab_bounds, write_mha)
from bodyct_dram_emph_subtype_tpu_torch.inference import processor, \
    run_inference
from bodyct_dram_emph_subtype_tpu_torch.inference.processor import (
    COUNTERS, FORWARD_SPLIT, STAGES, pool_width)
from bodyct_dram_emph_subtype_tpu_torch.models.registry import \
    get_model_by_name
from bodyct_dram_emph_subtype_tpu_torch.utils import spans
from bodyct_dram_emph_subtype_tpu_torch.utils.spans import profiler, span

POST = ("post.upsample", "post.uncrop", "post.quantise", "post.zlib",
        "post.write")
# the postprocess spans that kernel G took over: kept as counters, never
# entered
KERNEL_G = {"post.upsample", "post.uncrop"}
DISPATCH = ("proc.setup", "wait.loader", "wait.post")


class _StepClock:
    """``time`` stand-in whose ``perf_counter`` advances ``step`` seconds
    per call in each thread (every span then lasts exactly ``step``)."""

    def __init__(self, step: float):
        self.step = step
        self._local = threading.local()

    def perf_counter(self) -> float:
        t = getattr(self._local, "t", 0.0) + self.step
        self._local.t = t
        return t


def test_span_counter_adds_up(monkeypatch):
    monkeypatch.setattr(spans, "time", _StepClock(0.25))
    into = {"b": 1.0}
    for _ in range(3):
        with span("a", into):
            pass
    with span("b", into):
        pass
    with span("c"):              # no counter: nothing added
        pass
    assert into == {"a": 750.0, "b": 251.0}


def test_span_counter_adds_on_raise(monkeypatch):
    monkeypatch.setattr(spans, "time", _StepClock(0.5))
    into = {}
    with pytest.raises(KeyError):
        with span("a", into):
            raise KeyError("x")
    assert into == {"a": 500.0}


def test_threads_lose_no_update(monkeypatch):
    """4 threads x 1000 spans of exactly 1 ms into one dict, with the
    interpreter switching threads as often as it can."""
    monkeypatch.setattr(spans, "time", _StepClock(1e-3))
    into = {}

    def work():
        for _ in range(1000):
            with span("wait.post", into):
                pass

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert into["wait.post"] == pytest.approx(4000.0, abs=1e-6)


def test_no_record_function_without_profiler(monkeypatch):
    opened = []
    real = torch.profiler.record_function

    def counting(name, *args):
        opened.append(name)
        return real(name, *args)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    into = {}
    with span("io.read", into):
        pass
    assert opened == [] and "io.read" in into
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with span("io.read", into):
            pass
    assert opened == ["io.read"]


def test_span_present_under_profiler():
    def worker():
        with span("in.worker"):
            torch.ones(4).sum()

    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as main_only:
        with span("in.main"):
            torch.ones(4).sum()
    with profiler(torch.device("cpu")) as every:
        with span("in.main"):
            t = threading.Thread(target=worker)
            t.start()
            t.join(timeout=60)
    assert not t.is_alive()
    assert "in.main" in {e.name for e in main_only.events()}
    assert {"in.main", "in.worker"} <= {e.name for e in every.events()}


def _write_case(scans, lobes, uid, shape, seed):
    rng = np.random.RandomState(seed)
    zz, yy, xx = np.mgrid[:shape[0], :shape[1], :shape[2]]
    lobe = ((((zz - shape[0] / 2) / (shape[0] * 0.35)) ** 2
             + ((yy - shape[1] / 2) / (shape[1] * 0.3)) ** 2
             + ((xx - shape[2] / 2) / (shape[2] * 0.35)) ** 2) < 1)
    ct = np.full(shape, -600, np.int16)
    ct[lobe] = (-880 + 60 * rng.randn(lobe.sum())).astype(np.int16)
    write_mha(scans / f"{uid}.mha", ct, (0.7, 0.7, 2.0))
    write_mha(lobes / f"{uid}.mha", lobe.astype(np.uint8), (0.7, 0.7, 2.0))


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    root = tmp_path_factory.mktemp("spans")
    scans, lobes = root / "ct", root / "lobes"
    scans.mkdir()
    lobes.mkdir()
    _write_case(scans, lobes, "case1", (48, 64, 80), 0)
    _write_case(scans, lobes, "case2", (40, 56, 72), 1)
    return root, scans, lobes


@pytest.mark.parametrize("device_preprocess", [True, False],
                         ids=["device_path", "host_path"])
def test_processor_spans_and_counters(cohort, device_preprocess):
    root, scans, lobes = cohort
    model = get_model_by_name("med3ddramtiny")

    def run(prof, tag):
        stats = {}
        with prof:
            run_inference(str(scans), str(lobes), str(root / tag),
                          target_size=(32, 48, 64), batch_size=2, workers=2,
                          model=model, device="cpu", stats=stats,
                          device_preprocess=device_preprocess)
        return stats, {e.name for e in prof.events()}

    stats, main_only = run(torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU]), "main")
    _, every = run(profiler(torch.device("cpu")), "every")

    stage_ms = stats["stage_ms"]
    assert set(stage_ms) == {*STAGES, *FORWARD_SPLIT, "postprocess",
                             *COUNTERS}
    ran = set(COUNTERS) - KERNEL_G
    assert all(stage_ms[k] > 0 for k in ran), stage_ms
    assert all(stage_ms[k] == 0 for k in KERNEL_G)
    assert stage_ms["heatmap"] > 0 and stats["device_heatmaps"] == 0
    assert sum(stage_ms[k] for k in POST) <= stage_ms["postprocess"]
    assert stats["pack_ms"] > 0 if device_preprocess else \
        stats["pack_ms"] == 0
    # the heatmap writer's slab pool: every slab of the 4 maps written
    heat = sorted((root / "main" / "images").glob("*/*.mha"))
    assert len(heat) == 4
    z = stats["zlib"]
    assert z["threads"] == pool_width() >= 1 and z["work_ms"] > 0
    assert z["slabs"] == sum(len(slab_bounds(read_mha(f).array.shape,
                                             np.uint8)) - 1 for f in heat)

    assert set(DISPATCH) | {"proc.dispatch", "proc.results"} <= main_only
    names = {"io.read", "io.prepare", "wait.copies", *POST} - KERNEL_G
    assert set(DISPATCH) | names <= every
    assert not KERNEL_G & every
    # the eval forward's stages, on the dispatch thread
    assert {"trunk", "stem", "layer1", "layer2", "layer3", "layer4",
            "decoder", "us1", "us2", "heads"} <= main_only


@pytest.mark.parametrize("device_preprocess", [True, False],
                         ids=["device_path", "host_path"])
def test_forward_splits_into_trunk_and_decoder(cohort, monkeypatch,
                                               device_preprocess):
    """``trunk`` and ``decoder`` (the model's ``decoder`` mark) sum to
    ``forward`` per batch, here on the CPU clock: both batches, both
    paths."""
    root, scans, lobes = cohort
    seen = []

    def post(*args, stage_ms, **kw):
        seen.append(dict(stage_ms))
        return batch_post(*args, stage_ms=stage_ms, **kw)

    batch_post = processor._batch_post
    monkeypatch.setattr(processor, "_batch_post", post)
    stats = {}
    run_inference(str(scans), str(lobes),
                  str(root / f"split{device_preprocess}"),
                  target_size=(32, 48, 64), batch_size=1, workers=1,
                  model=get_model_by_name("med3ddramtiny"), device="cpu",
                  stats=stats, device_preprocess=device_preprocess)
    assert len(seen) == stats["batches"] == 2
    for ms in seen:
        assert ms["trunk"] > 0 and ms["decoder"] > 0
        assert ms["trunk"] + ms["decoder"] == pytest.approx(ms["forward"],
                                                            rel=0.02)
    total = stats["stage_ms"]
    assert total["trunk"] + total["decoder"] == pytest.approx(
        total["forward"], rel=0.02)
