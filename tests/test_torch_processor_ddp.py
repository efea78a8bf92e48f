"""The deployment processor's data axis on the CPU: two gloo ranks against
the JAX processor at ``nchips=2``.

Three synthetic scans (``tests/test_processor.py``'s cases): ``scan_a``
and ``scan_c`` with lung crops 49 x 67 in-plane, ``scan_b`` 55 x 71.
Sorted, rank 0 is dealt ``scan_a``, ``scan_c`` and rank 1 ``scan_b`` plus
the wrap-around padding ``scan_a``, which rank 1 runs but does not write.
One launch per case group, three in all:

- the CLI, ``--ngpus 2 --device cpu --ckp w.npz`` at batch 1, against the
  JAX ``run_inference(nchips=2)`` on the same variables, in the bounds of
  ``tests/test_torch_processor.py::_assert_matches_jax``: scores and score
  JSONs equal, percentages within 1e-4, heatmaps within one uint8 count;
  rank 0 alone prints, each scan's heatmaps written by one rank;
- this file's ``__main__`` as two ranks calling ``run_inference``: one scan
  on two ranks at batch 2 gives one result; at ``pad_shape`` (160, 52, 384)
  ``scan_b``'s crop exceeds the pad and falls back to the host path on
  rank 1, its owner, alone;
- the CLI with ``--mesh data=2`` on the host path, and with ``--mesh
  spatial=2,model=2`` on the device path: four ranks score every scan,
  each on its H slab of the model input and its channel slice of the
  weights, rank 0 alone writes them; against one process's
  ``run_inference`` on the same weights: scores, score JSONs and results
  equal, percentages within 1e-4 (the fractions unrounded within 1e-5
  relative), heatmaps within one uint8 count.
"""
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from bodyct_dram_emph_subtype_tpu_torch.inference.__main__ import main

REPO = Path(__file__).resolve().parents[1]
TARGET = (32, 48, 64)
UIDS = ["scan_a", "scan_b", "scan_c"]
NARROW_PAD = (160, 52, 384)           # scan_b's crop (55 rows) exceeds it


def _write_scans(root: Path):
    from test_processor import _write_case
    scans, lobes, only, only_lobes = (root / "ct", root / "lobes",
                                      root / "ct1", root / "lobes1")
    for d in (scans, lobes, only, only_lobes):
        d.mkdir(parents=True)
    _write_case(scans, lobes, "scan_a", shape=(40, 56, 72), seed=1)
    _write_case(scans, lobes, "scan_b")
    _write_case(scans, lobes, "scan_c", shape=(40, 56, 72), seed=2)
    _write_case(only, only_lobes, "only", shape=(40, 56, 72), seed=3)
    return scans, lobes, only, only_lobes


@pytest.fixture(scope="module")
def scans(tmp_path_factory):
    root = tmp_path_factory.mktemp("ddp_scans")
    return (root, *_write_scans(root))


def _argv(scans, lobes, out, *extra):
    return ["--scan_path", str(scans), "--lobe_path", str(lobes),
            "--output_path", str(out), "--model_arch", "med3ddramtiny",
            "--target_size", ",".join(map(str, TARGET)),
            "--compute_dtype", "float32", "--device", "cpu",
            "--workers", "1", *extra]


def _printed(text: str):
    """The ``results:`` and ``stats:`` lines the CLI printed."""
    lines = text.splitlines()
    results = [ln for ln in lines if ln.startswith("results: ")]
    stats = [json.loads(ln.removeprefix("stats: ")) for ln in lines
             if ln.startswith("stats: ")]
    return results, stats


def test_cli_two_ranks_match_jax_processor(scans, capfd):
    from bodyct_dram_emph_subtype_tpu.inference import \
        run_inference as jax_run_inference
    from bodyct_dram_emph_subtype_tpu.train.state import (TrainState,
                                                          make_optimizer)
    from bodyct_dram_emph_subtype_tpu_torch.models.torch_import import \
        state_dict_from_jax
    from test_torch_processor import _assert_matches_jax, _shared_weights
    root, ct, lobes, _, _ = scans
    variables = _shared_weights()
    npz = root / "w.npz"
    np.savez(npz, **{k: v.numpy() for k, v in
                     state_dict_from_jax(variables).items()})
    jout, tout = root / "jax_out", root / "cli_out"
    jres = jax_run_inference(
        str(ct), str(lobes), str(jout), model_arch="med3ddramtiny",
        ckp_path=None, target_size=TARGET, batch_size=1, workers=1,
        nchips=2, state=TrainState.create(variables, make_optimizer()))
    capfd.readouterr()
    main(_argv(ct, lobes, tout, "--ngpus", "2", "--ckp", str(npz),
               "--batch_size", "1"))
    results, stats = _printed(capfd.readouterr().out)
    tres = json.loads((tout / "results.json").read_text())
    _assert_matches_jax(tres, jres, tout, jout, want=UIDS)
    assert len(results) == 1 and len(stats) == 1      # rank 0 alone
    ranks = stats[0]["ranks"]
    assert [r["finalized"] for r in ranks] == [["scan_a", "scan_c"],
                                               ["scan_b"]]
    assert [r["batches"] for r in ranks] == [2, 2]    # rank 1: + padding


def test_cli_mesh_data_axis(scans, capfd):
    root, ct, lobes, _, _ = scans
    out = root / "mesh_out"
    capfd.readouterr()
    main(_argv(ct, lobes, out, "--mesh", "data=2", "--ckp", "none",
               "--host_preprocess"))
    _, stats = _printed(capfd.readouterr().out)
    results = json.loads((out / "results.json").read_text())
    assert [r["entity"] for r in results] == UIDS
    assert stats[0]["world"] == 2
    assert [r["host_scans"] for r in stats[0]["ranks"]] == \
        [["scan_a", "scan_c"], ["scan_b"]]
    for sub in ("centrilobular-emphysema-heatmap",
                "paraseptal-emphysema-heatmap"):
        assert sorted(p.stem for p in (out / "images" / sub).iterdir()) \
            == UIDS
    # the spatial and model axes: every scan on all four ranks, one H slab
    # and one channel slice each
    from bodyct_dram_emph_subtype_tpu_torch.inference.processor import \
        run_inference
    from test_torch_processor import _assert_matches_jax
    sout, oout = root / "spatial_out", root / "one_out"
    main(_argv(ct, lobes, sout, "--mesh", "spatial=2,model=2", "--ckp",
               "none"))
    _, stats = _printed(capfd.readouterr().out)
    one_stats = {}
    one = run_inference(str(ct), str(lobes), str(oout),
                        model_arch="med3ddramtiny", ckp_path="none",
                        target_size=TARGET, workers=1, device="cpu",
                        stats=one_stats)
    _assert_matches_jax(json.loads((sout / "results.json").read_text()),
                        one, sout, oout, want=UIDS)
    ranks = stats[0]["ranks"]
    assert [r["finalized"] for r in ranks] == [UIDS, [], [], []]
    assert [r["batches"] for r in ranks] == [2, 2, 2, 2]
    for uid, want in one_stats["fractions"].items():
        np.testing.assert_allclose(ranks[0]["fractions"][uid], want,
                                   rtol=1e-5)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def ranks(scans):
    """Each rank's record of :func:`_rank_main`'s cases."""
    root = scans[0]
    port, procs = str(_free_port()), []
    for r in range(2):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE="2", LOCAL_RANK=str(r),
                   MASTER_ADDR="localhost", MASTER_PORT=port,
                   PYTHONPATH=os.pathsep.join((str(REPO),
                                               str(REPO / "tests"))))
        procs.append(subprocess.Popen(
            [sys.executable, __file__, str(root)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    try:
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out[-4000:]}"
    return [json.loads((root / f"rank{r}.json").read_text())
            for r in range(2)]


def test_one_scan_on_two_ranks_gives_one_result(ranks, scans):
    """One scan, two ranks at batch 2 (the JAX test
    ``test_single_scan_fills_multi_chip_batch``): rank 1 runs the padding
    and writes nothing; every rank returns the one result."""
    for r, rec in enumerate(ranks):
        case = rec["one"]
        assert [x["entity"] for x in case["results"]] == ["only"]
        assert case["stats"]["finalized"] == (["only"] if r == 0 else [])
        assert case["stats"]["batches"] == 1
    out = scans[0] / "out_one"
    assert [x["entity"] for x in
            json.loads((out / "results.json").read_text())] == ["only"]


def test_oversized_scan_falls_back_on_its_rank(ranks, scans):
    """``scan_b`` exceeds the pad: rank 1, its owner, runs it on the host
    path; rank 0 holds it nowhere and falls back on nothing."""
    want = {0: [], 1: ["scan_b"]}
    for r, rec in enumerate(ranks):
        case = rec["over"]
        assert case["stats"]["host_scans"] == want[r]
        assert [x["entity"] for x in case["results"]] == UIDS
    gathered = ranks[0]["over"]["stats"]["ranks"]
    assert [g["host_scans"] for g in gathered] == [[], ["scan_b"]]
    assert sorted(u for g in gathered for u in g["finalized"]) == UIDS
    # two device-path batches on each rank at batch 1, plus rank 1's host
    assert [g["batches"] for g in gathered] == [2, 3]


def _rank_main(root: Path) -> None:
    from bodyct_dram_emph_subtype_tpu_torch.inference import run_inference
    from bodyct_dram_emph_subtype_tpu_torch.parallel.mesh import (
        init_distributed, rank, shutdown)
    init_distributed("cpu")
    cases = {"one": dict(scans=root / "ct1", lobes=root / "lobes1",
                         batch_size=2),
             "over": dict(scans=root / "ct", lobes=root / "lobes",
                          batch_size=1, pad_shape=NARROW_PAD)}
    record = {}
    for name, kw in cases.items():
        stats = {}
        results = run_inference(
            str(kw.pop("scans")), str(kw.pop("lobes")),
            str(root / f"out_{name}"), model_arch="med3ddramtiny",
            ckp_path=None, target_size=TARGET, workers=1,
            compute_dtype="float32", device="cpu", stats=stats, **kw)
        record[name] = {"results": results, "stats": {
            k: stats[k] for k in ("finalized", "host_scans", "batches",
                                  "ranks")}}
    (root / f"rank{rank()}.json").write_text(json.dumps(record))
    shutdown()


if __name__ == "__main__":
    _rank_main(Path(sys.argv[1]))
