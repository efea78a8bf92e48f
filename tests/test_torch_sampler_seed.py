"""One resampled list per epoch on every rank (``train/loop.py::
resampled_list``).

``SubtypingStratifiedSampler`` reseeds from the wall clock every epoch
when it has no fixed seed (the CLI's default, as the reference).  Ranks
that read the clock in different seconds would deal their shards from
different lists, so rank 0's seed is taken by every rank.  The JAX
package runs one process per host, which deals one list to its data axis
(``loop.py:306-310``).

The gloo pair's rank code is this file's ``__main__``: the test starts it
as a script, one process per rank, with torchrun's environment, and each
rank's clock reads ``T0 + rank``.
"""
import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import pytest

from bodyct_dram_emph_subtype_tpu_torch.data.samplers import \
    SubtypingStratifiedSampler
from bodyct_dram_emph_subtype_tpu_torch.train import loop

REPO = Path(__file__).resolve().parents[1]
T0 = 1_700_000_000


def _sampler(seed=None):
    """A stratified sampler over 12 scans of CLE classes 0-5 (PSE 0-2), 8
    draws per class."""
    uids = [f"s{i}" for i in range(12)]
    source = SimpleNamespace(series_uids=uids, subtyping_labels={
        u: {"cle": str(i % 6), "pse": str(i % 3)} for i, u in
        enumerate(uids)})
    return SubtypingStratifiedSampler(source, 8, seed=seed)


def test_clocks_differ_so_lists_would_differ():
    """The fault's premise: a second of clock gives another list."""
    s = _sampler()
    assert s.epoch_indices(T0) != s.epoch_indices(T0 + 1)


def test_rank_takes_rank0_seed(monkeypatch):
    """With ``gather_objects`` standing in for rank 0 at ``T0``, a rank
    whose clock reads ``T0 + 1`` draws rank 0's list."""
    monkeypatch.setattr(loop, "world_size", lambda: 2)
    monkeypatch.setattr(loop, "gather_objects", lambda obj: [T0, obj])
    monkeypatch.setattr(time, "time", lambda: T0 + 1.5)
    s = _sampler()
    assert loop.resampled_list(s) == s.epoch_indices(T0)


@pytest.mark.parametrize("world,seed", [(1, None), (2, 7)])
def test_own_seed_without_a_gather(monkeypatch, world, seed):
    """One process draws from its own clock, and a fixed seed is every
    rank's already: neither gathers."""
    def no_gather(obj):
        raise AssertionError("gathered")

    monkeypatch.setattr(loop, "world_size", lambda: world)
    monkeypatch.setattr(loop, "gather_objects", no_gather)
    monkeypatch.setattr(time, "time", lambda: T0 + 1.5)
    s = _sampler(seed)
    want = T0 + 1 if seed is None else seed
    assert loop.resampled_list(s) == s.epoch_indices(want)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_gloo_pair_draws_one_list(tmp_path):
    """Two gloo ranks whose clocks differ by 1 s draw the same list: rank
    0's, from ``T0``."""
    port, procs = str(_free_port()), []
    for r in range(2):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE="2", LOCAL_RANK=str(r),
                   MASTER_ADDR="localhost", MASTER_PORT=port,
                   PYTHONPATH=str(REPO))
        procs.append(subprocess.Popen(
            [sys.executable, __file__, str(tmp_path)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    try:
        outs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out[-4000:]}"
    lists = [json.loads((tmp_path / f"rank{r}.json").read_text())
             for r in range(2)]
    assert lists[0] == lists[1] == _sampler().epoch_indices(T0)


def _rank_main(work: Path) -> None:
    from bodyct_dram_emph_subtype_tpu_torch.parallel.mesh import (
        init_distributed, rank, shutdown)
    init_distributed("cpu")
    r = rank()
    time.time = lambda: T0 + r + 0.5
    (work / f"rank{r}.json").write_text(
        json.dumps(loop.resampled_list(_sampler())))
    shutdown()


if __name__ == "__main__":
    _rank_main(Path(sys.argv[1]))
