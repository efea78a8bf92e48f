"""Data parallelism: the process group, the differentiable sum all-reduce
and the epoch-end gather.

Counterpart of ``bodyct_dram_emph_subtype_tpu/parallel/mesh.py``.  The
reference trains with DDP over ``--ngpus`` (``train.py:70``) with
SyncBatchNorm and gathers its epoch outputs with ``cat_all_gather``
(``utils.py:66-80``); the JAX package runs one program over a ('data',
'spatial', 'model') mesh, where the losses and the BatchNorm moments are
reduced over the global batch.  The port runs one process (rank) per card
under ``torch.distributed``:

- ``--ngpus N`` (or ``--mesh data=N``) on one host starts N ranks, one per
  card (:func:`spawn_ranks`); ``--multihost`` reads torchrun's ``RANK``,
  ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``
  (:func:`init_distributed`).  The backend is NCCL on cards, gloo on the
  CPU and for ranks that share a card (more local ranks than cards:
  NCCL refuses them);
- :func:`all_sum` is a sum all-reduce whose backward sums the incoming
  gradients over the ranks.  Every global-batch sum of the losses and of
  train BatchNorm goes through it, so on W ranks each rank's gradient is W
  times its share of the global loss's gradient, and DDP's mean over the
  ranks gives the global gradient: W ranks at batch B equal one process at
  batch W*B with ``num_data_shards=W``;
- :func:`cat_all_gather` is the epoch-end gather (JAX
  ``multihost_utils.process_allgather``), over a gloo group, since NCCL
  cannot gather numpy arrays; :func:`gather_objects` under it also
  collects the deployment processor's per-rank results;
- :func:`distributed` runs a CLI's body as one rank: the training,
  evaluation and deployment CLIs share it and ``--multihost``.

Only the 'data' axis is ported: a mesh with ``spatial`` or ``model`` above
1 raises ``NotImplementedError`` (ROADMAP section 1).
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import logging
import os
import re
import socket
import subprocess
import sys
import time
from argparse import ArgumentParser
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)

LAUNCH_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT")
_HOST_GROUP = None      # gloo: object gathers and barriers


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Mesh layout: ``data`` replicas x ``spatial`` shards (volume H axis)
    x ``model`` shards (conv channel axis, tensor parallelism)."""
    data: int = 1
    spatial: int = 1
    model: int = 1

    @property
    def size(self):
        return self.data * self.spatial * self.model


def parse_mesh(value) -> Optional[MeshSpec]:
    """``data=2,spatial=2,model=2`` -> :class:`MeshSpec` (copy of JAX
    ``utils/cli.py::parse_mesh``); ``None`` stays ``None``."""
    if value is None or isinstance(value, MeshSpec):
        return value
    axes = {"data": 1, "spatial": 1, "model": 1}
    for part in str(value).split(","):
        part = part.strip()
        if not part:
            continue
        m = re.fullmatch(r"(data|spatial|model)\s*=\s*(\d+)", part)
        if not m:
            raise ValueError(
                f"cannot parse mesh axis {part!r} (expected e.g. "
                f"'data=2,spatial=2,model=2')")
        axes[m.group(1)] = int(m.group(2))
    return MeshSpec(**axes)


def data_width(mesh=None, nchips: Optional[int] = None,
               device: Optional[str] = None) -> int:
    """The number of data-parallel ranks that ``--mesh`` / ``--ngpus`` ask
    for; neither given: every visible card (JAX's ``nchips=None``), or 1
    on the CPU.  Raises ``NotImplementedError`` for a spatial or model
    axis."""
    spec = parse_mesh(mesh)
    if spec is not None:
        if spec.spatial > 1 or spec.model > 1:
            raise NotImplementedError(
                f"mesh {spec}: only the 'data' axis is ported; spatial "
                f"H-sharding and tensor parallelism are queued in ROADMAP "
                f"section 1 ('Spatial sharding, tensor parallelism and "
                f"remat')")
        return spec.data
    if nchips is not None:
        return int(nchips)
    on_cpu = device is not None and torch.device(device).type == "cpu"
    if on_cpu or not torch.cuda.is_available():
        return 1
    return torch.cuda.device_count()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn_ranks(module: str, argv: Sequence[str], world: int) -> int:
    """Run ``python -m module *argv --multihost`` as ``world`` ranks on
    this host (rank i on card i, modulo the cards), each with torchrun's
    environment, and wait for them; returns the first non-zero exit code
    (the other ranks are then stopped), else 0."""
    port = str(_free_port())
    root = str(Path(__file__).resolve().parents[2])
    procs = []
    for r in range(world):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(world),
                   LOCAL_RANK=str(r), LOCAL_WORLD_SIZE=str(world),
                   MASTER_ADDR="localhost", MASTER_PORT=port)
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (root, os.environ.get("PYTHONPATH")) if p)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", module, *argv, "--multihost"], env=env))
    code = 0
    try:
        while any(p.poll() is None for p in procs):
            failed = [p.returncode for p in procs
                      if p.returncode not in (None, 0)]
            if failed:
                code = failed[0]
                break
            time.sleep(0.2)
        else:
            code = next((p.returncode for p in procs if p.returncode), 0)
    finally:
        for p in procs:
            if p.poll() is None:
                p.terminate()
        for p in procs:
            p.wait()
    return code


def init_distributed(device: Optional[str] = None) -> torch.device:
    """Join the process group that torchrun's environment describes and
    return this rank's device: ``device`` as given, a bare or default
    ``cuda`` being card ``LOCAL_RANK`` modulo the visible cards.  The
    backend is NCCL, or gloo on the CPU and when this host runs more
    ranks (``LOCAL_WORLD_SIZE``) than it has cards (with a warning: the
    ranks then share cards and stage every collective through the
    host)."""
    global _HOST_GROUP
    missing = [k for k in LAUNCH_ENV if k not in os.environ]
    if missing:
        raise RuntimeError(f"--multihost needs torchrun's environment; "
                           f"{', '.join(missing)} not set")
    local = int(os.environ["LOCAL_RANK"])
    dev = torch.device(device or "cuda")
    backend = "gloo"
    if dev.type == "cuda":
        cards = torch.cuda.device_count()
        if dev.index is None:
            dev = torch.device("cuda", local % cards)
        torch.cuda.set_device(dev)
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", 1))
        backend = "nccl"
        if local_world > cards:
            backend = "gloo"
            logger.warning("%d local ranks share %d card(s): gloo, not "
                           "NCCL (NCCL refuses two ranks on one card)",
                           local_world, cards)
    if not dist.is_initialized():
        dist.init_process_group(
            backend, init_method=f"tcp://{os.environ['MASTER_ADDR']}:"
                                 f"{os.environ['MASTER_PORT']}",
            rank=int(os.environ["RANK"]),
            world_size=int(os.environ["WORLD_SIZE"]))
    # the tensor collectives (DDP's buckets, all_sum) share the default
    # group, so they run on one communicator in autograd's order
    _HOST_GROUP = (dist.group.WORLD if backend == "gloo"
                   else dist.new_group(backend="gloo"))
    logger.info("rank %d of %d on %s (%s)", rank(), world_size(), dev,
                backend)
    return dev


def add_distributed_args(p: ArgumentParser) -> None:
    p.add_argument("--multihost", action="store_true",
                   help="join the process group of torchrun's environment "
                        "(RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, "
                        "MASTER_PORT)")


@contextlib.contextmanager
def distributed(module: str, args, argv):
    """Run the block as this process's part of data parallelism (the
    training, evaluation and deployment CLIs): yields ``(device, rank)``,
    or ``None`` after the ranks that ``--ngpus`` / ``--mesh`` ask for have
    run ``module`` as child processes (raises ``SystemExit`` with their
    exit code if one failed)."""
    if not args.multihost:
        world = data_width(getattr(args, "mesh", None), args.nchips,
                           args.device)
        if world > 1:
            code = spawn_ranks(module, list(sys.argv[1:] if argv is None
                                            else argv), world)
            if code:
                raise SystemExit(code)
            yield None
            return
        yield args.device, 0
        return
    device = init_distributed(args.device)
    try:
        yield str(device), rank()
    finally:
        shutdown()


def shutdown() -> None:
    global _HOST_GROUP
    if dist.is_initialized():
        dist.destroy_process_group()
    _HOST_GROUP = None


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks; the backward sums the gradients over them."""

    @staticmethod
    def forward(ctx, x):
        y = x.detach().clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, grad):
        g = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g)
        return g


def all_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the ranks, differentiably (:class:`_AllReduceSum`);
    ``x`` itself in a world of one."""
    return _AllReduceSum.apply(x) if world_size() > 1 else x


def barrier() -> None:
    if world_size() > 1:
        dist.barrier(group=_HOST_GROUP)


def gather_objects(obj) -> List:
    """Every rank's ``obj``, in rank order."""
    if world_size() == 1:
        return [obj]
    out = [None] * world_size()
    dist.all_gather_object(out, obj, group=_HOST_GROUP)
    return out


def cat_all_gather(arrays: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """The per-rank arrays concatenated in rank order on every rank (JAX
    ``process_allgather`` + ``reshape(-1)``, reference ``cat_all_gather``)."""
    parts = gather_objects(arrays)
    return {k: np.concatenate([np.asarray(p[k]).reshape(-1) for p in parts])
            for k in arrays}


def check_replicas_equal(module: torch.nn.Module) -> None:
    """Raise ``RuntimeError`` unless every rank holds the same bytes in
    each of ``module``'s buffers (train BatchNorm updates its running
    statistics from the global moments on every rank; DDP runs with
    ``broadcast_buffers=False``)."""
    if world_size() == 1:
        return
    digest = {}
    for name, buf in module.state_dict().items():
        if name.endswith(("running_mean", "running_var")):
            digest[name] = hashlib.sha1(
                buf.detach().cpu().contiguous().numpy().tobytes()).hexdigest()
    ranks = gather_objects(digest)
    differ = sorted(k for k in digest if any(r[k] != ranks[0][k]
                                             for r in ranks))
    if differ:
        raise RuntimeError(f"running statistics differ across ranks: "
                           f"{differ[:5]}")
