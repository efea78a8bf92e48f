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

The mesh (:func:`set_mesh`): ``--mesh data=D,spatial=S,model=M`` runs
D*S*M ranks, rank ``r = (d*S + s)*M + m`` at coordinates (d, s, m)
(:func:`coords`), JAX's data-major ``reshape(data, spatial, model)``.
Every rank creates every group in the same order: ``spatial`` (fixed d,
m: the halo exchange of ``parallel/spatial.py``), ``model`` (fixed d, s:
the channel gathers of ``parallel/tensor.py``), ``data`` (fixed s, m: the
per-row sums of the losses) and ``replica`` (fixed m, spanning data x
spatial: the batch's voxel sums, train BatchNorm and DDP).  Axes whose
groups hold the same ranks share one group, so one communicator (at
``data=1`` ``replica`` is ``spatial``, at ``spatial=1`` it is ``data``),
and under NCCL every communicator is connected before the first step.
The gradient rule above holds per group: every partial sum goes through
:func:`all_sum` over the group it spans, DDP over the ``replica`` group
divides by its D*S ranks, and the model axis's channel gather sums its
gradient over the model group (``parallel/tensor.py``).
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


def mesh_width(mesh=None, nchips: Optional[int] = None,
               device: Optional[str] = None) -> int:
    """The number of ranks that ``--mesh`` / ``--ngpus`` ask for: D*S*M of
    a mesh, else ``nchips`` data-parallel ranks (JAX ``loop.py:126-141``);
    neither given: every visible card (JAX's ``nchips=None``), or 1 on the
    CPU."""
    spec = parse_mesh(mesh)
    if spec is not None:
        return spec.size
    if nchips is not None:
        return int(nchips)
    on_cpu = device is not None and torch.device(device).type == "cpu"
    if on_cpu or not torch.cuda.is_available():
        return 1
    return torch.cuda.device_count()


@dataclasses.dataclass
class _Layout:
    spec: MeshSpec
    coords: tuple
    groups: dict


_LAYOUT: Optional[_Layout] = None
AXES = ("spatial", "model", "data", "replica")


def _axis_ranks(spec: MeshSpec):
    """``{axis: [rank lists]}``: every group of every axis, in the order
    every rank creates them."""
    dd, ss, mm = spec.data, spec.spatial, spec.model

    def r(d, s, m):
        return (d * ss + s) * mm + m

    return {
        "spatial": [[r(d, s, m) for s in range(ss)]
                    for d in range(dd) for m in range(mm)],
        "model": [[r(d, s, m) for m in range(mm)]
                  for d in range(dd) for s in range(ss)],
        "data": [[r(d, s, m) for d in range(dd)]
                 for s in range(ss) for m in range(mm)],
        "replica": [[r(d, s, m) for d in range(dd) for s in range(ss)]
                    for m in range(mm)]}


def set_mesh(spec: Optional[MeshSpec] = None) -> MeshSpec:
    """Lay the process group out as ``spec`` (default: every rank on the
    data axis) and create the groups of :data:`AXES` (a no-op when that
    layout is set already).  Every rank must call it, in the same order
    as its other collectives."""
    global _LAYOUT
    world = world_size()
    spec = parse_mesh(spec) or MeshSpec(data=world)
    if _LAYOUT is not None and _LAYOUT.spec == spec:
        return spec
    if spec.size != world:
        raise ValueError(f"mesh {spec} needs {spec.size} ranks, the process "
                         f"group holds {world}")
    me = rank()
    m = me % spec.model
    s = me // spec.model % spec.spatial
    d = me // (spec.model * spec.spatial)
    made, groups = {}, {}       # one group per distinct set of ranks
    for axis, lists in _axis_ranks(spec).items():
        for ranks in lists:
            key = tuple(ranks)
            if key in made:
                pass
            elif len(ranks) == 1:
                made[key] = None
            elif len(ranks) == world:
                made[key] = dist.group.WORLD
            else:
                made[key] = dist.new_group(ranks)
            if me in ranks:
                groups[axis] = made[key]
    if world > 1 and dist.get_backend() == "nccl":
        _connect({tuple(range(world)): dist.group.WORLD, **made})
    _LAYOUT = _Layout(spec, (d, s, m), groups)
    return spec


def _connect(made: dict) -> None:
    """Create the NCCL communicator of every group of ``made`` (``{ranks:
    group}``) now, one after another in the same order on every rank,
    each finished before the next starts.  Left to its first collective,
    a communicator would be created while those of other groups have
    kernels in flight that wait on ranks busy creating theirs."""
    one = torch.zeros(1, device=torch.cuda.current_device())
    for ranks, g in made.items():
        if g is not None and rank() in ranks:
            dist.all_reduce(one, group=g)
            torch.cuda.synchronize()


def _layout() -> _Layout:
    if _LAYOUT is None or _LAYOUT.spec.size != world_size():
        world = world_size()
        return _Layout(MeshSpec(data=world), (rank(), 0, 0),
                       {"spatial": None, "model": None,
                        "data": dist.group.WORLD if world > 1 else None,
                        "replica": dist.group.WORLD if world > 1 else None})
    return _LAYOUT


def mesh() -> MeshSpec:
    """The layout of the process group (``data`` = the world until
    :func:`set_mesh` says otherwise)."""
    return _layout().spec


def coords() -> tuple:
    """This rank's (d, s, m)."""
    return _layout().coords


def group(axis: str):
    """This rank's process group along ``axis`` (one of :data:`AXES`), or
    None when it holds this rank alone."""
    return _layout().groups[axis]


def axis_size(axis: str) -> int:
    g = group(axis)
    return 1 if g is None else dist.get_world_size(g)


def is_leader() -> bool:
    """True on the first rank of its spatial and model group: the rank
    that speaks for its data index (writes files, reports rows)."""
    _, s, m = coords()
    return s == 0 and m == 0


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
    # the tensor collectives (DDP's buckets, all_sum, the halo and channel
    # gathers) go over the mesh's groups (set_mesh): one communicator per
    # distinct set of ranks, each used in autograd's order on every rank
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
        world = mesh_width(getattr(args, "mesh", None), args.nchips,
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
        spec = parse_mesh(getattr(args, "mesh", None))
        set_mesh(spec if spec is not None and spec.size > 1 else None)
        yield str(device), rank()
    finally:
        shutdown()


def shutdown() -> None:
    global _HOST_GROUP, _LAYOUT
    if dist.is_initialized():
        dist.destroy_process_group()
    _HOST_GROUP = None
    _LAYOUT = None


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


class _AllReduceSum(torch.autograd.Function):
    """Sum over a group; the backward sums the gradients over it."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.detach().clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        g = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_sum(x: torch.Tensor, axis: Optional[str] = None) -> torch.Tensor:
    """``x`` summed over the ranks of ``axis`` (one of :data:`AXES`;
    default every rank), differentiably (:class:`_AllReduceSum`); ``x``
    itself where the group holds this rank alone."""
    if world_size() == 1:
        return x
    g = dist.group.WORLD if axis is None else group(axis)
    return x if g is None else _AllReduceSum.apply(x, g)


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
    """The arrays of one rank per data index (:func:`is_leader`: the ranks
    of a spatial and model group hold the same rows, which JAX's
    ``process_local_data`` dedups, ``mesh.py:198-219``) concatenated in
    rank order on every rank (JAX ``process_allgather`` + ``reshape(-1)``,
    reference ``cat_all_gather``)."""
    parts = gather_objects(arrays if is_leader() else None)
    return {k: np.concatenate([np.asarray(p[k]).reshape(-1) for p in parts
                               if p is not None]) for k in arrays}


def check_replicas_equal(module: torch.nn.Module) -> None:
    """Raise ``RuntimeError`` unless every rank of this rank's ``replica``
    group holds the same bytes in each of ``module``'s running statistics
    (train BatchNorm updates them from the global moments on every rank;
    DDP runs with ``broadcast_buffers=False``; the ranks of a model group
    hold different channel slices).  Every rank calls it."""
    if world_size() == 1:
        return
    digest = {}
    for name, buf in module.state_dict().items():
        if name.endswith(("running_mean", "running_var")):
            digest[name] = hashlib.sha1(
                buf.detach().cpu().contiguous().numpy().tobytes()).hexdigest()
    m = coords()[2]
    ranks = [r for r, rm in gather_objects((digest, m)) if rm == m]
    differ = sorted(k for k in digest if any(r[k] != ranks[0][k]
                                             for r in ranks))
    if differ:
        raise RuntimeError(f"running statistics differ across ranks: "
                           f"{differ[:5]}")
