"""The mesh's ``spatial`` axis: the volume's H axis cut into slabs, one per
rank of a spatial group, with explicit halo exchanges.

Counterpart of the H-sharding of ``bodyct_dram_emph_subtype_tpu/parallel/
mesh.py`` (``batch_sharding``, :8-13): there GSPMD partitions the program
and XLA inserts the halo exchanges of the convs; a ``pallas_call`` is
opaque to GSPMD, so JAX runs no kernel on such a mesh (``mesh_fast_path_ok``).
The port shards by hand, one rank per slab, so every kernel runs on its
slab:

- :func:`shard_h` / :func:`unshard_h` cut the H axis of a (B, D, H, W, ...)
  tensor into this rank's slab and gather the slabs back;
- :func:`halo_extend` extends this rank's slab by ``lo`` rows above and
  ``hi`` rows below, taken from the edge strips that every rank of the
  group contributes (a halo may span several ranks: layer4's dilation 4
  on a one-row slab); its backward sends the halo rows' gradients back to
  their owners and adds them there;
- :func:`halo_apply` runs an op (conv, pool, kernel) on the extended slab
  and crops its output to this rank's rows.  The halo above is rounded up
  to the op's stride so the output rows stay aligned; at the volume's true
  top and bottom no halo is taken and the op pads as it does unsharded.

H is sharded only where ``H % (8 * S) == 0`` (:func:`can_shard`): the
trunk's strides multiply to 8, so every scale's slabs then start on a
stride boundary.  Otherwise every rank of the group runs the whole volume
(one warning), as JAX ``shard_batch``'s ``fit`` (``mesh.py:232-252``)
replicates a dim that its mesh axis does not divide.  The condition is
stricter than JAX's ``H % S == 0``: GSPMD pads uneven slabs, the port's
slabs do not.

:func:`sharded` marks a forward (and its backward, where remat recomputes
it) as running on slabs; :func:`voxel_axis` then names the group of the
batch's voxel sums: ``replica`` on slabs, ``data`` when every spatial rank
holds the whole volume.
"""
from __future__ import annotations

import contextlib
import logging
from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from . import mesh

logger = logging.getLogger(__name__)

H_AXIS = 2                     # NDHWC
_SHARDED = False
_WARNED = set()


def size() -> int:
    """S, the spatial group's extent."""
    return mesh.axis_size("spatial")


def index() -> int:
    """s, this rank's slab."""
    return mesh.coords()[1]


def can_shard(h: int) -> bool:
    """True where an H of ``h`` rows is cut into slabs: S > 1 and
    ``h % (8 * S) == 0``; warns once per ``h`` where S > 1 and it is
    not."""
    s = size()
    if s == 1:
        return False
    if h % (8 * s) == 0:
        return True
    if h not in _WARNED:
        _WARNED.add(h)
        logger.warning("H = %d does not divide by 8 x spatial (%d): every "
                       "rank of the spatial group runs the whole volume",
                       h, 8 * s)
    return False


@contextlib.contextmanager
def sharded(on: bool = True):
    """The block runs on H slabs (``on``): :func:`active` is then true.
    A global, not a thread's: autograd's device threads recompute remat's
    checkpoints inside it."""
    global _SHARDED
    prev, _SHARDED = _SHARDED, bool(on)
    try:
        yield
    finally:
        _SHARDED = prev


def active() -> bool:
    """True inside :func:`sharded` on a spatial group of more than one."""
    return _SHARDED and size() > 1


def voxel_axis() -> str:
    """The group of the batch's voxel sums: ``replica`` on slabs, else
    ``data``."""
    return "replica" if active() else "data"


def shard_h(x: torch.Tensor, axis: int = H_AXIS) -> torch.Tensor:
    """This rank's slab of ``x`` along ``axis`` (contiguous)."""
    n = x.shape[axis] // size()
    return x.narrow(axis, index() * n, n).contiguous()


def unshard_h(x: torch.Tensor, axis: int = H_AXIS) -> torch.Tensor:
    """Every slab of the spatial group, concatenated along ``axis`` (not
    differentiable)."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(size())]
    dist.all_gather(parts, x, group=mesh.group("spatial"))
    return torch.cat(parts, dim=axis)


def h_windows(rows: int, out_rows: int, lo: int = 0) -> list:
    """``windows`` of ``ops/resize.py`` for a (B, D, H, W, ...) resize of
    this slab's ``rows`` rows, extended by ``lo`` halo rows above, to its
    ``out_rows`` output rows: the global rows of the H axis, None for D and
    W; or None outside :func:`sharded`."""
    if not active():
        return None
    n, s = size(), index()
    return [None, (s * rows - lo, s * out_rows, rows * n, out_rows * n),
            None]


def assemble_halo(x: torch.Tensor, strips: Sequence[torch.Tensor], s: int,
                  lo: int, hi: int) -> Tuple[torch.Tensor, int, int]:
    """Slab ``s`` of ``len(strips)`` slabs of ``h`` rows each (H axis 2),
    extended by up to ``lo`` rows above and ``hi`` below from the other
    slabs' edge strips: strip r holds slab r's first ``min(hi, h)`` rows,
    then its last ``min(lo, h)``.  Rows beyond the volume are not taken.
    Returns (extended slab, rows taken above, rows taken below)."""
    h = x.shape[H_AXIS]
    n_total = h * len(strips)
    th, tl = min(hi, h), min(lo, h)
    a = s * h
    above, below = [], []
    start = max(0, a - lo)
    for r in range(start // h, s):           # rows [start, a) by owner
        first = max(start, r * h) - r * h    # local row in slab r
        take = min(a, (r + 1) * h) - r * h - first
        k = th + first - (h - tl)
        above.append(strips[r].narrow(H_AXIS, k, take))
    end = min(n_total, a + h + hi)
    for r in range(s + 1, -(-end // h)):      # rows [a + h, end)
        take = min(end, (r + 1) * h) - r * h
        below.append(strips[r].narrow(H_AXIS, 0, take))
    lo_eff, hi_eff = a - start, end - a - h
    return torch.cat(above + [x] + below, dim=H_AXIS), lo_eff, hi_eff


def halo_adjoint(grad_ext: torch.Tensor, grads: Sequence[torch.Tensor],
                 s: int, h: int, lo: int, hi: int) -> torch.Tensor:
    """The adjoint of :func:`assemble_halo` for slab ``s``: its own rows of
    ``grad_ext`` plus, from every slab r, the gradients of r's halo rows
    that slab ``s`` owns.  ``grads[r]`` holds slab r's halo-row gradients
    as ``lo`` rows above then ``hi`` below, rows beyond the volume zero."""
    n = len(grads)
    a = s * h
    lo_eff = a - max(0, a - lo)
    g = grad_ext.narrow(H_AXIS, lo_eff, h).clone()
    for r in range(n):
        if r == s:
            continue
        b = r * h
        # slab r's halo above covers rows [b - lo, b), below [b + h, ...)
        for first, rows, off in ((b - lo, lo, 0), (b + h, hi, lo)):
            lo_g, hi_g = max(first, a), min(first + rows, a + h)
            if lo_g < hi_g:
                g[:, :, lo_g - a:hi_g - a] += grads[r].narrow(
                    H_AXIS, off + lo_g - first, hi_g - lo_g)
    return g


def _halo_rows(n: int, s: int, h: int, lo: int, hi: int) -> Tuple[int, int]:
    """The rows slab ``s`` of ``n`` slabs of ``h`` rows takes above and
    below for a halo of ``lo``, ``hi`` (none beyond the volume)."""
    a = s * h
    return a - max(0, a - lo), min(n * h, a + h + hi) - a - h


class _HaloExtend(torch.autograd.Function):
    """Forward: :func:`assemble_halo` from the gathered edge strips.
    Backward: the halo rows' gradients gathered and added by their owners
    (:func:`halo_adjoint`).  One ``all_gather`` (list form, which gloo
    serves on CUDA tensors) each way."""

    @staticmethod
    def forward(ctx, x, lo, hi):
        group, n, s = mesh.group("spatial"), size(), index()
        h = x.shape[H_AXIS]
        x = x.contiguous()
        strip = torch.cat([x.narrow(H_AXIS, 0, min(hi, h)),
                           x.narrow(H_AXIS, h - min(lo, h), min(lo, h))],
                          dim=H_AXIS).contiguous()
        strips = [torch.empty_like(strip) for _ in range(n)]
        dist.all_gather(strips, strip, group=group)
        ctx.meta = (group, n, s, h, lo, hi)
        return assemble_halo(x, strips, s, lo, hi)[0]

    @staticmethod
    def backward(ctx, gy):
        group, n, s, h, lo, hi = ctx.meta
        lo_eff, hi_eff = _halo_rows(n, s, h, lo, hi)
        shape = list(gy.shape)
        shape[H_AXIS] = lo + hi
        mine = gy.new_zeros(shape)
        if lo_eff:
            mine[:, :, lo - lo_eff:lo] = gy.narrow(H_AXIS, 0, lo_eff)
        if hi_eff:
            mine[:, :, lo:lo + hi_eff] = gy.narrow(H_AXIS, lo_eff + h, hi_eff)
        grads = [torch.empty_like(mine) for _ in range(n)]
        dist.all_gather(grads, mine, group=group)
        return halo_adjoint(gy, grads, s, h, lo, hi), None, None


def halo_extend(x: torch.Tensor, lo: int, hi: int
                ) -> Tuple[torch.Tensor, int, int]:
    """This rank's NDHWC slab ``x`` extended by up to ``lo`` rows above and
    ``hi`` below from the other slabs of the spatial group (none beyond
    the volume's edges), differentiably.  Returns (extended slab, rows
    taken above, rows taken below)."""
    lo_eff, hi_eff = _halo_rows(size(), index(), x.shape[H_AXIS], lo, hi)
    return _HaloExtend.apply(x, int(lo), int(hi)), lo_eff, hi_eff


def _pad_rows(t: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    shape = list(t.shape)
    parts = []
    for n in (lo, hi):
        shape[H_AXIS] = n
        parts.append(t.new_zeros(shape))
    return torch.cat([parts[0], t, parts[1]], dim=H_AXIS).contiguous()


def halo_bounds(kernel: int, stride: int = 1, dilation: int = 1,
                pad: int = 0) -> Tuple[int, int]:
    """(rows above, rows below) that an op of H ``kernel``, ``stride``,
    ``dilation`` and padding ``pad`` reads beyond a slab whose first row
    is a multiple of ``stride``: ``pad`` rounded up to ``stride`` above
    (so its output rows stay aligned), ``dilation * (kernel - 1) - pad -
    stride + 1`` below."""
    return (-(-pad // stride) * stride,
            max(0, dilation * (kernel - 1) - pad - stride + 1))


def halo_apply(op: Callable[..., torch.Tensor], x: torch.Tensor, kernel: int,
               stride: int = 1, dilation: int = 1, pad: int = 0,
               extras: Sequence[torch.Tensor] = ()) -> torch.Tensor:
    """``op(x, *extras)`` for an op of H ``kernel``, ``stride``,
    ``dilation`` and padding ``pad`` on this rank's slab: outside
    :func:`sharded` (or on one slab) the call itself; on slabs ``op`` runs
    on ``x`` extended by its halo (``pad`` rows above, rounded up to
    ``stride``; ``dilation * (kernel - 1) - pad - stride + 1`` below) and
    its output is cropped to this slab's ``x.shape[2] // stride`` rows.
    ``extras`` (e.g. a residual of the output's shape) are padded with zero
    rows to the extended shape; the rows they pad are cropped."""
    if not active():
        return op(x, *extras)
    lo, hi = halo_bounds(kernel, stride, dilation, pad)
    if lo == 0 and hi == 0:
        return op(x, *extras)
    xe, lo_eff, hi_eff = halo_extend(x, lo, hi)
    extras = [_pad_rows(e, lo_eff, hi_eff) for e in extras]
    y = op(xe, *extras)
    return y.narrow(H_AXIS, lo_eff // stride,
                    x.shape[H_AXIS] // stride).contiguous()


def forward_slabs(model: torch.nn.Module, x: torch.Tensor,
                  lungs: Optional[torch.Tensor],
                  mark: Optional[Callable[[str], None]] = None):
    """An eval forward of ``model`` on (B, D, H, W, 1) ``x`` and ``lungs``
    (at any resolution): on H slabs where :func:`can_shard` holds, with the
    dense outputs gathered back to the whole volume on every rank of the
    spatial group.  Returns the model's (dense outputs, heads).  ``mark``
    goes to the Seg model's forward, which calls ``mark("decoder")``, if
    given, between its trunk and its decoder."""
    if not can_shard(x.shape[H_AXIS]):
        return model(x, lungs, mark=mark)
    with sharded():
        dense, heads = model(shard_h(x),
                             None if lungs is None else shard_h(lungs),
                             mark=mark)
    return [unshard_h(d) for d in dense], heads
