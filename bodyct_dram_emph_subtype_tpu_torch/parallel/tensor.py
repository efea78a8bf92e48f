"""The mesh's ``model`` axis: tensor parallelism over the conv output
channels.

Counterpart of ``bodyct_dram_emph_subtype_tpu/parallel/mesh.py::
shard_params_tp`` (:159-176): JAX places every leaf whose last dim (a
conv's O, a BatchNorm or bias channel) divides by M and is at least M
sharded along it over 'model', everything else replicated, and GSPMD
inserts the activation collectives.  The port slices explicitly, one
slice per rank of a model group:

- :func:`shard_model` cuts, in place, every such conv's weight and bias
  and every such BatchNorm's weight, bias and running statistics to this
  rank's O-slice (dim 0 of the torch layout); the other leaves (the 1x1x1
  heads of one output, a head of 3 classes at M = 2) stay whole;
- the forward (``models/blocks.py``, ``models/resnet3d.py``,
  ``ops/layer1_kernel.py``) runs each sliced conv on the whole input and
  its epilogue (BatchNorm, ReLU, a residual slice) on the slice, then
  :func:`gather_channels` gathers the slices back (an ``all_gather``
  over the model group);
- :func:`gather_channels`' backward sums the incoming gradient over the
  model group, then keeps this rank's slice: each rank's gradient of the
  gathered tensor is partial, from its own O-slice of the next conv.
  Where the gathered tensor feeds a computation that every model rank
  repeats whole (the replicated heads, the losses), :func:`replicated`
  divides the gradient entering it by M, so the sum over the group counts
  it once; the replicated leaves' own gradients are whole on every rank;
- a sliced model loads the full state dict under the reference's keys
  (a load hook slices it) and :func:`full_state_dict` /
  :func:`full_optimizer_state` gather it back, so checkpoints stay those
  of one process.
"""
from __future__ import annotations

from typing import Dict, Iterable, Tuple

import torch
import torch.distributed as dist
import torch.nn as nn

from . import mesh

_BN_LEAVES = ("weight", "bias", "running_mean", "running_var")


def size() -> int:
    """M, the model group's extent."""
    return mesh.axis_size("model")


def index() -> int:
    """m, this rank's channel slice."""
    return mesh.coords()[2]


def sliced(module: nn.Module) -> bool:
    """True for a conv or BatchNorm that :func:`shard_model` cut."""
    return getattr(module, "tp_slice", None) is not None


def _divides(n: int, m: int) -> bool:
    return m > 1 and n % m == 0 and n >= m


def _slice_rows(t: torch.Tensor, m: int, n: int) -> torch.Tensor:
    k = t.shape[0] // n
    return t.detach()[m * k:(m + 1) * k].clone()


def _slice_on_load(model, state_dict, prefix, *args):
    """Load hook of a sliced model: full-size entries of its sliced leaves
    are cut to this rank's slice (entries already sliced pass)."""
    n, m = model.tp_slice
    for key, full in model.tp_full_shapes.items():
        key = prefix + key
        value = state_dict.get(key)
        if value is not None and tuple(value.shape) == full:
            state_dict[key] = _slice_rows(torch.as_tensor(value), m, n)


def shard_model(model: nn.Module) -> nn.Module:
    """Cut ``model``'s convs and BatchNorms whose channels divide by M to
    this rank's O-slice, in place (before the optimizer and DDP take its
    parameters); ``model`` itself where M is 1.  Records the full shapes
    of the cut state-dict entries (``model.tp_full_shapes``)."""
    n, m = size(), index()
    if n == 1 or sliced(model):
        return model
    full = {}
    for name, mod in model.named_modules():
        if isinstance(mod, nn.Conv3d) and _divides(mod.out_channels, n):
            leaves = ("weight", "bias")
        elif isinstance(mod, nn.BatchNorm3d) and _divides(mod.num_features,
                                                          n):
            leaves = _BN_LEAVES
        else:
            continue
        for leaf in leaves:
            t = getattr(mod, leaf)
            if t is None:
                continue
            full[f"{name}.{leaf}"] = tuple(t.shape)
            part = _slice_rows(t, m, n)
            if isinstance(t, nn.Parameter):
                setattr(mod, leaf, nn.Parameter(
                    part, requires_grad=t.requires_grad))
            else:
                mod.register_buffer(leaf, part)
        mod.tp_slice = (n, m)
    model.tp_slice = (n, m)
    model.tp_full_shapes = full
    model._register_load_state_dict_pre_hook(
        lambda *a: _slice_on_load(model, *a))
    return model


def gather_rows(t: torch.Tensor, group, n: int) -> torch.Tensor:
    """The model group's slices of ``t`` (dim 0), concatenated in rank
    order (not differentiable)."""
    t = t.detach().contiguous()
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts, dim=0)


def full_tensors(model: nn.Module, tensors: Dict[str, torch.Tensor]
                 ) -> Dict[str, torch.Tensor]:
    """``tensors`` under ``model``'s state-dict keys (its state, its
    gradients) with the sliced entries gathered to their full size (a
    collective of the model group: every rank calls it)."""
    if not sliced(model):
        return tensors
    group, n = mesh.group("model"), size()
    return {k: gather_rows(v, group, n) if k in model.tp_full_shapes
            else v for k, v in tensors.items()}


def full_state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    """``model.state_dict()`` with the sliced entries gathered to their
    full size (:func:`full_tensors`)."""
    return full_tensors(model, model.state_dict())


def _param_keys(model: nn.Module) -> Iterable[Tuple[int, str]]:
    """(optimizer state index, state-dict key) of an optimizer built over
    ``model.parameters()``."""
    return enumerate(k for k, _ in model.named_parameters())


def full_optimizer_state(model: nn.Module,
                         optimizer: torch.optim.Optimizer) -> Dict:
    """``optimizer.state_dict()`` with the moments of sliced parameters
    gathered to full size (a collective of the model group)."""
    state = optimizer.state_dict()
    if not sliced(model):
        return state
    group, n = mesh.group("model"), size()
    out = {}
    for i, key in _param_keys(model):
        if i not in state["state"]:
            continue
        out[i] = {k: gather_rows(v, group, n)
                  if key in model.tp_full_shapes and v.ndim else v
                  for k, v in state["state"][i].items()}
    return {"state": out, "param_groups": state["param_groups"]}


def shard_optimizer_state(model: nn.Module, state: Dict) -> Dict:
    """A full optimizer state dict (:func:`full_optimizer_state`, or one
    process's) cut to this rank's slices."""
    if not sliced(model):
        return state
    n, m = model.tp_slice
    out = {}
    for i, key in _param_keys(model):
        if i not in state["state"]:
            continue
        full = model.tp_full_shapes.get(key)
        out[i] = {k: _slice_rows(v, m, n)
                  if full is not None and tuple(v.shape) == full else v
                  for k, v in state["state"][i].items()}
    return {"state": out, "param_groups": state["param_groups"]}


class _GatherChannels(torch.autograd.Function):
    """Forward: the slices of the model group concatenated on the last
    dim.  Backward: the gradient summed over the group, then this rank's
    slice."""

    @staticmethod
    def forward(ctx, x, group, n, m):
        ctx.meta = (group, m, x.shape[-1])
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts, dim=-1)

    @staticmethod
    def backward(ctx, g):
        group, m, k = ctx.meta
        g = g.contiguous().clone()
        dist.all_reduce(g, group=group)
        return g[..., m * k:(m + 1) * k].contiguous(), None, None, None


def gather_channels(x: torch.Tensor) -> torch.Tensor:
    """The model group's channel slices of ``x`` (last dim), concatenated
    in rank order, differentiably; ``x`` where M is 1."""
    n = size()
    if n == 1:
        return x
    return _GatherChannels.apply(x, mesh.group("model"), n, index())


def gather_if(y: torch.Tensor, module: nn.Module) -> torch.Tensor:
    """``y``, the output of ``module``'s O-slice, gathered where the
    module is sliced."""
    return gather_channels(y) if sliced(module) else y


def channel_slice(x: torch.Tensor) -> torch.Tensor:
    """This rank's slice of the last dim of ``x`` (``x`` where M is 1)."""
    n = size()
    if n == 1:
        return x
    k = x.shape[-1] // n
    m = index()
    return x[..., m * k:(m + 1) * k]


class _Replicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, n):
        ctx.n = n
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None


def replicated(x: torch.Tensor) -> torch.Tensor:
    """``x`` entering a computation that every rank of the model group
    repeats whole: identity forward, gradient divided by M (see the module
    docstring); ``x`` where M is 1."""
    n = size()
    return x if n == 1 else _Replicated.apply(x, n)
