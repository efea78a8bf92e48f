"""Weights across: reference checkpoints and the JAX package's variables.

The port's module names ARE the reference state-dict keys (``conv1``,
``bn1``, ``layerN.i.convK/bnK``, ``usX.conv_blocks.i.0/1``, ``us3.0/1``,
``fcs.i``), so a reference ``best.ckpt`` loads with ``load_state_dict``
once the Lightning ``model.`` prefix is stripped
(:func:`load_reference_checkpoint`, greedy like the reference's
``load_state_dict_greedy``, ``utils.py:226-249``).

:func:`state_dict_from_jax` goes the other way from the JAX package's
variable tree: it inverts ``torch_key_to_flax_path`` — the mapping of
``bodyct_dram_emph_subtype_tpu/models/torch_import.py:33-94``, copied here
because that package imports jax — and transposes DHWIO kernels to OIDHW.
It takes numpy (or any array-like) leaves and never imports jax.
:func:`optimizer_state_from_jax` carries the JAX package's Adam state
(optax ``ScaleByAdamState``) onto ``torch.optim.Adam`` under the same key
mapping.
"""
from __future__ import annotations

import logging
import re
from pathlib import Path
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

logger = logging.getLogger(__name__)

_BN_ATTR = {"weight": ("params", "scale"), "bias": ("params", "bias"),
            "running_mean": ("batch_stats", "mean"),
            "running_var": ("batch_stats", "var")}
_BN_LEAF = {v: k for k, v in _BN_ATTR.items()}
_CONV_LEAF = {"weight": "kernel", "bias": "bias"}
_CONV_ATTR = {v: k for k, v in _CONV_LEAF.items()}


def torch_key_to_flax_path(key: str) -> Optional[Tuple[str, Tuple[str, ...]]]:
    """Reference state-dict key -> (collection, flax path), or None for
    keys without a flax counterpart (``num_batches_tracked``)."""
    key = key.removeprefix("model.")
    if key.endswith("num_batches_tracked"):
        return None
    parts = key.split(".")

    def bn_leaf(attr, *prefix):
        coll, leaf = _BN_ATTR[attr]
        return coll, (*prefix, "bn", leaf)

    if parts[0] == "conv1":
        return "params", ("trunk", "conv1", _CONV_LEAF[parts[1]])
    if parts[0] == "bn1":
        return bn_leaf(parts[1], "trunk", "bn1")
    m = re.fullmatch(r"layer(\d)", parts[0])
    if m:
        block = f"layer{m.group(1)}_{parts[1]}"
        sub = parts[2]
        if sub.startswith("conv"):
            return "params", ("trunk", block, sub, _CONV_LEAF[parts[3]])
        if sub.startswith("bn"):
            return bn_leaf(parts[3], "trunk", block, sub)
        if sub == "downsample":
            if parts[3] == "0":
                return "params", ("trunk", block, "downsample", "conv",
                                  _CONV_LEAF[parts[4]])
            if parts[3] == "1":
                return bn_leaf(parts[4], "trunk", block, "downsample", "norm")
            return None
    m = re.fullmatch(r"us([12])", parts[0])
    if m:
        if len(parts) >= 5 and parts[1] == "conv_blocks":
            idx, j = parts[2], parts[3]
            if j == "0":
                return "params", ("decoder", f"us{m.group(1)}", f"conv{idx}",
                                  _CONV_LEAF[parts[4]])
            if j == "1":
                return bn_leaf(parts[4], "decoder", f"us{m.group(1)}",
                               f"norm{idx}")
        return None
    if parts[0] == "us3":
        if parts[1] == "0":
            return "params", ("decoder", "us3_conv", _CONV_LEAF[parts[2]])
        if parts[1] == "1":
            return bn_leaf(parts[2], "decoder", "us3_bn")
    if parts[0] == "fcs":
        return "params", (f"fc{parts[1]}", _CONV_LEAF[parts[2]])
    if parts[0] == "fc":
        return "params", ("fc", _CONV_LEAF[parts[1]])
    return None


def flax_path_to_torch_key(coll: str, path: Tuple[str, ...]) -> str:
    """Inverse of :func:`torch_key_to_flax_path`."""
    if path[-2] == "bn":                       # BatchNorm leaf
        prefix, attr = path[:-2], _BN_LEAF[(coll, path[-1])]
        if prefix[-2:] == ("downsample", "norm"):
            prefix = prefix[:-2] + ("downsample", "1")
    else:                                      # conv leaf
        prefix, attr = path[:-1], _CONV_ATTR[path[-1]]
        if prefix[-2:] == ("downsample", "conv"):
            prefix = prefix[:-2] + ("downsample", "0")
    if prefix[0] == "trunk":
        prefix = prefix[1:]
        m = re.fullmatch(r"(layer\d)_(\d+)", prefix[0])
        if m:
            prefix = (m.group(1), m.group(2)) + prefix[1:]
    elif prefix[0] == "decoder":
        prefix = prefix[1:]
        m = re.fullmatch(r"(conv|norm)(\d+)", prefix[-1])
        if prefix[0] in ("us1", "us2") and m:
            j = "0" if m.group(1) == "conv" else "1"
            prefix = (prefix[0], "conv_blocks", m.group(2), j)
        elif prefix == ("us3_conv",):
            prefix = ("us3", "0")
        elif prefix == ("us3_bn",):
            prefix = ("us3", "1")
    else:
        m = re.fullmatch(r"fc(\d+)", prefix[0])
        if m:
            prefix = ("fcs", m.group(1))
    key = ".".join(prefix + (attr,))
    if torch_key_to_flax_path(key) != (coll, tuple(path)):
        raise KeyError(f"no reference key for {coll}/{'/'.join(path)}")
    return key


def _flatten(tree, prefix=()) -> Dict[Tuple[str, ...], Any]:
    out = {}
    if isinstance(tree, Mapping):
        for k, v in tree.items():
            out.update(_flatten(v, prefix + (k,)))
    else:
        out[prefix] = tree
    return out


def state_dict_from_jax(variables: Mapping[str, Any]
                        ) -> Dict[str, torch.Tensor]:
    """JAX ``{'params', 'batch_stats'}`` variables (numpy leaves) -> a
    reference-keyed state dict for the port's models (conv kernels DHWIO
    -> OIDHW; every BatchNorm gets ``num_batches_tracked = 0``)."""
    out: Dict[str, torch.Tensor] = {}
    for coll in ("params", "batch_stats"):
        for path, leaf in _flatten(variables.get(coll, {})).items():
            key = flax_path_to_torch_key(coll, path)
            arr = np.asarray(leaf, dtype=np.float32)
            if arr.ndim == 5:
                arr = arr.transpose(4, 3, 0, 1, 2)
            out[key] = torch.tensor(arr)
            if coll == "batch_stats" and key.endswith(".running_mean"):
                out[key.removesuffix("running_mean") + "num_batches_tracked"] \
                    = torch.tensor(0, dtype=torch.long)
    return out


WEIGHT_FILES = (".ckpt", ".pth", ".pt", ".npz")


def read_torch_state_dict(path) -> Mapping[str, Any]:
    """The state dict of a torch weights file: a reference ``.ckpt``/
    ``.pth`` (its Lightning ``state_dict`` entry) or the port trainer's
    ``epoch_<n>.pt`` (its ``model`` entry, ``train/checkpoint.py``).  The
    file is a pickle written by the reference trainer (``torch.load`` with
    ``weights_only=False``, as the reference itself loads it): load only
    checkpoints from a trusted source."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(ckpt, dict) and "state_dict" in ckpt:
        ckpt = ckpt["state_dict"]
    elif isinstance(ckpt, dict) and isinstance(ckpt.get("model"), Mapping):
        ckpt = ckpt["model"]        # the port trainer's ``epoch_<n>.pt``
    return ckpt


def load_reference_checkpoint(model: torch.nn.Module, path: str
                              ) -> Dict[str, int]:
    """Greedily load a reference ``.ckpt``/``.pth`` (or the port trainer's
    ``.pt``, :func:`read_torch_state_dict`) into ``model``: ``model.``
    prefixes stripped, unknown and shape-mismatched entries skipped with a
    warning, missing ones reported."""
    return load_state_dict_greedy(model, read_torch_state_dict(path))


def load_weights_file(model: torch.nn.Module, path) -> Dict[str, int]:
    """Greedily load a weights file into ``model`` by its suffix (JAX
    ``train/checkpoint.py::greedy_restore_variables``): ``.ckpt``/
    ``.pth``/``.pt`` through :func:`load_reference_checkpoint`, ``.npz``
    (flat arrays under the reference's keys) through
    :func:`load_state_dict_greedy`; any other suffix raises
    ``ValueError``."""
    suffix = Path(path).suffix
    if suffix == ".npz":
        with np.load(path) as z:
            return load_state_dict_greedy(model, {k: z[k] for k in z.files})
    if suffix in WEIGHT_FILES:
        return load_reference_checkpoint(model, str(path))
    raise ValueError(f"unsupported weights file: {path} (expected one of "
                     f"{', '.join(WEIGHT_FILES)})")


def load_state_dict_greedy(model: torch.nn.Module,
                           ckpt: Mapping[str, Any]) -> Dict[str, int]:
    """Load the entries of ``ckpt`` whose key (``model.`` prefix stripped)
    and shape match ``model``; skip the rest with a warning and report the
    counts."""
    own = model.state_dict()
    keep = {}
    report = {"loaded": 0, "shape_mismatch": 0, "unexpected": 0,
              "missing": 0}
    for key, value in ckpt.items():
        key = key.removeprefix("model.")
        if key not in own:
            logger.warning("[torch_import] unexpected entry: %s", key)
            report["unexpected"] += 1
        elif tuple(np.shape(value)) != tuple(own[key].shape):
            logger.warning("[torch_import] shape mismatch: %s %s vs %s",
                           key, tuple(value.shape), tuple(own[key].shape))
            report["shape_mismatch"] += 1
        else:
            keep[key] = torch.as_tensor(np.asarray(value)) \
                if not isinstance(value, torch.Tensor) else value
            report["loaded"] += 1
    for key in own:
        if key not in keep and not key.endswith("num_batches_tracked"):
            logger.warning("[torch_import] missing entry: %s", key)
            report["missing"] += 1
    model.load_state_dict(keep, strict=False)
    return report


def optimizer_state_from_jax(opt_state: Any, model: torch.nn.Module
                             ) -> Dict[int, Dict[str, torch.Tensor]]:
    """optax ``ScaleByAdamState`` (``count``, ``mu``, ``nu``; or a tuple
    holding one) -> the ``"state"`` entry of a ``torch.optim.Adam``
    state dict for an optimizer built over ``model.parameters()``: per
    parameter index ``step`` (the count), ``exp_avg`` (mu) and
    ``exp_avg_sq`` (nu), conv moments DHWIO -> OIDHW.  Load it with
    ``opt.load_state_dict({"state": ..., "param_groups":
    opt.state_dict()["param_groups"]})``."""
    if not hasattr(opt_state, "mu"):
        found = [s for s in opt_state if hasattr(s, "mu")]
        if len(found) != 1:
            raise ValueError("no single ScaleByAdamState in the opt state")
        opt_state = found[0]
    step = float(np.asarray(opt_state.count))
    moments = {}
    for name, tree in (("exp_avg", opt_state.mu),
                       ("exp_avg_sq", opt_state.nu)):
        for path, leaf in _flatten(tree).items():
            arr = np.asarray(leaf, dtype=np.float32)
            if arr.ndim == 5:
                arr = arr.transpose(4, 3, 0, 1, 2)
            key = flax_path_to_torch_key("params", path)
            moments.setdefault(key, {})[name] = torch.tensor(arr)
    state = {}
    for i, (key, p) in enumerate(model.named_parameters()):
        if key not in moments:
            raise KeyError(f"no Adam moments for parameter {key}")
        m = moments[key]
        if tuple(m["exp_avg"].shape) != tuple(p.shape):
            raise ValueError(f"{key}: moments {tuple(m['exp_avg'].shape)} "
                             f"vs parameter {tuple(p.shape)}")
        state[i] = {"step": torch.tensor(step), **m}
    return state
