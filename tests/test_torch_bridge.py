"""Weights across the two packages, and the port's isolation from JAX."""
import functools
import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bodyct_dram_emph_subtype_tpu.models import get_model_by_name as jax_model
from bodyct_dram_emph_subtype_tpu.models.torch_import import \
    convert_state_dict
from bodyct_dram_emph_subtype_tpu_torch.models.registry import \
    get_model_by_name
from bodyct_dram_emph_subtype_tpu_torch.models.torch_import import (
    flax_path_to_torch_key, load_reference_checkpoint, state_dict_from_jax,
    torch_key_to_flax_path)

REPO = Path(__file__).resolve().parents[1]


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (k,)))
        return out
    return {prefix: np.asarray(tree)}


def test_jax_port_jax_round_trip_is_exact():
    """JAX init -> state_dict_from_jax -> port load_state_dict(strict) ->
    the JAX package's convert_state_dict: nothing missing, mismatched or
    unexpected, every value equal."""
    model = jax_model("med3ddramtiny")
    x = jnp.zeros((1, 16, 16, 16, 1), jnp.float32)
    init = jax.jit(functools.partial(model.init, train=False))
    variables = jax.tree.map(np.asarray,
                             dict(init(jax.random.PRNGKey(3), x, x)))
    port = get_model_by_name("med3ddramtiny")
    port.load_state_dict(state_dict_from_jax(variables), strict=True)
    back, report = convert_state_dict(
        {k: v.numpy() for k, v in port.state_dict().items()}, variables)
    assert report["missing"] == report["shape_mismatch"] \
        == report["unexpected"] == 0
    assert report["loaded"] == len(_flat(variables["params"])) \
        + len(_flat(variables["batch_stats"]))
    want = _flat(variables)
    got = _flat(jax.tree.map(np.asarray, back))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=str(k))


@pytest.mark.parametrize("name", ["med3ddram", "med3ddram18", "med3ddram50",
                                  "med3ddramtiny"])
def test_every_port_key_maps_both_ways(name):
    """Every parameter and BN statistic of every dRAM arch has a JAX path
    that maps back to the same reference key."""
    keys = [k for k in get_model_by_name(name).state_dict()
            if not k.endswith("num_batches_tracked")]
    assert keys
    for k in keys:
        coll, path = torch_key_to_flax_path(k)
        assert flax_path_to_torch_key(coll, path) == k


def test_reference_checkpoint_loads_greedily(tmp_path):
    src = get_model_by_name("med3ddramtiny",
                            generator=torch.Generator().manual_seed(7))
    sd = {f"model.{k}": v for k, v in src.state_dict().items()}
    sd["model.extra.weight"] = torch.zeros(1)
    sd["model.fcs.0.bias"] = torch.zeros(2)            # wrong shape
    path = tmp_path / "best.ckpt"
    torch.save({"state_dict": sd, "epoch": 3}, path)
    dst = get_model_by_name("med3ddramtiny")
    report = load_reference_checkpoint(dst, str(path))
    assert report["unexpected"] == 1 and report["shape_mismatch"] == 1
    assert report["missing"] == 1
    torch.testing.assert_close(dst.conv1.weight, src.conv1.weight)
    torch.testing.assert_close(dst.fcs[0].weight, src.fcs[0].weight)


def test_port_imports_no_jax_and_cpu_calls_stay_plain():
    """In a fresh interpreter: importing every port module pulls in neither
    jax nor the JAX package, and a kernel wrapper on a CPU tensor runs its
    plain version without building or launching anything."""
    code = r"""
import importlib, json, pkgutil, sys
import torch
import bodyct_dram_emph_subtype_tpu_torch as pkg
mods = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for m in mods:
    importlib.import_module(m)
from bodyct_dram_emph_subtype_tpu_torch.ops import cuda_build
from bodyct_dram_emph_subtype_tpu_torch.ops.roll_conv import (
    roll_conv_affine_relu, roll_conv_affine_relu_plain)
g = torch.Generator().manual_seed(0)
x = torch.randn(1, 3, 4, 5, 6, generator=g)
k = torch.randn(3, 3, 3, 6, 7, generator=g)
s, t = torch.ones(7), torch.zeros(7)
same = torch.equal(roll_conv_affine_relu(x, k, s, t),
                   roll_conv_affine_relu_plain(x, k, s, t))
print(json.dumps({"mods": mods,
                  "jax": sorted(n for n in sys.modules
                                if n == "jax" or n.startswith("jax.")),
                  "ref": sorted(n for n in sys.modules
                                if n.startswith("bodyct_dram_emph_subtype_tpu.")
                                or n == "bodyct_dram_emph_subtype_tpu"),
                  "same": same, "launches": sum(cuda_build.launches().values()),
                  "built": cuda_build.build_info() is not None}))
"""
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert len(out["mods"]) >= 20
    # the classification, device-pipeline, data-parallel, tools,
    # transform-framework and mesh-axes slices' modules are among them
    port = "bodyct_dram_emph_subtype_tpu_torch."
    assert {port + m for m in ("evaluate", "evaluate.__main__",
                               "models.resnet3d", "models.registry",
                               "data.datasets", "train.steps",
                               "train.loop", "ops.packing", "ops.preprocess",
                               "data.loader", "data.host_preprocess",
                               "inference.processor", "inference.__main__",
                               "parallel", "parallel.mesh",
                               "parallel.spatial", "parallel.tensor",
                               "utils.viz",
                               "ops.resize", "tools", "tools.build_cache",
                               "tools.convert_checkpoint",
                               "tools.compute_label_statistics",
                               "tools.compute_computation_complexity",
                               "transforms", "transforms.base",
                               "transforms.intensity", "transforms.spatial",
                               "ops.morphology", "ops.intensity",
                               "ops.grid_sample")
            } <= set(out["mods"])
    assert out["jax"] == [] and out["ref"] == []
    assert out["same"] and out["launches"] == 0 and not out["built"]


def test_kernel_wrapper_refuses_other_devices():
    from bodyct_dram_emph_subtype_tpu_torch.ops.maxpool_kernel import \
        max_pool_k3s2p1
    with pytest.raises(RuntimeError, match="device"):
        max_pool_k3s2p1(torch.zeros(1, 4, 4, 4, 2, device="meta"))
