"""The port's tools (``bodyct_dram_emph_subtype_tpu_torch/tools/``) against
the root ``tools/`` of the JAX package, on the cases of
``tests/test_tools.py``, and the CUDA image's files.

- ``compute_label_statistics``: the same JSON lines;
- ``build_cache``: every ``.npz`` array bit-equal with the same dtype, the
  same ``merged.csv``, and the archive reads back through the port's
  ``COPDGeneSubtyping``; ``--torch_cache``: the same arrays;
- ``convert_checkpoint --to_npz``: the same keys and arrays;
  ``--to_port``: a checkpoint directory that the processor's
  ``build_model`` restores with no entry missing;
- ``compute_computation_complexity``: ``params_M`` of the six default
  archs equal to the JAX models' (``jax.eval_shape``), the external
  baseline table equal to the JAX tool's, and the FLOPs of
  ``med3ddramtiny`` at (16, 32, 32) equal to an analytic count;
- ``Dockerfile.cuda`` and ``install_files/requirements_torch.txt``.
"""
import json
import math
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from bodyct_dram_emph_subtype_tpu_torch.data.datasets import \
    COPDGeneSubtyping
from bodyct_dram_emph_subtype_tpu_torch.data.mha import write_mha

REPO = Path(__file__).resolve().parents[1]
HEADER = ("SeriesInstanceUID,CT_Visual_Emph_Severity_P1,"
          "CT_Visual_Emph_Paraseptal_P1")


def _jax_tool(name, *args):
    """Run the root ``tools/<name>.py`` of the JAX package."""
    return subprocess.run([sys.executable, str(REPO / "tools" / f"{name}.py"),
                           *map(str, args)], capture_output=True, text=True,
                          check=True, cwd=REPO).stdout


def _npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _assert_same_arrays(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].shape == want[k].shape, k
        assert np.array_equal(got[k], want[k]), k


def test_label_statistics_equal_jax_tool(tmp_path, capsys):
    from bodyct_dram_emph_subtype_tpu_torch.tools.compute_label_statistics \
        import main
    csvs = []
    for name, rows in (("a", "a,0,0\nb,5,2\nc,5,1\n"),
                       ("b", "d,3.0,1\ne,3,0\n")):
        csvs.append(tmp_path / f"{name}.csv")
        csvs[-1].write_text(f"{HEADER}\n{rows}")
    arg = ",".join(map(str, csvs))
    want = [json.loads(line) for line in
            _jax_tool("compute_label_statistics", "--csvs",
                      arg).splitlines()]
    main(["--csvs", arg])
    got = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert got == want and len(got) == 2


def _write_mha_pairs(root: Path):
    """``tests/test_tools.py``'s scan ``u1`` and an unlabelled ``u2``."""
    scans, lobes = root / "ct", root / "lobes"
    scans.mkdir()
    lobes.mkdir()
    rng = np.random.RandomState(0)
    for uid, shape in (("u1", (24, 30, 36)), ("u2", (20, 28, 32))):
        lobe = np.zeros(shape, np.uint8)
        lobe[4:shape[0] - 4, 6:shape[1] - 6, 8:shape[2] - 6] = 1
        ct = np.full(shape, -600, np.int16)
        ct[lobe > 0] = (-880 + 60 * rng.randn((lobe > 0).sum())
                        ).astype(np.int16)
        write_mha(scans / f"{uid}.mha", ct, (0.7, 0.7, 2.0))
        write_mha(lobes / f"{uid}.mha", lobe, (0.7, 0.7, 2.0))
    labels = root / "labels.csv"
    labels.write_text(f"{HEADER}\nu1,3,1\n")
    return scans, lobes, labels


def test_build_cache_equals_jax_tool(tmp_path):
    from bodyct_dram_emph_subtype_tpu_torch.tools.build_cache import main
    scans, lobes, labels = _write_mha_pairs(tmp_path)
    _jax_tool("build_cache", "--scan_path", scans, "--lobe_path", lobes,
              "--labels_csv", labels, "--output_path", tmp_path / "jax")
    out = tmp_path / "port"
    main(["--scan_path", str(scans), "--lobe_path", str(lobes),
          "--labels_csv", str(labels), "--output_path", str(out)])
    assert sorted(p.name for p in out.iterdir()) == ["merged.csv", "u1.npz"]
    _assert_same_arrays(_npz(out / "u1.npz"), _npz(tmp_path / "jax" /
                                                   "u1.npz"))
    assert (out / "merged.csv").read_text() == \
        (tmp_path / "jax" / "merged.csv").read_text()
    ds = COPDGeneSubtyping(str(out), COPDGeneSubtyping.get_series_uids(
        str(out / "merged.csv")))
    item = ds[0]
    assert item["image"].dtype == np.int16
    assert int(item["cls_label"]) == 3 and int(item["pse_label"]) == 1
    assert item["em_mask"].shape == item["image"].shape


def test_build_cache_torch_cache_equals_jax_tool(tmp_path):
    from bodyct_dram_emph_subtype_tpu_torch.tools.build_cache import main
    src = tmp_path / "pth"
    src.mkdir()
    rng = np.random.RandomState(1)
    for i, uid in enumerate(("s0", "s1")):
        ct = rng.randint(-1100, -300, (6, 8, 10)).astype(np.int16)
        torch.save({"image": torch.from_numpy(ct),
                    "lung_mask": torch.from_numpy(ct < -700),
                    "cls_label": i + 2, "pse_label": i}, src / f"{uid}.pth")
    (src / "merged.csv").write_text(f"{HEADER}\ns0,2,0\ns1,3,1\n")
    _jax_tool("build_cache", "--torch_cache", src, "--output_path",
              tmp_path / "jax")
    out = tmp_path / "port"
    main(["--torch_cache", str(src), "--output_path", str(out)])
    for uid in ("s0", "s1"):
        _assert_same_arrays(_npz(out / f"{uid}.npz"),
                            _npz(tmp_path / "jax" / f"{uid}.npz"))
    assert (out / "merged.csv").read_text() == \
        (src / "merged.csv").read_text()


def _reference_ckpt(path: Path, seed: int = 5):
    """A Lightning-style checkpoint of a ``med3ddramtiny``: its state dict
    under ``model.`` keys in a ``state_dict`` envelope."""
    from bodyct_dram_emph_subtype_tpu_torch.models.registry import \
        get_model_by_name
    model = get_model_by_name("med3ddramtiny",
                              generator=torch.Generator().manual_seed(seed))
    torch.save({"epoch": 7, "state_dict": {
        f"model.{k}": v for k, v in model.state_dict().items()}}, path)
    return model


def test_convert_checkpoint_to_npz_equals_jax_tool(tmp_path):
    from bodyct_dram_emph_subtype_tpu_torch.tools.convert_checkpoint import \
        main
    src = tmp_path / "best.ckpt"
    _reference_ckpt(src)
    _jax_tool("convert_checkpoint", "--src", src, "--to_npz",
              tmp_path / "jax.npz")
    main(["--src", str(src), "--to_npz", str(tmp_path / "port.npz")])
    got, want = _npz(tmp_path / "port.npz"), _npz(tmp_path / "jax.npz")
    assert all(k.startswith("model.") for k in want)
    _assert_same_arrays(got, want)


def test_convert_checkpoint_to_port_deploys(tmp_path):
    """``--to_port``: the processor given the directory restores the
    source's weights, no entry missing (train -> deploy)."""
    from bodyct_dram_emph_subtype_tpu_torch.inference import build_model
    from bodyct_dram_emph_subtype_tpu_torch.models.registry import \
        get_model_by_name
    from bodyct_dram_emph_subtype_tpu_torch.models.torch_import import \
        load_reference_checkpoint
    from bodyct_dram_emph_subtype_tpu_torch.tools.convert_checkpoint import \
        main
    src = tmp_path / "best.ckpt"
    source = _reference_ckpt(src)
    ckpts = tmp_path / "subtyping_med3ddramtiny" / "checkpoints"
    main(["--src", str(src), "--arch", "med3ddramtiny", "--to_port",
          str(ckpts), "--epoch", "3"])
    assert sorted(p.name for p in ckpts.iterdir()) == ["epoch_0003.pt"]
    report = load_reference_checkpoint(get_model_by_name("med3ddramtiny"),
                                       str(ckpts / "epoch_0003.pt"))
    assert report["missing"] == 0 and report["unexpected"] == 0
    payload = torch.load(ckpts / "epoch_0003.pt", weights_only=True)
    assert payload["epoch"] == 3 and payload["optimizer"]["state"] == {}
    deployed = build_model("med3ddramtiny", ckp_path=str(ckpts)).state_dict()
    for k, v in source.state_dict().items():
        assert torch.equal(deployed[k], v), k


DEFAULT_ARCHS = ["med3d18", "med3d", "med3d50", "med3ddram18", "med3ddram",
                 "med3ddram50"]


def test_complexity_params_equal_jax_models():
    import jax
    import jax.numpy as jnp

    from bodyct_dram_emph_subtype_tpu.models import \
        get_model_by_name as jax_model
    from bodyct_dram_emph_subtype_tpu_torch.tools import \
        compute_computation_complexity as tool
    assert tool.DEFAULT_ARCHS.split(",") == DEFAULT_ARCHS
    rows = {r["arch"]: r for r in tool.main(["--target_size", "16,32,32"])}
    for arch in DEFAULT_ARCHS:
        model = jax_model(arch)
        x = jnp.zeros((1, 16, 32, 32, 1), jnp.float32)
        variables = jax.eval_shape(
            lambda k: model.init(k, x, x, train=False),
            jax.random.PRNGKey(0))
        n = sum(int(np.prod(leaf.shape))
                for leaf in jax.tree.leaves(variables["params"]))
        assert rows[arch]["params_M"] == round(n / 1e6, 2), arch


def test_complexity_baseline_table_equals_jax_tool():
    sys.path.insert(0, str(REPO))
    try:
        from tools.compute_computation_complexity import \
            external_baseline_table as jax_table
    finally:
        sys.path.remove(str(REPO))
    from bodyct_dram_emph_subtype_tpu_torch.tools.compute_computation_complexity \
        import external_baseline_table
    assert external_baseline_table() == jax_table()


def _ceil(shape, s):
    return tuple(-(-n // s) for n in shape)


def _conv_flops(conv, out):
    k = math.prod(conv.kernel_size)
    return 2 * conv.in_channels * conv.out_channels * k * math.prod(out)


def _resize_flops(shape, channels, scale):
    """Linear x``scale`` resize, one axis after the other, each a product
    with an (n, scale n) matrix: 2 n (scale n) per line of that axis."""
    flops, shape = 0, list(shape)
    for axis in range(3):
        n = shape[axis]
        lines = channels * math.prod(shape) // n
        flops += 2 * lines * n * scale * n
        shape[axis] = scale * n
    return flops, tuple(shape)


def _analytic_flops(model, size):
    """2 Cin Cout k^3 out-voxels over the eval forward's convs (stem, the
    residual blocks, the decoder, the 1x1x1 heads) plus the decoder's two
    linear resizes, batch 1."""
    stem = _ceil(size, 2)
    flops = _conv_flops(model.conv1, stem)
    s = _ceil(stem, 2)                                   # the max-pool
    x1 = None
    for lname in ("layer1", "layer2", "layer3", "layer4"):
        for blk in getattr(model, lname):
            s_in = s
            for name, conv in blk.named_modules():
                if isinstance(conv, torch.nn.Conv3d):
                    out = _ceil(s if name.startswith("conv") else s_in,
                                conv.stride[0])
                    flops += _conv_flops(conv, out)
                    if name.startswith("conv"):
                        s = out
        x1 = s if lname == "layer1" else x1
    channels = model.layer4[-1].conv2.out_channels
    for us, skip in ((model.us1, x1), (model.us2, stem)):
        up, s = _resize_flops(s, channels, us.scale_factor)
        assert s == skip
        flops += up
        for conv, _, _ in us.conv_blocks:
            flops += _conv_flops(conv, s)
            channels = conv.out_channels
    flops += _conv_flops(model.us3[0], s)
    return flops + sum(_conv_flops(fc, s) for fc in model.fcs)


def test_complexity_flops_equal_analytic_count():
    from bodyct_dram_emph_subtype_tpu_torch.models.registry import \
        get_model_by_name
    from bodyct_dram_emph_subtype_tpu_torch.tools.compute_computation_complexity \
        import count_flops
    size = (16, 32, 32)
    model = get_model_by_name("med3ddramtiny")
    got = count_flops(model, (1, *size, 1))
    want = _analytic_flops(model, size)
    if got != want:
        pytest.fail(f"FlopCounterMode {got} != analytic {want} (JAX XLA "
                    f"cost analysis: {_jax_xla_flops(size)})")


def _jax_xla_flops(size):
    """XLA's count for the JAX model (elementwise work included)."""
    import jax
    import jax.numpy as jnp

    from bodyct_dram_emph_subtype_tpu.models import \
        get_model_by_name as jax_model
    model = jax_model("med3ddramtiny")
    x = jnp.zeros((1, *size, 1), jnp.float32)
    variables = model.init(jax.random.PRNGKey(0), x, x, train=False)
    cost = jax.jit(lambda v, a: model.apply(v, a, a, train=False)).lower(
        variables, x).compile().cost_analysis()
    return (cost[0] if isinstance(cost, list) else cost).get("flops")


def test_dockerfile_cuda_runs_the_port():
    text = (REPO / "Dockerfile.cuda").read_text()
    lines = [ln.strip() for ln in text.splitlines()
             if ln.strip() and not ln.strip().startswith("#")]
    entry = [ln for ln in lines if ln.startswith("ENTRYPOINT")]
    assert len(entry) == 1 and json.loads(entry[0].split(None, 1)[1]) == \
        ["python", "-m", "bodyct_dram_emph_subtype_tpu_torch.inference"]
    copies = [ln.split()[1:] for ln in lines if ln.startswith("COPY")]
    port = [c for c in copies if any(
        a.rstrip("/") == "bodyct_dram_emph_subtype_tpu_torch" for a in c)]
    assert port, copies
    assert not any(a.rstrip("/") == "bodyct_dram_emph_subtype_tpu"
                   for c in copies for a in c)
    assert (REPO / "bodyct_dram_emph_subtype_tpu_torch" / "csrc").is_dir()
    # the kernel library is built into the image
    assert any(ln.startswith("RUN") and "cuda_build" in ln for ln in lines)
    assert re.search(r"mkdir -p [^\n]*/input /output", text)
    labels = dict(re.findall(r"^LABEL (\S+)=(\S+)", text, re.M))
    prefix = "nl.diagnijmegen.rse.algorithm."
    assert labels[prefix + "hardware.gpu.count"] == "1"
    assert prefix + "hardware.tpu.count" not in labels
    assert prefix + "name" in labels and "USER algorithm" in lines
    reqs = (REPO / "install_files" / "requirements_torch.txt").read_text()
    pins = [ln.split("#")[0].strip() for ln in reqs.splitlines()]
    names = [re.split(r"[<>=\[ ]", p)[0].lower() for p in pins if p]
    assert "torch" in names and "numpy" in names
    assert not [n for n in names if "jax" in n or n in ("flax", "optax")]
    assert "jax" not in text.lower().replace("no jax", "")
