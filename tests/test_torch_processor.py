"""The port's deployment processor against the JAX package's, end to end:
the ``tests/test_processor.py`` synthetic scans, ``med3ddramtiny`` with one
set of weights, target (32, 48, 64), float32, through both
``run_inference``s.  Score JSONs equal, percentages within 1e-4, heatmaps
within one uint8 count."""
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bodyct_dram_emph_subtype_tpu.data import read_mha
from bodyct_dram_emph_subtype_tpu.inference import \
    run_inference as jax_run_inference
from bodyct_dram_emph_subtype_tpu.models import get_model_by_name as jax_model
from bodyct_dram_emph_subtype_tpu.train.state import TrainState, make_optimizer
from bodyct_dram_emph_subtype_tpu_torch.inference import run_inference
from bodyct_dram_emph_subtype_tpu_torch.models.registry import \
    get_model_by_name
from bodyct_dram_emph_subtype_tpu_torch.models.torch_import import \
    state_dict_from_jax
from test_processor import _write_case

TARGET = (32, 48, 64)
HEATMAPS = ("centrilobular-emphysema-heatmap", "paraseptal-emphysema-heatmap")
SCORE_JSONS = ("centrilobular-emphysema-score.json",
               "araseptal-emphysema-score.json")


@pytest.fixture
def cases(tmp_path):
    scans, lobes = tmp_path / "ct", tmp_path / "lobes"
    scans.mkdir()
    lobes.mkdir()
    _write_case(scans, lobes, "case1")
    _write_case(scans, lobes, "case2", shape=(40, 56, 72), seed=1)
    return tmp_path, scans, lobes


def _shared_weights():
    model = jax_model("med3ddramtiny")
    x = jnp.zeros((1, *TARGET, 1), jnp.float32)
    init = jax.jit(functools.partial(model.init, train=False))
    return jax.tree.map(np.asarray, dict(init(jax.random.PRNGKey(0), x, x)))


def test_processor_matches_jax_processor(cases):
    root, scans, lobes = cases
    variables = _shared_weights()
    jout, tout = root / "jax_out", root / "torch_out"
    jres = jax_run_inference(
        str(scans), str(lobes), str(jout), model_arch="med3ddramtiny",
        ckp_path=None, target_size=TARGET, batch_size=1, workers=1,
        nchips=1, state=TrainState.create(variables, make_optimizer()))
    port = get_model_by_name("med3ddramtiny")
    port.load_state_dict(state_dict_from_jax(variables), strict=True)
    stats = {}
    tres = run_inference(str(scans), str(lobes), str(tout),
                         target_size=TARGET, batch_size=2, workers=1,
                         model=port, device="cpu", stats=stats)

    assert [r["entity"] for r in tres] == [r["entity"] for r in jres] \
        == ["case1", "case2"]
    for t, j in zip(tres, jres):
        assert set(t["metrics"]) == set(j["metrics"])
        for name in ("cle", "pse"):
            key = f"{name}_lesion_percentage_per_lung"
            assert abs(float(t["metrics"][key]) - float(j["metrics"][key])) \
                <= 1e-4
            key = f"{name}_severity_score"
            assert t["metrics"][key] == j["metrics"][key]
    for fname in SCORE_JSONS:
        assert json.loads((tout / fname).read_text()) == \
            json.loads((jout / fname).read_text())
    assert len(json.loads((tout / "results.json").read_text())) == 2
    for sub in HEATMAPS:
        for uid in ("case1", "case2"):
            t = read_mha(tout / "images" / sub / f"{uid}.mha")
            j = read_mha(jout / "images" / sub / f"{uid}.mha")
            assert t.array.dtype == np.uint8
            assert t.array.shape == j.array.shape
            assert (t.spacing, t.origin) == (j.spacing, j.origin)
            diff = np.abs(t.array.astype(int) - j.array.astype(int))
            assert diff.max() <= 1
    assert stats["batches"] == 1 and stats["scans"] == 2
    assert set(stats["stage_ms"]) == {"upload", "preprocess", "forward",
                                      "reduction", "download", "postprocess"}


def test_oversized_crop_raises_naming_the_scan(cases):
    root, scans, lobes = cases
    with pytest.raises(ValueError, match="case1"):
        run_inference(str(scans), str(lobes), str(root / "out"),
                      model_arch="med3ddramtiny", ckp_path=None,
                      target_size=TARGET, batch_size=1, workers=1,
                      pad_shape=(160, 32, 384), device="cpu")


def test_cli_writes_the_output_contract(cases):
    from bodyct_dram_emph_subtype_tpu_torch.inference.__main__ import main
    root, scans, lobes = cases
    out = root / "cli_out"
    main(["--scan_path", str(scans), "--lobe_path", str(lobes),
          "--output_path", str(out), "--model_arch", "med3ddramtiny",
          "--ckp", str(root / "missing.ckpt"), "--target_size", "16,24,32",
          "--compute_dtype", "float32", "--device", "cpu"])
    for fname in SCORE_JSONS:
        assert set(json.loads((out / fname).read_text())) == \
            {"score", "percentage"}
    for sub in HEATMAPS:
        assert (out / "images" / sub / "case2.mha").exists()
    with pytest.raises(SystemExit):
        main(["--nchips", "2"])
