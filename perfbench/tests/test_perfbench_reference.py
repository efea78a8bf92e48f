"""The plain reference against the program's plain route at a tiny size
(float32 on the CPU).  The test imports both; the reference imports
nothing of the program."""
import numpy as np
import pytest
import torch

from perfbench import synth
from perfbench.reference import model as ref_model
from perfbench.reference import train as ref_train
from perfbench.tests import tiny

from bodyct_dram_emph_subtype_tpu_torch.data.host_preprocess import \
    preprocess_sample
from bodyct_dram_emph_subtype_tpu_torch.models.registry import \
    get_model_by_name
from bodyct_dram_emph_subtype_tpu_torch.transforms.batch_augment import (
    augment_batch, draw_augment_params)


@pytest.mark.parametrize("arch", ["med3ddramtiny", "med3ddram",
                                  "med3ddram50"])
def test_weights_load_into_the_program_strictly(arch):
    sd = ref_model.make_weights(arch, 3, "cpu", 0.01)
    model = get_model_by_name(arch)
    model.load_state_dict(sd, strict=True)
    n = sum(v.numel() for k, v in sd.items() if not k.endswith(
        ("running_mean", "running_var", "num_batches_tracked")))
    assert n == sum(p.numel() for p in model.parameters())


@pytest.mark.parametrize("train", [False, True])
def test_model_matches_the_program(train):
    sd = ref_model.make_weights("med3ddramtiny", 5, "cpu", 0.3)
    model = get_model_by_name("med3ddramtiny")
    model.load_state_dict(sd)
    model.train(train)
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 32, 48, 64, generator=g)
    lung = (torch.rand(2, 32, 48, 64, generator=g) > 0.3).float()
    with torch.set_grad_enabled(train):
        dense, fracs = model(x[..., None], lung[..., None])
        rd, rf = ref_model.forward({k: v.clone() for k, v in sd.items()},
                                   "med3ddramtiny", x[:, None],
                                   lung[:, None], train=train)
    for a, b in zip(dense, rd):
        torch.testing.assert_close(a[..., 0], b[:, 0], rtol=0, atol=2e-5)
    for a, b in zip(fracs, rf):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


def test_train_preprocess_matches_the_loaders():
    ct, lobes = synth.make_scan((24, 32, 40), (20, 28, 36), 9, "cpu")
    lung = (lobes > 0).numpy()
    sample = {"image": ct.numpy(), "lung_mask": lung,
              "em_mask": (ct.numpy() < -950) & lung}
    got = preprocess_sample(sample, (16, 24, 32))
    want = ref_train.preprocess(ct, lobes, (16, 24, 32))
    np.testing.assert_allclose(got["image"], want["image"].numpy(),
                               rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got["lung_mask"], want["lung"].numpy())
    np.testing.assert_array_equal(got["em_mask"], want["em"].numpy())


def test_augment_matches_the_programs_on_its_draws():
    g = torch.Generator().manual_seed(4)
    images = torch.randn(2, 16, 24, 32, generator=g)
    lungs = (torch.rand(2, 16, 24, 32, generator=g) > 0.4).float()
    ems = lungs * (torch.rand(2, 16, 24, 32, generator=g) > 0.7).float()
    for seed in range(6):
        draws = draw_augment_params(torch.Generator().manual_seed(seed), 2,
                                    (16, 24, 32))
        got = augment_batch(images, lungs, ems, draws, (8, 12, 16))
        want = ref_train.augment(images, lungs, ems, draws, (8, 12, 16))
        torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=2e-5)
        assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])


def test_processor_pipeline_matches_the_program(tmp_path):
    res = tiny.run(tmp_path, "proc.tiny")
    assert res["correct"], res["checks"]
    assert res["checks"]["frac_gap"]["value"] < 1e-4
    assert res["checks"]["heat_gap"]["value"] < 0.1


def test_wide_scans_take_the_host_path_and_match(tmp_path):
    res = tiny.run(tmp_path, "proc.tiny.wide", trace=True)
    assert res["correct"], res["checks"]
    assert "proc.pack_ms" not in res["metrics"]
    assert res["metrics"]["proc.postprocess_ms"]["value"] > 0
