"""A run with the timed path broken underneath comes out not correct.

Each case drives a whole tiny run on the CPU (the harness's look for a
card skipped) with one fault planted in the program, and sees ``correct``
false; the sound run beside them comes out true."""
import pytest
import torch

from perfbench.tests import tiny

from bodyct_dram_emph_subtype_tpu_torch.inference import processor as prog_proc
from bodyct_dram_emph_subtype_tpu_torch.train import steps as prog_steps


def _alter_fraction(mp):
    orig = prog_proc._predict

    def predict(*a, **k):
        out = orig(*a, **k)
        out["cle_pct"] = out["cle_pct"] * 1.02
        return out

    mp.setattr(prog_proc, "_predict", predict)


def _alter_heatmap(mp):
    orig = prog_proc._finalize_scan

    def finalize(uid, rec, **k):
        rec = dict(rec, pse_dense=rec["pse_dense"] * 0.9)
        return orig(uid, rec, **k)

    mp.setattr(prog_proc, "_finalize_scan", finalize)


def _half_batch_proc(mp):
    orig = prog_proc._predict

    def predict(*a, **k):
        out = orig(*a, **k)
        return {key: torch.stack([v[0]] * v.shape[0]) for key, v in
                out.items()}

    mp.setattr(prog_proc, "_predict", predict)


@pytest.mark.parametrize("fault", [None, _alter_fraction, _alter_heatmap,
                                   _half_batch_proc])
def test_processor(tmp_path, monkeypatch, fault):
    if fault is not None:
        fault(monkeypatch)
    res = tiny.run(tmp_path, "proc.tiny")
    assert res["correct"] is (fault is None), res["checks"]


def _state_unchanged(mp):
    mp.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)


def _half_batch_train(mp):
    orig = prog_steps._reg_losses

    def losses(outs, inputs, *a):
        dense, regs = outs
        one = ([d[:1] for d in dense], [r[:1] for r in regs])
        return orig(one, {k: v[:1] for k, v in inputs.items()}, *a)

    mp.setattr(prog_steps, "_reg_losses", losses)


def _alter_maps(mp):
    orig = prog_steps._reg_losses

    def losses(outs, *a):
        dense, regs = outs
        return orig(([d * 0.95 for d in dense], regs), *a)

    mp.setattr(prog_steps, "_reg_losses", losses)


@pytest.mark.parametrize("fault", [None, _state_unchanged,
                                   _half_batch_train, _alter_maps])
def test_trainer(tmp_path, monkeypatch, fault):
    if fault is not None:
        fault(monkeypatch)
    res = tiny.run(tmp_path, "train.tiny")
    assert res["correct"] is (fault is None), res["checks"]
