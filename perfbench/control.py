#!/usr/bin/env python3
"""Readings that set a cell's limits: the program's and the control's.

For each seed, at the cell's own size, in one process:

- the program's numbers: the cell's timed path (one unit of work through
  the program's entry point, as the window runs it) against the float32
  reference;
- the control's numbers: the reference computed in the precision below the
  configuration's (float8 e4m3 convolutions for bfloat16), put in the
  program's place: for the processor its heatmaps, result JSONs and
  fractions are written in the program's layout and go through the cell's
  own ``compare`` and ``judge``, as a job's do.

The largest program reading over the seeds is a limit's lower reading, the
smallest control reading its upper one (``PERF.md`` gives both and the
limit).  The benchmark's own runs never run this::

    python3 perfbench/control.py --workload proc.med3ddram.cohort \\
        --seeds 12 --out chiprun_out/control_cohort.json
"""
from __future__ import annotations

import argparse
import contextlib
import json
import shutil
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from perfbench import harness, synth  # noqa: E402


def processor_readings(ctx, driver, seed: int) -> dict:
    """One job of the cell through ``run_inference`` against the float32
    reference, and the float8 reference against it."""
    import torch
    from bodyct_dram_emph_subtype_tpu_torch.inference.processor import \
        run_inference
    from bodyct_dram_emph_subtype_tpu_torch.models.registry import \
        get_model_by_name

    cfg, trf = ctx.config, ctx.traffic
    dev = torch.device(ctx.device)
    target = tuple(cfg["input_size"])
    shutil.rmtree(ctx.work, ignore_errors=True)
    inputs = ctx.work / "inputs"
    cohort = synth.make_cohort(trf, seed, dev)
    for sub, key in (("scans", "ct"), ("lobes", "lobes")):
        (inputs / sub).mkdir(parents=True)
        for s in cohort:
            synth.write_mha(inputs / sub / f"{s['name']}.mha", s[key],
                            tuple(reversed(trf["spacing_zyx"])))
    params = driver.make_params(cfg, cohort[0], seed, dev, target)
    model = get_model_by_name(
        cfg["arch"], packed_decoder=cfg["compute_dtype"] == "bfloat16")
    model.load_state_dict(params)
    model = model.to(dev).eval()
    kw = dict(model=model, compute_dtype=cfg["compute_dtype"],
              batch_size=int(cfg["batch_per_rank"]),
              workers=int(trf["workers"]), target_size=target,
              pad_shape=tuple(trf["pad_shape"]),
              gated_frac=float(trf["gated_frac"]), device=ctx.device)
    job = driver._job(0, inputs, ctx.work / "jobs", cohort, run_inference, kw)
    del model, kw
    params = {k: v.cpu() for k, v in params.items()}
    refs = driver.references(cfg, cohort, params, dev, target)
    prog = driver.compare(refs, [job], cohort, seed, len(cohort), dev)
    ctrl_refs = driver.references(cfg, cohort, params, dev, target,
                                  prec="fp8")
    ctrl_job = _control_job(driver, ctrl_refs, cohort, ctx.work / "jobs",
                            tuple(reversed(trf["spacing_zyx"])))
    del ctrl_refs
    ctrl = driver.compare(refs, [ctrl_job], cohort, seed, len(cohort), dev)
    bf16_refs = driver.references(cfg, cohort, params, dev, target,
                                  prec="bf16")
    fr, cf = job["stats"]["fractions"], ctrl_job["stats"]["fractions"]
    detail = {}
    for uid, cuid, s in zip(job["uids"], ctrl_job["uids"], cohort):
        r, w = refs[s["name"]], bf16_refs[s["name"]]
        detail[s["name"]] = {
            "ref": [r["cle_pct"], r["pse_pct"]], "program": list(fr[uid]),
            "control": list(cf[cuid]),
            "bf16_reference": [w["cle_pct"], w["pse_pct"]]}
    shutil.rmtree(ctx.work, ignore_errors=True)
    return {"seed": seed, "program": prog, "control": ctrl,
            "program_correct": harness.judge(driver.checks(prog, ctx.limits)),
            "control_correct": harness.judge(driver.checks(ctrl, ctx.limits)),
            "detail": detail}


def _control_job(driver, refs, cohort, jobs: Path, spacing_xyz) -> dict:
    """The control in the program's place: a job's record and files in the
    program's layout (compressed heatmap MetaImages, the result JSONs, the
    fractions), made from the control's outputs ``refs``, for the cell's
    own ``compare``."""
    from perfbench.reference import processor as ref_proc

    tag = "jcontrol"
    out = jobs / tag / "out"
    results, fractions, uids = [], {}, []
    for s in cohort:
        uid, r = f"{tag}{s['name']}", refs[s["name"]]
        for m in ("cle", "pse"):
            d = out / "images" / driver.HEAT_DIRS[m]
            d.mkdir(parents=True, exist_ok=True)
            synth.write_mha(d / f"{uid}.mha", r["heat"][m].cpu().numpy(),
                            spacing_xyz, compressed=True)
        f = fractions[uid] = (float(r["cle_pct"]), float(r["pse_pct"]))
        results.append({"entity": uid, "error_messages": [], "metrics": {
            "cle_severity_score": str(ref_proc.ratio_to_label(
                f[0], ref_proc.CLE_RATIO_MAP)),
            "pse_severity_score": str(ref_proc.ratio_to_label(
                f[1], ref_proc.PSE_RATIO_MAP)),
            "cle_lesion_percentage_per_lung": f"{f[0]:.3f}",
            "pse_lesion_percentage_per_lung": f"{f[1]:.3f}"}})
        uids.append(uid)
    for name in ("results.json", "centrilobular-emphysema-score.json",
                 "araseptal-emphysema-score.json"):
        (out / name).write_text(json.dumps(results))
    return {"tag": tag, "dir": jobs / tag, "stats": {"fractions": fractions},
            "results": results, "uids": uids}


def trainer_readings(ctx, driver, seed: int, witness: bool = False,
                     faults: bool = False) -> dict:
    """The cell's set-up steps through the trainer's epoch loop, followed
    by the float32 reference; the float8 reference against it (the
    control); and the fault "half of the batch left out": the reference on
    each batch's first row alone, the mean taken over it.  (The fault "a
    step that returns its state unchanged" reads 1 by ``update_gap``'s
    measure and needs no run.)  ``witness``: also the reference in
    bfloat16, and the program in float32, against the float32
    reference.  ``faults``: also a run with an answer altered where it is
    produced, in the loader (the preprocessed image x1.01, the lung's
    middle plane cleared) and in the augmentation (its image x1.01, its
    lung's middle plane cleared): the readings of the start and augment
    numbers."""
    import numpy as np
    import torch

    cfg, trf = ctx.config, ctx.traffic
    dev = torch.device(ctx.device)
    n = int(trf["check_steps"])
    labels = {k: np.asarray(trf[f"{k}_labels"]) for k in ("cle", "pse")}
    cap, params, archive = _capture_steps(ctx, driver, seed, n)
    prog = driver.follow(cfg, cap, params, archive, labels, dev)
    ref = driver.reference_steps(cfg, cap, params, labels, dev)
    out = {"seed": seed, "program": prog}
    sides = [("control", {"prec": "fp8"}),
             ("half_batch", {"rows": slice(0, 1)})]
    if witness:
        sides.append(("bf16_reference", {"prec": "bf16"}))
    for name, kw in sides:
        side = driver.reference_steps(cfg, cap, params, labels, dev, **kw)
        out[name] = driver.compare_steps(*side, ref, params)
    out["losses"] = {"program": [l["loss"] for l in cap.losses],
                     "reference": ref[0]}
    if witness:
        ctx.config = dict(cfg, compute_dtype="float32")
        cap32, _, _ = _capture_steps(ctx, driver, seed, n)
        ctx.config = cfg
        out["float32_program"] = driver.compare_steps(
            [l["loss"] for l in cap32.losses], cap32.grad1, cap32.params,
            cap32.maps1,
            driver.reference_steps(cfg, cap32, params, labels, dev), params)
    if faults:
        with _altered_answers():
            capf, _, _ = _capture_steps(ctx, driver, seed, n)
        out["altered_answers"] = driver.check_inputs(cfg, capf, archive, dev)
    shutil.rmtree(ctx.work, ignore_errors=True)
    return out


@contextlib.contextmanager
def _altered_answers():
    """Plant the preprocess's (the host loader's and the device
    pipeline's) and the augmentation's altered answers in the program's
    modules for the block."""
    from bodyct_dram_emph_subtype_tpu_torch.data import host_preprocess
    from bodyct_dram_emph_subtype_tpu_torch.train import steps

    pre, fused = host_preprocess.preprocess_sample, steps.fused_preprocess
    aug = steps.augment_batch

    def bad_pre(sample, *a, **k):
        out = pre(sample, *a, **k)
        out["image"] = out["image"] * 1.01
        out["lung_mask"] = out["lung_mask"].copy()
        out["lung_mask"][len(out["lung_mask"]) // 2] = 0
        return out

    def bad_fused(*a, **k):
        out = fused(*a, **k)
        lung = out["lung_mask"].clone()
        lung[:, lung.shape[1] // 2] = 0
        return dict(out, image=out["image"] * 1.01, lung_mask=lung)

    def bad_aug(*a, **k):
        images, lungs, ems = aug(*a, **k)
        lungs = lungs.clone()
        lungs[:, lungs.shape[1] // 2] = 0
        return images * 1.01, lungs, ems

    host_preprocess.preprocess_sample = bad_pre
    steps.fused_preprocess, steps.augment_batch = bad_fused, bad_aug
    try:
        yield
    finally:
        host_preprocess.preprocess_sample = pre
        steps.fused_preprocess, steps.augment_batch = fused, aug


def _capture_steps(ctx, driver, seed: int, n: int):
    """The trainer's first ``n`` steps of the seed, captured; the trainer
    freed."""
    import gc

    import torch

    trainer, params, archive, _ = driver.build(ctx, seed)
    cap = driver.Capture(trainer, n)
    seen = []

    def mark(name):
        if name == "loader":
            if len(seen) == n:
                raise driver.StopWindow
            seen.append(name)

    trainer.step_mark = mark
    try:
        trainer.fit()
    except driver.StopWindow:
        pass
    trainer.close()
    del trainer
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return cap, params, archive


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, default=12)
    parser.add_argument("--first_seed", type=int, default=3_000_000_017)
    parser.add_argument("--out", required=True)
    parser.add_argument("--witness", action="store_true",
                        help="trainer cells: the bfloat16 reference and the "
                        "float32 program too")
    parser.add_argument("--faults", action="store_true",
                        help="trainer cells: a run with altered answers "
                        "in the loader and the augmentation too")
    args = parser.parse_args(argv)
    manifest = harness.load_json(harness.ROOT / "BENCHMARK.json")
    spec = harness.cell_spec(args.workload, manifest)
    ctx = harness.Context(args.workload, spec, args.first_seed, 0, False,
                          "cuda", int(spec["workload"]["chips"]),
                          harness.ROOT / "bench_work" / "control")
    driver = harness.load_module(spec["driver"])
    readings = getattr(sys.modules[__name__],
                       f"{spec['traffic']['driver']}_readings")
    out = []
    for i in range(args.seeds):
        t0 = time.perf_counter()
        kw = {k: True for k in ("witness", "faults") if getattr(args, k)}
        r = readings(ctx, driver, args.first_seed + 7919 * i, **kw)
        r["seconds"] = time.perf_counter() - t0
        out.append(r)
        harness.log(json.dumps(r))
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    for side in ("program_correct", "control_correct"):
        if side in out[0]:
            harness.log(f"{side}: {[r[side] for r in out]}")
    for side in ("program", "control", "half_batch", "bf16_reference",
                 "float32_program", "altered_answers"):
        if side not in out[0]:
            continue
        for key, v in out[0][side].items():
            if isinstance(v, str):
                continue
            vals = [r[side][key] for r in out]
            harness.log(f"{side} {key}: min {min(vals)!r} max "
                        f"{max(vals)!r} all {vals}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
