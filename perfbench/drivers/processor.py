"""Driver ``processor``: the deployment processor in back-to-back jobs.

Set-up: the traffic's distinct scans are made from the seed (on the
device) and written once as uncompressed MetaImages; the weights are drawn
from the seed on the device and loaded into the program's model
(``get_model_by_name``, the processor's packed decoder in bfloat16); one
job warms up every shape.  The window: jobs of the whole cohort, each a
``run_inference`` call (the CLI's defaults: batch, workers, pad, gated
fraction, bfloat16) over a directory of links to the scans under fresh
uids, started back to back until ``--seconds`` have passed; the last one
finishes.  A job is done when its heatmaps and JSONs are written.

After the window the reference (``reference/processor.py``, float32)
scores each distinct scan once, and every finished scan is held to it.
The numbers that ``limits/<cell>.json`` names and the exact ones are
compared; the rest are printed as readings:

- ``frac_gap``: the mean |program - reference| lesion fraction over the
  finished scans and both maps (a reading: a fraction averages the maps'
  rounding over a million voxels, so it does not part the program from
  the lower-precision control);
- ``heat_gap`` and ``heat_over4``: of a sample of the finished scans drawn
  from the seed, the largest mean |program - reference| heatmap value
  (uint8 counts, over the voxels where either is nonzero), and the largest
  share of those voxels off by more than 4 counts;
- ``heat_outside``: nonzero heatmap voxels outside the crop (limit 0);
- ``score_mismatch``: written scores or percentages that are not the
  reference's interval map and format of the program's fraction (0);
- ``missing``: scans of a finished job without a result, a heatmap or a
  score JSON (0).
"""
from __future__ import annotations

import gc
import math
import shutil
import time
from pathlib import Path
from typing import Dict, List

import numpy as np

from perfbench import flops, synth
from perfbench import trace as tr
from perfbench import window as win
from perfbench.reference import model as ref_model
from perfbench.reference import processor as ref_proc

HEAT_DIRS = {"cle": "centrilobular-emphysema-heatmap",
             "pse": "paraseptal-emphysema-heatmap"}


def _job(j, inputs: Path, jobs: Path, cohort, run_inference, kw) -> Dict:
    """One ``run_inference`` call over links to ``cohort``'s files under
    uids of job ``j``; its times, stats and results."""
    tag = f"j{j:04d}" if isinstance(j, int) else f"j{j}"
    d = jobs / tag
    for sub in ("scans", "lobes"):
        (d / sub).mkdir(parents=True)
        for s in cohort:
            (d / sub / f"{tag}{s['name']}.mha").symlink_to(
                inputs / sub / f"{s['name']}.mha")
    stats: Dict = {}
    t0 = time.perf_counter()
    results = run_inference(str(d / "scans"), str(d / "lobes"),
                            str(d / "out"), stats=stats, **kw)
    t1 = time.perf_counter()
    return {"tag": tag, "dir": d, "t0": t0, "t1": t1, "stats": stats,
            "results": results, "uids": [f"{tag}{s['name']}" for s in cohort]}


def _sum_stats(jobs: List[Dict], batch: int) -> Dict:
    out = {"stage_ms": {}, "pack_ms": 0.0, "upload_bytes": 0, "batches": 0,
           "scans": 0, "host_scans": 0, "device_batches": 0,
           "device_scans": 0}
    for j in jobs:
        s = j["stats"]
        for k, v in s["stage_ms"].items():
            out["stage_ms"][k] = out["stage_ms"].get(k, 0.0) + v
        n, n_host = len(j["uids"]), len(s["host_scans"])
        out["pack_ms"] += s["pack_ms"]
        out["upload_bytes"] += s["upload_bytes"]
        out["batches"] += s["batches"]
        out["scans"] += n
        out["host_scans"] += n_host
        out["device_batches"] += math.ceil(n / batch)
        out["device_scans"] += n - n_host
    return out


def run(ctx) -> Dict:
    import torch
    from bodyct_dram_emph_subtype_tpu_torch.inference.processor import \
        run_inference
    from bodyct_dram_emph_subtype_tpu_torch.models.registry import \
        get_model_by_name

    cfg, trf = ctx.config, ctx.traffic
    dev = torch.device(ctx.device)
    cuda = dev.type == "cuda"
    target = tuple(trf.get("target_size", cfg["input_size"]))
    batch = int(trf.get("batch_size", cfg["batch_per_rank"]))
    shutil.rmtree(ctx.work, ignore_errors=True)
    inputs, jobs_dir = ctx.work / "inputs", ctx.work / "jobs"
    written = 0
    with ctx.part("inputs"):
        cohort = synth.make_cohort(trf, ctx.seed, dev)
        spacing_xyz = tuple(reversed(trf["spacing_zyx"]))
        for sub, key in (("scans", "ct"), ("lobes", "lobes")):
            (inputs / sub).mkdir(parents=True)
            for s in cohort:
                written += synth.write_mha(inputs / sub / f"{s['name']}.mha",
                                           s[key], spacing_xyz)
    with ctx.part("weights"):
        params = make_params(cfg, cohort[0], ctx.seed, dev, target)
    with ctx.part("model"):
        model = get_model_by_name(
            cfg["arch"], packed_decoder=cfg["compute_dtype"] == "bfloat16")
        model.load_state_dict(params)
        model = model.to(dev).eval()
        params = {k: v.cpu() for k, v in params.items()}
    kw = dict(model=model, compute_dtype=cfg["compute_dtype"],
              batch_size=batch, workers=int(trf["workers"]),
              target_size=target, pad_shape=tuple(trf["pad_shape"]),
              gated_frac=float(trf["gated_frac"]), device=ctx.device)
    with ctx.part("warmup"):
        # one batch: every shape of the window (a batch is always full)
        warm = _job("warm", inputs, jobs_dir, cohort[:batch], run_inference,
                    kw)
        shutil.rmtree(warm["dir"])
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()

    ctx.window_starts()
    jobs: List[Dict] = []
    traced = None
    deadline = time.perf_counter() + ctx.seconds
    while time.perf_counter() < deadline or (ctx.trace and len(jobs) < 2):
        j = len(jobs)
        call = lambda: _job(j, inputs, jobs_dir, cohort, run_inference, kw)
        if ctx.trace and j == 1:
            rec, traced = tr.profiled(call, ctx.work / "profile", dev.type)
        else:
            rec = call()
        jobs.append(rec)
        st = rec["stats"]
        ctx.log(f"job {j}: {len(rec['uids'])} scans in "
                f"{rec['t1'] - rec['t0']:.3f} s (postprocess "
                f"{st['stage_ms']['postprocess']:.0f} ms, packing "
                f"{st['pack_ms']:.0f} ms, host-path scans "
                f"{len(st['host_scans'])})")
    window_s = jobs[-1]["t1"] - jobs[0]["t0"]
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    del model, kw
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    checks = _check(ctx, cfg, trf, cohort, params, jobs, dev, target)
    attempted = sum(len(j["uids"]) for j in jobs)
    shutil.rmtree(ctx.work, ignore_errors=True)

    proc = _sum_stats(jobs, batch)
    scan_flops = flops.model_flops(cfg["arch"], (1, 1, *target), False)
    rec = {
        "e2e": {"scans_per_s": win.jobs_rate(
            [(j["t0"], j["t1"], len(j["uids"])) for j in jobs]),
                "setup_s": ctx.setup_s},
        "checks": checks, "attempted": attempted,
        "failed": int(checks["missing"]["value"]),
        "device": {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                   "count": ctx.chips, "memory_peak_bytes": int(peak)},
        "proc": proc, "window_s": window_s, "peaks": ctx.peaks(),
        "useful_flops": scan_flops * attempted,
        "bytes_written_inputs": written,
    }
    if traced is not None:
        rec["trace"] = traced
        rec["device"].update(busy_s=traced.busy_s, window_s=traced.window_s)
        rec["breakdown"] = {"device_ops": traced.top_ops(),
                            "idle_gaps": traced.idle_gaps()}
        rec["conv_patterns"] = ctx.kernel_patterns("conv")
        # the traced job's forwards: every batch it ran on the device
        rec["traced_conv_ops"] = flops.conv_ops(
            cfg["arch"], (batch, 1, *target), False) * int(
            jobs[1]["stats"]["batches"])
    return rec


def make_params(cfg, scan, seed: int, dev, target):
    """The seed's weights on the device, their BatchNorm statistics
    calibrated on ``scan`` by the reference (``calibrate_bn``)."""
    import torch

    params = ref_model.make_weights(cfg["arch"], synth.sub_seed(seed, 10),
                                    dev, cfg["head_std"],
                                    cfg.get("head_bias", 0.0))
    ct = torch.from_numpy(scan["ct"]).to(dev)
    lobes = torch.from_numpy(scan["lobes"]).to(dev)
    with ref_model.strict_float32():
        pre = ref_proc.preprocess(ct, lobes, scan["spacing_zyx"], target)
        ref_model.calibrate_bn(params, cfg["arch"], pre["x"], pre["lung"])
    return params


def references(cfg, cohort, params, dev, target, prec: str = "f32") -> Dict:
    """The reference's outputs for each distinct scan, by name."""
    import torch

    p = {k: v.to(dev) for k, v in params.items()}
    refs = {}
    with ref_model.strict_float32():
        for s in cohort:
            ct = torch.from_numpy(s["ct"]).to(dev)
            lobes = torch.from_numpy(s["lobes"]).to(dev)
            refs[s["name"]] = ref_proc.process_scan(
                p, cfg["arch"], ct, lobes, s["spacing_zyx"], target,
                prec=prec)
            del ct, lobes
    return refs


def compare(refs, jobs, cohort, seed: int, heat_sample: int, dev) -> Dict:
    """The compared numbers of the finished jobs against ``refs``."""
    import torch

    gaps, missing, mismatch = [], 0, 0
    finished = []
    for j in jobs:
        by_uid = {r["entity"]: r for r in j["results"]}
        fr = j["stats"].get("fractions", {})
        out = j["dir"] / "out"
        if not all((out / f).exists() for f in (
                "results.json", "centrilobular-emphysema-score.json",
                "araseptal-emphysema-score.json")):
            missing += len(j["uids"])
            continue
        for uid, s in zip(j["uids"], cohort):
            r, f = by_uid.get(uid), fr.get(uid)
            heat = [out / "images" / HEAT_DIRS[m] / f"{uid}.mha"
                    for m in ("cle", "pse")]
            if r is None or f is None or not all(h.exists() for h in heat):
                missing += 1
                continue
            ref = refs[s["name"]]
            gaps += [abs(f[0] - ref["cle_pct"]), abs(f[1] - ref["pse_pct"])]
            m = r["metrics"]
            want = {"cle_severity_score": str(ref_proc.ratio_to_label(
                        f[0], ref_proc.CLE_RATIO_MAP)),
                    "pse_severity_score": str(ref_proc.ratio_to_label(
                        f[1], ref_proc.PSE_RATIO_MAP)),
                    "cle_lesion_percentage_per_lung": f"{f[0]:.3f}",
                    "pse_lesion_percentage_per_lung": f"{f[1]:.3f}"}
            mismatch += sum(m.get(k) != v for k, v in want.items())
            finished.append((uid, s["name"], heat))
    rng = np.random.default_rng(synth.sub_seed(seed, 20))
    n_heat = min(int(heat_sample), len(finished))
    heat_gap = heat_over4 = 0.0
    outside = 0
    for i in sorted(rng.choice(len(finished), n_heat, replace=False)):
        uid, name, paths = finished[i]
        ref = refs[name]
        inside = torch.zeros(ref["heat"]["cle"].shape, dtype=torch.bool,
                             device=dev)
        inside[ref["crop"]] = True
        for m, path in zip(("cle", "pse"), paths):
            got = torch.from_numpy(synth.read_mha(path).copy()).to(dev)
            st = heat_stats(got, ref["heat"][m])
            heat_gap = max(heat_gap, st["mean"])
            heat_over4 = max(heat_over4, st["over4"])
            outside += int((got[~inside] > 0).sum())
    return {"frac_gap": float(np.mean(gaps)) if gaps else float("nan"),
            "heat_gap": heat_gap, "heat_over4": heat_over4,
            "heat_outside": float(outside), "score_mismatch": float(mismatch),
            "missing": float(missing)}


def heat_stats(got, want) -> Dict[str, float]:
    """|got - want| of two uint8 heatmaps over the voxels where either is
    nonzero: its mean, 99th percentile, and the share over 1, 2, 4."""
    live = (got > 0) | (want > 0)
    if not bool(live.any()):
        return {"mean": 0.0, "p99": 0.0, "over1": 0.0, "over2": 0.0,
                "over4": 0.0}
    d = (got.float() - want.float()).abs()[live]
    return {"mean": float(d.mean()),
            "p99": float(d.kthvalue(max(1, int(0.99 * d.numel())))[0]),
            **{f"over{k}": float((d > k).float().mean())
               for k in (1, 2, 4)}}


def checks(got: Dict, limits: Dict) -> Dict:
    """Each number that ``limits`` names beside its limit, and the exact
    ones (limit 0); the others are printed as readings."""
    limits = {"heat_outside": 0.0, "score_mismatch": 0.0, "missing": 0.0,
              **limits}
    return {k: {"value": float(got[k]), "limit": float(v)}
            for k, v in limits.items()}


def _check(ctx, cfg, trf, cohort, params, jobs, dev, target) -> Dict:
    refs = references(cfg, cohort, params, dev, target)
    got = compare(refs, jobs, cohort, ctx.seed, trf["heat_sample"], dev)
    ctx.log(f"readings: {got}")
    return checks(got, ctx.limits)
