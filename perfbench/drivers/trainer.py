"""Driver ``trainer``: the trainer's epoch loop on a seeded archive.

Set-up: the traffic's lung-cropped volumes are made from the seed (on the
device) and written as the trainer's ``.npz`` archive; the trainer
(``SubtypeTrainer``: the configuration's arch and dtype, the default
routing, the traffic's input pipeline, augmentation and Adam) is built,
the weights drawn from the seed on the device are loaded into its model,
and ``fit()`` starts its epoch.  The first ``check_steps`` steps are
set-up: they warm every shape (cuDNN's algorithm search) and are the steps
that the reference follows.  The window opens at the next batch fetch and
closes at the first batch fetch after ``--seconds``: the benchmark's
``step_mark`` raises :class:`StopWindow` there, which ends the epoch loop.

The hook marks each step's phases (``loader``, ``augment``, ``forward``,
``backward``, ``optimizer``, ``done``) on the host clock and with CUDA
events; with ``--trace`` the profiler covers ``trace_steps`` steps from the
window's second, each phase a span of the benchmark's own; the trace is
exported and read after the window.

After the window (the program freed) the float32 reference
(``reference/train.py``) follows the set-up steps on the program's own
inputs, stage by stage: it preprocesses the archive rows the loader
fetched against the step's preprocessed inputs (``start_gap``,
``start_masks``), applies the augmentation to those inputs with the
program's draws (``aug_gap``, ``aug_masks``), then from the seed's weights
runs the forward, losses, backward and Adam on the program's augmented
batches (:func:`compare_steps`: the first step's maps, the losses, the
first gradient as Adam holds it, the parameters' change).  The cell's
limits file names the numbers compared; the others are printed.
"""
from __future__ import annotations

import gc
import shutil
import time
from typing import Dict, List

import numpy as np

from perfbench import flops, synth
from perfbench import window as win
from perfbench.trace import from_profiler
from perfbench.reference import model as ref_model
from perfbench.reference import train as ref_train

PHASES = ("loader", "augment", "forward", "backward", "optimizer")


class StopWindow(Exception):
    """Raised at the first batch fetch after the window's end."""


def build(ctx, seed: int):
    """The archive, the trainer with the seed's weights, and the config."""
    import torch
    from bodyct_dram_emph_subtype_tpu_torch.train.loop import (
        SubtypeTrainer, TrainerConfig)

    cfg, trf = ctx.config, ctx.traffic
    dev = torch.device(ctx.device)
    shutil.rmtree(ctx.work, ignore_errors=True)
    archive = ctx.work / "archive"
    with ctx.part("archive"):
        uids, written = synth.write_training_archive(archive, trf, seed, dev)
    with ctx.part("model"):
        tcfg = TrainerConfig(
            model_arch=cfg["arch"], lr=float(trf["lr"]), max_epochs=1,
            batch_size=int(cfg["batch_per_rank"]),
            num_samples=int(trf["num_samples"]),
            target_size=tuple(cfg["input_size"]),
            workers=int(trf["workers"]), data_path=str(archive),
            train_csv=str(archive / "train.csv"), valid_csv="",
            test_csv="", model_path=str(ctx.work / "models"),
            seed=synth.sub_seed(seed, 30) % (1 << 31),
            sampler_seed=synth.sub_seed(seed, 31) % (1 << 31),
            compute_dtype=cfg["compute_dtype"],
            input_pipeline=trf["input_pipeline"],
            pad_shape=(tuple(trf["pad_shape"]) if trf.get("pad_shape")
                       else None),
            packed_decoder=bool(trf["packed_decoder"]), device=ctx.device)
        trainer = SubtypeTrainer(tcfg)
        trainer.init_state()
        params = ref_model.make_weights(cfg["arch"],
                                        synth.sub_seed(seed, 10), dev,
                                        cfg["head_std"])
        trainer.model.load_state_dict(params)
        trainer.setup_checkpointing()
        params = {k: v.cpu() for k, v in params.items()}
    return trainer, params, archive, written


class Capture:
    """Records the set-up steps: each batch's archive rows and labels, its
    preprocessed inputs, the augmentation's draws and outputs, the first
    step's maps, the losses, the first gradient (Adam's first moment after
    step 1) and the parameters after the last set-up step; then steps
    aside."""

    def __init__(self, trainer, n: int):
        from bodyct_dram_emph_subtype_tpu_torch.train import steps

        self.trainer, self.n, self.steps_mod = trainer, n, steps
        self.rows: List[np.ndarray] = []
        self.labels, self.pre, self.augmented, self.losses = [], [], [], []
        self.lr: List[float] = []
        self.grad1: Dict = {}
        self.params: Dict = {}
        self.maps1 = None
        self._hook = trainer.model.register_forward_hook(self._maps)
        self._put, self._step = trainer._put, trainer._train_step
        self._augment = steps.augment_batch
        trainer._put = self.put
        trainer._train_step = self.step
        steps.augment_batch = self.augment

    def _maps(self, module, args, output):
        """The first train forward's two dense maps."""
        if module.training and self.maps1 is None:
            self.maps1 = [d.detach().float().cpu() for d in output[0]]
            self._hook.remove()

    def put(self, pipeline, train):
        inner = self._put(pipeline, train)

        def put(batch):
            if train and len(self.rows) < self.n:
                self.rows.append(np.asarray(batch["index"]).reshape(-1))
            return inner(batch)

        return put

    def augment(self, images, lungs, ems, draws, mask_out=None):
        # the step's preprocessed inputs (the loader's, or the device
        # pipeline's fused preprocess), then the augmentation
        self.pre.append([t.detach().cpu() for t in (images, lungs, ems)])
        out = self._augment(images, lungs, ems, draws, mask_out)
        self.augmented.append({
            "draws": {k: v.detach().cpu() for k, v in draws.items()},
            "mask_out": mask_out,
            "out": [t.detach().cpu() for t in out]})
        return out

    def step(self, batch, lr, cw_cle, cw_pse, generator=None, mark=None):
        import torch
        self.labels.append([batch[k].detach().cpu()
                            for k in ("cls_label", "pse_label")])
        self.lr.append(float(lr))
        metrics, preds = self._step(batch, lr, cw_cle, cw_pse,
                                    generator=generator, mark=mark)
        self.losses.append({k: float(v) for k, v in metrics.items()})
        model, opt = self.trainer.model, self.trainer.optimizer
        if len(self.labels) == 1:
            # the gradient as Adam got it: its first moment after one step
            # (none where it took no step)
            b1 = opt.param_groups[0]["betas"][0]
            self.grad1 = {k: (opt.state[p]["exp_avg"] / (1 - b1)).cpu()
                          if "exp_avg" in opt.state[p]
                          else torch.zeros_like(p, device="cpu")
                          for k, p in model.named_parameters()}
        if len(self.labels) == self.n:
            self.params = {k: p.detach().cpu().clone()
                           for k, p in model.named_parameters()}
            self.trainer._put, self.trainer._train_step = \
                self._put, self._step
            self.steps_mod.augment_batch = self._augment
        return metrics, preds


class Marks:
    """The ``step_mark`` hook: phase times, the window, the profiler."""

    def __init__(self, ctx, n_setup: int, cuda: bool):
        self.ctx, self.n_setup, self.cuda = ctx, n_setup, cuda
        self.steps: List[Dict] = []          # per step: name -> (t, event)
        self.deadline = self.t_stop = None
        self.t_fit = time.perf_counter()
        self.prof = self.trace = self._stopped = None
        self._spans: List = []

    def _event(self):
        import torch
        if not self.cuda:
            return None
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def __call__(self, name: str) -> None:
        now = time.perf_counter()
        if name == "loader":
            n = len(self.steps)
            if n == self.n_setup:
                self.ctx.setup_parts["first steps"] = now - self.t_fit
                if self.cuda:
                    import torch
                    torch.cuda.reset_peak_memory_stats()
                self.ctx.window_starts()
                self.deadline = now + self.ctx.seconds
            elif self.deadline is not None and now >= self.deadline:
                self.t_stop = now
                self.finish()
                raise StopWindow
            if self.ctx.trace:
                self._profile(n)
            self.steps.append({})
        if self.steps:
            self.steps[-1][name] = (now, self._event())
        self._span(name)

    def _span(self, name):
        if self.prof is None:
            return
        import torch
        while self._spans:
            self._spans.pop().__exit__(None, None, None)
        if name is not None and name != "done":
            span = torch.profiler.record_function(name)
            span.__enter__()
            self._spans.append(span)

    def finish(self) -> None:
        """Close the open span and, if it still runs, the profiler."""
        self._span(None)
        if self.prof is not None:
            self._stop()

    def _stop(self) -> None:
        import torch
        if self.cuda:
            torch.cuda.synchronize()
        self._window.__exit__(None, None, None)
        self.prof.stop()
        self._stopped, self.prof = self.prof, None

    def read_trace(self) -> None:
        """The stopped profiler's :class:`Trace`, read once the window has
        closed: exporting and parsing it takes seconds that are no step's."""
        if self._stopped is not None:
            self.trace = from_profiler(self._stopped,
                                       self.ctx.work / "trace.json")
            self._stopped = None

    def _profile(self, n: int) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile
        first = self.n_setup + 1
        last = first + int(self.ctx.traffic["trace_steps"])
        if n == first:
            acts = [ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if self.cuda else [])
            self.prof = profile(activities=acts)
            self.prof.start()
            self._window = torch.profiler.record_function("perfbench.window")
            self._window.__enter__()
        elif n == last and self.prof is not None:
            self._span(None)
            self._stop()


def run(ctx) -> Dict:
    import torch

    cfg, trf = ctx.config, ctx.traffic
    dev = torch.device(ctx.device)
    cuda = dev.type == "cuda"
    n_check = int(trf["check_steps"])
    trainer, params, archive, written = build(ctx, ctx.seed)
    cap = Capture(trainer, n_check)
    marks = Marks(ctx, n_check, cuda)
    trainer.step_mark = marks
    try:
        trainer.fit()
        raise RuntimeError("the epoch ended inside the window: raise the "
                           "traffic's num_samples")
    except StopWindow:
        pass
    if cuda:
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    marks.read_trace()
    b = int(cfg["batch_per_rank"])
    measured = marks.steps[n_check:]
    bounds = [s["loader"][0] for s in measured] + [marks.t_stop]
    durations = win.step_times(bounds)
    phases = _phase_ms(measured, cuda)
    labels = {k: np.asarray(v) for k, v in (
        ("cle", trf["cle_labels"]), ("pse", trf["pse_labels"]))}
    trainer.close()
    del trainer
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    got = follow(cfg, cap, params, archive, labels, dev)
    ctx.log(f"readings: {got}")
    checks = {k: {"value": float(got[k]), "limit": float(v)}
              for k, v in ctx.limits.items()}
    shutil.rmtree(ctx.work, ignore_errors=True)
    steps = len(durations)
    ctx.log(f"{steps} steps; step ms p10 / p50 / p90 / max "
            + " / ".join(f"{1e3 * win.percentile(durations, q):.1f}"
                         for q in (10, 50, 90, 100))
            + "; phase ms " + ", ".join(f"{k} {v:.1f}"
                                        for k, v in phases.items()))
    step_flops = flops.model_flops(cfg["arch"], (1, 1, *cfg["input_size"]),
                                   True) * b
    rec = {
        "e2e": {"volumes_per_s": win.steps_rate(bounds, b),
                "step_ms_p90": 1e3 * win.percentile(durations, 90),
                "peak_mem_gib": peak / 2 ** 30, "setup_s": ctx.setup_s},
        "checks": checks, "attempted": steps * b, "failed": 0,
        "device": {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                   "count": ctx.chips, "memory_peak_bytes": int(peak)},
        "train": {"steps": steps, "phase_ms": phases,
                  "step_ms": [1e3 * d for d in durations]},
        "window_s": bounds[-1] - bounds[0], "peaks": ctx.peaks(),
        "useful_flops": step_flops * steps,
        "bytes_written_inputs": written,
    }
    if marks.trace is not None:
        tr = marks.trace
        rec["trace"] = tr
        rec["device"].update(busy_s=tr.busy_s, window_s=tr.window_s)
        rec["breakdown"] = {"device_ops": tr.top_ops(),
                            "idle_gaps": tr.idle_gaps()}
        rec["conv_patterns"] = ctx.kernel_patterns("conv")
        rec["nccl_patterns"] = ctx.kernel_patterns("nccl")
        rec["traced_steps"] = int(trf["trace_steps"])
        rec["traced_conv_ops"] = flops.conv_ops(
            cfg["arch"], (b, 1, *cfg["input_size"]), True) * int(
            trf["trace_steps"])
    return rec


def _phase_ms(steps: List[Dict], cuda: bool) -> Dict[str, float]:
    """Mean milliseconds per step of each phase: ``loader`` on the host
    clock (the fetch to the next mark), the others between CUDA events
    (host clocks on the CPU)."""
    out = {p: 0.0 for p in PHASES}
    n = 0
    for s in steps:
        names = [k for k in ("loader", *PHASES[1:], "done") if k in s]
        if "done" not in names:
            continue
        n += 1
        for a, b in zip(names, names[1:]):
            ta, ea = s[a]
            tb, eb = s[b]
            if a == "loader" or not cuda:
                out[a] += 1e3 * (tb - ta)
            else:
                out[a] += ea.elapsed_time(eb)
    return {k: v / max(n, 1) for k, v in out.items()}


def _leaf_gaps(prog: Dict, ref: Dict) -> Dict[str, float]:
    """Each leaf's |norm(program) - norm(reference)| over the larger of the
    reference leaf's norm and the median leaf's."""
    import torch
    norms = {k: float(torch.linalg.vector_norm(ref[k].double()))
             for k in ref}
    med = float(np.median(list(norms.values())))
    return {k: abs(float(torch.linalg.vector_norm(prog[k].double()))
                   - norms[k]) / max(norms[k], med, 1e-30) for k in ref}


def reference_steps(cfg, cap, params, labels, dev, prec="f32", rows=None):
    """The reference's losses, first gradient and parameters after the
    captured steps, on the program's augmented batches (``rows``: only
    those rows of each batch)."""
    import torch
    p = {k: v.to(dev).clone() for k, v in params.items()}
    leaves = {k: v.requires_grad_(True) for k, v in p.items()
              if not k.endswith(("running_mean", "running_var",
                                 "num_batches_tracked"))}
    cw = [torch.as_tensor(ref_train.class_weights(labels[k], n),
                          dtype=torch.float32, device=dev)
          for k, n in (("cle", 6), ("pse", 3))]
    opt = ref_train.Adam(leaves)
    out_losses, grad1, maps1 = [], None, None
    with ref_model.strict_float32():
        for i in range(len(cap.labels)):
            images, lungs, ems = (t.to(dev) for t in cap.augmented[i]["out"])
            cle, pse = (t.to(dev).long() for t in cap.labels[i])
            if rows is not None:
                images, lungs, ems, cle, pse = (t[rows] for t in (
                    images, lungs, ems, cle, pse))
            losses, grads, dense = ref_train.step(
                p, cfg["arch"], images, lungs, ems, cle, pse, *cw, prec=prec)
            if grad1 is None:
                grad1 = {k: g.cpu() for k, g in grads.items()}
                # NDHWC, as the program's
                maps1 = [d[:, 0, ..., None].cpu() for d in dense]
            opt.update(leaves, grads, cap.lr[i])
            out_losses.append(losses["loss"])
    return (out_losses, grad1, {k: v.detach().cpu() for k, v in
                                leaves.items()}, maps1)


def compare_steps(cap_losses, cap_grad1, cap_params, cap_maps, ref,
                  params) -> Dict:
    """The step numbers of one side against the reference ``ref`` (losses,
    first gradient, parameters after the steps, the first step's maps):
    ``map_gap``, the first step's dense maps' mean |difference|, its
    99.9th percentile (every 7th voxel) and largest, and ``map_over``, the
    share of their voxels off by more than 0.005;
    ``loss_gap_step1`` and ``loss_gap`` (the worst step), relative;
    ``grad_gap`` and ``update_gap`` by the worst leaf (and by the median
    leaf)."""
    import torch
    ref_losses, ref_grad1, ref_params, ref_maps = ref
    # a side that ran fewer rows is held to the reference's same rows
    diff = torch.cat([(a.float() - b[:len(a)].float()).abs().flatten()
                      for a, b in zip(cap_maps, ref_maps)])
    loss_gaps = [abs(a - b) / max(abs(b), 1e-30)
                 for a, b in zip(cap_losses, ref_losses)]
    grads = _leaf_gaps(cap_grad1, ref_grad1)
    # leaves whose reference gradient is nought to rounding move by
    # round-off alone under Adam: a thousandth of the median leaf's norm
    gnorm = {k: float(torch.linalg.vector_norm(g.double()))
             for k, g in ref_grad1.items()}
    med = float(np.median(list(gnorm.values())))
    keep = {k for k, v in gnorm.items() if v >= 1e-3 * med}
    updates = _leaf_gaps({k: cap_params[k] - params[k] for k in keep},
                         {k: ref_params[k] - params[k] for k in keep})
    worst_g = max(grads, key=grads.get)
    worst_u = max(updates, key=updates.get)
    return {"map_gap": float(diff.mean()),
            "map_p999": float(torch.quantile(diff[::7].double(), 0.999)),
            "map_max": float(diff.max()),
            "map_over": float((diff > 0.005).float().mean()),
            "loss_gap": max(loss_gaps), "loss_gap_step1": loss_gaps[0],
            "grad_gap": grads[worst_g],
            "grad_gap_median": float(np.median(list(grads.values()))),
            "update_gap": updates[worst_u],
            "update_gap_median": float(np.median(list(updates.values()))),
            "worst_grad_leaf": worst_g, "worst_update_leaf": worst_u}


def check_inputs(cfg, cap, archive, dev) -> Dict:
    """start_gap / start_masks: the step's preprocessed inputs (the
    loader's, or the device pipeline's) against the reference's preprocess
    of the same archive rows; aug_gap / aug_masks: the augmentation
    against the reference's on the same inputs and draws."""
    import torch
    target = tuple(cfg["input_size"])
    start_gap = aug_gap = 0.0
    start_masks = aug_masks = 0
    uids = [line.split(",")[0] for line in
            (archive / "train.csv").read_text().splitlines()[1:]]
    for i, pre in enumerate(cap.pre):
        pre = [t.to(dev) for t in pre]
        for r, row in enumerate(cap.rows[i]):
            with np.load(archive / f"{uids[int(row)]}.npz") as z:
                img = torch.from_numpy(z["image"]).to(dev)
                lung = torch.from_numpy(z["lung_mask"]).to(dev)
            ref = ref_train.preprocess(img, lung, target)
            start_gap = max(start_gap, float(
                (pre[0][r] - ref["image"]).abs().max()))
            start_masks += int((pre[1][r] != ref["lung"]).sum())
            start_masks += int((pre[2][r] != ref["em"]).sum())
        aug = cap.augmented[i]
        draws = {k: v.to(dev) for k, v in aug["draws"].items()}
        mask_size = aug["mask_out"] or target
        images, lungs, ems = ref_train.augment(*pre, draws, mask_size)
        out = [t.to(dev) for t in aug["out"]]
        aug_gap = max(aug_gap, float((out[0] - images).abs().max()))
        aug_masks += int((out[1] != lungs).sum()) + int(
            (out[2] != ems).sum())
    return {"start_gap": start_gap, "start_masks": float(start_masks),
            "aug_gap": aug_gap, "aug_masks": float(aug_masks)}


def follow(cfg, cap, params, archive, labels, dev) -> Dict:
    got = check_inputs(cfg, cap, archive, dev)
    ref = reference_steps(cfg, cap, params, labels, dev)
    got.update(compare_steps([l["loss"] for l in cap.losses], cap.grad1,
                             cap.params, cap.maps1, ref, params))
    return got
