"""Data parallelism of the port on the CPU: two gloo ranks against one
process and against the JAX step under a ``data=2`` mesh.

The rank code is this file's ``__main__``: the tests start it as a script,
one process per rank, with torchrun's environment (as
``tests/test_multiprocess.py`` starts ``tests/mp_worker.py``); one pair of
ranks runs every case below and saves what it saw for the tests to read.

- **The differentiable sum**: on rank r, ``all_sum(x_r) * (r + 1)``
  backpropagates ``1 + 2 = 3`` into ``x_r`` on both ranks: the backward
  sums the incoming gradients over the ranks (the port's own
  ``autograd.Function``, ``parallel/mesh.py``).
- **Train steps**: ``med3ddramtiny`` (reg) and ``med3dtiny`` (CLS), float32,
  16x24x32, two Adam steps at lr 1e-5 under DDP, each rank holding one row
  of a batch of 2, ``num_data_shards=2``.  Each step is compared from the
  same state: the first from the initial weights, the second from the
  ranks' state after the first (the one process rebuilds it by Adam on
  the ranks' first gradients; the ranks' parameter digests pin the
  rebuild bit for bit).  Both ranks hold the same gradients, running
  statistics and parameters, byte for byte.
  - against one process at B=2 with ``num_data_shards=2``, augmentation on
    (each row draws from its global row's generator) and off: the loss
    and its components rtol 1e-5; every gradient (DDP's mean) rtol 1e-4,
    atol 1e-6 plus 1e-4 of the tensor's peak; the running statistics rtol
    1e-5, atol 1e-6; the labels equal;
  - against the JAX step (augmentation off) under a ``data=2`` mesh of
    conftest's virtual devices, in ``test_torch_train_step.py``'s bounds:
    loss and components rtol 1e-5 (coverage term and total 5e-5,
    ``SEG_RTOL``), gradients rtol 1e-4, atol 1e-6 plus 3e-3 of the peak
    (``GRAD_PEAK_ATOL``; the CLS decoder biases that feed a train BN: the
    bound of their conv's weight gradient, as ``test_torch_cls_train.py``
    holds them), running statistics rtol 1e-5, atol 1e-6; the labels
    equal.  The port's side is the one process, which the ranks equal;
  - the parameters after each step: within ``2.1 * lr`` (Adam moves an
    element whose gradient lies within float noise of zero by about lr
    either way, the bound of ``tests/test_parallel.py::
    test_dp_matches_single_device``), and within 1e-6 relative plus ``0.1 *
    lr`` wherever the step's gradient is resolved (at least 1e-2 of its
    tensor's peak, not a decoder bias that feeds a train BN).
  - ReLU ties: an input within ``TIE`` (1e-5) of zero falls on either side
    by rounding, and a flip changes its stage's weight gradient by up to
    1e-2 of the peak in one output channel and every tensor upstream by
    1e-3 (measured: reg against JAX, one voxel of us2's first stage at
    2.6e-6; CLS with augmentation, two ranks against one process, one at
    7.5e-7 in the first step and one at 1.3e-6 in the second).  Where a
    step misses its bounds, the one process is rerun with the derivative
    flipped at one such input at a time (the smallest ``MAX_TIE_TRIALS``
    first; the values stay as they are), and the step passes if one flip
    brings it inside every bound.
- **Remat**: the reg case without augmentation once more under
  ``remat="all"`` (activation checkpointing: train BN's ``all_sum`` is
  issued again in the backward): on each rank bit-equal to its run
  without remat.
- **Eval epoch**: ``SubtypeTrainer.evaluate`` of a 5-scan test set (odd,
  so both ranks pad by wrap-around) on two ranks: rank 0's gathered,
  de-duplicated CSV and metrics equal one process's; rank 1 returns
  ``{}``.
- **CLI**: ``--ngpus 2 --device cpu`` trains one epoch on two ranks;
  rank 0 alone writes the checkpoint, the CSVs, ``metrics.jsonl`` (one
  line per phase) and one TensorBoard event file; the evaluation entry
  point with ``--ngpus 2`` on that checkpoint writes the same test CSV
  and one more ``metrics.jsonl`` line.
- ``parse_mesh`` equals the JAX package's.
"""
import copy
import hashlib
import json
import os
import re
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
SHAPE = (16, 24, 32)
LR = 1e-5
STEPS = 2
CW_CLE = np.asarray([0.2, 0.25, 0.15, 0.2, 0.1, 0.1], np.float32)
CW_PSE = np.asarray([0.3, 0.5, 0.2], np.float32)
ARCH = {"reg": "med3ddramtiny", "cls": "med3dtiny"}
CASES = [(kind, augment) for kind in ("reg", "cls")
         for augment in (True, False)]
TIE = 1e-5              # a ReLU input this close to zero is a tie
MAX_TIE_TRIALS = 8
# the decoder conv biases that feed a train BatchNorm, which removes them
PRE_BN_BIAS = re.compile(r"us[12]\.conv_blocks\.\d\.0\.bias|us3\.0\.bias")


def _sha(tensors):
    """The sha1 of each tensor's bytes."""
    return {n: hashlib.sha1(t.detach().contiguous().numpy().tobytes())
            .hexdigest() for n, t in tensors.items()}


def _params(model):
    return {n: p.detach().clone() for n, p in model.named_parameters()}


def _adam_step(model, opt, grads):
    """One step of ``opt`` on ``model`` with the given gradients."""
    for n, p in model.named_parameters():
        p.grad = grads[n].clone()
    opt.step()


class _ReluTies:
    """``torch.relu`` that records its inputs within ``TIE`` of zero as
    ``(call, flat index, |x|)`` and takes the derivative from the other
    side at the ``(call, flat index)`` pairs of ``flips`` (the values stay
    as they are)."""

    def __init__(self, flips=()):
        self.flips = dict(flips)
        self.near, self.calls = [], 0

    def __enter__(self):
        self.relu, torch.relu = torch.relu, self
        return self

    def __exit__(self, *exc):
        torch.relu = self.relu

    def __call__(self, x):
        call, self.calls = self.calls, self.calls + 1
        flat = x.detach().reshape(-1)
        self.near += [(call, int(i), abs(float(flat[i])))
                      for i in (flat.abs() < TIE).nonzero().reshape(-1)]
        y = self.relu(x)
        if call not in self.flips:
            return y
        i = self.flips[call]
        mask = torch.zeros(flat.numel(), dtype=torch.bool)
        mask[i] = True
        xd = x.detach()
        other = xd.clamp(min=0) if flat[i] > 0 else x - xd
        return torch.where(mask.reshape(x.shape), other, y)


def run_steps(module, model, kind, batch, augment, shards, ranks=None,
              flips=None):
    """``STEPS`` Adam steps of ``kind``'s train step on ``module``
    (``model`` or its DDP wrapper).  Per step: the metrics, the labels,
    the running statistics after it, the gradients and the parameters
    after it.

    ``ranks`` (one process): the ranks' per-step records.  The second step
    then starts from the ranks' state: the initial weights with the ranks'
    first running statistics, and one Adam step on their first gradients
    (``ranks_state``); each step also rebuilds the ranks' parameters after
    it by Adam on their gradients (``ranks_params``), which the ranks'
    digests pin bit for bit.  ``flips``: per step, the ReLU ties to flip
    (:class:`_ReluTies`); each step records its ties as ``near``."""
    from bodyct_dram_emph_subtype_tpu_torch.train.state import make_optimizer
    from bodyct_dram_emph_subtype_tpu_torch.train.steps import (
        make_cls_train_step, make_reg_train_step)
    make = make_reg_train_step if kind == "reg" else make_cls_train_step
    opt = make_optimizer(model.parameters(), LR)
    step = make(module, opt, num_data_shards=shards, augment=augment)
    init = copy.deepcopy(model.state_dict())
    out = []
    for s in range(STEPS):
        rec = {}
        if ranks is not None and s == 1:
            model.load_state_dict({**init, **ranks[0]["buffers"]})
            opt.state.clear()
            _adam_step(model, opt, ranks[0]["grads"])
            out[0]["ranks_params"] = _params(model)
            out[0]["ranks_state"] = {
                "model": copy.deepcopy(model.state_dict()),
                "optimizer": copy.deepcopy(opt.state_dict())}
        if ranks is not None:
            twin = copy.deepcopy(model)
            twin_opt = make_optimizer(twin.parameters(), LR)
            twin_opt.load_state_dict(copy.deepcopy(opt.state_dict()))
            _adam_step(twin, twin_opt, ranks[s]["grads"])
            rec["ranks_params"] = _params(twin)
            del twin, twin_opt
        gen = torch.Generator().manual_seed(100 + s)
        with _ReluTies((flips or {}).get(s, ())) as ties:
            metrics, preds = step(batch, LR, CW_CLE, CW_PSE, generator=gen)
        rec.update({
            "near": sorted(ties.near, key=lambda t: t[2]),
            "metrics": {k: float(v) for k, v in metrics.items()},
            "preds": {k: v.clone() for k, v in preds.items()},
            "buffers": {n: b.clone() for n, b in model.named_buffers()},
            "grads": {n: p.grad.clone() for n, p in model.named_parameters()},
            "params": _params(model)})
        out.append(rec)
    return out


def _rank_main(work: Path) -> None:
    """One rank: the differentiable sum, the DDP train steps of
    ``steps.pt``, the eval epoch of ``eval.json``; saves ``rank<r>.pt``."""
    torch.set_num_threads(2)
    from bodyct_dram_emph_subtype_tpu_torch.models.registry import \
        get_model_by_name
    from bodyct_dram_emph_subtype_tpu_torch.parallel.mesh import (
        all_sum, init_distributed, rank, shutdown)
    from bodyct_dram_emph_subtype_tpu_torch.train.loop import (
        SubtypeTrainer, TrainerConfig)
    init_distributed("cpu")
    r = rank()
    x = torch.tensor([float(r + 1)], requires_grad=True)
    y = all_sum(x)
    (y * (r + 1)).sum().backward()
    results = {"all_sum": (y.item(), x.grad.item())}
    spec = torch.load(work / "steps.pt", weights_only=False)
    for kind, augment in CASES:
        model = get_model_by_name(ARCH[kind], packed_decoder=True)
        model.load_state_dict(spec[kind]["weights"])
        ddp = torch.nn.parallel.DistributedDataParallel(
            model, broadcast_buffers=False)
        rows = {k: v[r:r + 1] for k, v in spec[kind]["batch"].items()}
        steps = run_steps(ddp, model, kind, rows, augment, shards=2)
        for rec in steps:   # rank 0's gradients in full, digests otherwise
            rec["params"] = _sha(rec["params"])
            rec["grad_sha"] = _sha(rec["grads"])
            if r:
                del rec["grads"]
        results[(kind, augment)] = steps
    # the reg case without augmentation again under remat "all"
    model = get_model_by_name(ARCH["reg"], packed_decoder=True, remat="all")
    model.load_state_dict(spec["reg"]["weights"])
    ddp = torch.nn.parallel.DistributedDataParallel(
        model, broadcast_buffers=False)
    rows = {k: v[r:r + 1] for k, v in spec["reg"]["batch"].items()}
    results["remat"] = [
        {"metrics": rec["metrics"], "preds": rec["preds"],
         "grad_sha": _sha(rec["grads"]), "params": _sha(rec["params"]),
         "buffers": _sha(rec["buffers"])}
        for rec in run_steps(ddp, model, "reg", rows, False, shards=2)]
    cfg = json.loads((work / "eval.json").read_text())
    trainer = SubtypeTrainer(TrainerConfig(**cfg))
    results["eval"] = trainer.evaluate("test", epoch=0)
    torch.save(results, work / f"rank{r}.pt")
    shutdown()


# ----------------------------------------------------------------- the tests
def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _launch(work: Path, world: int = 2):
    port = str(_free_port())
    procs = []
    for r in range(world):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(world),
                   LOCAL_RANK=str(r), MASTER_ADDR="localhost",
                   MASTER_PORT=port, PYTHONPATH=str(REPO))
        procs.append(subprocess.Popen(
            [sys.executable, __file__, str(work)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=300)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out[-4000:]}"
    out = []
    for r in range(world):      # read once: the files are large
        out.append(torch.load(work / f"rank{r}.pt", weights_only=False))
        (work / f"rank{r}.pt").unlink()
    return out


def _variables(kind):
    import functools

    import jax
    import jax.numpy as jnp

    from bodyct_dram_emph_subtype_tpu.models import \
        get_model_by_name as jax_model
    model = jax_model(ARCH[kind], packed_decoder=True)
    x0 = jnp.zeros((1, *SHAPE, 1), jnp.float32)
    init = jax.jit(functools.partial(model.init, train=False))
    variables = jax.tree.map(np.asarray, dict(init(
        jax.random.PRNGKey(3 if kind == "reg" else 5), x0, x0)))
    if kind == "reg":   # as test_torch_train_step.py: both maps near 0.2
        for i in range(2):
            fc = variables["params"][f"fc{i}"]
            fc["kernel"] = fc["kernel"] * np.float32(0.05)
            fc["bias"] = np.full_like(fc["bias"], -1.5)
    return model, variables


def _batch(kind):
    rng = np.random.RandomState(0 if kind == "reg" else 8)
    return {
        "image": rng.randn(2, *SHAPE).astype(np.float32),
        "lung_mask": (rng.rand(2, *SHAPE) > 0.3).astype(np.float32),
        "em_mask": (rng.rand(2, *SHAPE) > 0.8).astype(np.float32),
        "cls_label": np.asarray([3, 0] if kind == "reg" else [3, 5],
                                np.int32),
        "pse_label": np.asarray([1, 2], np.int32),
    }


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The inputs, the two ranks' results, and one process's eval."""
    from bodyct_dram_emph_subtype_tpu_torch.models.torch_import import \
        state_dict_from_jax
    from bodyct_dram_emph_subtype_tpu_torch.train.loop import (
        SubtypeTrainer, TrainerConfig)
    from tests.test_data import make_training_archive
    work = tmp_path_factory.mktemp("ddp")
    spec, jax_side = {}, {}
    for kind in ("reg", "cls"):
        model, variables = _variables(kind)
        spec[kind] = {"weights": state_dict_from_jax(variables),
                      "batch": _batch(kind)}
        jax_side[kind] = (model, variables)
    torch.save(spec, work / "steps.pt")
    archive = work / "archive"
    archive.mkdir()
    uids = make_training_archive(archive, n=6, shape=(16, 20, 24))
    header = ("SeriesInstanceUID,CT_Visual_Emph_Severity_P1,"
              "CT_Visual_Emph_Paraseptal_P1")
    (archive / "test.csv").write_text("\n".join(
        [header] + [f"{u},{i % 6},{i % 3}" for i, u in enumerate(uids[:5])])
        + "\n")
    cfg = {"model_arch": "med3ddramtiny", "batch_size": 2,
           "target_size": list(SHAPE), "workers": 1,
           "data_path": str(archive), "test_csv": str(archive / "test.csv"),
           "model_path": str(work / "ranks"), "seed": 4, "device": "cpu"}
    (work / "eval.json").write_text(json.dumps(cfg))
    ranks = _launch(work)
    one = SubtypeTrainer(TrainerConfig(**dict(
        cfg, model_path=str(work / "single"))))
    return {"work": work, "ranks": ranks, "jax": jax_side, "spec": spec,
            "single_eval": one.evaluate("test", epoch=0)}


def _one_process(world, kind, augment, flips=None):
    """The one process at B=2 (``run_steps`` with the ranks' records)."""
    from bodyct_dram_emph_subtype_tpu_torch.models.registry import \
        get_model_by_name
    model = get_model_by_name(ARCH[kind], packed_decoder=True)
    model.load_state_dict(world["spec"][kind]["weights"])
    return run_steps(model, model, kind, world["spec"][kind]["batch"],
                     augment, shards=2,
                     ranks=world["ranks"][0][(kind, augment)], flips=flips)


def _passing(check, run, recs):
    """The one process's records ``recs`` (of ``run({})``) if
    ``check(recs, s)`` passes for every step ``s``; where a step fails,
    those of ``run(flips)`` with the derivative flipped at one ReLU tie of
    that step (:class:`_ReluTies`, the smallest first, at most
    ``MAX_TIE_TRIALS``) that passes; re-raises the step's failure if no
    single flip does."""
    flips = {}
    for s in range(STEPS):
        try:
            check(recs, s)
            continue
        except AssertionError as exc:
            failure = exc
        for call, i, _ in recs[s]["near"][:MAX_TIE_TRIALS]:
            trial = run({**flips, s: {call: i}})
            try:
                check(trial, s)
            except AssertionError:
                continue
            flips[s], recs = {call: i}, trial
            break
        else:
            raise failure
    return recs


def test_all_sum_backward_sums_over_ranks(world):
    assert [r["all_sum"] for r in world["ranks"]] == [(3.0, 3.0),
                                                      (3.0, 3.0)]


def _assert_params_close(got, want, grads, step):
    """The parameters after one Adam step from the same state: each within
    ``2.1 * lr`` of ``want`` (Adam moves an element whose gradient lies
    within float noise of zero by about lr either way), and
    within 1e-6 relative plus ``0.1 * lr`` where the step's gradient is
    resolved (at least 1e-2 of its tensor's peak, and not a decoder bias
    that feeds a train BN)."""
    for n, w in want.items():
        w = np.asarray(w)
        g = np.abs(np.asarray(grads[n]))
        d = np.abs(np.asarray(got[n]) - w)
        assert d.max() <= 2.1 * LR, (step, n, d.max() / LR)
        if PRE_BN_BIAS.fullmatch(n):
            continue
        resolved = g >= 1e-2 * g.max()
        excess = d - 1e-6 * np.abs(w) - 0.1 * LR
        assert excess[resolved].max(initial=-1.0) <= 0, \
            (step, n, d[resolved].max() / LR)


def _rows(ranks, case, s, k):
    return torch.cat([r[case][s]["preds"][k] for r in ranks]).numpy()


def _assert_ranks_replicas(ranks, case, one):
    """Both ranks hold the same gradients, running statistics and
    parameters after each step, and the parameters are those that Adam
    makes of the gradients (rebuilt in ``one``)."""
    for s, want in enumerate(one):
        got = [r[case][s] for r in ranks]
        assert got[1]["grad_sha"] == got[0]["grad_sha"] == \
            _sha(got[0]["grads"]), s
        assert got[1]["params"] == got[0]["params"] == \
            _sha(want["ranks_params"]), s
        for n, b in got[0]["buffers"].items():
            assert torch.equal(got[1]["buffers"][n], b), (s, n)


@pytest.mark.parametrize("kind,augment", CASES)
def test_two_ranks_equal_one_process(world, kind, augment):
    """Each step from the same state: the first from the initial weights,
    the second from the ranks' state after the first."""
    ranks, case = world["ranks"], (kind, augment)

    def check(one, s):
        want, got = one[s], ranks[0][case][s]
        for r in ranks:
            for k, v in want["metrics"].items():
                np.testing.assert_allclose(r[case][s]["metrics"][k], v,
                                           rtol=1e-5, err_msg=f"{s} {k}")
        for n, g in want["grads"].items():
            g = g.numpy()
            np.testing.assert_allclose(
                got["grads"][n].numpy(), g, rtol=1e-4,
                atol=1e-6 + 1e-4 * np.abs(g).max(), err_msg=f"{s} {n}")
        for n, b in want["buffers"].items():
            np.testing.assert_allclose(got["buffers"][n].numpy(), b.numpy(),
                                       rtol=1e-5, atol=1e-6,
                                       err_msg=f"{s} {n}")
        _assert_params_close(want["ranks_params"], want["params"],
                             want["grads"], s)
        for k, v in want["preds"].items():
            np.testing.assert_array_equal(_rows(ranks, case, s, k),
                                          v.numpy(), err_msg=f"{s} {k}")

    one = _one_process(world, kind, augment)
    _assert_ranks_replicas(ranks, case, one)
    _passing(check, lambda flips: _one_process(world, kind, augment, flips),
             one)


def test_two_ranks_remat_all_equal_no_remat(world):
    """Each rank's two steps under ``remat="all"`` equal its steps without
    remat bit for bit: losses, labels, gradients, parameters and
    BatchNorm buffers (train BN's ``all_sum`` runs again in the recompute,
    between DDP's gradient buckets, in the same order on both ranks)."""
    for r in world["ranks"]:
        for got, want in zip(r["remat"], r[("reg", False)]):
            assert got["metrics"] == want["metrics"]
            for k, v in want["preds"].items():
                assert torch.equal(got["preds"][k], v), k
            assert got["grad_sha"] == want["grad_sha"]
            assert got["params"] == want["params"]
            assert got["buffers"] == _sha(want["buffers"])


def _adam_keeping_grads():
    """optax Adam whose state also keeps the last gradient."""
    import jax
    import jax.numpy as jnp
    import optax
    adam = optax.scale_by_adam(b1=0.9, b2=0.999, eps=1e-8)

    def update(g, state, params=None):
        u, a = adam.update(g, state[0], params)
        return u, (a, g)

    return optax.GradientTransformation(
        lambda p: (adam.init(p), jax.tree.map(jnp.zeros_like, p)), update)


def _jax_state(torch_state, kind, variables, tx):
    """The JAX ``TrainState`` of the ranks' model and Adam state after the
    first step (``_adam_keeping_grads``'s state)."""
    import jax
    import jax.numpy as jnp
    import optax

    from bodyct_dram_emph_subtype_tpu.models.torch_import import \
        convert_state_dict
    from bodyct_dram_emph_subtype_tpu.train.state import TrainState
    from bodyct_dram_emph_subtype_tpu_torch.models.registry import \
        get_model_by_name
    names = [n for n, _ in get_model_by_name(
        ARCH[kind], packed_decoder=True).named_parameters()]

    def tree(state_dict, coll="params"):
        out, report = convert_state_dict(
            {k: v.numpy() for k, v in state_dict.items()}, variables)
        assert report["shape_mismatch"] == report["unexpected"] == 0
        return out if coll is None else out[coll]

    v = tree(torch_state["model"], None)
    opt = torch_state["optimizer"]["state"]
    mu = tree({names[i]: st["exp_avg"] for i, st in opt.items()})
    nu = tree({names[i]: st["exp_avg_sq"] for i, st in opt.items()})
    adam = optax.ScaleByAdamState(
        count=jnp.asarray(int(opt[0]["step"]), jnp.int32), mu=mu, nu=nu)
    return TrainState(params=v["params"], batch_stats=v["batch_stats"],
                      opt_state=(adam, jax.tree.map(jnp.zeros_like, mu)),
                      step=jnp.ones((), jnp.int32),
                      epoch=jnp.zeros((), jnp.int32))


@pytest.mark.parametrize("kind", ["reg", "cls"])
def test_two_ranks_equal_jax_data_mesh(world, kind):
    """Each JAX step on a ``data=2`` mesh from the ranks' state before it
    (the initial weights, then the ranks' model and Adam state after the
    first step) against the one process's from the same state."""
    import jax
    import jax.numpy as jnp

    from bodyct_dram_emph_subtype_tpu.parallel.mesh import (MeshSpec,
                                                            get_mesh,
                                                            shard_batch)
    from bodyct_dram_emph_subtype_tpu.train.state import TrainState
    from bodyct_dram_emph_subtype_tpu.train.steps import (
        make_cls_train_step, make_reg_train_step)
    from bodyct_dram_emph_subtype_tpu_torch.models.torch_import import \
        flax_path_to_torch_key
    from tests.test_torch_train_step import (GRAD_PEAK_ATOL, SEG_RTOL,
                                             _flat, _to_torch_layout)
    model, variables = world["jax"][kind]
    tx = _adam_keeping_grads()
    make = make_reg_train_step if kind == "reg" else make_cls_train_step
    step = make(model, tx, num_data_shards=2, augment=False)
    mesh = get_mesh(MeshSpec(data=2), devices=jax.devices()[:2])
    batch = shard_batch(mesh, world["spec"][kind]["batch"])
    one = _one_process(world, kind, False)
    states = [TrainState.create(variables, tx),
              _jax_state(one[0]["ranks_state"], kind, variables, tx)]

    def torch_tree(coll, tree, layout=True):
        return {flax_path_to_torch_key(coll, p):
                _to_torch_layout(v) if layout else v
                for p, v in _flat(jax.tree.map(np.asarray, tree)).items()}

    jax_steps = []
    for state in states:
        with jax.default_matmul_precision("highest"):
            state, m, preds = step(state, batch, jnp.asarray(LR),
                                   jnp.asarray(CW_CLE), jnp.asarray(CW_PSE),
                                   jax.random.PRNGKey(0))
        jax_steps.append({
            "metrics": {k: float(v) for k, v in m.items()},
            "grads": torch_tree("params", state.opt_state[1]),
            "buffers": torch_tree("batch_stats", state.batch_stats, False),
            "params": torch_tree("params", state.params),
            "preds": jax.tree.map(np.asarray, preds)})

    def check(port, s):
        mine, want = port[s], jax_steps[s]
        for k, v in want["metrics"].items():
            np.testing.assert_allclose(
                mine["metrics"][k], v, err_msg=f"{s} {k}",
                rtol=SEG_RTOL if k in ("seg_loss", "loss") else 1e-5)
        assert set(want["grads"]) == set(mine["grads"])
        for key, g in want["grads"].items():
            g_port = mine["grads"][key].numpy()
            if kind == "cls" and PRE_BN_BIAS.fullmatch(key):
                w = want["grads"][key.replace(".bias", ".weight")]
                bound = 1e-6 + GRAD_PEAK_ATOL * np.abs(w).max()
                assert np.abs(g_port).max() <= bound
                assert np.abs(g).max() <= bound
                continue
            np.testing.assert_allclose(
                g_port, g, rtol=1e-4,
                atol=1e-6 + GRAD_PEAK_ATOL * np.abs(g).max(),
                err_msg=f"{s} {key}")
        for key, v in want["buffers"].items():
            np.testing.assert_allclose(mine["buffers"][key].numpy(), v,
                                       rtol=1e-5, atol=1e-6,
                                       err_msg=f"{s} {key}")
        _assert_params_close(mine["params"], want["params"], want["grads"],
                             s)
        for k in ("pred_cle_labels", "pred_pse_labels", "cle_labels",
                  "pse_labels"):
            np.testing.assert_array_equal(mine["preds"][k].numpy(),
                                          want["preds"][k], err_msg=f"{s} {k}")

    _passing(check, lambda flips: _one_process(world, kind, False, flips),
             one)


def test_eval_epoch_gathered_equals_one_process(world):
    work = world["work"]
    assert world["ranks"][1]["eval"] == {}
    got, want = world["ranks"][0]["eval"], world["single_eval"]
    assert set(got) == set(want)
    # JAX's accuracies average the gathered rows, wrap-around duplicates
    # included (JAX loop.py:530-531), which depend on the world size: 8
    # rows on two ranks, 6 on one; the report is over the de-duplicated
    # rows
    acc = {"epoch_test_acc_cle", "epoch_test_acc_pse"}
    assert {k: v for k, v in got.items() if k not in acc} == \
        {k: v for k, v in want.items() if k not in acc}
    csv = "subtyping_med3ddramtiny/predicts/test/0_predicts.csv"
    got = (work / "ranks" / csv).read_text().splitlines()
    assert got == (work / "single" / csv).read_text().splitlines()
    assert len(got) == 1 + 5


def test_cli_ngpus_2_trains_and_rank0_alone_writes(tmp_path):
    from bodyct_dram_emph_subtype_tpu_torch.evaluate.__main__ import \
        main as evaluate_main
    from bodyct_dram_emph_subtype_tpu_torch.train.__main__ import main
    from tests.test_data import make_training_archive
    from tests.test_torch_trainer import _argv
    uids = make_training_archive(tmp_path, n=12, shape=(16, 20, 24))
    header = ("SeriesInstanceUID,CT_Visual_Emph_Severity_P1,"
              "CT_Visual_Emph_Paraseptal_P1")
    # CLE classes 0 and 1 x num_samples 2: one step of B=1 on each rank
    for name, rows in (("train", [i for i in range(12) if i % 6 < 2]),
                       ("test", range(5))):
        (tmp_path / f"{name}.csv").write_text("\n".join(
            [header] + [f"{uids[i]},{i % 6},{i % 3}" for i in rows]) + "\n")
    out = tmp_path / "m"
    argv = _argv(tmp_path, out, 1)
    argv[argv.index("--batch_size") + 1] = "1"
    argv[argv.index("--valid_csv") + 1] = ""
    assert main(argv + ["--ngpus", "2", "--workers", "1"]) == 0
    exp = out / "subtyping_med3ddramtiny"
    assert sorted(p.name for p in (exp / "checkpoints").iterdir()) == \
        ["epoch_0000.pt"]
    lines = [json.loads(line) for line in
             (exp / "metrics.jsonl").read_text().splitlines()]
    assert [e["phase"] for e in lines] == ["train", "test"]
    test_rows = (exp / "predicts" / "test" / "0_predicts.csv").read_text()
    assert len(test_rows.splitlines()) == 1 + 5
    assert len(list((exp / "tb_logs").glob("events.out.tfevents.*"))) == 1
    # the evaluation entry point on two ranks (root test.py's --ngpus)
    assert evaluate_main([
        "--model_arch", "med3ddramtiny", "--ckp", "0", "--data_path",
        str(tmp_path), "--test_csv", str(tmp_path / "test.csv"),
        "--model_path", str(out), "--target_size", "16,24,32",
        "--batch_size", "1", "--workers", "1", "--device", "cpu",
        "--ngpus", "2"]) == {}
    lines = (exp / "metrics.jsonl").read_text().splitlines()
    assert [json.loads(line)["phase"] for line in lines][2:] == ["test"]
    assert (exp / "predicts" / "test" / "0_predicts.csv").read_text() \
        .splitlines() == test_rows.splitlines()


@pytest.mark.parametrize("text", [None, "data=2", "data=1,spatial=2",
                                  "model=2", " data = 4 , model=2 ", "",
                                  "data=2,bogus=1"])
def test_parse_mesh_equals_jax(text):
    from bodyct_dram_emph_subtype_tpu.utils.cli import \
        parse_mesh as jax_parse
    from bodyct_dram_emph_subtype_tpu_torch.parallel.mesh import parse_mesh
    try:
        want = jax_parse(text)
    except ValueError as exc:
        with pytest.raises(ValueError, match="cannot parse mesh axis"):
            parse_mesh(text)
        assert "cannot parse mesh axis" in str(exc)
        return
    got = parse_mesh(text)
    assert (got is None) == (want is None)
    if want is not None:
        assert (got.data, got.spatial, got.model, got.size) == \
            (want.data, want.spatial, want.model, want.size)


if __name__ == "__main__":
    _rank_main(Path(sys.argv[1]))
