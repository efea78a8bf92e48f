"""The mesh's spatial axis and multi-rank gradient accumulation on the CPU:
one launch of four gloo ranks against one process and the JAX package.

The rank code is this file's ``__main__``, started as a script per rank
with torchrun's environment (``tests/test_torch_ddp.py``'s launcher, with
a per-process timeout); the ranks import only torch and the port, and the
parent computes every reference.  Weights are carried from JAX
(``test_torch_ddp.py::_variables``: the reg heads scaled so both maps sit
near 0.2), inputs are drawn from a seed with numpy, float32.

- **Eval forward** of ``med3ddramtiny`` (reg) and ``med3dtiny`` (CLS), the
  packed decoder (so every kernel site of the eval forward: C + A of
  layer1, the decoder's A and the heads' B, each on its plain version
  here), B=2, 16x32x32, under ``spatial=4`` (one row per slab at 1/8
  scale: layer4's dilation-4 halo spans four ranks) and under
  ``data=2,spatial=2`` (one row per data rank).  Against the JAX package's
  unsharded forward at least as tight as JAX's own
  ``tests/test_parallel.py:106`` (regs rtol 1e-4; dense maps rtol 1e-3,
  atol 1e-4), and against the port in one process: regs and pooled
  logits rtol 1e-6, dense maps atol 4e-6 of the map's peak.  Measured:
  ``spatial=4`` bit-equal maps, heads within 1.7e-7; ``data=2,spatial=2``
  (B=1 per rank against B=2: the library orders a conv's sums per shape)
  maps within 1.6e-6 of the peak (CLS logits, peak 15.8), heads 3.8e-7.
- **Train step** at ``data=2,spatial=2`` (reg and CLS, augmentation on and
  off, B=1 per data rank, 16x32x32) against one process at B=2 with
  ``num_data_shards=2``, by ``test_torch_ddp.py``'s method: losses rtol
  1e-5, every gradient (DDP's mean over the replica group) rtol 1e-4,
  atol 1e-6 plus 1e-4 of its peak, the running statistics rtol 1e-5, atol
  1e-6, the labels equal, with its rerun of a step that misses with one
  ReLU tie's derivative flipped.  Every rank holds the same gradients,
  statistics and parameters.
- **An H that does not divide** by 8 x spatial (16x24x32 at ``data=2,
  spatial=2``, JAX ``test_parallel.py:128``): every rank runs the whole
  volume, warns once over two steps, and matches one process as above.
- **Accumulation** at ``data=2,spatial=2`` with ``accum_steps=2``, B=2 per
  data rank (the rows of each micro-batch that ``train/loop.py::
  accum_rows`` deals), reg and CLS with augmentation, against one process
  at B=4 with ``accum_steps=2`` (JAX ``test_train_loop.py:171, :233``),
  by the same method.
- **CLI**: ``--mesh data=2,spatial=2`` trains one epoch and tests (JAX
  ``test_train_loop.py:138``): rank 0 alone writes the checkpoint, the
  CSVs and ``metrics.jsonl``; the test CSV holds each scan once.
- **The model axis**: the eval forward above under ``spatial=2,model=2``
  (JAX ``test_parallel.py:175``), in the same bounds; one train step
  there (reg and CLS, B=2 on every rank) against one process at B=2 by
  the same method, the gradients, statistics and parameters gathered to
  full size.  Augmentation is off there: with it this batch meets two or
  more ReLU ties at once (measured: reg reconciles exactly with two ties
  flipped together, which the one-flip rerun cannot try; CLS needs more;
  ``spatial=2`` alone, on two ranks, shows the same two ties), and the
  augmented steps are held above on the spatial and data axes.  And a
  one-process checkpoint (model and Adam state) loaded into the slices
  and gathered back: equal tensor for tensor, and loadable into one
  process.
"""
import json
import logging
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from bodyct_dram_emph_subtype_tpu_torch.parallel.tensor import full_tensors
from tests.test_torch_ddp import (ARCH, CW_CLE, CW_PSE, LR, MAX_TIE_TRIALS,
                                  _ReluTies, _sha)

REPO = Path(__file__).resolve().parents[1]
WORLD = 4
FWD = (16, 32, 32)
NONDIV = (16, 24, 32)
FORWARD_MESHES = ("spatial=4", "data=2,spatial=2", "spatial=2,model=2")
TRAIN_CASES = [(kind, augment) for kind in ("reg", "cls")
               for augment in (True, False)]
TIMEOUT = 240           # per rank process, seconds


def _batch(kind, shape, n, seed):
    rng = np.random.RandomState(seed + (0 if kind == "reg" else 50))
    return {
        "image": rng.randn(n, *shape).astype(np.float32),
        "lung_mask": (rng.rand(n, *shape) > 0.3).astype(np.float32),
        "em_mask": (rng.rand(n, *shape) > 0.8).astype(np.float32),
        "cls_label": rng.randint(0, 6, n).astype(np.int32),
        "pse_label": rng.randint(0, 3, n).astype(np.int32),
    }


def _model(weights, kind):
    """The weights of ``kind`` in a model, this rank's channel slice on a
    model axis."""
    from bodyct_dram_emph_subtype_tpu_torch.models.registry import \
        get_model_by_name
    from bodyct_dram_emph_subtype_tpu_torch.parallel.tensor import \
        shard_model
    model = shard_model(get_model_by_name(ARCH[kind], packed_decoder=True))
    model.load_state_dict(weights[kind])
    return model


def _forward(model, batch):
    """An eval forward through ``spatial.forward_slabs``: (dense maps,
    heads) as numpy."""
    from bodyct_dram_emph_subtype_tpu_torch.parallel.spatial import \
        forward_slabs
    x = torch.from_numpy(batch["image"])[..., None]
    lungs = torch.from_numpy(batch["lung_mask"])[..., None]
    with torch.inference_mode():
        dense, heads = forward_slabs(model.eval(), x, lungs)
    return ([d.numpy() for d in dense], [h.numpy() for h in heads])


def one_step(module, model, kind, batch, augment, shards, accum=1,
             flips=()):
    """One Adam step of ``kind``'s train step on ``module`` (``model`` or
    its DDP wrapper): metrics, labels, running statistics, gradients,
    parameters after it, and the ReLU ties it met (:class:`_ReluTies`)."""
    from bodyct_dram_emph_subtype_tpu_torch.train.state import make_optimizer
    from bodyct_dram_emph_subtype_tpu_torch.train.steps import (
        make_cls_train_step, make_reg_train_step)
    make = make_reg_train_step if kind == "reg" else make_cls_train_step
    opt = make_optimizer(model.parameters(), LR)
    step = make(module, opt, num_data_shards=shards, augment=augment,
                accum_steps=accum)
    gen = torch.Generator().manual_seed(100)
    with _ReluTies(flips) as ties:
        metrics, preds = step(batch, LR, CW_CLE, CW_PSE, generator=gen)
    return {"near": sorted(ties.near, key=lambda t: t[2]),
            "metrics": {k: float(v) for k, v in metrics.items()},
            "preds": {k: v.clone() for k, v in preds.items()},
            "buffers": full_tensors(model, {
                n: b.clone() for n, b in model.named_buffers()}),
            "grads": full_tensors(model, {
                n: p.grad.clone() for n, p in model.named_parameters()}),
            "params": _sha(full_tensors(model, {
                n: p.detach() for n, p in model.named_parameters()}))}


def _ranks_step(weights, kind, batch, augment, accum=1, shards=2):
    """This rank's step under DDP over the replica group (none where the
    group holds this rank alone)."""
    from bodyct_dram_emph_subtype_tpu_torch.parallel.mesh import group
    model = _model(weights, kind)
    ddp = model if group("replica") is None else \
        torch.nn.parallel.DistributedDataParallel(
            model, broadcast_buffers=False, process_group=group("replica"))
    rec = one_step(ddp, model, kind, batch, augment, shards, accum)
    rec["grad_sha"] = _sha(rec["grads"])
    del rec["near"]
    return rec


def _rank_main(work: Path) -> None:
    torch.set_num_threads(1)
    from bodyct_dram_emph_subtype_tpu_torch.parallel.mesh import (
        coords, init_distributed, parse_mesh, rank, set_mesh)
    init_distributed("cpu")
    r = rank()
    spec = torch.load(work / "spec.pt", weights_only=False)
    weights, out = spec["weights"], {}
    for text in FORWARD_MESHES:
        mesh = set_mesh(parse_mesh(text))
        d, n = coords()[0], 2 // mesh.data
        for kind in ("reg", "cls"):
            rows = {k: v[d * n:(d + 1) * n]
                    for k, v in spec["fwd"][kind].items()}
            out[("forward", text, kind)] = _forward(_model(weights, kind),
                                                    rows)
    set_mesh(parse_mesh("data=2,spatial=2"))
    d = coords()[0]
    for kind, augment in TRAIN_CASES:
        rows = {k: v[d:d + 1] for k, v in spec["train"][kind].items()}
        out[("train", kind, augment)] = _ranks_step(weights, kind, rows,
                                                    augment)
    # an H that does not divide by 8 x spatial: whole volumes, one warning
    records = []
    handler = logging.Handler()
    handler.emit = records.append
    logging.getLogger("bodyct_dram_emph_subtype_tpu_torch").addHandler(
        handler)
    rows = {k: v[d:d + 1] for k, v in spec["nondiv"].items()}
    out["nondiv"] = _ranks_step(weights, "reg", rows, False)
    _ranks_step(weights, "reg", rows, False)
    out["nondiv_warnings"] = sum("does not divide" in h.getMessage()
                                 for h in records)
    # accumulation: rank d holds global rows d and 2 + d of the B=4 batch
    for kind in ("reg", "cls"):
        rows = {k: v[[d, 2 + d]] for k, v in spec["accum"][kind].items()}
        out[("accum", kind)] = _ranks_step(weights, kind, rows, True, 2)
    # the model axis: a train step at spatial=2,model=2 (all rows on every
    # rank), and the full state dict and Adam state through a sliced model
    set_mesh(parse_mesh("spatial=2,model=2"))
    for kind in ("reg", "cls"):
        out[("model", kind)] = _ranks_step(weights, kind, spec["train"][kind],
                                           False, shards=1)
    out["roundtrip"] = _roundtrip(spec["ckpt"])
    for key, rec in out.items():        # rank 0's gradients in full
        if r and isinstance(rec, dict) and "grads" in rec:
            del rec["grads"]
    torch.save(out, work / f"rank{r}.pt")
    # the CLI last: its exit shuts the process group down
    from bodyct_dram_emph_subtype_tpu_torch.train.__main__ import main
    main(json.loads((work / "cli.json").read_text()) + ["--multihost"])


def _roundtrip(ckpt):
    """A one-process checkpoint through a model-axis slice: this rank's
    slices after loading it, and the state gathered back."""
    from bodyct_dram_emph_subtype_tpu_torch.parallel.tensor import (
        full_optimizer_state, full_state_dict, shard_optimizer_state)
    from bodyct_dram_emph_subtype_tpu_torch.train.state import make_optimizer
    model = _model({"reg": ckpt["model"]}, "reg")
    opt = make_optimizer(model.parameters(), LR)
    opt.load_state_dict(shard_optimizer_state(model, ckpt["optimizer"]))
    return {"slices": {k: v.clone() for k, v in model.state_dict().items()},
            "model": full_state_dict(model),
            "optimizer": full_optimizer_state(model, opt)}


# ----------------------------------------------------------------- the tests
def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _launch(work: Path):
    port = str(_free_port())
    procs = []
    for r in range(WORLD):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(WORLD),
                   LOCAL_RANK=str(r), LOCAL_WORLD_SIZE=str(WORLD),
                   MASTER_ADDR="localhost", MASTER_PORT=port,
                   PYTHONPATH=str(REPO))
        procs.append(subprocess.Popen(
            [sys.executable, __file__, str(work)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, text) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{text[-4000:]}"
    return [torch.load(work / f"rank{r}.pt", weights_only=False)
            for r in range(WORLD)]


def _jax_forward(model, variables, batch):
    import jax
    import jax.numpy as jnp
    x = jnp.asarray(batch["image"])[..., None]
    lungs = jnp.asarray(batch["lung_mask"])[..., None]
    with jax.default_matmul_precision("highest"):
        dense, heads = model.apply(variables, x, lungs, train=False)
    return ([np.asarray(d) for d in dense], [np.asarray(h) for h in heads])


def _one_process_ckpt(weights):
    """One process's model state and Adam state after a step on random
    gradients (every moment differs from the next)."""
    from bodyct_dram_emph_subtype_tpu_torch.models.registry import \
        get_model_by_name
    from bodyct_dram_emph_subtype_tpu_torch.train.state import make_optimizer
    model = get_model_by_name(ARCH["reg"], packed_decoder=True)
    model.load_state_dict(weights)
    opt = make_optimizer(model.parameters(), LR)
    gen = torch.Generator().manual_seed(9)
    for p in model.parameters():
        p.grad = torch.randn(p.shape, generator=gen)
    opt.step()
    return {"model": model.state_dict(), "optimizer": opt.state_dict()}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    from bodyct_dram_emph_subtype_tpu_torch.models.torch_import import \
        state_dict_from_jax
    from tests.test_data import make_training_archive
    from tests.test_torch_ddp import _variables
    work = tmp_path_factory.mktemp("mesh")
    jax_side, weights = {}, {}
    for kind in ("reg", "cls"):
        model, variables = _variables(kind)
        jax_side[kind] = (model, variables)
        weights[kind] = state_dict_from_jax(variables)
    spec = {"weights": weights, "ckpt": _one_process_ckpt(weights["reg"]),
            "fwd": {k: _batch(k, FWD, 2, 1) for k in ("reg", "cls")},
            "train": {k: _batch(k, FWD, 2, 2) for k in ("reg", "cls")},
            "nondiv": _batch("reg", NONDIV, 2, 3),
            "accum": {k: _batch(k, FWD, 4, 4) for k in ("reg", "cls")}}
    torch.save(spec, work / "spec.pt")
    archive = work / "archive"
    archive.mkdir()
    uids = make_training_archive(archive, n=6, shape=(16, 20, 24))
    header = ("SeriesInstanceUID,CT_Visual_Emph_Severity_P1,"
              "CT_Visual_Emph_Paraseptal_P1")
    (archive / "test.csv").write_text("\n".join(
        [header] + [f"{u},{i % 6},{i % 3}" for i, u in enumerate(uids[:5])])
        + "\n")
    csv = str(archive / "merged.csv")
    (work / "cli.json").write_text(json.dumps([
        "--model_arch", "med3ddramtiny", "--mesh", "data=2,spatial=2",
        "--batch_size", "1", "--num_samples", "1", "--max_epochs", "1",
        "--target_size", ",".join(map(str, FWD)), "--workers", "1",
        "--data_path", str(archive), "--train_csv", csv, "--valid_csv", "",
        "--test_csv", str(archive / "test.csv"), "--model_path",
        str(work / "cli"), "--sampler_seed", "0", "--device", "cpu"]))
    return {"work": work, "ranks": _launch(work), "spec": spec,
            "jax": jax_side}


def _one_process(ranks, case, flips=()):
    """The one process's step of ``case``: ("train", kind, augment) at B=2
    and ``num_data_shards=2``, "nondiv" likewise, ("accum", kind) at B=4
    with ``accum_steps=2``."""
    spec = ranks["spec"]
    if case == "nondiv":
        kind, batch, augment, accum = "reg", spec["nondiv"], False, 1
    elif case[0] == "train":
        kind, augment, accum = case[1], case[2], 1
        batch = spec["train"][kind]
    elif case[0] == "model":
        kind, augment = case[1], False
        model = _model(spec["weights"], kind)
        return one_step(model, model, kind, spec["train"][kind], augment, 1,
                        1, flips)
    else:
        kind, augment, accum = case[1], True, 2
        batch = spec["accum"][kind]
    model = _model(spec["weights"], kind)
    return one_step(model, model, kind, batch, augment, 2, accum, flips)


def _check_step(got, want, order):
    for k, v in want["metrics"].items():
        np.testing.assert_allclose(got["metrics"][k], v, rtol=1e-5,
                                   err_msg=k)
    for n, g in want["grads"].items():
        g = g.numpy()
        np.testing.assert_allclose(got["grads"][n].numpy(), g, rtol=1e-4,
                                   atol=1e-6 + 1e-4 * np.abs(g).max(),
                                   err_msg=n)
    for n, b in want["buffers"].items():
        np.testing.assert_allclose(got["buffers"][n].numpy(), b.numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=n)
    for k, v in want["preds"].items():
        np.testing.assert_array_equal(order(k), v.numpy()[...], err_msg=k)


def _passing(ranks, case, order):
    """Check rank 0's step against the one process; where it misses, the
    one process again with the derivative flipped at one of its ReLU ties
    at a time (the smallest first): the step passes if one flip brings it
    inside every bound (``test_torch_ddp.py::_passing``)."""
    got = ranks["ranks"][0][case]
    one = _one_process(ranks, case)
    try:
        _check_step(got, one, order)
        return
    except AssertionError as exc:
        failure = exc
    for call, i, _ in one["near"][:MAX_TIE_TRIALS]:
        try:
            _check_step(got, _one_process(ranks, case, {call: i}), order)
            return
        except AssertionError:
            continue
    raise failure


def _replicas(ranks, case):
    """Every rank holds the same gradients, parameters and statistics
    (gathered to full size on a model axis)."""
    recs = [r[case] for r in ranks["ranks"]]
    assert all(x["grad_sha"] == recs[0]["grad_sha"] for x in recs)
    assert all(x["params"] == recs[0]["params"] for x in recs)
    for x in recs[1:]:
        for n, b in recs[0]["buffers"].items():
            assert torch.equal(x["buffers"][n], b), n


@pytest.mark.parametrize("text", FORWARD_MESHES)
@pytest.mark.parametrize("kind", ["reg", "cls"])
def test_forward_on_slabs_equals_unsharded(ranks, text, kind):
    batch = ranks["spec"]["fwd"][kind]
    jmodel, variables = ranks["jax"][kind]
    jdense, jheads = _jax_forward(jmodel, variables, batch)
    dense, heads = _forward(_model(ranks["spec"]["weights"], kind), batch)
    d_width = 2 if text.startswith("data=2") else 1
    for r, rec in enumerate(ranks["ranks"]):
        d = r // (WORLD // d_width)
        rows = slice(d * 2 // d_width, (d + 1) * 2 // d_width)
        got_dense, got_heads = rec[("forward", text, kind)]
        for g, j, p in zip(got_heads, jheads, heads):
            np.testing.assert_allclose(g, j[rows], rtol=1e-4)
            np.testing.assert_allclose(g, p[rows], rtol=1e-6)
        for g, j, p in zip(got_dense, jdense, dense):
            np.testing.assert_allclose(g, j[rows], rtol=1e-3, atol=1e-4)
            np.testing.assert_allclose(g, p[rows], rtol=0,
                                       atol=4e-6 * np.abs(p).max())


def _rows_of(ranks, case, rows_of_rank):
    """The labels of ``case`` over the data ranks (ranks 0 and 2), in the
    one process's row order."""
    def order(k):
        out = np.zeros(sum(len(v) for v in rows_of_rank.values()), np.int64)
        for r, rows in rows_of_rank.items():
            out[rows] = ranks["ranks"][r][case]["preds"][k].numpy()
        return out
    return order


@pytest.mark.parametrize("kind,augment", TRAIN_CASES)
def test_train_step_on_slabs_equals_one_process(ranks, kind, augment):
    case = ("train", kind, augment)
    _replicas(ranks, case)
    _passing(ranks, case, _rows_of(ranks, case, {0: [0], 2: [1]}))


def test_h_that_does_not_divide_runs_whole_volumes(ranks):
    _replicas(ranks, "nondiv")
    assert [r["nondiv_warnings"] for r in ranks["ranks"]] == [1] * WORLD
    _passing(ranks, "nondiv", _rows_of(ranks, "nondiv", {0: [0], 2: [1]}))


@pytest.mark.parametrize("kind", ["reg", "cls"])
def test_accumulation_over_data_ranks_equals_one_process(ranks, kind):
    case = ("accum", kind)
    _replicas(ranks, case)
    _passing(ranks, case, _rows_of(ranks, case, {0: [0, 2], 2: [1, 3]}))


def test_cli_mesh_data2_spatial2_epoch(ranks):
    exp = ranks["work"] / "cli" / "subtyping_med3ddramtiny"
    assert sorted(p.name for p in (exp / "checkpoints").iterdir()) == \
        ["epoch_0000.pt"]
    lines = [json.loads(line) for line in
             (exp / "metrics.jsonl").read_text().splitlines()]
    assert [e["phase"] for e in lines] == ["train", "test"]
    rows = (exp / "predicts" / "test" / "0_predicts.csv").read_text()
    uids = [line.split(",")[0] for line in rows.splitlines()[1:]]
    assert len(uids) == 5 == len(set(uids))


def test_accum_rows_deal_each_rank_its_rows_of_every_micro_batch():
    from bodyct_dram_emph_subtype_tpu_torch.train.loop import accum_rows
    shards = [np.arange(8) + 100 * d for d in range(2)]
    # step 0's global batch is [0 1 2 3 | 100 101 102 103]: micro-batch 0
    # its rows 0-3 (all loaded by rank 0's shard), rank 0 taking 0 1 and
    # rank 1 taking 2 3; micro-batch 1 its rows 4-7
    assert accum_rows(shards, 4, 2, 0).tolist() == [0, 1, 100, 101,
                                                    4, 5, 104, 105]
    assert accum_rows(shards, 4, 2, 1).tolist() == [2, 3, 102, 103,
                                                    6, 7, 106, 107]
    assert accum_rows(shards, 2, 2, 0).tolist() == [0, 100, 2, 102,
                                                    4, 104, 6, 106]
    g = [np.concatenate([s[t * 4:(t + 1) * 4] for s in shards])
         for t in range(2)]
    got = [accum_rows(shards, 4, 4, d).reshape(2, 4, 1) for d in range(2)]
    for t in range(2):
        for i in range(4):
            assert [got[d][t, i, 0] for d in range(2)] == \
                list(g[t][2 * i:2 * i + 2])
    for d in range(2):      # no accumulation: the shard's full steps
        assert accum_rows(shards, 3, 1, d).tolist() == \
            shards[d][:6].tolist()


@pytest.mark.parametrize("kind", ["reg", "cls"])
def test_model_axis_train_step_equals_one_process(ranks, kind):
    """``spatial=2,model=2``: each rank runs its H slab and its channel
    slice of every conv whose O divides by 2 (the heads of 1 and 3 outputs
    whole); the gathered gradients, statistics and parameters equal on
    every rank and hold one process's at the same B=2, augmentation off
    (the module docstring says why)."""
    case = ("model", kind)
    _replicas(ranks, case)
    _passing(ranks, case, lambda k: ranks["ranks"][0][case]["preds"][k]
             .numpy())


def test_model_axis_checkpoint_round_trip(ranks):
    """A one-process state dict and Adam state load into the slices
    (rank (s, m) holds rows m of 2 of each sliced leaf) and gather back
    equal, tensor for tensor, into a one-process model."""
    from bodyct_dram_emph_subtype_tpu_torch.models.registry import \
        get_model_by_name
    want = ranks["spec"]["ckpt"]
    for r, rec in enumerate(ranks["ranks"]):
        got = rec["roundtrip"]
        assert got["model"].keys() == want["model"].keys()
        for k, v in want["model"].items():
            assert torch.equal(got["model"][k], v), k
            part = got["slices"][k]
            if part.shape != v.shape:
                n = part.shape[0]
                assert torch.equal(part, v[(r % 2) * n:(r % 2 + 1) * n]), k
        assert got["optimizer"]["param_groups"] == \
            want["optimizer"]["param_groups"]
        for i, st in want["optimizer"]["state"].items():
            for k, v in st.items():
                assert torch.equal(got["optimizer"]["state"][i][k], v), (i, k)
    model = get_model_by_name(ARCH["reg"], packed_decoder=True)
    model.load_state_dict(ranks["ranks"][0]["roundtrip"]["model"])


if __name__ == "__main__":
    _rank_main(Path(sys.argv[1]))
