"""Model complexity per architecture: parameters and FLOPs.

Counterpart of the root ``tools/compute_computation_complexity.py``, which
replaces the reference's two probes (``compute_computation_complexity_
proposed.py``, a profiled training fit, and ``compute_computation_
complexity_resnet.py``, ptflops MACs of MONAI resnets).  Per arch:

- ``params_M``: the model's parameters (the JAX variables' ``params``
  collection: convs, BatchNorm scale and bias; not the running
  statistics);
- ``gflops`` and ``gmacs`` (``gflops / 2``): what
  ``torch.utils.flop_counter.FlopCounterMode`` counts over the eval forward
  at ``--batch`` x ``--target_size``, or with ``--train`` over the train
  forward and a backward of its outputs' sum: the convolutions (and their
  gradients), the 1x1x1 heads and the decoder's linear resizes, which run
  as matrix products; elementwise work is not counted.  The forward runs
  on fake tensors (``FakeTensorMode``: shapes, no data, no device), so the
  deployment size costs no memory.  Fake tensors lie on the CPU, so every
  kernel site takes its plain PyTorch version: on the card the
  hand-written CUDA kernels are called through ``ctypes``
  (``ops/cuda_build.py``), where ``FlopCounterMode`` cannot see them and
  would undercount.

There is no ``gbytes_accessed``: the JAX tool reads it from XLA's cost
analysis of the compiled program, and no torch counterpart counts the
bytes of this program.  ``--compare`` appends the reference-style
external baseline table (:func:`external_baseline_table`, copied).  The
JAX tool's ``--cpu`` has no counterpart: nothing here uses a device.

    python -m bodyct_dram_emph_subtype_tpu_torch.tools.compute_computation_complexity \\
        [--archs med3d,med3ddram50] [--target_size 128,224,288] [--batch 1] \\
        [--train] [--compare]
"""
import argparse
import json
import math
from typing import Dict, List, Optional, Sequence

import torch

from ..models.registry import get_model_by_name

DEFAULT_ARCHS = ("med3d18,med3d,med3d50,med3ddram18,med3ddram,"
                 "med3ddram50")


def _resnet_macs_params(depth: int, ndim: int, in_shape,
                        n_classes: int = 400):
    """Analytic MACs/params of a standard torchvision-convention ResNet
    (the architecture family behind the reference's MONAI baselines,
    ``compute_computation_complexity_resnet.py:1-7``) at arbitrary spatial
    rank — conv7 stride-2 stem, maxpool3 stride-2, BasicBlock for 18/34 /
    Bottleneck for 50, type-B (1x1-conv) downsample shortcuts, global pool
    + FC.  Counts conv/FC multiply-accumulates only (the ptflops
    convention is MACs-dominated by the same terms; BN/ReLU add <1%)."""
    cfg = {18: ("basic", (2, 2, 2, 2)), 34: ("basic", (3, 4, 6, 3)),
           50: ("bottleneck", (3, 4, 6, 3))}[depth]
    kind, blocks = cfg
    exp = 4 if kind == "bottleneck" else 1
    cin, *spatial = in_shape
    macs = params = 0

    def conv(cin, cout, k, stride, spatial):
        nonlocal macs, params
        out_sp = [math.ceil(s / stride) for s in spatial]
        n_out = 1
        for s in out_sp:
            n_out *= s
        macs += n_out * cout * cin * k ** ndim
        params += cout * cin * k ** ndim + 2 * cout   # + BN affine
        return out_sp

    spatial = conv(cin, 64, 7, 2, spatial)                    # stem
    spatial = [math.ceil(s / 2) for s in spatial]             # maxpool
    c = 64
    for i, nb in enumerate(blocks):
        planes = 64 * 2 ** i
        cout = planes * exp
        for b in range(nb):
            stride = 2 if (i > 0 and b == 0) else 1
            if kind == "basic":
                sp = conv(c, planes, 3, stride, spatial)
                sp = conv(planes, planes, 3, 1, sp)
            else:
                sp = conv(c, planes, 1, 1, spatial)
                sp = conv(planes, planes, 3, stride, sp)
                sp = conv(planes, cout, 1, 1, sp)
            if b == 0 and (stride != 1 or c != cout):
                conv(c, cout, 1, stride, spatial)             # shortcut B
            spatial, c = sp, cout
    macs += c * n_classes                                     # FC
    params += c * n_classes + n_classes
    return macs, params


def external_baseline_table():
    """The reference's MONAI-resnet comparison rows
    (``compute_computation_complexity_resnet.py:9-43``): resnet18/34/50 at
    (3, 224, 224[, 224]) in 2D and 3D, MACs + params."""
    rows = []
    for ndim, shape in ((3, (3, 224, 224, 224)), (2, (3, 224, 224))):
        for depth in (18, 34, 50):
            macs, params = _resnet_macs_params(depth, ndim, shape)
            rows.append({"arch": f"resnet{depth}_{ndim}d (baseline)",
                         "params_M": round(params / 1e6, 2),
                         "gmacs": round(macs / 1e9, 1),
                         "input": list(shape)})
    return rows


def _outputs_sum(out) -> torch.Tensor:
    """The sum of every floating tensor in a forward's output."""
    if isinstance(out, torch.Tensor):
        return out.float().sum()
    return sum(_outputs_sum(o) for o in out)


def count_flops(model: torch.nn.Module, shape: Sequence[int],
                train: bool = False) -> int:
    """``FlopCounterMode``'s total over ``model``'s forward (eval, or the
    train forward and backward) on fake NDHWC inputs of ``shape``."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode
    model.train(train)
    with FakeTensorMode(allow_non_fake_inputs=True):
        x = torch.zeros(tuple(shape))
        with FlopCounterMode(display=False) as counter, \
                torch.set_grad_enabled(train):
            out = model(x, x)
            if train:
                _outputs_sum(out).backward()
    return counter.get_total_flops()


def complexity_row(arch: str, shape: Sequence[int],
                   train: bool = False) -> Dict:
    model = get_model_by_name(arch)
    n_params = sum(p.numel() for p in model.parameters())
    flops = count_flops(model, shape, train)
    return {"arch": arch, "params_M": round(n_params / 1e6, 2),
            "gflops": round(flops / 1e9, 1),
            "gmacs": round(flops / 2e9, 1), "input": list(shape)}


def main(argv: Optional[Sequence[str]] = None) -> List[Dict]:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--archs", default=DEFAULT_ARCHS)
    parser.add_argument("--target_size", default="128,224,288")
    parser.add_argument("--batch", default=1, type=int)
    parser.add_argument("--train", action="store_true",
                        help="count the train forward and backward instead "
                             "of the eval forward")
    parser.add_argument("--compare", action="store_true",
                        help="append the reference-style external baseline "
                             "table (standard resnet18/34/50, 2D and 3D at "
                             "224, analytic MACs)")
    args = parser.parse_args(argv)
    size = tuple(int(v) for v in args.target_size.replace("x", ",")
                 .strip("()").split(","))
    shape = (args.batch, *size, 1)
    rows = []
    for arch in args.archs.split(","):
        rows.append(complexity_row(arch, shape, args.train))
        print(json.dumps(rows[-1]))
    if args.compare:
        for row in external_baseline_table():
            rows.append(row)
            print(json.dumps(row))
    return rows


if __name__ == "__main__":
    main()
