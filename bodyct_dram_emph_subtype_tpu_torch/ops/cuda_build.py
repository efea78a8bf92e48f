"""Build, load and count the port's hand-written CUDA kernels.

The sources under ``csrc/`` (``conv3x3x3.cu``: kernels A and B;
``maxpool3d.cu``: C; ``conv3x3x3_wgrad.cu``: D; ``stem_pool.cu``: E;
``masked_sums.cu``: F, the lung-masked sums; the headers ``common.cuh``
and ``mma_bf16.cuh``, the bf16 tensor-core loop of A, B and D; every
``*.cu`` there is compiled, and ``pyproject.toml`` ships them as package
data) have a plain C interface.  At first use they
are compiled with ``nvcc`` for ``sm_90a`` into ONE shared library under
``build/kernels/`` (listed in ``.gitignore``), whose file name carries a
hash of the sources and flags, and loaded with :mod:`ctypes`.  A checkout
therefore builds its own kernels on the first CUDA call and reuses the
library afterwards; an edited source gets a new file name.

Nothing here runs at import: the CPU tests import every module of the
port on machines without ``nvcc`` or a card.

``LAUNCHES`` counts kernel launches by kernel name.  Each wrapper adds one
right after its kernel was launched, and nowhere else, so a caller can
show that a run went through the kernels (``reset_launches`` before,
``launches`` after).  Kernel D runs its partials and then a fixed-order
sum of them as a second launch; one call counts once.  Kernel F is one
launch per call.
``OP_LAUNCHES`` counts the kernel-A launches made for each opt-in
conv-mode op (``pallas_conv3d``, ``tap_conv3d``, ``flat_conv3d``), which
share kernel A (``op_launches``).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Optional

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

KERNELS = ("conv3x3x3_affine", "conv3x3x3_heads_sigmoid",
           "max_pool3d_k3s2p1", "conv3x3x3_wgrad", "stem_pool",
           "masked_sums")
LAUNCHES: Dict[str, int] = {k: 0 for k in KERNELS}
MODE_OPS = ("pallas_conv3d", "tap_conv3d", "flat_conv3d")
OP_LAUNCHES: Dict[str, int] = {k: 0 for k in MODE_OPS}

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # dtype, x, w, scale, shift, residual, out, B, D, H, W, C, O, relu,
    # dilation, stream
    "conv3x3x3_affine": [_I, _P, _P, _P, _P, _P, _P,
                         _I, _I, _I, _I, _I, _I, _I, _I, _P],
    # dtype, x, w, scale, shift, head_w, head_b, out, n_heads,
    # B, D, H, W, C, O, stream
    "conv3x3x3_heads_sigmoid": [_I, _P, _P, _P, _P, _P, _P, _P, _I,
                                _I, _I, _I, _I, _I, _I, _P],
    # dtype, x, out, B, D, H, W, C, stream
    "max_pool3d_k3s2p1": [_I, _P, _P, _I, _I, _I, _I, _I, _P],
    # dtype, x, g, workspace, out, B, D, H, W, C, O, splits, stream
    "conv3x3x3_wgrad": [_I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    # dtype, x, w, mul, add, stem, pooled, B, D, H, W, chunks, stream
    "stem_pool": [_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # dtype, dense, lung, workspace, tickets, num, den, B, D, H, W, C,
    # splits, stream
    "masked_sums": [_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
}


@dataclass
class BuildInfo:
    path: Path
    seconds: float      # compile time of this call (0.0 when cached)
    log: str            # nvcc/ptxas output of this call
    cached: bool


_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_info: Optional[BuildInfo] = None


def reset_launches() -> None:
    for counts in (LAUNCHES, OP_LAUNCHES):
        for k in counts:
            counts[k] = 0


def launches() -> Dict[str, int]:
    return dict(LAUNCHES)


def op_launches() -> Dict[str, int]:
    return dict(OP_LAUNCHES)


def sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found (PATH, CUDA_HOME): the CUDA "
                           "kernels of this package need the CUDA toolkit")
    return str(path)


def build() -> BuildInfo:
    """Compile ``csrc/*.cu`` into the hashed library unless it exists: one
    ``nvcc -c`` per source, all started together, then one link."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    digest = _digest()
    target = BUILD_DIR / f"libdram_kernels_{digest}.so"
    if target.exists():
        return BuildInfo(target, 0.0, "", True)
    nvcc = _nvcc()
    tag = f"{digest}.{os.getpid()}"
    tmp = target.with_suffix(f".{os.getpid()}.tmp.so")
    jobs = []
    t0 = time.perf_counter()
    try:
        for src in (p for p in sources() if p.suffix == ".cu"):
            obj = BUILD_DIR / f"{src.stem}_{tag}.o"
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            jobs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs = []
        for cmd, _, proc in jobs:
            out, _ = proc.communicate(timeout=900)
            logs.append(out)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                                   f"{' '.join(cmd)}\n{out}")
        cmd = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
               *(str(obj) for _, obj, _ in jobs)]
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
        logs.append(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{logs[-1]}")
        os.replace(tmp, target)      # atomic: concurrent processes agree
    finally:
        for _, obj, proc in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            obj.unlink(missing_ok=True)
        tmp.unlink(missing_ok=True)
    return BuildInfo(target, time.perf_counter() - t0, "".join(logs), False)


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib, _info
    with _lock:
        if _lib is None:
            _info = build()
            lib = ctypes.CDLL(str(_info.path))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.dram_cuda_error_string.argtypes = [ctypes.c_int]
            lib.dram_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def build_info() -> Optional[BuildInfo]:
    """How the loaded library was obtained (None before first use)."""
    return _info


def check(err: int, name: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if err != 0:
        msg = library().dram_cuda_error_string(err).decode()
        raise RuntimeError(f"CUDA kernel {name} failed: error {err} ({msg})")


def launched(name: str, op: Optional[str] = None) -> None:
    """Count one launch of kernel ``name``, and of it one for the conv-mode
    ``op`` that made it."""
    LAUNCHES[name] += 1
    if op is not None:
        OP_LAUNCHES[op] += 1
