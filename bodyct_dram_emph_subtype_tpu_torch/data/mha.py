"""Self-contained MetaImage (.mha) codec — no SimpleITK dependency.

Numpy-only copy of ``bodyct_dram_emph_subtype_tpu/data/mha.py`` (the JAX
package's data layer imports jax, so the port owns its host layer).

The reference reads and writes MHA through SimpleITK (``dataset.py:49-55``,
``utils.py:87-104``).  This image has no SimpleITK wheel, and the format is
simple enough that a first-party codec is the cleaner dependency story: an
ASCII ``Key = Value`` header followed by raw (optionally zlib-compressed)
voxel data in x-fastest order.

Conventions match SimpleITK:
- arrays are returned/accepted in (z, y, x) index order
  (``GetArrayFromImage`` layout);
- ``spacing``/``origin`` are (x, y, z) tuples and ``direction`` is the
  flattened 3x3 row-major matrix, exactly what ``GetSpacing``/``GetOrigin``/
  ``GetDirection`` return — callers reverse them to z-y-x just like the
  reference does (``dataset.py:51-53``).
"""
from __future__ import annotations

import zlib
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np

from ..utils.spans import span

_MET_TO_DTYPE = {
    "MET_CHAR": np.int8, "MET_UCHAR": np.uint8,
    "MET_SHORT": np.int16, "MET_USHORT": np.uint16,
    "MET_INT": np.int32, "MET_UINT": np.uint32,
    "MET_LONG": np.int64, "MET_ULONG": np.uint64,
    "MET_LONG_LONG": np.int64, "MET_ULONG_LONG": np.uint64,
    "MET_FLOAT": np.float32, "MET_DOUBLE": np.float64,
}
_DTYPE_TO_MET = {np.dtype(v): k for k, v in _MET_TO_DTYPE.items()}


@dataclass
class MhaImage:
    """A decoded MetaImage: (z,y,x) array + ITK-convention geometry."""
    array: np.ndarray
    spacing: Tuple[float, ...] = (1.0, 1.0, 1.0)   # (x, y, z)
    origin: Tuple[float, ...] = (0.0, 0.0, 0.0)    # (x, y, z)
    direction: Tuple[float, ...] = field(
        default_factory=lambda: tuple(np.eye(3).ravel()))
    extra_header: Dict[str, str] = field(default_factory=dict)


def read_mha(path: Union[str, Path]) -> MhaImage:
    path = Path(path)
    raw = path.read_bytes()
    header: Dict[str, str] = {}
    pos = 0
    while True:
        eol = raw.index(b"\n", pos)
        line = raw[pos:eol].decode("ascii", errors="replace").strip()
        pos = eol + 1
        if "=" not in line:
            raise ValueError(f"malformed MHA header line: {line!r}")
        key, value = (s.strip() for s in line.split("=", 1))
        header[key] = value
        if key == "ElementDataFile":
            if value != "LOCAL":
                raise NotImplementedError(
                    "only ElementDataFile = LOCAL (.mha) is supported")
            break

    ndims = int(header.get("NDims", 3))
    dim_size = [int(v) for v in header["DimSize"].split()]
    if len(dim_size) != ndims:
        raise ValueError(f"{path}: DimSize {dim_size} does not have "
                         f"NDims = {ndims} entries")
    dtype = np.dtype(_MET_TO_DTYPE[header["ElementType"]])
    if header.get("BinaryDataByteOrderMSB", "False") == "True":
        dtype = dtype.newbyteorder(">")

    # memoryview: a bytes slice would copy the whole payload
    payload = memoryview(raw)[pos:]
    if header.get("CompressedData", "False") == "True":
        payload = zlib.decompress(payload)
    count = int(np.prod(dim_size))
    array = np.frombuffer(payload, dtype=dtype, count=count)
    # MHA data is x-fastest; DimSize is (x, y, z) → numpy shape reversed.
    array = array.reshape(tuple(reversed(dim_size)))
    native = dtype.newbyteorder("=")
    if dtype != native:
        array = array.astype(native)

    def floats(key, default):
        if key in header:
            return tuple(float(v) for v in header[key].split())
        return default

    # NOTE: the returned array is READ-ONLY in every case — a zero-copy
    # view over the file bytes (uncompressed native-endian) or over the
    # decompressed buffer.  Callers that mutate must copy; the
    # deployment pipeline only ever mutates crops, which are copies.
    return MhaImage(
        array=np.ascontiguousarray(array),
        spacing=floats("ElementSpacing", (1.0,) * ndims),
        origin=floats("Offset", (0.0,) * ndims),
        direction=floats("TransformMatrix",
                         tuple(np.eye(ndims).ravel())),
        extra_header={k: v for k, v in header.items()
                      if k.startswith("Anatomical")},
    )


def write_mha(path: Union[str, Path], array: np.ndarray,
              spacing: Sequence[float] = (1.0, 1.0, 1.0),
              origin: Sequence[float] = (0.0, 0.0, 0.0),
              direction: Sequence[float] = None,
              compressed: bool = True,
              anatomical_orientation: str = "RAI",
              counters: Optional[Dict[str, float]] = None) -> None:
    """Write a (z,y,x) array as .mha; geometry args are ITK (x,y,z) order,
    mirroring ``sitk.Image`` setters used by the reference
    (``utils.py:93-104``).  The compression is a ``post.zlib`` span and
    the rest a ``post.write`` span (``utils/spans.py``), added to
    ``counters`` when given."""
    with span("post.write", counters):
        array = np.ascontiguousarray(array)
        payload = array.tobytes()
    if compressed:
        with span("post.zlib", counters):
            # level 1: ~4x faster than the default on 1-2 core deployment
            # hosts; MHA only requires a valid zlib stream
            payload = zlib.compress(payload, level=1)
    with span("post.write", counters):
        _write_mha_file(Path(path), payload, array.shape, array.dtype,
                        spacing, origin, direction, compressed,
                        anatomical_orientation)


def _write_mha_file(path: Path, payload: bytes, shape, dtype, spacing,
                    origin, direction, compressed: bool,
                    anatomical_orientation: str) -> None:
    """The header and ``payload`` (compressed when ``compressed``) of a
    (z,y,x) ``shape`` array."""
    ndims = len(shape)
    if direction is None:
        direction = tuple(np.eye(ndims).ravel())
    met = _DTYPE_TO_MET[np.dtype(dtype)]
    lines = [
        "ObjectType = Image",
        f"NDims = {ndims}",
        "BinaryData = True",
        "BinaryDataByteOrderMSB = False",
        f"CompressedData = {'True' if compressed else 'False'}",
    ]
    if compressed:
        lines.append(f"CompressedDataSize = {len(payload)}")
    fmt = lambda vals: " ".join(repr(float(v)) if float(v) != int(v)
                                else str(int(v)) for v in vals)
    lines += [
        f"TransformMatrix = {fmt(direction)}",
        f"Offset = {fmt(origin)}",
        f"CenterOfRotation = {fmt([0.0] * ndims)}",
        f"AnatomicalOrientation = {anatomical_orientation}",
        f"ElementSpacing = {fmt(spacing)}",
        f"DimSize = {' '.join(str(s) for s in reversed(shape))}",
        f"ElementType = {met}",
        "ElementDataFile = LOCAL",
    ]
    with open(path, "wb") as f:
        f.write(("\n".join(lines) + "\n").encode("ascii"))
        f.write(payload)


def write_arrays_to_mha(target_dir: Union[str, Path], arrays, names,
                        dtype=np.int16, origin=(0.0, 0.0, 0.0),
                        direction=None, spacing=(1.0, 1.0, 1.0),
                        counters: Optional[Dict[str, float]] = None) -> None:
    """Batch writer matching ``write_array_to_mha_itk`` (``utils.py:87-104``):
    arrays are z-y-x; spacing/origin/direction here are x-y-z (ITK order).
    ``counters``: as :func:`write_mha`'s (the cast adds to ``post.write``)."""
    target_dir = Path(target_dir)
    target_dir.mkdir(parents=True, exist_ok=True)
    for arr, name in zip(arrays, names):
        with span("post.write", counters):
            arr = np.asarray(arr).astype(dtype, copy=False)
        write_mha(target_dir / f"{name}.mha", arr, spacing=spacing,
                  origin=origin, direction=direction, compressed=True,
                  counters=counters)
