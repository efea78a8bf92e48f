"""Self-contained MetaImage (.mha) codec — no SimpleITK dependency.

Numpy-only copy of ``bodyct_dram_emph_subtype_tpu/data/mha.py`` (the JAX
package's data layer imports jax, so the port owns its host layer).

The reference reads and writes MHA through SimpleITK (``dataset.py:49-55``,
``utils.py:87-104``).  This image has no SimpleITK wheel, and the format is
simple enough that a first-party codec is the cleaner dependency story: an
ASCII ``Key = Value`` header followed by raw (optionally zlib-compressed)
voxel data in x-fastest order.  The writer's compressed payload is one
zlib stream of slabs that a caller's map may deflate in parallel (see
``_SLAB_BYTES``).

Conventions match SimpleITK:
- arrays are returned/accepted in (z, y, x) index order
  (``GetArrayFromImage`` layout);
- ``spacing``/``origin`` are (x, y, z) tuples and ``direction`` is the
  flattened 3x3 row-major matrix, exactly what ``GetSpacing``/``GetOrigin``/
  ``GetDirection`` return — callers reverse them to z-y-x just like the
  reference does (``dataset.py:51-53``).
"""
from __future__ import annotations

import functools
import struct
import zlib
from dataclasses import dataclass, field
from pathlib import Path
from typing import (Any, Callable, Dict, Iterable, List, Optional, Sequence,
                    Tuple, Union)

import numpy as np

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


# The compressed payload is one zlib stream (RFC 1950) of fixed slabs of
# whole leading-axis planes, about _SLAB_BYTES each, that a caller's map
# may deflate apart on a thread pool, as pigz does: each slab a raw deflate
# whose dictionary is the 32 KiB before it, closed by a sync flush (the
# last by the final block); the header 0x78 0x01 and the Adler-32 of the
# whole volume around them.  Any inflater reads it.  The slab bounds follow
# the shape and dtype alone, so the bytes do not depend on the map.  Level
# 1: about 4x faster than the default; MHA only requires a valid stream.
_SLAB_BYTES = 4 << 20
_WINDOW = 32 << 10          # deflate's window: a slab's dictionary
_ZLIB_HEADER = b"\x78\x01"  # deflate, 32 KiB window, fastest level
_ADLER_BASE = 65521

# the planes [z0, z1) of a volume as one flat C-order buffer
Planes = Callable[[int, int], memoryview]
# a function mapped over the slab indices, as the builtin ``map`` or an
# executor's ``map`` does it
SlabMap = Callable[[Callable[[int], Any], Iterable[int]], Iterable[Any]]


def slab_bounds(shape: Sequence[int], dtype) -> List[int]:
    """The leading-axis plane indices where the compressed payload's slabs
    of a ``shape`` array start, and its end: whole planes, about
    ``_SLAB_BYTES`` a slab, and one slab at least."""
    plane = np.dtype(dtype).itemsize * int(np.prod(shape[1:]))
    per = max(1, _SLAB_BYTES // max(plane, 1))
    return [*(range(0, shape[0], per) or [0]), shape[0]]


def _adler32_combine(a1: int, a2: int, len2: int) -> int:
    """The Adler-32 of ``x + y`` from ``a1 = adler32(x)``, ``a2 =
    adler32(y)`` and ``len2 = len(y)`` (zlib's ``adler32_combine``)."""
    s1 = ((a1 & 0xFFFF) + (a2 & 0xFFFF) - 1) % _ADLER_BASE
    s2 = ((a1 >> 16) + (a2 >> 16) + len2 * ((a1 & 0xFFFF) - 1)) \
        % _ADLER_BASE
    return (s2 << 16) | s1


def _deflate_slab(planes: Planes, bounds: List[int], plane: int, k: int):
    """Slab ``k``: its raw deflate stream, its Adler-32 and its length.
    The planes before it that hold its dictionary are made again here, so
    no slab waits for another."""
    z0, z1 = bounds[k], bounds[k + 1]
    context = -(-_WINDOW // plane) if plane else 0    # planes
    c0 = max(0, z0 - context)
    buf = planes(c0, z1)
    off = (z0 - c0) * plane
    data = buf[off:]
    kw = {"zdict": buf[max(0, off - _WINDOW):off]} if off else {}
    co = zlib.compressobj(1, zlib.DEFLATED, -15, **kw)
    last = k == len(bounds) - 2
    out = co.compress(data) + co.flush(zlib.Z_FINISH if last
                                       else zlib.Z_SYNC_FLUSH)
    return out, zlib.adler32(data), len(data)


def deflate(planes: Planes, shape, dtype,
            slab_map: Optional[SlabMap] = None) -> List[bytes]:
    """The compressed payload of a ``shape``/``dtype`` volume whose planes
    ``planes`` makes, as the chunks to write in turn.  ``slab_map`` maps
    the deflate over the slabs (an executor's ``map`` runs them on its
    threads); without one they run in turn on the caller."""
    bounds = slab_bounds(shape, dtype)
    plane = np.dtype(dtype).itemsize * int(np.prod(shape[1:]))
    run = functools.partial(_deflate_slab, planes, bounds, plane)
    slabs = list((slab_map or map)(run, range(len(bounds) - 1)))
    adler = 1
    for _, a, length in slabs:
        adler = _adler32_combine(adler, a, length)
    return [_ZLIB_HEADER, *(s[0] for s in slabs), struct.pack(">I", adler)]


def pasted_planes(crop: np.ndarray, paste: Sequence[slice],
                  shape: Sequence[int]) -> Planes:
    """The planes of the ``shape`` volume that holds ``crop`` at ``paste``
    (one slice per axis) and zeros elsewhere, each made from the crop when
    asked for, so that volume is never made."""
    shape = tuple(int(s) for s in shape)
    box = [s.indices(n)[:2] for s, n in zip(paste, shape)]
    if len(box) != len(shape) or tuple(b - a for a, b in box) != crop.shape:
        raise ValueError(f"a crop of shape {crop.shape} does not fill "
                         f"{paste} of a {shape} volume")
    (za, zb), inner = box[0], tuple(slice(a, b) for a, b in box[1:])

    def planes(z0: int, z1: int) -> memoryview:
        out = np.zeros((z1 - z0, *shape[1:]), crop.dtype)
        a, b = max(z0, za), min(z1, zb)
        if a < b:
            out[(slice(a - z0, b - z0), *inner)] = crop[a - za:b - za]
        return memoryview(out.reshape(-1).view(np.uint8))
    return planes


def _write(path, planes: Planes, shape, dtype, spacing, origin, direction,
           compressed: bool, anatomical_orientation: str,
           slab_map: Optional[SlabMap]) -> None:
    chunks = (deflate(planes, shape, dtype, slab_map) if compressed
              else [planes(0, shape[0])])
    write_mha_file(path, chunks, shape, dtype, spacing, origin, direction,
                   compressed, anatomical_orientation)


def write_mha(path: Union[str, Path], array: np.ndarray,
              spacing: Sequence[float] = (1.0, 1.0, 1.0),
              origin: Sequence[float] = (0.0, 0.0, 0.0),
              direction: Sequence[float] = None,
              compressed: bool = True,
              anatomical_orientation: str = "RAI",
              slab_map: Optional[SlabMap] = None) -> None:
    """Write a (z,y,x) array as .mha; geometry args are ITK (x,y,z) order,
    mirroring ``sitk.Image`` setters used by the reference
    (``utils.py:93-104``).  The slabs are views of the array's memory,
    deflated through ``slab_map`` as :func:`deflate` does."""
    array = np.ascontiguousarray(array)
    flat = memoryview(array.reshape(-1).view(np.uint8))
    plane = array.itemsize * int(np.prod(array.shape[1:]))
    _write(path, lambda z0, z1: flat[z0 * plane:z1 * plane], array.shape,
           array.dtype, spacing, origin, direction, compressed,
           anatomical_orientation, slab_map)


def write_pasted_mha(path: Union[str, Path], crop: np.ndarray,
                     paste: Sequence[slice], shape: Sequence[int],
                     spacing: Sequence[float] = (1.0, 1.0, 1.0),
                     origin: Sequence[float] = (0.0, 0.0, 0.0),
                     direction: Sequence[float] = None,
                     compressed: bool = True,
                     anatomical_orientation: str = "RAI",
                     slab_map: Optional[SlabMap] = None) -> None:
    """Write, as :func:`write_mha` does, the ``shape`` volume that holds
    ``crop`` at ``paste`` and zeros elsewhere, the same bytes, from
    :func:`pasted_planes`: each slab's planes are made from the crop where
    the slab is deflated."""
    shape = tuple(int(s) for s in shape)
    _write(path, pasted_planes(crop, paste, shape), shape, crop.dtype,
           spacing, origin, direction, compressed, anatomical_orientation,
           slab_map)


def write_mha_file(path: Union[str, Path], chunks: Sequence, shape, dtype,
                   spacing: Sequence[float] = (1.0, 1.0, 1.0),
                   origin: Sequence[float] = (0.0, 0.0, 0.0),
                   direction: Sequence[float] = None,
                   compressed: bool = True,
                   anatomical_orientation: str = "RAI") -> None:
    """Write the header and the payload ``chunks`` (compressed when
    ``compressed``, as :func:`deflate` makes them) of a (z,y,x) ``shape``
    array."""
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
        lines.append(
            f"CompressedDataSize = {sum(len(c) for c in chunks)}")
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
        for c in chunks:
            f.write(c)
