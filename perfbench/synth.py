"""Synthetic chest CT made from a seed, and the files the cells read.

Every seed gives the same geometry (volume shapes, lung boxes, spacing):
the seed changes the texture, the emphysema pattern, the labels' order and
the order of the scans, never the amount of work.  Volumes are made on the
device in a few large calls and copied to the host once.

- :func:`make_scan`: one int16 CT (Z, Y, X) and its uint8 lobe map: a body
  ellipse of soft tissue in air, two lung ellipsoids of parenchyma with
  low-attenuation (emphysema-like) blobs, five lobes cut along z.
- :func:`write_mha` / :func:`read_mha`: a MetaImage codec of its own (the
  program's is not used to make or judge its inputs).
- :func:`write_training_archive`: lung-cropped volumes as the trainer's
  ``{uid}.npz`` archive and its ``merged.csv`` and split CSVs.
"""
from __future__ import annotations

import csv
import zlib
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

_MET = {np.dtype(np.int16): "MET_SHORT", np.dtype(np.uint8): "MET_UCHAR"}
_DTYPE = {v: k for k, v in _MET.items()}


def sub_seed(seed: int, *path: int) -> int:
    """A 63-bit seed for the stream ``path`` of run seed ``seed``."""
    state = np.random.SeedSequence([int(seed) % (1 << 64), *path])
    return int(state.generate_state(1, np.uint64)[0] >> np.uint64(1))


def make_scan(shape: Sequence[int], lung_box: Sequence[int], seed: int,
              device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ct int16, lobes uint8), both (Z, Y, X) on ``device``.  The two lung
    ellipsoids fill ``lung_box`` (z, y, x voxels), centred in the volume;
    about a fifth of the parenchyma is below -950 HU."""
    gen = torch.Generator(device).manual_seed(seed)
    z_n, y_n, x_n = (int(s) for s in shape)
    bz, by, bx = (float(s) for s in lung_box)
    f32 = dict(dtype=torch.float32, device=device)
    z = torch.arange(z_n, **f32)[:, None, None] - (z_n - 1) / 2
    y = torch.arange(y_n, **f32)[None, :, None] - (y_n - 1) / 2
    x = torch.arange(x_n, **f32)[None, None, :] - (x_n - 1) / 2
    gap = 4.0
    ax = (bx - gap) / 4
    lungs = []
    for side in (-1.0, 1.0):
        cx = side * (gap / 2 + ax)
        lungs.append((z / (bz / 2)) ** 2 + (y / (by / 2)) ** 2
                     + ((x - cx) / ax) ** 2 <= 1.0)
    right, left = lungs
    lung = right | left
    body = (y / (0.47 * y_n)) ** 2 + (x / (0.48 * x_n)) ** 2 <= 1.0
    noise = torch.randn((z_n, y_n, x_n), generator=gen, **f32)
    # a smooth field, thresholded: emphysema-like blobs inside the lung
    coarse = torch.randn((1, 1, max(2, z_n // 12), max(2, y_n // 12),
                          max(2, x_n // 12)), generator=gen, **f32)
    field = F.interpolate(coarse, size=(z_n, y_n, x_n), mode="trilinear",
                          align_corners=False)[0, 0]
    field = (field - field.mean()) / field.std()
    blobs = field > 0.85
    hu = torch.where(body, 40.0 + 20.0 * noise, -1000.0 + 15.0 * noise)
    paren = torch.where(blobs, -975.0 + 18.0 * noise, -860.0 + 35.0 * noise)
    hu = torch.where(lung, paren, hu)
    ct = torch.round(hu).clamp(-2048, 3071).to(torch.int16)
    # lobes: right lung upper / middle / lower, left upper / lower, by z
    zc = z.expand(z_n, y_n, x_n)
    lobes = torch.zeros((z_n, y_n, x_n), dtype=torch.uint8, device=device)
    lobes[right & (zc < -bz / 6)] = 1
    lobes[right & (zc >= -bz / 6) & (zc < bz / 6)] = 2
    lobes[right & (zc >= bz / 6)] = 3
    lobes[left & (zc < 0)] = 4
    lobes[left & (zc >= 0)] = 5
    return ct, lobes


def write_mha(path, array: np.ndarray, spacing_xyz: Sequence[float],
              origin_xyz: Sequence[float] = (0.0, 0.0, 0.0),
              compressed: bool = False) -> int:
    """A MetaImage of a (Z, Y, X) array, uncompressed or zlib-compressed
    (level 1); returns its bytes."""
    array = np.ascontiguousarray(array)
    payload = memoryview(array).cast("B")
    if compressed:
        payload = zlib.compress(payload, 1)
    header = "\n".join([
        "ObjectType = Image", "NDims = 3", "BinaryData = True",
        "BinaryDataByteOrderMSB = False", f"CompressedData = {compressed}",
        "TransformMatrix = 1 0 0 0 1 0 0 0 1",
        "Offset = " + " ".join(repr(float(v)) for v in origin_xyz),
        "ElementSpacing = " + " ".join(repr(float(v)) for v in spacing_xyz),
        "DimSize = " + " ".join(str(s) for s in reversed(array.shape)),
        f"ElementType = {_MET[array.dtype]}", "ElementDataFile = LOCAL",
    ]) + "\n"
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(payload)
    return len(header) + len(payload)


def read_mha(path) -> np.ndarray:
    """The (Z, Y, X) array of a MetaImage (zlib-compressed or not)."""
    raw = Path(path).read_bytes()
    header, pos = {}, 0
    while True:
        eol = raw.index(b"\n", pos)
        key, _, value = raw[pos:eol].decode("ascii").partition("=")
        header[key.strip()] = value.strip()
        pos = eol + 1
        if key.strip() == "ElementDataFile":
            break
    payload = memoryview(raw)[pos:]
    if header.get("CompressedData", "False") == "True":
        payload = zlib.decompress(payload)
    dims = [int(v) for v in header["DimSize"].split()]
    return np.frombuffer(payload, _DTYPE[header["ElementType"]],
                         count=int(np.prod(dims))).reshape(dims[::-1])


def make_cohort(traffic: Dict, seed: int, device) -> List[Dict]:
    """The distinct scans of a processor cell: ``traffic["scans"]`` lists
    each scan's ``lung_box``; all share ``shape`` and ``spacing_zyx``.  The
    seed orders them.  Each entry: ``ct``, ``lobes`` (host numpy) and the
    geometry."""
    shape = traffic["shape"]
    spacing = traffic["spacing_zyx"]
    order = np.random.default_rng(sub_seed(seed, 0)).permutation(
        len(traffic["scans"]))
    out = []
    for k, i in enumerate(order):
        ct, lobes = make_scan(shape, traffic["scans"][int(i)]["lung_box"],
                              sub_seed(seed, 1, k), device)
        out.append({"ct": ct.cpu().numpy(), "lobes": lobes.cpu().numpy(),
                    "spacing_zyx": tuple(spacing), "name": f"s{k}"})
        del ct, lobes
    return out


def write_training_archive(root: Path, traffic: Dict, seed: int,
                           device) -> Tuple[List[str], int]:
    """``traffic["volumes"]`` lung-cropped volumes of ``crop_shape`` as
    ``{uid}.npz`` (int16 ``image``, bool ``lung_mask``, labels) and
    ``merged.csv``; ``train.csv`` lists all of them, ``valid.csv`` and
    ``test.csv`` the first.  The CLE/PSE labels are the traffic file's
    ``cle_labels``/``pse_labels`` in an order drawn from the seed.  Returns
    (uids, bytes written)."""
    root.mkdir(parents=True, exist_ok=True)
    n = int(traffic["volumes"])
    shape = traffic["crop_shape"]
    border = int(traffic["crop_border"])
    box = [s - 2 * border for s in shape]
    perm = np.random.default_rng(sub_seed(seed, 2)).permutation(n)
    cle = [int(traffic["cle_labels"][i]) for i in perm]
    pse = [int(traffic["pse_labels"][i]) for i in perm]
    uids, written = [], 0
    for k in range(n):
        ct, lobes = make_scan(shape, box, sub_seed(seed, 3, k), device)
        uid = f"1.2.826.0.1.{k:04d}"
        path = root / f"{uid}.npz"
        np.savez(path, image=ct.cpu().numpy(),
                 lung_mask=(lobes > 0).cpu().numpy(),
                 cls_label=np.int64(cle[k]), pse_label=np.int64(pse[k]))
        written += path.stat().st_size
        uids.append(uid)
    fields = ["SeriesInstanceUID", "CT_Visual_Emph_Severity_P1",
              "CT_Visual_Emph_Paraseptal_P1"]
    for name, rows in (("merged.csv", range(n)), ("train.csv", range(n)),
                       ("valid.csv", range(1)), ("test.csv", range(1))):
        with open(root / name, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(fields)
            for k in rows:
                w.writerow([uids[k], cle[k], pse[k]])
    return uids, written
