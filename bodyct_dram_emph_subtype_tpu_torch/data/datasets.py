"""Deployment inference dataset and the severity-score interval maps.

Numpy-only copy of ``bodyct_dram_emph_subtype_tpu/data/datasets.py``'s
``SubtypingInference``, ``CLE_RATIO_MAP``, ``PSE_RATIO_MAP`` and
``ratio_to_label`` (reference ``dataset.py:14-93,99-112``): paired
``*.mha`` scan + lobe glob, z-y-x geometry reversal, lung dilation (2
iterations, full 3^3 structure), outside-lung -2048 mask-out, lung-bbox
crop + 5 mm border, -910 HU ``ess_mask``, per-uid ITK meta cache; and the
training dataset ``COPDGeneSubtyping`` over a per-series ``.npz`` archive
or a reference ``{uid}.pth`` cache, and its ``merged.csv`` (reference
``dataset.py:96-155``).
"""
from __future__ import annotations

import functools
import glob
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..ops.morphology import dilate_axis_np, find_crops_np
from ..utils.spans import span
from .csv_utils import read_csv_in_dict
from .host_preprocess import moments_from_sums, window_sums_np
from .mha import SlabMap, read_mha

CLE_RATIO_MAP = {0: (0.0, 0.01), 1: (0.01, 0.05), 2: (0.05, 0.1),
                 3: (0.1, 0.2), 4: (0.2, 0.3), 5: (0.3, 1.0001)}
PSE_RATIO_MAP = {0: (0.0, 0.01), 1: (0.01, 0.05), 2: (0.05, 1.0001)}


def ratio_to_label(ratio: float, ratio_mapping: Dict[int, tuple]) -> int:
    """Lesion fraction → severity score by interval lookup
    (reference ``processor.py:34-38``)."""
    for label, (lo, hi) in ratio_mapping.items():
        if lo <= ratio < hi:
            return label
    raise ValueError(f"ratio {ratio} outside every interval")


def load_torch_cache(path) -> Dict[str, Any]:
    """A reference training cache ``{uid}.pth`` (a dict of tensors and
    labels, ``dataset.py:148``) with its tensors as numpy arrays, as the
    ``.npz`` branch and the JAX package's torch-free reader
    (``data/torch_pickle.py``) return them (bfloat16, which numpy lacks,
    widened to float32), and the ``*_label`` entries as Python ints."""
    import torch
    data = torch.load(path, map_location="cpu", weights_only=True)
    out = {}
    for k, v in data.items():
        if isinstance(v, torch.Tensor):
            v = (v.float() if v.dtype == torch.bfloat16 else v).numpy()
        out[k] = int(v) if k.endswith("_label") else v
    return out


# planes of a z-slab of the crop in the prepare's one pass: a few MB of
# int16, bool and int32 temporaries, so each slab's passes run in cache
SLAB_PLANES = 8
# the reach of the reference's dilation: 2 iterations of the full 3^3
# structure are a max filter of radius 2 along each axis
DILATE = 2


class SubtypingInference:
    """Deployment dataset over paired scan/lobe ``.mha`` directories.
    Each item's MHA reads are an ``io.read`` span and the rest an
    ``io.prepare`` span (``utils/spans.py``), added to ``counters`` when
    given (its views add their own work to ``io.prepare``).

    An item is prepared in one pass over z-slabs of its lung crop
    (:func:`_crop_slab`), after the crop's bounding box is found in
    z-slabs of the lobe map; ``slab_map`` maps both passes' slabs (an
    executor's ``map`` runs them on its threads; without one they run in
    turn on the caller, with the same bytes)."""

    def __init__(self, scan_path: str, lobe_path: str, crop_border: int = 5,
                 keep_original: bool = True, compute_ess: bool = True,
                 counters: Optional[Dict[str, float]] = None,
                 slab_map: Optional[SlabMap] = None):
        self.scan_path = scan_path
        self.lobe_path = lobe_path
        self.crop_border = crop_border
        # the deployment device pipeline neither reads ``original_image``
        # nor ``ess_mask`` (the ess threshold runs on the device), so the
        # processor disables both — skipping a full-crop copy and two
        # full-crop compare/and passes per scan on the host
        self.keep_original = keep_original
        self.compute_ess = compute_ess
        self.scan_files = sorted(glob.glob(scan_path + "/*.mha"))
        self.lobe_files = sorted(glob.glob(lobe_path + "/*.mha"))
        self.scan_meta_cache: Dict[str, dict] = {}
        self.counters = counters
        self.slab_map = slab_map

    def __len__(self):
        return len(self.scan_files)

    def __getitem__(self, index):
        return self.get_data(index)

    def read_image(self, path):
        """Read and reverse geometry to z-y-x, like the reference
        (``dataset.py:49-55``)."""
        img = read_mha(path)
        spacing = img.spacing[::-1]
        origin = img.origin[::-1]
        direction = np.asarray(img.direction).reshape(3, 3)[::-1].flatten().tolist()
        return img.array, origin, spacing, direction

    def get_data(self, index,
                 moments: Optional[Callable[[Tuple[int, ...]], bool]] = None
                 ) -> Dict[str, Any]:
        """Item ``index``; where ``moments`` holds for the crop's shape it
        also carries ``moments``, the crop's ``window_moments_np`` taken
        from the same pass."""
        scan_file = self.scan_files[index]
        lobe_file = self.lobe_files[index]
        with span("io.read", self.counters):
            scan, origin, spacing, direction = self.read_image(scan_file)
            lobe, *_ = self.read_image(lobe_file)
        with span("io.prepare", self.counters):
            return self._prepare(Path(scan_file).stem, scan, lobe, origin,
                                 spacing, direction, moments)

    def _prepare(self, scan_name: str, scan, lobe, origin, spacing,
                 direction, moments=None) -> Dict[str, Any]:
        original_size = scan.shape
        if lobe.shape != scan.shape:
            raise ValueError(f"{scan_name}: scan {scan.shape} and lobe "
                             f"segmentation {lobe.shape} differ in shape")
        run = self.slab_map or map
        slices = find_crops_np(lobe, spacing, self.crop_border, run)
        shape = tuple(s.stop - s.start for s in slices)
        ret = {
            "image": np.empty(shape, np.int16),
            "lung_mask": np.empty(shape, bool),
            "crop_slice": np.asarray([(s.start, s.stop) for s in slices]),
            "original_size": np.asarray(original_size),
            "uid": scan_name,
        }
        if self.keep_original:
            ret["original_image"] = np.empty(shape, np.int16)
        if self.compute_ess:
            ret["ess_mask"] = np.empty(shape, bool)
        sums = moments is not None and moments(shape)
        parts = list(run(functools.partial(
            _crop_slab, scan, lobe, slices, ret, sums),
            range(0, shape[0], SLAB_PLANES)))
        if sums:
            # exact integers: the slabs' order cannot change the moments
            ret["moments"] = moments_from_sums(
                *(sum(p[k] for p in parts) for k in range(3)))
        self.scan_meta_cache[scan_name] = {
            "spacing": spacing, "origin": origin, "direction": direction,
        }
        return ret


def _crop_slab(scan, lobe, crop: Tuple[slice, ...], item: Dict[str, Any],
               sums: bool, z: int) -> Optional[Tuple[int, int, int]]:
    """Planes ``[z, z + SLAB_PLANES)`` of an item's crop, written into its
    arrays: the lung (``lobe > 0``), the crop cast to int16 (a copy in
    ``original_image``), -2048 outside the dilated lung, the -910 HU
    ``ess_mask``; returns the slab's ``window_sums_np`` if ``sums``.

    The reference dilates the whole volume, then crops
    (``dataset.py:68-71``).  The dilation reaches ``DILATE`` voxels, so
    the lung of the slab widened by ``DILATE`` along each axis, clipped to
    the volume (whose outside the reference's dilation reads as 0), gives
    the same dilated lung inside the slab."""
    z0 = crop[0].start + z
    slab = (slice(z0, min(crop[0].stop, z0 + SLAB_PLANES)), *crop[1:])
    near = tuple(slice(max(0, s.start - DILATE), min(n, s.stop + DILATE))
                 for s, n in zip(slab, lobe.shape))
    # the slab's planes, rows and columns inside ``near``
    inner = [(s.start - e.start, s.stop - e.start)
             for s, e in zip(slab, near)]
    lung = lobe[near] > 0
    grown = lung
    for axis, (lo, hi) in enumerate(inner):
        grown = dilate_axis_np(grown, axis, lo, hi, DILATE)
    planes = slice(z, z + slab[0].stop - z0)
    item["lung_mask"][planes] = lung[tuple(slice(*b) for b in inner)]
    raw = scan[slab]
    image = item["image"][planes]
    np.copyto(image, raw, casting="unsafe")     # astype's cast (float CT)
    if "original_image" in item:
        item["original_image"][planes] = image
    np.copyto(image, np.int16(-2048), where=~grown)
    if "ess_mask" in item:
        # NOTE: −910 HU here vs −950 in training — a reference quirk we
        # preserve (dataset.py:79 vs dataset.py:149).  Thresholded on
        # the NATIVE-dtype crop: for float-typed scans a voxel at −910.4
        # must count as ess exactly like the reference's pre-cast
        # compare; inside the lung the mask-out never fires (lung ⊂
        # dilated lung), so the un-masked crop is equivalent to the
        # reference's masked volume here
        np.logical_and(raw < -910, item["lung_mask"][planes],
                       out=item["ess_mask"][planes])
    return window_sums_np(image) if sums else None


class COPDGeneSubtyping:
    """Training dataset over a cached per-series archive: ``{uid}.npz``
    (``image`` int16, ``lung_mask``, ``cls_label``, ``pse_label``) plus
    ``merged.csv`` (``SeriesInstanceUID``, ``CT_Visual_Emph_Severity_P1``,
    ``CT_Visual_Emph_Paraseptal_P1``).  Each item adds the -950 HU
    ``em_mask`` inside the lung and its ``index``."""

    cle_ratio_map = CLE_RATIO_MAP
    pse_ratio_map = PSE_RATIO_MAP

    @classmethod
    def get_series_uids(cls, csv_file) -> List[str]:
        selected, _ = read_csv_in_dict(csv_file, "SeriesInstanceUID")
        return sorted(selected.keys())

    def __init__(self, archive_path: str, series_uids: Sequence[str]):
        self.archive_path = archive_path
        self.series_uids = list(series_uids)
        self.meta, _ = read_csv_in_dict(archive_path + "/merged.csv",
                                        "SeriesInstanceUID")
        self.subtyping_labels: Dict[str, Dict[str, int]] = {}
        for uid in self.series_uids:
            self.subtyping_labels[uid] = {
                "cle": int(float(self.meta[uid]["CT_Visual_Emph_Severity_P1"])),
                "pse": int(float(self.meta[uid]["CT_Visual_Emph_Paraseptal_P1"])),
            }
        # set by the trainer from the sampler (models.py:110-114)
        self.cle_class_weights: Optional[np.ndarray] = None
        self.pse_class_weights: Optional[np.ndarray] = None

    def __len__(self):
        return len(self.series_uids)

    def __getitem__(self, index):
        d = self.get_data(self.series_uids[index])
        d["index"] = np.asarray([index], np.int64)
        return d

    def _load_cached(self, uid: str) -> Dict[str, Any]:
        npz = Path(self.archive_path) / f"{uid}.npz"
        if npz.exists():
            with np.load(npz) as z:
                return {k: z[k] for k in z.files}
        pth = Path(self.archive_path) / f"{uid}.pth"
        if pth.exists():
            return load_torch_cache(pth)
        raise FileNotFoundError(f"no cache entry for series {uid} "
                                f"({npz} / {pth})")

    def get_data(self, uid: str) -> Dict[str, Any]:
        """The cache entry of ``uid`` (an ``io.read`` span) and its
        ``em_mask`` (an ``io.prepare`` span)."""
        with span("io.read"):
            data = self._load_cached(uid)
        with span("io.prepare"):
            data["em_mask"] = np.logical_and(
                np.asarray(data["image"]) < -950,
                np.asarray(data["lung_mask"]) > 0)
        return data
