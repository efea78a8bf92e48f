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

import glob
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from ..ops.morphology import binary_dilate_np, find_crops_np
from .csv_utils import read_csv_in_dict
from .mha import read_mha

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


class SubtypingInference:
    """Deployment dataset over paired scan/lobe ``.mha`` directories."""

    def __init__(self, scan_path: str, lobe_path: str, crop_border: int = 5,
                 keep_original: bool = True, compute_ess: bool = True):
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

    def get_data(self, index) -> Dict[str, Any]:
        scan_file = self.scan_files[index]
        lobe_file = self.lobe_files[index]
        scan_name = Path(scan_file).stem
        scan, origin, spacing, direction = self.read_image(scan_file)
        original_size = scan.shape
        lobe, *_ = self.read_image(lobe_file)
        if lobe.shape != scan.shape:
            raise ValueError(f"{scan_name}: scan {scan.shape} and lobe "
                             f"segmentation {lobe.shape} differ in shape")
        lung = lobe > 0
        slices = find_crops_np(lung, spacing, self.crop_border)
        # crop FIRST, then dilate + mask out only the crop: the reference
        # dilates the whole volume before cropping (dataset.py:69-71), but
        # the 2-iteration 3^3 dilation reaches exactly 2 voxels, so
        # dilating the crop expanded by 2 reproduces the full-volume
        # dilation everywhere inside the crop — identical output at a
        # fraction of the host work, and the full scan is never copied
        # astype (always copies) — scan may be the codec's read-only
        # zero-copy file view, and the crop can alias the whole volume
        image = scan[slices].astype(np.int16)
        original = image.copy() if self.keep_original else None
        ext = tuple(slice(max(0, s.start - 2), min(n, s.stop + 2))
                    for s, n in zip(slices, lung.shape))
        inner = tuple(slice(s.start - e.start,
                            s.start - e.start + (s.stop - s.start))
                      for s, e in zip(slices, ext))
        dlung = binary_dilate_np(lung[ext], iterations=2)[inner]
        image[~dlung] = -2048
        lung = lung[slices]
        ret = {
            "image": image,
            "lung_mask": lung,
            "crop_slice": np.asarray([(s.start, s.stop) for s in slices]),
            "original_size": np.asarray(original_size),
            "uid": scan_name,
        }
        if original is not None:
            ret["original_image"] = original
        if self.compute_ess:
            # NOTE: −910 HU here vs −950 in training — a reference quirk we
            # preserve (dataset.py:79 vs dataset.py:149).  Thresholded on
            # the NATIVE-dtype crop (a view, no copy): for float-typed
            # scans a voxel at −910.4 must count as ess exactly like the
            # reference's pre-cast compare; inside the lung the mask-out
            # never fires (lung ⊂ dilated lung), so the un-masked view is
            # equivalent to the reference's masked volume here
            ret["ess_mask"] = np.logical_and(
                np.asarray(scan[slices]) < -910, lung)
        self.scan_meta_cache[scan_name] = {
            "spacing": spacing, "origin": origin, "direction": direction,
        }
        return ret


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
        data = self._load_cached(uid)
        data["em_mask"] = np.logical_and(np.asarray(data["image"]) < -950,
                                         np.asarray(data["lung_mask"]) > 0)
        return data
