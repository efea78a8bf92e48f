"""Build the training cache: paired scan/lobe MHA directories and a labels
CSV become per-series ``{uid}.npz`` archives and ``merged.csv``, the
archive the port's trainer reads (``data/datasets.py::
COPDGeneSubtyping``).

Counterpart of the root ``tools/build_cache.py``, with the same keys,
dtypes and crop: the per-scan preparation of the deployment dataset
(``data/datasets.py::SubtypingInference``: lung = lobe > 0, dilated
twice, -2048 outside it, cropped to the lung's box plus a 5 mm border);
``image`` int16, ``lung_mask`` bool, ``cls_label`` and ``pse_label``.

    python -m bodyct_dram_emph_subtype_tpu_torch.tools.build_cache \\
        --scan_path ct/ --lobe_path lobes/ --labels_csv labels.csv \\
        --output_path cache/

``--torch_cache DIR`` converts a reference cache of ``{uid}.pth`` dicts
(``dataset.py:148``) and its ``merged.csv`` instead; the files are read
with ``torch.load(weights_only=True)``, which takes their tensors and
integer labels and refuses other pickled objects.
"""
import argparse
import shutil
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from ..data.csv_utils import read_csv_in_dict
from ..data.datasets import SubtypingInference

HEADER = ("SeriesInstanceUID,CT_Visual_Emph_Severity_P1,"
          "CT_Visual_Emph_Paraseptal_P1")


def convert_torch_cache(torch_cache: Path, output: Path) -> None:
    import torch
    output.mkdir(parents=True, exist_ok=True)
    for pth in sorted(torch_cache.glob("*.pth")):
        data = torch.load(pth, map_location="cpu", weights_only=True)
        np.savez_compressed(
            output / f"{pth.stem}.npz",
            **{k: (v.numpy() if isinstance(v, torch.Tensor)
                   else np.asarray(v)) for k, v in data.items()})
        print(f"converted {pth.stem}")
    csv = torch_cache / "merged.csv"
    if csv.exists():
        shutil.copy(csv, output / "merged.csv")


def build_from_mha(scan_path: str, lobe_path: str, labels_csv: str,
                   output: Path) -> None:
    output.mkdir(parents=True, exist_ok=True)
    labels, _ = read_csv_in_dict(labels_csv, "SeriesInstanceUID")
    ds = SubtypingInference(scan_path, lobe_path, keep_original=False,
                            compute_ess=False)
    rows = [HEADER]
    for i in range(len(ds)):
        item = ds[i]
        uid = item["uid"]
        if uid not in labels:
            print(f"skip {uid}: no labels")
            continue
        cle = int(float(labels[uid]["CT_Visual_Emph_Severity_P1"]))
        pse = int(float(labels[uid]["CT_Visual_Emph_Paraseptal_P1"]))
        np.savez_compressed(output / f"{uid}.npz",
                            image=item["image"].astype(np.int16),
                            lung_mask=item["lung_mask"].astype(bool),
                            cls_label=cle, pse_label=pse)
        rows.append(f"{uid},{cle},{pse}")
        print(f"cached {uid} {item['image'].shape}")
    (output / "merged.csv").write_text("\n".join(rows) + "\n")


def main(argv: Optional[Sequence[str]] = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--scan_path", type=str)
    parser.add_argument("--lobe_path", type=str)
    parser.add_argument("--labels_csv", type=str)
    parser.add_argument("--torch_cache", type=str)
    parser.add_argument("--output_path", required=True, type=str)
    args = parser.parse_args(argv)
    output = Path(args.output_path)
    if args.torch_cache:
        convert_torch_cache(Path(args.torch_cache), output)
    else:
        if not (args.scan_path and args.lobe_path and args.labels_csv):
            parser.error("need --scan_path --lobe_path --labels_csv "
                         "(or --torch_cache)")
        build_from_mha(args.scan_path, args.lobe_path, args.labels_csv,
                       output)


if __name__ == "__main__":
    main()
