"""Label distribution by split: counts and frequencies of the CLE and PSE
scores of each CSV, one JSON line per CSV (counterpart of the root
``tools/compute_label_statistics.py``; reference
``compute_label_statistics.py``).

    python -m bodyct_dram_emph_subtype_tpu_torch.tools.compute_label_statistics \\
        --csvs tr.csv,val.csv,te.csv
"""
import argparse
import json
from collections import Counter
from typing import Dict, List, Optional, Sequence

from ..data.csv_utils import read_csv_in_dict


def label_statistics(csv_path: str) -> Dict:
    rows, _ = read_csv_in_dict(csv_path, "SeriesInstanceUID")
    cle = Counter(int(float(r["CT_Visual_Emph_Severity_P1"]))
                  for r in rows.values())
    pse = Counter(int(float(r["CT_Visual_Emph_Paraseptal_P1"]))
                  for r in rows.values())
    n = max(len(rows), 1)
    return {"csv": csv_path, "n": len(rows),
            "cle_counts": {k: cle.get(k, 0) for k in range(6)},
            "cle_freq": {k: round(cle.get(k, 0) / n, 4) for k in range(6)},
            "pse_counts": {k: pse.get(k, 0) for k in range(3)},
            "pse_freq": {k: round(pse.get(k, 0) / n, 4) for k in range(3)}}


def main(argv: Optional[Sequence[str]] = None) -> List[Dict]:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--csvs", required=True,
                        help="comma-separated CSV paths")
    args = parser.parse_args(argv)
    out = []
    for csv_path in args.csvs.split(","):
        out.append(label_statistics(csv_path))
        print(json.dumps(out[-1]))
    return out


if __name__ == "__main__":
    main()
