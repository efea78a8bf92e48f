"""CSV helpers (parity with ``read_csv_in_dict``, reference ``utils.py:40-50``).

Numpy-free copy of ``bodyct_dram_emph_subtype_tpu/data/csv_utils.py``.
"""
from __future__ import annotations

import csv
import os
from typing import Dict, Optional, Tuple


def read_csv_in_dict(csv_file_path, column_key, fieldnames=None
                     ) -> Tuple[Dict[str, dict], Optional[list]]:
    """Index a CSV by ``column_key``; returns ({key: row_dict}, fieldnames).

    Missing files return an empty dict (reference behavior,
    ``utils.py:42-43``).
    """
    row_dict: Dict[str, dict] = {}
    if not os.path.exists(csv_file_path):
        return row_dict, None
    with open(csv_file_path, "rt", newline="") as fp:
        reader = csv.DictReader(fp, delimiter=",", fieldnames=fieldnames)
        for row in reader:
            row_dict[row[column_key]] = row
        names = reader.fieldnames
    return row_dict, list(names) if names else None
