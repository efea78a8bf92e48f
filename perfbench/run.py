#!/usr/bin/env python3
"""Run one cell of the benchmark and print its result as the last line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

See ``perfbench/harness.py`` for what is read from where.
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from perfbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main())
