"""stat.csv logging with the reference's file format (reference
``save_result_stat``, src/util.py:853-866; JAX ``training/stats.py``).

One row per call is appended to ``<ckpt_path>/stat.csv`` under the header
``,info,<sorted stat keys>`` that the first call writes; the unnamed first
column is the pandas index, always 0.  The file is byte for byte what
pandas' ``to_csv`` writes, without pandas: floats as ``repr``, infinities
as ``inf``/``-inf``, NaN as an empty field (pandas' ``na_rep=''``), quoting
only where a field needs it, lines ended by a newline.
"""

from __future__ import annotations

import csv
import math
import os
from typing import Dict


def _field(v: float) -> str:
    return "" if math.isnan(v) else repr(v)


def save_result_stat(stat: Dict[str, float], ckpt_path: str,
                     info: str = "Default") -> None:
    stat = {k: float(v) for k, v in stat.items()}
    stat_path = os.path.join(ckpt_path, "stat.csv")
    keys = sorted(stat)
    rows = []
    if not os.path.exists(stat_path):
        rows.append(["", "info"] + keys)
    rows.append(["0", info] + [_field(stat[k]) for k in keys])
    with open(stat_path, "a", newline="") as f:
        csv.writer(f, lineterminator="\n").writerows(rows)
