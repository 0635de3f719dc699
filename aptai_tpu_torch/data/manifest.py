"""Manifests as lists of rows, over the standard ``csv`` module.

A manifest is a CSV file with a header line; a row is a dict from column
name to cell text. The JAX package writes and reads its manifests with
pandas (``DataFrame.to_csv(index=False)`` and ``pd.read_csv``); this
module reads those files and writes files that pandas reads back to the
same values:

* an empty cell reads as ``None`` (pandas' NaN, e.g. a missing
  ``path_f0``) and ``None`` writes as an empty cell;
* every other cell stays text: lists such as ``phoneme_timestamps`` are
  the ``str()`` of a Python list, which the datasets parse with
  ``ast.literal_eval``; a value written is its ``str()``, as pandas writes
  it;
* fields are quoted only where needed, lines end in ``\\n`` (pandas'
  defaults).
"""

from __future__ import annotations

import csv
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence

Row = Dict[str, Optional[str]]


def read_rows(path) -> List[Row]:
    """The rows of a CSV manifest, in file order."""
    with open(path, encoding="utf-8", newline="") as f:
        return [{k: (v if v != "" else None) for k, v in row.items()}
                for row in csv.DictReader(f)]


def write_rows(path, rows: Sequence[Dict],
               columns: Optional[Sequence[str]] = None) -> Path:
    """Write ``rows`` (dicts) as a CSV manifest with the header
    ``columns`` (the first row's keys by default); returns the path."""
    columns = list(rows[0]) if columns is None else list(columns)
    with open(path, "w", encoding="utf-8", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(columns)
        w.writerows(["" if row.get(c) is None else str(row.get(c))
                     for c in columns] for row in rows)
    return Path(path)


def select(rows: Iterable[Row], column: str, value) -> List[Row]:
    """The rows whose ``column`` is ``value`` (compared as text), in
    order."""
    return [r for r in rows if r.get(column) == str(value)]


def unique(rows: Iterable[Row], column: str) -> List:
    """The values of ``column`` in order of first appearance (pandas'
    ``Series.unique``)."""
    return list(dict.fromkeys(r.get(column) for r in rows))
