"""Minimal Praat TextGrid parser and writer, long text format (the JAX
package's ``data/textgrid.py``): interval tiers only, which is what the
corpora carry (the MAUS ``MAU`` phoneme tier, the ``ORT-MAU`` and
``word`` orthographic tiers).
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Dict, List, NamedTuple


class Interval(NamedTuple):
    xmin: float
    xmax: float
    text: str


def parse_textgrid(path) -> Dict[str, List[Interval]]:
    """Parse a long-format TextGrid into {tier_name: [Interval, ...]}."""
    content = Path(path).read_text(encoding="utf-8", errors="replace")
    tiers: Dict[str, List[Interval]] = {}
    # split on item [n] blocks (skip the header item [])
    blocks = re.split(r"item\s*\[\d+\]\s*:", content)[1:]
    for block in blocks:
        name_m = re.search(r'name\s*=\s*"((?:[^"]|"")*)"', block)
        if not name_m:
            continue
        name = name_m.group(1).replace('""', '"')
        intervals: List[Interval] = []
        for im in re.finditer(
            r"intervals\s*\[\d+\]\s*:\s*"
            r"xmin\s*=\s*([\d.eE+-]+)\s*"
            r"xmax\s*=\s*([\d.eE+-]+)\s*"
            r'text\s*=\s*"((?:[^"]|"")*)"',
            block,
        ):
            intervals.append(
                Interval(float(im.group(1)), float(im.group(2)),
                         im.group(3).replace('""', '"'))
            )
        tiers[name] = intervals
    return tiers


def textgrid_phonemes(path, tier: str = "MAU"):
    """Phoneme labels + (start, end) tuples from a MAUS TextGrid —
    ``utility.decode_textgrid_path`` contract (reference utility.py:346-353)."""
    tiers = parse_textgrid(path)
    intervals = tiers[tier]
    labels = [iv.text for iv in intervals]
    timestamps = [(iv.xmin, iv.xmax) for iv in intervals]
    return labels, timestamps


def write_textgrid(path, tiers: Dict[str, List[Interval]]) -> None:
    """Write a long-format TextGrid (used by the synthetic corpus fixture)."""
    xmin = min((iv.xmin for t in tiers.values() for iv in t), default=0.0)
    xmax = max((iv.xmax for t in tiers.values() for iv in t), default=1.0)
    lines = [
        'File type = "ooTextFile"',
        'Object class = "TextGrid"',
        "",
        f"xmin = {xmin}",
        f"xmax = {xmax}",
        "tiers? <exists>",
        f"size = {len(tiers)}",
        "item []:",
    ]
    for i, (name, intervals) in enumerate(tiers.items(), start=1):
        lines += [
            f"    item [{i}]:",
            '        class = "IntervalTier"',
            f'        name = "{name}"',
            f"        xmin = {xmin}",
            f"        xmax = {xmax}",
            f"        intervals: size = {len(intervals)}",
        ]
        for j, iv in enumerate(intervals, start=1):
            lines += [
                f"        intervals [{j}]:",
                f"            xmin = {iv.xmin}",
                f"            xmax = {iv.xmax}",
                f'            text = "{iv.text}"',
            ]
    Path(path).write_text("\n".join(lines) + "\n", encoding="utf-8")
