"""Kraken/Slacken report filter/colorizer (reference: analysis/DisplayReport.scala).

Reads report lines from a stream, filters by rank cutoff, minimum percent,
and/or a clade set (descendants included via indentation level), colorizing
the standard rank levels. Run as:
    python -m slacken.analysis.display [rank-code] [min-percent] < kreport.txt
"""

from __future__ import annotations

import re
import sys
from typing import Optional, Set

from ..taxonomy import RANKS

_COLORS = {
    0: "\033[34m",  # root: blue
    1: "\033[31m",  # superkingdom: red
    2: "\033[32m",  # kingdom: green
    3: "\033[33m",  # phylum: yellow
}
_RESET = "\033[0m"
_CODE_TO_DEPTH = {code: depth for _, code, depth in RANKS}


def color(level: int) -> str:
    return _COLORS.get(level, "\033[37m")


def num_rank_for_code(code: str) -> int:
    return _CODE_TO_DEPTH.get(code, -1)


def filter_report(
    lines,
    level_cutoff: Optional[int] = None,
    min_percent: Optional[float] = None,
    clades: Optional[Set[int]] = None,
    out=None,
    colorize: bool = False,
):
    """Filter report lines (DisplayReport.scala:51-84): keep taxa above the
    rank cutoff and percent floor; with a clade set, keep member taxa and
    everything indented below them."""
    out = out or sys.stdout
    digits = re.compile(r"[0-9]+")
    last_indent = float("inf")
    for line in lines:
        line = line.rstrip("\n")
        if line.startswith("#"):
            continue
        spl = line.split("\t")
        if len(spl) < 6:
            continue
        frac = float(spl[0])
        if min_percent is not None and frac < min_percent:
            continue
        level = digits.sub("", spl[3])
        num_level = num_rank_for_code(level)
        if level_cutoff is not None and num_level > level_cutoff:
            continue
        taxon = int(spl[4])
        m = re.match(r"\s*", spl[5])
        indent = len(m.group(0)) if m else 0

        in_clades = clades is None or taxon in clades
        if in_clades and last_indent > indent:
            last_indent = indent
        if clades is None or in_clades or indent > last_indent:
            if colorize:
                out.write(color(num_level) + line + _RESET + "\n")
            else:
                out.write(line + "\n")
        else:
            last_indent = float("inf")


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    cutoff = num_rank_for_code(argv[0].upper()) if argv else None
    min_percent = float(argv[1]) if len(argv) > 1 else None
    filter_report(sys.stdin, cutoff, min_percent, None, colorize=sys.stdout.isatty())


if __name__ == "__main__":
    main()
