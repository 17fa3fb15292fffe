"""KrakenReport property tests (KrakenReportProps analogue)."""

import numpy as np

from slacken.report import KrakenReport, TreeAggregator
from test_taxonomy import random_taxonomy


def test_report_properties(rng):
    t = random_taxonomy(rng)
    taxa = list(t.taxa())
    counts = [(int(x), int(rng.integers(1, 50))) for x in rng.choice(taxa, 12, replace=False)]
    counts.append((0, 7))  # unclassified
    rep = KrakenReport(t, counts)
    lines = rep.lines()
    assert lines[0].startswith("#Perc")
    body = lines[1:]

    total = sum(c for _, c in counts)
    # parse rows: perc, clade, own, rank, taxid, name
    rows = []
    for line in body:
        perc, clade, own, rank, taxid, name = line.split("\t")
        rows.append((float(perc), int(clade), int(own), rank, int(taxid), name))

    # unclassified line first, then root
    assert rows[0][4] == 0 and rows[0][2] == 7
    assert rows[1][4] == 1

    by_taxid = {r[4]: r for r in rows}
    agg = TreeAggregator(t, counts)
    for taxid, r in by_taxid.items():
        assert r[1] == agg.clade_totals.get(taxid, 0)
        assert r[2] == agg.taxon_counts.get(taxid, 0)
        assert abs(r[0] - 100.0 * r[1] / total) < 0.01
        # clade >= own, and clade == own + sum of children clades
        child_sum = sum(agg.clade_totals.get(c, 0) for c in t.children[taxid])
        assert r[1] == r[2] + child_sum

    # root clade total = classified reads
    assert by_taxid[1][1] == total - 7

    # every reported non-root taxon's parent is reported too (aggregation up)
    for taxid in by_taxid:
        if taxid not in (0, 1):
            assert int(t.parents[taxid]) in by_taxid

    # indentation matches tree depth along parents within the report
    for taxid, r in by_taxid.items():
        if taxid in (0, 1):
            continue
        own_indent = len(r[5]) - len(r[5].lstrip())
        parent = by_taxid[int(t.parents[taxid])]
        parent_indent = len(parent[5]) - len(parent[5].lstrip())
        assert own_indent == parent_indent + 2


def test_report_children_sorted_desc(rng):
    t = random_taxonomy(rng)
    taxa = list(t.taxa())
    counts = [(int(x), int(rng.integers(1, 100))) for x in taxa]
    rep = KrakenReport(t, counts)
    lines = rep.lines()[1:]
    # siblings appear in descending clade-count order: scan each parent's
    # direct children positions
    pos = {int(l.split("\t")[4]): i for i, l in enumerate(lines)}
    clade = {int(l.split("\t")[4]): int(l.split("\t")[1]) for l in lines}
    for p in taxa:
        kids = [c for c in t.children[p] if c in pos]
        order = sorted(kids, key=lambda c: pos[c])
        counts_in_order = [clade[c] for c in order]
        assert counts_in_order == sorted(counts_in_order, reverse=True)
