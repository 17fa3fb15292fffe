import numpy as np

import oracle
from slacken.index import IndexParams, KeyValueIndex
from slacken.stats import (
    TotalKmerSizeAggregator,
    depth_histograms,
    library_span_data,
    taxon_full_coverage_stats,
    total_kmer_count_report,
)
from slacken.taxonomy import Taxonomy
from test_index import make_genomes, random_genome
from test_taxonomy import random_taxonomy


class FakeLibrary:
    def __init__(self, genomes):
        self.genomes = genomes
        self.labels = {f"seq{t}": t for t, _ in genomes}

    def sequences(self):
        for taxon, seq in self.genomes:
            yield taxon, f"seq{taxon}", seq


def test_library_kmer_counts(rng):
    """Per-taxon total k-mer counts match a naive count of valid windows
    (the quantity KMC/Discount-verified in the reference's ground truths,
    Testing.scala:171-173 pattern)."""
    t = random_taxonomy(rng)
    genomes = make_genomes(rng, t, n_genomes=3, length=700)
    # insert Ns to exercise ambiguity accounting
    taxon0, seq0 = genomes[0]
    genomes[0] = (taxon0, seq0[:300] + "NN" + seq0[302:])
    idx = KeyValueIndex.build(genomes, IndexParams(), t)
    counts, keys, taxa = library_span_data(idx, FakeLibrary(genomes))
    k = 35
    for taxon, seq in genomes:
        codes = oracle.encode(seq)
        want = sum(
            1
            for i in range(len(seq) - k + 1)
            if all(c < 4 for c in codes[i : i + k])
        )
        assert counts[taxon] == want

    # span records agree with oracle span count
    for taxon, seq in genomes:
        want_spans = 0
        codes = oracle.encode(seq)
        i = 0
        while i < len(codes):
            j = i
            while j < len(codes) and (codes[j] < 4) == (codes[i] < 4):
                j += 1
            if codes[i] < 4 and j - i >= k:
                want_spans += len(oracle.spans(codes[i:j], k, 31, 7))
            i = j
        assert (taxa == taxon).sum() == want_spans


def test_tkc_aggregator():
    nodes = [
        (1, 1, "root"),
        (10, 1, "genus"),
        (100, 10, "species"),
        (101, 10, "species"),
        (11, 1, "genus"),
        (110, 11, "species"),
    ]
    t = Taxonomy.from_nodes_and_names(nodes, [(x, f"N{x}") for x, _, _ in nodes])
    sizes = {100: 1000, 101: 3000, 110: 500}
    agg = TotalKmerSizeAggregator(t, sizes)
    # leaf: own size
    assert agg.s1(100) == 1000
    assert agg.s2(100) == 1000
    # genus 10: leaves 1000, 3000
    assert agg.s1(10) == 2000
    assert agg.s2(10) == 2000
    # root: S1 over all leaves; S2 avg of child averages (2000, 500)
    assert agg.s1(1) == (1000 + 3000 + 500) / 3
    assert agg.s2(1) == (2000 + 500) / 2
    # S3 = weighted mix: (S1*3 + S2*2) / 5
    assert abs(agg.s3(1) - (agg.s1(1) * 3 + agg.s2(1) * 2) / 5) < 1e-9


def test_coverage_and_report(rng):
    t = random_taxonomy(rng)
    genomes = make_genomes(rng, t, n_genomes=3, length=500)
    idx = KeyValueIndex.build(genomes, IndexParams(), t)
    lib = FakeLibrary(genomes)

    rows = taxon_full_coverage_stats(idx, lib)
    assert len(rows) == 3
    for taxon, covs, dcovs in rows:
        # all minimizers of a uniquely-sourced genome sit at the leaf depth
        d = t.depth(taxon)
        assert covs.startswith(f"{d}:")
        total = sum(int(p.split(":")[1]) for p in covs.split("|"))
        distinct = sum(int(p.split(":")[1]) for p in dcovs.split("|"))
        assert total >= distinct > 0

    rep = total_kmer_count_report(idx, lib)
    lines = rep.lines()
    assert lines[0].count("TKC") == 3
    kmer_h, taxon_h = depth_histograms(idx)
    assert sum(c for _, _, c in kmer_h) == len(idx.keys)
