#!/usr/bin/env python
"""End-to-end accuracy demonstration: 1-step vs 2-step dynamic classification
on a synthetic community (the reference's headline result — 2-step improves
taxon precision and read sensitivity, README.md:300-330, All_metrics.tsv).

Builds a 20-genome library with sibling species pairs, samples mutated reads
from a 5-genome sub-community, classifies with the base index and with
classify2's dynamically detected index, and scores both against the known
ground truth with the MappingComparison metrics.
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")

    from slacken.analysis.mapping_comparison import MappingComparison
    from slacken.classify import Classifier, ClassifyParams, Fragment
    from slacken.dynamic import ClassifiedReadCount, Dynamic
    from slacken.index import IndexParams, KeyValueIndex
    from slacken.taxonomy import Taxonomy

    rng = np.random.default_rng(11)
    lut = np.frombuffer(b"ACGT", dtype=np.uint8)

    def gen(n):
        return lut[rng.integers(0, 4, n)].tobytes().decode()

    def mutate(seq, rate):
        arr = np.frombuffer(seq.encode(), np.uint8).copy()
        pos = rng.random(len(arr)) < rate
        arr[pos] = lut[rng.integers(0, 4, pos.sum())]
        return arr.tobytes().decode()

    # taxonomy: 10 genera x 2 sibling species
    nodes = [(1, 1, "root")]
    for g in range(10):
        nodes.append((10 + g, 1, "genus"))
        nodes.append((100 + 2 * g, 10 + g, "species"))
        nodes.append((101 + 2 * g, 10 + g, "species"))
    tax = Taxonomy.from_nodes_and_names(nodes, [(t, f"n{t}") for t, _, _ in nodes])

    # sibling species share 70% of their genome (the confusion source)
    genomes = []
    for g in range(10):
        core = gen(1_500_000)
        a = core[:1_050_000] + gen(450_000)
        b = core[:1_050_000] + gen(450_000)
        genomes.append((100 + 2 * g, a))
        genomes.append((101 + 2 * g, b))

    t0 = time.time()
    idx = KeyValueIndex.build(
        genomes, IndexParams(), tax, batch_rows=64, row_len=1 << 16, keep_records=True
    )
    print(f"base index: {len(idx.keys) / 1e6:.1f}M records in {time.time() - t0:.0f}s")

    # community: 5 species present
    present = [100, 103, 104, 109, 112]
    by_taxon = dict(genomes)
    frags, truth = [], {}
    for i in range(20000):
        src = present[i % 5]
        g = by_taxon[src]
        s = int(rng.integers(0, len(g) - 150))
        frags.append(Fragment(f"read{i}", mutate(g[s : s + 150], 0.02)))
        truth[f"read{i}"] = src

    class Lib:
        def sequences(self):
            for t, s in genomes:
                yield t, f"seq{t}", s

        def taxa_sequences(self):
            return iter(genomes)

        def taxon_set(self, taxonomy):
            return taxonomy.taxa_with_ancestors([t for t, _ in genomes])

    def score(results, label):
        cmp_data = {r.title: r.taxon for r in results}
        mc = MappingComparison(tax, 2, 3, False, min_count_taxon=10)
        pt = mc.per_taxon(cmp_data, truth, 8)
        pr = mc.per_read(cmp_data, truth, 8)
        print(
            f"{label}: taxon precision {pt.precision:.3f} recall {pt.recall:.3f} | "
            f"read ppv {pr.ppv:.3f} sensitivity {pr.sensitivity:.3f} "
            f"(tp={pr.tp} vp={pr.vp} fp={pr.fp} fn={pr.fn})"
        )
        return pt, pr

    cpar = ClassifyParams(thresholds=[0.05], per_read_output=False)
    one_step = Classifier(idx).classify(frags, cpar)[0.05]
    score(one_step, "1-step  ")

    out = "/tmp/accuracy_demo"
    dyn = Dynamic(idx, Lib(), 8, ClassifiedReadCount(100, 0.15), cpar, None, out)
    dyn_idx = dyn.make_records(frags)[0]
    two_step = Classifier(dyn_idx).classify(frags, cpar)[0.05]
    score(two_step, "2-step  ")


if __name__ == "__main__":
    main()
