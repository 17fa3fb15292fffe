import numpy as np

import oracle
from slacken import taxonomy as tx
from slacken.ops import lca as dlca
from slacken.ops import resolve as dresolve


def random_taxonomy(rng, size=40):
    """Level-structured random taxonomy, mirroring the reference generator
    (slacken/Testing.scala:62-83): 8 rank levels with fixed ID ranges, each
    node's parent drawn from lower-numbered IDs."""
    level_size = size // 8 + 1
    nodes = [(1, 1, "root")]
    names = [(1, "root")]
    for depth in range(1, 9):
        lo = (depth - 1) * level_size + 2
        hi = depth * level_size + 2
        max_parent = (depth - 1) * level_size + 1
        title = tx.RANK_TITLES[depth]
        for taxid in range(lo, hi):
            parent = int(rng.integers(1, max_parent + 1))
            nodes.append((taxid, parent, title))
            names.append((taxid, f"Taxon {taxid}"))
    return tx.Taxonomy.from_nodes_and_names(nodes, names)


def test_basic_structure(rng):
    t = random_taxonomy(rng)
    assert t.is_defined(1)
    assert not t.is_defined(0)
    for taxon in t.taxa():
        path = list(t.path_to_root(taxon))
        assert path[-1] == 1
        assert len(path) <= t.max_path_len
        # standardized depth is the rank depth here (all nodes ranked)
        assert t.depth(taxon) == t.rank_depth[taxon]


def test_lca_host_vs_oracle(rng):
    t = random_taxonomy(rng)
    parents = {i: int(p) for i, p in enumerate(t.parents)}
    taxa = [x for x in t.taxa()]
    for _ in range(200):
        a, b = rng.choice(taxa), rng.choice(taxa)
        assert t.lca(int(a), int(b)) == oracle.lca(parents, int(a), int(b))


def test_lca_device_vs_oracle(rng):
    t = random_taxonomy(rng)
    parents = {i: int(p) for i, p in enumerate(t.parents)}
    taxa = [x for x in t.taxa()]
    n = 300
    a = rng.choice(taxa, n).astype(np.int32)
    b = rng.choice(taxa, n).astype(np.int32)
    # include NONE edge cases
    a[:10] = 0
    b[5:15] = 0
    got = np.asarray(dlca.lca_pairs(a, b, t.parents, t.max_path_len))
    want = [oracle.lca(parents, int(x), int(y)) for x, y in zip(a, b)]
    assert got.tolist() == want


def test_segment_lca(rng):
    t = random_taxonomy(rng)
    parents = {i: int(p) for i, p in enumerate(t.parents)}
    taxa_pool = [x for x in t.taxa()]
    # build random runs
    run_taxa, run_ids, want = [], [], []
    rid = 0
    for _ in range(60):
        run = [int(rng.choice(taxa_pool)) for _ in range(int(rng.integers(1, 6)))]
        acc = 0  # NONE identity
        for x in run:
            acc = oracle.lca(parents, acc, x)
        want.append(acc)
        run_taxa += run
        run_ids += [rid] * len(run)
        rid += 1
    got = np.asarray(
        dlca.segment_lca(
            np.array(run_ids, np.int32), np.array(run_taxa, np.int32), t.parents, t.max_path_len
        )
    )
    assert got[: len(want)].tolist() == want


def test_resolve_tree_vs_oracle(rng):
    t = random_taxonomy(rng, size=60)
    parents = {i: int(p) for i, p in enumerate(t.parents)}
    taxa_pool = [x for x in t.taxa()]

    B, T = 64, 16
    taxa = np.zeros((B, T), np.int32)
    counts = np.zeros((B, T), np.int32)
    totals = np.zeros(B, np.int64)
    for b in range(B):
        nt = int(rng.integers(0, 8))
        chosen = rng.choice(taxa_pool, nt, replace=False) if nt else []
        for j, x in enumerate(chosen):
            taxa[b, j] = x
            counts[b, j] = int(rng.integers(1, 20))
        # unknown (NONE) and ambiguous k-mers inflate the denominator
        totals[b] = counts[b].sum() + int(rng.integers(0, 30))

    res = dresolve.resolve_hits(taxa, counts, t.rpath_table())

    import math

    for conf in [0.0, 0.05, 0.15, 0.5, 0.9, 1.0]:
        required = np.array([math.ceil(conf * tt) for tt in totals], np.float64)
        got = dresolve.pick_threshold_host(res, required)
        for b in range(B):
            hit_counts = {int(taxa[b, j]): int(counts[b, j]) for j in range(T) if taxa[b, j] != 0}
            want = oracle.resolve_tree(parents, hit_counts, required[b])
            assert got[b] == want, f"read {b} conf {conf}: got {got[b]} want {want} hits {hit_counts}"


def test_resolve_with_ties(rng):
    """Force exact score ties so the LCA tie-break path is exercised."""
    t = random_taxonomy(rng, size=60)
    parents = {i: int(p) for i, p in enumerate(t.parents)}
    leaves = [x for x in t.taxa() if t.is_leaf(x)]
    B = 32
    taxa = np.zeros((B, 16), np.int32)
    counts = np.zeros((B, 16), np.int32)
    for b in range(B):
        a, c = rng.choice(leaves, 2, replace=False)
        taxa[b, 0], taxa[b, 1] = a, c
        counts[b, 0] = counts[b, 1] = 5
    res = dresolve.resolve_hits(taxa, counts, t.rpath_table())
    got = dresolve.pick_threshold_host(res, np.zeros(B))
    for b in range(B):
        hits = {int(taxa[b, 0]): 5, int(taxa[b, 1]): 5}
        want = oracle.resolve_tree(parents, hits, 0.0)
        assert got[b] == want


def test_compact_hits():
    wt = np.array(
        [
            [5, 5, 0, 7, 7, 7, -3, -3, 5],
            [-3] * 9,
            [0] * 9,
        ],
        np.int32,
    )
    ch = dresolve.compact_hits(wt, 4)
    assert np.asarray(ch.taxa)[0].tolist() == [5, 7, 0, 0]
    assert np.asarray(ch.counts)[0].tolist() == [3, 3, 0, 0]
    assert np.asarray(ch.n_hit_kmers).tolist() == [6, 0, 0]
    assert np.asarray(ch.n_none_kmers).tolist() == [1, 0, 9]
    assert not np.asarray(ch.overflow).any()
    # overflow detection
    wt2 = np.arange(1, 10, dtype=np.int32)[None, :]
    ch2 = dresolve.compact_hits(wt2, 4)
    assert np.asarray(ch2.overflow)[0]


def test_taxonomy_save_load(tmp_path, rng):
    t = random_taxonomy(rng)
    t.save(str(tmp_path))
    t2 = tx.Taxonomy.load(str(tmp_path))
    assert t2.size == t.size
    assert np.array_equal(t2.parents, t.parents)
    assert np.array_equal(t2.rank_depth, t.rank_depth)
    for x in t.taxa():
        assert t2.get_name(x) == t.get_name(x)


def test_clade_closures(rng):
    t = random_taxonomy(rng)
    taxa = list(t.taxa())
    picks = [int(x) for x in rng.choice(taxa, 5, replace=False)]
    up = t.taxa_with_ancestors(picks)
    # closure contains picks, root, and every member's parent
    assert set(picks) <= up and 1 in up
    for x in up:
        if x != 1:
            assert int(t.parents[x]) in up
    down = t.taxa_with_descendants(picks)
    assert set(picks) <= down
    for x in down:
        for c in t.children[x]:
            assert c in down
    assert t.count_distinct_taxa_with_ancestors(picks) == len(up)


def test_ancestor_levels(rng):
    t = random_taxonomy(rng)
    for x in list(t.taxa())[:30]:
        d = t.depth(x)
        # ancestor at own level is itself (or a same-depth ancestor)
        a = t.ancestor_at_level(x, d)
        assert a is not None and t.depth(a) == d and t.has_ancestor(x, a)
        sa = t.standard_ancestor_at_level(x, d)
        assert sa is not None and t.has_ancestor(x, sa)
        # at root level we always find ROOT
        assert t.ancestor_at_level(x, 0) == 1
        # standard steps consistent with depths
        anc = t.ancestor_at_level(x, max(0, d - 2))
        if anc is not None:
            assert t.standard_steps_to_ancestor(x, anc) == d - t.depth(anc)
