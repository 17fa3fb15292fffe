import numpy as np

import oracle
from slacken.index import IndexParams, KeyValueIndex
from slacken.ops import lookup as lookup_ops
from slacken.ops import u64
from test_taxonomy import random_taxonomy


def random_genome(rng, n):
    return "".join("ACGT"[i] for i in rng.integers(0, 4, n))


def oracle_index(genomes, k, m, s, parents):
    """(minimizer -> LCA taxon) built naively from per-genome spans."""
    by_min = {}
    for taxon, seq in genomes:
        for _, _, value, _ in oracle.spans(oracle.encode(seq), k, m, s):
            if value in by_min:
                by_min[value] = oracle.lca(parents, by_min[value], taxon)
            else:
                by_min[value] = taxon
    return by_min


def make_genomes(rng, t, n_genomes=6, length=600):
    leaves = [x for x in t.taxa() if t.is_leaf(x)]
    chosen = rng.choice(leaves, n_genomes, replace=False)
    return [(int(tx), random_genome(rng, length)) for tx in chosen]


def test_build_matches_oracle(rng):
    t = random_taxonomy(rng)
    parents = {i: int(p) for i, p in enumerate(t.parents)}
    genomes = make_genomes(rng, t)
    # duplicate one genome under a different taxon to force LCA merging
    genomes.append((genomes[0][0], genomes[1][1]))

    params = IndexParams(k=35, m=31, spaces=7)
    idx = KeyValueIndex.build(genomes, params, t, row_len=256)

    want = oracle_index(genomes, 35, 31, 7, parents)
    got = dict(zip(idx.keys.tolist(), idx.taxa.tolist()))
    assert got == want
    assert np.all(np.diff(idx.keys.astype(np.uint64)) > 0)  # sorted unique


def test_save_load_roundtrip(rng, tmp_path):
    t = random_taxonomy(rng)
    genomes = make_genomes(rng, t, n_genomes=3, length=300)
    idx = KeyValueIndex.build(genomes, IndexParams(), t)
    idx.save(str(tmp_path / "idx"))
    idx2 = KeyValueIndex.load(str(tmp_path / "idx"))
    assert np.array_equal(idx2.keys, idx.keys)
    assert np.array_equal(idx2.taxa, idx.taxa)
    assert idx2.params.to_json() == idx.params.to_json()
    assert np.array_equal(idx2.taxonomy.parents, idx.taxonomy.parents)


def test_lookup(rng):
    t = random_taxonomy(rng)
    genomes = make_genomes(rng, t)
    idx = KeyValueIndex.build(genomes, IndexParams(), t)

    n = len(idx.keys)
    # present queries
    pick = rng.integers(0, n, 200)
    q = idx.keys[pick]
    qk = lookup_ops.keys_from_numpy(q)
    got = np.asarray(idx.lookup(qk.hi, qk.lo))
    assert np.array_equal(got, idx.taxa[pick])

    # absent queries -> NONE
    absent = []
    present = set(idx.keys.tolist())
    while len(absent) < 50:
        v = int(rng.integers(0, 1 << 62))
        if v not in present:
            absent.append(v)
    qk = lookup_ops.keys_from_numpy(np.array(absent, np.uint64))
    got = np.asarray(idx.lookup(qk.hi, qk.lo))
    assert np.all(got == 0)

    # boundary keys: first and last
    qk = lookup_ops.keys_from_numpy(idx.keys[[0, n - 1]])
    got = np.asarray(idx.lookup(qk.hi, qk.lo))
    assert np.array_equal(got, idx.taxa[[0, n - 1]])


def test_respace(rng):
    t = random_taxonomy(rng)
    parents = {i: int(p) for i, p in enumerate(t.parents)}
    genomes = make_genomes(rng, t, n_genomes=4)
    idx = KeyValueIndex.build(genomes, IndexParams(k=35, m=31, spaces=3), t)
    re = idx.respace(7)
    assert re.params.spaces == 7
    # respaced index contents == index built directly with s=7?
    # Not exactly: respace merges priorities that differ only in masked bits.
    # Build directly and compare (both reduce the same record multiset).
    direct = KeyValueIndex.build(genomes, IndexParams(k=35, m=31, spaces=7), t)
    # respace of per-window values equals windows of respaced values only when
    # the window minimum is preserved; like the reference this is a lossy
    # projection, so compare key sets loosely: every direct key must exist in
    # the respaced key set (projection can only merge or reorder priorities
    # within windows).
    got = set(re.keys.tolist())
    assert len(got) == len(re.keys)
    assert np.all(np.diff(re.keys.astype(np.uint64)) > 0)


def test_build_skips_undefined_and_filtered(rng):
    t = random_taxonomy(rng)
    genomes = make_genomes(rng, t, n_genomes=4)
    bogus_taxon = t.size + 50  # not defined
    genomes2 = genomes + [(bogus_taxon, random_genome(rng, 300))]
    idx_a = KeyValueIndex.build(genomes, IndexParams(), t)
    idx_b = KeyValueIndex.build(genomes2, IndexParams(), t)
    assert np.array_equal(idx_a.keys, idx_b.keys)

    only = {genomes[0][0]}
    idx_f = KeyValueIndex.build(genomes, IndexParams(), t, taxon_filter=only)
    assert set(np.unique(idx_f.taxa).tolist()) <= only


def test_full_records_sidecar(rng, tmp_path):
    from slacken.index import KeyValueIndex as KVI

    t = random_taxonomy(rng)
    genomes = make_genomes(rng, t, n_genomes=5, length=500)
    idx = KVI.build(genomes, IndexParams(), t, keep_records=True)
    assert idx.record_keys is not None
    idx.save(str(tmp_path / "idx"))
    idx2 = KVI.load(str(tmp_path / "idx"))
    assert idx2.record_keys is not None

    subset = {genomes[0][0], genomes[1][0]}
    fast = idx2.build_restricted(subset)
    direct = KVI.build(genomes, IndexParams(), t, taxon_filter=subset)
    assert np.array_equal(fast.keys, direct.keys)
    assert np.array_equal(fast.taxa, direct.taxa)


def test_sharded_persistence(rng, tmp_path):
    t = random_taxonomy(rng)
    genomes = make_genomes(rng, t, n_genomes=3, length=400)
    idx = KeyValueIndex.build(genomes, IndexParams(buckets=4), t)
    loc = str(tmp_path / "sharded")
    idx.save_sharded(loc)
    full = KeyValueIndex.load_shards(loc)
    assert np.array_equal(full.keys, idx.keys)
    assert np.array_equal(full.taxa, idx.taxa)
    # single-shard load is a contiguous sorted range
    part = KeyValueIndex.load_shards(loc, [1])
    assert len(part.keys) > 0
    assert np.all(np.diff(part.keys.astype(np.uint64)) > 0)
    i0 = np.searchsorted(idx.keys, part.keys[0])
    assert np.array_equal(idx.keys[i0 : i0 + len(part.keys)], part.keys)


def test_merged_dmp_canonicalization(rng):
    """Labels carrying secondary (merged) taxon IDs are canonicalised to
    primary IDs at build time (Taxonomy.primary, Taxonomy.scala:100-103)."""
    t = random_taxonomy(rng)
    real = next(x for x in t.taxa() if t.is_leaf(x))
    # create a secondary alias for `real`
    n = t.size
    import numpy as np

    primary = np.concatenate([t.primary, np.arange(n, n + 5, dtype=np.int32)])
    parents = np.concatenate([t.parents, np.zeros(5, np.int32)])
    rank_depth = np.concatenate([t.rank_depth, np.full(5, -128, np.int16)])
    primary[n + 2] = real
    from slacken.taxonomy import Taxonomy

    t2 = Taxonomy(parents, rank_depth, t.names + [None] * 5, primary, None)
    g = random_genome(rng, 400)
    via_alias = KeyValueIndex.build([(n + 2, g)], IndexParams(), t2)
    via_real = KeyValueIndex.build([(int(real), g)], IndexParams(), t2)
    assert np.array_equal(via_alias.keys, via_real.keys)
    assert np.array_equal(via_alias.taxa, via_real.taxa)


def test_spilled_build_matches_in_memory(rng, tmp_path):
    """Out-of-core (range-spilled) build must produce the identical index."""
    t = random_taxonomy(rng)
    genomes = make_genomes(rng, t, n_genomes=5, length=700)
    genomes.append((genomes[0][0], genomes[1][1]))  # cross-taxon duplicates
    mem = KeyValueIndex.build(genomes, IndexParams(), t, keep_records=True)
    spill = KeyValueIndex.build(
        genomes, IndexParams(), t, keep_records=True, spill_dir=str(tmp_path / "spill")
    )
    assert np.array_equal(mem.keys, spill.keys)
    assert np.array_equal(mem.taxa, spill.taxa)
    assert np.array_equal(mem.record_keys, spill.record_keys)
    assert np.array_equal(mem.record_taxa, spill.record_taxa)
    import os

    assert not os.path.exists(str(tmp_path / "spill"))  # cleaned up


def test_remote_storage_memory_fs(rng):
    """Index + taxonomy persistence works against a remote fsspec URI
    (memory://), matching the reference's HDFS/S3/GCS support
    (HDFSUtil.scala:31-156). Covers save/load, sharded layouts, and the
    per-host shard loader."""
    import pytest

    fsspec = pytest.importorskip("fsspec")
    from slacken import storage

    t = random_taxonomy(rng)
    genomes = make_genomes(rng, t, n_genomes=3, length=300)
    idx = KeyValueIndex.build(genomes, IndexParams(), t)

    loc = "memory://stpu_test/idx"
    storage.delete_recursive("memory://stpu_test")
    idx.save(loc)
    idx2 = KeyValueIndex.load(loc)
    assert np.array_equal(np.asarray(idx2.keys), np.asarray(idx.keys))
    assert np.array_equal(np.asarray(idx2.taxa), np.asarray(idx.taxa))
    assert idx2.params.to_json() == idx.params.to_json()
    assert np.array_equal(idx2.taxonomy.parents, idx.taxonomy.parents)
    assert np.array_equal(idx2.taxonomy.primary, idx.taxonomy.primary)

    # sharded remote layout + partial (per-host) loads
    sloc = "memory://stpu_test/idx_sharded"
    idx.save_sharded(sloc, n_shards=4)
    full = KeyValueIndex.load_shards(sloc)
    assert np.array_equal(np.asarray(full.keys), np.asarray(idx.keys))
    part = KeyValueIndex.load_shards(sloc, [0, 1], taxonomy=t)
    n0 = len(part.keys)
    assert 0 < n0 < len(idx.keys)
    assert np.array_equal(np.asarray(part.keys), np.asarray(idx.keys)[:n0])

    # storage helpers: find/copy/exists round-trip
    found = storage.find_files("memory://stpu_test/idx", ".npy")
    assert any(f.endswith("keys.npy") for f in found)
    storage.copy(storage.join(loc, "params.json"), "memory://stpu_test/p2.json")
    assert storage.exists("memory://stpu_test/p2.json")
    storage.delete_recursive("memory://stpu_test")
    assert not storage.exists(loc)


def test_reduce_records_final_run_straddles_chunk(rng):
    """A run of equal keys straddling a chunk boundary — including the
    ARRAY-FINAL run, which used to IndexError in the boundary snap — must
    reduce exactly like the unchunked path."""
    from slacken.index import reduce_records, reduce_records_wide

    t = random_taxonomy(rng)
    leaves = [x for x in t.taxa() if t.is_leaf(x)]
    # 10 distinct keys then one key repeated 50x as the FINAL run
    keys = np.concatenate([
        np.sort(np.unique(rng.integers(1, 1 << 40, 16).astype(np.uint64))[:10]),
        np.full(50, np.uint64(1 << 41)),
    ])
    taxa = rng.choice(leaves, len(keys)).astype(np.int32)
    want_k, want_t = reduce_records(keys.copy(), taxa.copy(), t, chunk=1 << 22)
    for chunk in (7, 16, 32):
        got_k, got_t = reduce_records(keys.copy(), taxa.copy(), t, chunk=chunk)
        assert np.array_equal(got_k, want_k)
        assert np.array_equal(got_t, want_t)
    # wide variant, same shape of bug
    keys2 = np.stack([keys >> np.uint64(20), keys], axis=1)
    want_k2, want_t2 = reduce_records_wide(keys2.copy(), taxa.copy(), t)
    got_k2, got_t2 = reduce_records_wide(keys2.copy(), taxa.copy(), t, chunk=16)
    assert np.array_equal(got_k2, want_k2)
    assert np.array_equal(got_t2, want_t2)


def test_sharded_persistence_keeps_ordering_lut(rng, tmp_path):
    """save_sharded/load_shards must round-trip the explicit-ordering rank
    LUT: without it a reloaded non-xor index silently probes xor priorities
    and classifies nothing."""
    from test_index import make_genomes

    t = random_taxonomy(rng)
    genomes = make_genomes(rng, t, n_genomes=3, length=600)
    idx = KeyValueIndex.build(
        genomes, IndexParams(k=25, m=11, spaces=0, ordering="lexicographic"), t
    )
    assert idx.ordering_lut is not None
    loc = str(tmp_path / "sharded_lex")
    idx.save_sharded(loc, n_shards=4)
    got = KeyValueIndex.load_shards(loc, taxonomy=t)
    assert got.ordering_lut is not None
    assert np.array_equal(got.ordering_lut, idx.ordering_lut)

    from slacken.classify import Classifier, ClassifyParams, Fragment

    _, g = genomes[0]
    frags = [Fragment("r", g[:101])]
    cpar = ClassifyParams(thresholds=[0.0])
    want = Classifier(idx).classify(frags, cpar)[0.0]
    have = Classifier(got).classify(frags, cpar)[0.0]
    assert want == have and want[0].classified


def test_spill_collector_cleans_stale_files(rng, tmp_path):
    """A crashed build's leftover spill files must not merge into the next
    build using the same --spill-dir."""
    from slacken.index import SpillCollector

    t = random_taxonomy(rng)
    d = str(tmp_path / "spill")
    stale = SpillCollector(d)
    stale.add(
        np.array([1, 2, 3], np.uint64), np.array([5, 5, 5], np.int32)
    )
    stale.close()  # crash before reduce/cleanup: files remain on disk

    fresh = SpillCollector(d)
    fresh.add(np.array([10, 11], np.uint64), np.array([7, 7], np.int32))
    keys, taxa, _ = fresh.reduce(t)
    fresh.cleanup()
    assert np.array_equal(keys, np.array([10, 11], np.uint64))
    assert np.array_equal(taxa, np.array([7, 7], np.int32))


def test_device_reduce_build_matches_host(rng, monkeypatch):
    """The device-resident build (batch sort/dedup + hierarchical
    _reduce_chunks_kernel LCA reduction) must produce a bit-identical index
    to the host radix-sort path, including cross-taxon LCA-reduced keys and
    the multi-superbatch (hierarchical) reduction."""
    t = random_taxonomy(rng, 30)
    lut = np.frombuffer(b"ACGT", np.uint8)
    lib = []
    for tx in (5, 7, 9, 11, 5, 7):
        seq = lut[rng.integers(0, 4, 20000)].tobytes().decode()
        lib.append((tx, seq))
    lib.append((9, lib[0][1][:6000]))  # duplicate keys under another taxon
    params = IndexParams(k=35, m=31, spaces=7)

    monkeypatch.setenv("STPU_BUILD_DEVICE", "0")
    host = KeyValueIndex.build(iter(lib), params, t, batch_rows=8, row_len=4096)
    monkeypatch.setenv("STPU_BUILD_DEVICE", "1")
    # tiny superbatch: force several intermediate device reductions
    monkeypatch.setenv("STPU_BUILD_SUPERBATCH", str(8 * 4096 * 2))
    dev = KeyValueIndex.build(iter(lib), params, t, batch_rows=8, row_len=4096)
    assert np.array_equal(host.keys, dev.keys)
    assert np.array_equal(host.taxa, dev.taxa)

    # HBM-bounded variant: a tiny budget forces merge-tree leaves to spill
    # to host and the final cross-leaf merge to run the host reduce path —
    # still bit-identical (LCA associativity across partial reductions)
    monkeypatch.setenv("STPU_BUILD_DEVICE_BUDGET", "20000")
    spilled = KeyValueIndex.build(iter(lib), params, t, batch_rows=8, row_len=4096)
    assert np.array_equal(host.keys, spilled.keys)
    assert np.array_equal(host.taxa, spilled.taxa)


def test_wide_device_reduce_build_matches_host(rng, monkeypatch):
    """Wide (m > 31) device-resident build reduction: the [5, M] raw-limb
    scan kernel + 4-limb sort/segment-LCA reduce must be bit-identical to
    the host span path, including hierarchical superbatch reduction and the
    HBM-budget leaf-spill variant (Slacken has no m restriction on builds,
    KeyValueIndex.scala:85-139)."""
    t = random_taxonomy(rng, 30)
    lut = np.frombuffer(b"ACGT", np.uint8)
    lib = []
    for tx in (5, 7, 9, 11, 5, 7):
        seq = lut[rng.integers(0, 4, 20000)].tobytes().decode()
        lib.append((tx, seq))
    lib.append((9, lib[0][1][:6000]))  # duplicate keys under another taxon
    params = IndexParams(k=45, m=33, spaces=7)

    monkeypatch.setenv("STPU_BUILD_DEVICE", "0")
    host = KeyValueIndex.build(iter(lib), params, t, batch_rows=8, row_len=4096)
    monkeypatch.setenv("STPU_BUILD_DEVICE", "1")
    monkeypatch.setenv("STPU_BUILD_SUPERBATCH", str(8 * 4096 * 2))
    dev = KeyValueIndex.build(iter(lib), params, t, batch_rows=8, row_len=4096)
    assert np.array_equal(host.keys, dev.keys)
    assert np.array_equal(host.taxa, dev.taxa)

    monkeypatch.setenv("STPU_BUILD_DEVICE_BUDGET", "20000")
    spilled = KeyValueIndex.build(iter(lib), params, t, batch_rows=8, row_len=4096)
    assert np.array_equal(host.keys, spilled.keys)
    assert np.array_equal(host.taxa, spilled.taxa)


def test_build_trace_phases(rng, monkeypatch):
    """STPU_BUILD_TRACE=1 attaches a PhaseTimers accounting to the index on
    both the host path and the device-reduce path, without changing the
    result (the bench build6 experiment reads idx._build_phases)."""
    t = random_taxonomy(rng)
    genomes = make_genomes(rng, t, n_genomes=3, length=400)
    params = IndexParams(k=35, m=31, spaces=7)
    base = KeyValueIndex.build(genomes, params, t, row_len=256)

    monkeypatch.setenv("STPU_BUILD_TRACE", "1")
    for dev in ("0", "1"):
        monkeypatch.setenv("STPU_BUILD_DEVICE", dev)
        idx = KeyValueIndex.build(genomes, params, t, row_len=256)
        assert np.array_equal(idx.keys, base.keys)
        assert np.array_equal(idx.taxa, base.taxa)
        ph = idx._build_phases
        assert ph.totals and all(v >= 0 for v in ph.totals.values())
        expect = "device_reduce" if dev == "1" else "spans_to_records"
        assert expect in ph.totals


def test_build_flat_d2h_identical(rng, monkeypatch):
    """The ravel-before-transfer final d2h (GPU default) is a pure layout
    change: forced on via STPU_BUILD_FLAT_D2H it must produce the identical
    index on any backend."""
    t = random_taxonomy(rng)
    genomes = make_genomes(rng, t, n_genomes=4, length=500)
    params = IndexParams(k=35, m=31, spaces=7)
    monkeypatch.setenv("STPU_BUILD_DEVICE", "1")
    monkeypatch.setenv("STPU_BUILD_FLAT_D2H", "0")
    base = KeyValueIndex.build(genomes, params, t, row_len=256)
    monkeypatch.setenv("STPU_BUILD_FLAT_D2H", "1")
    flat = KeyValueIndex.build(genomes, params, t, row_len=256)
    assert np.array_equal(base.keys, flat.keys)
    assert np.array_equal(base.taxa, flat.taxa)


def test_device_hashed_rows_builder_matches_host(rng):
    """build_hashed_rows_device (the build->serve path's on-device table
    construction) must be bit-identical to the host builder, including the
    auto row_bits/tile growth policy."""
    from slacken.ops import lookup

    for n in (0, 7, 1000, 50000):
        keys = np.unique(rng.integers(1, 1 << 62, max(n, 1) * 2).astype(np.uint64))[:n]
        taxa = rng.integers(1, 99999, len(keys)).astype(np.int32)
        ht, htile, hrb = lookup.build_hashed_rows(keys, taxa)
        kh = (keys >> np.uint64(32)).astype(np.uint32)
        kl = keys.astype(np.uint32)
        dt, dtile, drb = lookup.build_hashed_rows_device(kh, kl, taxa)
        assert (htile, hrb) == (dtile, drb), n
        assert np.array_equal(np.asarray(dt), ht), n


def test_wide_device_hashed_rows_builder_matches_host(rng):
    """build_hashed_rows_wide_device (wide build->serve on-device table
    construction) must be bit-identical to the host builder, including the
    auto row_bits/tile growth policy."""
    from slacken.ops import lookup

    for n in (0, 7, 1000, 50000):
        hi = rng.integers(1, 1 << 62, max(n, 1) * 2).astype(np.uint64)
        lo = rng.integers(0, 1 << 63, max(n, 1) * 2).astype(np.uint64)
        keys2 = np.stack([hi, lo], axis=1)
        keys2 = np.unique(keys2, axis=0)[:n]
        taxa = rng.integers(1, 99999, len(keys2)).astype(np.int32)
        ht, htile, hrb = lookup.build_hashed_rows_wide(keys2, taxa)
        l3 = (keys2[:, 0] >> np.uint64(32)).astype(np.uint32)
        l2 = keys2[:, 0].astype(np.uint32)
        l1 = (keys2[:, 1] >> np.uint64(32)).astype(np.uint32)
        l0 = keys2[:, 1].astype(np.uint32)
        dt, dtile, drb = lookup.build_hashed_rows_wide_device(l3, l2, l1, l0, taxa)
        assert (htile, hrb) == (dtile, drb), n
        assert np.array_equal(np.asarray(dt), ht), n


def test_wide_device_resident_build_serves_without_host_roundtrip(rng, monkeypatch):
    """Wide STPU_DEVICE_RESIDENT builds: [5, cap] raw-limb records stay on
    device, the hashed1_wide probe serves straight from them, and lazy
    materialization yields the host-path [N, 2] keys exactly."""
    from slacken.classify import Classifier, ClassifyParams, Fragment

    t = random_taxonomy(rng)
    genomes = make_genomes(rng, t, n_genomes=4, length=600)
    params = IndexParams(k=45, m=33, spaces=7)
    monkeypatch.setenv("STPU_BUILD_DEVICE", "1")
    monkeypatch.setenv("STPU_DEVICE_RESIDENT", "1")
    idx_dr = KeyValueIndex.build(genomes, params, t, row_len=256)
    assert idx_dr._device_records is not None and idx_dr._keys is None
    assert idx_dr._device_records.shape[0] == 5
    monkeypatch.setenv("STPU_DEVICE_RESIDENT", "0")
    idx_host = KeyValueIndex.build(genomes, params, t, row_len=256)
    assert idx_dr.num_records == len(idx_host.keys)

    frags = []
    for i in range(12):
        _, g = genomes[int(rng.integers(len(genomes)))]
        s = int(rng.integers(0, len(g) - 121))
        frags.append(Fragment(f"r{i}", g[s : s + 121]))
    cpar = ClassifyParams(thresholds=[0.0, 0.1], per_read_output=True)
    got = Classifier(idx_dr, probe="hashed1").classify(frags, cpar)
    assert idx_dr._keys is None  # classification never touched host keys
    want = Classifier(idx_host, probe="hashed1").classify(frags, cpar)
    for c in cpar.thresholds:
        assert got[c] == want[c]
    assert np.array_equal(idx_dr.keys, idx_host.keys)  # lazy == host path
    assert np.array_equal(idx_dr.taxa, idx_host.taxa)


def test_device_resident_build_serves_without_host_roundtrip(rng, monkeypatch):
    """STPU_DEVICE_RESIDENT builds keep the finished records ON device: the
    hashed1 probe serves straight from them (no host keys materialized),
    lazy materialization equals the host-path build exactly, and save()
    still works (it materializes on demand)."""
    from slacken.classify import Classifier, ClassifyParams, Fragment

    t = random_taxonomy(rng)
    genomes = make_genomes(rng, t, n_genomes=4, length=600)
    params = IndexParams(k=35, m=31, spaces=7)
    monkeypatch.setenv("STPU_BUILD_DEVICE", "1")
    monkeypatch.setenv("STPU_DEVICE_RESIDENT", "1")
    idx_dr = KeyValueIndex.build(genomes, params, t, row_len=256)
    assert idx_dr._device_records is not None and idx_dr._keys is None
    monkeypatch.setenv("STPU_DEVICE_RESIDENT", "0")
    idx_host = KeyValueIndex.build(genomes, params, t, row_len=256)
    assert idx_dr.num_records == len(idx_host.keys)

    frags = []
    for i in range(12):
        _, g = genomes[int(rng.integers(len(genomes)))]
        s = int(rng.integers(0, len(g) - 101))
        frags.append(Fragment(f"r{i}", g[s : s + 101]))
    cpar = ClassifyParams(thresholds=[0.0, 0.1], per_read_output=True)
    got = Classifier(idx_dr, probe="hashed1").classify(frags, cpar)
    assert idx_dr._keys is None  # classification never touched host keys
    want = Classifier(idx_host, probe="hashed1").classify(frags, cpar)
    for c in cpar.thresholds:
        assert got[c] == want[c]
    assert np.array_equal(idx_dr.keys, idx_host.keys)  # lazy == host path
    assert np.array_equal(idx_dr.taxa, idx_host.taxa)
