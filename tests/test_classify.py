import math

import numpy as np
import pytest

import oracle
from slacken.classify import Classifier, ClassifyParams, Fragment
from slacken.index import IndexParams, KeyValueIndex
from test_index import make_genomes, oracle_index, random_genome
from test_taxonomy import random_taxonomy

K, M, S = 35, 31, 7


def oracle_classify(seq, seq2, idx_map, parents, k, m, s, conf, min_hit_groups):
    """Full per-read oracle: spans -> lookup -> ordered hits -> resolveTree.
    Returns (classified, taxon, hit_details, length_string)."""
    mates = [seq] if seq2 is None else [seq, seq2]
    all_hits = []  # ordered (taxon, count), with border markers -2
    window_taxa = []
    num_distinct = 0
    last_min = None
    ambig = 0
    for mi, mate in enumerate(mates):
        if mi > 0:
            all_hits.append((-2, 0))
        codes = oracle.encode(mate)
        # char runs
        i = 0
        n = len(codes)
        while i < n:
            j = i
            while j < n and (codes[j] < 4) == (codes[i] < 4):
                j += 1
            if j - i >= k:
                if codes[i] < 4:
                    sps = oracle.spans(codes[i:j], k, m, s)
                    for start, nwin, value, _ in sps:
                        taxon = idx_map.get(value, 0)
                        distinct = last_min is None or value != last_min
                        if distinct and taxon != 0:
                            num_distinct += 1
                        last_min = value
                        all_hits.append((taxon, nwin))
                        window_taxa += [taxon] * nwin
                else:
                    all_hits.append((-1, (j - i) - k + 1))
                    ambig += (j - i) - k + 1
            i = j

    # merge adjacent equal (TaxonCounts.fromHits)
    merged = []
    for t, c in all_hits:
        if merged and merged[-1][0] == t and t != -2:
            merged[-1][1] += c
        else:
            merged.append([t, c])

    total = len(window_taxa) + ambig
    required = math.ceil(conf * total)
    counts = {}
    for t in window_taxa:
        counts[t] = counts.get(t, 0) + 1
    taxon = oracle.resolve_tree(parents, counts, required)
    classified = taxon != 0 and num_distinct >= min_hit_groups

    pieces = []
    lengths = []
    cur = 0
    for t, c in merged:
        if t == -2:
            lengths.append(cur + k - 1)
            cur = 0
            pieces.append("|:|")
        else:
            pieces.append(("A" if t == -1 else str(t)) + f":{c}")
            cur += c
    lengths.append(cur + k - 1)
    details = " ".join(pieces)
    length_string = "|".join(str(x) for x in lengths)
    return classified, (taxon if classified else 0), details, length_string


def sample_read(rng, genomes, length=101):
    taxon, seq = genomes[int(rng.integers(len(genomes)))]
    if len(seq) <= length:
        return taxon, seq
    start = int(rng.integers(0, len(seq) - length))
    return taxon, seq[start : start + length]


def setup(rng, n_genomes=6, glen=800):
    t = random_taxonomy(rng)
    parents = {i: int(p) for i, p in enumerate(t.parents)}
    genomes = make_genomes(rng, t, n_genomes=n_genomes, length=glen)
    idx = KeyValueIndex.build(genomes, IndexParams(k=K, m=M, spaces=S), t)
    idx_map = oracle_index(genomes, K, M, S, parents)
    return t, parents, genomes, idx, idx_map


def test_classify_source_or_ancestor(rng):
    """Reads sampled from a genome classify to the source taxon or an
    ancestor (ClassifierTest.scala:75-126)."""
    t, parents, genomes, idx, _ = setup(rng)
    frags = []
    sources = []
    for i in range(60):
        taxon, seq = sample_read(rng, genomes)
        frags.append(Fragment(f"read{i}", seq))
        sources.append(taxon)
    cls = Classifier(idx)
    cpar = ClassifyParams(thresholds=[0.0])
    res = cls.classify(frags, cpar)[0.0]
    assert len(res) == 60
    n_classified = 0
    for r, src in zip(res, sources):
        if r.classified:
            n_classified += 1
            assert t.has_ancestor(src, r.taxon), f"{r.taxon} not ancestor of {src}"
    assert n_classified > 50  # nearly all should classify


def test_classify_matches_oracle_exactly(rng):
    t, parents, genomes, idx, idx_map = setup(rng)
    cls = Classifier(idx)

    frags = []
    for i in range(40):
        _, seq = sample_read(rng, genomes)
        # some mutated reads, some with Ns, some random (unclassifiable)
        r = rng.random()
        if r < 0.2:
            seq = random_genome(rng, 101)
        elif r < 0.4:
            pos = sorted(rng.integers(0, len(seq), 3).tolist())
            chars = list(seq)
            for p in pos:
                chars[p] = "N"
            seq = "".join(chars)
        frags.append(Fragment(f"read{i}", seq))
    # short read, all-N read, empty-ish
    frags.append(Fragment("short", "ACGTACGT"))
    frags.append(Fragment("allN", "N" * 80))
    frags.append(Fragment("mixN", "N" * 40 + genomes[0][1][:61]))

    for conf in [0.0, 0.15, 0.6]:
        cpar = ClassifyParams(thresholds=[conf])
        res = cls.classify(frags, cpar)[conf]
        for f, r in zip(frags, res):
            want = oracle_classify(f.seq, f.seq2, idx_map, parents, K, M, S, conf, 2)
            assert (r.classified, r.taxon) == want[:2], f"{f.title} conf={conf}"
            assert r.hit_details == want[2], f"{f.title} details"
            assert r.length_string == want[3], f"{f.title} length"


def test_classify_paired(rng):
    t, parents, genomes, idx, idx_map = setup(rng)
    cls = Classifier(idx)
    frags = []
    for i in range(20):
        taxon, seq = sample_read(rng, genomes, length=120)
        r1, r2 = seq[:60], seq[60:]
        frags.append(Fragment(f"pair{i}", r1, r2))
    cpar = ClassifyParams(thresholds=[0.0, 0.1])
    res = cls.classify(frags, cpar)
    for conf in [0.0, 0.1]:
        for f, r in zip(frags, res[conf]):
            want = oracle_classify(f.seq, f.seq2, idx_map, parents, K, M, S, conf, 2)
            assert (r.classified, r.taxon) == want[:2], f"{f.title}"
            assert r.hit_details == want[2]
            assert r.length_string == want[3]
            assert "|:|" in r.hit_details
            assert "|" in r.length_string


def test_min_hit_groups_gate(rng):
    t, parents, genomes, idx, idx_map = setup(rng)
    # a read with a single span: exactly k bases -> 1 hit group
    taxon, seq = genomes[0]
    read = seq[:K]
    cls = Classifier(idx)
    res2 = cls.classify([Fragment("r", read)], ClassifyParams(min_hit_groups=2))[0.0]
    res1 = cls.classify([Fragment("r", read)], ClassifyParams(min_hit_groups=1))[0.0]
    assert not res2[0].classified
    assert res1[0].classified


def test_sample_regex(rng):
    t, parents, genomes, idx, idx_map = setup(rng, n_genomes=3)
    frags = [
        Fragment("sampleA|x|1", genomes[0][1][:101]),
        Fragment("sampleB|x|2", genomes[1][1][:101]),
        Fragment("nomatch", genomes[2][1][:101]),
    ]
    cls = Classifier(idx)
    cpar = ClassifyParams(sample_regex=r"(.*)\|.*\|.*")
    res = cls.classify(frags, cpar)[0.0]
    assert [r.sample_id for r in res] == ["sampleA", "sampleB", "other"]


def test_write_outputs(rng, tmp_path):
    t, parents, genomes, idx, idx_map = setup(rng, n_genomes=3)
    frags = [Fragment(f"r{i}", genomes[i % 3][1][200 : 200 + 101]) for i in range(9)]
    cls = Classifier(idx)
    cpar = ClassifyParams(thresholds=[0.0, 0.05])
    out = str(tmp_path / "out")
    cls.classify_and_write(frags, out, cpar)
    import gzip
    import os

    for suffix in ["_c0.00", "_c0.05"]:
        d = out + suffix
        assert os.path.isdir(d)
        with gzip.open(os.path.join(d, "sample=all", "part-00000.txt.gz"), "rt") as f:
            lines = f.read().splitlines()
        assert len(lines) == 9
        for line in lines:
            parts = line.split("\t")
            assert parts[0] in ("C", "U") and len(parts) == 5
        report = open(os.path.join(d, "all_kreport.txt")).read().splitlines()
        assert report[0].startswith("#Perc")
        assert any("\tR\t1\t" in line for line in report)


def test_aggregated_reports_match_per_read(rng, tmp_path):
    """Streaming reports-only aggregation must produce the same kreports as
    the per-read path."""
    from slacken import native

    t, parents, genomes, idx, idx_map = setup(rng)
    reads = []
    for i in range(60):
        _, seq = sample_read(rng, genomes)
        reads.append((f"s{i % 3}|read{i}", seq))
    packed = native.PackedReads(
        *(lambda rows: (rows[0], rows[1], rows[2]))(
            (
                __import__("numpy").stack(
                    [
                        __import__("numpy").pad(
                            __import__("slacken.ops.encode", fromlist=["encode_seq"]).encode_seq(s),
                            (0, 128 - len(s)),
                            constant_values=4,
                        )
                        for _, s in reads
                    ]
                ),
                __import__("numpy").array([len(s) for _, s in reads], "int32"),
                [h for h, _ in reads],
            )
        )
    )
    cls = Classifier(idx)
    cpar = ClassifyParams(
        thresholds=[0.0, 0.1], per_read_output=False, sample_regex=r"(s\d+)\|.*"
    )
    out_a = str(tmp_path / "agg")
    cls.classify_and_write_packed([packed], out_a, cpar)

    cpar_pr = ClassifyParams(
        thresholds=[0.0, 0.1], per_read_output=True, sample_regex=r"(s\d+)\|.*"
    )
    out_b = str(tmp_path / "perread")
    cls.classify_and_write_packed([packed], out_b, cpar_pr)

    import os

    for th in ("_c0.0", "_c0.1"):
        for s in ("s0", "s1", "s2"):
            a = open(out_a + th + f"/{s}_kreport.txt").read()
            b = open(out_b + th + f"/{s}_kreport.txt").read()
            assert a == b, f"{th}/{s}"


def test_classify_preserves_input_order(rng):
    """Mixed-length inputs must come back in input order despite bucket
    regrouping."""
    t, parents, genomes, idx, idx_map = setup(rng)
    frags = []
    for i in range(30):
        _, seq = genomes[i % len(genomes)]
        L = [60, 101, 140, 200][i % 4]
        s = int(rng.integers(0, len(seq) - L))
        frags.append(Fragment(f"read{i}", seq[s : s + L]))
    cls = Classifier(idx)
    res = cls.classify(frags, ClassifyParams())[0.0]
    assert [r.title for r in res] == [f.title for f in frags]


def test_probe_and_transfer_variants_identical(rng):
    """The direct-bucket probe and the wire-packed transfer path must produce
    exactly the same classifications as the default routed/dense path."""
    t, parents, genomes, idx, idx_map = setup(rng)
    frags = []
    for i in range(30):
        _, seq = sample_read(rng, genomes)
        if rng.random() < 0.3:
            pos = rng.integers(0, len(seq), 2)
            chars = list(seq)
            for p in pos:
                chars[int(p)] = "N"
            seq = "".join(chars)
        frags.append(Fragment(f"read{i}", seq))
    cpar = ClassifyParams(thresholds=[0.0, 0.2])

    base = Classifier(idx, packed_transfer=False).classify(frags, cpar)
    for kw in (
        dict(probe="bucketed", packed_transfer=False),
        dict(probe="routed", packed_transfer=True),
        dict(probe="bucketed", packed_transfer=True),
        dict(probe="tiled", packed_transfer=False),
        dict(probe="tiled", packed_transfer=True),
        dict(probe="hashed", packed_transfer=False),
        dict(probe="hashed", packed_transfer=True),
        dict(probe="hashed128", packed_transfer=False),
        dict(probe="hashed128", packed_transfer=True),
        dict(probe="hashed1", packed_transfer=False),
        dict(probe="hashed1", packed_transfer=True),
    ):
        got = Classifier(idx, **kw).classify(frags, cpar)
        for conf in cpar.thresholds:
            for a, b in zip(base[conf], got[conf]):
                assert a == b, (kw, conf, a, b)

    # dense tiled probing (the GPU default) must also match exactly
    import os

    os.environ["STPU_TILED_DENSE"] = "1"
    try:
        cls = Classifier(idx, probe="tiled", packed_transfer=False)
        assert cls._probe_static == ("tiled", cls._probe_static[1], True)
        got = cls.classify(frags, cpar)
    finally:
        del os.environ["STPU_TILED_DENSE"]
    for conf in cpar.thresholds:
        for a, b in zip(base[conf], got[conf]):
            assert a == b, ("tiled-dense", conf, a, b)


def test_pack_2bit_roundtrip(rng):
    from slacken.ops import encode as enc

    codes = rng.integers(0, 5, size=(16, 128)).astype(np.uint8)
    packed, valid = enc.pack_2bit(codes)
    assert packed.shape == (16, 32) and valid.shape == (16, 16)
    back = np.asarray(enc.unpack_2bit_device(packed, valid))
    assert np.array_equal(back, codes)


def test_bucketed_lookup_matches_routed(rng):
    from slacken.ops import lookup as lookup_ops
    from slacken.ops.u64 import U64
    import jax.numpy as jnp

    keys = np.unique(rng.integers(0, 1 << 62, 5000).astype(np.uint64))
    taxa = rng.integers(1, 100, len(keys)).astype(np.int32)
    idx = KeyValueIndex(keys, taxa, IndexParams(), random_taxonomy(rng))
    # queries: half hits, half misses
    q = np.concatenate([keys[:: 3], rng.integers(0, 1 << 62, 700).astype(np.uint64)])
    qv = U64(jnp.asarray((q >> np.uint64(32)).astype(np.uint32)), jnp.asarray(q.astype(np.uint32)))
    routed = np.asarray(idx.lookup(qv.hi, qv.lo))
    dk, dt, maxb = idx.device_bucketed
    bucketed = np.asarray(
        lookup_ops.lookup_taxa_bucketed(dk, dt, idx.device_router, qv, maxb, idx.router_bits)
    )
    assert np.array_equal(routed, bucketed)
    table, tile = idx.device_tiled
    tiled = np.asarray(
        lookup_ops.lookup_taxa_tiled(table, idx.device_router, qv, tile, idx.router_bits)
    )
    assert np.array_equal(routed, tiled)
    htab, htile, hbits = idx.device_hashed
    hashed = np.asarray(
        lookup_ops.lookup_taxa_hashed(htab, qv, htile, hbits, idx.key_bits)
    )
    assert np.array_equal(routed, hashed)
    ctab, ctile, cbits = idx.device_hashed_cols
    hashed_cols = np.asarray(
        lookup_ops.lookup_taxa_hashed_cols(ctab, qv, ctile, cbits, idx.key_bits)
    )
    assert np.array_equal(routed, hashed_cols)
    rtab, rtile, rbits = idx.device_hashed_rows
    hashed_rows = np.asarray(
        lookup_ops.lookup_taxa_hashed_rows(rtab, qv, rtile, rbits, idx.key_bits)
    )
    assert np.array_equal(routed, hashed_rows)


def test_fits_hashed_rows_bounds_actual_table(rng):
    """The shared HBM-fit estimate must bound the REAL table the auto build
    produces (the guard's 2x growth allowance): for a range of key counts,
    actual bytes <= the allowance used by fits_hashed_rows."""
    from slacken.ops import lookup as lookup_ops

    for n in (1000, 50_000, 300_000, 1_000_000):
        keys = np.unique(rng.integers(0, 1 << 62, int(n * 1.1)).astype(np.uint64))[:n]
        taxa = rng.integers(1, 100, len(keys)).astype(np.int32)
        tab, tile, rb = lookup_ops.build_hashed_rows(keys, taxa)
        est_slots = 1 << max(12, int(np.ceil(np.log2(max(n, 2) / 128))) + 7)
        assert tab.nbytes <= 12 * 2 * est_slots, (n, tab.nbytes, est_slots)


def test_compact_hits_rounds_matches_sort(rng):
    """The production successive-minimum compaction must stay bit-identical
    to the sort-based reference implementation (ops/resolve.py)."""
    from slacken.ops.resolve import (
        INVALID_WINDOW,
        compact_hits_rounds,
        compact_hits_sort,
    )

    # dense random taxa incl. sentinels, plus structured edge rows:
    # all-invalid, all-miss, more distinct taxa than max_taxa
    wt = rng.integers(-3, 60, (64, 96)).astype(np.int32)
    wt[0] = INVALID_WINDOW
    wt[1] = 0
    wt[2] = np.arange(96) + 1
    for t in (1, 4, 32):
        a = compact_hits_sort(wt, t)
        b = compact_hits_rounds(wt, t)
        for field in ("taxa", "counts", "n_hit_kmers", "n_none_kmers", "overflow"):
            assert np.array_equal(
                np.asarray(getattr(a, field)), np.asarray(getattr(b, field))
            ), (field, t)


def test_stream_detailed_lines_match_api(rng, tmp_path):
    """The bulk-formatted streaming detailed writer must emit exactly the
    lines the per-read API produces (order within each sample preserved)."""
    import gzip

    from slacken import native
    from slacken.ops import encode as enc

    t, parents, genomes, idx, idx_map = setup(rng)
    reads = []
    for i in range(40):
        _, seq = sample_read(rng, genomes)
        reads.append((f"s{i % 2}|read{i}", seq))
    rows = np.stack(
        [np.pad(enc.encode_seq(s), (0, 128 - len(s)), constant_values=4) for _, s in reads]
    )
    packed = native.PackedReads(
        rows, np.array([len(s) for _, s in reads], "int32"), [h for h, _ in reads]
    )
    cpar = ClassifyParams(
        thresholds=[0.0, 0.1], per_read_output=True, sample_regex=r"(s\d+)\|.*"
    )
    cls = Classifier(idx)
    out = str(tmp_path / "det")
    cls.classify_and_write_packed([packed], out, cpar)
    api = cls.classify_packed([packed], cpar)
    for th_label, th in (("_c0.0", 0.0), ("_c0.1", 0.1)):
        for s in ("s0", "s1"):
            got = gzip.open(
                out + th_label + f"/sample={s}/part-00000.txt.gz", "rt"
            ).read().splitlines()
            want = [r.output_line() for r in api[th] if r.sample_id == s]
            assert got == want, (th, s)


def test_window_rle_roundtrip(rng):
    """ops.rle encode/decode must reconstruct window_taxa exactly, report
    per-row run counts, and flag cap overflow instead of corrupting."""
    import jax.numpy as jnp
    from slacken.ops import rle as rle_ops

    B, L = 16, 40
    cap = rle_ops.DEFAULT_RUNS_PER_ROW
    wt = np.zeros((B, L), np.int32)
    wt[:, 10:20] = 7
    wt[3, :] = 7
    wt[5, 25:] = -3
    bundle = np.asarray(rle_ops.encode_rows(jnp.asarray(wt), cap))
    dense, ovf = rle_ops.decode_rows(bundle, L, cap)
    assert len(ovf) == 0 and np.array_equal(dense, wt)
    assert bundle[3, -1] == 1  # row 3 is a single run

    # random rows fuzz (few distinct values => runs fit the cap)
    wt = rng.integers(0, 2, (B, L)).astype(np.int32)
    wt = np.repeat(wt[:, : L // 4], 4, axis=1)[:, :L]
    bundle = np.asarray(rle_ops.encode_rows(jnp.asarray(wt), cap))
    dense, ovf = rle_ops.decode_rows(bundle, L, cap)
    assert len(ovf) == 0 and np.array_equal(dense, wt)

    # forced overflow on row 2: every position a distinct run
    wt = np.zeros((B, L), np.int32)
    wt[2] = np.arange(L)
    bundle = np.asarray(rle_ops.encode_rows(jnp.asarray(wt), cap))
    dense, ovf = rle_ops.decode_rows(bundle, L, cap)
    assert list(ovf) == [2]
    keep = np.ones(B, bool)
    keep[2] = False
    assert np.array_equal(dense[keep], wt[keep])  # other rows intact


def test_detailed_output_rle_identical(rng, monkeypatch):
    """Per-read detailed output must be byte-identical with the RLE
    window-taxa transfer forced on vs off (classify.py _hit_pairs)."""
    t, parents, genomes, idx, idx_map = setup(rng)
    frags = []
    for i in range(25):
        _, seq = sample_read(rng, genomes)
        if rng.random() < 0.4:
            chars = list(seq)
            for p in rng.integers(0, len(seq), 3):
                chars[int(p)] = "N"
            seq = "".join(chars)
        frags.append(Fragment(f"read{i}", seq))
    cpar = ClassifyParams(thresholds=[0.0, 0.1], per_read_output=True)

    monkeypatch.setenv("STPU_WT_RLE", "0")
    base = Classifier(idx).classify(frags, cpar)
    monkeypatch.setenv("STPU_WT_RLE", "1")
    got = Classifier(idx).classify(frags, cpar)
    for conf in cpar.thresholds:
        assert base[conf] == got[conf]


def test_window_codes_roundtrip(rng):
    """_window_codes_kernel/_decode_window_codes must reconstruct
    window_taxa exactly (incl. the bitcast byte order) for rows whose taxa
    are all in the compacted hit list; rows with foreign taxa (max_taxa
    overflow) are the caller's responsibility (refetched densely via
    batch.overflow — see _hit_pairs)."""
    import jax.numpy as jnp

    from slacken.classify import _decode_window_codes, _window_codes_kernel
    from slacken.ops.resolve import INVALID_WINDOW

    B, L, T = 12, 40, 8
    hit_taxa = np.zeros((B, T), np.int32)
    wt = np.full((B, L), INVALID_WINDOW, np.int32)
    for i in range(B):
        vals = np.sort(rng.choice(np.arange(1, 1 << 30), T - 2, replace=False))
        hit_taxa[i, : T - 2] = vals
        pick = rng.integers(0, T - 2, L)
        wt[i] = vals[pick]
        wt[i, rng.integers(0, L, 5)] = 0  # NONE misses
        wt[i, rng.integers(0, L, 5)] = INVALID_WINDOW
    # row 3: a taxon NOT in the hit list (simulates max_taxa overflow);
    # its rank code aliases — the production path refetches overflow rows
    wt[3, 7] = 999_999_999
    bundle = np.asarray(_window_codes_kernel(jnp.asarray(wt), jnp.asarray(hit_taxa)))
    got, fallback = _decode_window_codes(bundle, L)
    assert len(fallback) == 0  # rank codes never self-flag
    keep = np.ones(B, bool)
    keep[3] = False
    assert np.array_equal(got[keep], wt[keep])
    got[3] = wt[3]  # the production path refetches overflow rows densely
    assert np.array_equal(got, wt)


def test_window_codes_output_identical(rng, monkeypatch):
    """Detailed output must be byte-identical with the dictionary-compressed
    window-taxa transfer on vs the dense path, including paired reads,
    N-heavy rows, and hit-table overflow (max_taxa_per_read=2 forces the
    253-fallback refetch)."""
    t, parents, genomes, idx, idx_map = setup(rng)
    frags = []
    for i in range(30):
        _, seq = sample_read(rng, genomes)
        if rng.random() < 0.4:
            chars = list(seq)
            for p in rng.integers(0, len(seq), 3):
                chars[int(p)] = "N"
            seq = "".join(chars)
        if rng.random() < 0.3:
            _, seq2 = sample_read(rng, genomes)
            frags.append(Fragment(f"read{i}", seq, seq2))
        else:
            frags.append(Fragment(f"read{i}", seq))
    monkeypatch.setenv("STPU_HIT_RUNS", "0")
    for max_taxa in (32, 2):
        cpar = ClassifyParams(thresholds=[0.0, 0.1], per_read_output=True)
        monkeypatch.setenv("STPU_WINDOW_CODES", "0")
        base = Classifier(idx, max_taxa_per_read=max_taxa).classify(frags, cpar)
        monkeypatch.setenv("STPU_WINDOW_CODES", "1")
        got = Classifier(idx, max_taxa_per_read=max_taxa).classify(frags, cpar)
        for conf in cpar.thresholds:
            assert base[conf] == got[conf], (max_taxa, conf)


def test_device_finalize_matches_host(rng, monkeypatch):
    """The device _finalize_kernel (required-LUT + path walk) must produce
    exactly the host _finalize_taxa results, including hit-table-overflow
    rows (forced with max_taxa_per_read=2), paired reads, N runs, and the
    min-hit-groups gate."""
    t, parents, genomes, idx, idx_map = setup(rng)
    frags = []
    for i in range(40):
        _, seq = sample_read(rng, genomes)
        if rng.random() < 0.4:
            chars = list(seq)
            for p in rng.integers(0, len(seq), int(rng.integers(1, 8))):
                chars[int(p)] = "N"
            seq = "".join(chars)
        if rng.random() < 0.3:
            _, seq2 = sample_read(rng, genomes)
            frags.append(Fragment(f"read{i}", seq, seq2))
        else:
            frags.append(Fragment(f"read{i}", seq))
    for mhg, max_taxa in ((1, 32), (2, 32), (1, 2)):
        cpar = ClassifyParams(
            thresholds=[0.0, 0.05, 0.31], min_hit_groups=mhg
        )
        monkeypatch.setenv("STPU_DEVICE_FINALIZE", "0")
        legacy = Classifier(idx, max_taxa_per_read=max_taxa).classify(frags, cpar)
        monkeypatch.setenv("STPU_DEVICE_FINALIZE", "1")
        dev = Classifier(idx, max_taxa_per_read=max_taxa).classify(frags, cpar)
        for conf in cpar.thresholds:
            assert legacy[conf] == dev[conf], (mhg, max_taxa, conf)


def test_streaming_detailed_dense_native_identical(rng, monkeypatch, tmp_path):
    """The streaming detailed writer must produce byte-identical per-read
    files through all three line-emission paths: native dense full lines
    (stpu_output_lines_dense — the accelerator default transfer), native
    hit-runs full lines, and the per-read Python fallback. Single + paired
    reads, N-heavy rows, classified and unclassified lines."""
    import gzip

    from slacken import native
    from slacken.ops import encode

    t, parents, genomes, idx, idx_map = setup(rng)

    def pack(reads):
        codes = np.stack(
            [
                np.pad(
                    encode.encode_seq(s), (0, 128 - len(s)), constant_values=4
                )
                for _, s in reads
            ]
        )
        return native.PackedReads(
            codes,
            np.array([len(s) for _, s in reads], np.int32),
            [h for h, _ in reads],
        )

    reads1, reads2 = [], []
    for i in range(40):
        _, seq = sample_read(rng, genomes)
        if rng.random() < 0.4:
            chars = list(seq)
            for p in rng.integers(0, len(seq), int(rng.integers(1, 15))):
                chars[int(p)] = "N"
            seq = "".join(chars)
        reads1.append((f"r{i}", seq))
        _, s2 = sample_read(rng, genomes)
        reads2.append((f"p{i}", s2))
    cpar = ClassifyParams(
        thresholds=[0.0, 0.1], per_read_output=True, with_unclassified=True
    )

    def run(tag):
        out = str(tmp_path / tag)
        packed = [pack(reads1), native.pack_pairs(pack(reads1), pack(reads2))]
        Classifier(idx).classify_and_write_packed(iter(packed), out, cpar)
        data = {}
        for th in ("_c0.0", "_c0.1"):
            p = out + th + "/sample=all/part-00000.txt.gz"
            with gzip.open(p, "rt") as f:
                data[th] = f.read()
        assert data["_c0.0"].count("\n") == 80
        return data

    monkeypatch.setenv("STPU_HIT_RUNS", "0")
    dense = run("dense")
    monkeypatch.setenv("STPU_HIT_RUNS", "1")
    runs = run("runs")
    monkeypatch.setenv("STPU_HIT_RUNS", "0")
    monkeypatch.setattr(native, "output_lines_dense", lambda *a, **k: None)
    monkeypatch.setattr(native, "output_lines_runs", lambda *a, **k: None)
    fallback = run("fallback")
    assert dense == fallback
    assert runs == fallback


def test_streaming_detailed_wide_index_identical(rng, monkeypatch, tmp_path):
    """The streaming detailed writer's three emission paths stay
    byte-identical on a WIDE (m > 31) index — hit runs and line
    formatting are downstream of the probe and must be key-width
    agnostic."""
    import gzip

    from slacken import native
    from slacken.ops import encode

    t = random_taxonomy(rng)
    genomes = make_genomes(rng, t, n_genomes=4, length=700)
    idx = KeyValueIndex.build(genomes, IndexParams(k=45, m=33, spaces=7), t)

    def pack(reads):
        codes = np.stack(
            [
                np.pad(
                    encode.encode_seq(s), (0, 128 - len(s)), constant_values=4
                )
                for _, s in reads
            ]
        )
        return native.PackedReads(
            codes,
            np.array([len(s) for _, s in reads], np.int32),
            [h for h, _ in reads],
        )

    reads = []
    for i in range(24):
        _, seq = sample_read(rng, genomes)
        if rng.random() < 0.4:
            chars = list(seq)
            for p in rng.integers(0, len(seq), 4):
                chars[int(p)] = "N"
            seq = "".join(chars)
        reads.append((f"w{i}", seq))
    cpar = ClassifyParams(
        thresholds=[0.0], per_read_output=True, with_unclassified=True
    )

    def run(tag):
        out = str(tmp_path / tag)
        Classifier(idx, probe="hashed1").classify_and_write_packed(
            iter([pack(reads)]), out, cpar
        )
        with gzip.open(out + "_c0.0/sample=all/part-00000.txt.gz", "rt") as f:
            return f.read()

    monkeypatch.setenv("STPU_HIT_RUNS", "0")
    dense = run("dense")
    monkeypatch.setenv("STPU_HIT_RUNS", "1")
    runs = run("runs")
    assert dense == runs
    assert dense.count("\n") == 24 and "C\t" in dense


def test_hit_runs_output_identical(rng, monkeypatch):
    """Detailed output must be byte-identical with the device hit-runs
    reduction on vs the dense window-taxa path, including paired reads and
    N-heavy rows that overflow the run cap."""
    t, parents, genomes, idx, idx_map = setup(rng)
    frags = []
    for i in range(30):
        _, seq = sample_read(rng, genomes)
        if rng.random() < 0.5:
            chars = list(seq)
            # up to 20 Ns: > cap runs on some rows => overflow fallback
            for p in rng.integers(0, len(seq), int(rng.integers(1, 20))):
                chars[int(p)] = "N"
            seq = "".join(chars)
        if i % 4 == 3:
            _, seq2 = sample_read(rng, genomes)
            frags.append(Fragment(f"r{i}", seq, seq2))
        else:
            frags.append(Fragment(f"r{i}", seq))
    cpar = ClassifyParams(thresholds=[0.0, 0.1], per_read_output=True)
    monkeypatch.setenv("STPU_HIT_RUNS", "0")
    base = Classifier(idx).classify(frags, cpar)
    monkeypatch.setenv("STPU_HIT_RUNS", "1")
    runs = Classifier(idx).classify(frags, cpar)
    for conf in cpar.thresholds:
        for a, b in zip(base[conf], runs[conf]):
            assert a == b, (conf, a, b)


@pytest.mark.parametrize(
    "platform, limit, per_device, want",
    [
        ("cpu", None, None, "routed"),
        ("gpu", 64 << 30, None, "hashed1"),
        ("gpu", 1 << 16, None, "tiled"),
        ("gpu", 1 << 26, None, "hashed1"),
        ("gpu", 1 << 26, 10**7, "tiled"),
    ],
)
def test_default_probe_policy(rng, monkeypatch, platform, limit, per_device, want):
    """The probe picked when none is named: routed on the CPU; on the GPU
    hashed1, or tiled once the hashed1 table (of the whole index, or of the
    largest per-device shard) would crowd device memory."""
    from slacken import utils
    from slacken.classify import default_probe

    _, _, _, idx, _ = setup(rng, n_genomes=2, glen=300)
    monkeypatch.setattr(utils, "backend", lambda: platform)
    if limit is not None:
        monkeypatch.setattr(utils, "device_memory_bytes", lambda: limit)
    assert default_probe(idx, keys_per_device=per_device) == want
