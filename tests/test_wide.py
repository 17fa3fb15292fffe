"""Wide minimizers (31 < m <= 63): oracle parity for the u128 scan pipeline,
index build, and end-to-end classification.

Reference capability: minimizers are stored as ceil(m/32) longs
(KmerKeyedIndex.scala:33-54) with the XOR toggle mask replicated across longs
(MinimizerPriorities.scala:146-160); the CLI validates only m <= k
(MinimizerCLIConf.scala:75-79).
"""

import numpy as np
import pytest

import oracle
from slacken.classify import Classifier, ClassifyParams, Fragment
from slacken.index import IndexParams, KeyValueIndex
from slacken.ops import encode, minimizers, u128
from slacken.ops.minimizers import MinimizerParams
from test_classify import oracle_classify, sample_read
from test_index import make_genomes, oracle_index
from test_minimizers import random_dna
from test_taxonomy import random_taxonomy


@pytest.mark.parametrize("m", [32, 33, 45, 63])
def test_mmer_values_wide(rng, m):
    s = random_dna(rng, 150, mixed_case=True)
    codes = encode.encode_seq(s)[None, :]
    got = u128.to_ints(minimizers.mmer_at_starts_wide(codes, m))[0]
    oc = oracle.encode(s)
    for i in range(len(s) - m + 1):
        assert int(got[i]) == oracle.mmer_value(oc, i, m), f"pos {i} m={m}"


@pytest.mark.parametrize("m", [33, 45, 63])
def test_revcomp_canonical_wide(rng, m):
    vals = [
        int.from_bytes(rng.bytes(16), "big") & ((1 << (2 * m)) - 1) for _ in range(40)
    ]
    x = u128.from_limbs(
        np.array([(v >> 96) & 0xFFFFFFFF for v in vals], np.uint32),
        np.array([(v >> 64) & 0xFFFFFFFF for v in vals], np.uint32),
        np.array([(v >> 32) & 0xFFFFFFFF for v in vals], np.uint32),
        np.array([v & 0xFFFFFFFF for v in vals], np.uint32),
    )
    rc = u128.to_ints(minimizers.revcomp_mmer_wide(x, m))
    for v, r in zip(vals, rc):
        assert int(r) == oracle.revcomp_value(v, m)


def test_wide_toggle_matches_oracle():
    for m in (32, 33, 40, 45, 63):
        assert u128.wide_toggle_mask(m, oracle.DEFAULT_TOGGLE_MASK) == oracle.wide_toggle(
            m, oracle.DEFAULT_TOGGLE_MASK
        )


@pytest.mark.parametrize(
    "k,m,s",
    [(35, 33, 0), (50, 45, 7), (63, 63, 0), (40, 33, 5)],
)
def test_window_minimizers_wide_vs_oracle(rng, k, m, s):
    params = MinimizerParams(k=k, m=m, spaces=s)
    for trial in range(6):
        amb = 0.0 if trial < 3 else 0.03
        L = int(rng.integers(k, 180))
        seq = random_dna(rng, L, with_ambiguity=amb)
        codes = encode.encode_seq(seq)[None, :]
        wm = minimizers.window_minimizers(codes, params)
        got_min = u128.to_ints(wm.minimizer)[0]
        got_valid = np.asarray(wm.valid)[0]

        oc = oracle.encode(seq)
        want = oracle.window_minimizers(oc, k, m, s)
        for i in range(L):
            assert got_valid[i] == (want[i] is not None), f"{seq} valid at {i}"
            if want[i] is not None:
                assert int(got_min[i]) == want[i], f"{seq} min at {i}"

        want_spans = oracle.spans(oc, k, m, s)
        got_starts = np.flatnonzero(np.asarray(wm.span_start)[0])
        assert list(got_starts) == [sp[0] for sp in want_spans]
        got_distinct = np.asarray(wm.distinct)[0][got_starts]
        assert list(got_distinct) == [sp[3] for sp in want_spans]


def test_revcomp_invariance_wide(rng):
    params = MinimizerParams(k=50, m=45, spaces=7)
    seq = random_dna(rng, 160)
    rc = encode.revcomp_str(seq)
    wm1 = minimizers.window_minimizers(encode.encode_seq(seq)[None, :], params)
    wm2 = minimizers.window_minimizers(encode.encode_seq(rc)[None, :], params)
    v1 = u128.to_ints(wm1.minimizer)[0][np.asarray(wm1.valid)[0]]
    v2 = u128.to_ints(wm2.minimizer)[0][np.asarray(wm2.valid)[0]]
    assert sorted(v1.tolist()) == sorted(v2.tolist())


def _setup_wide(rng, k, m, s, n_genomes=5, glen=500):
    t = random_taxonomy(rng)
    parents = {i: int(p) for i, p in enumerate(t.parents)}
    genomes = make_genomes(rng, t, n_genomes=n_genomes, length=glen)
    idx = KeyValueIndex.build(
        genomes, IndexParams(k=k, m=m, spaces=s), t, batch_rows=8, row_len=256
    )
    idx_map = oracle_index(genomes, k, m, s, parents)
    return t, parents, genomes, idx, idx_map


@pytest.mark.parametrize("k,m,s", [(35, 33, 0), (50, 45, 7)])
def test_wide_build_matches_oracle(rng, k, m, s):
    _, _, _, idx, idx_map = _setup_wide(rng, k, m, s)
    assert idx.wide and idx.keys.shape == (len(idx_map), 2)
    got = {
        (int(hi) << 64) | int(lo): int(tx)
        for (hi, lo), tx in zip(np.asarray(idx.keys), np.asarray(idx.taxa))
    }
    assert got == idx_map


@pytest.mark.parametrize("k,m,s", [(35, 33, 0), (50, 45, 7)])
def test_wide_classify_matches_oracle(rng, k, m, s):
    t, parents, genomes, idx, idx_map = _setup_wide(rng, k, m, s)
    frags = []
    for i in range(40):
        _, seq = sample_read(rng, genomes, length=120)
        if i % 5 == 4:  # inject ambiguity
            pos = int(rng.integers(0, len(seq)))
            seq = seq[:pos] + "N" + seq[pos + 1 :]
        frags.append(Fragment(f"r{i}", seq))
    # paired rows too
    for i in range(10):
        _, s1 = sample_read(rng, genomes, length=80)
        _, s2 = sample_read(rng, genomes, length=80)
        frags.append(Fragment(f"p{i}", s1, s2))

    cls = Classifier(idx)
    cpar = ClassifyParams(thresholds=[0.0, 0.1], min_hit_groups=2)
    res = cls.classify(frags, cpar)
    n_classified = 0
    for conf in cpar.thresholds:
        for f, r in zip(frags, res[conf]):
            want = oracle_classify(
                f.seq, f.seq2, idx_map, parents, k, m, s, conf, cpar.min_hit_groups
            )
            got = (r.classified, r.taxon, r.hit_details, r.length_string)
            assert got == want, f"{f.title} conf={conf}: {got} != {want}"
            n_classified += r.classified
    assert n_classified > 0


def test_wide_save_load_roundtrip(rng, tmp_path):
    t, parents, genomes, idx, idx_map = _setup_wide(rng, 35, 33, 0)
    loc = str(tmp_path / "widx")
    idx.save(loc)
    idx2 = KeyValueIndex.load(loc)
    assert idx2.wide
    np.testing.assert_array_equal(np.asarray(idx2.keys), np.asarray(idx.keys))
    np.testing.assert_array_equal(np.asarray(idx2.taxa), np.asarray(idx.taxa))
    # lookups still work after reload
    cls = Classifier(idx2)
    _, seq = sample_read(rng, genomes, length=100)
    res = cls.classify([Fragment("x", seq)], ClassifyParams())[0.0]
    want = oracle_classify(seq, None, idx_map, parents, 35, 33, 0, 0.0, 2)
    got = (res[0].classified, res[0].taxon, res[0].hit_details, res[0].length_string)
    assert got == want


@pytest.mark.parametrize("k,m,s", [(35, 33, 0), (50, 45, 7)])
def test_wide_tiled_probe_matches_routed(rng, k, m, s):
    """The wide tiled row-gather probe (span-compacted AND dense) must
    produce exactly the routed wide probe's classifications."""
    t, parents, genomes, idx, idx_map = _setup_wide(rng, k, m, s)
    frags = []
    for i in range(30):
        _, seq = sample_read(rng, genomes, length=120)
        if i % 4 == 3:
            pos = int(rng.integers(0, len(seq)))
            seq = seq[:pos] + "N" + seq[pos + 1 :]
        frags.append(Fragment(f"r{i}", seq))
    cpar = ClassifyParams(thresholds=[0.0, 0.1])
    want = Classifier(idx, probe="routed").classify(frags, cpar)
    for dense in ("0", "1"):
        import os

        os.environ["STPU_TILED_DENSE"] = dense
        try:
            got = Classifier(idx, probe="tiled").classify(frags, cpar)
            got_h1 = Classifier(idx, probe="hashed1").classify(frags, cpar)
        finally:
            del os.environ["STPU_TILED_DENSE"]
        for conf in cpar.thresholds:
            assert want[conf] == got[conf], (dense, conf)
            assert want[conf] == got_h1[conf], ("hashed1", dense, conf)


def test_wide_spilled_build_matches_in_memory(rng, tmp_path):
    """Out-of-core (range-spilled) builds work for wide (m > 31) keys too:
    [N, 2] uint64 records partition on the top 64 bits of the 2m-bit
    priority and reduce per range to the identical index (the reference's
    Spark shuffle handles all m <= 63 uniformly, KeyValueIndex.scala:85-93).
    m=32 exercises the shift-0 edge of the partition projection."""
    import numpy as np

    from test_taxonomy import random_taxonomy
    from test_index import make_genomes

    t = random_taxonomy(rng)
    genomes = make_genomes(rng, t, n_genomes=4, length=600)
    genomes.append((genomes[0][0], genomes[1][1]))  # cross-taxon duplicates
    for k, m in ((50, 45), (35, 32)):
        params = IndexParams(k=k, m=m, spaces=7)
        mem = KeyValueIndex.build(
            genomes, params, t, keep_records=True, row_len=256
        )
        spill = KeyValueIndex.build(
            genomes, params, t, keep_records=True, row_len=256,
            spill_dir=str(tmp_path / f"spill{m}"),
        )
        assert np.array_equal(mem.keys, spill.keys)
        assert np.array_equal(mem.taxa, spill.taxa)
        assert np.array_equal(mem.record_keys, spill.record_keys)
        assert np.array_equal(mem.record_taxa, spill.record_taxa)
