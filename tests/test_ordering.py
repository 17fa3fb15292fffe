"""Explicit minimizer orderings (MinTable analogue) vs the XOR path and a
naive oracle."""

import numpy as np

from slacken.ops import ordering
from slacken.ops.minimizers import MinimizerParams, window_minimizers


def codes_of(rng, n, invalid_frac=0.0):
    c = rng.integers(0, 4, n).astype(np.uint8)
    if invalid_frac:
        c[rng.random(n) < invalid_frac] = 4
    return c


def test_lexicographic_equals_zero_toggle(rng):
    """LUT lexicographic ordering == toggle_mask=0 XOR path (both with and
    without spacing)."""
    for spaces in (0, 2):
        mp = MinimizerParams(k=15, m=8, spaces=spaces, toggle_mask=0)
        lut = ordering.lexicographic_lut(8)
        codes = codes_of(rng, 300, 0.02)[None, :]
        a = window_minimizers(codes, mp)
        b = window_minimizers(codes, mp, lut)
        assert np.array_equal(np.asarray(a.minimizer.lo), np.asarray(b.minimizer.lo))
        assert np.array_equal(np.asarray(a.span_start), np.asarray(b.span_start))
        assert np.array_equal(np.asarray(a.distinct), np.asarray(b.distinct))


def naive_window_min_rank(codes, mp, lut):
    """Oracle: for each valid window, the min rank over its m-mer starts."""
    m, k = mp.m, mp.k
    n = len(codes)
    mask = (
        ordering.space_mask_int(m, mp.spaces) if mp.spaces else (1 << (2 * m)) - 1
    )
    out = []
    for i in range(n - k + 1):
        w = codes[i : i + k]
        if (w >= 4).any():
            out.append(None)
            continue
        best = None
        for j in range(k - m + 1):
            v = 0
            for c in w[j : j + m]:
                v = (v << 2) | int(c)
            if mp.canonical:
                rc = 0
                for c in w[j : j + m][::-1]:
                    rc = (rc << 2) | (int(c) ^ 3)
                v = min(v, rc)
            r = int(lut[v & mask])
            best = r if best is None else min(best, r)
        out.append(best)
    return out


def test_frequency_ordering_vs_oracle(rng):
    mp = MinimizerParams(k=12, m=6, spaces=1)
    sample = [codes_of(rng, 400) for _ in range(3)]
    counts = ordering.sample_mmer_counts(sample, mp)
    lut = ordering.frequency_lut(counts, 6)

    codes = codes_of(rng, 200, 0.03)
    wm = window_minimizers(codes[None, :], mp, lut)
    got_rank = np.asarray(wm.minimizer.lo)[0]
    got_valid = np.asarray(wm.valid)[0]
    want = naive_window_min_rank(codes, mp, lut)
    for i, w in enumerate(want):
        if w is None:
            assert not got_valid[i]
        else:
            assert got_valid[i] and got_rank[i] == w, i


def test_given_ordering(rng):
    m = 4
    motifs = rng.permutation(1 << (2 * m))[:7]
    lut = ordering.given_lut(motifs, m)
    # listed motifs rank 0..6 in order; others follow lexicographically
    for i, mo in enumerate(motifs):
        assert lut[mo] == i
    rest = sorted(set(range(1 << (2 * m))) - set(motifs.tolist()))
    assert np.array_equal(lut[rest], np.arange(7, 7 + len(rest)))
    # ranks are a permutation
    assert np.array_equal(np.sort(lut), np.arange(1 << (2 * m)))


def test_frequency_prefers_rare(rng):
    """A window containing one rare and many common m-mers must pick the
    rare one."""
    m = 3
    counts = np.full(1 << (2 * m), 1000, np.int64)
    rare = 0b010101  # CCC... motif value for "CCC" = 0b010101
    counts[rare] = 1
    lut = ordering.frequency_lut(counts, m)
    assert lut[rare] == 0
    mp = MinimizerParams(k=6, m=3, spaces=0, canonical=False)
    # sequence containing CCC: minimizer rank must be 0 in windows covering it
    codes = np.array([0, 0, 1, 1, 1, 0, 0, 0], np.uint8)  # AACCCAAA
    wm = window_minimizers(codes[None, :], mp, lut)
    assert np.asarray(wm.minimizer.lo)[0, 0] == 0


def test_ordering_index_end_to_end(rng, tmp_path):
    """Indexes built with explicit orderings classify correctly end to end:
    lexicographic == toggle_mask=0 XOR bit-exactly, frequency classifies
    reads to the source taxon or an ancestor, and the rank LUT survives a
    save/load round-trip (MinimizerCLIConf.scala:81-95 `--ordering`)."""
    from slacken.classify import Classifier, ClassifyParams, Fragment
    from slacken.index import IndexParams, KeyValueIndex
    from test_index import make_genomes
    from test_taxonomy import random_taxonomy

    t = random_taxonomy(rng)
    genomes = make_genomes(rng, t, n_genomes=4, length=500)
    reads = []
    sources = []
    for i in range(30):
        tx, seq = genomes[rng.integers(0, len(genomes))]
        start = rng.integers(0, len(seq) - 80)
        reads.append(Fragment(f"r{i}", seq[start : start + 80]))
        sources.append(tx)
    cpar = ClassifyParams(thresholds=[0.0])

    def classify(idx):
        res = Classifier(idx).classify(reads, cpar)[0.0]
        return [(r.classified, r.taxon, r.hit_details) for r in res]

    # lexicographic ranks ARE the m-mer values when spaces=0, so results
    # must be bit-identical to the XOR path with a zero toggle mask
    p_lex = IndexParams(k=21, m=11, spaces=0, ordering="lexicographic")
    p_xor0 = IndexParams(k=21, m=11, spaces=0, toggle_mask=0)
    idx_lex = KeyValueIndex.build(genomes, p_lex, t)
    idx_xor0 = KeyValueIndex.build(genomes, p_xor0, t)
    assert np.array_equal(idx_lex.keys, idx_xor0.keys)
    assert np.array_equal(idx_lex.taxa, idx_xor0.taxa)
    assert classify(idx_lex) == classify(idx_xor0)

    # frequency ordering: sample the library itself, build, classify
    from slacken.ops import encode as encode_ops

    p_freq = IndexParams(k=21, m=9, spaces=2, ordering="frequency")
    mp = p_freq.minimizer_params
    counts = ordering.sample_mmer_counts(
        [encode_ops.encode_seq(s) for _, s in genomes], mp
    )
    lut = ordering.frequency_lut(counts, 9)
    idx_f = KeyValueIndex.build(genomes, p_freq, t, ordering_lut=lut)
    got = classify(idx_f)
    n_cls = 0
    for (classified, taxon, _), src in zip(got, sources):
        if classified:
            n_cls += 1
            assert t.has_ancestor(src, taxon)
    assert n_cls > 25

    # save/load round-trip: LUT persisted, classifications identical
    idx_f.save(str(tmp_path / "freq_idx"))
    idx2 = KeyValueIndex.load(str(tmp_path / "freq_idx"))
    assert idx2.params.ordering == "frequency"
    assert np.array_equal(idx2.ordering_lut, idx_f.ordering_lut)
    assert classify(idx2) == got

    # mixing an xor index with a LUT (or vice versa) is rejected
    import pytest

    with pytest.raises(ValueError):
        KeyValueIndex.build(genomes, IndexParams(k=21, m=9), t, ordering_lut=lut)
    with pytest.raises(ValueError):
        KeyValueIndex.build(genomes, p_freq, t)


def test_signature_lut_semantics():
    """KMC2 signature rules at small m, checked against a direct string
    predicate: candidates (no AAA/ACA start, no interior AA) rank before
    non-candidates, lexicographic within each class."""
    m = 5
    lut = ordering.signature_lut(m)
    n = 1 << (2 * m)
    bases = "ACGT"

    def mmer_str(v):
        return "".join(bases[(v >> (2 * (m - 1 - i))) & 3] for i in range(m))

    def is_candidate(s):
        if s.startswith("AAA") or s.startswith("ACA"):
            return False
        return "AA" not in s[1:]  # AA allowed only at the very start

    cand = [v for v in range(n) if is_candidate(mmer_str(v))]
    non = [v for v in range(n) if not is_candidate(mmer_str(v))]
    # permutation property
    assert sorted(lut.tolist()) == list(range(n))
    # candidates first, each class lexicographic
    assert lut[cand].tolist() == list(range(len(cand)))
    assert lut[non].tolist() == list(range(len(cand), n))
    # spot checks: AAAAA and ACAAA are non-candidates; CCCCC is rank of
    # first C-block candidate below it
    assert int(lut[0]) >= len(cand)


def test_signature_ordering_window_min_vs_oracle(rng):
    """Device windows with the signature LUT == the naive per-window min
    rank oracle."""
    mp = MinimizerParams(k=19, m=7, spaces=2)
    lut = ordering.signature_lut(7)
    codes = codes_of(rng, 400, 0.02)
    wm = window_minimizers(codes[None, :], mp, lut)
    got = np.asarray(wm.minimizer.lo)[0]
    valid = np.asarray(wm.valid)[0]
    want = naive_window_min_rank(codes, mp, lut)
    for i, w in enumerate(want):
        if w is None:
            assert not valid[i]
        else:
            assert valid[i] and int(got[i]) == w, i


def test_signature_index_build_and_classify(rng, tmp_path):
    """End-to-end: build + save/load + classify with ordering="signature"
    must round-trip and classify library reads (registry parity with the
    reference ADT, package.scala:35-56)."""
    from slacken.classify import Classifier, ClassifyParams, Fragment
    from slacken.index import IndexParams, KeyValueIndex
    from test_index import make_genomes
    from test_taxonomy import random_taxonomy

    t = random_taxonomy(rng)
    genomes = make_genomes(rng, t, n_genomes=4, length=700)
    params = IndexParams(k=25, m=11, spaces=0, ordering="signature")
    idx = KeyValueIndex.build(genomes, params, t)
    assert idx.ordering_lut is not None
    loc = str(tmp_path / "sigidx")
    idx.save(loc)
    idx2 = KeyValueIndex.load(loc)
    assert np.array_equal(idx2.ordering_lut, idx.ordering_lut)
    frags = []
    for i in range(10):
        _, g = genomes[int(rng.integers(len(genomes)))]
        s = int(rng.integers(0, len(g) - 101))
        frags.append(Fragment(f"r{i}", g[s : s + 101]))
    cpar = ClassifyParams(thresholds=[0.0], per_read_output=True)
    want = Classifier(idx).classify(frags, cpar)
    got = Classifier(idx2).classify(frags, cpar)
    assert want[0.0] == got[0.0]
    assert sum(r.classified for r in want[0.0]) > 5


def test_lut_m13_envelope():
    """MAX_LUT_M matches the reference MinTable bound (m <= 15,
    MinimizerPriorities.scala:181-271); a 268 MB m=13 table builds and the
    guard still rejects m=16."""
    import pytest

    lut = ordering.lexicographic_lut(13)
    assert lut.shape == (1 << 26,) and lut.dtype == np.uint32
    assert int(lut[12345]) == 12345
    del lut
    with pytest.raises(ValueError):
        ordering.lexicographic_lut(16)
    assert ordering.MAX_LUT_M == 15
