import numpy as np
import pytest

import oracle
from slacken.ops import encode, minimizers, u64
from slacken.ops.minimizers import MinimizerParams


def random_dna(rng, n, with_ambiguity=0.0, mixed_case=True):
    letters = "ACGT"
    s = []
    for _ in range(n):
        if with_ambiguity and rng.random() < with_ambiguity:
            s.append("N")
        else:
            c = letters[rng.integers(4)]
            if mixed_case and rng.random() < 0.3:
                c = c.lower()
            s.append(c)
    return "".join(s)


def test_encode_roundtrip(rng):
    s = random_dna(rng, 500, with_ambiguity=0.05)
    codes = encode.encode_seq(s)
    dec = encode.decode_codes(codes)
    assert dec == s.upper().replace("U", "T").replace("N", "N")
    # INVALID iff not ACGTU
    for ch, c in zip(s, codes):
        assert (c == 4) == (ch.upper() not in "ACGTU")


def test_space_mask_example():
    # Reference documented example (MinimizerPriorities.scala:274-279):
    # TTCTGTGGG with s=3 masks to TTC-G-G-G i.e. TTCAGAGAG
    m, s = 9, 3
    v = oracle.mmer_value(oracle.encode("TTCTGTGGG"), 0, m)
    masked = v & minimizers.space_mask_int(m, s)
    assert masked == oracle.mmer_value(oracle.encode("TTCAGAGAG"), 0, m)
    assert minimizers.space_mask_int(m, s) == oracle.space_mask(m, s)


@pytest.mark.parametrize("m", [1, 2, 5, 10, 15, 16, 21, 31])
def test_mmer_values(rng, m):
    s = random_dna(rng, 200, mixed_case=True)
    codes = encode.encode_seq(s)[None, :]
    got = u64.to_ints(minimizers.mmer_at_starts(codes, m))[0]
    oc = oracle.encode(s)
    for i in range(len(s) - m + 1):
        assert int(got[i]) == oracle.mmer_value(oc, i, m), f"pos {i} m={m}"


@pytest.mark.parametrize("m", [3, 8, 15, 17, 31])
def test_revcomp_canonical(rng, m):
    vals = [int(x) for x in rng.integers(0, 1 << (2 * m), size=50, dtype=np.uint64)]
    x = u64.U64(
        np.array([(v >> 32) for v in vals], np.uint32),
        np.array([v & 0xFFFFFFFF for v in vals], np.uint32),
    )
    rc = u64.to_ints(minimizers.revcomp_mmer(x, m))
    can = u64.to_ints(minimizers.canonical_mmer(x, m))
    for v, r, c in zip(vals, rc, can):
        assert int(r) == oracle.revcomp_value(v, m)
        assert int(c) == oracle.canonical_value(v, m)


@pytest.mark.parametrize(
    "k,m,s",
    [(35, 31, 7), (35, 31, 0), (10, 5, 0), (21, 11, 3), (7, 7, 0), (15, 10, 2)],
)
def test_window_minimizers_vs_oracle(rng, k, m, s):
    params = MinimizerParams(k=k, m=m, spaces=s)
    for trial in range(8):
        amb = 0.0 if trial < 4 else 0.03
        L = int(rng.integers(k, 160))
        seq = random_dna(rng, L, with_ambiguity=amb)
        codes = encode.encode_seq(seq)[None, :]
        wm = minimizers.window_minimizers(codes, params)
        got_min = u64.to_ints(wm.minimizer)[0]
        got_valid = np.asarray(wm.valid)[0]

        oc = oracle.encode(seq)
        want = oracle.window_minimizers(oc, k, m, s)
        for i in range(L):
            assert got_valid[i] == (want[i] is not None), f"{seq} valid at {i}"
            if want[i] is not None:
                assert int(got_min[i]) == want[i], f"{seq} min at {i}"

        # span structure
        want_spans = oracle.spans(oc, k, m, s)
        got_starts = np.flatnonzero(np.asarray(wm.span_start)[0])
        assert list(got_starts) == [sp[0] for sp in want_spans]
        got_distinct = np.asarray(wm.distinct)[0][got_starts]
        assert list(got_distinct) == [sp[3] for sp in want_spans]


def test_revcomp_invariance(rng):
    """The multiset of (canonical) window minimizers of a read equals that of
    its reverse complement (MinSplitterProps.scala:91-114 analogue)."""
    params = MinimizerParams(k=35, m=31, spaces=7)
    seq = random_dna(rng, 120)
    rc = encode.revcomp_str(seq)
    for s in (seq, rc):
        pass
    wm1 = minimizers.window_minimizers(encode.encode_seq(seq)[None, :], params)
    wm2 = minimizers.window_minimizers(encode.encode_seq(rc)[None, :], params)
    v1 = u64.to_ints(wm1.minimizer)[0][np.asarray(wm1.valid)[0]]
    v2 = u64.to_ints(wm2.minimizer)[0][np.asarray(wm2.valid)[0]]
    assert sorted(v1.tolist()) == sorted(v2.tolist())
