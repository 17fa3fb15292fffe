import numpy as np

from slacken.ops import u64


def rand_u64s(rng, n):
    return [int(x) for x in rng.integers(0, 1 << 64, size=n, dtype=np.uint64)]


def test_roundtrip(rng):
    vals = rand_u64s(rng, 100)
    pairs = [u64.from_int(v) for v in vals]
    hi = np.stack([np.asarray(p.hi) for p in pairs])
    lo = np.stack([np.asarray(p.lo) for p in pairs])
    back = u64.to_ints(u64.U64(hi, lo))
    assert [int(b) for b in back] == vals


def _pack(vals):
    hi = np.array([(v >> 32) & 0xFFFFFFFF for v in vals], np.uint32)
    lo = np.array([v & 0xFFFFFFFF for v in vals], np.uint32)
    return u64.U64(hi, lo)


def test_shifts(rng):
    vals = rand_u64s(rng, 64)
    x = _pack(vals)
    for n in [0, 1, 7, 31, 32, 33, 62, 63]:
        got = u64.to_ints(u64.shl(x, n))
        want = [(v << n) & ((1 << 64) - 1) for v in vals]
        assert [int(g) for g in got] == want, f"shl {n}"
        got = u64.to_ints(u64.shr(x, n))
        want = [v >> n for v in vals]
        assert [int(g) for g in got] == want, f"shr {n}"


def test_bitwise_and_compare(rng):
    a_vals = rand_u64s(rng, 200)
    b_vals = rand_u64s(rng, 200)
    # include equal pairs for compare edge cases
    b_vals[:50] = a_vals[:50]
    a, b = _pack(a_vals), _pack(b_vals)
    assert list(u64.to_ints(u64.bor(a, b))) == [x | y for x, y in zip(a_vals, b_vals)]
    assert list(u64.to_ints(u64.band(a, b))) == [x & y for x, y in zip(a_vals, b_vals)]
    assert list(u64.to_ints(u64.bxor(a, b))) == [x ^ y for x, y in zip(a_vals, b_vals)]
    assert list(np.asarray(u64.ltu(a, b))) == [x < y for x, y in zip(a_vals, b_vals)]
    assert list(np.asarray(u64.leu(a, b))) == [x <= y for x, y in zip(a_vals, b_vals)]
    assert list(np.asarray(u64.eq(a, b))) == [x == y for x, y in zip(a_vals, b_vals)]
    assert list(u64.to_ints(u64.minu(a, b))) == [min(x, y) for x, y in zip(a_vals, b_vals)]
