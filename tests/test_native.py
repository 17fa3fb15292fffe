import numpy as np
import pytest

from slacken import native
from slacken.ops import encode


def make_fastq(records):
    return b"".join(
        b"@" + h + b"\n" + s + b"\n+\n" + b"I" * len(s) + b"\n" for h, s in records
    )


def make_fasta(records, width=60):
    out = []
    for h, s in records:
        out.append(b">" + h + b"\n")
        for i in range(0, len(s), width):
            out.append(s[i : i + width] + b"\n")
    return b"".join(out)


def random_seq(rng, n):
    return bytes(rng.choice(list(b"ACGTacgtN"), n))


def test_native_available():
    assert native.available(), "native library failed to build"


@pytest.mark.parametrize("use_native", [True, False])
def test_fastq_chunk(rng, use_native, monkeypatch):
    if not use_native:
        monkeypatch.setattr(native, "_lib", None)
        monkeypatch.setattr(native, "_tried", True)
    records = [(f"read{i} x".encode(), random_seq(rng, int(rng.integers(50, 120)))) for i in range(30)]
    buf = make_fastq(records)
    # append a partial record (next chunk)
    partial = b"@partial\nACGT"
    packed, consumed = native.pack_fastq_chunk(buf + partial)
    assert consumed == len(buf)
    assert len(packed) == 30
    for i, (h, s) in enumerate(records):
        assert packed.titles[i] == h.decode()
        assert packed.lengths[i] == len(s)
        want = encode.encode_seq(s.decode())
        got = packed.codes[i, : len(s)]
        assert np.array_equal(got, want), f"record {i}"
        assert (packed.codes[i, len(s) :] == 4).all()


@pytest.mark.parametrize("use_native", [True, False])
def test_fasta_buffer(rng, use_native, monkeypatch):
    if not use_native:
        monkeypatch.setattr(native, "_lib", None)
        monkeypatch.setattr(native, "_tried", True)
    records = [(f"seq{i} desc".encode(), random_seq(rng, int(rng.integers(100, 400)))) for i in range(10)]
    buf = make_fasta(records)
    packed = native.pack_fasta_chunk(buf)
    assert len(packed) == 10
    for i, (h, s) in enumerate(records):
        assert packed.titles[i] == h.decode()
        assert packed.lengths[i] == len(s)
        want = encode.encode_seq(s.decode())
        assert np.array_equal(packed.codes[i, : len(s)], want)


def test_encode_bytes(rng):
    data = random_seq(rng, 1000)
    got = native.encode_bytes(data)
    want = encode.encode_seq(data.decode())
    assert np.array_equal(got, want)


def test_native_speed(rng):
    """The native parser should beat a naive python loop comfortably."""
    import time

    records = [(f"r{i}".encode(), random_seq(rng, 101)) for i in range(20000)]
    buf = make_fastq(records)
    native.pack_fastq_chunk(buf[:4096])  # warm up (may build the library)
    t0 = time.time()
    packed, _ = native.pack_fastq_chunk(buf)
    dt = time.time() - t0
    assert len(packed) == 20000
    mbps = len(buf) / dt / 1e6
    print(f"native fastq parse: {mbps:.0f} MB/s")
    assert mbps > 20  # very conservative floor (CI boxes vary)


def test_hit_lines_matches_python(rng):
    """C++ hit-string formatter must be byte-identical to the Python path."""
    from slacken.classify import _row_hit_parts, hits_to_strings

    k = 35
    B, L = 40, 160
    codes = rng.integers(0, 4, (B, L)).astype(np.uint8)
    wt = rng.integers(0, 5, (B, L)).astype(np.int32)
    wt[wt == 4] = 100  # some real taxa
    splits = np.full(B, -1, np.int64)
    row_lens = np.full(B, L, np.int64)
    for i in range(B):
        if i % 3 == 0:  # paired rows
            splits[i] = 70
            codes[i, 70] = 4
        if i % 4 == 0:  # N runs
            codes[i, 20:90] = 4
        if i % 5 == 0:  # short content with trailing Ns
            row_lens[i] = 120
            codes[i, 120:] = 4
        # repeated taxa to force run merging
        wt[i, 10:30] = wt[i, 10]
    # make window taxa consistent with validity (invalid windows get junk,
    # but the formatter only reads valid-window positions)
    got = native.hit_lines(codes, wt, splits, row_lens, k)
    assert got is not None
    for i in range(B):
        split = None if splits[i] < 0 else int(splits[i])
        parts = _row_hit_parts(codes[i], wt[i], split, int(row_lens[i]), k)
        details, length = hits_to_strings(parts, k)
        assert got[i] == (details, length), f"row {i}: {got[i]} != {(details, length)}"


def test_output_lines_dense_and_gather(rng):
    """stpu_output_lines_dense must emit exactly the Python-composed full
    Kraken lines (header + hits_to_strings), and stpu_gather_rows must
    concatenate arbitrary row subsets in order."""
    from slacken.classify import _row_hit_parts, hits_to_strings

    k = 35
    B, L = 40, 160
    codes = rng.integers(0, 4, (B, L)).astype(np.uint8)
    wt = rng.integers(0, 5, (B, L)).astype(np.int32)
    wt[wt == 4] = 100
    splits = np.full(B, -1, np.int64)
    row_lens = np.full(B, L, np.int64)
    for i in range(B):
        if i % 3 == 0:
            splits[i] = 70
            codes[i, 70] = 4
        if i % 4 == 0:
            codes[i, 20:90] = 4
        wt[i, 10:30] = wt[i, 10]
    titles = [f"read {i}|x" for i in range(B)]
    tb = [t.encode() for t in titles]
    toffs = np.zeros(B + 1, np.int64)
    np.cumsum([len(t) for t in tb], out=toffs[1:])
    rtax = rng.integers(0, 1 << 20, B).astype(np.int64)
    rtax[::7] = 0
    classified = (rtax > 0).astype(np.uint8)
    got = native.output_lines_dense(
        codes, wt, splits, row_lens, b"".join(tb), toffs, rtax, classified,
        k, max(len(t) for t in tb),
    )
    assert got is not None
    buf, starts, ends = got
    mv = memoryview(buf)
    want_lines = []
    for i in range(B):
        split = None if splits[i] < 0 else int(splits[i])
        parts = _row_hit_parts(codes[i], wt[i], split, int(row_lens[i]), k)
        details, length = hits_to_strings(parts, k)
        cu = "C" if classified[i] else "U"
        want_lines.append(f"{cu}\t{titles[i]}\t{rtax[i]}\t{length}\t{details}\n")
        assert bytes(mv[starts[i] : ends[i]]).decode() == want_lines[i], i
    for idxs in (np.arange(B), np.array([5, 0, 17]), np.array([], np.int64)):
        data = native.gather_rows(buf, starts, ends, idxs)
        assert bytes(data).decode() == "".join(want_lines[i] for i in idxs)


def test_output_lines_thread_safety(rng):
    """The reused emit buffer is thread-local: two threads formatting
    concurrently must never corrupt each other's lines."""
    import threading

    k = 35
    B, L = 512, 160
    codes = rng.integers(0, 4, (B, L)).astype(np.uint8)
    wt = rng.integers(1, 1000, (B, L)).astype(np.int32)
    splits = np.full(B, -1, np.int64)
    row_lens = np.full(B, L, np.int64)
    tb = [f"t{i}".encode() for i in range(B)]
    toffs = np.zeros(B + 1, np.int64)
    np.cumsum([len(t) for t in tb], out=toffs[1:])
    blob = b"".join(tb)
    rtax = rng.integers(1, 1 << 20, B).astype(np.int64)
    classified = np.ones(B, np.uint8)
    idxs = np.arange(B)

    def render():
        buf, starts, ends = native.output_lines_dense(
            codes, wt, splits, row_lens, blob, toffs, rtax, classified,
            k, 8,
        )
        return bytes(native.gather_rows(buf, starts, ends, idxs))

    want = render()
    errors = []

    def worker():
        try:
            for _ in range(30):
                if render() != want:
                    errors.append("corrupted output")
                    return
        except Exception as e:  # noqa: BLE001
            errors.append(repr(e))

    threads = [threading.Thread(target=worker) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors


def test_packed_pairs_match_fragment_path(rng, tmp_path):
    """Paired packed fast path must classify identically to the Fragment
    path."""
    import jax

    from slacken.classify import Classifier, ClassifyParams, Fragment
    from slacken.index import IndexParams, KeyValueIndex
    from slacken.inputs import packed_pairs_from_files
    from test_taxonomy import random_taxonomy
    from test_index import make_genomes

    t = random_taxonomy(rng)
    genomes = make_genomes(rng, t, n_genomes=3, length=600)
    idx = KeyValueIndex.build(genomes, IndexParams(), t)

    r1, r2 = [], []
    for i in range(25):
        taxon, seq = genomes[i % 3]
        s = int(rng.integers(0, len(seq) - 150))
        a, b = seq[s : s + 70], seq[s + 80 : s + 150]
        if i % 5 == 0:
            a = a[:30] + "N" * 3 + a[33:]
        r1.append((f"pair{i}/1", a))
        r2.append((f"pair{i}/2", b))
    f1, f2 = tmp_path / "r1.fastq", tmp_path / "r2.fastq"
    for path, recs in ((f1, r1), (f2, r2)):
        with open(path, "w") as fh:
            for h, s in recs:
                fh.write(f"@{h}\n{s}\n+\n{'I' * len(s)}\n")

    cls = Classifier(idx)
    cpar = ClassifyParams(thresholds=[0.0, 0.1])
    fast = cls.classify_packed(packed_pairs_from_files(str(f1), str(f2)), cpar)
    frags = [Fragment(h1, s1, s2) for (h1, s1), (_, s2) in zip(r1, r2)]
    slow = cls.classify(frags, cpar)
    for conf in (0.0, 0.1):
        for a, b in zip(fast[conf], slow[conf]):
            assert (a.classified, a.taxon, a.length_string, a.hit_details) == (
                b.classified,
                b.taxon,
                b.length_string,
                b.hit_details,
            )


def test_radix_sort_kv(rng):
    from slacken import native

    n = 50_000
    k = rng.integers(0, 1 << 62, n, dtype=np.uint64)
    # duplicate keys to exercise stability + value ordering
    k[n // 2 :] = k[: n // 2]
    v = rng.integers(0, 1 << 30, n).astype(np.int32)
    sk, sv = native.radix_sort_kv(k, v, with_vals=True)
    o = np.lexsort((v, k))
    assert np.array_equal(sk, k[o]) and np.array_equal(sv, v[o])
    sk2, sv2 = native.radix_sort_kv(k, v)
    o2 = np.argsort(k, kind="stable")
    assert np.array_equal(sk2, k[o2]) and np.array_equal(sv2, v[o2])
    # empty
    e1, e2 = native.radix_sort_kv(np.empty(0, np.uint64), np.empty(0, np.int32))
    assert len(e1) == 0 and len(e2) == 0
