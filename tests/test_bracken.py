import numpy as np

import oracle
from slacken.bracken import BrackenWeights, write_kmer_distrib
from slacken.index import IndexParams, KeyValueIndex
from test_index import make_genomes, oracle_index
from test_taxonomy import random_taxonomy

K, M, S = 35, 31, 7


class FakeLibrary:
    def __init__(self, genomes):
        self.genomes = genomes

    def sequences(self):
        for taxon, seq in self.genomes:
            yield taxon, f"seq{taxon}", seq


def oracle_bracken(genomes, idx_map, parents, read_len, k, m, s):
    """Naive per-read simulation: classify every read of length R from every
    genome against the minimizer map (FragmentWindow semantics, but O(L*R))."""
    out = {}
    for source, seq in genomes:
        codes = oracle.encode(seq)
        L = len(seq)
        # per-position window taxa (NONE where invalid), via spans
        t = [0] * L
        spans_list = []  # (start, n_windows, taxon, distinct)
        i = 0
        while i < L:
            j = i
            while j < L and (codes[j] < 4) == (codes[i] < 4):
                j += 1
            if j - i >= k and codes[i] < 4:
                last = None
                for st, nw, value, _ in oracle.spans(codes[i:j], k, m, s):
                    taxon = idx_map.get(value, 0)
                    distinct = last is None or value != last
                    last = value
                    spans_list.append((i + st, nw, taxon, distinct))
                    for w in range(i + st, i + st + nw):
                        t[w] = taxon
            i = j
        W = read_len - k + 1
        for start in range(0, L - read_len + 1):
            window = t[start : start + W]
            counts = {}
            for x in window:
                counts[x] = counts.get(x, 0) + 1
            hit_groups = sum(
                1
                for (st, nw, taxon, distinct) in spans_list
                if distinct and taxon != 0 and st < start + W and st + nw > start
            )
            taxon = oracle.resolve_tree(parents, counts, 0.0)
            dest = taxon if hit_groups >= 2 else 0
            out[(dest, source)] = out.get((dest, source), 0) + 1
    return out


def test_bracken_vs_oracle(rng):
    t = random_taxonomy(rng)
    parents = {i: int(p) for i, p in enumerate(t.parents)}
    genomes = make_genomes(rng, t, n_genomes=4, length=700)
    # add shared sequence so some reads map to an LCA
    genomes.append((genomes[0][0], genomes[1][1][:400]))

    idx = KeyValueIndex.build(genomes, IndexParams(k=K, m=M, spaces=S), t)
    idx_map = oracle_index(genomes, K, M, S, parents)

    bw = BrackenWeights(idx, 100)
    got = bw.build_weights(FakeLibrary(genomes), {g[0] for g in genomes})
    want = oracle_bracken(genomes, idx_map, parents, 100, K, M, S)
    assert got == want


def test_bracken_with_ns(rng):
    t = random_taxonomy(rng)
    parents = {i: int(p) for i, p in enumerate(t.parents)}
    genomes = make_genomes(rng, t, n_genomes=2, length=500)
    # genome with ambiguous stretch
    g0 = genomes[0]
    seq = g0[1][:200] + "N" * 60 + g0[1][260:]
    genomes[0] = (g0[0], seq)
    idx = KeyValueIndex.build(genomes, IndexParams(k=K, m=M, spaces=S), t)
    idx_map = oracle_index(genomes, K, M, S, parents)
    bw = BrackenWeights(idx, 100)
    got = bw.build_weights(FakeLibrary(genomes), {g[0] for g in genomes})
    want = oracle_bracken(genomes, idx_map, parents, 100, K, M, S)
    assert got == want


def test_gradual_and_write(rng, tmp_path):
    t = random_taxonomy(rng)
    genomes = make_genomes(rng, t, n_genomes=4, length=400)
    idx = KeyValueIndex.build(genomes, IndexParams(k=K, m=M, spaces=S), t)
    bw = BrackenWeights(idx, 100)
    lib = FakeLibrary(genomes)
    taxa = {g[0] for g in genomes}
    full = bw.build_weights(lib, taxa)
    gradual = bw.build_weights_gradually(lib, taxa, str(tmp_path / "tmp"), chunks=3)
    assert full == gradual

    out = str(tmp_path / "weights.kmer_distrib")
    write_kmer_distrib(full, out)
    lines = open(out).read().splitlines()
    assert lines[0] == "mapped_taxid\tgenome_taxids:kmers_mapped:total_genome_kmers"
    # totals per source must equal number of simulated reads per genome
    per_source = {}
    for line in lines[1:]:
        for piece in line.split("\t")[1].split(" "):
            src, cnt, tot = map(int, piece.split(":"))
            per_source.setdefault(src, [0, tot])[0] += cnt
    for taxon, seq in genomes:
        n_reads = len(seq) - 100 + 1
        assert per_source[taxon][0] == n_reads
        assert per_source[taxon][1] == n_reads


def test_gradual_resumes_from_persisted_chunks(rng, tmp_path, monkeypatch):
    """A re-run after a mid-job kill must resume from the durable chunk files
    instead of recomputing them (BrackenWeights.scala:356-374 spot-node
    resilience). A second gradual run with compute poisoned to raise proves
    every chunk was served from disk."""
    t = random_taxonomy(rng)
    genomes = make_genomes(rng, t, n_genomes=4, length=400)
    idx = KeyValueIndex.build(genomes, IndexParams(k=K, m=M, spaces=S), t)
    bw = BrackenWeights(idx, 100)
    lib = FakeLibrary(genomes)
    taxa = {g[0] for g in genomes}

    tmp = str(tmp_path / "tmp")
    want = bw.build_weights_gradually(lib, taxa, tmp, chunks=3)

    # simulate a killed job that completed only some chunks: delete one chunk
    import os

    chunk_files = sorted(os.listdir(tmp))
    assert len(chunk_files) >= 3
    os.unlink(os.path.join(tmp, chunk_files[-1]))

    calls = {"n": 0}
    real = BrackenWeights.build_weights

    def counting(self, library, taxa_set):
        calls["n"] += 1
        return real(self, library, taxa_set)

    monkeypatch.setattr(BrackenWeights, "build_weights", counting)
    got = bw.build_weights_gradually(lib, taxa, tmp, chunks=3)
    assert got == want
    assert calls["n"] == 1  # only the lost chunk was recomputed

    # with all chunks present, compute must not run at all
    def poisoned(self, library, taxa_set):
        raise AssertionError("build_weights called despite complete chunks")

    monkeypatch.setattr(BrackenWeights, "build_weights", poisoned)
    assert bw.build_weights_gradually(lib, taxa, tmp, chunks=3) == want


def test_cli_bracken_build_gradual_default(rng, tmp_path, monkeypatch):
    """CLI bracken-build must run the gradual path by default (reference:
    buildAndWriteWeights(..., gradual = true), Slacken.scala:276) and honor
    --no-gradual."""
    from slacken import cli
    from slacken import bracken as bracken_mod
    from test_inputs_cli import write_fasta

    t = random_taxonomy(rng)
    leaves = [x for x in t.taxa() if t.is_leaf(x)][:2]
    lib = tmp_path / "lib"
    (lib / "library").mkdir(parents=True)
    with open(lib / "seqid2taxid.map", "w") as f:
        for i, taxon in enumerate(leaves):
            g = make_genomes(rng, t, n_genomes=1, length=400)[0][1]
            write_fasta(lib / "library" / f"g{i}.fna", [(f"seq{taxon}", g)])
            f.write(f"seq{taxon}\t{taxon}\n")
    taxdir = tmp_path / "taxonomy"
    t.save(str(taxdir))
    idx_loc = str(tmp_path / "idx")
    assert (
        cli.main(
            ["build", "-i", idx_loc, "-l", str(lib), "-t", str(taxdir), "-k",
             str(K), "-m", str(M), "-s", str(S)]
        )
        == 0
    )

    seen = {}
    real = bracken_mod.BrackenWeights.build_and_write_weights

    def spy(self, library, taxa_set, out, gradual=False):
        seen["gradual"] = gradual
        return real(self, library, taxa_set, out, gradual=gradual)

    monkeypatch.setattr(bracken_mod.BrackenWeights, "build_and_write_weights", spy)
    assert (
        cli.main(["bracken-build", "-i", idx_loc, "-l", str(lib), "--read-len", "100"])
        == 0
    )
    assert seen["gradual"] is True
    out = f"{idx_loc}_bracken/database100mers.kmer_distrib"
    assert open(out).readline().startswith("mapped_taxid")
    import os

    assert not os.path.exists(out + "_tmp")  # tmp chunks cleaned up on success

    assert (
        cli.main(
            ["bracken-build", "-i", idx_loc, "-l", str(lib), "--read-len", "100",
             "--no-gradual"]
        )
        == 0
    )
    assert seen["gradual"] is False


def test_device_path_matches_numpy(rng):
    """The device window classifier must agree with the numpy path exactly
    (and actually take the device path, not the overflow fallback)."""
    t = random_taxonomy(rng)
    genomes = make_genomes(rng, t, n_genomes=4, length=2000)
    genomes.append((genomes[0][0], genomes[1][1][:900]))  # shared content
    g0 = genomes[2]
    genomes[2] = (g0[0], g0[1][:700] + "N" * 50 + g0[1][750:])  # ambiguity
    idx = KeyValueIndex.build(genomes, IndexParams(k=K, m=M, spaces=S), t)
    lib = FakeLibrary(genomes)
    taxa = {g[0] for g in genomes}

    dev = BrackenWeights(idx, 100, use_device=True).build_weights(lib, taxa)
    cpu = BrackenWeights(idx, 100, use_device=False).build_weights(lib, taxa)
    assert dev == cpu


def test_fragment_kernel_tiled_matches_routed(rng):
    """Bracken's tiled fragment-scan kernel (GPU path) must equal the
    routed one."""
    from slacken.bracken import _fragment_kernel, _fragment_kernel_tiled
    from slacken.index import IndexParams, KeyValueIndex
    from slacken.ops import encode as enc
    from test_index import make_genomes
    from test_taxonomy import random_taxonomy

    t = random_taxonomy(rng)
    genomes = make_genomes(rng, t, n_genomes=4, length=700)
    idx = KeyValueIndex.build(genomes, IndexParams(), t)
    mp = idx.params.minimizer_params
    rows = np.stack(
        [enc.encode_seq(g[:512]) for _, g in genomes]
    ).astype(np.uint8)
    a = _fragment_kernel(
        rows, idx.device_keys.hi, idx.device_keys.lo, idx.device_taxa,
        idx.device_router, mp, idx.router_rounds, idx.router_bits,
        idx.key_bits, idx.device_lut,
    )
    table, tile = idx.device_tiled
    b = _fragment_kernel_tiled(
        rows, table, idx.device_router, mp, tile, idx.router_bits,
        idx.key_bits, idx.device_lut,
    )
    for x, y in zip(a, b):
        assert np.array_equal(np.asarray(x), np.asarray(y))
