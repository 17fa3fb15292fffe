import io
import os

import numpy as np

from slacken.analysis.cami import CAMIToKrakenReport
from slacken.analysis.display import filter_report
from slacken.analysis.mapping_comparison import (
    MappingComparison,
    hit_category,
)
from slacken.analysis.migration import MinimizerMigration
from slacken.analysis.unifrac import UniFrac
from slacken.taxonomy import Taxonomy
from test_taxonomy import random_taxonomy


def small_tax():
    nodes = [
        (1, 1, "root"),
        (2, 1, "superkingdom"),
        (10, 2, "genus"),
        (11, 2, "genus"),
        (100, 10, "species"),
        (101, 10, "species"),
        (110, 11, "species"),
    ]
    return Taxonomy.from_nodes_and_names(nodes, [(t, f"N{t}") for t, _, _ in nodes])


def test_hit_categories():
    t = small_tax()
    S = 8
    # exact match
    assert hit_category(t, 100, 100, S) == ("TruePos", 0)
    # classified below/at ref's species ancestor
    assert hit_category(t, 100, 100, 7)[0] == "TruePos"
    # unclassified
    assert hit_category(t, 100, 0, S) == ("FalseNeg", 9)
    # ancestor of ref -> VaguePos with standardized steps
    cat, idx = hit_category(t, 100, 10, S)
    assert cat == "VaguePos" and idx == 1
    cat, idx = hit_category(t, 100, 2, S)
    assert cat == "VaguePos"
    # ROOT never TruePos
    assert hit_category(t, 100, 1, S)[0] == "VaguePos"
    # wrong clade
    assert hit_category(t, 100, 110, S)[0] == "FalsePos"
    # sibling species, same genus: at genus level this is TruePos
    assert hit_category(t, 100, 101, 7)[0] == "TruePos"
    assert hit_category(t, 100, 101, 8)[0] == "FalsePos"


def test_mapping_comparison_files(tmp_path):
    t = small_tax()
    # reference mapping: 3 columns (extra, id, taxon) 1-based id=2 taxon=3
    ref = tmp_path / "ref.tsv"
    ref_rows = [("x", f"r{i}", 100) for i in range(20)] + [
        ("x", f"s{i}", 110) for i in range(20)
    ]
    ref.write_text("".join(f"{a}\t{b}\t{c}\n" for a, b, c in ref_rows))

    # classifications: kraken format C/U, id, taxon
    cls = tmp_path / "cls.tsv"
    rows = []
    for i in range(20):
        rows.append(("C", f"r{i}", 100))  # all correct
    for i in range(15):
        rows.append(("C", f"s{i}", 100))  # wrong clade
    for i in range(15, 20):
        rows.append(("U", f"s{i}", 0))  # unclassified
    cls.write_text("".join(f"{a}\t{b}\t{c}\t101\tx\n" for a, b, c in rows))

    mc = MappingComparison(t, 2, 3, False, min_count_taxon=1)
    lines = mc.all_metrics(str(cls), str(ref))
    assert len(lines) == 2  # genus + species
    species = lines[1].split("\t")
    # per-read fields: classified, total, tp, fp, vp, fn ...
    vals = species[12:]
    taxon_classified, taxon_total = int(vals[0]), int(vals[1])
    assert taxon_total == 2  # 100 and 110
    read_vals = vals[4:]
    classified, total, tp, fp, vp, fn = map(int, read_vals[:6])
    assert (classified, total) == (35, 40)
    assert (tp, fp, fn) == (20, 15, 5)

    mc.process_files([str(cls)], str(tmp_path / "out"), str(ref))
    metrics = (tmp_path / "out_metrics.tsv").read_text().splitlines()
    assert metrics[0].startswith("title\t")
    assert len(metrics) == 3


def test_unifrac():
    t = small_tax()
    u = UniFrac(t, {100}, {100})
    assert u.distance == 0.0
    u2 = UniFrac(t, {100}, {110})
    # trees: {100,10,2} vs {110,11,2}; shared {2}; both {100,10,110,11,2}
    assert abs(u2.distance - 4 / 5) < 1e-9
    u3 = UniFrac(t, {100}, {101})
    # {100,10,2} vs {101,10,2}: distinct 1+1, both=4
    assert abs(u3.distance - 2 / 4) < 1e-9


def test_migration(rng, tmp_path):
    from slacken.index import IndexParams, KeyValueIndex
    from test_index import make_genomes

    t = random_taxonomy(rng)
    genomes = make_genomes(rng, t, n_genomes=4, length=500)
    idx = KeyValueIndex.build(genomes, IndexParams(), t)
    # reference: same genomes but two merged under one taxon -> LCAs move up
    genomes2 = list(genomes)
    genomes2.append((genomes[1][0], genomes[0][1]))
    ref = KeyValueIndex.build(genomes2, IndexParams(), t)
    mm = MinimizerMigration(idx, ref)
    a, b, steps = mm.taxa_distances()
    assert len(a) == len(idx.keys)  # all minimizers shared
    assert (steps > 0).sum() > 0  # some moved up
    hist = mm.run(str(tmp_path / "mig"))
    assert sum(hist.values()) == len(a)
    assert os.path.exists(str(tmp_path / "mig") + "_taxaToRoot_report.txt")


def test_cami(tmp_path):
    t = small_tax()
    mapping = tmp_path / "mapping.tsv"
    rows = ["#anonymous_read_id\tgenome_id\ttax_id\tread_id"]
    for i in range(10):
        rows.append(f"S0R{i}/1\tG1\t100\tnode-{i}/1")
        rows.append(f"S0R{i}/2\tG1\t100\tnode-{i}/2")
    for i in range(4):
        rows.append(f"S0Q{i}/1\tG2\t10\tnode2-{i}/1")  # genus level
        rows.append(f"S0Q{i}/2\tG2\t10\tnode2-{i}/2")
    mapping.write_text("\n".join(rows) + "\n")

    c2r = CAMIToKrakenReport(str(mapping), t, 8)  # species cutoff
    c2r.write_filtered_ids(str(tmp_path / "ids.txt"))
    ids = (tmp_path / "ids.txt").read_text().splitlines()
    assert len(ids) == 20  # genus-level reads filtered out
    c2r.write_filtered_report(str(tmp_path / "rep.txt"))
    rep = (tmp_path / "rep.txt").read_text()
    assert "\t10\t" in rep.split("\n")[2]  # 10 pairs at taxon 100


def test_display_filter():
    report = [
        "#Perc\tAggregate\tIn taxon\tRank\tTaxon\tName",
        "100.00\t90\t0\tR\t1\troot",
        " 66.00\t60\t0\tG\t10\t  GenA",
        " 33.00\t30\t30\tS\t100\t    SpA",
        " 33.00\t30\t30\tS\t101\t    SpB",
        "  5.00\t30\t30\tS\t110\t  SpC",
    ]
    buf = io.StringIO()
    filter_report(report, level_cutoff=7, out=buf)  # genus and above
    out = buf.getvalue().splitlines()
    assert len(out) == 2 and "GenA" in out[1]

    buf = io.StringIO()
    filter_report(report, min_percent=10.0, out=buf)
    assert all("SpC" not in line for line in buf.getvalue().splitlines())

    # clade filter: taxon 10 and its indented descendants
    buf = io.StringIO()
    filter_report(report, clades={10}, out=buf)
    out = buf.getvalue().splitlines()
    assert [l.split("\t")[4] for l in out] == ["10", "100", "101"]


def test_mapping_comparison_multi_dirs(tmp_path):
    t = small_tax()
    # two samples, classified dirs in the reference's multi-sample layout
    for sample, taxon in (("0", 100), ("1", 110)):
        d = tmp_path / "run_c0.00" / f"sample={sample}"
        d.mkdir(parents=True)
        with open(d / "part-00000.txt", "w") as f:
            for i in range(15):
                f.write(f"C\ts{sample}r{i}\t{taxon}\t101\t{taxon}:67\n")
        ref = tmp_path / "refs" / f"sample{sample}"
        ref.mkdir(parents=True)
        with open(ref / "reads_mapping.tsv", "w") as f:
            for i in range(15):
                f.write(f"x\ts{sample}r{i}\t{taxon}\n")

    mc = MappingComparison(t, 2, 3, False, min_count_taxon=1, multi_sample=True)
    mc.process_directories(
        [str(tmp_path / "run_c0.00")], str(tmp_path / "out"), str(tmp_path / "refs")
    )
    lines = (tmp_path / "out_metrics.tsv").read_text().splitlines()
    assert len(lines) == 1 + 2 * 2  # header + 2 samples x 2 ranks
    for line in lines[1:]:
        cols = line.split("\t")
        # perfect classification: tp = total, ppv = sensitivity = 1.0
        assert cols[-3] == "1.0" and cols[-2] == "1.0"


def test_accuracy_experiment_two_step_beats_one_step():
    """The reference's headline claim (README.md:300-330, All_metrics.tsv):
    2-step dynamic classification must match or beat the 1-step full-index
    pass on read sensitivity, and the gold-set index bounds both. Small
    reproduction of scripts/accuracy_corpus.py (which writes the checked-in
    metrics/All_metrics_synth.tsv at full scale)."""
    from slacken.analysis.experiment import run_experiment

    rows = run_experiment(
        n_genera=6, genome_len=120_000, n_present=3, n_reads=2000,
        thresholds=(0.05,), detect_count=20,
    )
    by = {(r["library"], r["rank"]): r for r in rows}
    assert len(rows) == 3 * 2  # 3 modes x 2 ranks
    for rank in ("Genus", "Species"):
        one = by[("1step", rank)]["per_read"]
        two = by[("2step", rank)]["per_read"]
        gold = by[("gold", rank)]["per_read"]
        assert two.sensitivity >= one.sensitivity, rank
        assert gold.sensitivity >= two.sensitivity - 1e-9, rank
        # taxon precision must not regress either
        assert (
            by[("2step", rank)]["per_taxon"].precision
            >= by[("1step", rank)]["per_taxon"].precision
        ), rank
    # the sibling-species confusion must actually bite at species rank:
    # the 2-step advantage is real, not vacuous
    assert by[("2step", "Species")]["per_read"].sensitivity > (
        by[("1step", "Species")]["per_read"].sensitivity + 0.2
    )


def test_background_reads_seeded_and_shaped():
    """The off-library background generator: same seed, same reads; an
    Illumina-like base composition, a length spread reaching below k, and
    N runs in a small share of reads."""
    from slacken.analysis.experiment import BACKGROUND_BASE_P, background_reads

    a = background_reads(np.random.default_rng(3), 4000)
    assert a == background_reads(np.random.default_rng(3), 4000)
    assert a != background_reads(np.random.default_rng(4), 4000)
    lens = np.array([len(f.seq) for f in a])
    assert lens.max() == 150 and lens.min() >= 20 and (lens < 35).any()
    assert 0.15 < (lens < 150).mean() < 0.25
    with_n = np.mean(["N" in f.seq for f in a])
    assert 0.02 < with_n < 0.08
    bases = "".join(f.seq for f in a).replace("N", "")
    freq = [bases.count(b) / len(bases) for b in "ACGT"]
    assert np.allclose(freq, BACKGROUND_BASE_P, atol=0.01)
    assert len({f.title for f in a}) == len(a)
