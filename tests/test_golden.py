"""Golden-format tests: freeze the exact output formats (Kraken lines,
kreport, kmer_distrib) so later optimisation rounds cannot drift them."""

import numpy as np

from slacken.classify import Classifier, ClassifyParams, Fragment
from slacken.index import IndexParams, KeyValueIndex
from slacken.report import KrakenReport
from slacken.taxonomy import Taxonomy


def fixed_tax():
    nodes = [
        (1, 1, "root"),
        (10, 1, "genus"),
        (100, 10, "species"),
        (101, 10, "species"),
    ]
    return Taxonomy.from_nodes_and_names(
        nodes, [(1, "root"), (10, "Genus ten"), (100, "Species A"), (101, "Species B")]
    )


def fixed_genome(taxon, seed, n=400):
    rng = np.random.default_rng(seed)
    return taxon, "".join("ACGT"[i] for i in rng.integers(0, 4, n))


def test_kraken_line_and_report_golden(tmp_path):
    tax = fixed_tax()
    genomes = [fixed_genome(100, 1), fixed_genome(101, 2)]
    idx = KeyValueIndex.build(genomes, IndexParams(), tax)
    cls = Classifier(idx)

    g = genomes[0][1]
    frags = [
        Fragment("readA", g[10:111]),
        Fragment("readB", g[50:120], g[200:280]),  # paired
        Fragment("readC", "N" * 40 + g[300:366]),  # leading ambiguity
        Fragment("readD", "ACGT" * 30),  # unclassifiable (random-ish)
    ]
    res = cls.classify(frags, ClassifyParams(thresholds=[0.0]))[0.0]
    lines = [r.output_line() for r in res]
    assert lines[0] == "C\treadA\t100\t101\t100:67"
    assert lines[1] == "C\treadB\t100\t70|80\t100:36 |:| 100:46"
    assert lines[2] == "C\treadC\t100\t72\tA:6 100:32"
    assert lines[3] == "U\treadD\t0\t120\t0:86"

    report = KrakenReport(tax, [(100, 30), (101, 10), (0, 10)])
    assert report.lines() == [
        "#Perc\tAggregate\tIn taxon\tRank\tTaxon\tName",
        " 20.00\t10\t10\tU\t0\tunclassified",
        " 80.00\t40\t0\tR\t1\troot",
        " 80.00\t40\t0\tG\t10\t  Genus ten",
        " 60.00\t30\t30\tS\t100\t    Species A",
        " 20.00\t10\t10\tS\t101\t    Species B",
    ]


def test_kmer_distrib_golden(tmp_path):
    from slacken.bracken import write_kmer_distrib

    counts = {(100, 100): 90, (10, 100): 5, (0, 100): 5, (101, 101): 50}
    out = str(tmp_path / "d.kmer_distrib")
    write_kmer_distrib(counts, out)
    assert open(out).read() == (
        "mapped_taxid\tgenome_taxids:kmers_mapped:total_genome_kmers\n"
        "0\t100:5:100\n"
        "10\t100:5:100\n"
        "100\t100:90:100\n"
        "101\t101:50:50\n"
    )
