import numpy as np

from slacken.api import Slacken
from slacken.index import IndexParams, KeyValueIndex
from test_index import make_genomes
from test_taxonomy import random_taxonomy


def test_api_roundtrip(rng, tmp_path):
    t = random_taxonomy(rng)
    genomes = make_genomes(rng, t, n_genomes=3, length=600)
    idx = KeyValueIndex.build(genomes, IndexParams(), t)
    idx.save(str(tmp_path / "idx"))

    sl = Slacken(str(tmp_path / "idx"), detailed=True, confidence=0.0, unclassified=True)
    reads = [(f"r{i}", genomes[i % 3][1][50:151]) for i in range(6)]
    res = sl.classify_reads(reads)
    assert len(res) == 6
    assert all(r.classified for r in res)

    # paired via reads2
    r1 = [(f"p{i}", genomes[0][1][i * 10 : i * 10 + 60]) for i in range(3)]
    r2 = [(f"p{i}", genomes[0][1][300 + i * 10 : 360 + i * 10]) for i in range(3)]
    res2 = sl.classify_reads(r1, r2)
    assert all("|:|" in r.hit_details for r in res2)

    reports = sl.write_reports(res, str(tmp_path / "api_out"))
    import os

    assert all(os.path.exists(p) for p in reports)


def test_check_input(tmp_path, rng):
    from slacken.inputs import GenomeLibrary, check_input
    from test_inputs_cli import write_fasta

    lib = tmp_path / "lib"
    (lib / "library").mkdir(parents=True)
    good = "".join("ACGT"[i] for i in rng.integers(0, 4, 200))
    write_fasta(lib / "library" / "g.fna", [("ok", good), ("bad", "ACGTN" * 20), ("short", "ACGT")])
    (lib / "seqid2taxid.map").write_text("ok\t2\nbad\t2\nshort\t2\n")
    gl = GenomeLibrary.from_directory(str(lib))
    bad = check_input(gl, 35)
    assert bad == ["bad", "short"]
