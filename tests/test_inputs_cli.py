import gzip
import os

import numpy as np
import pytest

from slacken import cli, inputs
from test_taxonomy import random_taxonomy


def write_fasta(path, records, width=60, compress=False):
    op = gzip.open if compress else open
    with op(path, "wt") as f:
        for h, s in records:
            f.write(f">{h}\n")
            for i in range(0, len(s), width):
                f.write(s[i : i + width] + "\n")


def write_fastq(path, records):
    with open(path, "w") as f:
        for h, s in records:
            f.write(f"@{h}\n{s}\n+\n{'I' * len(s)}\n")


def random_genome(rng, n):
    return "".join("ACGT"[i] for i in rng.integers(0, 4, n))


@pytest.fixture
def library_dir(tmp_path, rng):
    """On-disk genome library + taxonomy, like testData/slacken."""
    t = random_taxonomy(rng)
    leaves = [x for x in t.taxa() if t.is_leaf(x)][:4]
    lib = tmp_path / "lib"
    (lib / "library").mkdir(parents=True)
    labels = []
    genomes = {}
    for i, taxon in enumerate(leaves):
        g = random_genome(rng, 3000)
        genomes[taxon] = g
        # two sequences per genome file
        write_fasta(
            lib / "library" / f"genome{i}.fna",
            [(f"seq{taxon}a desc", g[:1500]), (f"seq{taxon}b", g[1500:])],
            compress=(i == 0),
        )
        if i == 0:
            os.rename(lib / "library" / f"genome{i}.fna", lib / "library" / f"genome{i}.fna.gz")
        labels += [(f"seq{taxon}a", taxon), (f"seq{taxon}b", taxon)]
    with open(lib / "seqid2taxid.map", "w") as f:
        for sid, taxon in labels:
            f.write(f"{sid}\t{taxon}\n")
    taxdir = tmp_path / "taxonomy"
    t.save(str(taxdir))
    return t, leaves, genomes, str(lib), str(taxdir), tmp_path


def test_fasta_fastq_readers(tmp_path, rng):
    recs = [("a desc1", random_genome(rng, 150)), ("b", random_genome(rng, 75))]
    write_fasta(tmp_path / "x.fasta", recs)
    got = list(inputs.read_fasta(str(tmp_path / "x.fasta")))
    assert got == recs

    write_fasta(tmp_path / "x.fa.gz", recs, compress=True)
    assert list(inputs.read_fasta(str(tmp_path / "x.fa.gz"))) == recs

    write_fastq(tmp_path / "x.fastq", recs)
    assert list(inputs.read_fastq(str(tmp_path / "x.fastq"))) == recs

    # file list expansion
    with open(tmp_path / "list.txt", "w") as f:
        f.write(f"{tmp_path}/x.fasta\n{tmp_path}/x.fastq\n")
    frags = list(inputs.fragments_from_files([f"@{tmp_path}/list.txt"]))
    assert len(frags) == 4


def test_paired_reading(tmp_path, rng):
    r1 = [(f"read{i}/1", random_genome(rng, 80)) for i in range(5)]
    r2 = [(f"read{i}/2", random_genome(rng, 80)) for i in range(5)]
    write_fastq(tmp_path / "r1.fastq", r1)
    write_fastq(tmp_path / "r2.fastq", r2)
    frags = list(
        inputs.fragments_from_files(
            [str(tmp_path / "r1.fastq"), str(tmp_path / "r2.fastq")], paired=True
        )
    )
    assert len(frags) == 5
    for i, f in enumerate(frags):
        assert f.title == f"read{i}/1"
        assert f.seq == r1[i][1]
        assert f.seq2 == r2[i][1]


def test_cli_build_classify_stats(library_dir, tmp_path, capsys):
    t, leaves, genomes, lib, taxdir, base = library_dir
    idx_loc = str(base / "idx")
    assert cli.main(["build", "-i", idx_loc, "-l", lib, "-t", taxdir, "-k", "35", "-m", "31"]) == 0
    out = capsys.readouterr().out
    assert "Saved" in out and "Tree size" in out

    # classify reads drawn from the genomes
    rng = np.random.default_rng(1)
    reads = []
    for i in range(20):
        taxon = leaves[i % len(leaves)]
        g = genomes[taxon]
        s = int(rng.integers(0, len(g) - 101))
        reads.append((f"r{i}_t{taxon}", g[s : s + 101]))
    write_fastq(base / "reads.fastq", reads)
    out_loc = str(base / "out")
    assert (
        cli.main(
            ["classify", "-i", idx_loc, str(base / "reads.fastq"), "-o", out_loc, "-c", "0.0"]
        )
        == 0
    )
    with gzip.open(out_loc + "_c0.0/sample=all/part-00000.txt.gz", "rt") as f:
        lines = f.read().splitlines()
    assert len(lines) == 20
    ok = 0
    for line in lines:
        flag, title, taxon_s = line.split("\t")[:3]
        src = int(title.split("_t")[1])
        if flag == "C":
            assert t.has_ancestor(src, int(taxon_s))
            ok += 1
    assert ok >= 18
    assert os.path.exists(out_loc + "_c0.0/all_kreport.txt")

    # stats + histogram + inspect
    assert cli.main(["stats", "-i", idx_loc]) == 0
    assert "minimizers" in capsys.readouterr().out
    assert cli.main(["stats", "-i", idx_loc, "--histogram"]) == 0
    assert "histogram" in capsys.readouterr().out
    rep = str(base / "rep")
    assert cli.main(["inspect", "-i", idx_loc, "-o", rep, "--labels", lib + "/seqid2taxid.map"]) == 0
    assert os.path.exists(rep + "_min_report.txt")
    assert os.path.exists(rep + "_genome_report.txt")
    assert os.path.exists(rep + "_missing_report.txt")


def test_cli_respace(library_dir, capsys):
    t, leaves, genomes, lib, taxdir, base = library_dir
    idx_loc = str(base / "idx_s3")
    assert cli.main(["build", "-i", idx_loc, "-l", lib, "-t", taxdir, "-s", "3"]) == 0
    out_loc = str(base / "re_s3")
    assert cli.main(["respace", "-i", idx_loc, "-o", out_loc, "--spaces", "5", "7"]) == 0
    from slacken.index import KeyValueIndex

    for s in (5, 7):
        ri = KeyValueIndex.load(str(base / f"re_s{s}"))
        assert ri.params.spaces == s
        assert len(ri.keys) > 0


def test_indexed_fasta_streaming(tmp_path, rng):
    from slacken import inputs

    seqs = [("chr1", random_genome(rng, 5000)), ("chr2", random_genome(rng, 301))]
    path = tmp_path / "g.fna"
    width = 70
    write_fasta(path, seqs, width=width)
    # build a .fai: name, length, offset, linebases, linewidth
    with open(path, "rb") as f:
        data = f.read()
    fai_lines = []
    pos = 0
    for name, s in seqs:
        hdr = f">{name}\n".encode()
        pos = data.index(hdr, pos) + len(hdr)
        fai_lines.append(f"{name}\t{len(s)}\t{pos}\t{width}\t{width + 1}")
    (tmp_path / "g.fna.fai").write_text("\n".join(fai_lines) + "\n")

    k = 35
    chunks = list(inputs.read_fasta_indexed(str(path), max_chunk=1024, k=k))
    # reassemble: chunks overlap by k-1
    by_name = {}
    for name, seq, off in chunks:
        cur = by_name.get(name, "")
        assert cur[off:] == seq[: len(cur) - off]
        by_name[name] = cur[:off] + seq
    assert by_name == dict(seqs)
    # every k-window appears in some chunk
    for name, seq, off in chunks:
        assert len(seq) >= k or len(dict(seqs)[name]) < k


def test_real_testdata_readers():
    """Parse the reference's bundled real read files (InputReaderProps
    analogue against testData)."""
    import os

    base = "/root/reference/testData"
    if not os.path.isdir(base):
        import pytest

        pytest.skip("reference testData not available")
    fq = list(inputs.read_fastq(os.path.join(base, "ERR599052_10k.fastq")))
    assert len(fq) == 10000
    assert all(s and set(s) <= set("ACGTN") for _, s in fq[:100])

    fa = list(inputs.read_fasta(os.path.join(base, "SRR094926_10k.fasta")))
    assert len(fa) == 9845  # actual record count of the bundled file

    # Akashinriki is a single genome sequence with a .fai; exercise both the
    # whole-file reader and the indexed chunked reader
    aka = os.path.join(base, "Akashinriki_10k.fasta")
    fa2 = list(inputs.read_fasta(aka))
    assert len(fa2) == 1
    chunks = list(inputs.read_fasta_indexed(aka, max_chunk=100_000, k=35))
    reassembled = ""
    for name, seq, off in chunks:
        reassembled = reassembled[:off] + seq
    assert reassembled == fa2[0][1]

    # native parser agrees with the python reader on real data
    from slacken import native
    from slacken.ops import encode

    with open(os.path.join(base, "ERR599052_10k.fastq"), "rb") as f:
        packed, consumed = native.pack_fastq_chunk(f.read())
    assert len(packed) == 10000
    for i in (0, 123, 9999):
        assert packed.titles[i] == fq[i][0]
        assert packed.lengths[i] == len(fq[i][1])
        assert np.array_equal(
            packed.codes[i, : packed.lengths[i]], encode.encode_seq(fq[i][1])
        )


def test_cli_build_ordering_frequency(library_dir, tmp_path, capsys):
    """`build --ordering frequency` samples the library, persists the rank
    LUT, and the resulting index classifies library reads correctly
    (MinimizerCLIConf.scala:81-95)."""
    t, leaves, genomes, lib, taxdir, base = library_dir
    idx_loc = str(base / "idx_freq")
    assert (
        cli.main(
            ["build", "-i", idx_loc, "-l", lib, "-t", taxdir,
             "-k", "21", "-m", "11", "-s", "2", "--ordering", "frequency"]
        )
        == 0
    )
    assert os.path.exists(os.path.join(idx_loc, "ordering_lut.npy"))

    rng = np.random.default_rng(7)
    reads = []
    for i in range(10):
        taxon = leaves[i % len(leaves)]
        g = genomes[taxon]
        s = int(rng.integers(0, len(g) - 101))
        reads.append((f"r{i}_t{taxon}", g[s : s + 101]))
    write_fastq(base / "freads.fastq", reads)
    out_loc = str(base / "fout")
    assert (
        cli.main(
            ["classify", "-i", idx_loc, str(base / "freads.fastq"), "-o", out_loc,
             "-c", "0.0"]
        )
        == 0
    )
    with gzip.open(out_loc + "_c0.0/sample=all/part-00000.txt.gz", "rt") as f:
        lines = f.read().splitlines()
    assert len(lines) == 10
    ok = 0
    for line in lines:
        flag, title, taxon_s = line.split("\t")[:3]
        src = int(title.split("_t")[1])
        if flag == "C":
            assert t.has_ancestor(src, int(taxon_s))
            ok += 1
    assert ok >= 9
