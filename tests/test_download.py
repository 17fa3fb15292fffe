"""Library download tooling (reference scripts/k2/) with an injected
offline fetcher: taxonomy extraction, assembly filtering, library layout,
seqid2taxid.map, .fai generation, and low-complexity masking."""

import gzip
import io
import os
import tarfile

import numpy as np
import pytest

from slacken import download
from slacken.download import LibraryDownloader, make_fai, mask_low_complexity


def make_taxdump():
    buf = io.BytesIO()
    files = {
        "nodes.dmp": "1\t|\t1\t|\tno rank\t|\n2\t|\t1\t|\tspecies\t|\n",
        "names.dmp": "1\t|\troot\t|\t\t|\tscientific name\t|\n",
        "merged.dmp": "3\t|\t2\t|\n",
        "division.dmp": "ignored\n",
    }
    with tarfile.open(fileobj=buf, mode="w:gz") as tf:
        for name, text in files.items():
            data = text.encode()
            ti = tarfile.TarInfo(name)
            ti.size = len(data)
            tf.addfile(ti, io.BytesIO(data))
    return buf.getvalue()


def fasta_gz(records):
    text = "".join(f">{h}\n{s}\n" for h, s in records)
    return gzip.compress(text.encode())


SUMMARY = (
    "## comment\n"
    "#assembly_accession\tbioproject\tbiosample\twgs_master\trefseq_category\t"
    "taxid\tspecies_taxid\torganism_name\tinfraspecific_name\tisolate\t"
    "version_status\tassembly_level\trelease_type\tgenome_rep\tseq_rel_date\t"
    "asm_name\tsubmitter\tgbrs_paired_asm\tpaired_asm_comp\tftp_path\n"
    "GCF_1\tx\tx\tx\tx\t100\t100\tOrg A\tx\tx\tlatest\tComplete Genome\tx\tx\tx\tx\tx\tx\tx\t"
    "https://ftp.ncbi.nlm.nih.gov/genomes/all/GCF_1\n"
    "GCF_2\tx\tx\tx\tx\t101\t101\tOrg B\tx\tx\tlatest\tContig\tx\tx\tx\tx\tx\tx\tx\t"
    "https://ftp.ncbi.nlm.nih.gov/genomes/all/GCF_2\n"
    "GCF_3\tx\tx\tx\tx\t102\t102\tOrg C\tx\tx\treplaced\tComplete Genome\tx\tx\tx\tx\tx\tx\tx\t"
    "https://ftp.ncbi.nlm.nih.gov/genomes/all/GCF_3\n"
)


class FakeNCBI:
    def __init__(self):
        self.requests = []
        self.data = {
            f"{download.NCBI}/pub/taxonomy/taxdump.tar.gz": make_taxdump(),
            f"{download.NCBI}/genomes/refseq/archaea/assembly_summary.txt": SUMMARY.encode(),
            f"{download.NCBI}/genomes/all/GCF_1/GCF_1_genomic.fna.gz": fasta_gz(
                [("NC_001.1 Org A chr", "ACGT" * 50), ("NC_002.1 plasmid", "GGCC" * 30)]
            ),
            f"{download.NCBI}/genomes/all/GCF_2/GCF_2_genomic.fna.gz": fasta_gz(
                [("NC_003.1", "ATAT" * 40)]
            ),
            f"{download.NCBI}/pub/UniVec/UniVec_Core": b">uv1 vector\nACGTACGTAC\n",
        }

    def __call__(self, url):
        self.requests.append(url)
        if url not in self.data:
            raise OSError(f"404: {url}")
        return self.data[url]


def test_taxonomy_and_library(tmp_path):
    fake = FakeNCBI()
    dl = LibraryDownloader(str(tmp_path), fetcher=fake, parallel=2, progress=False)

    tdir = dl.download_taxonomy()
    for f in ("nodes.dmp", "names.dmp", "merged.dmp"):
        assert os.path.exists(os.path.join(tdir, f))
    from slacken.taxonomy import Taxonomy

    t = Taxonomy.load(tdir)
    assert t.primary[3] == 2  # merged.dmp honored

    n_asm, n_seq = dl.download_library("archaea")
    # GCF_2 filtered (Contig < Complete Genome), GCF_3 filtered (replaced)
    assert (n_asm, n_seq) == (1, 2)
    assert os.path.exists(tmp_path / "library" / "archaea" / "GCF_1_genomic.fna.gz")
    assert not os.path.exists(tmp_path / "library" / "archaea" / "GCF_2_genomic.fna.gz")
    labels = dict(
        line.split("\t")
        for line in (tmp_path / "seqid2taxid.map").read_text().splitlines()
    )
    assert labels == {"NC_001.1": "100", "NC_002.1": "100"}

    # Contig level keeps GCF_2 and appends its label
    n_asm, n_seq = dl.download_library("archaea", level="Contig")
    assert (n_asm, n_seq) == (2, 3)

    # UniVec special library
    n_asm, n_seq = dl.download_library("UniVec_Core")
    assert (n_asm, n_seq) == (1, 1)
    assert "28384" in (tmp_path / "seqid2taxid.map").read_text()

    with pytest.raises(ValueError):
        dl.download_library("nonexistent")


def test_downloaded_library_builds_and_classifies(tmp_path):
    """End-to-end: download -> build -> classify via the real CLI."""
    from slacken import cli

    fake = FakeNCBI()
    dl = LibraryDownloader(str(tmp_path), fetcher=fake, progress=False)
    dl.download_taxonomy()
    # taxdump above is tiny; use taxa that exist in it
    fake.data[f"{download.NCBI}/genomes/refseq/archaea/assembly_summary.txt"] = (
        SUMMARY.replace("\t100\t100\t", "\t2\t2\t").encode()
    )
    rng = np.random.default_rng(0)
    genome = "".join("ACGT"[i] for i in rng.integers(0, 4, 2000))
    fake.data[f"{download.NCBI}/genomes/all/GCF_1/GCF_1_genomic.fna.gz"] = fasta_gz(
        [("NC_001.1 Org A", genome)]
    )
    dl.download_library("archaea")

    idx_loc = str(tmp_path / "idx")
    assert (
        cli.main(
            ["build", "-i", idx_loc, "-l", str(tmp_path), "-t",
             str(tmp_path / "taxonomy"), "-k", "21", "-m", "15", "-s", "2"]
        )
        == 0
    )
    reads = tmp_path / "reads.fasta"
    reads.write_text(f">r0\n{genome[100:300]}\n")
    out = str(tmp_path / "out")
    assert cli.main(["classify", "-i", idx_loc, str(reads), "-o", out, "-c", "0.0"]) == 0
    with gzip.open(out + "_c0.0/sample=all/part-00000.txt.gz", "rt") as f:
        line = f.read().splitlines()[0]
    assert line.startswith("C\tr0\t2\t")


def test_make_fai(tmp_path):
    p = tmp_path / "g.fna"
    p.write_text(">s1 desc\nACGTACGTAC\nACGTA\n>s2\nGG\n")
    make_fai(str(p))
    from slacken.inputs import read_fai

    fai = read_fai(str(p) + ".fai")
    assert fai["s1"] == (15, 9, 10, 11)
    assert fai["s2"][0] == 2


def test_mask_low_complexity():
    rng = np.random.default_rng(0)
    random_part = rng.integers(0, 4, 300).astype(np.uint8)
    poly_a = np.zeros(200, np.uint8)
    seq = np.concatenate([random_part, poly_a, random_part])
    masked = mask_low_complexity(seq, window=64, threshold=1.2)
    # the homopolymer is masked, the random flanks mostly survive
    assert (masked[350:450] == 4).all()
    assert (masked[:200] < 4).mean() > 0.9
    assert (masked[-200:] < 4).mean() > 0.9
    # already-ambiguous bases stay 4, valid bases are never invented
    assert ((masked == 4) | (masked == seq)).all()


def test_mask_fasta_roundtrip():
    from slacken.download import mask_low_complexity_fasta

    data = b">s1\n" + b"ACGT" * 100 + b"\n" + b"A" * 200 + b"\n"
    out = mask_low_complexity_fasta(data)
    lines = out.split(b"\n")
    assert lines[0] == b">s1"
    assert b"N" not in lines[1]  # random-ish line untouched
    assert lines[2].count(b"N") == 200  # homopolymer fully masked
