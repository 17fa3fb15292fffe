"""Ground-truth cross-check against KMC3/Discount-verified constants.

The reference pins per-taxon distinct k-mer counts for its tiny library
(Testing.scala:171-173), but ships only the .fai — the FASTA must be
supplied externally (STPU_TINYDATA=/path/to/slacken_tinydata.fna) or
fetched over the network (this build host has no egress; see
scripts/ground_truth_check.py). The exact-constant check is therefore
network/file-gated; an unconditional self-consistency test of the counting
method runs always.
"""

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))

from ground_truth_check import VERIFIED, distinct_canonical_kmers, read_tinydata

TINYDATA = os.environ.get(
    "STPU_TINYDATA", "/root/repo/testData/slacken_tinydata.fna"
)


def test_distinct_canonical_kmer_counting_method(rng):
    """The counting method itself, validated on a sequence where the answer
    is enumerable: distinct canonical k-mers of a random sequence must equal
    a naive python set of min(kmer, revcomp) over valid windows."""
    from slacken.ops import encode

    lut = np.frombuffer(b"ACGT", dtype=np.uint8)
    seq = lut[rng.integers(0, 4, 5000)].tobytes().decode()
    # inject ambiguity to exercise window breaking
    seq = seq[:700] + "N" * 3 + seq[703:]
    for k in (31, 35):
        naive = set()
        for i in range(len(seq) - k + 1):
            w = seq[i : i + k]
            if "N" in w:
                continue
            rc = encode.revcomp_str(w)
            naive.add(min(w, rc))
        got = distinct_canonical_kmers([seq], k)
        assert got == len(naive), k


@pytest.mark.skipif(
    not os.path.exists(TINYDATA),
    reason="slacken_tinydata.fna not available (no network egress on this "
    "host; set STPU_TINYDATA to run the exact KMC3-verified check)",
)
def test_kmc3_verified_counts():
    per = read_tinydata(TINYDATA)
    for k, expected in VERIFIED.items():
        for taxon, want in expected.items():
            got = distinct_canonical_kmers(per[taxon], k)
            assert got == want, (k, taxon, got, want)
