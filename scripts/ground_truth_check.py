#!/usr/bin/env python
"""Ground-truth cross-check against the reference's KMC3/Discount-verified
k-mer counts (VERDICT r2 #5).

The reference pins per-taxon distinct k-mer counts for its tiny test library
`testData/slacken/slacken_tinydata.fna`, independently computed with KMC3 and
Discount (Testing.scala:171-173):

    distinct 31-mers: 526997 -> 2,914,769   455631 -> 3,594,763   9606 -> 639,800
    distinct 35-mers: 526997 -> 2,902,850   455631 -> 3,565,872   9606 -> 639,784

The FASTA itself is not shipped (only its .fai). Two ways to obtain it:

  1. `--fasta PATH` — the original slacken_tinydata.fna, if you have it.
     All three taxa are checked (exact).
  2. `--download DIR` — fetch the two bacterial genomes from NCBI
     (455631 = NZ_CM000441.1 + NZ_ABFD020000{18..31}.1; 526997 =
     NZ_CM000742.1, per the shipped .fai). Requires network egress — THIS
     BUILD HOST HAS NONE (DNS resolution fails; see BASELINE.md), so this
     mode is recorded here for a connected machine. The 9606 entry is an
     unreproducible 799,920 bp slice of NC_000001.11 (human chr1) and is
     skipped in this mode.

Counting semantics matched to KMC3: distinct CANONICAL k-mers per taxon,
ambiguous bases break k-mer windows. Computed with this repo's own device
scan (ops.minimizers with m=k, spaces=0: every valid window's canonical
k-mer priority with a zero toggle mask is the canonical k-mer itself), so a
pass validates the 2-bit encode / reverse complement / canonical-min pipeline
against an external tool's numbers, not against ourselves.
"""

import argparse
import json
import sys
import os

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

VERIFIED = {  # Testing.scala:171-173 (KMC3 + Discount)
    31: {526997: 2914769, 455631: 3594763, 9606: 639800},
    35: {526997: 2902850, 455631: 3565872, 9606: 639784},
}

ACCESSIONS = {
    455631: ["NZ_CM000441.1"] + [f"NZ_ABFD020000{i}.1" for i in range(18, 32)],
    526997: ["NZ_CM000742.1"],
}


def distinct_canonical_kmers(seqs, k: int) -> int:
    """Distinct canonical k-mers over an iterable of sequences, via the
    device scan (m=k, spaces=0, toggle=0 -> priority == canonical k-mer)."""
    import numpy as np

    from slacken.ops import encode
    from slacken.ops.minimizers import MinimizerParams, window_minimizers

    if k > 31:
        mp = MinimizerParams(k=k, m=k, spaces=0, toggle_mask=0)
    else:
        mp = MinimizerParams(k=k, m=k, spaces=0, toggle_mask=0)
    row_len = 1 << 16
    seen = []
    for seq in seqs:
        codes = encode.encode_seq(seq) if isinstance(seq, str) else seq
        step = row_len - (k - 1)
        rows = [codes[off : off + row_len] for off in range(0, max(len(codes) - k + 1, 1), step)]
        batch, _ = encode.pack_batch(rows, row_len)
        wm = window_minimizers(batch, mp)
        valid = np.asarray(wm.valid)
        if mp.wide:
            limbs = [np.asarray(x)[valid].astype(np.uint64) for x in wm.minimizer.limbs]
            arr = np.stack(
                [(limbs[0] << np.uint64(32)) | limbs[1],
                 (limbs[2] << np.uint64(32)) | limbs[3]], axis=1)
            seen.append(np.unique(arr, axis=0))
        else:
            hi = np.asarray(wm.minimizer.hi)[valid].astype(np.uint64)
            lo = np.asarray(wm.minimizer.lo)[valid].astype(np.uint64)
            seen.append(np.unique((hi << np.uint64(32)) | lo))
    import numpy as np

    if not seen:
        return 0
    allv = np.concatenate(seen)
    return int(len(np.unique(allv, axis=0) if allv.ndim > 1 else np.unique(allv)))


def read_tinydata(path):
    """Parse slacken_tinydata.fna into {taxon: [seq, ...]} using the
    kraken:taxid|TAXID|ACC header convention."""
    per = {}
    taxon = None
    buf = []

    def flush():
        if taxon is not None and buf:
            per.setdefault(taxon, []).append("".join(buf))

    with open(path) as f:
        for line in f:
            if line.startswith(">"):
                flush()
                buf = []
                try:
                    taxon = int(line.split("|")[1])
                except (IndexError, ValueError):
                    taxon = None
            else:
                buf.append(line.strip())
    flush()
    return per


def fetch_ncbi(acc: str, dest: str) -> str:
    """Download one accession FASTA via NCBI efetch (network required)."""
    import urllib.request

    out = os.path.join(dest, f"{acc}.fna")
    if not os.path.exists(out):
        url = (
            "https://eutils.ncbi.nlm.nih.gov/entrez/eutils/efetch.fcgi"
            f"?db=nuccore&id={acc}&rettype=fasta&retmode=text"
        )
        urllib.request.urlretrieve(url, out)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--fasta", help="path to the original slacken_tinydata.fna")
    ap.add_argument("--download", help="fetch bacterial accessions into DIR (needs network)")
    args = ap.parse_args()

    import jax

    if os.environ.get("STPU_PLATFORM"):
        jax.config.update("jax_platforms", os.environ["STPU_PLATFORM"])

    if args.fasta:
        per = read_tinydata(args.fasta)
    elif args.download:
        os.makedirs(args.download, exist_ok=True)
        per = {}
        for taxon, accs in ACCESSIONS.items():
            seqs = []
            for acc in accs:
                p = fetch_ncbi(acc, args.download)
                seqs.append(
                    "".join(
                        l.strip() for l in open(p) if not l.startswith(">")
                    )
                )
            per[taxon] = seqs
    else:
        ap.error("give --fasta or --download")

    results = {}
    failures = 0
    for k, expected in VERIFIED.items():
        for taxon, want in expected.items():
            if taxon not in per:
                results[f"k{k}_{taxon}"] = "absent (9606 slice not reproducible)"
                continue
            got = distinct_canonical_kmers(per[taxon], k)
            ok = got == want
            failures += not ok
            results[f"k{k}_{taxon}"] = {"got": got, "want": want, "ok": ok}
            print(f"k={k} taxon={taxon}: got {got:,} want {want:,} "
                  f"{'OK' if ok else 'MISMATCH'}", file=sys.stderr)
    print(json.dumps(results))
    sys.exit(1 if failures else 0)


if __name__ == "__main__":
    main()
