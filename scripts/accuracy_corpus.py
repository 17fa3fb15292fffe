#!/usr/bin/env python
"""Produce the checked-in synthetic accuracy corpus
(metrics/All_metrics_synth.tsv): 1-step vs 2-step vs gold-set, scored at
genus + species rank over three confidence thresholds.

This is the reproducible stand-in for the reference's metrics/All_metrics.tsv
(14,080 CAMI2 experiments; real CAMI2 data is unfetchable here — BASELINE.md).
Re-running this script regenerates the TSV bit-identically (fixed seed).

Usage: python scripts/accuracy_corpus.py [out.tsv]
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")

    from slacken.analysis.experiment import run_experiment

    out = sys.argv[1] if len(sys.argv) > 1 else os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "metrics", "All_metrics_synth.tsv",
    )
    t0 = time.time()
    rows = run_experiment(out_tsv=out)
    print(f"{len(rows)} scored rows -> {out} in {time.time() - t0:.0f}s")
    for r in rows:
        pt, pr = r["per_taxon"], r["per_read"]
        print(
            f"{r['library']:6s} c={r['c']:<4} {r['rank']:7s} "
            f"taxon P={pt.precision:.3f} R={pt.recall:.3f} | "
            f"read ppv={pr.ppv:.3f} sens={pr.sensitivity:.3f}"
        )


if __name__ == "__main__":
    main()
