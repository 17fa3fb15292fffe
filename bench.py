#!/usr/bin/env python
"""Benchmark: classify reads against a mini-library on one GPU and build
that library's index. Prints ONE JSON line.

The reference's bundled tiny library (slacken_tinydata.fna: taxa 455631,
526997, 9606; ~8 Mbp) is not shipped, so a deterministic synthetic library
of the same scale and taxon structure stands in. Reads: 10k sampled from
the library with 1% substitutions plus 10k off-library background reads
(analysis/experiment.background_reads), 4x replicated; k=35 m=31 s=7,
reports mode.

Runs in one process on the GPU, or exits non-zero: there is no CPU
fallback. vs_baseline compares against 15,000 reads/s, a Kraken 2-class
single-CPU-core estimate for 100 bp reads (the reference publishes no
absolute throughput; README.md:563-565 defers to the NAR paper).
"""

import json
import shutil
import sys
import tempfile
import time

import numpy as np

BASELINE_READS_PER_SEC = 15000.0
LIBRARY = {455631: 4_100_000, 526997: 3_100_000, 9606: 800_000}


def synthetic_library(rng):
    lut = np.frombuffer(b"ACGT", dtype=np.uint8)
    for taxon, n in LIBRARY.items():
        yield taxon, lut[rng.integers(0, 4, n)].tobytes().decode("ascii")


def load_reads():
    """10k library reads (1% substitutions) + 10k background, as packed
    batches, 4x replicated for steady state."""
    from slacken import native
    from slacken.analysis.experiment import background_reads
    from slacken.ops import encode

    rng = np.random.default_rng(7)
    packs = []
    for taxon, seq in synthetic_library(np.random.default_rng(20260816)):
        codes = encode.encode_seq(seq)
        starts = rng.integers(0, len(codes) - 101, 3334)
        rows = codes[starts[:, None] + np.arange(101)[None, :]].astype(np.uint8)
        mut = rng.random(rows.shape) < 0.01
        rows[mut] = rng.integers(0, 4, mut.sum())
        packs.append(native.PackedReads(
            np.pad(rows, ((0, 0), (0, 27)), constant_values=4),
            np.full(len(rows), 101, np.int32),
            [f"sim{taxon}_{j}" for j in range(len(rows))],
        ))
    bg = background_reads(rng, 10_000, read_len=101)
    codes, _ = encode.pack_batch([encode.encode_seq(f.seq) for f in bg], 128)
    packs.append(native.PackedReads(
        codes, np.array([len(f.seq) for f in bg], np.int32), [f.title for f in bg]
    ))
    return packs * 4


def build(tax):
    from slacken.index import IndexParams, KeyValueIndex

    return KeyValueIndex.build(
        synthetic_library(np.random.default_rng(20260816)),
        IndexParams(k=35, m=31, spaces=7), tax, batch_rows=32, row_len=1 << 16,
    )


def main():
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench: no GPU: JAX reports platform {dev.platform!r}", file=sys.stderr)
        sys.exit(1)

    from slacken.classify import Classifier, ClassifyParams
    from slacken.taxonomy import Taxonomy
    from slacken.utils import enable_compile_cache

    enable_compile_cache()
    nodes = [(1, 1, "root")] + [(t, 1, "species") for t in LIBRARY]
    tax = Taxonomy.from_nodes_and_names(nodes, [(t, f"taxon{t}") for t, _, _ in nodes])
    build(tax)  # warm: the timed build below compiles nothing
    t0 = time.time()
    idx = build(tax)
    build_dt = time.time() - t0
    build_bp = sum(LIBRARY.values())
    print(f"build: {idx.num_records} records from {build_bp} bp in {build_dt:.2f} s",
          file=sys.stderr)

    packed = load_reads()
    n_reads = sum(len(p) for p in packed)
    cpar = ClassifyParams(thresholds=[0.0], per_read_output=False)
    cls = Classifier(idx)
    outdir = tempfile.mkdtemp(prefix="slacken_bench_")
    best = 0.0
    try:
        cls.classify_and_write_packed(packed, outdir + "/warm", cpar)
        for trial in range(3):
            t0 = time.time()
            cls.classify_and_write_packed(packed, outdir + f"/t{trial}", cpar)
            dt = time.time() - t0
            best = max(best, n_reads / dt)
            print(f"trial {trial}: {dt:.3f} s = {n_reads / dt:.0f} reads/s", file=sys.stderr)
    finally:
        shutil.rmtree(outdir, ignore_errors=True)

    print(json.dumps({
        "metric": "classify_reads_per_sec_per_chip",
        "value": round(best, 1),
        "unit": "reads/s",
        "vs_baseline": round(best / BASELINE_READS_PER_SEC, 3),
        "build_mbp_per_sec": round(build_bp / build_dt / 1e6, 2),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }))


if __name__ == "__main__":
    main()
