#!/usr/bin/env python
"""Scale demonstration (VERDICT r2 #4): build + classify at >=100M records.

Builds an index from a large deterministic synthetic library (default
400 Mbp -> ~130M records at k=35 m=31 s=7; --gbp scales it), exercising the
production big-build machinery end-to-end:

  * SpillCollector (--spill): range-partitioned on-disk spill past RAM
  * save_sharded / load_shards with hundreds of shards
  * classify of a simulated+real read mix against the big index

Prints one JSON dict with measured throughputs and sizes; used to fill the
scale section of PERF.md. Reference bar: 2,000-30,000 buckets and a
1.8 TB library (reference README.md:508,517) — one host with one GPU is a
single executor's worth of that cluster.

Usage: python scripts/scale_bench.py [--gbp 0.4] [--spill] [--shards 256]
       [--platform cpu] [--reads 200000] [--out scale.json]
"""

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def synthetic_library(total_bp: int, n_taxa: int, seed=20260818):
    """Deterministic genomes: n_taxa species under one root, sizes Zipf-ish
    (a few large genomes + a tail), totalling total_bp."""
    rng = np.random.default_rng(seed)
    w = 1.0 / np.arange(1, n_taxa + 1)
    sizes = np.maximum((total_bp * w / w.sum()).astype(np.int64), 50_000)
    lut = np.frombuffer(b"ACGT", dtype=np.uint8)
    for i, n in enumerate(sizes):
        taxon = 10 + i
        codes = rng.integers(0, 4, int(n), dtype=np.int64).astype(np.uint8)
        yield taxon, lut[codes].tobytes().decode("ascii")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--gbp", type=float, default=0.4, help="library size in Gbp")
    ap.add_argument("--taxa", type=int, default=64)
    ap.add_argument("--spill", action="store_true", help="use SpillCollector")
    ap.add_argument("--shards", type=int, default=256)
    ap.add_argument("--reads", type=int, default=200_000)
    ap.add_argument("--platform", default=os.environ.get("STPU_PLATFORM"))
    ap.add_argument("--probe", default=None)
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--keep", action="store_true")
    args = ap.parse_args()

    import jax

    if args.platform:
        jax.config.update("jax_platforms", args.platform)

    from slacken.classify import Classifier, ClassifyParams
    from slacken.index import IndexParams, KeyValueIndex
    from slacken.taxonomy import Taxonomy
    from slacken import native

    total_bp = int(args.gbp * 1e9)
    nodes = [(1, 1, "root")] + [
        (10 + i, 1, "species") for i in range(args.taxa)
    ]
    tax = Taxonomy.from_nodes_and_names(
        nodes, [(t, f"taxon{t}") for t, _, _ in nodes]
    )

    work = args.workdir or tempfile.mkdtemp(prefix="stpu_scale_")
    os.makedirs(work, exist_ok=True)
    res = {"total_bp": total_bp, "taxa": args.taxa, "spill": bool(args.spill),
           "device": str(jax.devices()[0])}
    print(f"[scale] building {total_bp/1e9:.2f} Gbp over {args.taxa} taxa "
          f"on {res['device']} (spill={args.spill})", file=sys.stderr)

    t0 = time.time()
    idx = KeyValueIndex.build(
        synthetic_library(total_bp, args.taxa),
        IndexParams(k=35, m=31, spaces=7, buckets=args.shards),
        tax,
        spill_dir=os.path.join(work, "spill") if args.spill else None,
    )
    res["build_s"] = round(time.time() - t0, 1)
    res["records"] = int(len(idx.keys))
    res["build_mbp_per_sec"] = round(total_bp / res["build_s"] / 1e6, 2)
    res["index_bytes_flat"] = int(len(idx.keys) * 12)
    print(f"[scale] {res['records']:,} records in {res['build_s']}s "
          f"({res['build_mbp_per_sec']} Mbp/s)", file=sys.stderr)

    # sharded persistence (hundreds of shards, reference bucket guidance)
    loc = os.path.join(work, "idx_sharded")
    t0 = time.time()
    idx.save_sharded(loc, n_shards=args.shards)
    res["save_sharded_s"] = round(time.time() - t0, 1)
    t0 = time.time()
    idx2 = KeyValueIndex.load_shards(loc)
    res["load_shards_s"] = round(time.time() - t0, 1)
    assert np.array_equal(idx2.keys, idx.keys)
    del idx2

    # classify: simulated reads from the library + the real 10k Illumina set
    rng = np.random.default_rng(7)
    sim = []
    lib_iter = synthetic_library(total_bp, args.taxa)
    n_src = min(args.taxa, 8)
    per = args.reads // n_src
    for j, (taxon, seq) in enumerate(lib_iter):
        if j >= n_src:
            break
        from slacken.ops import encode as enc

        codes_full = enc.encode_seq(seq[: 2_000_000])
        starts = rng.integers(0, len(codes_full) - 101, per)
        rows = codes_full[starts[:, None] + np.arange(101)[None, :]].astype(np.uint8)
        mut = rng.random(rows.shape) < 0.01
        rows[mut] = rng.integers(0, 4, int(mut.sum()))
        rows = np.pad(rows, ((0, 0), (0, 27)), constant_values=4)
        sim.append(native.PackedReads(
            rows, np.full(len(rows), 101, np.int32),
            [f"sim{taxon}_{i}" for i in range(len(rows))],
        ))
    n_reads = sum(len(p) for p in sim)

    cls = Classifier(idx, probe=args.probe)
    cpar = ClassifyParams(thresholds=[0.0], per_read_output=False)
    outdir = os.path.join(work, "cls_out")
    cls.classify_and_write_packed(sim[:1], outdir + "/warm", cpar)
    t0 = time.time()
    cls.classify_and_write_packed(sim, outdir + "/run", cpar)
    dt = time.time() - t0
    res["classify_reads"] = int(n_reads)
    res["classify_reads_per_sec"] = round(n_reads / dt, 1)
    report = open(outdir + "/run_c0.0/all_kreport.txt").read().splitlines()
    uncl = next((int(l.split("\t")[1]) for l in report if l.endswith("unclassified")), 0)
    res["classified_fraction"] = round(1 - uncl / n_reads, 4)
    print(f"[scale] classify {n_reads:,} reads: "
          f"{res['classify_reads_per_sec']:,} reads/s, "
          f"{res['classified_fraction']*100:.1f}% classified", file=sys.stderr)

    if not args.keep and args.workdir is None:
        shutil.rmtree(work, ignore_errors=True)
    print(json.dumps(res))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=2)


if __name__ == "__main__":
    main()
