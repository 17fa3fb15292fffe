#!/usr/bin/env python
"""Smoke test of slacken's main path (build -> classify) on one GPU, at a
size its users run.

    python chip_smoke.py [--genome-len N]
    python chip_smoke.py --devices 4 [--genome-len N]

Phases, in order; the first failure ends the run with a non-zero exit:

1. device      JAX must report a GPU (no CPU fallback). Prints the card's
               name and power limit, the JAX version and whether the native
               C++ IO helper built.
2. oracle      A small random library: the index built on the GPU must equal
               the naive oracle (tests/test_index.oracle_index) record for
               record, and GPU classification must equal the oracle
               (tests/test_classify.oracle_classify) line for line, in
               detailed mode at confidence 0.0 and 0.15.
3. main        A 64-species, 32-genus community (siblings share 70% of their
               genome) written as a Kraken-style library, then `build` and
               `classify` through the CLI (slacken.cli.main) on reads sampled
               from it with 1% substitutions plus off-library background.
4. cross-check A CPU-only subprocess (JAX_PLATFORMS=cpu, no visible GPU)
               classifies the first 20,000 reads against the saved index; its
               per-read lines and kreports must equal the GPU's byte for byte.
5. probes      Reports-mode timing of the routed, tiled and hashed1 probes on
               the full index, each at its default batch and at hashed1's,
               and of the minimizer scan alone.

`--devices 4` runs only the multi-device path: build once, classify on one
device and with `--devices 4 --layout replicated|ring`, and require all
three outputs to be byte-identical.

Every value on this path is an integer, so every comparison is exact.
The last line of stdout is one JSON object: {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import gzip
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
THRESHOLDS = ("0.0", "0.15")
GENOME_LEN = 6_000_000  # per species; 64 species = 384 Mbp


def log(msg: str) -> None:
    print(msg, flush=True)


def check_device():
    """Phase 1. Returns the first JAX device; exits non-zero without a GPU."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: no GPU: JAX reports platform {devs[0].platform!r}",
              file=sys.stderr)
        sys.exit(1)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip()
    from slacken import native, utils

    log(f"[device] {smi}")
    log(f"[device] jax {jax.__version__}, {len(devs)} x {devs[0].device_kind}, "
        f"memory limit {utils.device_memory_bytes()} B, "
        f"native helper {'built' if native.available() else 'NOT built'}, "
        f"compile cache {utils.enable_compile_cache()}")
    return devs[0]


def kraken_line(title, classified, taxon, length_string, details) -> str:
    return f"{'C' if classified else 'U'}\t{title}\t{taxon}\t{length_string}\t{details}"


def oracle_phase(seed: int = 0, n_genomes: int = 8, genome_len: int = 50_000,
                 n_reads: int = 2000):
    """Phase 2: GPU (or whatever the backend is) vs the naive oracle.
    Returns (records compared, lines compared); raises on any difference."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from test_classify import oracle_classify
    from test_index import make_genomes, oracle_index
    from test_taxonomy import random_taxonomy

    from slacken.analysis.experiment import _mutate, background_reads
    from slacken.classify import Classifier, ClassifyParams, Fragment
    from slacken.index import IndexParams, KeyValueIndex

    k, m, s = 35, 31, 7
    rng = np.random.default_rng(seed)
    tax = random_taxonomy(rng, 80)
    parents = {i: int(p) for i, p in enumerate(tax.parents)}
    genomes = make_genomes(rng, tax, n_genomes=n_genomes, length=genome_len)
    # a shared segment under another taxon forces LCA merges
    genomes.append((genomes[0][0], genomes[1][1][: genome_len // 4]))
    idx = KeyValueIndex.build(genomes, IndexParams(k=k, m=m, spaces=s), tax)
    want = oracle_index(genomes, k, m, s, parents)
    got = dict(zip(idx.keys.tolist(), idx.taxa.tolist()))
    if got != want:
        diff = sum(got.get(key) != v for key, v in want.items())
        raise AssertionError(
            f"index differs from the oracle: {len(got)} vs {len(want)} records, "
            f"{diff} oracle records missing or different"
        )

    def piece(length):
        g = genomes[int(rng.integers(len(genomes)))][1]
        start = int(rng.integers(0, len(g) - length))
        return _mutate(rng, g[start : start + length], 0.01)

    frags = []
    for i in range(n_reads):
        r = i % 10
        if r < 4:  # single-end
            frags.append(Fragment(f"se{i}", piece(150)))
        elif r < 6:  # paired
            frags.append(Fragment(f"pe{i}", piece(100), piece(100)))
        elif r < 7:  # an N run inside
            seq = list(piece(150))
            at, run = int(rng.integers(0, 140)), int(rng.integers(1, 40))
            seq[at : at + run] = "N" * run
            frags.append(Fragment(f"nrun{i}", "".join(seq)[:150]))
        elif r < 8:  # shorter than k
            frags.append(Fragment(f"short{i}", piece(int(rng.integers(1, k)))))
    frags += background_reads(rng, n_reads - len(frags), prefix="offlib")

    thresholds = [float(t) for t in THRESHOLDS]
    res = Classifier(idx).classify(frags, ClassifyParams(thresholds=thresholds))
    lines = 0
    for conf in thresholds:
        for f, r in zip(frags, res[conf]):
            c, taxon, details, lens = oracle_classify(
                f.seq, f.seq2, want, parents, k, m, s, conf, 2
            )
            expect = kraken_line(f.title, c, taxon, lens, details)
            if r.output_line() != expect:
                raise AssertionError(
                    f"conf {conf} read {f.title}:\n got  {r.output_line()}\n want {expect}"
                )
            lines += 1
    return len(want), lines


def write_library(work: str, tax, genomes) -> tuple:
    """Kraken-style library dir (library/*.fna + seqid2taxid.map) and an NCBI
    taxonomy dir. Returns (library dir, taxonomy dir)."""
    lib = os.path.join(work, "lib")
    os.makedirs(os.path.join(lib, "library"))
    with open(os.path.join(lib, "seqid2taxid.map"), "w") as labels:
        for i, (taxon, seq) in enumerate(genomes):
            with open(os.path.join(lib, "library", f"g{i}.fna"), "w") as f:
                f.write(f">seq{taxon}\n")
                for at in range(0, len(seq), 80):
                    f.write(seq[at : at + 80] + "\n")
            labels.write(f"seq{taxon}\t{taxon}\n")
    taxdir = os.path.join(work, "taxonomy")
    tax.save(taxdir)
    return lib, taxdir


def write_fastq(path: str, frags) -> None:
    with open(path, "w") as f:
        for fr in frags:
            f.write(f"@{fr.title}\n{fr.seq}\n+\n{'I' * len(fr.seq)}\n")


def read_outputs(out: str) -> dict:
    """{relative path: bytes} of every file a classify run wrote, gz inflated."""
    base = os.path.dirname(out)
    got = {}
    for root, _, files in os.walk(base):
        for fn in files:
            p = os.path.join(root, fn)
            with open(p, "rb") as f:
                data = f.read()
            if fn.endswith(".gz"):
                data = gzip.decompress(data)
            got[os.path.relpath(p, base)] = data
    return got


def classify_cli(idx_dir: str, fastq: str, out: str, extra=()) -> float:
    from slacken import cli

    t0 = time.time()
    rc = cli.main(["classify", "-i", idx_dir, fastq, "-o", out, "-c", *THRESHOLDS,
                   *extra])
    if rc != 0:
        raise RuntimeError(f"classify {list(extra)} exited {rc}")
    return time.time() - t0


def make_workload(work: str, genome_len: int, n_reads: int, n_background: int):
    """Library + reads of the main phase. Returns (lib, taxdir, fastq, frags,
    library bases)."""
    from slacken.analysis.experiment import background_reads, build_community, sample_reads

    t0 = time.time()
    rng = np.random.default_rng(0)
    tax, genomes = build_community(rng, n_genera=32, genome_len=genome_len)
    lib, taxdir = write_library(work, tax, genomes)
    present = [t for t, _ in genomes]
    frags, _ = sample_reads(rng, genomes, present, n_reads, read_len=150,
                            mutation_rate=0.01)
    frags += background_reads(rng, n_background, read_len=150)
    frags = [frags[i] for i in rng.permutation(len(frags))]  # mix the two kinds
    fastq = os.path.join(work, "reads.fastq")
    write_fastq(fastq, frags)
    total_bp = sum(len(g) for _, g in genomes)
    log(f"[main] library {len(genomes)} genomes, {total_bp} bp; {len(frags)} reads "
        f"({n_reads} sampled, {n_background} background); made in {time.time() - t0:.1f} s")
    return lib, taxdir, fastq, frags, total_bp


def build_cli(idx_dir: str, lib: str, taxdir: str) -> float:
    from slacken import cli

    t0 = time.time()
    if cli.main(["build", "-i", idx_dir, "-l", lib, "-t", taxdir]) != 0:
        raise RuntimeError("build failed")
    return time.time() - t0


def classified_count(out: str) -> int:
    """Reads under root in the kreport of the first threshold."""
    from slacken.classify import format_threshold

    thresholds = [float(t) for t in THRESHOLDS]
    loc = out + "_c" + format_threshold(thresholds[0], thresholds)
    with open(os.path.join(loc, "all_kreport.txt")) as f:
        rows = [line.split("\t") for line in f]
    return sum(int(r[1]) for r in rows[1:] if r[4] == "1")  # clade count of root


def main_phase(work: str, genome_len: int, n_reads: int = 200_000,
               n_background: int = 50_000):
    """Phases 3-5."""
    from slacken.index import KeyValueIndex

    lib, taxdir, fastq, frags, total_bp = make_workload(
        work, genome_len, n_reads, n_background
    )
    idx_dir = os.path.join(work, "idx")
    os.environ["STPU_BUILD_TRACE"] = "1"
    build_s = build_cli(idx_dir, lib, taxdir)
    del os.environ["STPU_BUILD_TRACE"]
    with open(os.path.join(idx_dir, "params.json")) as f:
        records = json.load(f)["num_records"]
    log(f"[main] build: {records} records from {total_bp} bp in {build_s:.2f} s "
        f"= {total_bp / build_s / 1e6:.2f} Mbp/s (cli wall, compiles included)")

    out = os.path.join(work, "gpu_all", "out")
    cls_s = classify_cli(idx_dir, fastq, out)
    log(f"[main] classify: {len(frags)} reads in {cls_s:.2f} s = "
        f"{len(frags) / cls_s:.0f} reads/s (cli wall: index load, table build "
        f"and compiles included); classified at c=0.0: {classified_count(out)}")

    # phase 4: the same 20k reads on the GPU and in a CPU-only subprocess
    n_cross = min(20_000, len(frags))
    small = os.path.join(work, "reads20k.fastq")
    write_fastq(small, frags[:n_cross])
    gpu_out = os.path.join(work, "gpu_20k", "out")
    classify_cli(idx_dir, small, gpu_out)
    cpu_out = os.path.join(work, "cpu_20k", "out")
    env = dict(os.environ, JAX_PLATFORMS="cpu", CUDA_VISIBLE_DEVICES="")
    t0 = time.time()
    subprocess.run(
        [sys.executable, "-m", "slacken.cli", "classify", "-i", idx_dir, small,
         "-o", cpu_out, "-c", *THRESHOLDS],
        cwd=ROOT, env=env, check=True, stdout=subprocess.DEVNULL,
    )
    gpu, cpu = read_outputs(gpu_out), read_outputs(cpu_out)
    if gpu.keys() != cpu.keys() or any(gpu[k] != cpu[k] for k in gpu):
        bad = sorted(k for k in gpu.keys() | cpu.keys() if gpu.get(k) != cpu.get(k))
        raise AssertionError(f"CPU and GPU outputs differ: {bad}")
    full = read_outputs(out)
    for name, data in gpu.items():
        if "kreport" in name:
            continue
        subset = set(data.splitlines())
        if not subset <= set(full[name].splitlines()):
            raise AssertionError(f"20k-read lines differ from the full run: {name}")
    n_lines = sum(len(v.splitlines()) for k, v in gpu.items() if "kreport" not in k)
    log(f"[cross-check] {n_cross} reads: {len(gpu)} files byte-identical on CPU and "
        f"GPU ({n_lines} per-read lines over {len(THRESHOLDS)} thresholds); CPU run "
        f"{time.time() - t0:.1f} s")

    probe_phase(KeyValueIndex.load(idx_dir), fastq, len(frags), work)


def probe_phase(idx, fastq: str, n_reads: int, work: str):
    """Phase 5: reports-mode timing per probe over the reads 4x, first pass
    (compiles) apart from three steady passes, each probe at its default
    batch and, where that differs, at hashed1's batch too; then the
    minimizer scan alone."""
    import jax

    from slacken.classify import Classifier, ClassifyParams
    from slacken.inputs import packed_reads_from_file
    from slacken.ops.minimizers import window_minimizers

    packed = list(packed_reads_from_file(fastq)) * 4
    n_reads *= 4
    cpar = ClassifyParams(thresholds=[0.0], per_read_output=False)

    def time_probe(probe: str, batch_bp=None) -> int:
        t0 = time.time()
        cls = Classifier(idx, probe=probe, target_batch_bp=batch_bp)
        table_bytes = sum(a.nbytes for a in jax.tree.leaves((cls._dev_keys, cls._dev_taxa)))
        setup_s = time.time() - t0
        outdir = os.path.join(work, f"probe_{probe}_{cls.target_batch_bp}")
        t0 = time.time()
        cls.classify_and_write_packed(packed, outdir + "/first", cpar)
        first_s = time.time() - t0
        steady = []
        for trial in range(3):
            t0 = time.time()
            cls.classify_and_write_packed(packed, outdir + f"/t{trial}", cpar)
            steady.append(time.time() - t0)
        log(f"[probe] {probe}: {n_reads / float(np.median(steady)):.0f} reads/s steady "
            f"(median; passes of {n_reads} reads took {[round(x, 3) for x in steady]} s), first pass {first_s:.2f} s, table "
            f"{table_bytes} B built in {setup_s:.2f} s, batch {cls.target_batch_bp} bp")
        return cls.target_batch_bp

    hashed1_bp = time_probe("hashed1")
    for probe in ("routed", "tiled"):
        if time_probe(probe) != hashed1_bp:
            time_probe(probe, hashed1_bp)  # the probe alone, at equal batch
    codes = np.random.default_rng(1).integers(0, 4, (8192, 128)).astype(np.uint8)
    params = idx.params.minimizer_params
    t0 = time.time()
    jax.block_until_ready(window_minimizers(codes, params))
    first = time.time() - t0
    dev = jax.device_put(codes)
    times = []
    for _ in range(20):
        t0 = time.time()
        jax.block_until_ready(window_minimizers(dev, params))
        times.append(time.time() - t0)
    log(f"[probe] scan: window_minimizers [8192, 128] k=35 m=31 s=7: "
        f"{1e3 * float(np.median(times)):.3f} ms median of 20 (first call {first:.2f} s)")


def mesh_phase(work: str, genome_len: int, n: int, n_reads: int = 200_000,
               n_background: int = 50_000):
    """--devices N: single device vs replicated vs ring, byte for byte."""
    import jax

    from slacken.index import KeyValueIndex
    from slacken.parallel.classifier import MeshClassifier

    if len(jax.devices()) < n:
        raise RuntimeError(f"--devices {n}: JAX sees {len(jax.devices())} devices")
    lib, taxdir, fastq, frags, total_bp = make_workload(
        work, genome_len, n_reads, n_background
    )
    idx_dir = os.path.join(work, "idx")
    build_s = build_cli(idx_dir, lib, taxdir)
    log(f"[mesh] build {total_bp} bp in {build_s:.2f} s")
    runs = {}
    for name, extra in (("single", ()),
                        ("replicated", ("--devices", str(n), "--layout", "replicated")),
                        ("ring", ("--devices", str(n), "--layout", "ring"))):
        out = os.path.join(work, name, "out")
        wall = classify_cli(idx_dir, fastq, out, extra)
        runs[name] = read_outputs(out)
        log(f"[mesh] {name}: {len(frags)} reads in {wall:.2f} s (cli wall), "
            f"{len(runs[name])} files")
    for name in ("replicated", "ring"):
        if runs[name] != runs["single"]:
            bad = sorted(k for k in runs["single"] if runs[name].get(k) != runs["single"][k])
            raise AssertionError(f"{name} differs from the single-device run: {bad}")
    ring = MeshClassifier(KeyValueIndex.load(idx_dir), n, "ring")
    placed = {}
    for a in ring._mesh_args[:-1]:
        for shard in a.addressable_shards:
            placed.setdefault(shard.device.id, []).append(shard.data.shape)
    if len(placed) != n:
        raise AssertionError(f"ring shards sit on devices {sorted(placed)}, not {n}")
    log(f"[mesh] replicated and ring outputs byte-identical to the single device; "
        f"ring shard shapes per device: {placed}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--genome-len", type=int, default=GENOME_LEN,
                    help=f"bases per species genome (64 species; default {GENOME_LEN})")
    ap.add_argument("--devices", type=int, default=1,
                    help="run only the multi-device comparison over this many GPUs")
    args = ap.parse_args()

    dev = check_device()
    if args.genome_len != GENOME_LEN:
        log(f"[cut] library cut to 64 x {args.genome_len} bp by --genome-len "
            f"(full size 64 x {GENOME_LEN} bp)")
    work = tempfile.mkdtemp(prefix="slacken_smoke_")
    try:
        if args.devices > 1:
            mesh_phase(work, args.genome_len, args.devices)
        else:
            t0 = time.time()
            records, lines = oracle_phase()
            log(f"[oracle] index equal to the oracle: {records} records; "
                f"classification equal: {lines} lines (detailed, c={' '.join(THRESHOLDS)}); "
                f"{time.time() - t0:.1f} s")
            main_phase(work, args.genome_len)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    import jax

    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": len(jax.devices()),
    }}))


if __name__ == "__main__":
    main()
