#!/usr/bin/env python
"""Multi-device scaling benchmark: classify a fixed per-device workload on
1..N devices with the ring-sharded index and report weak-scaling efficiency
(the BASELINE north star asks for >=80% at N>=2).

On a multi-GPU host this measures the ring over the device interconnect;
on a CPU-only host it can still validate the collective path with virtual
CPU devices:

    XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python scripts/scaling_bench.py --cpu --index idx
(virtual devices share the host's cores, so CPU efficiency numbers are not
meaningful — use them only to check the path runs.)
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true", help="force the CPU backend")
    ap.add_argument("--index", required=True, help="saved index directory")
    ap.add_argument("--reads-per-device", type=int, default=8192)
    args = ap.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    devs = jax.devices()
    print(f"devices: {len(devs)} x {devs[0].platform}", file=sys.stderr)

    from slacken.analysis.experiment import background_reads
    from slacken.index import KeyValueIndex
    from slacken.ops import encode
    from slacken.parallel import mesh as pmesh

    idx = KeyValueIndex.load(args.index)
    mp = idx.params.minimizer_params
    table = idx.taxonomy.rpath_table()

    reads = background_reads(np.random.default_rng(0), 10_000, read_len=101)
    codes_all, _ = encode.pack_batch([encode.encode_seq(f.seq) for f in reads], 128)

    base_rate = None
    for n in [1, 2, 4, 8]:
        if n > len(devs):
            break
        rows = args.reads_per_device * n
        reps = int(np.ceil(rows / len(codes_all)))
        codes = np.concatenate([codes_all] * reps)[:rows]
        m = pmesh.make_mesh(n)
        sk, st = pmesh.shard_index_by_range(idx.keys, idx.taxa, n)
        routers, rounds, rbits = pmesh.shard_routers(sk)
        if devs[0].platform == "cpu":
            ring = pmesh.classify_ring_fn(m, mp, 32, rounds, rbits)
            args_dev = (
                codes,
                (sk >> np.uint64(32)).astype(np.uint32),
                sk.astype(np.uint32),
                st,
                routers,
                table,
            )
        else:
            # the GPU config: per-shard tiled tables
            tables, tile = pmesh.shard_tiled_tables(sk, st, routers)
            ring = pmesh.classify_ring_fn(
                m, mp, 32, rounds, rbits, probe=("tiled", tile)
            )
            args_dev = (codes, tables, routers, table)
        out = ring(*args_dev)
        np.asarray(out[5])  # warm up + sync (psum'd report counts)
        t0 = time.time()
        out = ring(*args_dev)
        np.asarray(out[5])
        dt = time.time() - t0
        rate = rows / dt
        if base_rate is None:
            base_rate = rate
        eff = rate / (base_rate * n)
        # per-hop interconnect payload: compacted (hi, lo, acc) x span_query_cap
        # entries vs the uncompacted per-position rotation
        npos = codes.shape[1] * (rows // n)
        from slacken.ops import lookup as lookup_ops

        hop_bytes = 12 * lookup_ops.span_query_cap(npos)
        full_bytes = 12 * npos
        print(
            f"n={n}: {rows} reads in {dt:.3f}s = {rate:.0f} reads/s "
            f"(weak-scaling efficiency {eff * 100:.0f}%); "
            f"ring hop payload {hop_bytes / 1e6:.1f} MB/device "
            f"(uncompacted would be {full_bytes / 1e6:.1f} MB, "
            f"{full_bytes / hop_bytes:.1f}x)"
        )


if __name__ == "__main__":
    main()
