"""Multi-chip distribution over a jax.sharding.Mesh.

Replaces the reference's Spark shuffle/broadcast backend (SURVEY §2
parallelism table; KeyValueIndex.scala:188-217 hash-shuffle join) with two
device layouts:

  * **replicated**: the index fits in every device's memory; reads are sharded
    over the 'data' axis and each chip probes its own reads against the full
    index. The only collective is a psum when aggregating report counts.
    (Analogue of Spark broadcast of a small table.)

  * **ring-sharded**: the sorted key array is RANGE-sharded over the mesh;
    each chip holds 1/n of the index. Queries stay sharded by read and
    rotate around the ring via ppermute (one hop per step over the
    device interconnect);
    each chip probes the visiting queries against its local shard and the
    accumulated answers arrive back at the owner after a full rotation.
    Because the global key array is sorted and unique, exactly one shard can
    answer each query, so the combiner is a plain max. (This is the
    hash-shuffle join's device equivalent, with all-to-all replaced by a
    bandwidth-optimal ring.)
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..ops import lookup as lookup_ops
from ..ops import u128 as u128_mod
from ..ops import u64
from ..ops.minimizers import MinimizerParams, window_minimizers
from ..ops.resolve import INVALID_WINDOW, compact_hits, resolve_hits


def make_mesh(
    n_devices: Optional[int] = None,
    axis: str = "data",
    platform: Optional[str] = None,
) -> Mesh:
    """1-D device mesh over the default backend (or an explicit `platform`,
    e.g. "cpu" for the virtual-device dryrun while the default backend is
    an accelerator).
    Asking for more devices than the platform has is a loud error: silently
    folding to fewer devices would make every `n`-derived shard shape wrong.
    """
    devs = jax.devices(platform) if platform else jax.devices()
    if n_devices is not None:
        if len(devs) < n_devices:
            raise ValueError(
                f"requested a {n_devices}-device mesh but platform "
                f"{platform or devs[0].platform!r} has {len(devs)}"
            )
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis,))


def shard_index_by_range(keys: np.ndarray, taxa: np.ndarray, n: int):
    """Pad and split the sorted key array into n equal contiguous ranges.

    Padding uses the all-ones key (greater than any real 62-bit priority), so
    padded slots never match a query.
    """
    pad = (-len(keys)) % n
    keys_p = np.concatenate([keys, np.full(pad, np.uint64(0xFFFFFFFFFFFFFFFF))])
    taxa_p = np.concatenate([taxa, np.zeros(pad, np.int32)])
    return keys_p.reshape(n, -1), taxa_p.reshape(n, -1)


def shard_routers(sharded_keys: np.ndarray, key_bits: int = 62):
    """Per-shard prefix routers + worst-case rounds + bits (adaptive to the
    per-shard key count). key_bits = the key-space width (2m): prefixes are
    taken from the top of that range, so it must match the probe's."""
    bits = min(lookup_ops.adaptive_router_bits(sharded_keys.shape[1]), key_bits)
    routers = np.stack(
        [lookup_ops.build_router(k, bits, key_bits) for k in sharded_keys]
    )
    rounds = max(lookup_ops.router_rounds(r) for r in routers)
    return routers, rounds, bits


def shard_index_by_range_wide(
    keys2: np.ndarray, taxa: np.ndarray, n: int, key_bits: int
):
    """shard_index_by_range for wide ([N, 2] uint64) keys.

    Padding uses the LARGEST key-space value (all-ones within key_bits = 2m),
    which keeps the shards sorted and the router build in range. Unlike the
    narrow case a real query CAN equal this value, but the pad rows carry
    taxon 0 and the ring combiner is max, so a pad match is exactly a miss —
    and a genuine record with that key (if any) still wins the max."""
    pad = (-len(keys2)) % n
    hi_pad = np.uint64((1 << (key_bits - 64)) - 1)
    # the sentinel is a LEGAL wide key (unlike the narrow 2^64-1 > 62-bit
    # case); the hashed-table builds mask sentinel rows out, so a real
    # record carrying it would be silently dropped there. keys2 is sorted,
    # so the max value can only sit in the last row: refuse it loudly.
    if len(keys2) and keys2[-1, 0] == hi_pad and keys2[-1, 1] == np.uint64(
        0xFFFFFFFFFFFFFFFF
    ):
        raise ValueError(
            "index contains the maximum wide key (== the shard pad "
            "sentinel); this 2^-128-probability key cannot be represented "
            "in sharded layouts"
        )
    pad_rows = np.empty((pad, 2), np.uint64)
    pad_rows[:, 0] = hi_pad
    pad_rows[:, 1] = np.uint64(0xFFFFFFFFFFFFFFFF)
    keys_p = np.concatenate([keys2, pad_rows])
    taxa_p = np.concatenate([taxa, np.zeros(pad, np.int32)])
    return keys_p.reshape(n, -1, 2), taxa_p.reshape(n, -1)


def shard_routers_wide(sharded_keys2: np.ndarray, key_bits: int):
    """Per-shard wide-key prefix routers + worst-case rounds + bits."""
    bits = min(
        lookup_ops.adaptive_router_bits(sharded_keys2.shape[1]), key_bits
    )
    routers = np.stack(
        [lookup_ops.build_router_wide(k, bits, key_bits) for k in sharded_keys2]
    )
    rounds = max(lookup_ops.router_rounds(r) for r in routers)
    return routers, rounds, bits


def shard_tiled_tables_wide(
    sharded_keys2: np.ndarray, sharded_taxa: np.ndarray, routers: np.ndarray
):
    """Per-shard wide tiled row-gather tables ([n, rows, tile, 5]) with a
    UNIFORM tile (cf. shard_tiled_tables)."""
    tile = 16
    for r in routers:
        tile = max(tile, lookup_ops.tile_for_span(lookup_ops.max_bucket_span(r)))
    tables = [
        lookup_ops.build_tiled_wide(k, t, r, tile=tile)[0]
        for k, t, r in zip(sharded_keys2, sharded_taxa, routers)
    ]
    return np.stack(tables), tile


def _window_scan(codes, mp, lut=None):
    """lut: optional device rank table for explicit orderings — closed over
    by the mesh fns (a replicated constant), matching the single-chip
    kernels' device_lut argument."""
    return window_minimizers(codes, mp, lut)


def _postprocess(wm, looked, rpath_table, max_taxa):
    from ..classify import _host_bundle

    window_taxa = jnp.where(wm.valid, looked, INVALID_WINDOW).astype(jnp.int32)
    num_distinct = jnp.sum(
        wm.span_start & wm.distinct & (looked > 0) & wm.valid, axis=-1
    ).astype(jnp.int32)
    ch = compact_hits(window_taxa, max_taxa)
    res = resolve_hits(ch.taxa, ch.counts, rpath_table)
    return window_taxa, num_distinct, ch, res, _host_bundle(num_distinct, ch, res)


def classify_replicated_fn(
    mesh: Mesh,
    mp: MinimizerParams,
    max_taxa: int,
    rounds: int = 32,
    bits: int = lookup_ops.ROUTER_BITS,
    probe: tuple = ("routed",),
    key_bits: int = 62,
    lut=None,
):
    """Data-parallel classification with a fully replicated index.

    Returns a jitted fn with codes sharded over 'data' and everything else
    replicated; the per-taxon report count vector is psum-reduced across the
    mesh. The signature matches the probe layout:

      probe ("routed",):           fn(codes[B,L], keys_hi[N], keys_lo[N],
                                      key_taxa[N], router[R], rpath_table)
      probe ("tiled", tile, ...):  fn(codes, table[rows,tile,3], router,
                                      rpath_table)
      probe ("hashed", tile, hash bits, ...): fn(codes, table[slots,3],
                                      router(ignored dummy), rpath_table)

    The tiled/hashed single-chip fast probes carry over unchanged — every
    chip probes its read shard against the replicated table, so the mesh
    kernel is exactly the single-chip kernel plus one psum.
    """

    def finish(wm, looked, rpath_table):
        window_taxa, num_distinct, ch, res, hostpack = _postprocess(
            wm, looked, rpath_table, max_taxa
        )
        # per-taxon counts of winning taxa (report aggregation): psum over mesh
        counts = jnp.zeros(rpath_table.shape[0], jnp.int32).at[res.max_taxon].add(1)
        counts = jax.lax.psum(counts, "data")
        return window_taxa, num_distinct, ch, res, hostpack, counts

    if probe[0] == "tiled_wide":

        def local_fn(codes, table, router, rpath_table):
            wm = _window_scan(codes, mp, lut)
            looked = lookup_ops.lookup_taxa_tiled_wide(
                table, router, wm.minimizer, probe[1], bits, key_bits
            )
            return finish(wm, looked, rpath_table)

        in_specs = (P("data"), P(), P(), P())
    elif probe[0] == "routed_wide":

        def local_fn(codes, k3, k2, k1, k0, key_taxa, router, rpath_table):
            wm = _window_scan(codes, mp, lut)
            keys = u128_mod.U128(u64.U64(k3, k2), u64.U64(k1, k0))
            looked = lookup_ops.lookup_taxa_routed_wide(
                keys, key_taxa, router, wm.minimizer, rounds, bits, key_bits
            )
            return finish(wm, looked, rpath_table)

        in_specs = (P("data"), P(), P(), P(), P(), P(), P(), P())
    elif probe[0] == "hashed1_wide":

        def local_fn(codes, table, router, rpath_table):
            wm = _window_scan(codes, mp, lut)
            looked = lookup_ops.lookup_taxa_hashed_rows_wide(
                table, wm.minimizer, probe[1], probe[2], key_bits
            )
            return finish(wm, looked, rpath_table)

        in_specs = (P("data"), P(), P(), P())
    elif probe[0] in ("tiled", "hashed", "hashed1"):

        def local_fn(codes, table, router, rpath_table):
            wm = _window_scan(codes, mp, lut)
            if probe[0] == "hashed":
                looked = lookup_ops.lookup_taxa_hashed(
                    table, wm.minimizer, probe[1], probe[2]
                )
            elif probe[0] == "hashed1":
                looked = lookup_ops.lookup_taxa_hashed_rows(
                    table, wm.minimizer, probe[1], probe[2]
                )
            else:
                looked = lookup_ops.lookup_taxa_tiled(
                    table, router, wm.minimizer, probe[1], bits, key_bits
                )
            return finish(wm, looked, rpath_table)

        in_specs = (P("data"), P(), P(), P())
    else:

        def local_fn(codes, keys_hi, keys_lo, key_taxa, router, rpath_table):
            wm = _window_scan(codes, mp, lut)
            looked = lookup_ops.lookup_taxa_routed(
                u64.U64(keys_hi, keys_lo), key_taxa, router, wm.minimizer,
                rounds, bits, key_bits,
            )
            return finish(wm, looked, rpath_table)

        in_specs = (P("data"), P(), P(), P(), P(), P())

    shard = jax.shard_map(
        local_fn,
        mesh=mesh,
        in_specs=in_specs,
        out_specs=(P("data"), P("data"), P("data"), P("data"), P("data"), P()),
        check_vma=False,
    )
    return jax.jit(shard)


def shard_tiled_tables(sharded_keys: np.ndarray, sharded_taxa: np.ndarray,
                       routers: np.ndarray):
    """Per-shard tiled row-gather tables with a UNIFORM tile so they stack
    into one [n, rows, tile, 3] array shardable over 'data'. Shards are
    equal-length (shard_index_by_range pads), so row counts match too."""
    tile = 16
    for r in routers:
        tile = max(tile, lookup_ops.tile_for_span(lookup_ops.max_bucket_span(r)))
    tables = [
        lookup_ops.build_tiled(k, t, r, tile=tile)[0]
        for k, t, r in zip(sharded_keys, sharded_taxa, routers)
    ]
    return np.stack(tables), tile


def ring_lookup(codes, probe_fn, wm, n: int):
    """The ring-rotated index lookup: span-compact the queries, rotate them
    around the n-device ring with ppermute (probing each local shard in
    turn), and scatter the answers back to window positions. Returns the
    per-window looked-up taxa [B, L]. Must run inside a shard_map over the
    'data' axis; `probe_fn(*limbs)` probes the LOCAL index shard — 2 u32
    limb buffers for m <= 31, 4 for wide minimizers.

    Shared by the classify and span-hit ring kernels, so classify2's step-1
    counting rides the exact same collective schedule as classification."""
    b, l = codes.shape
    npos = b * l
    cap = lookup_ops.span_query_cap(npos)
    if isinstance(wm.minimizer, u64.U64):
        cq_hi, cq_lo, sid, n_spans = lookup_ops.compact_span_queries(wm, cap)
        cqs = (cq_hi, cq_lo)
        full_qs = (wm.minimizer.hi.reshape(npos), wm.minimizer.lo.reshape(npos))
    else:
        cqs, sid, n_spans = lookup_ops.compact_span_queries_wide(wm, cap)
        full_qs = tuple(x.reshape(npos) for x in wm.minimizer.limbs)
    overflow_any = jax.lax.psum((n_spans > cap).astype(jnp.int32), "data") > 0

    perm = [(i, (i + 1) % n) for i in range(n)]

    def ring(qs):
        acc = probe_fn(*qs)

        def step(carry, _):
            qs, acc = carry
            qs = tuple(jax.lax.ppermute(x, "data", perm) for x in qs)
            acc = jax.lax.ppermute(acc, "data", perm)
            acc = jnp.maximum(acc, probe_fn(*qs))
            return (qs, acc), None

        (qs, acc), _ = jax.lax.scan(step, (qs, acc), None, length=n - 1)
        # one final hop brings answers back to their owner
        if n > 1:
            acc = jax.lax.ppermute(acc, "data", perm)
        return acc

    def compacted(_):
        return ring(cqs)[jnp.clip(sid, 0, cap - 1)].reshape(b, l)

    def full(_):
        return ring(full_qs).reshape(b, l)

    return jax.lax.cond(overflow_any, full, compacted, operand=None)


def shard_hashed_tables(sharded_keys: np.ndarray, sharded_taxa: np.ndarray):
    """Per-shard hashed probe tables with UNIFORM (bits, tile, slot count) so
    they stack into one [n, slots, 3] array shardable over 'data'.

    Hash-table geometry must agree across shards because the probe kernel is
    SPMD: bits = the largest shard's auto choice, tile = the largest tile any
    shard needs at those bits, and every table is sentinel-padded to the
    largest row count (clamped row gathers land on sentinel rows —
    a correct miss, see lookup_taxa_hashed). The all-ones range-pad
    keys from shard_index_by_range are stripped first so they cannot inflate
    displacement (real keys are <= 62 bits, never all-ones)."""
    pad_key = np.uint64(0xFFFFFFFFFFFFFFFF)
    reals = [k != pad_key for k in sharded_keys]
    bits = max(
        lookup_ops.adaptive_router_bits(int(r.sum()), max_bits=30) for r in reals
    )
    built = [
        lookup_ops.build_hashed(k[r], t[r], bits=bits)
        for k, t, r in zip(sharded_keys, sharded_taxa, reals)
    ]
    tile = max(b[1] for b in built)
    if any(b[1] != tile for b in built):
        # a shard needed a bigger tile: rebuild the rest at the same tile
        # (placement depends only on bits, so this is just re-padding)
        built = [
            lookup_ops.build_hashed(k[r], t[r], bits=bits, tile=tile)
            for k, t, r in zip(sharded_keys, sharded_taxa, reals)
        ]
    rows = max(b[0].shape[0] for b in built)
    tables = np.full((len(built), rows, tile, 3), 0xFFFFFFFF, np.uint32)
    for i, (tb, _, _) in enumerate(built):
        tables[i, : tb.shape[0]] = tb
    return tables, tile, bits


def shard_hashed1_tables(sharded_keys: np.ndarray, sharded_taxa: np.ndarray):
    """Per-shard single-gather row-bucket hash tables (build_hashed_rows)
    with UNIFORM (row_bits, tile) so they stack into one
    [n, 2^row_bits, 3*tile] array shardable over 'data'. Geometry agreement
    mirrors shard_hashed_tables: row_bits/tile = the maxima any shard needs,
    iterated until stable (forcing row_bits can grow a shard's tile)."""
    pad_key = np.uint64(0xFFFFFFFFFFFFFFFF)
    reals = [k != pad_key for k in sharded_keys]
    built = [
        lookup_ops.build_hashed_rows(k[r], t[r])
        for k, t, r in zip(sharded_keys, sharded_taxa, reals)
    ]
    while True:
        tile = max(b[1] for b in built)
        rb = max(b[2] for b in built)
        if all(b[1] == tile and b[2] == rb for b in built):
            break
        built = [
            lookup_ops.build_hashed_rows(k[r], t[r], tile=tile, row_bits=rb)
            for k, t, r in zip(sharded_keys, sharded_taxa, reals)
        ]
    return np.stack([b[0] for b in built]), tile, rb


def shard_hashed1_tables_wide(
    sharded_keys2: np.ndarray, sharded_taxa: np.ndarray, key_bits: int
):
    """shard_hashed1_tables for wide ([n, N/n, 2] u64) keys: per-shard
    single-gather row-bucket tables (build_hashed_rows_wide) at UNIFORM
    (row_bits, tile) stacking to [n, 2^row_bits, 5*tile]."""
    hi_pad = np.uint64((1 << (key_bits - 64)) - 1)
    lo_pad = np.uint64(0xFFFFFFFFFFFFFFFF)
    reals = [
        ~((k[:, 0] == hi_pad) & (k[:, 1] == lo_pad)) for k in sharded_keys2
    ]
    built = [
        lookup_ops.build_hashed_rows_wide(k[r], t[r], key_bits)
        for k, t, r in zip(sharded_keys2, sharded_taxa, reals)
    ]
    while True:
        tile = max(b[1] for b in built)
        rb = max(b[2] for b in built)
        if all(b[1] == tile and b[2] == rb for b in built):
            break
        built = [
            lookup_ops.build_hashed_rows_wide(
                k[r], t[r], key_bits, tile=tile, row_bits=rb
            )
            for k, t, r in zip(sharded_keys2, sharded_taxa, reals)
        ]
    return np.stack([b[0] for b in built]), tile, rb


def classify_ring_fn(
    mesh: Mesh,
    mp: MinimizerParams,
    max_taxa: int,
    rounds: int = 32,
    bits: int = lookup_ops.ROUTER_BITS,
    probe: tuple = ("routed",),
    key_bits: int = 62,
    lut=None,
):
    """Classification with a range-sharded index and ring-rotated queries.

    probe ("routed",):   fn(codes[B,L], keys_hi[n,N/n], keys_lo[n,N/n],
                            key_taxa[n,N/n], routers[n,R], rpath_table)
    probe ("tiled", tile): fn(codes, tables[n,rows,tile,3], routers[n,R],
                            rpath_table)  — per-shard tiled row-gather
                            tables (shard_tiled_tables).
    probe ("hashed", tile, hbits): fn(codes, tables[n,slots,3], routers
                            (ignored dummy), rpath_table) — per-shard
                            aligned-row hashed tables
                            (shard_hashed_tables), routerless.

    Codes and index shards ride 'data'; `rounds`/`bits` come from
    shard_routers. Each of the n ring steps probes the local index shard
    with the visiting chip's queries, then forwards (queries, partial
    answers) to the next chip with ppermute. After n steps every answer is
    home.

    Queries are compacted to one probe per super-mer span before entering the
    ring (all windows of a span share a minimizer), so each hop carries
    ~0.4*B*L entries instead of B*L — a ~2.5x interconnect-bandwidth saving over
    rotating the full per-position arrays. If any device's span count
    overflows the compact buffer (pathological minimizer-dense input), a
    psum reaches consensus and every device takes the full-resolution ring
    instead, keeping the collective schedule identical across the mesh.
    """
    n = mesh.devices.size

    def ring_body(codes, probe_fn, wm, rpath_table):
        acc = ring_lookup(codes, probe_fn, wm, n)

        window_taxa, num_distinct, ch, res, hostpack = _postprocess(
            wm, acc, rpath_table, max_taxa
        )
        counts = jnp.zeros(rpath_table.shape[0], jnp.int32).at[res.max_taxon].add(1)
        counts = jax.lax.psum(counts, "data")
        return window_taxa, num_distinct, ch, res, hostpack, counts

    if probe[0] == "tiled_wide":

        def local_fn(codes, tables, routers, rpath_table):
            wm = _window_scan(codes, mp, lut)
            table = tables[0]
            router = routers[0]

            def probe_fn(l3, l2, l1, l0):
                return lookup_ops.lookup_taxa_tiled_wide(
                    table, router, u128_mod.from_limbs(l3, l2, l1, l0),
                    probe[1], bits, key_bits,
                )

            return ring_body(codes, probe_fn, wm, rpath_table)

        in_specs = (P("data"), P("data"), P("data"), P())
    elif probe[0] == "routed_wide":

        def local_fn(codes, k3, k2, k1, k0, key_taxa, routers, rpath_table):
            wm = _window_scan(codes, mp, lut)
            keys = u128_mod.U128(
                u64.U64(k3[0], k2[0]), u64.U64(k1[0], k0[0])
            )
            kt = key_taxa[0]
            router = routers[0]

            def probe_fn(l3, l2, l1, l0):
                return lookup_ops.lookup_taxa_routed_wide(
                    keys, kt, router, u128_mod.from_limbs(l3, l2, l1, l0),
                    rounds, bits, key_bits,
                )

            return ring_body(codes, probe_fn, wm, rpath_table)

        in_specs = (
            P("data"), P("data"), P("data"), P("data"), P("data"), P("data"),
            P("data"), P(),
        )
    elif probe[0] == "hashed1_wide":

        def local_fn(codes, tables, routers, rpath_table):
            wm = _window_scan(codes, mp, lut)
            table = tables[0]

            def probe_fn(l3, l2, l1, l0):
                return lookup_ops.lookup_taxa_hashed_rows_wide(
                    table, u128_mod.from_limbs(l3, l2, l1, l0),
                    probe[1], probe[2], key_bits,
                )

            return ring_body(codes, probe_fn, wm, rpath_table)

        in_specs = (P("data"), P("data"), P("data"), P())
    elif probe[0] in ("tiled", "hashed", "hashed1"):

        def local_fn(codes, tables, routers, rpath_table):
            wm = _window_scan(codes, mp, lut)
            table = tables[0]
            router = routers[0]

            if probe[0] == "hashed":

                def probe_fn(q_hi, q_lo):
                    return lookup_ops.lookup_taxa_hashed(
                        table, u64.U64(q_hi, q_lo), probe[1], probe[2]
                    )

            elif probe[0] == "hashed1":

                def probe_fn(q_hi, q_lo):
                    return lookup_ops.lookup_taxa_hashed_rows(
                        table, u64.U64(q_hi, q_lo), probe[1], probe[2]
                    )

            else:

                def probe_fn(q_hi, q_lo):
                    return lookup_ops.lookup_taxa_tiled(
                        table, router, u64.U64(q_hi, q_lo), probe[1], bits,
                        key_bits,
                    )

            return ring_body(codes, probe_fn, wm, rpath_table)

        in_specs = (P("data"), P("data"), P("data"), P())
    else:

        def local_fn(codes, keys_hi, keys_lo, key_taxa, routers, rpath_table):
            wm = _window_scan(codes, mp, lut)
            keys = u64.U64(keys_hi[0], keys_lo[0])
            kt = key_taxa[0]
            router = routers[0]

            def probe_fn(q_hi, q_lo):
                return lookup_ops.lookup_taxa_routed(
                    keys, kt, router, u64.U64(q_hi, q_lo), rounds, bits,
                    key_bits,
                )

            return ring_body(codes, probe_fn, wm, rpath_table)

        in_specs = (P("data"), P("data"), P("data"), P("data"), P("data"), P())

    shard = jax.shard_map(
        local_fn,
        mesh=mesh,
        in_specs=in_specs,
        out_specs=(P("data"), P("data"), P("data"), P("data"), P("data"), P()),
        check_vma=False,
    )
    return jax.jit(shard)


def span_hits_replicated_fn(
    mesh: Mesh,
    mp: MinimizerParams,
    rounds: int = 32,
    bits: int = lookup_ops.ROUTER_BITS,
    probe: tuple = ("routed",),
    key_bits: int = 62,
    lut=None,
):
    """Mesh variant of classify2's step-1 span-hit counting kernel
    (dynamic._span_hits_kernel*): codes sharded over 'data', index
    replicated. Returns (min_hi, min_lo, span_start&valid, looked), all
    sharded, so the host's per-taxon counting sees the same data as the
    single-device kernel (the reference distributes this step as a Spark
    job too, Dynamic.scala:95-142).

    probe layouts mirror classify_replicated_fn:
      ("routed",):            fn(codes, keys_hi, keys_lo, key_taxa, router)
      ("tiled", tile, ...):   fn(codes, table, router)
      ("hashed", tile, hbits, ...): fn(codes, table, router(dummy))
    Wide (m > 31) probes return FOUR minimizer limb arrays (l3..l0, most
    significant first) instead of (hi, lo):
      ("routed_wide",):       fn(codes, k3, k2, k1, k0, key_taxa, router)
      ("tiled_wide", tile):   fn(codes, table, router)
      ("hashed1_wide", tile, row_bits): fn(codes, table, router(dummy))
    """

    def finish(wm, looked):
        return wm.minimizer.hi, wm.minimizer.lo, wm.span_start & wm.valid, looked

    def finish_wide(wm, looked):
        return wm.minimizer.limbs + (wm.span_start & wm.valid, looked)

    n_out = 4
    if probe[0] == "routed_wide":
        n_out = 6

        def local_fn(codes, k3, k2, k1, k0, key_taxa, router):
            wm = _window_scan(codes, mp, lut)
            keys = u128_mod.U128(u64.U64(k3, k2), u64.U64(k1, k0))
            looked = lookup_ops.lookup_taxa_routed_wide(
                keys, key_taxa, router, wm.minimizer, rounds, bits, key_bits
            )
            return finish_wide(wm, looked)

        in_specs = (P("data"),) + (P(),) * 6
    elif probe[0] == "tiled_wide":
        n_out = 6

        def local_fn(codes, table, router):
            wm = _window_scan(codes, mp, lut)
            looked = lookup_ops.lookup_taxa_tiled_wide(
                table, router, wm.minimizer, probe[1], bits, key_bits
            )
            return finish_wide(wm, looked)

        in_specs = (P("data"), P(), P())
    elif probe[0] == "hashed1_wide":
        n_out = 6

        def local_fn(codes, table, router):
            wm = _window_scan(codes, mp, lut)
            looked = lookup_ops.lookup_taxa_hashed_rows_wide(
                table, wm.minimizer, probe[1], probe[2], key_bits
            )
            return finish_wide(wm, looked)

        in_specs = (P("data"), P(), P())
    elif probe[0] in ("tiled", "hashed", "hashed1"):

        def local_fn(codes, table, router):
            wm = _window_scan(codes, mp, lut)
            if probe[0] == "hashed":
                looked = lookup_ops.lookup_taxa_hashed(
                    table, wm.minimizer, probe[1], probe[2]
                )
            elif probe[0] == "hashed1":
                looked = lookup_ops.lookup_taxa_hashed_rows(
                    table, wm.minimizer, probe[1], probe[2]
                )
            else:
                looked = lookup_ops.lookup_taxa_tiled(
                    table, router, wm.minimizer, probe[1], bits, key_bits
                )
            return finish(wm, looked)

        in_specs = (P("data"), P(), P())
    else:

        def local_fn(codes, keys_hi, keys_lo, key_taxa, router):
            wm = _window_scan(codes, mp, lut)
            looked = lookup_ops.lookup_taxa_routed(
                u64.U64(keys_hi, keys_lo), key_taxa, router, wm.minimizer,
                rounds, bits, key_bits,
            )
            return finish(wm, looked)

        in_specs = (P("data"), P(), P(), P(), P())

    shard = jax.shard_map(
        local_fn,
        mesh=mesh,
        in_specs=in_specs,
        out_specs=(P("data"),) * n_out,
        check_vma=False,
    )
    return jax.jit(shard)


def span_hits_ring_fn(
    mesh: Mesh,
    mp: MinimizerParams,
    rounds: int = 32,
    bits: int = lookup_ops.ROUTER_BITS,
    probe: tuple = ("routed",),
    key_bits: int = 62,
    lut=None,
):
    """span_hits_replicated_fn for the ring layout: queries rotate the
    range-sharded index via ring_lookup (the same collective schedule as
    classify_ring_fn). probe layouts mirror classify_ring_fn; wide probes
    (routed_wide/tiled_wide/hashed1_wide) return four minimizer limb arrays
    l3..l0 instead of (hi, lo)."""
    n = mesh.devices.size

    def finish(wm, looked):
        return wm.minimizer.hi, wm.minimizer.lo, wm.span_start & wm.valid, looked

    def finish_wide(wm, looked):
        return wm.minimizer.limbs + (wm.span_start & wm.valid, looked)

    n_out = 4
    if probe[0] == "routed_wide":
        n_out = 6

        def local_fn(codes, k3, k2, k1, k0, key_taxa, routers):
            wm = _window_scan(codes, mp, lut)
            keys = u128_mod.U128(
                u64.U64(k3[0], k2[0]), u64.U64(k1[0], k0[0])
            )
            kt = key_taxa[0]
            router = routers[0]

            def probe_fn(l3, l2, l1, l0):
                return lookup_ops.lookup_taxa_routed_wide(
                    keys, kt, router, u128_mod.from_limbs(l3, l2, l1, l0),
                    rounds, bits, key_bits,
                )

            return finish_wide(wm, ring_lookup(codes, probe_fn, wm, n))

        in_specs = (P("data"),) * 7
    elif probe[0] == "tiled_wide":
        n_out = 6

        def local_fn(codes, tables, routers):
            wm = _window_scan(codes, mp, lut)
            table = tables[0]
            router = routers[0]

            def probe_fn(l3, l2, l1, l0):
                return lookup_ops.lookup_taxa_tiled_wide(
                    table, router, u128_mod.from_limbs(l3, l2, l1, l0),
                    probe[1], bits, key_bits,
                )

            return finish_wide(wm, ring_lookup(codes, probe_fn, wm, n))

        in_specs = (P("data"), P("data"), P("data"))
    elif probe[0] == "hashed1_wide":
        n_out = 6

        def local_fn(codes, tables, routers):
            wm = _window_scan(codes, mp, lut)
            table = tables[0]

            def probe_fn(l3, l2, l1, l0):
                return lookup_ops.lookup_taxa_hashed_rows_wide(
                    table, u128_mod.from_limbs(l3, l2, l1, l0),
                    probe[1], probe[2], key_bits,
                )

            return finish_wide(wm, ring_lookup(codes, probe_fn, wm, n))

        in_specs = (P("data"), P("data"), P("data"))
    elif probe[0] in ("tiled", "hashed", "hashed1"):

        def local_fn(codes, tables, routers):
            wm = _window_scan(codes, mp, lut)
            table = tables[0]
            router = routers[0]

            if probe[0] == "hashed":

                def probe_fn(q_hi, q_lo):
                    return lookup_ops.lookup_taxa_hashed(
                        table, u64.U64(q_hi, q_lo), probe[1], probe[2]
                    )

            elif probe[0] == "hashed1":

                def probe_fn(q_hi, q_lo):
                    return lookup_ops.lookup_taxa_hashed_rows(
                        table, u64.U64(q_hi, q_lo), probe[1], probe[2]
                    )

            else:

                def probe_fn(q_hi, q_lo):
                    return lookup_ops.lookup_taxa_tiled(
                        table, router, u64.U64(q_hi, q_lo), probe[1], bits,
                        key_bits,
                    )

            return finish(wm, ring_lookup(codes, probe_fn, wm, n))

        in_specs = (P("data"), P("data"), P("data"))
    else:

        def local_fn(codes, keys_hi, keys_lo, key_taxa, routers):
            wm = _window_scan(codes, mp, lut)
            keys = u64.U64(keys_hi[0], keys_lo[0])
            kt = key_taxa[0]
            router = routers[0]

            def probe_fn(q_hi, q_lo):
                return lookup_ops.lookup_taxa_routed(
                    keys, kt, router, u64.U64(q_hi, q_lo), rounds, bits,
                    key_bits,
                )

            return finish(wm, ring_lookup(codes, probe_fn, wm, n))

        in_specs = (P("data"), P("data"), P("data"), P("data"), P("data"))

    shard = jax.shard_map(
        local_fn,
        mesh=mesh,
        in_specs=in_specs,
        out_specs=(P("data"),) * n_out,
        check_vma=False,
    )
    return jax.jit(shard)


def scan_records_fn(mesh: Mesh, mp: MinimizerParams, lut=None):
    """Distributed index-build scan: every chip scans its shard of genome
    fragments and emits per-window (minimizer, span_start) data; the host
    concatenates shards and the sort + segment-LCA reduction follows
    (index.reduce_records). Mirrors the build pipeline of SURVEY §3.1 with
    the Spark shuffle replaced by host gather + range-sharded reduce."""

    def local_fn(codes):
        wm = _window_scan(codes, mp, lut)
        return wm.minimizer.hi, wm.minimizer.lo, wm.span_start

    shard = jax.shard_map(
        local_fn,
        mesh=mesh,
        in_specs=(P("data"),),
        out_specs=(P("data"), P("data"), P("data")),
        check_vma=False,
    )
    return jax.jit(shard)


def sample_shuffle_boundaries(codes_sample, mp: MinimizerParams, n: int, lut=None):
    """Empirical key-range split points for build_shuffle_fn.

    The priority distribution is NOT uniform (canonical = min(fw, rc) biases
    the high bits low, then the XOR toggle bin-permutes them), so fixed
    bit-prefix ranges skew by ~3x. Like Spark's sampling RangePartitioner
    (the engine under the reference's sorted outputs), we scan a sample
    batch, take n-quantiles of its span keys, and use those as boundaries.
    Returns uint64[n-1] (host array)."""
    import jax.numpy as jnp

    wm = window_minimizers(jnp.asarray(codes_sample), mp, lut)
    start = np.asarray(wm.span_start)
    hi = np.asarray(wm.minimizer.hi)[start].astype(np.uint64)
    lo = np.asarray(wm.minimizer.lo)[start].astype(np.uint64)
    keys = np.sort((hi << np.uint64(32)) | lo)
    if len(keys) == 0:
        return (np.arange(1, n, dtype=np.uint64) * ((1 << 62) // n)).astype(np.uint64)
    pos = (np.arange(1, n) * len(keys)) // n
    return keys[pos]


def build_shuffle_fn(
    mesh: Mesh, mp: MinimizerParams, cap_per_dest: int, boundaries=None, lut=None
):
    """Distributed index build step: the device equivalent of the
    reference's hash-shuffle + groupBy/LCA (KeyValueIndex.scala:85-93,
    125-139), entirely on device.

    Each device scans its shard of genome fragment rows, partitions the
    resulting (minimizer, taxon) span records by key range (top bits of the
    62-bit priority), and exchanges them with jax.lax.all_to_all so device r
    receives every record in range r. Each device then sorts and pair-dedups
    its range locally. The host concatenates the per-device outputs in rank
    order to obtain the globally sorted distinct record set (feeding
    reduce_records for the final cross-taxon LCA).

    fn(codes[B, L] sharded, taxa_rows[B] sharded) ->
        (hi[n, cap], lo[n, cap], taxon[n, cap], counts[n], overflow[n])
    where row r holds device r's deduplicated range records (sentinel-padded).

    `boundaries` (uint64[n-1], from sample_shuffle_boundaries) balances the
    ranges against the canonical-min key-distribution skew; without it, fixed
    bit-prefix ranges are used (OK for generous caps, ~3x skewed).
    """
    n = mesh.devices.size
    range_bits = max(1, (n - 1).bit_length())
    if boundaries is not None:
        b = np.asarray(boundaries, np.uint64)
        assert b.shape == (n - 1,), b.shape
        b_hi = jnp.asarray((b >> np.uint64(32)).astype(np.uint32))
        b_lo = jnp.asarray(b.astype(np.uint32))

    def local_fn(codes, taxa_rows):
        wm = window_minimizers(codes, mp, lut)
        b, l = codes.shape
        m_ = b * l
        hi = wm.minimizer.hi.reshape(m_)
        lo = wm.minimizer.lo.reshape(m_)
        start = wm.span_start.reshape(m_)
        taxon = jnp.broadcast_to(
            jnp.asarray(taxa_rows, jnp.int32)[:, None], (b, l)
        ).reshape(m_)

        if boundaries is not None:
            # dest = #boundaries <= key (n <= 64 broadcast u64 compares)
            key = u64.U64(hi[None, :], lo[None, :])
            bnd = u64.U64(b_hi[:, None], b_lo[:, None])
            dest = jnp.sum(u64.leu(bnd, key), axis=0).astype(jnp.int32)
        else:
            # destination range = top bits of the 62-bit key (hi = bits 32..61)
            dest = (hi >> (30 - range_bits)).astype(jnp.int32)
            dest = jnp.minimum(dest, n - 1)
        sent = jnp.uint32(0xFFFFFFFF)
        khi = jnp.where(start, hi, sent)
        klo = jnp.where(start, lo, sent)
        kdest = jnp.where(start, dest, n)  # invalid -> beyond last range
        ktax = jnp.where(start, taxon, 0)

        # sort by (dest, key) so each destination's records are contiguous
        sdest, shi, slo, stax = jax.lax.sort((kdest, khi, klo, ktax), num_keys=3)
        # slot each record within its destination bucket
        idx = jnp.arange(m_, dtype=jnp.int32)
        first_of_dest = jnp.searchsorted(sdest, jnp.arange(n + 1, dtype=jnp.int32))
        offset_in_dest = idx - first_of_dest[jnp.minimum(sdest, n)]
        sizes = first_of_dest[1:] - first_of_dest[:-1]
        overflow = jnp.any(sizes > cap_per_dest)

        out_idx = jnp.where(
            (sdest < n) & (offset_in_dest < cap_per_dest),
            sdest * cap_per_dest + offset_in_dest,
            n * cap_per_dest,
        )
        buf_hi = jnp.full(n * cap_per_dest, sent).at[out_idx].set(shi, mode="drop")
        buf_lo = jnp.full(n * cap_per_dest, sent).at[out_idx].set(slo, mode="drop")
        buf_tax = jnp.zeros(n * cap_per_dest, jnp.int32).at[out_idx].set(stax, mode="drop")

        # exchange: device d sends chunk r to device r
        def a2a(x):
            return jax.lax.all_to_all(
                x.reshape(n, cap_per_dest), "data", split_axis=0, concat_axis=0, tiled=False
            ).reshape(n * cap_per_dest)

        rhi = a2a(buf_hi)
        rlo = a2a(buf_lo)
        rtax = a2a(buf_tax)

        # local sort + pair dedup of this device's range
        shi2, slo2, stax2 = jax.lax.sort((rhi, rlo, rtax), num_keys=3)
        valid = shi2 != sent
        prev_hi = jnp.concatenate([sent[None], shi2[:-1]])
        prev_lo = jnp.concatenate([sent[None], slo2[:-1]])
        prev_tax = jnp.concatenate([jnp.full((1,), -1, jnp.int32), stax2[:-1]])
        new = valid & ((shi2 != prev_hi) | (slo2 != prev_lo) | (stax2 != prev_tax))
        pos = jnp.cumsum(new) - 1
        count = jnp.sum(new)
        o_idx = jnp.where(new, pos, n * cap_per_dest)
        out_hi = jnp.full(n * cap_per_dest, sent).at[o_idx].set(shi2, mode="drop")
        out_lo = jnp.full(n * cap_per_dest, sent).at[o_idx].set(slo2, mode="drop")
        out_tax = jnp.zeros(n * cap_per_dest, jnp.int32).at[o_idx].set(stax2, mode="drop")
        return (
            out_hi[None, :],
            out_lo[None, :],
            out_tax[None, :],
            count[None],
            overflow[None],
        )

    shard = jax.shard_map(
        local_fn,
        mesh=mesh,
        in_specs=(P("data"), P("data")),
        out_specs=(P("data"), P("data"), P("data"), P("data"), P("data")),
        check_vma=False,
    )
    return jax.jit(shard)


def sample_shuffle_boundaries_wide(codes_sample, mp: MinimizerParams, n: int):
    """sample_shuffle_boundaries for wide (m > 31) minimizers: n-quantiles
    of the sample's [S, 2] u64 span keys. Returns uint64[n-1, 2]."""
    import jax.numpy as jnp

    wm = window_minimizers(jnp.asarray(codes_sample), mp)
    start = np.asarray(wm.span_start)
    l3, l2, l1, l0 = (np.asarray(x)[start].astype(np.uint64) for x in wm.minimizer.limbs)
    hi64 = (l3 << np.uint64(32)) | l2
    lo64 = (l1 << np.uint64(32)) | l0
    order = np.lexsort((lo64, hi64))
    keys2 = np.stack([hi64[order], lo64[order]], axis=1)
    kb = 2 * mp.m
    if len(keys2) == 0:
        # spanless sample: fall back to uniform 2m-bit-keyspace quantiles
        # (exact 128-bit arithmetic in Python ints — the uint64 shortcuts
        # here previously produced degenerate all-to-one-device boundaries)
        out = np.zeros((n - 1, 2), np.uint64)
        for i in range(1, n):
            v = (i << kb) // n
            out[i - 1, 0] = v >> 64
            out[i - 1, 1] = v & ((1 << 64) - 1)
        return out
    pos = (np.arange(1, n) * len(keys2)) // n
    return keys2[pos]


def build_shuffle_fn_wide(
    mesh: Mesh, mp: MinimizerParams, cap_per_dest: int, boundaries=None
):
    """build_shuffle_fn for wide (m > 31) minimizers: the all_to_all range
    exchange carries FOUR u32 key limbs per record (most significant first),
    the local sorts key on all four, and the pair dedup compares them all.

    fn(codes[B, L] sharded, taxa_rows[B] sharded) ->
        (l3[n, cap], l2, l1, l0, taxon[n, cap], counts[n], overflow[n]).

    `boundaries` is uint64[n-1, 2] from sample_shuffle_boundaries_wide;
    without it, destinations come from the top bits of the 2m-bit priority.
    """
    n = mesh.devices.size
    range_bits = max(1, (n - 1).bit_length())
    kb = 2 * mp.m
    if boundaries is not None:
        b = np.asarray(boundaries, np.uint64)
        assert b.shape == (n - 1, 2), b.shape
        b_limbs = [
            jnp.asarray((b[:, 0] >> np.uint64(32)).astype(np.uint32)),
            jnp.asarray(b[:, 0].astype(np.uint32)),
            jnp.asarray((b[:, 1] >> np.uint64(32)).astype(np.uint32)),
            jnp.asarray(b[:, 1].astype(np.uint32)),
        ]

    def local_fn(codes, taxa_rows):
        wm = window_minimizers(codes, mp)
        b_, l_ = codes.shape
        m_ = b_ * l_
        l3, l2, l1, l0 = (x.reshape(m_) for x in wm.minimizer.limbs)
        start = wm.span_start.reshape(m_)
        taxon = jnp.broadcast_to(
            jnp.asarray(taxa_rows, jnp.int32)[:, None], (b_, l_)
        ).reshape(m_)

        if boundaries is not None:
            key = u128_mod.from_limbs(
                l3[None, :], l2[None, :], l1[None, :], l0[None, :]
            )
            bnd = u128_mod.from_limbs(*(x[:, None] for x in b_limbs))
            dest = jnp.sum(u128_mod.leu(bnd, key), axis=0).astype(jnp.int32)
        else:
            # top bits of the 2m-bit priority; for m > 31 they live in the
            # hi64 word, which holds kb-64 significant bits (2..62). When
            # kb-64 < range_bits (tiny m just over 31 on a big mesh) the
            # clamp leaves high devices idle — use sampled boundaries there.
            top = kb - 64
            dest = u64.shr(
                u64.U64(l3, l2), max(top - range_bits, 0)
            ).lo.astype(jnp.int32)
            dest = jnp.minimum(dest, n - 1)
        sent = jnp.uint32(0xFFFFFFFF)
        kl3 = jnp.where(start, l3, sent)
        kl2 = jnp.where(start, l2, sent)
        kl1 = jnp.where(start, l1, sent)
        kl0 = jnp.where(start, l0, sent)
        kdest = jnp.where(start, dest, n)
        ktax = jnp.where(start, taxon, 0)

        sdest, s3, s2, s1, s0, stax = jax.lax.sort(
            (kdest, kl3, kl2, kl1, kl0, ktax), num_keys=5
        )
        idx = jnp.arange(m_, dtype=jnp.int32)
        first_of_dest = jnp.searchsorted(sdest, jnp.arange(n + 1, dtype=jnp.int32))
        offset_in_dest = idx - first_of_dest[jnp.minimum(sdest, n)]
        sizes = first_of_dest[1:] - first_of_dest[:-1]
        overflow = jnp.any(sizes > cap_per_dest)

        out_idx = jnp.where(
            (sdest < n) & (offset_in_dest < cap_per_dest),
            sdest * cap_per_dest + offset_in_dest,
            n * cap_per_dest,
        )

        def scatter(vals, fill):
            return jnp.full(n * cap_per_dest, fill).at[out_idx].set(
                vals, mode="drop"
            )

        bufs = [scatter(v, sent) for v in (s3, s2, s1, s0)]
        buf_tax = jnp.zeros(n * cap_per_dest, jnp.int32).at[out_idx].set(
            stax, mode="drop"
        )

        def a2a(x):
            return jax.lax.all_to_all(
                x.reshape(n, cap_per_dest), "data", split_axis=0,
                concat_axis=0, tiled=False,
            ).reshape(n * cap_per_dest)

        r3, r2, r1, r0 = (a2a(x) for x in bufs)
        rtax = a2a(buf_tax)

        t3, t2, t1, t0, ttax = jax.lax.sort((r3, r2, r1, r0, rtax), num_keys=5)
        valid = (t3 != sent) | (t2 != sent) | (t1 != sent) | (t0 != sent)

        def prev(x, fill):
            return jnp.concatenate([jnp.full((1,), fill, x.dtype), x[:-1]])

        new = valid & (
            (t3 != prev(t3, sent)) | (t2 != prev(t2, sent))
            | (t1 != prev(t1, sent)) | (t0 != prev(t0, sent))
            | (ttax != prev(ttax, jnp.int32(-1)))
        )
        pos = jnp.cumsum(new) - 1
        count = jnp.sum(new)
        o_idx = jnp.where(new, pos, n * cap_per_dest)
        outs = [
            jnp.full(n * cap_per_dest, sent).at[o_idx].set(v, mode="drop")
            for v in (t3, t2, t1, t0)
        ]
        out_tax = jnp.zeros(n * cap_per_dest, jnp.int32).at[o_idx].set(
            ttax, mode="drop"
        )
        return tuple(x[None, :] for x in outs) + (
            out_tax[None, :], count[None], overflow[None],
        )

    shard = jax.shard_map(
        local_fn,
        mesh=mesh,
        in_specs=(P("data"), P("data")),
        out_specs=(P("data"),) * 7,
        check_vma=False,
    )
    return jax.jit(shard)
