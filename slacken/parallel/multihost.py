"""Multi-host (DCN) execution support.

The reference scales across machines with a Spark cluster (SparkTool.scala:
31-41 builds the session; the shuffle rides the cluster network). The
analogue here is a multi-host JAX program: one Python process per host,
connected with `jax.distributed`, devices of all hosts forming one global
mesh. Classification collectives are laid out so the heavy traffic (ring
query rotation) stays on the fast intra-host interconnect, and only
report-count psums cross the host network.

Usage (same script on every host):

    from slacken.parallel import multihost

    ctx = multihost.initialize()                # no-op on a single host
    idx = multihost.load_index_for_host("gs://.../idx_sharded", ctx)
    mesh = multihost.global_mesh()
    ...

On a single host (or when `jax.distributed` env vars are absent) every
function degenerates to the local behaviour, so the same program runs
unchanged from a laptop to a pod — there is no separate cluster code path
to maintain (contrast the reference's Spark-vs-local duality).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional

import numpy as np


_distributed_initialized = False


@dataclass
class HostContext:
    """This process's place in the (possibly single-host) job."""

    process_index: int
    process_count: int
    local_device_count: int
    global_device_count: int

    @property
    def is_distributed(self) -> bool:
        return self.process_count > 1


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> HostContext:
    """Initialize multi-host JAX if configured; otherwise return the local
    single-process context.

    Distribution is requested either via explicit arguments or the standard
    environment (JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES /
    JAX_PROCESS_ID). Safe to call multiple times."""
    global _distributed_initialized
    import jax

    explicit = coordinator_address or os.environ.get("JAX_COORDINATOR_ADDRESS")
    # NOTE: do not probe jax.process_count() before distributed init — that
    # call itself initialises the XLA backend, after which
    # jax.distributed.initialize refuses to run
    if explicit and not _distributed_initialized:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
        _distributed_initialized = True
    return HostContext(
        process_index=jax.process_index(),
        process_count=jax.process_count(),
        local_device_count=jax.local_device_count(),
        global_device_count=jax.device_count(),
    )


def global_mesh(axis: str = "data"):
    """1-D mesh over ALL devices of all hosts, in (process, local device)
    order so contiguous index ranges land on contiguous hosts."""
    import jax
    from jax.sharding import Mesh

    return Mesh(np.asarray(jax.devices()), (axis,))


def host_shard_ids(n_shards: int, ctx: HostContext) -> List[int]:
    """Contiguous shard-id range owned by this host (ranges in rank order so
    the concatenation across hosts is the globally sorted key array)."""
    bounds = np.linspace(0, n_shards, ctx.process_count + 1).astype(int)
    return list(range(bounds[ctx.process_index], bounds[ctx.process_index + 1]))


def load_index_for_host(location: str, ctx: HostContext, taxonomy=None):
    """Load only this host's key-range shards from a `save_sharded` layout.

    Each host holds 1/process_count of the sorted key array; together the
    hosts' ranges tile the index exactly — the DCN analogue of the
    reference's bucketed Parquet table being read partition-wise by Spark
    executors (KeyValueIndex.scala:150-159)."""
    import json

    from .. import storage
    from ..index import KeyValueIndex

    with storage.open_file(storage.join(location, "params.json")) as f:
        n_shards = len(json.load(f)["shards"])
    ids = host_shard_ids(n_shards, ctx)
    return KeyValueIndex.load_shards(location, ids, taxonomy=taxonomy)


def ring_index_for_host(location: str, ctx: HostContext, mesh, return_local=False):
    """Assemble the GLOBAL ring-sharded index arrays over `mesh`, each host
    loading only its own key-range shard files.

    Device d of the mesh owns global key range d (contiguous shard files
    d*s0..(d+1)*s0); this process loads and pads only the rows of its own
    devices and contributes them to global jax Arrays via
    `jax.make_array_from_process_local_data`. Rows are sentinel-padded to a
    common length (the all-ones key never matches a query — same convention
    as mesh.shard_index_by_range; the wide sentinel is build-time-asserted
    absent from the real keys). Returns, ready for `mesh.classify_ring_fn`:
      narrow (m <= 31): (keys_hi, keys_lo, taxa, routers, rounds, bits,
                         params) — two u32 limb arrays;
      wide  (m > 31):   (l3, l2, l1, l0, taxa, routers, rounds, bits,
                         params) — four u32 limb arrays, most-significant
                         first (l3/l2 = key hi word, l1/l0 = low word).
    With return_local=True a trailing (local_keys, local_taxa, routers)
    tuple of host-side per-local-row lists is appended. This is the DCN
    analogue of Spark executors each
    reading their partitions of the bucketed Parquet table
    (KeyValueIndex.scala:150-159)."""
    import json

    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from .. import storage
    from ..index import IndexParams
    from ..ops import lookup as lookup_ops

    with storage.open_file(storage.join(location, "params.json")) as f:
        meta = json.load(f)
    params = IndexParams.from_json(meta)
    sizes = meta["shards"]
    n_shards = len(sizes)
    n = mesh.devices.size
    if n_shards % n:
        raise ValueError(f"{n_shards} shard files not divisible by {n} devices")
    s0 = n_shards // n
    dev_sizes = [sum(sizes[d * s0 : (d + 1) * s0]) for d in range(n)]
    row_len = max(max(dev_sizes), 1)
    key_bits = 2 * params.m
    bits = min(lookup_ops.adaptive_router_bits(row_len), key_bits)

    devs = list(mesh.devices.flat)
    local_rows = [
        d for d in range(n) if devs[d].process_index == ctx.process_index
    ]
    wide = params.m > 31
    # pad with the LARGEST key-space value: it never matches a real query
    # (same convention as mesh.shard_index_by_range[_wide])
    sent = np.uint64(0xFFFFFFFFFFFFFFFF)
    hi_pad = np.uint64((1 << (key_bits - 64)) - 1) if wide else sent
    limbs = [[] for _ in range(4 if wide else 2)]
    tx, rt = [], []
    local_keys, local_taxa = [], []  # host-side rows (probe-table building)
    rounds = 1
    for d in local_rows:
        ids = range(d * s0, (d + 1) * s0)
        keys = np.concatenate(
            [storage.np_load(storage.join(location, f"keys.{i:05d}.npy")) for i in ids]
        )
        taxa = np.concatenate(
            [storage.np_load(storage.join(location, f"taxa.{i:05d}.npy")) for i in ids]
        )
        pad = row_len - len(keys)
        if wide:
            keys = keys.reshape(-1, 2)
            # the wide sentinel is a legal key value (cf.
            # mesh.shard_index_by_range_wide): a real record carrying it
            # would be masked out of the hashed ring tables — refuse loudly.
            # Keys are sorted, so only the last row can hold the maximum.
            if len(keys) and keys[-1, 0] == hi_pad and keys[-1, 1] == sent:
                raise ValueError(
                    "index contains the maximum wide key (== the shard pad "
                    "sentinel); cannot be represented in ring layouts"
                )
            keys = np.concatenate(
                [keys, np.stack(
                    [np.full(pad, hi_pad), np.full(pad, sent)], axis=1
                )]
            )
            router = lookup_ops.build_router_wide(keys, bits, key_bits)
            for li, col in enumerate((
                (keys[:, 0] >> np.uint64(32)).astype(np.uint32),
                keys[:, 0].astype(np.uint32),
                (keys[:, 1] >> np.uint64(32)).astype(np.uint32),
                keys[:, 1].astype(np.uint32),
            )):
                limbs[li].append(col)
        else:
            keys = np.concatenate([keys, np.full(pad, sent)])
            router = lookup_ops.build_router(keys, bits, key_bits)
            limbs[0].append((keys >> np.uint64(32)).astype(np.uint32))
            limbs[1].append(keys.astype(np.uint32))
        taxa = np.concatenate([taxa, np.zeros(pad, np.int32)]).astype(np.int32)
        rounds = max(rounds, lookup_ops.router_rounds(router))
        tx.append(taxa)
        rt.append(router)
        local_keys.append(keys)
        local_taxa.append(taxa)

    if ctx.is_distributed:
        from jax.experimental import multihost_utils

        rounds = int(multihost_utils.process_allgather(np.array([rounds])).max())

    sh = NamedSharding(mesh, P("data"))

    def mk(rows):
        local = np.stack(rows)
        return jax.make_array_from_process_local_data(
            sh, local, global_shape=(n,) + local.shape[1:]
        )

    out = tuple(mk(l) for l in limbs) + (mk(tx), mk(rt), rounds, bits, params)
    if return_local:
        return out + ((local_keys, local_taxa, rt),)
    return out


def ring_tables_for_host(location: str, ctx: HostContext, mesh, keys_rows,
                         taxa_rows, routers_rows):
    """Per-shard TILED probe tables for the multi-host ring, built from the
    rows `ring_index_for_host` loaded for this host's devices.

    Table geometry (tile width, row count) must agree across every process
    (the probe kernel is SPMD), but the required tile depends on each
    shard's densest router bucket — so hosts build candidates, allgather the
    maxima, and rebuild at the agreed geometry. Returns
    (tables global array [n, rows, tile, 3], tile)."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from ..ops import lookup as lookup_ops

    # candidate geometry from this host's shards
    tile = 16
    for r in routers_rows:
        tile = max(tile, lookup_ops.tile_for_span(lookup_ops.max_bucket_span(r)))
    agreed = allgather_objects({"tile": tile})
    tile = max(a["tile"] for a in agreed)
    tables = [
        lookup_ops.build_tiled(k, t, r, tile=tile)[0]
        for k, t, r in zip(keys_rows, taxa_rows, routers_rows)
    ]
    rows = max(tb.shape[0] for tb in tables)
    rows = max(a["rows"] for a in allgather_objects({"rows": rows}))
    stacked = np.full((len(tables), rows, tile, 3), 0xFFFFFFFF, np.uint32)
    for i, tb in enumerate(tables):
        stacked[i, : tb.shape[0]] = tb
        stacked[i, tb.shape[0] :, :, 2] = 0  # sentinel taxon 0 (a miss)
    n = mesh.devices.size
    sh = NamedSharding(mesh, P("data"))
    gtables = jax.make_array_from_process_local_data(
        sh, stacked, global_shape=(n,) + stacked.shape[1:]
    )
    return gtables, tile


def ring_hashed_tables_for_host(ctx: HostContext, mesh, keys_rows, taxa_rows,
                                kind: str = "hashed", key_bits: int = 62):
    """Per-shard HASHED probe tables for the multi-host ring (the fast
    routerless probes): kind="hashed" builds displacement-bounded two-row
    tables (ops/lookup.py build_hashed), kind="hashed1" the single-gather
    row-bucket tables (build_hashed_rows). Geometry (bits/row_bits, tile,
    row count) must agree across every process (SPMD probe kernel), so hosts
    build at their local maxima, allgather, and rebuild until the agreed
    geometry is stable (forcing bits can grow a shard's tile). The all-ones
    range-pad keys are stripped first (cannot inflate displacement).
    Returns (tables global array, tile, bits)."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from ..ops import lookup as lookup_ops

    pad_key = np.uint64(0xFFFFFFFFFFFFFFFF)
    wide = key_bits > 62
    if wide:
        hi_pad = np.uint64((1 << (key_bits - 64)) - 1)
        reals = [
            ~((k[:, 0] == hi_pad) & (k[:, 1] == pad_key)) for k in keys_rows
        ]
    else:
        reals = [k != pad_key for k in keys_rows]
    if kind == "hashed1" and wide:
        def build(k, t, **kw2):
            return lookup_ops.build_hashed_rows_wide(k, t, key_bits, **kw2)

        kw = lambda tile, bits: dict(tile=tile, row_bits=bits)
    elif kind == "hashed1":
        build = lookup_ops.build_hashed_rows
        kw = lambda tile, bits: dict(tile=tile, row_bits=bits)
    elif kind == "hashed" and not wide:
        build = lookup_ops.build_hashed
        kw = lambda tile, bits: dict(tile=tile, bits=bits)
    else:
        raise ValueError(f"unknown hashed kind {kind!r} (wide={wide})")
    built = [
        build(k[r], t[r]) for k, t, r in zip(keys_rows, taxa_rows, reals)
    ]
    # fixed-point on (tile, bits) ONLY — row counts are data-dependent for
    # kind="hashed" (n_rows tracks the last occupied slot) and handled by
    # padding below, so requiring row agreement would never converge. Every
    # process executes the same allgather sequence per iteration, and exit
    # is decided by a gathered did-anyone-rebuild flag so the loop count is
    # identical on all processes (a mismatch would desync the collectives).
    while True:
        agreed = allgather_objects({
            "tile": max(b[1] for b in built),
            "bits": max(b[2] for b in built),
        })
        tile = max(a["tile"] for a in agreed)
        bits = max(a["bits"] for a in agreed)
        changed = not all(b[1] == tile and b[2] == bits for b in built)
        if changed:
            built = [
                build(k[r], t[r], **kw(tile, bits))
                for k, t, r in zip(keys_rows, taxa_rows, reals)
            ]
        if not any(
            a["changed"] for a in allgather_objects({"changed": changed})
        ):
            break
    rows = max(
        a["rows"]
        for a in allgather_objects({"rows": max(b[0].shape[0] for b in built)})
    )
    # pad every table to the agreed row count (hashed1 tables are already
    # exactly 2^row_bits rows; hashed tables vary with the last occupied
    # slot). Clamped/over gathers land on sentinel rows — a correct miss.
    shape = built[0][0].shape[1:]
    stacked = np.full((len(built), rows) + shape, 0xFFFFFFFF, np.uint32)
    for i, (tb, _, _) in enumerate(built):
        stacked[i, : tb.shape[0]] = tb
    n = mesh.devices.size
    sh = NamedSharding(mesh, P("data"))
    gtables = jax.make_array_from_process_local_data(
        sh, stacked, global_shape=(n,) + stacked.shape[1:]
    )
    return gtables, tile, bits


def global_rows(local_rows: np.ndarray, mesh):
    """Build a global [B, ...] jax Array sharded over mesh axis 0 from this
    process's rows (each process contributes B/process_count rows)."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    sh = NamedSharding(mesh, P("data"))
    b_global = local_rows.shape[0] * jax.process_count()
    return jax.make_array_from_process_local_data(
        sh, local_rows, global_shape=(b_global,) + local_rows.shape[1:]
    )


def collect_local(global_array) -> np.ndarray:
    """Concatenate this process's addressable shards of a global array in
    global row order."""
    shards = sorted(global_array.addressable_shards, key=lambda s: s.index[0].start or 0)
    return np.concatenate([np.asarray(s.data) for s in shards])


def allgather_objects(obj):
    """All-gather one JSON-serialisable object per process (list in process
    order). Two process_allgathers: byte lengths, then padded buffers."""
    import json

    import jax

    if jax.process_count() == 1:
        return [obj]
    from jax.experimental import multihost_utils

    data = np.frombuffer(json.dumps(obj).encode("utf-8"), np.uint8)
    sizes = multihost_utils.process_allgather(np.array([len(data)]))[:, 0]
    buf = np.zeros(int(sizes.max()), np.uint8)
    buf[: len(data)] = data
    bufs = multihost_utils.process_allgather(buf)
    return [
        json.loads(bytes(bufs[p, : int(sizes[p])]).decode("utf-8"))
        for p in range(len(sizes))
    ]


from ..classify import Classifier as _Classifier, default_probe


class MultiHostRingClassifier(_Classifier):
    """CLI-reachable multi-host classification (VERDICT r2 #10).

    Each process loads only its own key-range shards of a `save_sharded`
    index; the devices of all processes form one global 1-D mesh and queries
    rotate the ring with ppermute ACROSS process boundaries (the DCN analogue
    of the reference's Spark cluster executing the shuffle join,
    KeyValueIndex.scala:150-159 + slacken.sh's SPARK_MASTER wiring).

    Lockstep discipline: collectives require every process to dispatch the
    same shapes in the same order, so batches are a FIXED (rows, bucket)
    shape; each process classifies a contiguous share of the global read
    stream and pads its tail (including whole all-padding dispatches) to the
    common dispatch count. Per-read outputs go to per-process part files in
    the shared output dir (part-<process>), whose name-ordered concatenation
    equals the single-process output; reports are merged across processes
    and written by process 0.
    """

    def __init__(self, location: str, ctx: Optional[HostContext] = None,
                 mh_probe: Optional[str] = None, **kwargs):
        import jax
        from jax.sharding import NamedSharding, PartitionSpec as P

        from . import mesh as pmesh

        self.ctx = ctx or initialize()
        mesh = global_mesh()
        # base init with an EMPTY-range index (params/taxonomy/LUT only):
        # the ring never probes self.index — loading this host's whole key
        # range here would duplicate ring_index_for_host's IO AND upload the
        # keys to device via the base routed-probe setup, for nothing
        from ..index import KeyValueIndex

        local = KeyValueIndex.load_shards(location, [], taxonomy=None)
        kwargs.setdefault("probe", "routed")
        kwargs.setdefault("packed_transfer", False)
        super().__init__(local, **kwargs)
        self._part_index = self.ctx.process_index
        self.mesh = mesh
        self.n_global = mesh.devices.size
        self.local_devices = jax.local_device_count()

        ring = ring_index_for_host(location, self.ctx, mesh, return_local=True)
        if local.wide:
            khh, khl, klh, kll, tx, rt, rounds, bits, params, local_rows = ring
        else:
            kh, kl, tx, rt, rounds, bits, params, local_rows = ring
        table = np.asarray(local.taxonomy.rpath_table())
        gtable = jax.make_array_from_process_local_data(
            NamedSharding(mesh, P()), table, global_shape=table.shape
        )
        # probe choice: default_probe at the padded per-device shard length,
        # which every process sees alike (the ring has no wide tiled layout:
        # routed there). STPU_MH_PROBE overrides (routed/tiled/hashed/hashed1).
        mh_probe = mh_probe or os.environ.get("STPU_MH_PROBE")
        if mh_probe is None:
            mh_probe = default_probe(local, keys_per_device=ring[0].shape[1])
            if local.wide and mh_probe == "tiled":
                mh_probe = "routed"
        if mh_probe not in ("routed", "tiled", "hashed", "hashed1"):
            raise ValueError(
                f"multi-host ring supports routed/tiled/hashed/hashed1 "
                f"probes, not {mh_probe!r}"
            )
        if local.wide and mh_probe not in ("routed", "hashed1"):
            raise ValueError(
                "wide (m > 31) multi-host indexes support the routed and "
                "hashed1 probes"
            )
        if mh_probe in ("hashed", "hashed1") and not local.wide:
            lk, lt, _ = local_rows
            gtables, tile, hb = ring_hashed_tables_for_host(
                self.ctx, mesh, lk, lt, kind=mh_probe
            )
            self._ring_fn = pmesh.classify_ring_fn(
                mesh, params.minimizer_params, self.max_taxa, rounds, bits,
                probe=(mh_probe, tile, hb), key_bits=2 * params.m,
                lut=local.device_lut,
            )
            dummies = jax.make_array_from_process_local_data(
                NamedSharding(mesh, P("data")),
                np.zeros((len(lk), 2), np.int32),
                global_shape=(self.n_global, 2),
            )
            self._gargs = (gtables, dummies, gtable)
        elif mh_probe == "tiled" and not local.wide:
            lk, lt, lr = local_rows
            gtables, tile = ring_tables_for_host(
                location, self.ctx, mesh, lk, lt, lr
            )
            self._ring_fn = pmesh.classify_ring_fn(
                mesh, params.minimizer_params, self.max_taxa, rounds, bits,
                probe=("tiled", tile), key_bits=2 * params.m,
                lut=local.device_lut,
            )
            self._gargs = (gtables, rt, gtable)
        elif mh_probe == "hashed1" and local.wide:
            lk, lt, _ = local_rows
            gtables, tile, rb = ring_hashed_tables_for_host(
                self.ctx, mesh, lk, lt, kind="hashed1", key_bits=2 * params.m
            )
            self._ring_fn = pmesh.classify_ring_fn(
                mesh, params.minimizer_params, self.max_taxa, rounds, bits,
                probe=("hashed1_wide", tile, rb), key_bits=2 * params.m,
            )
            dummies = jax.make_array_from_process_local_data(
                NamedSharding(mesh, P("data")),
                np.zeros((len(lk), 2), np.int32),
                global_shape=(self.n_global, 2),
            )
            self._gargs = (gtables, dummies, gtable)
        elif local.wide:
            self._ring_fn = pmesh.classify_ring_fn(
                mesh, params.minimizer_params, self.max_taxa, rounds, bits,
                probe=("routed_wide",), key_bits=2 * params.m,
            )
            self._gargs = (khh, khl, klh, kll, tx, rt, gtable)
        else:
            self._ring_fn = pmesh.classify_ring_fn(
                mesh, params.minimizer_params, self.max_taxa, rounds, bits,
                key_bits=2 * params.m, lut=local.device_lut,
            )
            self._gargs = (kh, kl, tx, rt, gtable)
        self._lockstep = None

    def set_lockstep(self, max_share_reads: int, rows: int, bucket: int):
        """Fix the dispatch schedule from the largest per-process read share:
        every process will issue exactly ceil(max_share/rows) batches of
        `rows` x `bucket` codes. All three inputs must be computed from the
        SAME global read stream on every process (they are: each process
        scans the same input files)."""
        rows = -(-rows // self.local_devices) * self.local_devices
        b = 128
        while b < bucket:
            b *= 2
        n_dispatches = max(1, -(-int(max_share_reads) // rows))
        self._lockstep = (n_dispatches, int(rows), b)

    # -- lockstep batching (replaces the adaptive packed_batches) -----------

    def packed_batches(self, packed_iter):
        import collections

        from ..ops import encode

        if self._lockstep is None:
            raise RuntimeError("call set_lockstep() before classifying")
        n_disp, rows, bucket = self._lockstep
        pending = collections.deque()
        issued = 0
        buf = []  # (codes, titles, splits, lens) chunks, all width==bucket

        def count():
            return sum(len(x[1]) for x in buf)

        def dispatch_next(force=False):
            nonlocal issued
            while count() >= rows or (force and count() > 0):
                take = min(count(), rows)
                codes_parts, titles, splits, lens = [], [], [], []
                got = 0
                while got < take:
                    c, t, sp, ln = buf[0]
                    need = take - got
                    if len(t) <= need:
                        codes_parts.append(c)
                        titles += t
                        splits += sp
                        lens += ln
                        got += len(t)
                        buf.pop(0)
                    else:
                        codes_parts.append(c[:need])
                        titles += t[:need]
                        splits += sp[:need]
                        lens += ln[:need]
                        buf[0] = (c[need:], t[need:], sp[need:], ln[need:])
                        got = take
                codes = np.ascontiguousarray(np.concatenate(codes_parts))
                issued += 1
                pending.append(self._dispatch_codes(codes, titles, splits, lens))
                while len(pending) > 2:
                    yield self._harvest(pending.popleft())

        for packed in packed_iter:
            c = np.asarray(packed.codes)
            if c.shape[1] > bucket:
                raise ValueError(
                    f"read width {c.shape[1]} exceeds the lockstep bucket "
                    f"{bucket}; recompute set_lockstep from the full input"
                )
            if c.shape[1] < bucket:
                c = np.pad(
                    c, ((0, 0), (0, bucket - c.shape[1])),
                    constant_values=encode.INVALID,
                )
            if getattr(packed, "splits", None) is not None:
                sp = [int(x) for x in packed.splits]
            else:
                sp = [None] * len(packed.titles)
            buf.append(
                (c, list(packed.titles), sp, [int(x) for x in packed.lengths])
            )
            yield from dispatch_next()
        yield from dispatch_next(force=True)
        # all-padding dispatches keep the collective schedule identical when
        # this process's share rounds to fewer batches than the longest one
        from ..ops import encode as enc

        while issued < n_disp:
            codes = np.full((rows, bucket), enc.INVALID, np.uint8)
            issued += 1
            pending.append(self._dispatch_codes(codes, [], [], []))
            while len(pending) > 2:
                yield self._harvest(pending.popleft())
        while pending:
            yield self._harvest(pending.popleft())

    # -- global dispatch ------------------------------------------------------

    def _dispatch_codes(self, codes, titles, splits, row_lens):
        from ..ops import encode

        n_disp, rows, bucket = self._lockstep
        if codes.shape[0] < rows:
            pad = np.full(
                (rows - codes.shape[0], bucket), encode.INVALID, np.uint8
            )
            codes = np.concatenate([codes, pad], axis=0)
        gcodes = global_rows(codes, self.mesh)
        outs = self._ring_fn(gcodes, *self._gargs)
        # defer the blocking device->host collection to _harvest so the
        # pending deque actually pipelines: the next batch can pack and
        # dispatch while this one still rotates the ring
        return ("mh", outs, codes, titles, splits, row_lens)

    def _harvest(self, dispatched):
        import jax

        if isinstance(dispatched, tuple) and dispatched and dispatched[0] == "mh":
            _, outs, codes, titles, splits, row_lens = dispatched
            wt, nd, ch, res, hp, _counts = outs
            # bring THIS process's rows home, then hand the LOCAL slices to
            # the standard single-chip post-dispatch glue (the device
            # finalize is re-dispatched on this host's own devices)
            local = jax.tree_util.tree_map(collect_local, (wt, nd, ch, res, hp))
            dispatched = self._post_dispatch(
                local, codes, titles, splits, row_lens
            )
        return super()._harvest(dispatched)

    # -- merged reports -------------------------------------------------------

    def _write_reports(self, counts, output_location: str, cpar):
        # serialise as (threshold index, sample, taxon, count) rows: JSON
        # keys are strings, so keep thresholds as indexes into the shared
        # cpar.thresholds list
        thr = list(counts.keys())
        rows = [
            [thr.index(t), sample, int(taxon), int(c)]
            for t, per_sample in counts.items()
            for sample, agg in per_sample.items()
            for taxon, c in agg.items()
        ]
        merged = {t: {} for t in thr}
        for proc_rows in allgather_objects(rows):
            for ti, sample, taxon, c in proc_rows:
                agg = merged[thr[ti]].setdefault(sample, {})
                agg[taxon] = agg.get(taxon, 0) + c
        if self.ctx.process_index == 0:
            return super()._write_reports(merged, output_location, cpar)
        return {t: sorted(per.keys()) for t, per in merged.items()}


def report_counts_across_hosts(local_counts: np.ndarray) -> np.ndarray:
    """Sum per-taxon report counts over all hosts (psum over DCN; the only
    cross-host traffic in replicated classification). Host-level numpy
    fallback when not distributed."""
    import jax

    if jax.process_count() == 1:
        return np.asarray(local_counts)
    from jax.experimental import multihost_utils

    return np.asarray(
        multihost_utils.process_allgather(np.asarray(local_counts)).sum(axis=0)
    )
