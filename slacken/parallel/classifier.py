"""Multi-chip classification and index build, wired into the product path.

`MeshClassifier` is a drop-in `Classifier` whose device dispatch runs over a
`jax.sharding.Mesh` (replicated or ring-sharded index — see parallel/mesh.py
for the layouts). Every host-side feature of the single-chip pipeline —
packed batching, pipelining, multi-threshold finalisation, per-read output,
reports — is inherited unchanged, so CLI `classify --devices N` produces
byte-identical outputs to the single-device run (the reference's equivalent
"product path" is the Spark job itself, KeyValueIndex.scala:150-159).

`build_distributed` is the production consumer of `mesh.build_shuffle_fn`:
genome batches are scanned, range-partitioned, exchanged with all_to_all and
deduplicated on the mesh; the host only merges the per-device distinct record
streams (KeyValueIndex.scala:85-93's shuffle + groupBy/LCA equivalent).
"""

from __future__ import annotations

from typing import Iterable, Optional, Tuple

import numpy as np

from ..classify import Classifier
from ..index import (
    IndexParams,
    KeyValueIndex,
    RecordCollector,
    SpillCollector,
    dedup_pairs,
    dedup_pairs_wide,
    reduce_records,
    reduce_records_wide,
    spans_to_records,
    spans_to_records_wide,
)
from ..ops import encode
from ..taxonomy import Taxonomy
from . import mesh as pmesh

LAYOUTS = ("replicated", "ring")


class MeshClassifier(Classifier):
    """Classifier running its device kernel over an n-device mesh.

    layout='replicated': index copied to every chip's HBM, reads sharded.
    layout='ring': index range-sharded; queries rotate the ring via ppermute.
    """

    def __init__(
        self,
        index: KeyValueIndex,
        n_devices: Optional[int] = None,
        layout: str = "replicated",
        **kwargs,
    ):
        super().__init__(index, **kwargs)
        if layout not in LAYOUTS:
            raise ValueError(f"layout must be one of {LAYOUTS}, got {layout!r}")
        self.mesh = pmesh.make_mesh(n_devices)
        self.n_devices = self.mesh.devices.size
        self.layout = layout
        mp = index.params.minimizer_params
        table = np.asarray(self._table_dev)
        if layout == "replicated":
            # inherit the single-chip probe choice (tiled/hashed fast paths
            # and the wide-key probes carry over unchanged)
            ps = self._probe_static
            if ps[0] == "tiled_wide":
                self._mesh_fn = pmesh.classify_replicated_fn(
                    self.mesh, mp, self.max_taxa,
                    index.router_rounds, index.router_bits,
                    probe=("tiled_wide", ps[1]), key_bits=index.key_bits,
                )
                self._mesh_args = (
                    np.asarray(index.device_tiled[0]),
                    np.asarray(index.device_router),
                    table,
                )
            elif ps[0] == "hashed1_wide":
                # routerless: never build/upload the wide router
                self._mesh_fn = pmesh.classify_replicated_fn(
                    self.mesh, mp, self.max_taxa, 0, 0,
                    probe=ps, key_bits=index.key_bits,
                )
                self._mesh_args = (
                    index.device_hashed_rows[0],
                    np.zeros(2, np.int32),  # routerless dummy
                    table,
                )
            elif ps[0] == "routed_wide":
                self._mesh_fn = pmesh.classify_replicated_fn(
                    self.mesh, mp, self.max_taxa,
                    index.router_rounds, index.router_bits,
                    probe=("routed_wide",), key_bits=index.key_bits,
                )
                k2 = np.ascontiguousarray(index.keys, np.uint64)
                self._mesh_args = (
                    (k2[:, 0] >> np.uint64(32)).astype(np.uint32),
                    k2[:, 0].astype(np.uint32),
                    (k2[:, 1] >> np.uint64(32)).astype(np.uint32),
                    k2[:, 1].astype(np.uint32),
                    np.asarray(index.taxa, np.int32),
                    np.asarray(index.device_router),
                    table,
                )
            elif ps[0] in ("tiled", "hashed", "hashed1"):
                self._mesh_fn = pmesh.classify_replicated_fn(
                    self.mesh, mp, self.max_taxa,
                    index.router_rounds, index.router_bits, probe=ps,
                    key_bits=index.key_bits, lut=index.device_lut,
                )
                # device tables pass through as-is — device_put reshards a
                # committed array without forcing a d2h round-trip
                if ps[0] == "hashed":
                    ptable = index.device_hashed[0]
                    router = np.zeros(2, np.int32)  # routerless dummy
                elif ps[0] == "hashed1":
                    ptable = index.device_hashed_rows[0]
                    router = np.zeros(2, np.int32)  # routerless dummy
                else:
                    ptable = index.device_tiled[0]
                    router = index.device_router
                self._mesh_args = (ptable, router, table)
            else:
                self._mesh_fn = pmesh.classify_replicated_fn(
                    self.mesh, mp, self.max_taxa,
                    index.router_rounds, index.router_bits,
                    key_bits=index.key_bits, lut=index.device_lut,
                )
                keys = np.asarray(index.keys, np.uint64)
                self._mesh_args = (
                    (keys >> np.uint64(32)).astype(np.uint32),
                    keys.astype(np.uint32),
                    np.asarray(index.taxa, np.int32),
                    np.asarray(index.device_router),
                    table,
                )
        elif index.wide:
            sk2, st = pmesh.shard_index_by_range_wide(
                np.ascontiguousarray(index.keys, np.uint64),
                np.asarray(index.taxa, np.int32),
                self.n_devices,
                index.key_bits,
            )
            if self._probe_static[0] == "hashed1_wide":
                # routerless per-shard single-gather tables; shard routers
                # are never built
                tables, tile, rb = pmesh.shard_hashed1_tables_wide(
                    sk2, st, index.key_bits
                )
                self._mesh_fn = pmesh.classify_ring_fn(
                    self.mesh, mp, self.max_taxa, 1, 0,
                    probe=("hashed1_wide", tile, rb),
                    key_bits=index.key_bits,
                )
                dummies = np.zeros((self.n_devices, 2), np.int32)
                self._mesh_args = (tables, dummies, table)
                self._commit_mesh_args(layout)
                return
            routers, rounds, bits = pmesh.shard_routers_wide(sk2, index.key_bits)
            if self._probe_static[0] == "tiled_wide":
                tables, tile = pmesh.shard_tiled_tables_wide(sk2, st, routers)
                self._mesh_fn = pmesh.classify_ring_fn(
                    self.mesh, mp, self.max_taxa, rounds, bits,
                    probe=("tiled_wide", tile), key_bits=index.key_bits,
                )
                self._mesh_args = (tables, routers, table)
            else:
                self._mesh_fn = pmesh.classify_ring_fn(
                    self.mesh, mp, self.max_taxa, rounds, bits,
                    probe=("routed_wide",), key_bits=index.key_bits,
                )
                self._mesh_args = (
                    (sk2[:, :, 0] >> np.uint64(32)).astype(np.uint32),
                    sk2[:, :, 0].astype(np.uint32),
                    (sk2[:, :, 1] >> np.uint64(32)).astype(np.uint32),
                    sk2[:, :, 1].astype(np.uint32),
                    st,
                    routers,
                    table,
                )
        else:
            sk, st = pmesh.shard_index_by_range(
                np.asarray(index.keys, np.uint64), np.asarray(index.taxa, np.int32),
                self.n_devices,
            )
            routers, rounds, bits = pmesh.shard_routers(sk, index.key_bits)
            if self._probe_static[0] == "hashed" and not index.wide:
                # per-shard aligned-row hashed tables (routerless)
                tables, tile, hbits = pmesh.shard_hashed_tables(sk, st)
                self._mesh_fn = pmesh.classify_ring_fn(
                    self.mesh, mp, self.max_taxa, rounds, bits,
                    probe=("hashed", tile, hbits), key_bits=index.key_bits,
                    lut=index.device_lut,
                )
                dummies = np.zeros((self.n_devices, 2), np.int32)
                self._mesh_args = (tables, dummies, table)
            elif self._probe_static[0] == "hashed1" and not index.wide:
                # per-shard single-gather row-bucket tables (routerless)
                tables, tile, rb = pmesh.shard_hashed1_tables(sk, st)
                self._mesh_fn = pmesh.classify_ring_fn(
                    self.mesh, mp, self.max_taxa, rounds, bits,
                    probe=("hashed1", tile, rb), key_bits=index.key_bits,
                    lut=index.device_lut,
                )
                dummies = np.zeros((self.n_devices, 2), np.int32)
                self._mesh_args = (tables, dummies, table)
            elif self._probe_static[0] == "tiled" and not index.wide:
                # per-shard tiled row-gather tables
                tables, tile = pmesh.shard_tiled_tables(sk, st, routers)
                self._mesh_fn = pmesh.classify_ring_fn(
                    self.mesh, mp, self.max_taxa, rounds, bits,
                    probe=("tiled", tile), key_bits=index.key_bits,
                    lut=index.device_lut,
                )
                self._mesh_args = (tables, routers, table)
            else:
                self._mesh_fn = pmesh.classify_ring_fn(
                    self.mesh, mp, self.max_taxa, rounds, bits,
                    key_bits=index.key_bits, lut=index.device_lut,
                )
                self._mesh_args = (
                    (sk >> np.uint64(32)).astype(np.uint32),
                    sk.astype(np.uint32),
                    st,
                    routers,
                    table,
                )
        self._commit_mesh_args(layout)

    def _commit_mesh_args(self, layout: str):
        """Commit the index/taxonomy args to the mesh ONCE: passing host
        numpy arrays to the jitted mesh fn would re-upload the whole
        table every batch (a 100+ MB h2d per dispatch on real chips).
        Replicated args use P(); the ring's sharded args use P('data')."""
        import jax
        from jax.sharding import NamedSharding, PartitionSpec as P

        if layout == "replicated":
            specs = [P()] * len(self._mesh_args)
        else:
            # ring: every arg except the trailing rpath_table is sharded
            specs = [P("data")] * (len(self._mesh_args) - 1) + [P()]
        self._mesh_args = tuple(
            jax.device_put(a, NamedSharding(self.mesh, s))
            for a, s in zip(self._mesh_args, specs)
        )

    def _dispatch_codes(self, codes, titles, splits, row_lens):
        bucket = codes.shape[1]
        # pad rows to a power of two AND a multiple of the mesh size so the
        # 'data' axis divides evenly (bounded shape set, like the base class)
        b_fixed = 8
        while b_fixed < codes.shape[0]:
            b_fixed *= 2
        b_fixed = -(-b_fixed // self.n_devices) * self.n_devices
        if codes.shape[0] < b_fixed:
            pad = np.full((b_fixed - codes.shape[0], bucket), encode.INVALID, np.uint8)
            codes = np.concatenate([codes, pad], axis=0)
        window_taxa, num_distinct, ch, res, hostpack, _counts = self._mesh_fn(
            codes, *self._mesh_args
        )
        # shared post-dispatch: device finalize (thresholds known) or the
        # legacy full host bundle — identical glue to the single-chip path
        return self._post_dispatch(
            (window_taxa, num_distinct, ch, res, hostpack),
            codes, titles, splits, row_lens,
        )


def make_classifier(
    index: KeyValueIndex,
    n_devices: Optional[int] = None,
    layout: Optional[str] = None,
    **kwargs,
) -> Classifier:
    """Single-device Classifier unless a mesh is requested (CLI entry)."""
    import jax

    if n_devices is None and layout is None:
        return Classifier(index, **kwargs)
    n = n_devices or len(jax.devices())
    if n == 1 and layout in (None, "replicated"):
        return Classifier(index, **kwargs)
    return MeshClassifier(index, n, layout or "replicated", **kwargs)


# ---------------------------------------------------------------------------
# Distributed build
# ---------------------------------------------------------------------------


def build_distributed(
    fragments: Iterable[Tuple[int, str]],
    params: IndexParams,
    taxonomy: Taxonomy,
    n_devices: Optional[int] = None,
    batch_rows: int = 64,
    row_len: int = 1 << 14,
    taxon_filter: Optional[set] = None,
    keep_records: bool = False,
    spill_dir: Optional[str] = None,
    ordering_lut=None,
) -> KeyValueIndex:
    """Build an index with the device all_to_all shuffle on an n-device mesh.

    Mirrors KeyValueIndex.build's outer loop (fragment batching, overlap
    splitting, taxon filtering) but each batch is scanned, range-partitioned,
    exchanged and pair-deduplicated ON the mesh (mesh.build_shuffle_fn,
    or build_shuffle_fn_wide carrying four u32 key limbs for m > 31); the
    host merges the per-device distinct streams and runs the global
    cross-taxon LCA reduction. Range boundaries are sampled from the first
    batch (Spark RangePartitioner-style) to balance the canonical-min key
    skew. Covers the reference's full m <= 63 envelope
    (KeyValueIndex.scala:85-93 has no m limit).
    """
    mp = params.minimizer_params.validate()
    if mp.wide and params.ordering != "xor":
        raise NotImplementedError("wide explicit orderings are unsupported")
    lut = None
    if params.ordering != "xor":
        import jax
        import jax.numpy as jnp

        from ..ops import ordering as ordering_ops

        if params.ordering == "lexicographic":
            ordering_lut = ordering_ops.lexicographic_lut(params.m)
        elif params.ordering == "signature":
            ordering_lut = ordering_ops.signature_lut(params.m)
        elif ordering_lut is None:
            raise ValueError(
                f"ordering {params.ordering!r} requires an explicit rank LUT"
            )
        with jax.ensure_compile_time_eval():
            lut = jnp.asarray(ordering_lut)
    elif ordering_lut is not None:
        raise ValueError('ordering_lut given but params.ordering == "xor"')
    mesh_ = pmesh.make_mesh(n_devices)
    n = mesh_.devices.size
    if batch_rows % n:
        batch_rows = -(-batch_rows // n) * n
    npos = batch_rows * row_len
    # ~0.35 spans/position expected; quantile boundaries keep ranges balanced,
    # so 1.6x the fair share is generous headroom (overflow falls back to a
    # host-side raw-record scan of the batch)
    cap = int(1.6 * 0.35 * npos / n)

    collector = (
        SpillCollector(spill_dir, m=params.m) if spill_dir else RecordCollector()
    )
    state = {"fn": None}
    buf_seqs, buf_taxa = [], []

    def flush():
        if not buf_seqs:
            return
        codes, _ = encode.pack_batch(buf_seqs, row_len)
        taxa_rows = np.zeros(batch_rows, np.int32)
        taxa_rows[: len(buf_taxa)] = buf_taxa
        if codes.shape[0] < batch_rows:
            pad = np.full(
                (batch_rows - codes.shape[0], row_len), encode.INVALID, np.uint8
            )
            codes = np.concatenate([codes, pad], axis=0)
        if mp.wide:
            if state["fn"] is None:
                bnd = pmesh.sample_shuffle_boundaries_wide(codes, mp, n)
                state["fn"] = pmesh.build_shuffle_fn_wide(
                    mesh_, mp, cap, boundaries=bnd
                )
            l3, l2, l1, l0, tax, counts, ovf = state["fn"](codes, taxa_rows)
            if bool(np.asarray(ovf).any()):
                k2, t = spans_to_records_wide(codes, taxa_rows, mp)
                collector.add(k2, t)
            else:
                l3, l2, l1, l0, tax, counts = (
                    np.asarray(x) for x in (l3, l2, l1, l0, tax, counts)
                )
                for r in range(n):
                    c = int(counts[r])
                    keys_r = np.stack(
                        [
                            (l3[r, :c].astype(np.uint64) << np.uint64(32))
                            | l2[r, :c],
                            (l1[r, :c].astype(np.uint64) << np.uint64(32))
                            | l0[r, :c],
                        ],
                        axis=1,
                    )
                    collector.add(keys_r, tax[r, :c])
            buf_seqs.clear()
            buf_taxa.clear()
            return
        if state["fn"] is None:
            bnd = pmesh.sample_shuffle_boundaries(codes, mp, n, lut)
            state["fn"] = pmesh.build_shuffle_fn(
                mesh_, mp, cap, boundaries=bnd, lut=lut
            )
        hi, lo, tax, counts, ovf = state["fn"](codes, taxa_rows)
        if bool(np.asarray(ovf).any()):
            k, t = spans_to_records(codes, taxa_rows, mp, lut)
            collector.add(k, t)
        else:
            hi, lo, tax, counts = (np.asarray(x) for x in (hi, lo, tax, counts))
            for r in range(n):
                c = int(counts[r])
                keys_r = (hi[r, :c].astype(np.uint64) << np.uint64(32)) | lo[r, :c]
                collector.add(keys_r, tax[r, :c])
        buf_seqs.clear()
        buf_taxa.clear()

    for taxon, seq in fragments:
        taxon = int(taxonomy.primary[taxon]) if taxon < len(taxonomy.primary) else taxon
        if not taxonomy.is_defined(taxon):
            continue
        if taxon_filter is not None and taxon not in taxon_filter:
            continue
        if isinstance(seq, str):
            seq = encode.encode_seq(seq)
        step = row_len - (params.k - 1)
        for off in range(0, max(len(seq) - params.k + 1, 1), step):
            buf_seqs.append(seq[off : off + row_len])
            buf_taxa.append(taxon)
            if len(buf_seqs) >= batch_rows:
                flush()
    flush()

    if spill_dir:
        keys, taxa, recs = collector.reduce(taxonomy, keep_records)
        collector.cleanup()
        idx = KeyValueIndex(keys, taxa, params, taxonomy)
        if recs is not None:
            idx.record_keys, idx.record_taxa = recs
        return idx

    pair_keys, pair_taxa = collector.concat()
    if mp.wide:
        if pair_keys.ndim == 1:  # empty library: concat() default shape
            pair_keys = pair_keys.reshape(0, 2)
        pair_keys, pair_taxa = dedup_pairs_wide(pair_keys, pair_taxa)
        keys, taxa = reduce_records_wide(pair_keys, pair_taxa, taxonomy)
    else:
        pair_keys, pair_taxa = dedup_pairs(pair_keys, pair_taxa)
        keys, taxa = reduce_records(pair_keys, pair_taxa, taxonomy)
    idx = KeyValueIndex(keys, taxa, params, taxonomy)
    if keep_records:
        idx.record_keys = pair_keys
        idx.record_taxa = pair_taxa
    return idx
