"""Two-step dynamic classification (reference: Dynamic.scala).

Step 1: detect a taxon set present in the sample, by one of three criteria
(total minimizer hits, distinct minimizer hits, or classified read counts
against the base index). Step 2: build a sample-tailored index restricted to
that taxon set (plus descendants) from the genome library and classify all
reads against it.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from functools import partial
from typing import Dict, List, Optional, Sequence, Set, Tuple

import jax
import numpy as np

from .classify import Classifier, ClassifyParams, Fragment, default_probe
from .index import KeyValueIndex
from .ops import encode, u64
from .ops import lookup as lookup_ops
from .ops.minimizers import window_minimizers
from .report import TreeAggregator
from .taxonomy import Taxonomy


@dataclass(frozen=True)
class MinimizerTotalCount:
    """Include taxa with >= threshold total minimizer hits (Dynamic.scala:34)."""

    threshold: int


@dataclass(frozen=True)
class MinimizerDistinctCount:
    """Include taxa with >= threshold distinct minimizer hits (Dynamic.scala:37)."""

    threshold: int


@dataclass(frozen=True)
class ClassifiedReadCount:
    """Include taxa with >= threshold classified reads at the given
    confidence (Dynamic.scala:41)."""

    threshold: int
    confidence: float


@dataclass(frozen=True)
class MinimizerFraction:
    """Include taxa whose clade-aggregated distinct minimizer hits cover
    >= threshold fraction of the clade's minimizers in the index.

    The reference DECLARES this criterion (Dynamic.scala:43) but leaves its
    counting method unimplemented (`???`, Dynamic.scala:255); these are this
    framework's semantics, chosen to be self-consistent: the numerator is
    the sample's distinct (minimizer, LCA taxon) hit count, the denominator
    the index's minimizer count per LCA taxon, both clade-aggregated with
    TreeAggregator — so a clade is kept when the sample has touched at least
    `threshold` of the index content that can possibly vote for it."""

    threshold: float


@dataclass
class GoldSetOptions:
    """User-supplied gold taxon set (Dynamic.scala:62)."""

    taxon_file: str
    promote_rank_depth: Optional[int]
    classify_with: bool


def criteria_from_args(args):
    if getattr(args, "min_count", None):
        return MinimizerTotalCount(args.min_count)
    if getattr(args, "reads", None):
        return ClassifiedReadCount(args.reads, args.init_confidence)
    if getattr(args, "min_distinct", None):
        return MinimizerDistinctCount(args.min_distinct)
    if getattr(args, "min_fraction", None):
        return MinimizerFraction(args.min_fraction)
    return ClassifiedReadCount(100, getattr(args, "init_confidence", 0.15))


from .utils import Timer  # noqa: E402  (named-task timers, utils.py)


class Dynamic:
    """Two-step classification driver (Dynamic.scala:78)."""

    def __init__(
        self,
        base: KeyValueIndex,
        genomes,
        reclassify_rank_depth: int,
        criteria,
        cpar: ClassifyParams,
        gold: Optional[GoldSetOptions],
        output_location: str,
        devices: Optional[int] = None,
        layout: Optional[str] = None,
        probe: Optional[str] = None,
    ):
        self.base = base
        self.genomes = genomes
        self.rank_depth = reclassify_rank_depth
        self.criteria = criteria
        self.cpar = cpar
        self.gold = gold
        self.output = output_location
        # mesh distribution for BOTH steps (the reference runs every step of
        # the 2-step pipeline as a distributed Spark job, Dynamic.scala:320-354):
        # step-1 counting kernels, the dynamic index build, and the final
        # classification all honor devices/layout/probe.
        self.devices = devices
        self.layout = layout
        self.probe = probe

    def _use_mesh(self) -> bool:
        if self.devices is None and self.layout is None:
            return False
        n = self.devices or len(jax.devices())
        return not (n == 1 and self.layout in (None, "replicated"))

    def _make_classifier(self, idx: KeyValueIndex) -> Classifier:
        from .parallel.classifier import make_classifier

        return make_classifier(idx, self.devices, self.layout, probe=self.probe)

    @property
    def taxonomy(self) -> Taxonomy:
        return self.base.taxonomy

    # -- counting methods (Dynamic.scala:95-142) ----------------------------

    def _span_hits(self, fragments: Sequence[Fragment]):
        """Per-span (minimizer key, LCA taxon) pairs against the base index,
        for spans whose taxon is at depth >= the reclassify rank.

        Narrow (m <= 31) indexes return uint64[S] keys; wide indexes return
        uint64[S, 2] (hi word, lo word) rows."""
        idx = self.base
        mp = idx.params.minimizer_params
        wide = idx.wide
        depth_std = self.taxonomy.depth_std
        cls = Classifier(idx, probe=self.probe)
        out_keys: List[np.ndarray] = []
        out_taxa: List[np.ndarray] = []

        use_mesh = self._use_mesh()
        if use_mesh:
            mesh_fn, mesh_args, mesh_n = self._mesh_span_setup()
        # the span kernels follow the Classifier's probe (self.probe, else
        # default_probe); wide indexes have no tiled span kernel: routed
        probe = cls.probe
        for bucket, frags in _bucketize(fragments, cls):
            codes, _ = encode.pack_batch(
                [_concat_pair(f) for f in frags], bucket
            )
            if use_mesh:
                # pad the row count to a power of two AND a multiple of the
                # mesh size (padded rows are all-INVALID: no valid spans)
                b_fixed = 8
                while b_fixed < codes.shape[0]:
                    b_fixed *= 2
                b_fixed = -(-b_fixed // mesh_n) * mesh_n
                if codes.shape[0] < b_fixed:
                    pad = np.full(
                        (b_fixed - codes.shape[0], bucket), encode.INVALID, np.uint8
                    )
                    codes = np.concatenate([codes, pad], axis=0)
                outs = mesh_fn(codes, *mesh_args)
            elif probe == "hashed1":
                table, tile, rb = idx.device_hashed_rows
                kernel = (
                    _span_hits_kernel_hashed1_wide if wide
                    else _span_hits_kernel_hashed1
                )
                outs = kernel(
                    codes, table, mp, tile, rb, idx.key_bits, idx.device_lut
                )
            elif wide:
                outs = _span_hits_kernel_wide(
                    codes, idx.device_keys, idx.device_taxa,
                    idx.device_router, mp, idx.router_rounds,
                    idx.router_bits, idx.key_bits, idx.device_lut,
                )
            elif probe == "tiled":
                table, tile = idx.device_tiled
                outs = _span_hits_kernel_tiled(
                    codes, table, idx.device_router, mp, tile,
                    idx.router_bits, idx.key_bits, idx.device_lut,
                )
            else:
                outs = _span_hits_kernel(
                    codes,
                    idx.device_keys.hi,
                    idx.device_keys.lo,
                    idx.device_taxa,
                    idx.device_router,
                    mp,
                    idx.router_rounds,
                    idx.router_bits,
                    idx.key_bits,
                    idx.device_lut,
                )
            starts = np.asarray(outs[-2])
            taxa = np.asarray(outs[-1])
            rows, cols = np.nonzero(starts)
            if wide:
                l3, l2, l1, l0 = (np.asarray(x) for x in outs[:4])
                khi = (
                    l3[rows, cols].astype(np.uint64) << np.uint64(32)
                ) | l2[rows, cols]
                klo = (
                    l1[rows, cols].astype(np.uint64) << np.uint64(32)
                ) | l0[rows, cols]
                keys = np.stack([khi, klo], axis=1)
            else:
                hi, lo = np.asarray(outs[0]), np.asarray(outs[1])
                keys = (
                    hi[rows, cols].astype(np.uint64) << np.uint64(32)
                ) | lo[rows, cols]
            t = taxa[rows, cols]
            keep = (t > 0) & (depth_std[np.clip(t, 0, len(depth_std) - 1)] >= self.rank_depth)
            out_keys.append(keys[keep])
            out_taxa.append(t[keep])
        if not out_keys:
            return (
                np.zeros((0, 2) if wide else 0, np.uint64),
                np.zeros(0, np.int32),
            )
        return np.concatenate(out_keys), np.concatenate(out_taxa)

    def _mesh_span_setup(self):
        """Build the mesh span-hit fn + committed index args for _span_hits,
        mirroring MeshClassifier's probe/arg packaging (parallel/classifier.py)
        so step-1 counting runs the same layouts as classification."""
        from jax.sharding import NamedSharding, PartitionSpec as P

        from .parallel import mesh as pmesh

        idx = self.base
        mp = idx.params.minimizer_params
        mesh_ = pmesh.make_mesh(self.devices)
        n = mesh_.devices.size
        layout = self.layout or "replicated"
        probe = self.probe or default_probe(idx)
        if idx.wide:
            return self._mesh_span_setup_wide(idx, mp, mesh_, n, layout, probe)

        # device tables are passed as-is: jax.device_put reshards committed
        # arrays without the d2h round-trip an np.asarray would force (the
        # hashed1 table is up to GBs)
        if layout == "replicated":
            if probe == "hashed":
                table, tile, hbits = idx.device_hashed
                fn = pmesh.span_hits_replicated_fn(
                    mesh_, mp, idx.router_rounds, idx.router_bits,
                    probe=("hashed", tile, hbits), key_bits=idx.key_bits,
                    lut=idx.device_lut,
                )
                args = (table, np.zeros(2, np.int32))
            elif probe == "hashed1":
                table, tile, rb = idx.device_hashed_rows
                fn = pmesh.span_hits_replicated_fn(
                    mesh_, mp, idx.router_rounds, idx.router_bits,
                    probe=("hashed1", tile, rb), key_bits=idx.key_bits,
                    lut=idx.device_lut,
                )
                args = (table, np.zeros(2, np.int32))
            elif probe == "tiled":
                table, tile = idx.device_tiled
                fn = pmesh.span_hits_replicated_fn(
                    mesh_, mp, idx.router_rounds, idx.router_bits,
                    probe=("tiled", tile), key_bits=idx.key_bits,
                    lut=idx.device_lut,
                )
                args = (table, idx.device_router)
            else:
                fn = pmesh.span_hits_replicated_fn(
                    mesh_, mp, idx.router_rounds, idx.router_bits,
                    key_bits=idx.key_bits, lut=idx.device_lut,
                )
                keys = np.asarray(idx.keys, np.uint64)
                args = (
                    (keys >> np.uint64(32)).astype(np.uint32),
                    keys.astype(np.uint32),
                    np.asarray(idx.taxa, np.int32),
                    np.asarray(idx.device_router),
                )
            specs = [P()] * len(args)
        else:
            sk, st = pmesh.shard_index_by_range(
                np.asarray(idx.keys, np.uint64), np.asarray(idx.taxa, np.int32), n
            )
            routers, rounds, bits = pmesh.shard_routers(sk, idx.key_bits)
            if probe == "hashed":
                tables, tile, hbits = pmesh.shard_hashed_tables(sk, st)
                fn = pmesh.span_hits_ring_fn(
                    mesh_, mp, rounds, bits, probe=("hashed", tile, hbits),
                    key_bits=idx.key_bits, lut=idx.device_lut,
                )
                args = (tables, np.zeros((n, 2), np.int32))
            elif probe == "hashed1":
                tables, tile, rb = pmesh.shard_hashed1_tables(sk, st)
                fn = pmesh.span_hits_ring_fn(
                    mesh_, mp, rounds, bits, probe=("hashed1", tile, rb),
                    key_bits=idx.key_bits, lut=idx.device_lut,
                )
                args = (tables, np.zeros((n, 2), np.int32))
            elif probe == "tiled":
                tables, tile = pmesh.shard_tiled_tables(sk, st, routers)
                fn = pmesh.span_hits_ring_fn(
                    mesh_, mp, rounds, bits, probe=("tiled", tile),
                    key_bits=idx.key_bits, lut=idx.device_lut,
                )
                args = (tables, routers)
            else:
                fn = pmesh.span_hits_ring_fn(
                    mesh_, mp, rounds, bits, key_bits=idx.key_bits,
                    lut=idx.device_lut,
                )
                args = (
                    (sk >> np.uint64(32)).astype(np.uint32),
                    sk.astype(np.uint32),
                    st,
                    routers,
                )
            specs = [P("data")] * len(args)
        args = tuple(
            jax.device_put(a, NamedSharding(mesh_, s)) for a, s in zip(args, specs)
        )
        return fn, args, n

    def _mesh_span_setup_wide(self, idx, mp, mesh_, n, layout, probe):
        """_mesh_span_setup for wide (m > 31) indexes: the span-hit kernels
        carry 4-limb minimizers, mirroring MeshClassifier's wide probe
        packaging (reference classify2 has no m restriction,
        Slacken.scala:242-260)."""
        from jax.sharding import NamedSharding, PartitionSpec as P

        from .parallel import mesh as pmesh

        # map the narrow probe names onto their wide variants (same rule as
        # Classifier's auto probe: hashed has no wide layout)
        probe = {
            "routed": "routed_wide", "tiled": "tiled_wide",
            "hashed1": "hashed1_wide", "routed_wide": "routed_wide",
            "tiled_wide": "tiled_wide", "hashed1_wide": "hashed1_wide",
        }.get(probe)
        if probe is None:
            raise ValueError(
                "wide classify2 mesh probes: routed, tiled or hashed1"
            )
        kb = idx.key_bits
        if layout == "replicated":
            if probe == "hashed1_wide":
                table, tile, rb = idx.device_hashed_rows
                fn = pmesh.span_hits_replicated_fn(
                    mesh_, mp, 0, 0, probe=("hashed1_wide", tile, rb),
                    key_bits=kb, lut=idx.device_lut,
                )
                args = (table, np.zeros(2, np.int32))
            elif probe == "tiled_wide":
                table, tile = idx.device_tiled
                fn = pmesh.span_hits_replicated_fn(
                    mesh_, mp, idx.router_rounds, idx.router_bits,
                    probe=("tiled_wide", tile), key_bits=kb,
                    lut=idx.device_lut,
                )
                args = (table, idx.device_router)
            else:
                fn = pmesh.span_hits_replicated_fn(
                    mesh_, mp, idx.router_rounds, idx.router_bits,
                    probe=("routed_wide",), key_bits=kb, lut=idx.device_lut,
                )
                k2 = np.ascontiguousarray(idx.keys, np.uint64)
                args = (
                    (k2[:, 0] >> np.uint64(32)).astype(np.uint32),
                    k2[:, 0].astype(np.uint32),
                    (k2[:, 1] >> np.uint64(32)).astype(np.uint32),
                    k2[:, 1].astype(np.uint32),
                    np.asarray(idx.taxa, np.int32),
                    np.asarray(idx.device_router),
                )
            specs = [P()] * len(args)
        else:
            sk2, st = pmesh.shard_index_by_range_wide(
                np.ascontiguousarray(idx.keys, np.uint64),
                np.asarray(idx.taxa, np.int32), n, kb,
            )
            routers, rounds, bits = pmesh.shard_routers_wide(sk2, kb)
            if probe == "hashed1_wide":
                tables, tile, rb = pmesh.shard_hashed1_tables_wide(sk2, st, kb)
                fn = pmesh.span_hits_ring_fn(
                    mesh_, mp, 1, 0, probe=("hashed1_wide", tile, rb),
                    key_bits=kb, lut=idx.device_lut,
                )
                args = (tables, np.zeros((n, 2), np.int32))
            elif probe == "tiled_wide":
                tables, tile = pmesh.shard_tiled_tables_wide(sk2, st, routers)
                fn = pmesh.span_hits_ring_fn(
                    mesh_, mp, rounds, bits, probe=("tiled_wide", tile),
                    key_bits=kb, lut=idx.device_lut,
                )
                args = (tables, routers)
            else:
                fn = pmesh.span_hits_ring_fn(
                    mesh_, mp, rounds, bits, probe=("routed_wide",),
                    key_bits=kb, lut=idx.device_lut,
                )
                args = (
                    (sk2[:, :, 0] >> np.uint64(32)).astype(np.uint32),
                    sk2[:, :, 0].astype(np.uint32),
                    (sk2[:, :, 1] >> np.uint64(32)).astype(np.uint32),
                    sk2[:, :, 1].astype(np.uint32),
                    st, routers,
                )
            specs = [P("data")] * len(args)
        args = tuple(
            jax.device_put(a, NamedSharding(mesh_, s)) for a, s in zip(args, specs)
        )
        return fn, args, n

    def total_minimizers_per_taxon(self, fragments) -> Dict[int, int]:
        _, taxa = self._span_hits(fragments)
        t, c = np.unique(taxa, return_counts=True)
        return dict(zip(t.tolist(), c.tolist()))

    def distinct_minimizers_per_taxon(self, fragments) -> Dict[int, int]:
        keys, taxa = self._span_hits(fragments)
        if keys.ndim == 2:  # wide: [S, 2] u64 key rows
            cols = np.concatenate([keys, taxa[:, None].astype(np.uint64)], axis=1)
        else:
            cols = np.stack([keys, taxa.astype(np.uint64)], axis=1)
        pairs = np.unique(cols, axis=0)
        t, c = np.unique(pairs[:, -1].astype(np.int64), return_counts=True)
        return dict(zip(t.tolist(), c.tolist()))

    def classified_reads_per_taxon(self, fragments, confidence: float) -> Dict[int, int]:
        cls = self._make_classifier(self.base)
        cpar = ClassifyParams(
            min_hit_groups=self.cpar.min_hit_groups,
            thresholds=[confidence],
            per_read_output=False,
        )
        reads = cls.classify(fragments, cpar)[confidence]
        counts: Dict[int, int] = {}
        for r in reads:
            if r.classified:
                counts[r.taxon] = counts.get(r.taxon, 0) + 1
        return counts

    # -- taxon set detection (Dynamic.scala:189-280) ------------------------

    def count_filter(self, counts: Dict[int, int], threshold: int) -> Set[int]:
        """Clade-aggregated counts >= threshold at depth >= rank
        (CountFilter, Dynamic.scala:191-201)."""
        agg = TreeAggregator(self.taxonomy, counts.items())
        return {
            t
            for t in agg.clade_totals
            if self.taxonomy.depth(t) >= self.rank_depth
            and agg.clade_totals[t] >= threshold
        }

    def fraction_filter(self, counts: Dict[int, int], threshold: float) -> Set[int]:
        """Clade hit fraction of the clade's index minimizers >= threshold
        at depth >= rank (the MinimizerFraction criterion — see its
        docstring; the reference declares but never implements it,
        Dynamic.scala:255)."""
        tax = self.taxonomy
        hits = TreeAggregator(tax, counts.items()).clade_totals
        t, c = np.unique(self.base.taxa, return_counts=True)
        denom = TreeAggregator(tax, zip(t.tolist(), c.tolist())).clade_totals
        return {
            x
            for x, h in hits.items()
            if tax.depth(x) >= self.rank_depth
            and h >= threshold * denom.get(x, float("inf"))
        }

    def find_taxon_set(self, fragments, write_location: Optional[str] = None) -> Set[int]:
        t = Timer("Find taxon set in subjects")
        c = self.criteria
        if isinstance(c, MinimizerTotalCount):
            counts = self.total_minimizers_per_taxon(fragments)
            keep = self.count_filter(counts, c.threshold)
        elif isinstance(c, MinimizerDistinctCount):
            counts = self.distinct_minimizers_per_taxon(fragments)
            keep = self.count_filter(counts, c.threshold)
        elif isinstance(c, MinimizerFraction):
            counts = self.distinct_minimizers_per_taxon(fragments)
            keep = self.fraction_filter(counts, c.threshold)
        elif isinstance(c, ClassifiedReadCount):
            counts = self.classified_reads_per_taxon(fragments, c.confidence)
            keep = self.count_filter(counts, c.threshold)
        else:
            raise ValueError(f"Unsupported criterion {c}")

        if write_location:
            os.makedirs(os.path.dirname(write_location) or ".", exist_ok=True)
            with open(write_location, "w") as f:
                for x in sorted(keep):
                    f.write(f"{x}\n")

        if self.gold is not None:
            gold_set = self.read_gold_set()
            tp = len(keep & gold_set)
            fp = len(keep - gold_set)
            fn = len(gold_set - keep)
            prec = tp / (tp + fp) if tp + fp else 0.0
            rec = tp / len(gold_set) if gold_set else 0.0
            print(
                f"Comparing detected set with supplied gold set. True Positives: {tp}, "
                f"False Positives: {fp}, False Negatives: {fn}, "
                f"Precision: {prec * 100:.2f}%, Recall: {rec * 100:.2f}%"
            )

        with_desc = self.taxonomy.taxa_with_descendants(keep)
        t.finish()
        print(
            f"Detected set: initial scan (criterion {c}) produced {len(keep)} taxa, "
            f"expanded with descendants to {len(with_desc)}"
        )
        return with_desc

    def read_gold_set(self) -> Set[int]:
        """Read + canonicalise the gold set, promoting taxa missing from the
        library up their lineage (Dynamic.scala:284-312)."""
        tax = self.taxonomy
        with open(self.gold.taxon_file) as f:
            gold = {
                int(tax.primary[int(line.strip().split(",")[0])])
                for line in f
                if line.strip()
            }
        print(f"Gold set contained {len(gold)} taxa")
        lib_set = self.genomes.taxon_set(tax)
        not_found = gold - lib_set
        promoted = set()
        for t in not_found:
            for p in tax.path_to_root(t):
                if p in lib_set:
                    promoted.add(p)
                    break
        print(f"{len(not_found)} taxa from gold set not found in library, promoted to {len(promoted)} taxa.")
        if self.gold.promote_rank_depth is not None:
            kept_promoted = {t for t in promoted if tax.depth(t) >= self.gold.promote_rank_depth}
        else:
            kept_promoted = set()
        total = gold | promoted
        filtered = {t for t in total if tax.depth(t) >= self.rank_depth} | kept_promoted
        print(f"Initial adjusted gold set size {len(total)}, filtered to {len(filtered)}")
        return filtered

    # -- two-step pipeline (Dynamic.scala:320-374) --------------------------

    def make_records(self, fragments) -> Tuple[KeyValueIndex, Set[int]]:
        if self.gold is not None and self.gold.classify_with:
            taxon_set = self.taxonomy.taxa_with_descendants(self.read_gold_set())
        else:
            taxon_set = self.find_taxon_set(fragments, self.output + "_taxonSet.txt")

        t = Timer("Build dynamic index")
        if self.base.record_keys is not None:
            # fast path: filter + re-reduce the base index's full records
            dynamic = self.base.build_restricted(taxon_set)
        elif self._use_mesh():
            from .parallel.classifier import build_distributed

            dynamic = build_distributed(
                self.genomes.taxa_sequences(),
                self.base.params,
                self.taxonomy,
                n_devices=self.devices,
                taxon_filter=taxon_set,
                ordering_lut=self.base.ordering_lut,
            )
        else:
            dynamic = KeyValueIndex.build(
                self.genomes.taxa_sequences(),
                self.base.params,
                self.taxonomy,
                taxon_filter=taxon_set,
                ordering_lut=self.base.ordering_lut,
            )
        t.finish()
        return dynamic, taxon_set

    def two_step_classify_and_write(
        self,
        fragments,
        dynamic_reports: bool = False,
        bracken_read_length: Optional[int] = None,
        packed_factory=None,
    ):
        """fragments: a sequence of Fragments, or a zero-arg callable
        returning a fresh iterator (streaming mode — reads are re-read for
        each of the two passes instead of being held in memory, like the
        reference re-evaluating its reads Dataset, Dynamic.scala:320-324).

        packed_factory: optional zero-arg callable yielding native
        PackedReads batches for the SAME reads — the final classification
        then takes the fast streaming path (classify_and_write_packed, the
        same writer the 1-step CLI uses)."""
        if callable(fragments):
            factory = fragments
        else:
            frags_list = list(fragments)
            factory = lambda: iter(frags_list)
        dynamic_index, used_taxa = self.make_records(factory())
        print(f"Dynamic index: {len(dynamic_index.keys)} records, {len(used_taxa)} taxa")

        if dynamic_reports:
            from .stats import write_inspect_reports

            write_inspect_reports(dynamic_index, self.output + "_dynamic")

        if bracken_read_length:
            from .bracken import BrackenWeights

            t = Timer("Build library and Bracken weights")
            bw = BrackenWeights(dynamic_index, bracken_read_length)
            os.makedirs(self.output, exist_ok=True)
            bw.build_and_write_weights(
                self.genomes,
                used_taxa,
                os.path.join(self.output, f"database{bracken_read_length}mers.kmer_distrib"),
            )
            t.finish()

        t = Timer("Classify reads")
        cls = self._make_classifier(dynamic_index)
        if packed_factory is not None:
            cls.classify_and_write_packed(packed_factory(), self.output, self.cpar)
        else:
            cls.classify_and_write(factory(), self.output, self.cpar)
        t.finish()
        return dynamic_index


# ---------------------------------------------------------------------------


@partial(jax.jit, static_argnums=(5, 6, 7, 8))
def _span_hits_kernel(
    codes, keys_hi, keys_lo, key_taxa, router, mp, rounds, bits, key_bits=62, lut=None
):
    wm = window_minimizers(codes, mp, lut)
    looked = lookup_ops.lookup_taxa_routed(
        u64.U64(keys_hi, keys_lo), key_taxa, router, wm.minimizer, rounds, bits,
        key_bits,
    )
    return wm.minimizer.hi, wm.minimizer.lo, wm.span_start & wm.valid, looked


@partial(jax.jit, static_argnums=(3, 4, 5, 6))
def _span_hits_kernel_tiled(
    codes, table, router, mp, tile, bits, key_bits=62, lut=None
):
    """_span_hits_kernel with the tiled row-gather probe (bit-identical to
    the routed variant)."""
    wm = window_minimizers(codes, mp, lut)
    looked = lookup_ops.lookup_taxa_tiled(
        table, router, wm.minimizer, tile, bits, key_bits
    )
    return wm.minimizer.hi, wm.minimizer.lo, wm.span_start & wm.valid, looked


@partial(jax.jit, static_argnums=(2, 3, 4, 5))
def _span_hits_kernel_hashed1(
    codes, table, mp, tile, row_bits, key_bits=62, lut=None
):
    """_span_hits_kernel with the single-gather row-bucket probe (the GPU
    path; bit-identical to the routed variant)."""
    wm = window_minimizers(codes, mp, lut)
    looked = lookup_ops.lookup_taxa_hashed_rows(
        table, wm.minimizer, tile, row_bits, key_bits
    )
    return wm.minimizer.hi, wm.minimizer.lo, wm.span_start & wm.valid, looked


@partial(jax.jit, static_argnums=(4, 5, 6, 7))
def _span_hits_kernel_wide(
    codes, keys, key_taxa, router, mp, rounds, bits, key_bits, lut=None
):
    """_span_hits_kernel for wide (m > 31) indexes: 4-limb minimizers
    probed against the routed [N, 2]-u64 key array. Returns the four
    minimizer limb arrays (l3..l0, most significant first), span starts and
    looked-up taxa."""
    wm = window_minimizers(codes, mp, lut)
    looked = lookup_ops.lookup_taxa_routed_wide(
        keys, key_taxa, router, wm.minimizer, rounds, bits, key_bits
    )
    return wm.minimizer.limbs + (wm.span_start & wm.valid, looked)


@partial(jax.jit, static_argnums=(2, 3, 4, 5))
def _span_hits_kernel_hashed1_wide(
    codes, table, mp, tile, row_bits, key_bits, lut=None
):
    """_span_hits_kernel_wide with the single-gather row-bucket probe."""
    wm = window_minimizers(codes, mp, lut)
    looked = lookup_ops.lookup_taxa_hashed_rows_wide(
        table, wm.minimizer, tile, row_bits, key_bits
    )
    return wm.minimizer.limbs + (wm.span_start & wm.valid, looked)


def _concat_pair(f: Fragment):
    c1 = encode.encode_seq(f.seq)
    if f.seq2 is None:
        return c1
    return np.concatenate([c1, np.array([encode.INVALID], np.uint8), encode.encode_seq(f.seq2)])


def _bucketize(fragments: Sequence[Fragment], cls: Classifier):
    pending: Dict[int, List[Fragment]] = {}
    for f in fragments:
        n = len(f.seq) + (len(f.seq2) + 1 if f.seq2 is not None else 0)
        bucket = cls._row_length_bucket(n)
        lst = pending.setdefault(bucket, [])
        lst.append(f)
        if len(lst) >= max(8, cls.target_batch_bp // bucket):
            yield bucket, lst
            pending[bucket] = []
    for bucket, lst in pending.items():
        if lst:
            yield bucket, lst
