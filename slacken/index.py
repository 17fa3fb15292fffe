"""The minimizer-LCA key-value index (reference: KeyValueIndex.scala).

Storage model: one sorted array of uint64 minimizer priorities ("keys") plus
a parallel int32 array of LCA taxa. On disk this is a directory:

    <loc>/params.json       k, m, spaces, toggle mask, canonical, counts
    <loc>/keys.npy          uint64 [N] sorted ascending
    <loc>/taxa.npy          int32  [N]
    <loc>/taxonomy/         nodes.dmp, names.dmp, merged.dmp

(The reference persists bucketed Parquet plus a .properties file —
KeyValueIndex.scala:125-159, IndexParams.scala:63-91. A sorted flat array is
the device equivalent: device lookup is a vectorised binary search, and
range-sharding it across a mesh replaces Spark's hash-bucketed join.)

Build: genome fragments are scanned on device in fixed-shape batches (the
fused kernel sorts and pair-dedups records before they leave the chip); the
host merges batches with a C++ OpenMP radix sort (native.radix_sort_kv) and
hands contiguous runs back to the device for segment-LCA reduction
(KeyValueIndex.scala:85-93's groupBy + LCA-UDAF).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from functools import partial
from typing import Iterable, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .ops import lca as lca_ops
from .ops import lookup as lookup_ops
from .ops import u64
from .ops.minimizers import DEFAULT_TOGGLE_MASK, MinimizerParams, space_mask_int, window_minimizers
from .ops import encode
from . import utils
from . import native
from .taxonomy import Taxonomy
from . import storage

FORMAT_VERSION = 1


@dataclass
class IndexParams:
    k: int = 35
    m: int = 31
    spaces: int = 7
    toggle_mask: int = DEFAULT_TOGGLE_MASK
    canonical: bool = True
    buckets: int = 200  # shard count hint for distributed layouts
    #: minimizer ordering: "xor" (RandomXOR, the Slacken default) or an
    #: explicit rank-table ordering "lexicographic" / "signature" /
    #: "frequency" (MinimizerCLIConf.scala:81-95; ops.ordering). Non-xor orderings
    #: store ranks as keys and persist their LUT beside the index.
    ordering: str = "xor"

    @property
    def minimizer_params(self) -> MinimizerParams:
        return MinimizerParams(
            k=self.k,
            m=self.m,
            spaces=self.spaces,
            toggle_mask=self.toggle_mask,
            canonical=self.canonical,
        )

    def to_json(self) -> dict:
        return {
            "version": FORMAT_VERSION,
            "k": self.k,
            "m": self.m,
            "spaces": self.spaces,
            "toggle_mask": f"{self.toggle_mask:#x}",
            "canonical": self.canonical,
            "buckets": self.buckets,
            "ordering": self.ordering,
        }

    @classmethod
    def from_json(cls, d: dict) -> "IndexParams":
        ver = d.get("version", 0)
        if ver > FORMAT_VERSION:
            raise ValueError(f"Unsupported index format version {ver}")
        return cls(
            k=d["k"],
            m=d["m"],
            spaces=d["spaces"],
            toggle_mask=int(d["toggle_mask"], 16),
            canonical=d["canonical"],
            buckets=d.get("buckets", 200),
            ordering=d.get("ordering", "xor"),
        )

    def compatibility_check(self, other: "IndexParams"):
        if (self.k, self.m, self.spaces, self.toggle_mask, self.canonical, self.ordering) != (
            other.k,
            other.m,
            other.spaces,
            other.toggle_mask,
            other.canonical,
            other.ordering,
        ):
            raise ValueError(f"Incompatible index parameters: {self} vs {other}")


# ---------------------------------------------------------------------------
# Device scan: genome fragments -> (minimizer, taxon) records
# ---------------------------------------------------------------------------


#: Device bytes per entry of the build's resident merge tree: 12 B of
#: record data, a few times that in lax.sort transients when the final two
#: leaves merge, and headroom for the other live arrays. A stated ratio,
#: not measured at its bound.
BUILD_BYTES_PER_ENTRY = 320
#: Resident merge-tree bound on the CPU backend, whose "device" memory is
#: host RAM (device builds run there only when STPU_BUILD_DEVICE=1 forces
#: them).
CPU_BUILD_BUDGET_ENTRIES = 48 << 20


def device_build_budget_entries() -> int:
    """Entries a device-resident build may hold before it spills leaves to
    the host: the device's memory limit over BUILD_BYTES_PER_ENTRY."""
    if utils.backend() == "cpu":
        return CPU_BUILD_BUDGET_ENTRIES
    return utils.device_memory_bytes() // BUILD_BYTES_PER_ENTRY


@partial(jax.jit, static_argnums=(1,))
def _scan_batch(codes, params: MinimizerParams, lut=None):
    wm = window_minimizers(codes, params, lut)
    return wm.minimizer.hi, wm.minimizer.lo, wm.span_start


@partial(jax.jit, static_argnums=(2, 3))
def _build_batch_kernel(codes, taxa_rows, params: MinimizerParams, cap: int, lut=None):
    """Fused build step on device: minimizer scan -> flatten span records ->
    sort by (key, taxon) -> pair-dedup -> compacted distinct records.

    Only distinct (key, taxon) pairs leave the device (the reference ships
    every raw record through a Spark shuffle; here the chip sorts and
    deduplicates its whole batch locally and the host merges sorted runs).
    The cross-taxon LCA reduction happens once, globally, in reduce_records."""
    wm = window_minimizers(codes, params, lut)
    b, l = codes.shape
    n = b * l
    hi = wm.minimizer.hi.reshape(n)
    lo = wm.minimizer.lo.reshape(n)
    start = wm.span_start.reshape(n)
    taxon = jnp.broadcast_to(jnp.asarray(taxa_rows, jnp.int32)[:, None], (b, l)).reshape(n)

    # sentinel-key invalid entries sort to the end (real keys are <= 62 bits)
    sent = jnp.uint32(0xFFFFFFFF)
    khi = jnp.where(start, hi, sent)
    klo = jnp.where(start, lo, sent)
    ktax = jnp.where(start, taxon, 0)
    shi, slo, stax = jax.lax.sort((khi, klo, ktax), num_keys=3)

    valid = shi < jnp.uint32(0x40000000)
    prev_hi = jnp.concatenate([sent[None], shi[:-1]])
    prev_lo = jnp.concatenate([sent[None], slo[:-1]])
    prev_tax = jnp.concatenate([jnp.full((1,), -1, jnp.int32), stax[:-1]])
    pair_new = valid & ((shi != prev_hi) | (slo != prev_lo) | (stax != prev_tax))
    pair_id = jnp.cumsum(pair_new) - 1

    count = jnp.sum(pair_new)
    out_idx = jnp.where(pair_new, pair_id, cap)
    # unused slots stay all-ones/taxon-0 so they remain invalid entries if a
    # later device-resident reduction concatenates this output un-sliced
    out_hi = jnp.full(cap, sent).at[out_idx].set(shi, mode="drop")
    out_lo = jnp.full(cap, sent).at[out_idx].set(slo, mode="drop")
    out_tax = jnp.zeros(cap, jnp.int32).at[out_idx].set(stax, mode="drop")
    # ONE [3, cap+1] u32 output: element [0, cap] carries the count, so the
    # host pays a single device->host fetch per batch instead of four (each
    # fetch costs a full link round trip)
    out = jnp.stack([out_hi, out_lo, out_tax.astype(jnp.uint32)], axis=0)
    tail = jnp.stack(
        [count.astype(jnp.uint32), jnp.uint32(0), jnp.uint32(0)]
    )[:, None]
    return jnp.concatenate([out, tail], axis=1)


@partial(jax.jit, static_argnums=(2,))
def _scan_batch_records_kernel(codes, taxa_rows, params: MinimizerParams, lut=None):
    """Raw span records for the device-resident merge tree: scan + flatten +
    sentinel-mask, NO per-batch sort/dedup ([3, B*L] u32 khi/klo/taxon).

    The merge tree's reduce (lax.sort) is data-oblivious, and chunk arrays
    are fixed-cap either way, so the per-batch sort+scatter of
    _build_batch_kernel buys the device-resident path nothing — it existed
    to count-slice the per-batch d2h transfer, and dropping it halves the
    device work of a sort-bound build."""
    wm = window_minimizers(codes, params, lut)
    b, l = codes.shape
    n = b * l
    hi = wm.minimizer.hi.reshape(n)
    lo = wm.minimizer.lo.reshape(n)
    start = wm.span_start.reshape(n)
    taxon = jnp.broadcast_to(
        jnp.asarray(taxa_rows, jnp.int32)[:, None], (b, l)
    ).reshape(n)
    sent = jnp.uint32(0xFFFFFFFF)
    return jnp.stack(
        [
            jnp.where(start, hi, sent),
            jnp.where(start, lo, sent),
            jnp.where(start, taxon, 0).astype(jnp.uint32),
        ],
        axis=0,
    )


@partial(jax.jit, static_argnums=(2,))
def _scan_batch_records_kernel_wide(codes, taxa_rows, params: MinimizerParams):
    """_scan_batch_records_kernel for wide (m > 31) minimizers: [5, B*L]
    u32 raw records (l3, l2, l1, l0 most-significant-first, taxon),
    sentinel-masked at non-span positions (the reference's build scan has
    no m bound, KeyValueIndex.scala:85-93 / Minimizers.scala:43-76)."""
    wm = window_minimizers(codes, params)
    b, l = codes.shape
    n = b * l
    l3, l2, l1, l0 = (x.reshape(n) for x in wm.minimizer.limbs)
    start = wm.span_start.reshape(n)
    taxon = jnp.broadcast_to(
        jnp.asarray(taxa_rows, jnp.int32)[:, None], (b, l)
    ).reshape(n)
    sent = jnp.uint32(0xFFFFFFFF)
    return jnp.stack(
        [
            jnp.where(start, l3, sent),
            jnp.where(start, l2, sent),
            jnp.where(start, l1, sent),
            jnp.where(start, l0, sent),
            jnp.where(start, taxon, 0).astype(jnp.uint32),
        ],
        axis=0,
    )


@jax.jit
def _reduce_chunks_kernel_wide(l3, l2, l1, l0, tax, rpath_table):
    """_reduce_chunks_kernel for wide keys: sort on the four u32 limbs (+
    taxon for determinism), segment-LCA runs of equal keys (the groupBy +
    LCA-UDAF of KeyValueIndex.scala:85-93 at the full m <= 63 envelope).
    Sentinel convention: l3 = all-ones marks padding (real wide keys have
    hi64 < 2^62, so l3 < 2^30). Returns ([5, M] u32, n_runs)."""
    from .ops import lca as lca_ops

    sent = jnp.uint32(0xFFFFFFFF)
    m = l3.shape[0]
    s3, s2, s1, s0, stax = jax.lax.sort(
        (l3, l2, l1, l0, jnp.asarray(tax, jnp.int32)), num_keys=5
    )
    valid = s3 < jnp.uint32(0x40000000)

    def prev(x):
        return jnp.concatenate([sent[None], x[:-1]])

    key_new = valid & (
        (s3 != prev(s3)) | (s2 != prev(s2)) | (s1 != prev(s1)) | (s0 != prev(s0))
    )
    run_id = jnp.cumsum(key_new.astype(jnp.int32)) - 1
    n_runs = jnp.maximum(run_id[-1] + 1, 0)
    safe_tax = jnp.where(valid, stax, 0)
    red = lca_ops.segment_lca_table(
        jnp.maximum(run_id, 0), safe_tax, rpath_table
    )
    out_idx = jnp.where(key_new, run_id, m)
    outs = [
        jnp.full(m, sent).at[out_idx].set(x, mode="drop")
        for x in (s3, s2, s1, s0)
    ]
    out_tax = jnp.zeros(m, jnp.int32).at[out_idx].set(
        red[jnp.maximum(run_id, 0)], mode="drop"
    )
    return jnp.stack(outs + [out_tax.astype(jnp.uint32)], axis=0), n_runs


@jax.jit
def _reduce_chunks_kernel(hi, lo, tax, rpath_table):
    """Device-global build reduction: sort (key, taxon) entries, drop
    sentinel padding, pair-dedup, and LCA-reduce each run of equal keys with
    the root-aligned path table (the reference's groupBy + LCA-UDAF,
    KeyValueIndex.scala:85-93 — here one lax.sort + segment min/max).

    Inputs may contain sentinel (all-ones key, taxon 0) padding anywhere;
    outputs use the same convention: [3, M] u32 (hi, lo, taxon) with one
    entry per distinct key, sentinel-padded to M. LCA is associative and
    idempotent per key, so this kernel can be applied hierarchically —
    partial reductions of superbatches then a final pass — and the result
    equals one global reduction.
    """
    from .ops import lca as lca_ops

    sent = jnp.uint32(0xFFFFFFFF)
    m = hi.shape[0]
    shi, slo, stax = jax.lax.sort(
        (hi, lo, jnp.asarray(tax, jnp.int32)), num_keys=3
    )
    valid = shi < jnp.uint32(0x40000000)
    prev_hi = jnp.concatenate([sent[None], shi[:-1]])
    prev_lo = jnp.concatenate([sent[None], slo[:-1]])
    key_new = valid & ((shi != prev_hi) | (slo != prev_lo))
    run_id = jnp.cumsum(key_new.astype(jnp.int32)) - 1
    n_runs = jnp.maximum(run_id[-1] + 1, 0)
    # invalid tail entries inherit the last run's id but carry taxon NONE,
    # which segment LCA treats as the aggregation identity
    safe_tax = jnp.where(valid, stax, 0)
    red = lca_ops.segment_lca_table(
        jnp.maximum(run_id, 0), safe_tax, rpath_table
    )
    out_idx = jnp.where(key_new, run_id, m)
    out_hi = jnp.full(m, sent).at[out_idx].set(shi, mode="drop")
    out_lo = jnp.full(m, sent).at[out_idx].set(slo, mode="drop")
    out_tax = jnp.zeros(m, jnp.int32).at[out_idx].set(
        red[jnp.maximum(run_id, 0)], mode="drop"
    )
    return jnp.stack(
        [out_hi, out_lo, out_tax.astype(jnp.uint32)], axis=0
    ), n_runs


def spans_to_records(codes: np.ndarray, taxa: np.ndarray, params: MinimizerParams, lut=None):
    """Scan packed fragments [B, L] and return (keys uint64 [R], taxa int32 [R])
    — one record per super-mer span, tagged with the fragment's taxon
    (Minimizers.scala:43-76 equivalent)."""
    hi, lo, start = _scan_batch(codes, params, lut)
    hi = np.asarray(hi)
    lo = np.asarray(lo)
    start = np.asarray(start)
    keys = (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)
    rows, cols = np.nonzero(start)
    return keys[rows, cols], np.asarray(taxa, np.int32)[rows]


# ---------------------------------------------------------------------------
# Wide keys (m > 31): [N, 2] uint64 (hi64, lo64) host representation
# ---------------------------------------------------------------------------


@partial(jax.jit, static_argnums=(1,))
def _scan_batch_wide(codes, params: MinimizerParams):
    wm = window_minimizers(codes, params)
    l3, l2, l1, l0 = wm.minimizer.limbs
    return l3, l2, l1, l0, wm.span_start


def spans_to_records_wide(codes: np.ndarray, taxa: np.ndarray, params: MinimizerParams):
    """Wide-m spans_to_records: returns (keys [R, 2] uint64, taxa [R])."""
    l3, l2, l1, l0, start = (np.asarray(x) for x in _scan_batch_wide(codes, params))
    rows, cols = np.nonzero(start)
    hi64 = (l3.astype(np.uint64) << np.uint64(32)) | l2.astype(np.uint64)
    lo64 = (l1.astype(np.uint64) << np.uint64(32)) | l0.astype(np.uint64)
    keys2 = np.stack([hi64[rows, cols], lo64[rows, cols]], axis=1)
    return keys2, np.asarray(taxa, np.int32)[rows]


def dedup_pairs_wide(keys2: np.ndarray, taxa: np.ndarray):
    """Sort + dedup (wide key, taxon) pairs ([N, 2] uint64 keys)."""
    if len(keys2) == 0:
        return keys2, taxa
    order = np.lexsort((taxa, keys2[:, 1], keys2[:, 0]))
    keys2, taxa = keys2[order], taxa[order]
    new = np.empty(len(keys2), bool)
    new[0] = True
    new[1:] = (
        (keys2[1:, 0] != keys2[:-1, 0])
        | (keys2[1:, 1] != keys2[:-1, 1])
        | (taxa[1:] != taxa[:-1])
    )
    return keys2[new], taxa[new]


def reduce_records_wide(
    keys2: np.ndarray, taxa: np.ndarray, taxonomy: Taxonomy, chunk: int = 1 << 22
):
    """reduce_records for wide keys: sort [N, 2] uint64 keys, LCA-reduce
    runs of equal keys on device."""
    if len(keys2) == 0:
        return keys2, taxa
    order = np.lexsort((keys2[:, 1], keys2[:, 0]))
    keys2 = keys2[order]
    taxa = np.ascontiguousarray(np.asarray(taxa)[order])
    boundary = np.empty(len(keys2), bool)
    boundary[0] = True
    boundary[1:] = (keys2[1:, 0] != keys2[:-1, 0]) | (keys2[1:, 1] != keys2[:-1, 1])
    run_of = np.cumsum(boundary) - 1
    num_runs = int(run_of[-1]) + 1
    uniq_keys = keys2[boundary]

    out_taxa = np.empty(num_runs, np.int32)
    table = jnp.asarray(taxonomy.rpath_table())
    run_starts = np.flatnonzero(boundary)
    start = 0
    while start < len(keys2):
        end = min(start + chunk, len(keys2))
        if end < len(keys2):
            # snap UP to the next run boundary (see reduce_records)
            nxt = np.searchsorted(run_starts, end, side="left")
            end = int(run_starts[nxt]) if nxt < len(run_starts) else len(keys2)
        rid = run_of[start:end] - run_of[start]
        red = np.asarray(
            lca_ops.segment_lca_table(
                jnp.asarray(rid, jnp.int32), jnp.asarray(taxa[start:end]), table
            )
        )
        r0 = int(run_of[start])
        r1 = int(run_of[end - 1]) + 1
        out_taxa[r0:r1] = red[: r1 - r0]
        start = end

    return uniq_keys, out_taxa


class SpillCollector:
    """Range-partitioned on-disk record collector for beyond-RAM builds.

    Each device batch's (sorted) records are split at fixed key-range
    boundaries and appended to per-range files; the final reduce then
    processes one bounded range at a time. This is the single-host form of
    the multi-host range-sharded build (each host owns a set of ranges —
    the analogue of the reference's shuffle to bucketed Parquet,
    KeyValueIndex.scala:125-139).
    """

    def __init__(self, directory: str, n_ranges: int = 64, m: int = 31):
        os.makedirs(directory, exist_ok=True)
        self.dir = directory
        self.n_ranges = n_ranges
        #: wide (m > 31) collectors store [N, 2] uint64 keys and partition on
        #: the top 64 bits of the 2m-bit priority
        self.wide = m > 31
        self._m = m
        # a previous crashed build's spill files would silently merge into
        # this build (files are opened in append mode): remove any of OUR
        # range files up front so every build starts from a clean slate
        import glob as _glob

        for stale in _glob.glob(os.path.join(directory, "k[0-9]*.bin")):
            os.unlink(stale)
        for stale in _glob.glob(os.path.join(directory, "t[0-9]*.bin")):
            os.unlink(stale)
        # uniform boundaries over the priority space (XOR-scrambled keys are
        # uniform): 62 bits narrow (2*31), the top-64-bit projection wide
        space_bits = 64 if self.wide else 62
        self.bounds = (
            np.arange(1, n_ranges) * ((1 << space_bits) // n_ranges)
        ).astype(np.uint64)
        self._files = {}

    def _part_key(self, keys: np.ndarray) -> np.ndarray:
        """uint64 projection that preserves key order for range partitioning:
        the key itself (narrow) or the top 64 of the 2m priority bits (wide;
        hi holds bits 64..2m-1, so the projection spans both limbs)."""
        if not self.wide:
            return keys
        shift = 2 * self._m - 64  # in [0, 62] for 31 < m <= 63
        if shift == 0:
            return keys[:, 1]
        return (keys[:, 0] << np.uint64(64 - shift)) | (
            keys[:, 1] >> np.uint64(shift)
        )

    def add(self, keys: np.ndarray, taxa: np.ndarray):
        keys = np.asarray(keys, np.uint64)
        taxa = np.asarray(taxa, np.int32)
        part = np.searchsorted(self.bounds, self._part_key(keys), side="right")
        order = np.argsort(part, kind="stable")
        keys, taxa, part = keys[order], taxa[order], part[order]
        edges = np.searchsorted(part, np.arange(self.n_ranges + 1))
        for r in range(self.n_ranges):
            a, b = edges[r], edges[r + 1]
            if a == b:
                continue
            kf, tf = self._open(r)
            kf.write(keys[a:b].tobytes())
            tf.write(taxa[a:b].tobytes())

    def _open(self, r):
        if r not in self._files:
            self._files[r] = (
                open(os.path.join(self.dir, f"k{r:04d}.bin"), "ab"),
                open(os.path.join(self.dir, f"t{r:04d}.bin"), "ab"),
            )
        return self._files[r]

    def close(self):
        for kf, tf in self._files.values():
            kf.close()
            tf.close()
        self._files = {}

    def reduce(self, taxonomy: Taxonomy, keep_records: bool = False):
        """Per-range dedup + LCA reduce; ranges concatenate in key order."""
        self.close()
        out_keys, out_taxa = [], []
        rec_keys, rec_taxa = [], []
        for r in range(self.n_ranges):
            kp = os.path.join(self.dir, f"k{r:04d}.bin")
            if not os.path.exists(kp):
                continue
            keys = np.fromfile(kp, dtype=np.uint64)
            if self.wide:
                keys = keys.reshape(-1, 2)
            taxa = np.fromfile(os.path.join(self.dir, f"t{r:04d}.bin"), dtype=np.int32)
            if self.wide:
                pk, pt = dedup_pairs_wide(keys, taxa)
            else:
                pk, pt = dedup_pairs(keys, taxa)
            if keep_records:
                rec_keys.append(pk)
                rec_taxa.append(pt)
            if self.wide:
                k2, t2 = reduce_records_wide(pk, pt, taxonomy)
            else:
                k2, t2 = reduce_records(pk, pt, taxonomy)
            out_keys.append(k2)
            out_taxa.append(t2)
        empty_keys = np.zeros((0, 2) if self.wide else 0, np.uint64)
        keys = np.concatenate(out_keys) if out_keys else empty_keys
        taxa = np.concatenate(out_taxa) if out_taxa else np.zeros(0, np.int32)
        recs = (
            (np.concatenate(rec_keys), np.concatenate(rec_taxa))
            if keep_records and rec_keys
            else None
        )
        return keys, taxa, recs

    def cleanup(self):
        self.close()
        import shutil

        shutil.rmtree(self.dir, ignore_errors=True)


class RecordCollector:
    """Accumulates (minimizer, taxon) record chunks on host during a build."""

    def __init__(self):
        self._keys: List[np.ndarray] = []
        self._taxa: List[np.ndarray] = []

    def add(self, keys: np.ndarray, taxa: np.ndarray):
        self._keys.append(np.asarray(keys, np.uint64))
        self._taxa.append(np.asarray(taxa, np.int32))

    def __len__(self):
        return sum(len(k) for k in self._keys)

    def concat(self) -> Tuple[np.ndarray, np.ndarray]:
        if not self._keys:
            return np.zeros(0, np.uint64), np.zeros(0, np.int32)
        return np.concatenate(self._keys), np.concatenate(self._taxa)


def dedup_pairs(keys: np.ndarray, taxa: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Globally sort and deduplicate (key, taxon) pairs."""
    if len(keys) == 0:
        return keys, taxa
    # C++ LSD radix sort (3.4x numpy lexsort at 30M records); (key, taxon)
    # lexicographic since build-record taxa are non-negative
    keys, taxa = native.radix_sort_kv(keys, taxa, with_vals=True)
    new = np.empty(len(keys), bool)
    new[0] = True
    new[1:] = (keys[1:] != keys[:-1]) | (taxa[1:] != taxa[:-1])
    return keys[new], taxa[new]


def reduce_records(
    keys: np.ndarray, taxa: np.ndarray, taxonomy: Taxonomy, chunk: int = 1 << 22
) -> Tuple[np.ndarray, np.ndarray]:
    """Sort records by key and LCA-reduce duplicates.

    Host radix-sorts the uint64 keys; the device LCA-reduces each run of
    equal keys (chunked on run boundaries so no run straddles a chunk).
    """
    if len(keys) == 0:
        return keys, taxa
    keys, taxa = native.radix_sort_kv(keys, taxa)
    boundary = np.empty(len(keys), bool)
    boundary[0] = True
    boundary[1:] = keys[1:] != keys[:-1]
    run_of = np.cumsum(boundary) - 1
    num_runs = int(run_of[-1]) + 1
    uniq_keys = keys[boundary]

    out_taxa = np.empty(num_runs, np.int32)
    table = jnp.asarray(taxonomy.rpath_table())

    run_starts = np.flatnonzero(boundary)
    start = 0
    while start < len(keys):
        end = min(start + chunk, len(keys))
        if end < len(keys):
            # snap UP to the next run boundary (a run must not straddle
            # chunks); the final run straddling the boundary means there is
            # no later run start, so the chunk extends to the end
            nxt = np.searchsorted(run_starts, end, side="left")
            end = int(run_starts[nxt]) if nxt < len(run_starts) else len(keys)
        rid = run_of[start:end] - run_of[start]
        red = np.asarray(
            lca_ops.segment_lca_table(
                jnp.asarray(rid, jnp.int32), jnp.asarray(taxa[start:end]), table
            )
        )
        r0 = int(run_of[start])
        r1 = int(run_of[end - 1]) + 1
        out_taxa[r0:r1] = red[: r1 - r0]
        start = end

    return uniq_keys, out_taxa


class KeyValueIndex:
    """Sorted minimizer->LCA index with its parameters and taxonomy."""

    def __init__(
        self,
        keys: Optional[np.ndarray],
        taxa: Optional[np.ndarray],
        params: IndexParams,
        taxonomy: Taxonomy,
        location: Optional[str] = None,
    ):
        #: device-resident record bundle ([3, cap] u32 hi/lo/taxon device
        #: array, n valid) — set by from_device_records; host keys/taxa then
        #: materialize lazily on first access (save(), routed probes), while
        #: the production hashed1 serve path never round-trips through the
        #: host at all (device_hashed_rows builds on device)
        self._device_records = None
        self._num_records: Optional[int] = None
        self._keys = None if keys is None else np.asarray(keys, np.uint64)
        self._taxa = None if taxa is None else np.asarray(taxa, np.int32)
        self.params = params
        self.taxonomy = taxonomy
        self.location = location
        self._device_keys = None
        self._device_taxa = None
        self._device_router = None
        self._router_rounds = None
        self._router_bits = None
        self._host_router = None
        self._device_bucketed = None
        self._device_tiled = None
        self._device_lut = None
        #: rank LUT for explicit (non-xor) orderings; keys are then ranks
        self.ordering_lut: Optional[np.ndarray] = None
        #: optional full (minimizer, taxon) pair sidecar enabling dynamic
        #: rebuilds without re-scanning the genome library
        self.record_keys: Optional[np.ndarray] = None
        self.record_taxa: Optional[np.ndarray] = None

    # -- device residency ---------------------------------------------------

    @classmethod
    def from_device_records(
        cls, red, n: int, params: IndexParams, taxonomy: Taxonomy
    ) -> "KeyValueIndex":
        """Index over a device-resident u32 record array with `n` valid
        sorted entries — [3, cap] (hi, lo, taxon) for m <= 31, [5, cap]
        (l3, l2, l1, l0, taxon) for wide keys. The build->serve fast path:
        the hashed1 probe table is built on device
        (build_hashed_rows_device[_wide]) and host keys/taxa materialize
        only if a host consumer (save, routed probe, sharding) asks."""
        idx = cls(None, None, params, taxonomy)
        idx._device_records = red
        idx._num_records = int(n)
        return idx

    @property
    def num_records(self) -> int:
        """Record count, known without materializing host keys."""
        if self._num_records is not None:
            return self._num_records
        return len(self.keys)

    def _materialize(self):
        red = self._device_records
        n = self._num_records
        rows = red.shape[0]
        out = np.asarray(jnp.ravel(red[:, :n])).reshape(rows, n)
        if rows == 5:  # wide: (l3, l2, l1, l0, taxon) -> [n, 2] u64 keys
            hi64 = (out[0].astype(np.uint64) << np.uint64(32)) | out[1]
            lo64 = (out[2].astype(np.uint64) << np.uint64(32)) | out[3]
            self._keys = np.stack([hi64, lo64], axis=1)
            self._taxa = out[4].view(np.int32).copy()
            return
        self._keys = (
            out[0].astype(np.uint64) << np.uint64(32)
        ) | out[1]
        self._taxa = out[2].view(np.int32).copy()

    @property
    def keys(self) -> np.ndarray:
        if self._keys is None and self._device_records is not None:
            self._materialize()
        return self._keys

    def _detach_device_records(self):
        """Assigning keys/taxa invalidates the device-resident record view:
        materialize the not-yet-overwritten column first (so the other
        array is not lost), then drop the device records and any serve
        table built from them (they would silently serve STALE data)."""
        if self._device_records is not None:
            self._materialize()
            self._device_records = None
            self._num_records = None
        self._device_hashed_rows = None

    @keys.setter
    def keys(self, value):
        self._detach_device_records()
        self._keys = None if value is None else np.asarray(value, np.uint64)
        self._num_records = None  # recompute from the new array

    @property
    def taxa(self) -> np.ndarray:
        if self._taxa is None and self._device_records is not None:
            self._materialize()
        return self._taxa

    @taxa.setter
    def taxa(self, value):
        self._detach_device_records()
        self._taxa = None if value is None else np.asarray(value, np.int32)

    @property
    def wide(self) -> bool:
        """Keys wider than one u64 (m > 31): stored as [N, 2] uint64."""
        return self.params.m > 31

    @property
    def device_keys(self):
        # ensure_compile_time_eval: these lazily-created arrays must be real
        # device constants even when first touched inside a jit trace —
        # otherwise the cache would capture a tracer and poison later calls
        if self._device_keys is None:
            with jax.ensure_compile_time_eval():
                self._device_keys = (
                    lookup_ops.wide_keys_from_numpy(self.keys)
                    if self.wide
                    else lookup_ops.keys_from_numpy(self.keys)
                )
        return self._device_keys

    @property
    def device_taxa(self):
        if self._device_taxa is None:
            with jax.ensure_compile_time_eval():
                self._device_taxa = jnp.asarray(self.taxa)
        return self._device_taxa

    @property
    def key_bits(self) -> int:
        """Width of the key space: priorities (and rank-LUT ranks) span
        2m bits, so router prefixes are taken from the top of that range —
        a 62-bit assumption would put every small-m key in one bucket."""
        return 2 * self.params.m

    @property
    def device_lut(self):
        """Device rank table for explicit orderings (None for xor)."""
        if self.ordering_lut is not None and self._device_lut is None:
            with jax.ensure_compile_time_eval():
                self._device_lut = jnp.asarray(self.ordering_lut)
        return self._device_lut

    @property
    def device_router(self):
        if self._device_router is None:
            self._router_bits = min(
                lookup_ops.adaptive_router_bits(len(self.keys)), self.key_bits
            )
            if self.wide:
                router = lookup_ops.build_router_wide(
                    self.keys, self._router_bits, self.key_bits
                )
            else:
                router = lookup_ops.build_router(
                    self.keys, self._router_bits, self.key_bits
                )
            self._router_rounds = lookup_ops.router_rounds(router)
            self._host_router = router
            with jax.ensure_compile_time_eval():
                self._device_router = jnp.asarray(router)
        return self._device_router

    @property
    def device_bucketed(self):
        """(padded U64 keys, padded taxa, max bucket span) for the
        direct-bucket probe (lookup_taxa_bucketed)."""
        if self._device_bucketed is None:
            if self.wide:
                raise NotImplementedError("bucketed probe requires m <= 31")
            self.device_router  # builds the router + records the host copy
            maxb = lookup_ops.max_bucket_span(self._host_router)
            pk, pt = lookup_ops.pad_keys_for_buckets(self.keys, self.taxa, maxb)
            with jax.ensure_compile_time_eval():
                self._device_bucketed = (
                    lookup_ops.keys_from_numpy(pk),
                    jnp.asarray(pt),
                    maxb,
                )
        return self._device_bucketed

    @property
    def device_hashed(self):
        """(routerless hashed [n_rows, tile, 3] uint32 table, tile, hash
        bits) for lookup_taxa_hashed: two ALIGNED row gathers around the
        home slot instead of the tiled probe's router + 2-row dependent
        chain (no router gather)."""
        if getattr(self, "_device_hashed", None) is None:
            if self.wide:
                raise NotImplementedError("hashed probe requires m <= 31")
            table, tile, hbits = lookup_ops.build_hashed(
                self.keys, self.taxa, self.key_bits
            )
            with jax.ensure_compile_time_eval():
                self._device_hashed = (jnp.asarray(table), tile, hbits)
        return self._device_hashed

    @property
    def device_hashed_cols(self):
        """(column-block hashed [n_rows, 3*tile] uint32 table, tile, bits)
        for lookup_taxa_hashed_cols: zero-layout-padding row gathers at hash
        load factor ~1 (~12-24 B/key vs ~38 for device_hashed)."""
        if getattr(self, "_device_hashed_cols", None) is None:
            if self.wide:
                raise NotImplementedError("hashed probes require m <= 31")
            table, tile, hbits = lookup_ops.build_hashed_cols(
                self.keys, self.taxa, self.key_bits
            )
            with jax.ensure_compile_time_eval():
                self._device_hashed_cols = (jnp.asarray(table), tile, hbits)
        return self._device_hashed_cols

    @property
    def device_hashed_rows(self):
        """(row-bucket hashed [2^row_bits, 3*tile] uint32 table, tile,
        row_bits) for lookup_taxa_hashed_rows: ONE aligned row gather per
        query (the hashed/hashed128 layouts need two) at ~15-38 B/key.
        Wide (m > 31) indexes get the [2^row_bits, 5*tile] raw-limb table
        for lookup_taxa_hashed_rows_wide."""
        if getattr(self, "_device_hashed_rows", None) is None:
            if self._device_records is not None:
                # build->serve fast path: table built ON device from the
                # device-resident records; no host round-trip anywhere
                red, n = self._device_records, self._num_records
                if self.wide:
                    table, tile, rbits = lookup_ops.build_hashed_rows_wide_device(
                        red[0, :n], red[1, :n], red[2, :n], red[3, :n],
                        red[4, :n].view(jnp.int32),
                    )
                else:
                    table, tile, rbits = lookup_ops.build_hashed_rows_device(
                        red[0, :n], red[1, :n], red[2, :n].view(jnp.int32)
                    )
                self._device_hashed_rows = (table, tile, rbits)
                return self._device_hashed_rows
            if self.wide:
                table, tile, rbits = lookup_ops.build_hashed_rows_wide(
                    self.keys, self.taxa, self.key_bits
                )
            else:
                table, tile, rbits = lookup_ops.build_hashed_rows(
                    self.keys, self.taxa, self.key_bits
                )
            with jax.ensure_compile_time_eval():
                self._device_hashed_rows = (jnp.asarray(table), tile, rbits)
        return self._device_hashed_rows

    @property
    def router_rounds(self) -> int:
        self.device_router
        return self._router_rounds

    @property
    def router_bits(self) -> int:
        self.device_router
        return self._router_bits

    @property
    def device_tiled(self):
        """(interleaved [n_rows, tile, 3] uint32 table, tile) for the
        row-gather probe (lookup_taxa_tiled); wide indexes get the
        [n_rows, tile, 5] table for lookup_taxa_tiled_wide."""
        if self._device_tiled is None:
            self.device_router  # builds the router + records the host copy
            if self.wide:
                table, tile = lookup_ops.build_tiled_wide(
                    self.keys, self.taxa, self._host_router
                )
            else:
                table, tile = lookup_ops.build_tiled(
                    self.keys, self.taxa, self._host_router
                )
            with jax.ensure_compile_time_eval():
                self._device_tiled = (jnp.asarray(table), tile)
        return self._device_tiled

    def lookup(self, q_hi, q_lo):
        """Device lookup of query minimizers -> LCA taxa (0 = miss)."""
        if self.wide:
            raise NotImplementedError("use lookup_wide for m > 31")
        return lookup_ops.lookup_taxa_routed(
            self.device_keys, self.device_taxa, self.device_router,
            u64.U64(q_hi, q_lo), self.router_rounds, self.router_bits,
            self.key_bits,
        )

    def lookup_wide(self, q):
        """Device lookup for wide (m > 31) keys; q is a u128.U128."""
        return lookup_ops.lookup_taxa_routed_wide(
            self.device_keys, self.device_taxa, self.device_router, q,
            self.router_rounds, self.router_bits, self.key_bits,
        )

    # -- construction -------------------------------------------------------

    @classmethod
    def build(
        cls,
        fragments: Iterable[Tuple[int, str]],
        params: IndexParams,
        taxonomy: Taxonomy,
        batch_rows: int = 256,
        row_len: int = 1 << 16,
        taxon_filter: Optional[set] = None,
        keep_records: bool = False,
        spill_dir: Optional[str] = None,
        ordering_lut: Optional[np.ndarray] = None,
    ) -> "KeyValueIndex":
        """Build from an iterable of (taxon, sequence) pairs.

        Sequences longer than row_len are split with k-1 overlap so no k-mer
        window is lost (the analogue of overlapped Hadoop splits,
        FileInputs.scala:246-273). Sequences with taxa not defined in the
        taxonomy are skipped (KeyValueIndex.scala:118-120), as are taxa
        outside `taxon_filter` when given (dynamic builds,
        KeyValueIndex.scala:102-113).
        """
        mp = params.minimizer_params.validate()
        lut = None
        if params.ordering != "xor":
            from .ops import ordering as ordering_ops

            if mp.wide:
                raise NotImplementedError("explicit orderings require m <= 31")
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
        collector = (
            SpillCollector(spill_dir, m=params.m) if spill_dir else RecordCollector()
        )
        # opt-in phase accounting (STPU_BUILD_TRACE=1): where does build
        # wall-clock go in a given environment? The report prints to stderr
        # and is attached to the returned index as _build_phases.
        import os as _os

        from .utils import PhaseTimers

        trace = PhaseTimers() if _os.environ.get("STPU_BUILD_TRACE") == "1" else None

        if trace is not None:
            _inner_frag = fragments

            def _timed_frags():
                it = iter(_inner_frag)
                while True:
                    with trace.phase("fragment_source"):
                        try:
                            item = next(it)
                        except StopIteration:
                            return
                    yield item

            fragments = _timed_frags()

        import contextlib as _contextlib
        import sys as _sys

        def _ph(name):
            return trace.phase(name) if trace is not None else _contextlib.nullcontext()

        def _attach_trace(idx):
            if trace is not None:
                print("build phases:", file=_sys.stderr)
                trace.report()
                idx._build_phases = trace

        buf_seqs: List[np.ndarray] = []
        buf_taxa: List[int] = []
        # spans occupy ~1/3 of positions on typical DNA; cap at 1/2 with a
        # raw-records fallback on overflow
        cap = (batch_rows * row_len) // 2
        import collections as _collections
        import os as _os

        pending = _collections.deque()  # (device out, codes, taxa_rows)

        # device-resident build (GPU default): per-batch records STAY on
        # device and are reduced there hierarchically
        # (_reduce_chunks_kernel); only the finished index crosses the link,
        # once, instead of every batch's records. STPU_BUILD_DEVICE=1/0
        # overrides (tests force it on CPU).
        env_dr = _os.environ.get("STPU_BUILD_DEVICE")
        device_reduce = (
            (utils.backend() == "gpu" if env_dr is None else env_dr == "1")
            and not spill_dir
            and not keep_records
        )
        # with cap = every position, batch-kernel overflow is impossible
        # (spans <= windows), so no per-batch count fetches are needed
        cap_dr = batch_rows * row_len
        chunks: List = []  # RAW per-batch device [3, n] sentinel-padded arrays
        reduced: List = []  # merge-tree leaves as (device array, exact count)
        table_dev = None
        # entries held device-resident before a hierarchical reduction.
        # The reduction's lax.sort transients are a few x the input, so 8M
        # entries keeps the peak ~1.3 GB; env override exercises the tree in
        # tests. Merge discipline: raw batches reduce into `reduced` leaves
        # and the leaves merge PAIRWISE when two have similar size — NEVER
        # re-sorting one ever-growing carry against every new batch, which
        # is quadratic work and holds the sort transients of the whole carry
        # at every flush.
        superbatch = int(
            _os.environ.get("STPU_BUILD_SUPERBATCH", max(2 * cap_dr, 1 << 23))
        )
        # device-memory bound for the resident merge tree: a leaf reaching
        # this many entries is transferred to host (sorted + LCA-reduced, so
        # the spill is distinct records, not raw spans) and the FINAL
        # cross-leaf merge runs the host reduce path. The bound keeps device
        # builds working at any library size (the spill traffic is
        # proportional to index size, which must cross the link once
        # anyway). STPU_BUILD_DEVICE_BUDGET overrides (entries).
        _budget_env = _os.environ.get("STPU_BUILD_DEVICE_BUDGET")
        budget_entries = (
            int(_budget_env) if _budget_env else device_build_budget_entries()
        )
        host_leaves: List[Tuple[np.ndarray, np.ndarray]] = []
        # ravel device [3, X] record arrays before d2h (GPU default): a 1-D
        # array leaves the transfer path no layout to convert, and the
        # device-side ravel copy is cheap next to the transfer.
        _flat_env = _os.environ.get("STPU_BUILD_FLAT_D2H")
        flat_d2h = (
            utils.backend() == "gpu" if _flat_env is None else _flat_env == "1"
        )

        def _fetch_records(arr):
            """One d2h of a [3, X] device record array, padding-free."""
            if flat_d2h:
                return np.asarray(jnp.ravel(arr)).reshape(arr.shape)
            return np.asarray(arr)

        def _spill_leaf(leaf, count):
            with _ph("leaf_d2h"):
                out = _fetch_records(leaf)
            if mp.wide:
                hi64 = (
                    out[0, :count].astype(np.uint64) << np.uint64(32)
                ) | out[1, :count]
                lo64 = (
                    out[2, :count].astype(np.uint64) << np.uint64(32)
                ) | out[3, :count]
                host_leaves.append(
                    (np.stack([hi64, lo64], axis=1),
                     out[4, :count].view(np.int32).copy())
                )
                return
            keys = (out[0, :count].astype(np.uint64) << np.uint64(32)) | out[1, :count]
            host_leaves.append((keys, out[2, :count].view(np.int32).copy()))

        def _bucket(n: int, g: int = 1 << 18) -> int:
            return max(g, -(-n // g) * g)

        def _reduce(parts):
            """Concatenate device record arrays and LCA-reduce on device,
            returning the bucket-sliced result and its logical count."""
            nonlocal table_dev
            with _ph("device_reduce"):
                if table_dev is None:
                    table_dev = jnp.asarray(taxonomy.rpath_table())
                if mp.wide:
                    limbs = [
                        jnp.concatenate([c[i] for c in parts]) for i in range(4)
                    ]
                    tx = jnp.concatenate([c[4] for c in parts]).view(jnp.int32)
                    red, n_runs = _reduce_chunks_kernel_wide(
                        *limbs, tx, table_dev
                    )
                else:
                    hi = jnp.concatenate([c[0] for c in parts])
                    lo = jnp.concatenate([c[1] for c in parts])
                    tx = jnp.concatenate([c[2] for c in parts]).view(jnp.int32)
                    red, n_runs = _reduce_chunks_kernel(hi, lo, tx, table_dev)
                n = int(np.asarray(n_runs))
                return red[:, : _bucket(n)], n

        def reduce_raw():
            """Fold the pending raw batches into one reduced leaf, then
            merge-tree: collapse the two most recent leaves while they are
            within 2x of each other (keeps every sort linear in its inputs
            and the resident set at O(log) leaves of geometric sizes)."""
            nonlocal chunks
            if not chunks:
                return
            leaf, n = _reduce(chunks)
            chunks = []
            reduced.append((leaf, n))
            while (
                len(reduced) > 1
                and reduced[-2][0].shape[1] <= 2 * reduced[-1][0].shape[1]
            ):
                a = reduced.pop()
                b = reduced.pop()
                leaf, n = _reduce([b[0], a[0]])
                reduced.append((leaf, n))
            # bound the resident set: a leaf at the budget moves to host
            # (earlier leaves are smaller by the merge discipline)
            while reduced and reduced[-1][0].shape[1] >= budget_entries:
                _spill_leaf(*reduced.pop())

        def reduce_chunks(final: bool):
            """Final global reduction over the merge-tree leaves (+ any raw
            tail). Returns (out, n). A single already-reduced leaf with no
            raw tail is returned as-is — re-reducing it would pay a second
            full device sort for nothing (the pre-round-4 bench build spent
            ~25% of its time doing exactly that when the batch count landed
            on the superbatch boundary)."""
            assert final
            if not chunks and len(reduced) == 1:
                out, n = reduced[0]
                reduced.clear()
                return out, n
            parts = [l for l, _ in reduced] + chunks
            out, n = _reduce(parts)
            reduced.clear()
            chunks.clear()
            return out, n

        def harvest(item):
            out_dev, codes, taxa_rows = item
            out = np.asarray(out_dev)
            count = int(out[0, cap])
            if count > cap:
                # dense-span batch: fall back to raw record extraction
                k, t = spans_to_records(codes, taxa_rows, mp, lut)
                collector.add(k, t)
            else:
                keys = (out[0, :count].astype(np.uint64) << np.uint64(32)) | out[1, :count]
                collector.add(keys, out[2, :count].view(np.int32).copy())

        def flush():
            if not buf_seqs:
                return
            with _ph("pack_batch"):
                codes, _ = encode.pack_batch(buf_seqs, row_len)
                taxa_rows = np.zeros(batch_rows, np.int32)
                taxa_rows[: len(buf_taxa)] = buf_taxa
                if codes.shape[0] < batch_rows:
                    pad = np.full(
                        (batch_rows - codes.shape[0], row_len), encode.INVALID, np.uint8
                    )
                    codes = np.concatenate([codes, pad], axis=0)
                buf_seqs.clear()
                buf_taxa.clear()
            if mp.wide and not device_reduce:
                k2, t2 = spans_to_records_wide(codes, taxa_rows, mp)
                collector.add(k2, t2)
                return
            if device_reduce:
                with _ph("kernel_dispatch"):
                    # raw records, no per-batch sort (see
                    # _scan_batch_records_kernel: the reduce's sort is
                    # data-oblivious, so pre-sorting was pure overhead)
                    chunks.append(
                        _scan_batch_records_kernel_wide(codes, taxa_rows, mp)
                        if mp.wide
                        else _scan_batch_records_kernel(codes, taxa_rows, mp, lut)
                    )
                if sum(c.shape[1] for c in chunks) >= superbatch:
                    reduce_raw()
                return
            if utils.backend() == "cpu":
                # on the CPU backend the kernel's lax.sort costs ~3.4x the
                # whole raw-extraction + C++ radix dedup path (1013 vs
                # 131+168 ms on a 2 Mbp batch); the device sort/dedup only
                # pays where it shrinks the device->host transfer
                with _ph("spans_to_records"):
                    k, t = spans_to_records(codes, taxa_rows, mp, lut)
                    collector.add(k, t)
                return
            # async dispatch: the next batch packs on the host while this one
            # scans/sorts on device and its single output array transfers
            pending.append(
                (_build_batch_kernel(codes, taxa_rows, mp, cap, lut), codes, taxa_rows)
            )
            while len(pending) > 2:
                harvest(pending.popleft())

        for taxon, seq in fragments:
            taxon = int(taxonomy.primary[taxon]) if taxon < len(taxonomy.primary) else taxon
            if not taxonomy.is_defined(taxon):
                continue
            if taxon_filter is not None and taxon not in taxon_filter:
                continue
            if isinstance(seq, str):
                with _ph("encode_seq"):
                    seq = encode.encode_seq(seq)
            # split long sequences with overlap
            step = row_len - (params.k - 1)
            for off in range(0, max(len(seq) - params.k + 1, 1), step):
                buf_seqs.append(seq[off : off + row_len])
                buf_taxa.append(taxon)
                if len(buf_seqs) >= batch_rows:
                    flush()
        flush()
        while pending:
            harvest(pending.popleft())

        if device_reduce:
            if host_leaves:
                # budget-spilled build: device-reduce the resident tail, then
                # merge the (already per-leaf-reduced) host leaves with the
                # standard host path — LCA is associative, so re-reducing
                # partial LCAs equals one global reduction
                if chunks or reduced:
                    red, n = reduce_chunks(final=True)
                    out = np.asarray(red)
                    if mp.wide:
                        hi64 = (
                            out[0, :n].astype(np.uint64) << np.uint64(32)
                        ) | out[1, :n]
                        lo64 = (
                            out[2, :n].astype(np.uint64) << np.uint64(32)
                        ) | out[3, :n]
                        host_leaves.append(
                            (np.stack([hi64, lo64], axis=1),
                             out[4, :n].view(np.int32).copy())
                        )
                    else:
                        k_tail = (
                            out[0, :n].astype(np.uint64) << np.uint64(32)
                        ) | out[1, :n]
                        host_leaves.append(
                            (k_tail, out[2, :n].view(np.int32).copy())
                        )
                with _ph("host_leaf_merge"):
                    pair_keys = np.concatenate([k for k, _ in host_leaves])
                    pair_taxa = np.concatenate([t for _, t in host_leaves])
                    host_leaves.clear()
                    if mp.wide:
                        pair_keys, pair_taxa = dedup_pairs_wide(pair_keys, pair_taxa)
                        keys, taxa = reduce_records_wide(
                            pair_keys, pair_taxa, taxonomy
                        )
                    else:
                        pair_keys, pair_taxa = dedup_pairs(pair_keys, pair_taxa)
                        keys, taxa = reduce_records(pair_keys, pair_taxa, taxonomy)
            elif not chunks and not reduced:
                keys = np.zeros((0, 2) if mp.wide else 0, np.uint64)
                taxa = np.zeros(0, np.int32)
            else:
                red, n = reduce_chunks(final=True)
                # device-resident build->serve (GPU default): the finished
                # sorted records STAY on device — the hashed1 serve table
                # builds there too, and host keys materialize lazily only
                # for save()/routed/sharding consumers, so build->classify
                # never pays the final d2h.
                _dr_env = _os.environ.get("STPU_DEVICE_RESIDENT")
                device_resident = (
                    utils.backend() == "gpu"
                    if _dr_env is None
                    else _dr_env == "1"
                )
                if device_resident:
                    jax.block_until_ready(red)  # build is DONE (honest timing)
                    idx = cls.from_device_records(red, n, params, taxonomy)
                    if lut is not None:
                        idx.ordering_lut = np.asarray(lut)
                    _attach_trace(idx)
                    return idx
                with _ph("final_d2h"):
                    out = _fetch_records(red)  # ONE transfer: the finished index
                with _ph("final_unpack"):
                    if mp.wide:
                        hi64 = (
                            out[0, :n].astype(np.uint64) << np.uint64(32)
                        ) | out[1, :n]
                        lo64 = (
                            out[2, :n].astype(np.uint64) << np.uint64(32)
                        ) | out[3, :n]
                        keys = np.stack([hi64, lo64], axis=1)
                        taxa = out[4, :n].view(np.int32).copy()
                    else:
                        keys = (
                            out[0, :n].astype(np.uint64) << np.uint64(32)
                        ) | out[1, :n]
                        taxa = out[2, :n].view(np.int32).copy()
            idx = cls(keys, taxa, params, taxonomy)
            if lut is not None:
                idx.ordering_lut = np.asarray(lut)
            _attach_trace(idx)
            return idx

        if spill_dir:
            with _ph("host_reduce"):
                keys, taxa, recs = collector.reduce(taxonomy, keep_records)
                collector.cleanup()
            idx = cls(keys, taxa, params, taxonomy)
            if lut is not None:
                idx.ordering_lut = np.asarray(lut)
            if recs is not None:
                idx.record_keys, idx.record_taxa = recs
            _attach_trace(idx)
            return idx

        with _ph("host_reduce"):
            pair_keys, pair_taxa = collector.concat()
            if mp.wide:
                if pair_keys.ndim == 1:  # empty library: concat() default shape
                    pair_keys = pair_keys.reshape(0, 2)
                pair_keys, pair_taxa = dedup_pairs_wide(pair_keys, pair_taxa)
                keys, taxa = reduce_records_wide(pair_keys, pair_taxa, taxonomy)
            else:
                pair_keys, pair_taxa = dedup_pairs(pair_keys, pair_taxa)
                keys, taxa = reduce_records(pair_keys, pair_taxa, taxonomy)
        idx = cls(keys, taxa, params, taxonomy)
        if lut is not None:
            idx.ordering_lut = np.asarray(lut)
        if keep_records:
            idx.record_keys = pair_keys
            idx.record_taxa = pair_taxa
        _attach_trace(idx)
        return idx

    # -- persistence --------------------------------------------------------

    def save(self, location: str):
        """Persist to a local directory or remote URI (gs://, s3://...);
        remote paths go through fsspec (HDFSUtil.scala:31-156 parity)."""
        storage.makedirs(location)
        meta = self.params.to_json()
        meta["num_records"] = int(len(self.keys))
        with storage.open_file(storage.join(location, "params.json"), "w") as f:
            json.dump(meta, f, indent=2)
        storage.np_save(storage.join(location, "keys.npy"), self.keys)
        storage.np_save(storage.join(location, "taxa.npy"), self.taxa)
        if self.ordering_lut is not None:
            storage.np_save(storage.join(location, "ordering_lut.npy"), self.ordering_lut)
        if self.record_keys is not None:
            storage.np_save(storage.join(location, "record_keys.npy"), self.record_keys)
            storage.np_save(storage.join(location, "record_taxa.npy"), self.record_taxa)
        self.taxonomy.save(storage.join(location, "taxonomy"))
        self.location = location

    @classmethod
    def load(cls, location: str, taxonomy: Optional[Taxonomy] = None) -> "KeyValueIndex":
        with storage.open_file(storage.join(location, "params.json")) as f:
            meta = json.load(f)
            params = IndexParams.from_json(meta)
        if "shards" in meta:
            # sharded (save_sharded) layout: load every shard
            return cls.load_shards(location, taxonomy=taxonomy)
        keys = storage.np_load(storage.join(location, "keys.npy"))
        taxa = storage.np_load(storage.join(location, "taxa.npy"))
        if taxonomy is None:
            taxonomy = Taxonomy.load(storage.join(location, "taxonomy"))
        idx = cls(keys, taxa, params, taxonomy, location)
        olp = storage.join(location, "ordering_lut.npy")
        if storage.exists(olp):
            idx.ordering_lut = storage.np_load(olp, mmap=False)
        rk = storage.join(location, "record_keys.npy")
        if storage.exists(rk):
            idx.record_keys = storage.np_load(rk)
            idx.record_taxa = storage.np_load(storage.join(location, "record_taxa.npy"))
        return idx

    def with_records(self, keys: np.ndarray, taxa: np.ndarray) -> "KeyValueIndex":
        return KeyValueIndex(keys, taxa, self.params, self.taxonomy, self.location)

    def build_restricted(self, taxon_set: set) -> "KeyValueIndex":
        """Build a restricted (dynamic) index from the full-records sidecar
        without re-scanning genomes — the fast path for 2-step
        classification (SURVEY §7: cache per-genome minimizer sets to make
        dynamic builds a filter+reduce; contrast KeyValueIndex.scala:102-113
        which rebuilds from the library)."""
        if self.record_keys is None:
            raise ValueError("index was built/saved without full records")
        mask = np.isin(np.asarray(self.record_taxa), np.fromiter(taxon_set, np.int32, len(taxon_set)))
        keys = np.asarray(self.record_keys)[mask]
        taxa = np.asarray(self.record_taxa)[mask]
        reduce = reduce_records_wide if self.wide else reduce_records
        keys, taxa = reduce(keys, taxa, self.taxonomy)
        idx = KeyValueIndex(keys, taxa, self.params, self.taxonomy)
        idx.ordering_lut = self.ordering_lut
        return idx

    def save_sharded(self, location: str, n_shards: Optional[int] = None):
        """Persist the index as `n_shards` contiguous key-range shards
        (keys.<i>.npy / taxa.<i>.npy) so each host of a multi-host mesh can
        load only its ranges — the analogue of the reference's bucketed
        Parquet layout (KeyValueIndex.scala:125-139, `buckets` =
        IndexParams.buckets)."""
        n_shards = n_shards or self.params.buckets
        storage.makedirs(location)
        bounds = np.linspace(0, len(self.keys), n_shards + 1).astype(np.int64)
        meta = self.params.to_json()
        meta["num_records"] = int(len(self.keys))
        meta["shards"] = [int(bounds[i + 1] - bounds[i]) for i in range(n_shards)]
        with storage.open_file(storage.join(location, "params.json"), "w") as f:
            json.dump(meta, f, indent=2)
        for i in range(n_shards):
            storage.np_save(storage.join(location, f"keys.{i:05d}.npy"), self.keys[bounds[i] : bounds[i + 1]])
            storage.np_save(storage.join(location, f"taxa.{i:05d}.npy"), self.taxa[bounds[i] : bounds[i + 1]])
        if self.ordering_lut is not None:
            # explicit-ordering keys are LUT ranks: an index loaded without
            # its LUT would silently probe xor priorities and miss everything
            storage.np_save(
                storage.join(location, "ordering_lut.npy"), self.ordering_lut
            )
        self.taxonomy.save(storage.join(location, "taxonomy"))

    @classmethod
    def load_shards(
        cls, location: str, shard_ids: Optional[List[int]] = None, taxonomy: Optional[Taxonomy] = None
    ) -> "KeyValueIndex":
        """Load a subset of shards (default: all) from a sharded layout.
        Hosts in a mesh pass their own shard id ranges."""
        with storage.open_file(storage.join(location, "params.json")) as f:
            meta = json.load(f)
        params = IndexParams.from_json(meta)
        n_shards = len(meta["shards"])
        ids = shard_ids if shard_ids is not None else list(range(n_shards))
        keys = np.concatenate(
            [storage.np_load(storage.join(location, f"keys.{i:05d}.npy")) for i in ids]
        ) if ids else np.zeros((0, 2) if params.m > 31 else 0, np.uint64)
        taxa = np.concatenate(
            [storage.np_load(storage.join(location, f"taxa.{i:05d}.npy")) for i in ids]
        ) if ids else np.zeros(0, np.int32)
        if taxonomy is None:
            taxonomy = Taxonomy.load(storage.join(location, "taxonomy"))
        idx = cls(keys, taxa, params, taxonomy, location)
        olp = storage.join(location, "ordering_lut.npy")
        if storage.exists(olp):
            idx.ordering_lut = storage.np_load(olp, mmap=False)
        return idx

    # -- tooling ------------------------------------------------------------

    def respace(self, spaces: int) -> "KeyValueIndex":
        """Project this index to a larger number of spaced-seed spaces and
        re-reduce (KeyValueIndex.scala:353-382): an index with s spaces
        contains all information needed for s' > s."""
        if spaces <= self.params.spaces:
            raise ValueError(
                f"Respacing must increase spaces (was {self.params.spaces}, got {spaces})"
            )
        if self.params.ordering != "xor":
            # rank-table keys are opaque ranks; re-masking them is meaningless
            raise NotImplementedError("respace requires the xor ordering")
        mask = np.uint64(space_mask_int(self.params.m, spaces))
        new_keys = self.keys & mask
        keys, taxa = reduce_records(new_keys.copy(), self.taxa.copy(), self.taxonomy)
        import dataclasses

        new_params = dataclasses.replace(self.params, spaces=spaces)
        return KeyValueIndex(keys, taxa, new_params, self.taxonomy)

    def records_per_taxon(self) -> dict:
        """taxon -> number of stored minimizers (showIndexStats support)."""
        t, c = np.unique(self.taxa, return_counts=True)
        return dict(zip(t.tolist(), c.tolist()))

    def distinct_minimizers_per_taxon(self) -> dict:
        # keys are unique already, so this equals records_per_taxon
        return self.records_per_taxon()
