"""Read classification driver (reference: Classifier.scala).

Pipeline per batch of reads (fixed-shape [B, L] code matrix):

  device: minimizer scan -> index binary-search probe -> per-window LCA taxa
          -> hit compaction -> batched resolveTree (clade-score vectors)
  host:   ambiguous-segment accounting, exact float64 confidence threshold
          pick (all thresholds reuse one device pass), per-read Kraken-format
          output lines, per-sample Kraken reports.

Paired-end reads are packed as R1 + one INVALID separator + R2 in a single
row: no k-mer window crosses the separator, the distinct-minimizer chain runs
through it (matching Supermers.scala:82-90 where the mate border does not
reset lastMinimizer), and the host splits the ordered hit list at the border
for output (the |:| marker, TaxonCounts.scala:94-110).
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass
from functools import partial
from typing import Dict, Iterable, List, NamedTuple, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .index import KeyValueIndex
from .ops import encode
from .ops import hitruns as hitruns_ops
from .ops import lookup as lookup_ops
from .ops import rle as rle_ops
from .ops import u64
from .ops import u128 as u128_mod
from .ops.minimizers import MinimizerParams, window_minimizers
from .ops.resolve import INVALID_WINDOW, compact_hits, resolve_hits
from .report import KrakenReport
from .taxonomy import NONE, Taxonomy
from .zio import ParallelGzipWriter
from . import utils

AMBIGUOUS_SPAN = -1  # package.scala:30
MATE_PAIR_BORDER = -2  # package.scala:31


class Fragment(NamedTuple):
    """An input read (or read pair) to classify (InputFragment analogue)."""

    title: str
    seq: str
    seq2: Optional[str] = None


@dataclass
class ClassifyParams:
    """Classification parameters (Classifier.scala:60-61)."""

    min_hit_groups: int = 2
    with_unclassified: bool = True
    thresholds: Sequence[float] = (0.0,)
    sample_regex: Optional[str] = None
    per_read_output: bool = True


@dataclass
class ClassifiedRead:
    sample_id: str
    classified: bool
    title: str
    taxon: int
    length_string: str
    hit_details: str

    @property
    def classify_flag(self) -> str:
        return "C" if self.classified else "U"

    def output_line(self) -> str:
        return f"{self.classify_flag}\t{self.title}\t{self.taxon}\t{self.length_string}\t{self.hit_details}"


# ---------------------------------------------------------------------------
# Device kernel
# ---------------------------------------------------------------------------


@partial(jax.jit, static_argnums=(6, 7, 8, 9, 10))
def _classify_kernel(
    codes, keys_hi, keys_lo, key_taxa, router, rpath_table,
    mp: MinimizerParams, max_taxa: int, rounds: int, bits: int,
    probe: tuple = ("routed",), lut=None,
):
    return _classify_body(
        codes, u64.U64(keys_hi, keys_lo), key_taxa, router, rpath_table, mp,
        max_taxa, rounds, bits, probe, lut,
    )


@partial(jax.jit, static_argnums=(7, 8, 9, 10, 11))
def _classify_kernel_packed(
    packed, valid, keys_hi, keys_lo, key_taxa, router, rpath_table,
    mp: MinimizerParams, max_taxa: int, rounds: int, bits: int,
    probe: tuple = ("routed",), lut=None,
):
    """_classify_kernel over wire-packed input (see encode.pack_2bit): the
    host ships 2 bits/base + 1 validity bit instead of a dense byte, and the
    device unpacks in a few elementwise ops — 3.6x less host->device traffic."""
    codes = encode.unpack_2bit_device(packed, valid)
    return _classify_body(
        codes, u64.U64(keys_hi, keys_lo), key_taxa, router, rpath_table, mp,
        max_taxa, rounds, bits, probe, lut,
    )


@partial(jax.jit, static_argnums=(4, 5, 6, 7))
def _classify_kernel_tiled(
    codes, table, router, rpath_table,
    mp: MinimizerParams, max_taxa: int, bits: int, probe: tuple = ("tiled", 16, False),
    lut=None,
):
    """_classify_kernel for the table-layout probes: `table` is the
    interleaved [n_rows, tile, 3] array from build_tiled (probe
    ("tiled", tile, dense)) or the [n_rows, tile, 3] table from build_hashed
    (probe ("hashed", tile, hash bits, dense) — router unused). dense=True
    probes every window position instead of compacting to span starts."""
    return _classify_body(
        codes, table, None, router, rpath_table, mp, max_taxa, 0, bits,
        probe, lut,
    )


@partial(jax.jit, static_argnums=(5, 6, 7, 8))
def _classify_kernel_packed_tiled(
    packed, valid, table, router, rpath_table,
    mp: MinimizerParams, max_taxa: int, bits: int, probe: tuple = ("tiled", 16, False),
    lut=None,
):
    codes = encode.unpack_2bit_device(packed, valid)
    return _classify_body(
        codes, table, None, router, rpath_table, mp, max_taxa, 0, bits,
        probe, lut,
    )


@partial(jax.jit, static_argnums=(5, 6, 7, 8, 9))
def _classify_kernel_wide(
    codes, keys, key_taxa, router, rpath_table,
    mp: MinimizerParams, max_taxa: int, rounds: int, bits: int,
    probe: tuple = ("routed_wide",),
):
    """_classify_kernel for wide (m > 31) indexes. probe ("routed_wide",):
    `keys` is a u128.U128 (four uint32 limb arrays); probe
    ("tiled_wide", tile, dense): `keys` is the [n_rows, tile, 5] table from
    build_tiled_wide and key_taxa is unused (None)."""
    return _classify_body(
        codes, keys, key_taxa, router, rpath_table, mp, max_taxa, rounds,
        bits, probe,
    )


@partial(jax.jit, static_argnums=(6, 7, 8, 9, 10))
def _classify_kernel_packed_wide(
    packed, valid, keys, key_taxa, router, rpath_table,
    mp: MinimizerParams, max_taxa: int, rounds: int, bits: int,
    probe: tuple = ("routed_wide",),
):
    codes = encode.unpack_2bit_device(packed, valid)
    return _classify_body(
        codes, keys, key_taxa, router, rpath_table, mp, max_taxa, rounds,
        bits, probe,
    )


def _classify_body(
    codes, keys, key_taxa, router, rpath_table,
    mp: MinimizerParams, max_taxa: int, rounds: int, bits: int, probe: tuple,
    lut=None,
):
    wm = window_minimizers(codes, mp, lut)
    looked = _probe_spans(wm, keys, key_taxa, router, rounds, bits, probe, 2 * mp.m)
    window_taxa = jnp.where(wm.valid, looked, INVALID_WINDOW).astype(jnp.int32)
    # hit groups: spans whose minimizer is distinct AND was found in the index
    # (Classifier.scala:92-95)
    num_distinct = jnp.sum(
        wm.span_start & wm.distinct & (looked > 0) & wm.valid, axis=-1
    ).astype(jnp.int32)
    ch = compact_hits(window_taxa, max_taxa)
    res = resolve_hits(ch.taxa, ch.counts, rpath_table)
    return window_taxa, num_distinct, ch, res, _host_bundle(num_distinct, ch, res)


def _host_bundle(num_distinct, ch, res):
    """Everything the host post-processing needs, in ONE i32 array
    [B, 5 + 2*D]: columns (num_distinct, n_hit_kmers, n_none_kmers,
    overflow, max_taxon, path[D], clade[D]). A single device->host transfer
    replaces six, each of which would pay the link's round-trip latency."""
    return jnp.concatenate(
        [
            num_distinct[:, None],
            ch.n_hit_kmers[:, None],
            ch.n_none_kmers[:, None],
            jnp.where(ch.overflow, 1, 0).astype(jnp.int32)[:, None],
            res.max_taxon[:, None],
            res.path,
            res.clade,
        ],
        axis=1,
    )


@jax.jit
def _finalize_kernel(res, num_distinct, n_hit, n_none, overflow, ambig, req_lut):
    """Per-threshold confidence resolution ON DEVICE (Classifier.scala:439-467
    semantics, bit-exact): replaces the [B, 5+2D] host bundle with a
    [B, 3+nthr] one — the big bundle's path/clade vectors exist only to let
    the host walk thresholds, and cost ~5.9 MB of d2h per batch.

    Exactness: the host computes required = ceil_f64(threshold * total).
    `total` is a small integer, so the host precomputes that f64 expression
    for EVERY possible total into req_lut [nthr, tmax+1] (int32) — the
    device then just gathers, reproducing float64 ceil semantics without
    any float arithmetic on device. `ambig` is the host-side ambiguous pseudo-kmer
    count per row (cheap, and only N-containing rows are scanned).

    Returns [B, 3+nthr] int32: (num_distinct, total, overflow, taxon per
    threshold — RAW, i.e. before the min-hit-groups gate, which the host
    applies so ClassifyParams stays a host concern).
    """
    total = n_hit + n_none + ambig  # [B] int32
    tmax = req_lut.shape[1] - 1
    req = req_lut[:, jnp.clip(total, 0, tmax)]  # [nthr, B]
    path, clade = res.path, res.clade  # [B, D]
    ok = (path != -1)[None] & (clade[None] >= req[:, :, None])  # [nthr, B, D]
    any_ok = ok.any(-1)
    d = path.shape[1]
    # deepest satisfying path position (host: argmax over the reversed row)
    dsel = d - 1 - jnp.argmax(ok[:, :, ::-1], axis=-1)  # [nthr, B]
    picked = path[jnp.arange(path.shape[0])[None, :], dsel]
    taxon = jnp.where(any_ok, picked, NONE)
    taxon = jnp.where(res.max_taxon[None] == NONE, NONE, taxon)
    return jnp.concatenate(
        [
            num_distinct[:, None],
            total[:, None],
            jnp.where(overflow, 1, 0).astype(jnp.int32)[:, None],
            taxon.T.astype(jnp.int32),
        ],
        axis=1,
    )


@jax.jit
def _window_codes_kernel(window_taxa, hit_taxa):
    """Dictionary-compress window_taxa for the d2h transfer: each window's
    taxon is one of the row's <= T compacted hit taxa (compact_hits), so a
    u8 index into that row's list carries the same information as the i32
    taxon. One [B, L + 4T] u8 bundle (codes | hit-taxa bytes) replaces the
    [B, L] i32 array — 2x fewer device->host bytes at L=128, T=32, for
    links where detailed mode is transfer-bound. Codes: 0..T-1 = index into hit_taxa row; 254 = NONE
    (index miss); 255 = invalid window.

    The code is the taxon's RANK in the row's list: compact_hits emits its
    taxa ascending (0-padded tail), so rank = count of nonzero entries
    below the window's taxon — T fused compare+add passes over [B, L], no
    [B, L, T] one-hot materialisation. Rows that
    overflowed max_taxa can hold taxa missing from the list, whose rank
    would silently alias a different entry — the HOST must densely refetch
    every overflow row (classify._hit_pairs uses batch.overflow)."""
    b, l = window_taxa.shape
    t = hit_taxa.shape[1]
    code = jnp.zeros((b, l), jnp.uint8)
    for j in range(t):
        col = hit_taxa[:, j : j + 1]  # [B, 1]
        code = code + ((col != NONE) & (col < window_taxa)).astype(jnp.uint8)
    code = jnp.where(
        window_taxa == INVALID_WINDOW,
        np.uint8(255),
        jnp.where(window_taxa == NONE, np.uint8(254), code),
    ).astype(jnp.uint8)
    taxa_bytes = jax.lax.bitcast_convert_type(hit_taxa, jnp.uint8).reshape(b, 4 * t)
    return jnp.concatenate([code, taxa_bytes], axis=1)


def _decode_window_codes(bundle: np.ndarray, l: int):
    """Host inverse of _window_codes_kernel: ([B, L] int32 window taxa,
    fallback row indices needing a dense refetch)."""
    codes = bundle[:, :l].astype(np.int64)
    t = (bundle.shape[1] - l) // 4
    taxa = bundle[:, l:].view("<i4").reshape(len(bundle), t)
    # lut columns: [taxa | NONE | INVALID_WINDOW]
    lut = np.concatenate(
        [
            taxa,
            np.full((len(bundle), 1), NONE, np.int32),
            np.full((len(bundle), 1), INVALID_WINDOW, np.int32),
        ],
        axis=1,
    )
    fallback = np.flatnonzero((codes == 253).any(axis=1))
    ci = np.where(codes == 254, t, np.where(codes >= 253, t + 1, codes))
    wt = np.take_along_axis(lut, ci, axis=1)
    return wt, fallback


def _ambig_array(codes, splits, row_lens, k, n):
    """[B] int32 ambiguous pseudo-kmer counts (_ambig_kmers per row); only
    rows whose invalid-char count exceeds pure padding are scanned."""
    ambig = np.zeros(codes.shape[0], np.int32)
    bucket = codes.shape[1]
    n_invalid = (codes[:n] == encode.INVALID).sum(axis=1)
    suspects = np.flatnonzero(
        n_invalid
        > (bucket - np.array(row_lens)) + np.array([s is not None for s in splits])
    )
    for i in suspects:
        ambig[i] = _ambig_kmers(codes[i], splits[i], row_lens[i], k)
    return ambig


def _probe_spans(wm, keys, key_taxa, router, rounds, bits, probe=("routed",), key_bits=62):
    """Probe the index once per super-mer span instead of once per window.

    All windows of a span share one minimizer (by construction), so span-start
    minimizers are compacted into a buffer of static size ~0.4*positions
    (spans occupy ~1/3 of window positions for W = k-m+1 = 5), probed, and
    scattered back via the span-id map. Overflowing batches (pathological
    reads where nearly every window starts a span) fall back to probing every
    position.

    keys: u64.U64 (m <= 31) or u128.U128 (wide m) index key arrays.
    probe: ("routed",) = router-accelerated binary search;
    ("bucketed", maxb) = direct-bucket wide-gather probe (keys/taxa must be
    the sentinel-padded arrays from pad_keys_for_buckets; m <= 31 only).
    """
    b, l = wm.valid.shape
    n = b * l
    cap = lookup_ops.span_query_cap(n)
    wide = probe[0] in ("routed_wide", "tiled_wide", "hashed1_wide") or isinstance(
        keys, u128_mod.U128
    )

    if wide:
        if probe[0] == "tiled_wide":
            # `keys` is the [n_rows, tile, 5] table from build_tiled_wide
            def lookup(q):
                return lookup_ops.lookup_taxa_tiled_wide(
                    keys, router, q, probe[1], bits, key_bits
                )

            if probe[-1]:
                # dense probing: same rationale as the narrow table probes
                return lookup(wm.minimizer)
        elif probe[0] == "hashed1_wide":
            # single-gather row-bucket table of raw limbs
            # (build_hashed_rows_wide); routerless
            def lookup(q):
                return lookup_ops.lookup_taxa_hashed_rows_wide(
                    keys, q, probe[1], probe[2], key_bits
                )

            if probe[-1]:
                return lookup(wm.minimizer)
        else:

            def lookup(q):
                return lookup_ops.lookup_taxa_routed_wide(
                    keys, key_taxa, router, q, rounds, bits, key_bits
                )

        q_limbs, sid, n_spans = lookup_ops.compact_span_queries_wide(wm, cap)
        q_compact = u128_mod.from_limbs(*q_limbs)
    elif probe[0] in ("tiled", "hashed", "hashed128", "hashed1"):

        if probe[0] == "hashed1":
            # single aligned row gather: the key's whole hash bucket is one
            # row (ops/lookup.py build_hashed_rows) — the shortest gather
            # chain an exact probe can have
            def lookup(q):
                return lookup_ops.lookup_taxa_hashed_rows(
                    keys, q, probe[1], probe[2], key_bits
                )

        elif probe[0] == "hashed":
            # routerless: two aligned row gathers around the home slot (the key's
            # own scrambled top bits are the home-slot hash; ops/lookup.py
            # build_hashed). `router` is an unused dummy here.
            def lookup(q):
                return lookup_ops.lookup_taxa_hashed(
                    keys, q, probe[1], probe[2], key_bits
                )

        elif probe[0] == "hashed128":
            # column-block rows ([n_rows, 3*tile], zero layout padding at
            # tile >= 128) at hash load factor ~1 (build_hashed_cols)
            def lookup(q):
                return lookup_ops.lookup_taxa_hashed_cols(
                    keys, q, probe[1], probe[2], key_bits
                )

        else:

            def lookup(q):
                return lookup_ops.lookup_taxa_tiled(
                    keys, router, q, probe[1], bits, key_bits
                )

        if probe[-1]:
            # Dense probing ("tiled", tile, True): probe every position and
            # skip the span compaction + scatter-back, which cost more than
            # the extra independent table gathers wherever gathers pipeline.
            # Span compaction stays for the routed/bucketed/wide probes
            # (probe cost dominates) and the ring layout (it saves
            # inter-device bytes, parallel/mesh.py). Outputs
            # are identical: all windows of a span probe the same key, and
            # invalid-position garbage is masked by wm.valid downstream
            # (exactly the established overflow-fallback semantics).
            return lookup(wm.minimizer)
        q_hi, q_lo, sid, n_spans = lookup_ops.compact_span_queries(wm, cap)
        q_compact = u64.U64(q_hi, q_lo)
    else:
        q_hi, q_lo, sid, n_spans = lookup_ops.compact_span_queries(wm, cap)

        def lookup(q):
            if probe[0] == "bucketed":
                return lookup_ops.lookup_taxa_bucketed(
                    keys, key_taxa, router, q, probe[1], bits, key_bits
                )
            return lookup_ops.lookup_taxa_routed(
                keys, key_taxa, router, q, rounds, bits, key_bits
            )

        q_compact = u64.U64(q_hi, q_lo)

    def compacted(_):
        probed = lookup(q_compact)
        return probed[jnp.clip(sid, 0, cap - 1)].reshape(b, l)

    def full(_):
        return lookup(wm.minimizer)

    return jax.lax.cond(n_spans > cap, full, compacted, operand=None)


# ---------------------------------------------------------------------------
# Host helpers: exact resolveTree fallback + ordered hit reconstruction
# ---------------------------------------------------------------------------


def _resolve_host(parents: np.ndarray, hit_counts: Dict[int, int], required: float) -> int:
    """Exact host resolveTree for reads overflowing the device's max-taxa
    budget (LowestCommonAncestor.scala:101-146)."""

    def path(t):
        out = []
        while t != NONE:
            out.append(t)
            t = int(parents[t])
        return out

    def lca(a, b):
        if a == NONE or b == NONE:
            return a if b == NONE else b
        pa = set(path(a))
        t = b
        while t != NONE:
            if t in pa:
                return t
            t = int(parents[t])
        return 1

    max_taxon, max_score = 0, 0
    for taxon in hit_counts:
        if taxon == NONE:
            continue
        score = sum(hit_counts.get(n, 0) for n in path(taxon))
        if score > max_score:
            max_taxon, max_score = taxon, score
        elif score == max_score:
            max_taxon = lca(max_taxon, taxon)

    max_score = hit_counts.get(max_taxon, 0)
    while max_taxon != NONE and max_score < required:
        anc = max_taxon
        max_score = sum(
            c for t, c in hit_counts.items() if t != NONE and anc in path(t)
        )
        if max_score >= required:
            return max_taxon
        max_taxon = int(parents[max_taxon])
    return max_taxon


def _char_runs(valid: np.ndarray):
    """Yield (start, end, is_valid) maximal runs of the boolean array."""
    n = len(valid)
    if n == 0:
        return
    change = np.flatnonzero(valid[1:] != valid[:-1]) + 1
    bounds = [0, *change.tolist(), n]
    for a, b in zip(bounds[:-1], bounds[1:]):
        yield a, b, bool(valid[a])


def mate_hits(codes: np.ndarray, window_taxa: np.ndarray, a: int, b: int, k: int):
    """Ordered (taxon, kmer-count) hit pairs for one mate occupying row
    columns [a, b), merging adjacent equal taxa (TaxonCounts.fromHits,
    TaxonCounts.scala:31-48). Ambiguous char-runs >= k become (-1, len-k+1)
    pseudo-hits; shorter ambiguous/valid runs are dropped
    (Supermers.scala:113-125)."""
    hits: List[List[int]] = []

    def add(taxon, count):
        if hits and hits[-1][0] == taxon:
            hits[-1][1] += count
        else:
            hits.append([taxon, count])

    valid = codes[a:b] < 4
    for i, j, is_valid in _char_runs(valid):
        runlen = j - i
        if runlen < k:
            continue
        if is_valid:
            for w in range(a + i, a + j - k + 1):
                add(int(window_taxa[w]), 1)
        else:
            add(AMBIGUOUS_SPAN, runlen - k + 1)
    return hits


def hits_to_strings(hits_parts: List[List[List[int]]], k: int) -> Tuple[str, str]:
    """(hit_details, length_string) from per-mate ordered hit lists
    (TaxonCounts.scala:94-121)."""
    pieces = []
    lengths = []
    for part in hits_parts:
        for taxon, count in part:
            pieces.append(("A" if taxon == AMBIGUOUS_SPAN else str(taxon)) + f":{count}")
        lengths.append(sum(c for _, c in part) + (k - 1))
        pieces.append("|:|")
    pieces.pop()  # drop trailing border
    return " ".join(pieces), "|".join(str(x) for x in lengths)


# ---------------------------------------------------------------------------
# Classifier
# ---------------------------------------------------------------------------


@dataclass
class _BatchResult:
    titles: List[str]
    window_taxa: np.ndarray  # [B, L]
    codes: np.ndarray  # [B, L]
    mate_split: List[Optional[int]]  # len1 per row if paired
    row_lens: List[int]  # true row content length (trailing Ns are content!)
    num_distinct: np.ndarray
    total_kmers: np.ndarray  # valid windows + ambiguous pseudo-kmers
    res_max_taxon: Optional[np.ndarray]  # None when finalised on device
    res_path: Optional[np.ndarray]
    res_clade: Optional[np.ndarray]
    overflow: np.ndarray
    hit_taxa: np.ndarray  # [B, T]
    hit_counts: np.ndarray  # [B, T]
    #: device RLE bundle of window_taxa (ops.rle) when detailed output is on
    #: and the backend benefits from compact d2h transfers; None otherwise
    window_rle: Optional[object] = None
    #: device [B, L + 4T] u8 dictionary-compressed window taxa
    #: (_window_codes_kernel) — the accelerator detailed-mode transfer
    window_codes: Optional[object] = None
    #: device bundle of FINAL per-read hit runs (ops.hitruns) — the default
    #: detailed-mode transfer; None when disabled
    hit_runs: Optional[object] = None
    #: {threshold: raw per-read taxon} computed by _finalize_kernel on
    #: device (before the min-hit-groups gate); None in legacy host mode
    final_taxa: Optional[Dict[float, np.ndarray]] = None


def default_probe(index: KeyValueIndex, keys_per_device: Optional[int] = None) -> str:
    """The probe kernel used when none is named: by Classifier and its mesh
    subclasses, Dynamic's span counting and the multi-host ring.

    CPU: "routed" binary search (the table probes' wide row gathers thrash
    CPU caches). GPU: the single-gather row-bucket "hashed1" table, or
    "tiled" row gathers for wide (m > 31) indexes and for tables beyond
    fits_hashed_rows' share of device memory. `keys_per_device` is the
    largest key count one device's table holds where the index is split
    over devices (default: the whole index)."""
    if utils.backend() == "cpu":
        return "routed"
    n_keys = index.num_records if keys_per_device is None else keys_per_device
    if index.wide or not lookup_ops.fits_hashed_rows(n_keys):
        return "tiled"
    return "hashed1"


class Classifier:
    """Classify reads against a KeyValueIndex (Classifier.scala:66)."""

    def __init__(
        self,
        index: KeyValueIndex,
        max_taxa_per_read: int = 32,
        target_batch_bp: Optional[int] = None,
        probe: Optional[str] = None,
        packed_transfer: Optional[bool] = None,
    ):
        self.index = index
        self.max_taxa = max_taxa_per_read
        self._table_dev = jnp.asarray(index.taxonomy.rpath_table())
        self.max_path = index.taxonomy.max_path_len

        # probe kernel (see ops.lookup); the platform default comes from
        # default_probe, STPU_PROBE overrides it
        self._dev_lut = index.device_lut  # None for the xor ordering
        if probe is None:
            probe = os.environ.get("STPU_PROBE") or default_probe(index)
        self.probe = probe
        if index.wide and probe not in ("routed", "tiled", "hashed1"):
            raise NotImplementedError(
                "wide (m > 31) indexes support the routed, tiled and "
                "hashed1 probes"
            )
        # dense (per-position) probing beats span compaction wherever
        # gathers pipeline (the GPU); see _probe_spans.
        env_dense = os.environ.get("STPU_TILED_DENSE")
        if env_dense is not None:
            if env_dense.lower() in ("1", "true", "yes", "on"):
                dense = True
            elif env_dense.lower() in ("0", "false", "no", "off"):
                dense = False
            else:
                raise ValueError(
                    f"STPU_TILED_DENSE={env_dense!r}: use 1/0 (true/false)"
                )
        else:
            dense = utils.backend() == "gpu"
        if index.wide:
            if probe == "tiled":
                dk, tile = index.device_tiled
                dt = None
                self._probe_static = ("tiled_wide", tile, dense)
            elif probe == "hashed1":
                dk, tile, rbits = index.device_hashed_rows
                dt = None
                self._probe_static = ("hashed1_wide", tile, rbits, dense)
            else:
                dk = index.device_keys
                dt = index.device_taxa
                self._probe_static = ("routed_wide",)
        elif probe == "bucketed":
            dk, dt, maxb = index.device_bucketed
            self._probe_static = ("bucketed", maxb)
        elif probe in ("tiled", "hashed", "hashed128", "hashed1"):
            dt = None
            if probe == "hashed":
                dk, tile, hbits = index.device_hashed
                self._probe_static = ("hashed", tile, hbits, dense)
            elif probe == "hashed128":
                dk, tile, hbits = index.device_hashed_cols
                self._probe_static = ("hashed128", tile, hbits, dense)
            elif probe == "hashed1":
                dk, tile, rbits = index.device_hashed_rows
                self._probe_static = ("hashed1", tile, rbits, dense)
            else:
                dk, tile = index.device_tiled
                self._probe_static = ("tiled", tile, dense)
        elif probe == "routed":
            dk = index.device_keys
            dt = index.device_taxa
            self._probe_static = ("routed",)
        else:
            raise ValueError(f"unknown probe mode {probe!r}")
        self._dev_keys = dk
        self._dev_taxa = dt

        # batch size per platform, chosen AFTER probe resolution because the
        # dispatch's transient memory depends on the probe's gather layout:
        # hashed1's [Q, 3*tile] gather result is dense, while the other
        # probes' [Q, tile, 3] results may pad their minor dims (~1.5 kB per
        # query), so next to a very large table they keep a 1 Mbp cap. 1 Mbp
        # keeps the CPU backend's working set in cache.
        if target_batch_bp is None:
            if utils.backend() == "cpu":
                target_batch_bp = 1 << 20
            elif self._probe_static[0] in ("hashed1", "hashed1_wide"):
                target_batch_bp = 1 << 22
            elif 12 * index.num_records > (1 << 29):
                target_batch_bp = 1 << 20
            else:
                target_batch_bp = 1 << 21
        self.target_batch_bp = target_batch_bp

        # wire-packed host->device transfer (2 bit/base + validity bit):
        # pays off whenever the link is slower than the pack (PCIe);
        # pointless for the CPU backend
        if packed_transfer is None:
            env = os.environ.get("STPU_PACKED_TRANSFER")
            if env is not None:
                packed_transfer = env == "1"
            else:
                packed_transfer = utils.backend() == "gpu"
        self._packed_transfer = packed_transfer
        #: set per call by the detailed-output paths (window_taxa is only
        #: fetched to host when per-read lines are produced)
        self._fetch_window_taxa = False
        #: reduce each read to its FINAL ordered hit runs on device
        #: (ops.hitruns) so detailed mode transfers ~90 B/read instead of
        #: the dense [B, L] window-taxa array, and the host formats O(runs)
        #: per row. Default OFF: with the native dense full-line formatter
        #: (stpu_output_lines_dense) the dense transfer is the faster CPU
        #: path. Exception: a no-compiler CPU host (no native formatter)
        #: keeps the runs default — there the O(runs) Python formatting
        #: beats the dense per-window walk. STPU_HIT_RUNS=1/0 overrides.
        from . import native as _native

        hr_default = (
            "1" if utils.backend() == "cpu" and not _native.available() else "0"
        )
        self._hit_runs = os.environ.get("STPU_HIT_RUNS", hr_default) == "1"
        #: dictionary-compressed window-taxa transfer for detailed mode
        #: (_window_codes_kernel): halves d2h bytes for the dominant L=128,
        #: T=32 shape, at the cost of T compare passes over [B, L] on
        #: device. Off by default; STPU_WINDOW_CODES=1 for d2h-starved
        #: links.
        self._window_codes = os.environ.get("STPU_WINDOW_CODES", "0") == "1"
        #: opt-in alternative: device RLE of window_taxa (ops.rle),
        #: superseded by hit_runs above.
        self._wt_rle = os.environ.get("STPU_WT_RLE") == "1"
        #: thresholds for on-device finalisation (set per call from cpar by
        #: the high-level entry points); None => legacy host finalize with
        #: the full path/clade bundle. STPU_DEVICE_FINALIZE=0 forces legacy.
        self._finalize_thresholds: Optional[Tuple[float, ...]] = None
        self._device_finalize = os.environ.get("STPU_DEVICE_FINALIZE", "1") == "1"
        self._req_lut_cache: Dict[tuple, object] = {}
        #: per-read output part file index (multi-host runs give each
        #: process its own part so outputs merge collision-free in one dir)
        self._part_index = 0
        with jax.ensure_compile_time_eval():
            self._router_dummy = jnp.zeros(2, jnp.int32)

    # -- batching -----------------------------------------------------------

    def _row_length_bucket(self, n: int) -> int:
        b = 128
        while b < n:
            b *= 2
        return b

    def _pack_rows(self, frags: List[Fragment], bucket: int):
        rows = []
        splits: List[Optional[int]] = []
        for f in frags:
            c1 = encode.encode_seq(f.seq)
            if f.seq2 is not None:
                c2 = encode.encode_seq(f.seq2)
                row = np.concatenate([c1, np.array([encode.INVALID], np.uint8), c2])
                splits.append(len(c1))
            else:
                row = c1
                splits.append(None)
            rows.append(row)
        codes, _ = encode.pack_batch(rows, bucket)
        return codes, splits

    def _run_batch(self, frags: List[Fragment], bucket: int) -> _BatchResult:
        return self._harvest(self._dispatch_batch(frags, bucket))

    def _dispatch_batch(self, frags: List[Fragment], bucket: int):
        codes, splits = self._pack_rows(frags, bucket)
        titles = [f.title for f in frags]
        row_lens = [
            len(f.seq) + (len(f.seq2) + 1 if f.seq2 is not None else 0) for f in frags
        ]
        return self._dispatch_codes(codes, titles, splits, row_lens)

    def _run_codes(
        self,
        codes: np.ndarray,
        titles: List[str],
        splits: List[Optional[int]],
        row_lens: List[int],
    ) -> _BatchResult:
        return self._harvest(self._dispatch_codes(codes, titles, splits, row_lens))

    def _dispatch_codes(
        self,
        codes: np.ndarray,
        titles: List[str],
        splits: List[Optional[int]],
        row_lens: List[int],
    ):
        """Asynchronously dispatch one batch to the device; pair with
        _harvest. jax dispatch is non-blocking, so a second batch can be in
        flight while the host post-processes the previous one."""
        bucket = codes.shape[1]
        # pad the row count to a power of two (full batches arrive at the
        # fixed rows_target already) so only O(log) shapes ever compile
        b_fixed = 8
        while b_fixed < codes.shape[0]:
            b_fixed *= 2
        if codes.shape[0] < b_fixed:
            pad = np.full((b_fixed - codes.shape[0], bucket), encode.INVALID, np.uint8)
            codes = np.concatenate([codes, pad], axis=0)
        idx = self.index
        if idx.wide:
            # hashed1_wide is routerless: never build/upload the wide router
            h1w = self._probe_static[0] == "hashed1_wide"
            common = (
                self._dev_keys,
                self._dev_taxa,
                self._router_dummy if h1w else idx.device_router,
                self._table_dev,
                idx.params.minimizer_params,
                self.max_taxa,
                0 if h1w else idx.router_rounds,
                0 if h1w else idx.router_bits,
                self._probe_static,
            )
            if self._packed_transfer and bucket % 8 == 0:
                packed, valid = encode.pack_2bit(codes)
                outs = _classify_kernel_packed_wide(packed, valid, *common)
                return self._post_dispatch(
                    outs, codes, titles, splits, row_lens, wire_valid=valid
                )
            outs = _classify_kernel_wide(codes, *common)
            return self._post_dispatch(outs, codes, titles, splits, row_lens)
        if self._probe_static[0] in ("tiled", "hashed", "hashed128", "hashed1"):
            hashed = self._probe_static[0] in ("hashed", "hashed128", "hashed1")
            common = (
                self._dev_keys,
                # the hashed probe is routerless: never build the router
                self._router_dummy if hashed else idx.device_router,
                self._table_dev,
                idx.params.minimizer_params,
                self.max_taxa,
                0 if hashed else idx.router_bits,
                self._probe_static,
                self._dev_lut,
            )
            if self._packed_transfer and bucket % 8 == 0:
                packed, valid = encode.pack_2bit(codes)
                outs = _classify_kernel_packed_tiled(packed, valid, *common)
                return self._post_dispatch(
                    outs, codes, titles, splits, row_lens, wire_valid=valid
                )
            outs = _classify_kernel_tiled(codes, *common)
            return self._post_dispatch(outs, codes, titles, splits, row_lens)
        common = (
            self._dev_keys.hi,
            self._dev_keys.lo,
            self._dev_taxa,
            idx.device_router,
            self._table_dev,
            idx.params.minimizer_params,
            self.max_taxa,
            idx.router_rounds,
            idx.router_bits,
            self._probe_static,
            self._dev_lut,
        )
        if self._packed_transfer and bucket % 8 == 0:
            packed, valid = encode.pack_2bit(codes)
            outs = _classify_kernel_packed(packed, valid, *common)
            return self._post_dispatch(
                outs, codes, titles, splits, row_lens, wire_valid=valid
            )
        outs = _classify_kernel(codes, *common)
        return self._post_dispatch(outs, codes, titles, splits, row_lens)

    def _req_lut(self, thresholds: Tuple[float, ...], tmax: int):
        """Device [nthr, tmax+1] int32 table of ceil_f64(t * total) for every
        possible integer total — the exact host expression, precomputed."""
        key = (thresholds, tmax)
        lut = self._req_lut_cache.get(key)
        if lut is None:
            totals = np.arange(tmax + 1, dtype=np.float64)
            lut = jnp.asarray(
                np.stack([np.ceil(t * totals) for t in thresholds]).astype(
                    np.int32
                )
            )
            self._req_lut_cache[key] = lut
        return lut

    def _post_dispatch(self, outs, codes, titles, splits, row_lens,
                       wire_valid=None):
        """Attach either the device-finalised [B, 3+nthr] bundle (thresholds
        known up front — the production paths) or the legacy full host
        bundle to the dispatched batch. wire_valid: pack_2bit's validity
        bitmask when the batch used the packed transfer (reused by the
        hit-runs reduction instead of re-uploading a dense bool mask)."""
        window_taxa, num_distinct, ch, res, hostpack = outs
        if self._finalize_thresholds is not None and self._device_finalize:
            ambig = _ambig_array(
                codes, splits, row_lens, self.index.params.k, len(titles)
            )
            lut = self._req_lut(self._finalize_thresholds, codes.shape[1])
            pack = _finalize_kernel(
                res,
                num_distinct,
                ch.n_hit_kmers,
                ch.n_none_kmers,
                ch.overflow,
                jnp.asarray(ambig),
                lut,
            )
            return (
                window_taxa, ch, pack, codes, titles, splits, row_lens,
                True, wire_valid,
            )
        return (
            window_taxa, ch, hostpack, codes, titles, splits, row_lens,
            False, wire_valid,
        )

    def _harvest(self, dispatched) -> _BatchResult:
        (window_taxa, ch, pack, codes, titles, splits, row_lens, devfin,
         wire_valid) = dispatched
        idx = self.index
        n = len(titles)
        k = idx.params.k
        window_rle = None
        hit_runs_dev = None
        window_codes_dev = None
        hr_splits = hr_lens = None
        if self._fetch_window_taxa and window_taxa.shape[1] < (1 << 16):
            # dispatch the detailed-output reductions now (async) so they
            # run while the host blocks on the bundle below
            if self._hit_runs:
                b_fixed = window_taxa.shape[0]
                hr_splits = np.full(b_fixed, -1, np.int64)
                hr_splits[:n] = [-1 if s is None else s for s in splits]
                hr_lens = np.zeros(b_fixed, np.int64)
                hr_lens[:n] = row_lens
                if wire_valid is not None:
                    vc = encode.unpack_valid_device(
                        jnp.asarray(wire_valid), window_taxa.shape[1]
                    )
                else:
                    vc = jnp.asarray(codes < encode.INVALID)
                hit_runs_dev = hitruns_ops.hit_runs(
                    window_taxa,
                    vc,
                    jnp.asarray(hr_splits, jnp.int32),
                    jnp.asarray(hr_lens, jnp.int32),
                    k,
                    hitruns_ops.DEFAULT_RUNS_PER_ROW,
                )
            elif self._wt_rle:
                window_rle = rle_ops.encode_rows(
                    window_taxa, rle_ops.DEFAULT_RUNS_PER_ROW
                )
            elif self._window_codes and self.max_taxa <= 250:
                # the u8 code space reserves 253/254/255; larger hit lists
                # would collide with the sentinels and wrap mod 256
                window_codes_dev = _window_codes_kernel(window_taxa, ch.taxa)
        # ONE device->host transfer for all the scalar-per-read outputs;
        # window_taxa stays device-lazy
        common = dict(
            titles=titles,
            window_taxa=window_taxa,  # device array; transferred lazily
            codes=codes[:n],
            mate_split=splits,
            row_lens=row_lens,
            hit_taxa=ch.taxa,  # device; rarely needed on host
            hit_counts=ch.counts,
            window_rle=window_rle,
            window_codes=window_codes_dev,
            hit_runs=hit_runs_dev,
        )
        # window_taxa's transfer stays lazy (_hit_pairs fetches on use)
        if devfin:
            fb = np.asarray(pack)[:n]
            thresholds = self._finalize_thresholds
            return _BatchResult(
                num_distinct=fb[:, 0],
                total_kmers=fb[:, 1].astype(np.int64),
                res_max_taxon=None,
                res_path=None,
                res_clade=None,
                overflow=fb[:, 2] != 0,
                final_taxa={
                    t: fb[:, 3 + i].astype(np.int64)
                    for i, t in enumerate(thresholds)
                },
                **common,
            )
        hp = np.asarray(pack)[:n]
        d = self.max_path
        # ambiguous pseudo-kmer accounting (device finalize folds this into
        # the bundle's total column via _ambig_array instead)
        total = (hp[:, 1] + hp[:, 2]).astype(np.int64)
        total += _ambig_array(codes, splits, row_lens, k, n)[:n]
        return _BatchResult(
            num_distinct=hp[:, 0],
            total_kmers=total,
            res_max_taxon=hp[:, 4],
            res_path=hp[:, 5 : 5 + d],
            res_clade=hp[:, 5 + d : 5 + 2 * d],
            overflow=hp[:, 3] != 0,
            **common,
        )

    def _rows_target(self, bucket: int) -> int:
        return max(8, self.target_batch_bp // bucket)

    def batches(self, fragments: Iterable[Fragment]):
        """Group fragments into shape-bucketed batches and run the device
        pipeline, yielding (_BatchResult, input positions). Mixed-length
        inputs are regrouped by bucket, so callers needing input order use
        the positions (classify() restores it)."""
        import collections
        import os as _os

        depth = max(1, int(_os.environ.get("STPU_PIPELINE_DEPTH", "3")))
        pending: Dict[int, List] = {}
        in_flight = collections.deque()  # (dispatched device batch, positions)

        def submit(lst, bucket):
            dispatched = self._dispatch_batch([x[1] for x in lst], bucket)
            in_flight.append((dispatched, [x[0] for x in lst]))
            out = []
            while len(in_flight) > depth:
                d, p = in_flight.popleft()
                out.append((self._harvest(d), p))
            return out

        for pos, f in enumerate(fragments):
            n = len(f.seq) + (len(f.seq2) + 1 if f.seq2 is not None else 0)
            bucket = self._row_length_bucket(n)
            lst = pending.setdefault(bucket, [])
            lst.append((pos, f))
            if len(lst) >= self._rows_target(bucket):
                yield from submit(lst, bucket)
                pending[bucket] = []
        for bucket, lst in pending.items():
            if lst:
                yield from submit(lst, bucket)
        while in_flight:
            d, p = in_flight.popleft()
            yield (self._harvest(d), p)

    def packed_batches(self, packed_iter):
        """Run pre-packed code batches (native.PackedReads) through the
        device pipeline — the zero-copy fast path fed by the C++ parser.
        Same-width chunks are coalesced into full device batches across the
        stream (no per-chunk tail padding), and the pipeline is
        pipelined: up to `STPU_PIPELINE_DEPTH` (default 2) batches compute
        on device while the host post-processes earlier ones. The input
        iterator itself runs in a background thread (the C++ parser releases
        the GIL), so file parse, host post-processing and device compute all
        overlap."""
        import collections
        import os as _os

        from .utils import prefetch_iterator

        depth = max(1, int(_os.environ.get("STPU_PIPELINE_DEPTH", "3")))
        packed_iter = prefetch_iterator(packed_iter, depth=2)
        pending = collections.deque()
        buffers: Dict[int, list] = {}  # width -> [(codes, titles, splits, lens)]

        def emit(width, force=False):
            nonlocal pending
            rows_target = self._rows_target(width)
            buf = buffers.get(width, [])
            count = sum(len(x[1]) for x in buf)
            while count >= rows_target or (force and count > 0):
                take = min(count, rows_target)
                codes_parts, titles, splits, lens = [], [], [], []
                got = 0
                while got < take:
                    c, t, s, l = buf[0]
                    need = take - got
                    if len(t) <= need:
                        codes_parts.append(c)
                        titles += t
                        splits += s
                        lens += l
                        got += len(t)
                        buf.pop(0)
                    else:
                        codes_parts.append(c[:need])
                        titles += t[:need]
                        splits += s[:need]
                        lens += l[:need]
                        buf[0] = (c[need:], t[need:], s[need:], l[need:])
                        got = take
                count -= take
                dispatched = self._dispatch_codes(
                    np.ascontiguousarray(np.concatenate(codes_parts))
                    if len(codes_parts) > 1
                    else np.ascontiguousarray(codes_parts[0]),
                    titles,
                    splits,
                    lens,
                )
                pending.append(dispatched)
                while len(pending) > depth:
                    yield self._harvest(pending.popleft())
            buffers[width] = buf

        for packed in packed_iter:
            width = packed.codes.shape[1]
            if getattr(packed, "splits", None) is not None:
                splits = [int(x) for x in packed.splits]
            else:
                splits = [None] * len(packed)
            buffers.setdefault(width, []).append(
                (packed.codes, list(packed.titles), splits, [int(x) for x in packed.lengths])
            )
            yield from emit(width)
        for width in list(buffers):
            yield from emit(width, force=True)
        while pending:
            yield self._harvest(pending.popleft())

    def classify_packed(self, packed_iter, cpar: ClassifyParams):
        self._fetch_window_taxa = bool(cpar.per_read_output)
        self._finalize_thresholds = tuple(cpar.thresholds)
        results: Dict[float, List[ClassifiedRead]] = {t: [] for t in cpar.thresholds}
        for batch in self.packed_batches(packed_iter):
            for t in cpar.thresholds:
                results[t].extend(self.finalize(batch, t, cpar))
        return results

    # -- per-threshold finalisation -----------------------------------------

    def finalize(
        self, batch: _BatchResult, threshold: float, cpar: ClassifyParams
    ) -> List[ClassifiedRead]:
        """Apply one confidence threshold to a batch's device results
        (host-exact, float64 ceil — Classifier.scala:439-467)."""
        n = len(batch.titles)
        taxon, classified = self._finalize_taxa(batch, threshold, cpar)
        report_taxon = np.where(classified, taxon, NONE)

        if cpar.sample_regex:
            sre = re.compile(cpar.sample_regex)
            samples = []
            for t in batch.titles:
                m = sre.search(t)
                samples.append(m.group(1) if m else "other")
        else:
            samples = ["all"] * n

        k = self.index.params.k
        if cpar.per_read_output:
            pairs = self._hit_pairs(batch)
            return [
                ClassifiedRead(
                    samples[i],
                    bool(classified[i]),
                    batch.titles[i],
                    int(report_taxon[i]),
                    pairs[i][1],
                    pairs[i][0],
                )
                for i in range(n)
            ]
        return [
            ClassifiedRead(samples[i], bool(classified[i]), batch.titles[i], int(report_taxon[i]), "", "")
            for i in range(n)
        ]

    def _hit_pairs(self, batch: _BatchResult):
        """(hit_details, length_string) per read, memoised on the batch —
        identical across thresholds, so multi-threshold runs format once."""
        cached = getattr(batch, "_hit_pairs_cache", None)
        if cached is not None:
            return cached
        n = len(batch.titles)
        k = self.index.params.k
        if batch.hit_runs is not None:
            pairs = self._pairs_from_runs(batch, n, k)
            if pairs is not None:
                batch._hit_pairs_cache = pairs
                return pairs
        wt_host = self._dense_window_taxa(batch, n)
        from . import native

        splits = np.array([-1 if s is None else s for s in batch.mate_split], np.int64)
        pairs = native.hit_lines(batch.codes, wt_host, splits, batch.row_lens, k)
        if pairs is None:
            pairs = []
            for i in range(n):
                parts = _row_hit_parts(
                    batch.codes[i], wt_host[i], batch.mate_split[i], batch.row_lens[i], k
                )
                details, length_string = hits_to_strings(parts, k)
                pairs.append((details, length_string))
        batch._hit_pairs_cache = pairs
        return pairs

    def _dense_window_taxa(self, batch: _BatchResult, n: int) -> np.ndarray:
        """Host [n, L] window taxa for detailed output, decoding whichever
        compact d2h transfer the batch carries (dict codes / RLE / dense)."""
        if batch.window_codes is not None:
            L = batch.window_taxa.shape[1]
            wt_host, fallback = _decode_window_codes(
                np.asarray(batch.window_codes)[:n], L
            )
            # rows that overflowed max_taxa can hold taxa absent from the
            # dictionary whose rank code aliases another entry: refetch
            # every overflow row densely (see _window_codes_kernel)
            fallback = np.union1d(fallback, np.flatnonzero(batch.overflow[:n]))
            if len(fallback):
                wt_host[fallback] = np.asarray(batch.window_taxa[fallback])
            return wt_host
        if batch.window_rle is not None:
            L = batch.window_taxa.shape[1]
            dense, overflow_rows = rle_ops.decode_rows(
                np.asarray(batch.window_rle), L, rle_ops.DEFAULT_RUNS_PER_ROW
            )
            if len(overflow_rows):
                # rare rows with more runs than the cap: refetch densely
                dense[overflow_rows] = np.asarray(
                    batch.window_taxa[overflow_rows]
                )
            return dense[:n]
        return np.asarray(batch.window_taxa)[:n]

    def _pairs_from_runs(self, batch: _BatchResult, n: int, k: int):
        """(details, length) pairs from the device hit-runs bundle; rows
        overflowing the run cap fall back to the dense per-row host path."""
        from . import native

        cap = hitruns_ops.DEFAULT_RUNS_PER_ROW
        bundle = np.asarray(batch.hit_runs)[:n]
        values, counts, nruns, totals, overflow_rows = hitruns_ops.decode(
            bundle, cap
        )
        splits = np.array(
            [-1 if s is None else s for s in batch.mate_split], np.int64
        )
        pairs = native.hit_lines_runs(
            values, counts, np.minimum(nruns, cap), totals, splits, k
        )
        if pairs is None:
            # no native library: assemble from the runs in Python
            pairs = []
            for i in range(n):
                parts = [[]] if batch.mate_split[i] is None else [[], []]
                for j in range(min(int(nruns[i]), cap)):
                    pv = int(values[i, j])
                    taxon = (pv >> 1) - 2
                    parts[pv & 1].append(
                        [AMBIGUOUS_SPAN if taxon == -1 else taxon, int(counts[i, j])]
                    )
                pairs.append(hits_to_strings(parts, k))
        if len(overflow_rows):
            wt = np.asarray(batch.window_taxa[overflow_rows])
            for w_row, i in zip(wt, overflow_rows.tolist()):
                parts = _row_hit_parts(
                    batch.codes[i], w_row, batch.mate_split[i],
                    batch.row_lens[i], k,
                )
                pairs[i] = hits_to_strings(parts, k)
        return pairs

    # -- high level ----------------------------------------------------------

    def classify(
        self, fragments: Iterable[Fragment], cpar: ClassifyParams
    ) -> Dict[float, List[ClassifiedRead]]:
        """Classify all fragments at every threshold (one device pass total,
        generalising the reference's multi-threshold cache,
        Classifier.scala:156-170). Results preserve input order."""
        self._fetch_window_taxa = bool(cpar.per_read_output)
        self._finalize_thresholds = tuple(cpar.thresholds)
        acc: Dict[float, List] = {t: [] for t in cpar.thresholds}
        for batch, positions in self.batches(fragments):
            for t in cpar.thresholds:
                for pos, read in zip(positions, self.finalize(batch, t, cpar)):
                    acc[t].append((pos, read))
        return {
            t: [read for _, read in sorted(pairs, key=lambda x: x[0])]
            for t, pairs in acc.items()
        }

    def classify_and_write_packed(
        self, packed_iter, output_location: str, cpar: ClassifyParams
    ) -> Dict[float, List[str]]:
        """classify_and_write over native-packed batches (fast path).

        In reports-only mode per-read results are never materialised: per
        (sample, taxon) counts are aggregated streaming, like the reference's
        SQL classifier (Classifier.scala:259-410)."""
        if not cpar.per_read_output:
            return self._aggregate_and_write(packed_iter, output_location, cpar)
        return self._stream_detailed_and_write(packed_iter, output_location, cpar)

    def _stream_detailed_and_write(self, packed_iter, output_location, cpar):
        """Detailed mode, streaming: write each batch's per-read lines as
        device results arrive (constant memory; writing overlaps the next
        batch's device compute via the double-buffered batcher)."""
        self._fetch_window_taxa = True
        self._finalize_thresholds = tuple(cpar.thresholds)
        writers: Dict[tuple, object] = {}
        counts: Dict[float, Dict[str, Dict[int, int]]] = {t: {} for t in cpar.thresholds}

        def writer_for(t, sample):
            key = (t, sample)
            if key not in writers:
                loc = output_location + "_c" + format_threshold(t, cpar.thresholds)
                d = os.path.join(loc, f"sample={sample}")
                os.makedirs(d, exist_ok=True)
                writers[key] = ParallelGzipWriter(
                    os.path.join(d, f"part-{self._part_index:05d}.txt.gz"),
                    level=1,
                )
            return writers[key]

        sre = re.compile(cpar.sample_regex) if cpar.sample_regex else None
        try:
            for batch in self.packed_batches(packed_iter):
                n = len(batch.titles)
                # fully-native line emission from device hit runs (no
                # per-read Python); falls back to the pairs + f-string path
                # when runs are unavailable or a row overflowed the cap
                from . import native

                tb = [s.encode("utf-8") for s in batch.titles]
                toffs = np.zeros(n + 1, np.int64)
                np.cumsum([len(s) for s in tb], out=toffs[1:])
                blob = b"".join(tb)
                max_title = max((len(s) for s in tb), default=0)
                splits_arr = np.array(
                    [-1 if s is None else s for s in batch.mate_split],
                    np.int64,
                )
                fast = None
                if batch.hit_runs is not None:
                    cap = hitruns_ops.DEFAULT_RUNS_PER_ROW
                    bundle = np.asarray(batch.hit_runs)[:n]
                    values, rcounts, nruns, totals, ovf = hitruns_ops.decode(
                        bundle, cap
                    )
                    if len(ovf) == 0:
                        fast = (values, rcounts, nruns, totals, splits_arr,
                                blob, toffs, max_title)
                fast_dense = None
                if fast is None and batch.hit_runs is None and native.available():
                    # dense window taxa (the default transfer): full lines
                    # format in C++ too — no per-read Python on any
                    # detailed path. Skipped when a hit-runs bundle exists
                    # but overflowed (the pairs path below then fetches
                    # only the overflow rows densely — fetching the whole
                    # dense array here would defeat the compact transfer)
                    fast_dense = (
                        np.ascontiguousarray(batch.codes[:n], np.uint8),
                        self._dense_window_taxa(batch, n),
                        splits_arr,
                        np.asarray(batch.row_lens, np.int64),
                        blob, toffs, max_title,
                    )
                pairs = (
                    None
                    if fast is not None or fast_dense is not None
                    else self._hit_pairs(batch)
                )
                if sre is not None:
                    samples = []
                    for title in batch.titles:
                        m = sre.search(title)
                        samples.append(m.group(1) if m else "other")
                    samples = np.array(samples)
                else:
                    samples = None
                k = self.index.params.k
                for t in cpar.thresholds:
                    # bulk formatting: no per-read objects or method calls —
                    # one vectorised threshold pass + a single comprehension
                    taxon, classified = self._finalize_taxa(batch, t, cpar)
                    rtax = np.where(classified, taxon, NONE)
                    keep = (
                        classified if not cpar.with_unclassified else np.ones(n, bool)
                    )
                    groups = (
                        [("all", np.flatnonzero(keep))]
                        if samples is None
                        else [
                            (str(s), np.flatnonzero(keep & (samples == s)))
                            for s in np.unique(samples[keep])
                        ]
                    )
                    emitted = None
                    if fast is not None:
                        from . import native

                        v_, c_, nr_, tt_, sp_, blob_, toffs_, maxt_ = fast
                        emitted = native.output_lines_runs(
                            v_, c_, nr_, tt_, sp_, blob_, toffs_, rtax,
                            classified.astype(np.uint8), k, maxt_,
                        )
                    elif fast_dense is not None:
                        from . import native

                        cd_, wt_, sp_, rl_, blob_, toffs_, maxt_ = fast_dense
                        emitted = native.output_lines_dense(
                            cd_, wt_, sp_, rl_, blob_, toffs_, rtax,
                            classified.astype(np.uint8), k, maxt_,
                        )
                    titles = batch.titles
                    for sample, idxs in groups:
                        if len(idxs) == 0:
                            continue
                        if emitted is not None:
                            from . import native

                            raw, starts, ends = emitted
                            writer_for(t, sample).write_bytes(
                                native.gather_rows(raw, starts, ends, idxs)
                            )
                        else:
                            if pairs is None:
                                pairs = self._hit_pairs(batch)
                            lines = [
                                f"{'C' if classified[i] else 'U'}\t{titles[i]}\t{rtax[i]}\t{pairs[i][1]}\t{pairs[i][0]}"
                                for i in idxs
                            ]
                            writer_for(t, sample).write("\n".join(lines) + "\n")
                        agg = counts[t].setdefault(sample, {})
                        vals, cts = np.unique(rtax[idxs], return_counts=True)
                        for v, c in zip(vals.tolist(), cts.tolist()):
                            agg[v] = agg.get(v, 0) + c
        finally:
            for f in writers.values():
                f.close()

        return self._write_reports(counts, output_location, cpar)

    def _aggregate_and_write(self, packed_iter, output_location, cpar):
        self._fetch_window_taxa = False
        self._finalize_thresholds = tuple(cpar.thresholds)
        counts: Dict[float, Dict[str, Dict[int, int]]] = {
            t: {} for t in cpar.thresholds
        }
        sre = re.compile(cpar.sample_regex) if cpar.sample_regex else None
        for batch in self.packed_batches(packed_iter):
            n = len(batch.titles)
            if sre is not None:
                samples = np.array(
                    [
                        (m.group(1) if (m := sre.search(t)) else "other")
                        for t in batch.titles
                    ]
                )
            else:
                samples = None
            for t in cpar.thresholds:
                taxon, classified = self._finalize_taxa(batch, t, cpar)
                report_taxon = np.where(classified, taxon, NONE)
                if not cpar.with_unclassified:
                    keep = classified
                else:
                    keep = np.ones(n, bool)
                per_sample = counts[t]
                if samples is None:
                    agg = per_sample.setdefault("all", {})
                    vals, cts = np.unique(report_taxon[keep], return_counts=True)
                    for v, c in zip(vals.tolist(), cts.tolist()):
                        agg[v] = agg.get(v, 0) + c
                else:
                    for s in np.unique(samples[keep]):
                        sel = keep & (samples == s)
                        agg = per_sample.setdefault(str(s), {})
                        vals, cts = np.unique(report_taxon[sel], return_counts=True)
                        for v, c in zip(vals.tolist(), cts.tolist()):
                            agg[v] = agg.get(v, 0) + c
        return self._write_reports(counts, output_location, cpar)

    def _write_reports(self, counts, output_location: str, cpar: ClassifyParams):
        """Write one kreport per (threshold, sample) from the aggregated
        {threshold: {sample: {taxon: count}}} map. Overridable hook: the
        multi-host classifier merges counts across processes here before
        process 0 writes (the reference's driver-collect analogue,
        Classifier.scala:214-217)."""
        out = {}
        for t, per_sample in counts.items():
            loc = output_location + "_c" + format_threshold(t, cpar.thresholds)
            os.makedirs(loc, exist_ok=True)
            names = []
            for sample, agg in per_sample.items():
                KrakenReport(self.index.taxonomy, sorted(agg.items())).write(
                    os.path.join(loc, f"{sample}_kreport.txt")
                )
                names.append(sample)
            out[t] = names
        return out

    def _finalize_taxa(self, batch: _BatchResult, threshold: float, cpar: ClassifyParams):
        """Vectorised (taxon, classified) for one threshold (no objects)."""
        if batch.final_taxa is not None and threshold in batch.final_taxa:
            # resolved on device (_finalize_kernel); only the rare hit-table
            # overflow rows and the min-hit-groups gate stay host-side
            taxon = batch.final_taxa[threshold]
            overflow_rows = np.flatnonzero(batch.overflow)
            if len(overflow_rows):
                taxon = taxon.copy()
                required = np.ceil(threshold * batch.total_kmers.astype(np.float64))
                parents = self.index.taxonomy.parents
                wt_host = np.asarray(batch.window_taxa)
                for i in overflow_rows:
                    taxon[i] = _resolve_host(
                        parents, _window_taxa_counts(wt_host[i]), required[i]
                    )
            classified = (taxon != NONE) & (
                batch.num_distinct >= cpar.min_hit_groups
            )
            return taxon, classified
        if batch.res_path is None:
            raise ValueError(
                f"threshold {threshold} was not finalised on device "
                f"(batch has {sorted(batch.final_taxa or ())}); classify with "
                "it in ClassifyParams.thresholds or set STPU_DEVICE_FINALIZE=0"
            )
        required = np.ceil(threshold * batch.total_kmers.astype(np.float64))
        path = batch.res_path
        clade = batch.res_clade
        ok = (path != -1) & (clade.astype(np.float64) >= required[:, None])
        dsel = ok.shape[1] - 1 - np.argmax(ok[:, ::-1], axis=1)
        any_ok = ok.any(axis=1)
        taxon = np.where(
            any_ok, np.take_along_axis(path, dsel[:, None], axis=1)[:, 0], NONE
        )
        taxon = np.where(batch.res_max_taxon == NONE, NONE, taxon).astype(np.int64)
        overflow_rows = np.flatnonzero(batch.overflow)
        if len(overflow_rows):
            parents = self.index.taxonomy.parents
            wt_host = np.asarray(batch.window_taxa)
            for i in overflow_rows:
                taxon[i] = _resolve_host(parents, _window_taxa_counts(wt_host[i]), required[i])
        classified = (taxon != NONE) & (batch.num_distinct >= cpar.min_hit_groups)
        return taxon, classified

    def classify_and_write(
        self, fragments: Iterable[Fragment], output_location: str, cpar: ClassifyParams
    ) -> Dict[float, List[str]]:
        """Classify and write per-sample outputs + kreports per threshold
        (Classifier.scala:184-251). Returns {threshold: [sample ids]}."""
        results = self.classify(fragments, cpar)
        return self._write_results(results, output_location, cpar)

    def _write_results(self, results, output_location: str, cpar: ClassifyParams):
        out = {}
        for t, reads in results.items():
            loc = output_location + "_c" + format_threshold(t, cpar.thresholds)
            out[t] = write_per_sample_output(reads, loc, cpar, self.index.taxonomy)
        return out


def _ambig_kmers(codes_row: np.ndarray, split: Optional[int], row_len: int, k: int) -> int:
    """Pseudo-kmers from ambiguous char-runs >= k, per mate."""
    total = 0
    if split is None:
        slices = [(0, row_len)]
    else:
        slices = [(0, split), (split + 1, row_len)]
    for a, b in slices:
        for i, j, is_valid in _char_runs(codes_row[a:b] < 4):
            if not is_valid and (j - i) >= k:
                total += (j - i) - k + 1
    return total


def _row_hit_parts(codes_row, window_taxa_row, split, row_len, k):
    if split is None:
        return [mate_hits(codes_row, window_taxa_row, 0, row_len, k)]
    return [
        mate_hits(codes_row, window_taxa_row, 0, split, k),
        mate_hits(codes_row, window_taxa_row, split + 1, row_len, k),
    ]


def _window_taxa_counts(window_taxa_row: np.ndarray) -> Dict[int, int]:
    vals, counts = np.unique(window_taxa_row[window_taxa_row >= 0], return_counts=True)
    return {int(v): int(c) for v, c in zip(vals, counts)}


def format_threshold(t: float, thresholds: Sequence[float]) -> str:
    """Format with max decimal places across the threshold list so file names
    sort (Classifier.scala:186-190)."""
    decimals = max(len(repr(float(x)).split(".")[1]) for x in thresholds)
    return f"%.{decimals}f" % t


def write_per_sample_output(
    reads: List[ClassifiedRead],
    location: str,
    cpar: ClassifyParams,
    taxonomy: Taxonomy,
) -> List[str]:
    """Write gzip per-read outputs partitioned by sample + a kreport per
    sample (Classifier.scala:184-251 layout: <loc>/sample=<id>/ and
    <loc>/<id>_kreport.txt)."""
    os.makedirs(location, exist_ok=True)
    kept = [r for r in reads if cpar.with_unclassified or r.classified]
    by_sample: Dict[str, List[ClassifiedRead]] = {}
    for r in kept:
        by_sample.setdefault(r.sample_id, []).append(r)

    samples = []
    for sample, rs in by_sample.items():
        if cpar.per_read_output:
            d = os.path.join(location, f"sample={sample}")
            os.makedirs(d, exist_ok=True)
            # level 1 + pooled compression: write-throughput-bound
            with ParallelGzipWriter(os.path.join(d, "part-00000.txt.gz"), level=1) as f:
                chunk = 1 << 14
                for i in range(0, len(rs), chunk):
                    f.write("\n".join(r.output_line() for r in rs[i : i + chunk]) + "\n")
        counts: Dict[int, int] = {}
        for r in rs:
            counts[r.taxon] = counts.get(r.taxon, 0) + 1
        report = KrakenReport(taxonomy, sorted(counts.items()))
        report.write(os.path.join(location, f"{sample}_kreport.txt"))
        samples.append(sample)
    return samples
