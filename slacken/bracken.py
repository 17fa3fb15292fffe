"""Bracken weight generation (reference: BrackenWeights.scala).

Simulates EVERY read of length R from every genome in the library,
self-classifies it against the index, and counts (source taxon, destination
taxon) pairs, writing a Bracken-compatible kmer_distrib file.

Device design: the reference's FragmentWindow (an O(1)-per-position
sliding window over hit spans, BrackenWeights.scala:46-137) is replaced by
prefix sums. For a fragment of length L:

  * the device scan + index probe yields a per-position taxon array t[p]
    (LCA of the k-mer starting at p, NONE where invalid) — exactly the
    per-position hits that taxonHits reconstructs (BrackenWeights.scala:
    198-237, including NONE filler for ambiguous regions and segment tails);
  * the distinct taxa of the fragment form a small set S (the source's
    lineage plus stray LCAs), so per-taxon counts over every read window are
    differences of S prefix-sum rows;
  * resolveTree at confidence 0 (the only mode bracken-build uses,
    BrackenWeights.scala:276-284) is argmax of ancestor-weighted scores with
    LCA tie-break, vectorised over all window positions at once;
  * hit groups per window are two prefix-sum lookups (spans started before
    window end minus spans ended before window start).
"""

from __future__ import annotations

import os
from functools import partial
from typing import Dict, List, Set, Tuple

import jax
import numpy as np

from .classify import default_probe
from .index import KeyValueIndex
from .ops import encode, u64
from .ops import lookup as lookup_ops
from .ops.minimizers import window_minimizers
from .taxonomy import NONE

FRAGMENT_MAX = 1024 * 1024  # BrackenWeights.scala:303


@partial(jax.jit, static_argnums=(5, 6, 7, 8))
def _fragment_kernel(
    codes, keys_hi, keys_lo, key_taxa, router, mp, rounds, bits, key_bits=62, lut=None
):
    """Per-position window taxa + span structure for genome fragments."""
    wm = window_minimizers(codes, mp, lut)
    looked = lookup_ops.lookup_taxa_routed(
        u64.U64(keys_hi, keys_lo), key_taxa, router, wm.minimizer, rounds, bits,
        key_bits,
    )
    return looked, wm.valid, wm.span_start, wm.distinct


@partial(jax.jit, static_argnums=(3, 4, 5, 6))
def _fragment_kernel_tiled(
    codes, table, router, mp, tile, bits, key_bits=62, lut=None
):
    """_fragment_kernel with the tiled row-gather probe (GPU path;
    bit-identical)."""
    wm = window_minimizers(codes, mp, lut)
    looked = lookup_ops.lookup_taxa_tiled(
        table, router, wm.minimizer, tile, bits, key_bits
    )
    return looked, wm.valid, wm.span_start, wm.distinct


class BrackenWeights:
    def __init__(self, index: KeyValueIndex, read_len: int, use_device: bool = False):
        self.index = index
        self.read_len = read_len
        #: classify read windows on device (prefix sums + matmul scoring).
        #: The adaptive numpy path is the default (5x faster on 4 CPU
        #: cores: the fixed per-fragment taxa budget wastes the device's
        #: width on mostly-sparse hit vectors); the kernel stays opt-in for
        #: hosts whose cycles are the scarce resource. Rows overflowing the budget fall back to the
        #: exact numpy path either way.
        self.use_device = use_device
        self.device_max_taxa = 64
        if read_len < index.params.k:
            raise ValueError(f"read length {read_len} must be >= k {index.params.k}")

    # -- core: classify every window of one fragment -------------------------

    def _fragment_dest_counts(
        self, taxa_pos: np.ndarray, valid: np.ndarray, span_start: np.ndarray,
        distinct: np.ndarray, frag_len: int
    ) -> Dict[int, int]:
        """Counts of destination taxa over all read windows of a fragment.

        taxa_pos/valid/span_start/distinct: per-position arrays (length >=
        frag_len) from the device scan. Windows start at 0..frag_len-R.
        """
        R = self.read_len
        k = self.index.params.k
        W = R - k + 1  # k-mers per read window
        n_windows = frag_len - R + 1
        if n_windows <= 0:
            return {}

        # per-position hit taxon: NONE where the k-mer is invalid
        t = np.where(valid[:frag_len], taxa_pos[:frag_len], NONE).astype(np.int64)

        # distinct hit-group starts/ends for the hit-group gate
        qual = span_start[:frag_len] & distinct[:frag_len] & (t > 0)
        # span lengths: from each span start to the next boundary; we only
        # need, for window [s, s+W): #(qualifying spans with start < s+W)
        #                          - #(qualifying spans fully before s)
        start_cum = np.concatenate([[0], np.cumsum(qual)])  # S1[x] = starts < x
        # a span is fully passed before s iff its last kmer position < s;
        # last kmer position of the span starting at p = next boundary - 1.
        # Build "span end" marks at the position after each span's last kmer.
        ends = np.zeros(frag_len + 1, np.int64)
        starts_idx = np.flatnonzero(qual)
        if len(starts_idx):
            # span of qualifying start p extends while valid & same value run:
            # derive ends from the span_start structure: the span ends where
            # the next span starts or validity ends.
            boundary = np.flatnonzero(span_start[:frag_len] | ~valid[:frag_len])
            nxt = np.searchsorted(boundary, starts_idx, side="right")
            end_pos = np.where(
                nxt < len(boundary), boundary[np.minimum(nxt, len(boundary) - 1)], frag_len
            )
            np.add.at(ends, end_pos, 1)
        passed_cum = np.cumsum(ends)  # S2[x] = spans fully before x (end <= x)

        s = np.arange(n_windows)
        # spans overlapping window [s, s+W): started before s+W, not fully
        # passed before s (FragmentWindow.inWindow/passedWindow,
        # BrackenWeights.scala:63-73)
        hit_groups = start_cum[s + W] - passed_cum[s]

        # distinct taxa in fragment
        taxa_list = np.unique(t[t > 0])
        if len(taxa_list) == 0:
            return {NONE: n_windows}

        tax = self.index.taxonomy
        # prefix sums per taxon: cnt[i, s] = count of taxa_list[i] in window s
        onehot = t[None, :] == taxa_list[:, None]  # [S, L]
        pref = np.concatenate(
            [np.zeros((len(taxa_list), 1), np.int64), np.cumsum(onehot, axis=1)], axis=1
        )
        cnt = pref[:, s + W] - pref[:, s]  # [S, n_windows]

        # ancestor matrix over the small taxon set
        S = len(taxa_list)
        anc = np.zeros((S, S), bool)
        paths = []
        for j, tj in enumerate(taxa_list):
            pj = list(tax.path_to_root(int(tj)))
            paths.append(pj)
            pset = set(pj)
            for i, ti in enumerate(taxa_list):
                anc[i, j] = int(ti) in pset

        scores = anc.T.astype(np.int64) @ cnt  # [S(j), n_windows]
        max_scores = scores.max(axis=0)
        # resolveTree at required=0: maxTaxon with LCA tie-break
        tied = (scores == max_scores[None, :]) & (cnt.sum(axis=0)[None, :] > 0)
        # LCA over tied: root-aligned paths
        D = tax.max_path_len
        rp = np.full((S, D), -1, np.int64)
        for i, pj in enumerate(paths):
            d = len(pj) - 1
            for step, node in enumerate(pj):
                rp[i, d - step] = node
        big = np.int64(2**62)
        mn = np.where(tied[:, :, None], rp[:, None, :], big).min(axis=0)  # [W, D]
        mx = np.where(tied[:, :, None], rp[:, None, :], np.int64(-2)).max(axis=0)
        agree = (mn == mx) & (mn != -1) & (mn != big)
        best = np.where(agree.any(axis=1), agree.shape[1] - 1 - np.argmax(agree[:, ::-1], axis=1), 0)
        dest = np.where(
            agree.any(axis=1), np.take_along_axis(mn, best[:, None], axis=1)[:, 0], NONE
        )
        # hit-group gate (minHitGroups=2, TaxonFragment.classify,
        # BrackenWeights.scala:276-284)
        dest = np.where(hit_groups >= 2, dest, NONE)

        vals, counts = np.unique(dest, return_counts=True)
        return {int(v): int(c) for v, c in zip(vals, counts)}

    # -- pipeline ------------------------------------------------------------

    def _iter_fragments(self, library, taxa: Set[int]):
        """(taxon, fragment codes) with FRAGMENT_MAX splitting and R-1 overlap
        (TaxonFragment.splitToMaxLength, BrackenWeights.scala:152-164)."""
        R = self.read_len
        for taxon, header, seq in library.sequences():
            taxon = int(self.index.taxonomy.primary[taxon]) if taxon < len(
                self.index.taxonomy.primary
            ) else taxon
            if taxon not in taxa:
                continue
            codes = encode.encode_seq(seq)
            if len(codes) <= FRAGMENT_MAX:
                yield taxon, codes
            else:
                step = FRAGMENT_MAX - (R - 1)
                for off in range(0, len(codes) - R + 1, step):
                    yield taxon, codes[off : off + FRAGMENT_MAX]

    def build_weights(self, library, taxa: Set[int]) -> Dict[Tuple[int, int], int]:
        """(dest, source) -> read count over all simulated reads
        (BrackenWeights.buildWeights, BrackenWeights.scala:312-354)."""
        idx = self.index
        mp = idx.params.minimizer_params
        dk = idx.device_keys
        out: Dict[Tuple[int, int], int] = {}

        # batch fragments by padded length for stable jit shapes
        pend: Dict[int, List[Tuple[int, np.ndarray]]] = {}

        table = jnp.asarray(idx.taxonomy.rpath_table())
        R = self.read_len
        k = idx.params.k

        # only routed and tiled fragment kernels exist: tiled wherever the
        # platform default is a table probe
        tiled = default_probe(idx) != "routed" and not idx.wide

        def flush(bucket, items):
            codes, _ = encode.pack_batch([c for _, c in items], bucket)
            if tiled:
                ttab, tile = idx.device_tiled
                looked, valid, span_start, distinct = _fragment_kernel_tiled(
                    codes, ttab, idx.device_router, mp, tile,
                    idx.router_bits, idx.key_bits, idx.device_lut,
                )
            else:
                looked, valid, span_start, distinct = _fragment_kernel(
                    codes, dk.hi, dk.lo, idx.device_taxa, idx.device_router, mp,
                    idx.router_rounds, idx.router_bits, idx.key_bits, idx.device_lut,
                )
            if self.use_device and bucket >= R:
                dest, overflow = _window_classify_kernel(
                    looked, valid, span_start, distinct, table, R, k, self.device_max_taxa
                )
                dest = np.asarray(dest)
                overflow = np.asarray(overflow)
            else:
                dest = None
                overflow = np.ones(len(items), bool)
            looked_h = valid_h = start_h = dist_h = None
            for row, (source, c) in enumerate(items):
                n_windows = len(c) - R + 1
                if dest is not None and not overflow[row] and n_windows > 0:
                    vals, cts = np.unique(dest[row, :n_windows], return_counts=True)
                    dc = dict(zip(vals.tolist(), cts.tolist()))
                else:
                    if looked_h is None:
                        looked_h = np.asarray(looked)
                        valid_h = np.asarray(valid)
                        start_h = np.asarray(span_start)
                        dist_h = np.asarray(distinct)
                    dc = self._fragment_dest_counts(
                        looked_h[row], valid_h[row], start_h[row], dist_h[row], len(c)
                    )
                for dest_t, n in dc.items():
                    key = (int(dest_t), source)
                    out[key] = out.get(key, 0) + n

        for taxon, codes in self._iter_fragments(library, taxa):
            bucket = 1 << max(10, (len(codes) - 1).bit_length())
            pend.setdefault(bucket, []).append((taxon, codes))
            if len(pend[bucket]) * bucket >= (1 << 22):
                flush(bucket, pend[bucket])
                pend[bucket] = []
        for bucket, items in pend.items():
            if items:
                flush(bucket, items)
        return out

    def build_weights_gradually(
        self, library, taxa: Set[int], temp_location: str, chunks: int = 5
    ) -> Dict[Tuple[int, int], int]:
        """Chunk the taxon set and persist each chunk's counts durably so an
        interrupted job only loses the latest batch
        (BrackenWeights.scala:356-374)."""
        os.makedirs(temp_location, exist_ok=True)
        taxa_sorted = sorted(taxa)
        size = max(1, len(taxa_sorted) // chunks)
        total: Dict[Tuple[int, int], int] = {}
        for ci in range(0, len(taxa_sorted), size):
            chunk_file = os.path.join(temp_location, f"chunk{ci}.npz")
            if os.path.exists(chunk_file):
                data = np.load(chunk_file)
                part = {
                    (int(d), int(s)): int(c)
                    for d, s, c in zip(data["dest"], data["source"], data["count"])
                }
            else:
                part = self.build_weights(library, set(taxa_sorted[ci : ci + size]))
                np.savez(
                    chunk_file,
                    dest=np.array([k[0] for k in part], np.int64),
                    source=np.array([k[1] for k in part], np.int64),
                    count=np.array(list(part.values()), np.int64),
                )
            for key, c in part.items():
                total[key] = total.get(key, 0) + c
        return total

    def build_and_write_weights(
        self, library, taxa: Set[int], output_location: str, gradual: bool = False
    ):
        os.makedirs(os.path.dirname(output_location) or ".", exist_ok=True)
        if gradual:
            counts = self.build_weights_gradually(library, taxa, output_location + "_tmp")
        else:
            counts = self.build_weights(library, taxa)
        write_kmer_distrib(counts, output_location)
        if gradual:
            import shutil

            shutil.rmtree(output_location + "_tmp", ignore_errors=True)
        return counts


def write_kmer_distrib(counts: Dict[Tuple[int, int], int], output_location: str):
    """Bracken kmer_distrib format (BrackenWeights.scala:418-430):
    mapped_taxid<TAB>genome_taxids:kmers_mapped:total_genome_kmers ..."""
    totals: Dict[int, int] = {}
    for (dest, source), c in counts.items():
        totals[source] = totals.get(source, 0) + c
    by_dest: Dict[int, List[Tuple[int, int]]] = {}
    for (dest, source), c in counts.items():
        by_dest.setdefault(dest, []).append((source, c))
    with open(output_location, "w") as f:
        f.write("mapped_taxid\tgenome_taxids:kmers_mapped:total_genome_kmers\n")
        for dest in sorted(by_dest):
            parts = " ".join(
                f"{s}:{c}:{totals[s]}" for s, c in sorted(by_dest[dest])
            )
            f.write(f"{dest}\t{parts}\n")


# ---------------------------------------------------------------------------
# Device window classification (per-read simulation on device)
# ---------------------------------------------------------------------------

import jax.numpy as jnp
from functools import partial as _partial

from .ops.resolve import INVALID_WINDOW, compact_hits


@_partial(jax.jit, static_argnums=(5, 6, 7))
def _window_classify_kernel(
    window_taxa, valid, span_start, distinct, rpath_table, read_len: int, k: int, max_taxa: int
):
    """Classify every read window of genome-fragment rows on device.

    Implements FragmentWindow semantics (BrackenWeights.scala:46-137) as
    prefix sums: per-taxon k-mer counts over each window are cumsum
    differences, candidate scores are one [S, S] x [S, W] matmul per row
    (matmul), the winner's tie set is reduced by LCA, and the min-hit-groups
    gate uses span prefix sums. Returns (dest [B, L] int32 valid at window
    starts 0..L-read_len, window_valid mask, overflow flag per row).
    """
    b, l = window_taxa.shape
    w_kmers = read_len - k + 1

    t = jnp.where(valid, window_taxa, 0).astype(jnp.int32)  # NONE where invalid
    ch = compact_hits(jnp.where(valid, window_taxa, INVALID_WINDOW), max_taxa)
    taxa_list = ch.taxa  # [B, S] sorted ascending, 0-padded
    present = taxa_list != 0

    # per-taxon prefix sums over k-mer positions
    onehot = (t[:, None, :] == taxa_list[:, :, None]) & present[:, :, None]
    pref = jnp.cumsum(onehot.astype(jnp.int32), axis=-1)
    zero = jnp.zeros((b, taxa_list.shape[1], 1), jnp.int32)
    pref = jnp.concatenate([zero, pref], axis=-1)  # [B, S, L+1]
    # window starting at position w covers k-mer positions [w, w+w_kmers)
    n_windows = l - read_len + 1
    starts = jnp.arange(n_windows)
    cnt = pref[:, :, starts + w_kmers] - pref[:, :, starts]  # [B, S, W]

    # candidate scores: anc[i, j] = taxa[i] is ancestor-or-self of taxa[j]
    rp = rpath_table[taxa_list]  # [B, S, D]
    anc = (
        jnp.any(rp[:, None, :, :] == taxa_list[:, :, None, None], axis=-1)
        & present[:, :, None]
    )
    # full-float32 precision: a TF32 product would round counts above 2048
    scores = jnp.einsum(
        "bij,biw->bjw", anc.astype(jnp.float32), cnt.astype(jnp.float32),
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    ).astype(jnp.int32)  # [B, S, W]
    scores = jnp.where(present[:, :, None], scores, 0)

    max_scores = jnp.max(scores, axis=1)  # [B, W]
    any_hit = jnp.sum(cnt, axis=1) > 0
    tied = (scores == max_scores[:, None, :]) & present[:, :, None] & any_hit[:, None, :]
    n_tied = jnp.sum(tied, axis=1)

    # single-winner fast path: argmax; multi-winner windows -> LCA of the set
    j_star = jnp.argmax(tied, axis=1)  # [B, W] first tied index
    dest_single = jnp.take_along_axis(taxa_list, j_star, axis=1)

    # LCA over the tied set per window, via per-level min/max (D small):
    rp_w = rp[:, :, None, :]  # [B, S, 1, D]
    big = jnp.int32(2**31 - 1)
    mn = jnp.min(jnp.where(tied[:, :, :, None], rp_w, big), axis=1)  # [B, W, D]
    mx = jnp.max(jnp.where(tied[:, :, :, None], rp_w, jnp.int32(-2)), axis=1)
    agree = (mn == mx) & (mn != -1) & (mn != big)
    d = jnp.arange(rp.shape[-1], dtype=jnp.int32)
    best = jnp.max(jnp.where(agree, d, -1), axis=-1)
    dest_lca = jnp.take_along_axis(mn, jnp.maximum(best, 0)[..., None], axis=-1)[..., 0]
    dest_lca = jnp.where(best >= 0, dest_lca, 0)
    dest = jnp.where(n_tied > 1, dest_lca, jnp.where(n_tied == 1, dest_single, 0))

    # hit-group gate: qualifying spans overlapping the window
    qual = (span_start & distinct & (window_taxa > 0) & valid).astype(jnp.int32)
    start_cum = jnp.concatenate(
        [jnp.zeros((b, 1), jnp.int32), jnp.cumsum(qual, axis=-1)], axis=-1
    )
    # span end marks: a span's last k-mer is the position before the next
    # boundary (next span start or validity end)
    boundary = span_start | ~valid
    # for each qualifying span start p, find next boundary > p via reverse
    # carry of boundary positions
    idx = jnp.arange(l, dtype=jnp.int32)
    next_b = jax.lax.associative_scan(
        lambda a, b_: jnp.minimum(a, b_),
        jnp.where(boundary, idx, l),
        reverse=True,
        axis=1,
    )
    # next boundary STRICTLY after p: shift left by one
    nb_after = jnp.concatenate([next_b[:, 1:], jnp.full((b, 1), l, jnp.int32)], axis=-1)
    ends = jnp.zeros((b, l + 1), jnp.int32)
    end_pos = jnp.where(qual > 0, nb_after, l)
    ends = ends.at[jnp.arange(b)[:, None], end_pos].add(qual)
    passed_cum = jnp.cumsum(ends, axis=-1)
    hit_groups = (
        jnp.take_along_axis(start_cum, starts[None, :] + w_kmers, axis=-1)
        - jnp.take_along_axis(passed_cum, starts[None, :], axis=-1)
    )
    dest = jnp.where(hit_groups >= 2, dest, 0)
    return dest, ch.overflow
