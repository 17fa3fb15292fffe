"""Batched Kraken 2 `resolveTree` on device.

Re-designs LowestCommonAncestor.resolveTree (LowestCommonAncestor.scala:
91-146, after Kraken 2 classify.cc) as dense tensor ops:

  * per-read hit taxa are compacted to a fixed-width list [B, T];
  * ancestor tests become equality scans over root-aligned path tables;
  * the score of a candidate taxon  = sum of counts of its ancestors-or-self;
  * tie-break = LCA of all argmax taxa (order-independent — the reference's
    sequential fold over a hash map iterator reduces to exactly this);
  * the confidence "lift" phase is returned as a full vector of clade scores
    along the winning taxon's root path, so the host can apply ANY number of
    confidence thresholds exactly (float64 ceil semantics, matching Scala's
    Math.ceil) without re-running the device pass. This generalises the
    reference's multi-threshold caching (Classifier.scala:156-170).

Everything is O(T * D) per read with T = max distinct hit taxa (reads with
more overflow to a host fallback) and D = the taxonomy's true max path length.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from .. import utils
from .lca import NONE, lca_of_rpath_set

INT_MAX = 2**31 - 1

#: sentinel for "not a valid k-mer window" in per-window taxon arrays
INVALID_WINDOW = -3


class CompactHits(NamedTuple):
    taxa: jnp.ndarray  # [B, T] int32, 0-padded
    counts: jnp.ndarray  # [B, T] int32
    n_hit_kmers: jnp.ndarray  # [B] total k-mers hitting real taxa (taxon > 0)
    n_none_kmers: jnp.ndarray  # [B] valid windows whose minimizer missed (taxon == 0)
    overflow: jnp.ndarray  # [B] bool: more than T distinct taxa (host fallback)


@partial(jax.jit, static_argnums=(1,))
def compact_hits_sort(window_taxa: jnp.ndarray, max_taxa: int) -> CompactHits:
    """Sort-based reference implementation of compact_hits (kept for tests;
    compact_hits_rounds below is the production kernel — bit-identical, but
    ~max_taxa fused elementwise passes instead of a bitonic sort network).

    window_taxa: int32, INVALID_WINDOW for non-window positions, 0 (NONE) for
    index misses, >0 for hits. Equivalent to TaxonCounts.toMap
    (TaxonCounts.scala:70-81: special taxa and, for scoring, NONE excluded).
    """
    wt = jnp.asarray(window_taxa, jnp.int32)
    hit = wt > 0
    s = jnp.sort(jnp.where(hit, wt, INT_MAX), axis=-1)
    prev = jnp.concatenate([jnp.full(s.shape[:-1] + (1,), -1, s.dtype), s[..., :-1]], axis=-1)
    is_run_start = (s != prev) & (s != INT_MAX)
    run_id = jnp.cumsum(is_run_start, axis=-1) - 1
    is_hit_sorted = s != INT_MAX

    def per_row(s_row, run_row, start_row, hit_row):
        set_idx = jnp.where(start_row, run_row, max_taxa)
        taxa = jnp.zeros(max_taxa, jnp.int32).at[set_idx].set(s_row, mode="drop")
        add_idx = jnp.where(hit_row, run_row, max_taxa)
        counts = jnp.zeros(max_taxa, jnp.int32).at[add_idx].add(1, mode="drop")
        return taxa, counts

    taxa, counts = jax.vmap(per_row)(s, run_id, is_run_start, is_hit_sorted)
    n_runs = jnp.sum(is_run_start, axis=-1)
    return CompactHits(
        taxa=taxa,
        counts=counts,
        n_hit_kmers=jnp.sum(hit, axis=-1).astype(jnp.int32),
        n_none_kmers=jnp.sum(wt == NONE, axis=-1).astype(jnp.int32),
        overflow=n_runs > max_taxa,
    )


@partial(jax.jit, static_argnums=(1,))
def compact_hits_rounds(window_taxa: jnp.ndarray, max_taxa: int) -> CompactHits:
    """compact_hits without the [B, L] row sort: extract the distinct hit
    taxa in ascending order with `max_taxa` successive-minimum rounds.

    Each round is a handful of fused elementwise passes (compare/select/
    min/sum) over the [B, L] window taxa — no comparator network, no
    materialised permutation — so it is bandwidth-bound at ~max_taxa
    full-array passes where a sorting network costs O(log^2 L) passes plus
    scatter traffic. Outputs are bit-identical to compact_hits (taxa emerge
    ascending, exactly like the sorted-run compaction).
    """
    wt = jnp.asarray(window_taxa, jnp.int32)
    hit = wt > 0
    vals = jnp.where(hit, wt, INT_MAX)
    b = wt.shape[0]
    prev = jnp.zeros((b, 1), jnp.int32)
    taxa_cols = []
    count_cols = []
    for _ in range(max_taxa):
        masked = jnp.where(vals > prev, vals, INT_MAX)
        cur = jnp.min(masked, axis=-1, keepdims=True)  # [B, 1]
        found = cur != INT_MAX
        cnt = jnp.sum(jnp.where(vals == cur, 1, 0), axis=-1, keepdims=True)
        taxa_cols.append(jnp.where(found, cur, 0))
        count_cols.append(jnp.where(found, cnt, 0))
        prev = jnp.where(found, cur, prev)
    remaining = jnp.min(jnp.where(vals > prev, vals, INT_MAX), axis=-1)
    return CompactHits(
        taxa=jnp.concatenate(taxa_cols, axis=-1),
        counts=jnp.concatenate(count_cols, axis=-1),
        n_hit_kmers=jnp.sum(hit, axis=-1).astype(jnp.int32),
        n_none_kmers=jnp.sum(wt == NONE, axis=-1).astype(jnp.int32),
        overflow=remaining != INT_MAX,
    )


def compact_hits(window_taxa: jnp.ndarray, max_taxa: int) -> CompactHits:
    """Platform-dispatched compaction (both variants are bit-identical).

    The sort wins on the CPU backend (15.0 vs 21.1 ms at [8192, 128],
    T=32: its merge sort beats 32 full-array passes in cache); the GPU takes
    the successive-minimum rounds, plain fused elementwise passes. The
    backend is fixed by trace time, so this resolves statically under jit.
    """
    if utils.backend() == "cpu":
        return compact_hits_sort(window_taxa, max_taxa)
    return compact_hits_rounds(window_taxa, max_taxa)


class ResolveResult(NamedTuple):
    """Per-read resolution data; final thresholding happens on host."""

    max_taxon: jnp.ndarray  # [B] int32 — the pre-confidence winning taxon
    path: jnp.ndarray  # [B, D] root-aligned path of max_taxon (-1 padded)
    clade: jnp.ndarray  # [B, D] int32 clade scores along that path


@jax.jit
def resolve_hits(
    taxa: jnp.ndarray, counts: jnp.ndarray, rpath_table: jnp.ndarray
) -> ResolveResult:
    """Batched resolveTree core. taxa/counts: [B, T], 0-padded.

    rpath_table: precomputed root-aligned ancestor table [n_taxa, D]
    (Taxonomy.rpath_table) replicated in HBM — every tree walk becomes one
    contiguous row gather. score(candidate j) = sum of counts over j's root
    path restricted to the hit set. The ancestor test is pure equality on
    root-aligned paths: hit taxon i is an ancestor-or-self of candidate j
    iff taxa[i] appears anywhere in rp[j, :] (paths hold distinct positive
    nodes; pads are -1 and pad taxa are 0, so they never spuriously match).
    D passes of [B, T, T] compares + one masked sum over the hit axis —
    gather-free, where a per-element binary search would cost
    T*D*log2(T) data-dependent gathers per read.
    """
    taxa = jnp.asarray(taxa, jnp.int32)
    counts = jnp.asarray(counts, jnp.int32)
    b, t = taxa.shape
    max_path = rpath_table.shape[-1]
    present = taxa != NONE

    rp = rpath_table[taxa]  # [B, T, D]: ancestors-or-self by real depth

    eq = rp[:, None, :, 0] == taxa[:, :, None]  # [B, T(i=hit), T(j=candidate)]
    for dd in range(1, max_path):
        eq = eq | (rp[:, None, :, dd] == taxa[:, :, None])
    # a masked sum, not an int32 einsum: XLA fuses it (there is no integer
    # GEMM to hand off to), and it measured no slower on the GPU
    scores = jnp.sum(jnp.where(eq, counts[:, :, None], 0), axis=1)
    scores = jnp.where(present, scores, 0)

    max_score = jnp.max(scores, axis=-1)
    tied = present & (scores == max_score[:, None]) & (max_score[:, None] > 0)

    max_taxon = lca_of_rpath_set(rp, tied)  # [B]

    # clade scores along max_taxon's root-aligned path: node at depth d is an
    # ancestor of taxa[i] iff rp[i, d] equals it (root-aligned paths share
    # depth indexing).
    pm = rpath_table[max_taxon]  # [B, D]
    in_clade = (rp == pm[:, None, :]) & (pm[:, None, :] != -1)  # [B, T, D]
    clade = jnp.sum(jnp.where(in_clade, counts[:, :, None], 0), axis=1)
    clade = jnp.where(pm != -1, clade, 0)

    return ResolveResult(max_taxon=max_taxon, path=pm, clade=clade)


def pick_threshold_host(result, required_score):
    """Host-side final step: deepest node on the winning path whose clade
    score meets the required score; NONE if unreachable (the lift loop,
    LowestCommonAncestor.scala:124-146).

    result: ResolveResult with numpy arrays; required_score: [B] float64.
    Returns [B] int32 taxa.
    """
    import numpy as np

    path = np.asarray(result.path)
    clade = np.asarray(result.clade)
    ok = (path != -1) & (clade.astype(np.float64) >= np.asarray(required_score)[:, None])
    d = ok.shape[1] - 1 - np.argmax(ok[:, ::-1], axis=1)  # deepest ok level
    any_ok = ok.any(axis=1)
    taxon = np.where(any_ok, np.take_along_axis(path, d[:, None], axis=1)[:, 0], NONE)
    taxon = np.where(np.asarray(result.max_taxon) == NONE, NONE, taxon)
    return taxon.astype(np.int32)
