"""Lowest-common-ancestor computations on device.

The taxonomy's `parents` array (int32, replicated in HBM) is the only tree
state needed. All walks are fixed-bound loops of `max_path` gather steps
(the reference bounds paths at 256 — LowestCommonAncestor.scala:34; real NCBI
paths are < 50, and the Taxonomy reports its true maximum).

Key building block: *root-aligned paths* — for taxon t, rpath[d] = the
ancestor of t at real tree depth d (root = depth 0), or -1 where t is
shallower than d. The LCA of any set of taxa is then the deepest level at
which all rpaths agree, which turns segment-LCA reduction (the index build's
aggregation, KeyValueIndex.scala:90-93) into plain per-level segment min/max
— fully parallel, no data-dependent loops.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

NONE = 0
ROOT = 1


def paths(taxa: jnp.ndarray, parents: jnp.ndarray, max_path: int) -> jnp.ndarray:
    """Self-aligned ancestor paths: out[..., d] = d-th ancestor (0 = self),
    padded with NONE once the walk passes the root."""
    taxa = jnp.asarray(taxa, jnp.int32)

    def step(node, _):
        return parents[node], node

    _, path = jax.lax.scan(step, taxa, None, length=max_path)
    # path has shape [max_path, ...]; move to last axis
    return jnp.moveaxis(path, 0, -1)


def real_depths(taxa: jnp.ndarray, parents: jnp.ndarray, max_path: int) -> jnp.ndarray:
    """Number of edges from taxon to root (root=0; NONE -> -1)."""
    p = paths(taxa, parents, max_path)
    return jnp.sum(p != NONE, axis=-1).astype(jnp.int32) - 1


def root_aligned_from_paths(p: jnp.ndarray) -> jnp.ndarray:
    """Convert self-aligned paths [..., D] to root-aligned form without new
    parent gathers."""
    max_path = p.shape[-1]
    depth = jnp.sum(p != NONE, axis=-1, keepdims=True) - 1  # [..., 1]
    d = jnp.arange(max_path, dtype=jnp.int32)
    idx = depth - d  # position in self-aligned path of the depth-d ancestor
    ok = (idx >= 0) & (d <= depth)
    gathered = jnp.take_along_axis(p, jnp.clip(idx, 0, max_path - 1), axis=-1)
    return jnp.where(ok, gathered, -1)


def root_aligned_paths(taxa: jnp.ndarray, parents: jnp.ndarray, max_path: int) -> jnp.ndarray:
    """rpath[..., d] = ancestor of taxon at real depth d, or -1 if the taxon
    sits above depth d (or is NONE)."""
    return root_aligned_from_paths(paths(taxa, parents, max_path))


@partial(jax.jit, static_argnums=(3,))
def lca_pairs(a: jnp.ndarray, b: jnp.ndarray, parents: jnp.ndarray, max_path: int) -> jnp.ndarray:
    """Vectorised pairwise LCA with the reference's NONE semantics
    (LowestCommonAncestor.scala:49-78): lca(a, NONE) = a, lca(NONE, b) = b."""
    ra = root_aligned_paths(a, parents, max_path)
    rb = root_aligned_paths(b, parents, max_path)
    agree = (ra == rb) & (ra != -1)
    # deepest agreeing level
    d = jnp.arange(max_path, dtype=jnp.int32)
    best = jnp.max(jnp.where(agree, d, -1), axis=-1)
    lca_val = jnp.take_along_axis(ra, jnp.maximum(best, 0)[..., None], axis=-1)[..., 0]
    lca_val = jnp.where(best >= 0, lca_val, ROOT)
    a = jnp.asarray(a, jnp.int32)
    b = jnp.asarray(b, jnp.int32)
    out = jnp.where(a == NONE, b, jnp.where(b == NONE, a, lca_val))
    return out.astype(jnp.int32)


def lca_of_rpath_set(rpaths: jnp.ndarray, member: jnp.ndarray) -> jnp.ndarray:
    """LCA over a masked set of taxa given their root-aligned paths.

    rpaths: [..., T, D]; member: bool [..., T]. Returns [...] int32 taxon,
    NONE if the set is empty.
    """
    big = jnp.int32(2**31 - 1)
    r = jnp.where(member[..., None], rpaths, big)
    mn = jnp.min(r, axis=-2)  # [..., D]
    r2 = jnp.where(member[..., None], rpaths, jnp.int32(-2))
    mx = jnp.max(r2, axis=-2)
    agree = (mn == mx) & (mn != -1) & (mn != big)
    d = jnp.arange(rpaths.shape[-1], dtype=jnp.int32)
    best = jnp.max(jnp.where(agree, d, -1), axis=-1)
    val = jnp.take_along_axis(mn, jnp.maximum(best, 0)[..., None], axis=-1)[..., 0]
    return jnp.where(best >= 0, val, NONE).astype(jnp.int32)


def table_from_parents(parents: "np.ndarray", max_path: int = None):
    """Host-side root-aligned path table from a bare parents array (for toy
    problems/tests without a full Taxonomy; Taxonomy.rpath_table is the
    production path)."""
    import numpy as np

    parents = np.asarray(parents, np.int32)
    n = len(parents)
    # real depths by repeated lifting
    depth = np.full(n, -1, np.int64)
    node = np.arange(n)
    cur = node.copy()
    d = 0
    alive = np.ones(n, bool)
    alive[NONE] = False
    while alive.any():
        at_root = alive & (cur == ROOT)
        depth[at_root & (depth < 0)] = d
        # taxa whose chain hits NONE without passing ROOT: isolated, depth 0
        dead = alive & (cur == NONE)
        depth[dead & (depth < 0)] = 0
        alive &= ~(at_root | dead)
        cur = parents[np.clip(cur, 0, n - 1)]
        d += 1
        if d > n:
            break
    D = max_path or max(int(depth.max()) + 1, 1)
    table = np.full((n, D), -1, np.int32)
    order = np.argsort(depth)
    for t in order:
        if t == NONE or depth[t] < 0:
            continue
        dd = int(depth[t])
        if dd > 0 and parents[t] != NONE:
            table[t, :dd] = table[parents[t], :dd]
        if dd < D:
            table[t, dd] = t
    return table


@partial(jax.jit, static_argnums=(3,))
def segment_lca(
    run_ids: jnp.ndarray, taxa: jnp.ndarray, parents: jnp.ndarray, max_path: int
) -> jnp.ndarray:
    """LCA-reduce via on-device path walks (compat path; segment_lca_table
    with a precomputed table is the fast path)."""
    rp = root_aligned_paths(taxa, parents, max_path)  # [N, D]
    return _segment_lca_rp(run_ids, taxa, rp)


@jax.jit
def segment_lca_table(run_ids: jnp.ndarray, taxa: jnp.ndarray, rpath_table: jnp.ndarray) -> jnp.ndarray:
    """LCA-reduce taxa within each run using the precomputed root-aligned
    path table — one contiguous row gather per record (the index build's
    groupBy+LCA-UDAF, KeyValueIndex.scala:85-93). `run_ids` must be sorted,
    contiguous from 0. Entry r < num_runs of the result holds run r's LCA.

    The reduction runs LEVEL BY LEVEL over 1-D [N] vectors instead of one
    pass over an [N, D] matrix: a tiled device layout may pad a small minor
    dim (D of 2-20 for shallow taxonomies) many-fold, and at the build's
    superbatch sizes that padding alone can exceed device memory.
    """
    n = taxa.shape[0]
    d_levels = rpath_table.shape[-1]
    taxa_i = jnp.asarray(taxa, jnp.int32)
    defined = taxa_i != NONE
    big = jnp.int32(2**31 - 1)
    best = jnp.full(n, -1, jnp.int32)
    val = jnp.zeros(n, jnp.int32)
    # ascending levels with overwrite = deepest level where the whole run
    # agrees on one (non -1) ancestor — exactly max(agreeing d)
    for d in range(d_levels):
        lev = rpath_table[:, d][taxa_i]
        mn = jax.ops.segment_min(
            jnp.where(defined, lev, big), run_ids, num_segments=n
        )
        mx = jax.ops.segment_max(
            jnp.where(defined, lev, jnp.int32(-2)), run_ids, num_segments=n
        )
        agree = (mn == mx) & (mn != -1) & (mn != big)
        best = jnp.where(agree, d, best)
        val = jnp.where(agree, mn, val)
    any_defined = jax.ops.segment_max(
        defined.astype(jnp.int32), run_ids, num_segments=n
    )
    fallback = jnp.where(any_defined > 0, ROOT, NONE)
    return jnp.where(best >= 0, val, fallback).astype(jnp.int32)


def _segment_lca_rp(run_ids, taxa, rp):
    """Level-looped segment LCA over a materialised [N, D] path matrix
    (compat path for segment_lca; see segment_lca_table for the layout
    rationale)."""
    n = taxa.shape[0]
    max_path = rp.shape[-1]
    # NONE taxa act as the aggregation identity (TaxonLCA.zero,
    # LowestCommonAncestor.scala:153): exclude them from the reduction.
    defined = jnp.asarray(taxa, jnp.int32) != NONE
    big = jnp.int32(2**31 - 1)
    best = jnp.full(n, -1, jnp.int32)
    val = jnp.zeros(n, jnp.int32)
    for d in range(max_path):
        lev = rp[:, d]
        mn = jax.ops.segment_min(
            jnp.where(defined, lev, big), run_ids, num_segments=n
        )
        mx = jax.ops.segment_max(
            jnp.where(defined, lev, jnp.int32(-2)), run_ids, num_segments=n
        )
        agree = (mn == mx) & (mn != -1) & (mn != big)
        best = jnp.where(agree, d, best)
        val = jnp.where(agree, mn, val)
    any_defined = jax.ops.segment_max(
        defined.astype(jnp.int32), run_ids, num_segments=n
    )
    fallback = jnp.where(any_defined > 0, ROOT, NONE)
    return jnp.where(best >= 0, val, fallback).astype(jnp.int32)
