"""Explicit minimizer orderings via rank lookup tables.

Device equivalent of the reference's MinTable family
(MinimizerPriorities.scala:181-271) and the MinimizerOrdering ADT
(minimizer/package.scala:35-56): instead of the XOR-mask priority formula,
the priority of an m-mer is a rank read from a dense `uint32[4^m]` table —
one device-memory gather per position.

Like the reference (MinTable requires small m; Slacken's own CLI registry
exposes only randomXOR — SlackenMinimizerFormats.scala:24-42), explicit
orderings are bounded to small m: we require m <= MAX_LUT_M so the table
(4^m entries) stays a modest device array. Orderings provided:

  * lexicographic  — rank(x) = x (reference Lexicographic)
  * given          — explicit motif list in priority order (reference Given)
  * frequency      — rarest-first by sampled counts, ties lexicographic
                     (reference Frequency: orderings/package semantics)
  * signature      — KMC2/3 signature ordering (reference Signature,
                     package.scala:50 — declared in the ADT but, like
                     MinimizerFraction, never implemented anywhere in the
                     reference; semantics here follow the public KMC2
                     definition, see signature_lut)

Spacing composes the same way as the reference's SpacedSeed wrapper
(MinimizerPriorities.scala:274-321): the m-mer is masked first, then ranked,
so the table only needs ranks for masked motifs (unmasked entries are unused).

Memory arithmetic for the dense uint32[4^m] table (MAX_LUT_M = 15, the
reference MinTable's own bound, MinimizerPriorities.scala:181-271):
m=12 -> 67 MB, m=13 -> 268 MB, m=14 -> 1 GiB, m=15 -> 4 GiB, which the
device must hold beside the probe table; the per-position cost is unchanged
(one rank gather regardless of m).
The real cost is table CONSTRUCTION on the host (frequency at m=15 argsorts
4^15 counts: ~16 GB transient RAM, minutes), which a production build pays
once; the reference pays the same 4^m materialization in MinTable.byPriority.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .minimizers import MinimizerParams, space_mask_int

#: largest m for a dense rank table — matches the reference MinTable's bound
#: (MinimizerPriorities.scala:181-271); see the module docstring for the
#: 4^m size arithmetic
MAX_LUT_M = 15


def _check_m(m: int) -> int:
    if not (1 <= m <= MAX_LUT_M):
        raise ValueError(
            f"explicit-ordering tables require 1 <= m <= {MAX_LUT_M}, got {m}"
        )
    return 1 << (2 * m)


def lexicographic_lut(m: int) -> np.ndarray:
    """Rank = m-mer value (reference Lexicographic ordering)."""
    n = _check_m(m)
    return np.arange(n, dtype=np.uint32)


def given_lut(motifs: np.ndarray, m: int) -> np.ndarray:
    """Explicit priority list: motifs[i] gets rank i; absent motifs rank last
    (in lexicographic order), mirroring MinTable.byPriority semantics."""
    n = _check_m(m)
    motifs = np.asarray(motifs, dtype=np.int64)
    if motifs.size and (motifs.min() < 0 or motifs.max() >= n):
        raise ValueError("motif out of range for m")
    if np.unique(motifs).size != motifs.size:
        raise ValueError("duplicate motifs in priority list")
    lut = np.full(n, np.iinfo(np.uint32).max, np.uint32)
    lut[motifs] = np.arange(motifs.size, dtype=np.uint32)
    absent = np.flatnonzero(lut == np.iinfo(np.uint32).max)
    lut[absent] = np.arange(motifs.size, motifs.size + absent.size, dtype=np.uint32)
    return lut


def signature_lut(m: int) -> np.ndarray:
    """KMC2/3 signature ordering (reference Signature, package.scala:50).

    The reference declares this ordering in its ADT but implements it
    nowhere (no MinimizerPriorities subclass consumes it) — so, as with
    MinimizerFraction, the semantics here are taken from the public KMC 2
    definition (Deorowicz et al. 2015, "KMC 2: fast and resource-frugal
    k-mer counting", the 'signature' m-mer filter): an m-mer is a signature
    CANDIDATE iff it does not start with AAA, does not start with ACA, and
    contains AA nowhere except possibly at its very start. Candidates rank
    before non-candidates; within each class the order is lexicographic.
    """
    n = _check_m(m)
    vals = np.arange(n, dtype=np.uint32)  # 2m <= 30 bits
    allowed = np.ones(n, bool)
    if m >= 3:
        top3 = vals >> np.uint32(2 * (m - 3))
        allowed &= (top3 != 0b000000) & (top3 != 0b000100)  # AAA, ACA
    # AA starting at any interior position 1..m-2 (position 0 is permitted)
    for i in range(1, m - 1):
        pair = (vals >> np.uint32(2 * (m - 2 - i))) & np.uint32(0xF)
        allowed &= pair != 0
    n_allowed = int(allowed.sum())
    lut = np.where(
        allowed,
        np.cumsum(allowed, dtype=np.int64) - 1,
        np.cumsum(~allowed, dtype=np.int64) - 1 + n_allowed,
    ).astype(np.uint32)
    return lut


def frequency_lut(counts: np.ndarray, m: int) -> np.ndarray:
    """Rarest-first ordering from sampled m-mer counts (reference Frequency
    ordering): lower count => lower rank => preferred as minimizer; ties
    break lexicographically (stable argsort)."""
    n = _check_m(m)
    counts = np.asarray(counts)
    if counts.shape != (n,):
        raise ValueError(f"counts must have shape ({n},), got {counts.shape}")
    order = np.argsort(counts, kind="stable")
    lut = np.empty(n, np.uint32)
    lut[order] = np.arange(n, dtype=np.uint32)
    return lut


@partial(jax.jit, static_argnums=(1,))
def _mmer_rank_ids(codes, params: MinimizerParams):
    """Device kernel: spaced-masked canonical m-mer value per start position
    (-1 where the m-mer is invalid or past the row end). m <= MAX_LUT_M so
    the value fits the lo limb."""
    from . import minimizers as mz

    m = params.m
    mm = mz.mmer_at_starts(codes, m)
    if params.canonical:
        mm = mz.canonical_mmer(mm, m)
    mask = space_mask_int(m, params.spaces) if params.spaces > 0 else (1 << (2 * m)) - 1
    valid = mz.sliding_all(jnp.asarray(codes) < 4, m)
    return jnp.where(valid, (mm.lo & jnp.uint32(mask)).astype(jnp.int32), -1)


def sample_mmer_counts(
    code_rows, params: MinimizerParams, row_len: int = 1 << 15, batch_rows: int = 64
) -> np.ndarray:
    """Count spaced-masked canonical m-mer occurrences over sample sequences
    (feeds frequency_lut; reference Frequency ordering sampling).

    Vectorized: rows are packed into fixed-shape [batch_rows, row_len]
    batches (long rows split with m-1 overlap so no m-mer is lost), the
    device scan emits per-position masked canonical m-mer ids, and the host
    bincounts them — ~1000x the per-position Python loop this replaces.
    """
    m = params.m
    n = _check_m(m)
    # int32 above m=13 keeps the counts array <= 4 GiB at m=15 (sampled
    # occurrence counts are nowhere near 2^31)
    counts = np.zeros(n, np.int64 if m <= 13 else np.int32)
    buf: list = []

    def flush():
        if not buf:
            return
        from . import encode

        codes, _ = encode.pack_batch(buf, row_len)
        ids = np.asarray(_mmer_rank_ids(codes, params)).ravel()
        counts[:] += np.bincount(ids[ids >= 0], minlength=n)
        buf.clear()

    step = row_len - (m - 1)
    for row in code_rows:
        row = np.asarray(row, np.uint8)
        for off in range(0, max(len(row) - m + 1, 1), step):
            buf.append(row[off : off + row_len])
            if len(buf) >= batch_rows:
                flush()
    flush()
    return counts
