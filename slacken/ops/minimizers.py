"""Minimizer scanning on device (JAX/XLA).

Implements the reference's minimizer semantics (Kraken 2 compatible):

  priority(m-mer) = (canonical(m-mer) XOR toggle_mask) AND spaced_seed_mask

where canonical = unsigned min(forward, reverse-complement)
(NTBitArray.scala:437-452 — lexicographic orientation test equals unsigned
integer order for 2-bit codes), the toggle mask is Kraken 2's
DEFAULT_TOGGLE_MASK truncated to 2m bits (MinimizerPriorities.scala:146-160:
the left-aligned mask replication is equivalent to masking the low 2m bits in
a right-aligned representation), and the spaced seed clears s nucleotides at
odd positions 1,3,..,2s-1 counted from the right (MinimizerPriorities.scala:
287-300, verified against the documented example TTCTGTGGG/s=3 -> TTC-G-G-G).

The k-mer window minimizer is the minimum priority over the W = k-m+1 m-mer
start positions of the window (PosRankWindow.scala). Super-mer boundaries fall
exactly where the window minimum *value* changes between adjacent windows
(MinSplitter.scala:154-155 merges on equal rank), so no positions need to be
tracked — everything is dense per-position elementwise arrays.

Instead of the reference's sequential rolling scan (ShiftScanner.scala:90-159),
all per-position quantities are computed with O(log) doubling steps over the
whole [B, L] batch: m-mer assembly, validity windows, and sliding-window
minimum are each a handful of full-array uint32 ops.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from . import u64
from .u64 import U64

#: Kraken 2's minimizer toggle mask (mmscanner.h; reference package.scala:32)
DEFAULT_TOGGLE_MASK = 0xE37E28C4271B5A2D


class MinimizerParams(NamedTuple):
    """Minimizer scheme parameters (reference IndexParams.scala:63-91)."""

    k: int = 35
    m: int = 31
    spaces: int = 7
    toggle_mask: int = DEFAULT_TOGGLE_MASK
    canonical: bool = True

    @property
    def window(self) -> int:
        """Number of m-mer start positions per k-mer window."""
        return self.k - self.m + 1

    @property
    def wide(self) -> bool:
        """m > 31: minimizers need 2 u64 words (KmerKeyedIndex.scala:33-54)."""
        return self.m > 31

    def validate(self):
        if not (1 <= self.m <= 63):
            raise ValueError(f"m must be in [1, 63], got {self.m}")
        if self.k < self.m:
            raise ValueError(f"k ({self.k}) must be >= m ({self.m})")
        if self.spaces > self.m // 2:
            raise ValueError(f"spaces ({self.spaces}) must be <= m/2 ({self.m // 2})")
        return self


def space_mask_int(m: int, s: int) -> int:
    """Spaced-seed AND-mask over 2m bits: clears nt positions 1,3,..,2s-1 from the right."""
    mask = (1 << (2 * m)) - 1
    for j in range(s):
        pos = 2 * j + 1
        mask &= ~(0b11 << (2 * pos))
    return mask


def _shift_u32(x: jnp.ndarray, d: int, fill) -> jnp.ndarray:
    """out[..., i] = x[..., i+d], filling the tail with `fill` (static d >= 0)."""
    if d == 0:
        return x
    pad = jnp.full(x.shape[:-1] + (d,), fill, x.dtype)
    return jnp.concatenate([x[..., d:], pad], axis=-1)


def _shift_mask(x: jnp.ndarray, d: int, back: bool = False) -> jnp.ndarray:
    """Shift a boolean mask along the last axis (False fill); the mask
    rides through the concat as i32 and is re-compared, a round-trip XLA
    folds away.
    """
    if d == 0:
        return x
    xi = jnp.where(x, jnp.int32(1), jnp.int32(0))
    pad = jnp.zeros(x.shape[:-1] + (d,), jnp.int32)
    if back:
        out = jnp.concatenate([pad, xi[..., :-d]], axis=-1)
    else:
        out = jnp.concatenate([xi[..., d:], pad], axis=-1)
    return out != 0


def _shift_pair(x: U64, d: int, fill_int: int = 0) -> U64:
    hi_fill = jnp.uint32((fill_int >> 32) & 0xFFFFFFFF)
    lo_fill = jnp.uint32(fill_int & 0xFFFFFFFF)
    return U64(_shift_u32(x.hi, d, hi_fill), _shift_u32(x.lo, d, lo_fill))


def _powers_desc(n: int):
    """Decompose n into descending powers of two."""
    out = []
    p = 1 << (n.bit_length() - 1)
    while p:
        if n & p:
            out.append(p)
        p >>= 1
    return out


def mmer_at_starts(codes: jnp.ndarray, m: int) -> U64:
    """Value of the m-mer *starting* at each position, right-aligned in a u64.

    codes: [..., L] integer array; only the low 2 bits of each element are
    used (invalid markers are handled separately via validity masks).
    Positions within m-1 of the end contain garbage (mask downstream).

    Built by doubling: v_{2l}[i] = v_l[i] << 2l | v_l[i+l], then composing the
    binary decomposition of m — O(log m) full-array ops instead of a rolling
    scan (contrast ShiftScanner.scala:125-148).
    """
    c = jnp.asarray(codes).astype(jnp.uint32) & jnp.uint32(3)
    base = U64(jnp.zeros_like(c), c)
    pow_vals = {1: base}
    p = 1
    while p * 2 <= m:
        v = pow_vals[p]
        pow_vals[p * 2] = u64.bor(u64.shl(v, 2 * p), _shift_pair(v, p))
        p *= 2

    acc = None
    off = 0
    for p in _powers_desc(m):
        block = _shift_pair(pow_vals[p], off)
        acc = block if acc is None else u64.bor(u64.shl(acc, 2 * p), block)
        off += p
    return acc


def _rev_pairs_u32(x: jnp.ndarray) -> jnp.ndarray:
    """Reverse the 16 2-bit groups inside each uint32 (bithack, cf.
    BitRepresentation.scala:60-73 / Kraken 2 mmscanner.cc)."""
    x = ((x & jnp.uint32(0xCCCCCCCC)) >> 2) | ((x & jnp.uint32(0x33333333)) << 2)
    x = ((x & jnp.uint32(0xF0F0F0F0)) >> 4) | ((x & jnp.uint32(0x0F0F0F0F)) << 4)
    x = ((x & jnp.uint32(0xFF00FF00)) >> 8) | ((x & jnp.uint32(0x00FF00FF)) << 8)
    x = (x >> 16) | (x << 16)
    return x


def revcomp_mmer(x: U64, m: int) -> U64:
    """Reverse complement of a right-aligned 2-bit m-mer (m <= 31)."""
    # Reverse all 32 2-bit groups across the 64-bit value: per-limb group
    # reversal + limb swap, then right-align and complement.
    swapped = U64(_rev_pairs_u32(x.lo), _rev_pairs_u32(x.hi))
    aligned = u64.shr(swapped, 64 - 2 * m)
    comp_mask = (1 << (2 * m)) - 1
    return u64.bxor(aligned, u64.from_int(comp_mask, x.hi.shape))


def canonical_mmer(x: U64, m: int) -> U64:
    """Canonical orientation: unsigned min(forward, reverse complement)."""
    return u64.minu(x, revcomp_mmer(x, m))


def priorities_at_starts(codes: jnp.ndarray, params: MinimizerParams, lut=None):
    """Per-position minimizer priority and validity.

    Returns (prio: U64[..., L], mmer_valid: bool[..., L]) where position i
    refers to the m-mer starting at i. Invalid positions contain garbage in
    `prio`; consult the mask.

    When `lut` is given (an explicit-ordering rank table from
    `ops.ordering`, reference MinTable — MinimizerPriorities.scala:181-271),
    the priority is `lut[spaced-masked canonical m-mer]` instead of the
    XOR-mask formula; requires m <= ordering.MAX_LUT_M.
    """
    m = params.m
    mm = mmer_at_starts(codes, m)
    if params.canonical:
        mm = canonical_mmer(mm, m)
    if lut is not None:
        masked = mm
        if params.spaces > 0:
            masked = u64.band(
                masked, u64.from_int(space_mask_int(m, params.spaces), mm.hi.shape)
            )
        # m <= MAX_LUT_M (15) => the (masked) m-mer's 2m <= 30 bits fit in
        # lo; rank is a uint32
        prio = U64(jnp.zeros_like(mm.hi), jnp.asarray(lut)[masked.lo])
        valid1 = jnp.asarray(codes) < 4
        return prio, sliding_all(valid1, m)
    toggle = params.toggle_mask & ((1 << (2 * m)) - 1)
    prio = u64.bxor(mm, u64.from_int(toggle, mm.hi.shape))
    if params.spaces > 0:
        prio = u64.band(prio, u64.from_int(space_mask_int(m, params.spaces), mm.hi.shape))

    valid1 = jnp.asarray(codes) < 4
    mmer_valid = sliding_all(valid1, m)
    return prio, mmer_valid


# ---------------------------------------------------------------------------
# Wide minimizers (31 < m <= 63): same algorithms over u128 values
# ---------------------------------------------------------------------------

from . import u128 as u128_mod
from .u128 import U128


def _shift_u128(x: U128, d: int, fill_int: int = 0) -> U128:
    """out[..., i] = x[..., i+d] along the last axis (static d >= 0)."""
    f = fill_int & ((1 << 128) - 1)
    return U128(
        _shift_pair(x.hi, d, f >> 64),
        _shift_pair(x.lo, d, f & ((1 << 64) - 1)),
    )


def mmer_at_starts_wide(codes: jnp.ndarray, m: int) -> U128:
    """mmer_at_starts for m <= 63: right-aligned 2m-bit values in a U128."""
    c = jnp.asarray(codes).astype(jnp.uint32) & jnp.uint32(3)
    z = jnp.zeros_like(c)
    base = U128(U64(z, z), U64(z, c))
    pow_vals = {1: base}
    p = 1
    while p * 2 <= m:
        v = pow_vals[p]
        pow_vals[p * 2] = u128_mod.bor(u128_mod.shl(v, 2 * p), _shift_u128(v, p))
        p *= 2

    acc = None
    off = 0
    for p in _powers_desc(m):
        block = _shift_u128(pow_vals[p], off)
        acc = block if acc is None else u128_mod.bor(u128_mod.shl(acc, 2 * p), block)
        off += p
    return acc


def revcomp_mmer_wide(x: U128, m: int) -> U128:
    """Reverse complement of a right-aligned 2-bit m-mer (m <= 63)."""
    l3, l2, l1, l0 = x.limbs
    # reverse 2-bit groups within each limb, then reverse limb order
    swapped = u128_mod.from_limbs(
        _rev_pairs_u32(l0), _rev_pairs_u32(l1), _rev_pairs_u32(l2), _rev_pairs_u32(l3)
    )
    aligned = u128_mod.shr(swapped, 128 - 2 * m)
    comp_mask = (1 << (2 * m)) - 1
    return u128_mod.bxor(aligned, u128_mod.from_int(comp_mask, x.shape))


def priorities_at_starts_wide(codes: jnp.ndarray, params: MinimizerParams):
    """Wide-m per-position priority + m-mer validity (cf. priorities_at_starts).

    The toggle mask uses the reference's multi-long replication
    (MinimizerPriorities.scala:146-160, u128.wide_toggle_mask)."""
    m = params.m
    mm = mmer_at_starts_wide(codes, m)
    if params.canonical:
        mm = u128_mod.minu(mm, revcomp_mmer_wide(mm, m))
    toggle = u128_mod.wide_toggle_mask(m, params.toggle_mask)
    prio = u128_mod.bxor(mm, u128_mod.from_int(toggle, mm.shape))
    if params.spaces > 0:
        prio = u128_mod.band(
            prio, u128_mod.from_int(space_mask_int(m, params.spaces), mm.shape)
        )
    valid1 = jnp.asarray(codes) < 4
    return prio, sliding_all(valid1, m)


def sliding_min_u128(x: U128, width: int) -> U128:
    """out[i] = unsigned min of x[i : i+width] (doubling; garbage past end)."""
    fill = (1 << 128) - 1
    pow_vals = {1: x}
    p = 1
    while p * 2 <= width:
        v = pow_vals[p]
        pow_vals[p * 2] = u128_mod.minu(v, _shift_u128(v, p, fill))
        p *= 2
    acc = None
    off = 0
    for p in _powers_desc(width):
        block = _shift_u128(pow_vals[p], off, fill)
        acc = block if acc is None else u128_mod.minu(acc, block)
        off += p
    return acc


def sliding_all(valid: jnp.ndarray, width: int) -> jnp.ndarray:
    """out[i] = AND of valid[i : i+width] (False-filled past the end)."""
    pow_vals = {1: valid}
    p = 1
    while p * 2 <= width:
        v = pow_vals[p]
        pow_vals[p * 2] = v & _shift_mask(v, p)
        p *= 2
    acc = None
    off = 0
    for p in _powers_desc(width):
        block = _shift_mask(pow_vals[p], off)
        acc = block if acc is None else (acc & block)
        off += p
    return acc


def sliding_min_u64(x: U64, width: int) -> U64:
    """out[i] = unsigned min of x[i : i+width] (doubling; garbage past end)."""
    fill = (1 << 64) - 1
    pow_vals = {1: x}
    p = 1
    while p * 2 <= width:
        v = pow_vals[p]
        pow_vals[p * 2] = u64.minu(v, _shift_pair(v, p, fill))
        p *= 2
    acc = None
    off = 0
    for p in _powers_desc(width):
        block = _shift_pair(pow_vals[p], off, fill)
        acc = block if acc is None else u64.minu(acc, block)
        off += p
    return acc


class WindowMinimizers(NamedTuple):
    """Per-k-mer-window minimizers for a batch of sequences.

    All arrays are [..., L]; index i refers to the k-mer window starting at
    base position i. Only positions with ``valid`` True are meaningful.
    """

    minimizer: U64  # window minimizer priority value
    valid: jnp.ndarray  # bool: all k bases of the window are valid
    span_start: jnp.ndarray  # bool: window starts a new super-mer span
    distinct: jnp.ndarray  # bool: span's minimizer differs from previous valid span's


@partial(jax.jit, static_argnums=(1,))
def window_minimizers(codes: jnp.ndarray, params: MinimizerParams, lut=None) -> WindowMinimizers:
    """Compute per-window minimizers + span structure for a code batch.

    Semantics match getSpans/Supermers.spans (KeyValueIndex.scala:163-173,
    Supermers.scala:70-97): a window is valid iff its k bases are all valid
    (equivalently it lies inside a >=k valid run); span boundaries occur at
    validity gaps or where the window minimum value changes; `distinct`
    compares against the last valid window before this span, carried across
    ambiguous gaps (Supermers.scala:82-90: ambiguous/mate-border segments do
    not update lastMinimizer).

    For wide m (params.wide) the minimizer field is a U128 and the same span
    algebra runs over four limbs.
    """
    params.validate()
    if params.wide:
        if lut is not None:
            raise ValueError("explicit-ordering LUTs require m <= 31")
        prio, _ = priorities_at_starts_wide(codes, params)
        win_min = sliding_min_u128(prio, params.window)
        ne_fn = u128_mod.ne
        limbs = list(win_min.limbs)
        rebuild = lambda ls: u128_mod.from_limbs(*ls)  # noqa: E731
    else:
        prio, _ = priorities_at_starts(codes, params, lut)
        win_min = sliding_min_u64(prio, params.window)
        ne_fn = u64.ne
        limbs = [win_min.hi, win_min.lo]
        rebuild = lambda ls: U64(*ls)  # noqa: E731
    win_valid = sliding_all(jnp.asarray(codes) < 4, params.k)

    # span_start: first valid window, or previous window invalid, or value change
    prev_valid = _shift_mask(win_valid, 1, back=True)
    prev_min = rebuild([_unshift1(x) for x in limbs])
    value_change = ne_fn(win_min, prev_min)
    span_start = win_valid & (~prev_valid | value_change)

    # distinct: compare with last valid window value strictly before i
    # (carry-forward scan of the last valid minimizer value, by doubling)
    carry_vals, carry_has = _carry_forward(limbs, win_valid)
    # shift right: state strictly before i
    before = rebuild([_unshift1(x) for x in carry_vals])
    before_has = _shift_mask(carry_has, 1, back=True)
    differs = ne_fn(win_min, before)
    distinct = span_start & (~before_has | differs)

    return WindowMinimizers(win_min, win_valid, span_start, distinct)


def _unshift1(x: jnp.ndarray) -> jnp.ndarray:
    """out[..., i] = x[..., i-1] (zero-filled at i=0)."""
    pad = jnp.zeros(x.shape[:-1] + (1,), x.dtype)
    return jnp.concatenate([pad, x[..., :-1]], axis=-1)


def _unshift_pair(x: U64) -> U64:
    return U64(_unshift1(x.hi), _unshift1(x.lo))


def _carry_forward(vals, has: jnp.ndarray):
    """Inclusive 'last valid value' scan along the last axis via doubling:
    after ceil(log2 L) steps, position i holds the most recent multi-limb
    value (list of arrays) where `has` was True at or before i."""
    vals = list(vals)
    n = vals[0].shape[-1]
    step = 1
    while step < n:
        prevs = [_shift_back(v, step) for v in vals]
        phas = _shift_mask(has, step, back=True)
        take_prev = ~has & phas
        vals = [jnp.where(take_prev, p, v) for p, v in zip(prevs, vals)]
        has = has | phas
        step *= 2
    return vals, has


def _shift_back(x: jnp.ndarray, d: int) -> jnp.ndarray:
    """out[..., i] = x[..., i-d] (zero fill)."""
    pad = jnp.zeros(x.shape[:-1] + (d,), x.dtype)
    return jnp.concatenate([pad, x[..., :-d]], axis=-1)
