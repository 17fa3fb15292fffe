"""Sorted-array key lookup on device.

The index is a pair of sorted uint32 limb arrays (hi, lo) + an int32 taxon
per key, resident in HBM. Lookup is a branchless binary search, vectorised
over all queries: ceil(log2 N) rounds of two gathers each.

This replaces the reference's shuffle join against bucketed Parquet
(KeyValueIndex.scala:188-217): instead of routing spans to the partition
holding their minimizer, every device holds (a shard of) the sorted key
array and probes it locally.
"""

from __future__ import annotations

from typing import Optional

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .. import utils
from . import u64
from .u64 import U64


def keys_from_numpy(keys: np.ndarray) -> U64:
    """Split a uint64 numpy array into uint32 limb arrays."""
    keys = np.ascontiguousarray(keys, dtype=np.uint64)
    hi = (keys >> np.uint64(32)).astype(np.uint32)
    lo = keys.astype(np.uint32)
    return U64(jnp.asarray(hi), jnp.asarray(lo))


ROUTER_BITS = 16


def adaptive_router_bits(n_keys: int, max_bits: int = 24) -> int:
    """Router sized ~2x the key count: average bucket < 1 key, so the
    residual binary search is 1-4 rounds. 2^bits+1 int32 entries of HBM."""
    if n_keys <= 1:
        return 12
    return min(max_bits, max(12, int(np.ceil(np.log2(n_keys))) + 1))


def build_router(keys: np.ndarray, bits: int = ROUTER_BITS, key_bits: int = 62) -> np.ndarray:
    """Prefix router: entry p = index of the first key whose top `bits` bits
    (of the key_bits-wide keyspace) are >= p. Shrinks the binary search from
    log2(N) to log2(N / 2^bits) rounds.

    The XOR toggle scrambles minimizer priorities uniformly and the spaced
    seed only clears LOW bits (positions 2(2j+1), j < s), so top-bit prefixes
    are uniformly loaded.
    """
    keys = np.ascontiguousarray(keys, dtype=np.uint64)
    prefixes = (keys >> np.uint64(key_bits - bits)).astype(np.int64)
    router = np.searchsorted(prefixes, np.arange((1 << bits) + 1), side="left")
    return router.astype(np.int32)


def router_rounds(router: np.ndarray) -> int:
    """Binary-search rounds needed to cover the largest router bucket."""
    max_span = int(np.max(np.diff(router.astype(np.int64)))) if len(router) > 1 else 1
    return max(1, int(np.ceil(np.log2(max_span + 1))))


def lower_bound_routed(
    keys: U64,
    router: jnp.ndarray,
    q: U64,
    rounds: int,
    bits: int = ROUTER_BITS,
    key_bits: int = 62,
) -> jnp.ndarray:
    """Router-accelerated lower bound: O(log2(max bucket)) gather rounds
    instead of O(log2 N)."""
    n = keys.hi.shape[0]
    # the top `bits` bits of a key_bits-wide key fit in the low limb
    pfx = u64.shr(q, key_bits - bits).lo.astype(jnp.int32)
    pos = router[pfx]
    size = router[pfx + 1] - pos
    for _ in range(rounds):
        half = size >> 1
        mid = pos + half
        idx = jnp.minimum(mid, n - 1)
        k_at = U64(keys.hi[idx], keys.lo[idx])
        less = u64.ltu(k_at, q) & (size > 0)
        pos = jnp.where(less, mid + 1, pos)
        size = jnp.where(less, size - half - 1, half)
    return pos


def lower_bound(keys: U64, q: U64) -> jnp.ndarray:
    """Index of the first key >= q (vectorised over q's shape)."""
    n = keys.hi.shape[0]
    nbits = max(1, (n).bit_length())
    pos = jnp.zeros(q.hi.shape, jnp.int32)
    for b in reversed(range(nbits)):
        mid = pos + (1 << b)
        idx = jnp.minimum(mid - 1, n - 1)
        k_at = U64(keys.hi[idx], keys.lo[idx])
        ok = (mid <= n) & u64.ltu(k_at, q)
        pos = jnp.where(ok, mid, pos)
    return pos


@jax.jit
def lookup_taxa(keys: U64, taxa: jnp.ndarray, q: U64) -> jnp.ndarray:
    """Look up LCA taxa for query minimizers; misses return NONE (0),
    mirroring the left join + NONE fill (KeyValueIndex.scala:176-185)."""
    n = keys.hi.shape[0]
    if n == 0:
        return jnp.zeros(q.hi.shape, jnp.int32)
    pos = lower_bound(keys, q)
    idx = jnp.minimum(pos, n - 1)
    k_at = U64(keys.hi[idx], keys.lo[idx])
    found = (pos < n) & u64.eq(k_at, q)
    return jnp.where(found, taxa[idx], 0).astype(jnp.int32)


# ---------------------------------------------------------------------------
# Wide keys (m > 31): 2 x u64 per key, same router + binary search over 4 limbs
# ---------------------------------------------------------------------------

from . import u128 as u128_mod
from .u128 import U128


def wide_keys_from_numpy(keys2: np.ndarray) -> U128:
    """Split an [N, 2] uint64 array (hi64, lo64 columns) into a U128 of
    four uint32 limb arrays."""
    keys2 = np.ascontiguousarray(keys2, dtype=np.uint64)
    hi64 = keys2[:, 0]
    lo64 = keys2[:, 1]
    return U128(
        U64(
            jnp.asarray((hi64 >> np.uint64(32)).astype(np.uint32)),
            jnp.asarray(hi64.astype(np.uint32)),
        ),
        U64(
            jnp.asarray((lo64 >> np.uint64(32)).astype(np.uint32)),
            jnp.asarray(lo64.astype(np.uint32)),
        ),
    )


def build_router_wide(keys2: np.ndarray, bits: int, key_bits: int) -> np.ndarray:
    """Prefix router over the top `bits` bits of the key_bits (= 2m)-wide
    keyspace for [N, 2] uint64 keys."""
    keys2 = np.ascontiguousarray(keys2, dtype=np.uint64)
    if key_bits - bits >= 64:
        prefixes = (keys2[:, 0] >> np.uint64(key_bits - 64 - bits)).astype(np.int64)
    else:
        up = key_bits - bits  # < 64: prefix spans both words
        prefixes = (
            (keys2[:, 0].astype(object) << (64 - up)) | (keys2[:, 1] >> np.uint64(up))
        ).astype(np.int64)
    router = np.searchsorted(prefixes, np.arange((1 << bits) + 1), side="left")
    return router.astype(np.int32)


@partial(jax.jit, static_argnums=(4, 5, 6))
def lookup_taxa_routed_wide(
    keys: U128, taxa: jnp.ndarray, router: jnp.ndarray, q: U128, rounds: int,
    bits: int, key_bits: int = 126,
) -> jnp.ndarray:
    """Router-accelerated lookup for wide (2-word) keys; misses return 0."""
    n = keys.hi.hi.shape[0]
    if n == 0:
        return jnp.zeros(q.shape, jnp.int32)
    pfx = u128_mod.shr(q, key_bits - bits).lo.lo.astype(jnp.int32)
    pos = router[pfx]
    size = router[pfx + 1] - pos
    for _ in range(rounds):
        half = size >> 1
        mid = pos + half
        idx = jnp.minimum(mid, n - 1)
        k_at = u128_mod.from_limbs(
            keys.hi.hi[idx], keys.hi.lo[idx], keys.lo.hi[idx], keys.lo.lo[idx]
        )
        less = u128_mod.ltu(k_at, q) & (size > 0)
        pos = jnp.where(less, mid + 1, pos)
        size = jnp.where(less, size - half - 1, half)
    idx = jnp.minimum(pos, n - 1)
    k_at = u128_mod.from_limbs(
        keys.hi.hi[idx], keys.hi.lo[idx], keys.lo.hi[idx], keys.lo.lo[idx]
    )
    found = (pos < n) & u128_mod.eq(k_at, q)
    return jnp.where(found, taxa[idx], 0).astype(jnp.int32)


def build_tiled_wide(
    keys2: np.ndarray, taxa: np.ndarray, router: np.ndarray, tile: int = 16
):
    """build_tiled for wide ([N, 2] uint64) keys: interleaved row-major
    table [n_rows, tile, 5] uint32 (l3, l2, l1, l0, taxon); one row gather
    fetches `tile` whole records as a contiguous tile*20-byte burst."""
    n = len(keys2)
    tile = tile_for_span(max_bucket_span(router), tile)
    n_rows = -(-n // tile) + 2
    keys2 = np.ascontiguousarray(keys2, np.uint64)
    table = np.empty((n_rows * tile, 5), np.uint32)
    table[:n, 0] = (keys2[:, 0] >> np.uint64(32)).astype(np.uint32)
    table[:n, 1] = keys2[:, 0].astype(np.uint32)
    table[:n, 2] = (keys2[:, 1] >> np.uint64(32)).astype(np.uint32)
    table[:n, 3] = keys2[:, 1].astype(np.uint32)
    table[:n, 4] = np.asarray(taxa, np.int32).view(np.uint32)
    table[n:, :4] = 0xFFFFFFFF
    table[n:, 4] = 0
    return table.reshape(n_rows, tile, 5), tile


@partial(jax.jit, static_argnums=(3, 4, 5))
def lookup_taxa_tiled_wide(
    table: jnp.ndarray, router: jnp.ndarray, q: U128, tile: int,
    bits: int = ROUTER_BITS, key_bits: int = 126,
) -> jnp.ndarray:
    """lookup_taxa_tiled for wide keys: one router gather + two contiguous
    row gathers, 4-limb equality; misses return 0."""
    shape = q.hi.hi.shape
    limbs = [x.reshape(-1) for x in (q.hi.hi, q.hi.lo, q.lo.hi, q.lo.lo)]
    qf = u128_mod.from_limbs(*limbs)
    pfx = u128_mod.shr(qf, key_bits - bits).lo.lo.astype(jnp.int32)
    pos = router[pfx]
    row = pos // tile
    r0 = table[row]  # [Q, tile, 5]
    r1 = table[row + 1]
    both = jnp.concatenate([r0, r1], axis=1)  # [Q, 2*tile, 5]
    eq = (
        (both[:, :, 0] == limbs[0][:, None])
        & (both[:, :, 1] == limbs[1][:, None])
        & (both[:, :, 2] == limbs[2][:, None])
        & (both[:, :, 3] == limbs[3][:, None])
    )
    tx = both[:, :, 4].view(jnp.int32)
    taxon = jnp.max(jnp.where(eq, tx, 0), axis=-1).astype(jnp.int32)
    return taxon.reshape(shape)


def tile_for_span(maxb: int, tile: int = 16) -> int:
    """Smallest power-of-two tile with tile + 1 >= maxb: two consecutive
    rows then cover any router bucket (the build_tiled lookup invariant).
    Shared by every tiled-table build site so the geometry rule cannot
    drift between the single-chip, mesh, and multi-host builders."""
    while tile + 1 < maxb:
        tile *= 2
    return tile


def max_bucket_span(router: np.ndarray) -> int:
    """Largest key count under one router prefix (bucket width for the
    direct-bucket probe)."""
    if len(router) <= 1:
        return 1
    return max(1, int(np.max(np.diff(router.astype(np.int64)))))


def pad_keys_for_buckets(keys: np.ndarray, taxa: np.ndarray, maxb: int):
    """Sentinel-pad the sorted key/taxon arrays so a full `maxb`-wide bucket
    slice starting at any real position stays in bounds. The all-ones key
    exceeds any 62-bit priority, so padding never matches."""
    pad_k = np.full(maxb, np.uint64(0xFFFFFFFFFFFFFFFF))
    pad_t = np.zeros(maxb, np.int32)
    return (
        np.concatenate([np.asarray(keys, np.uint64), pad_k]),
        np.concatenate([np.asarray(taxa, np.int32), pad_t]),
    )


@partial(jax.jit, static_argnums=(4, 5, 6))
def lookup_taxa_bucketed(
    keys: U64,
    taxa: jnp.ndarray,
    router: jnp.ndarray,
    q: U64,
    maxb: int,
    bits: int = ROUTER_BITS,
    key_bits: int = 62,
) -> jnp.ndarray:
    """Direct-bucket probe: one router gather + three WIDE contiguous gathers.

    With `bits ~ log2(N)` the router bucket under each prefix holds only a
    handful of keys (max `maxb`), so instead of log2(maxb) rounds of two
    scattered 4-byte gathers (lower_bound_routed), each query loads its whole
    bucket with a vmapped dynamic_slice — a single gather of `maxb`
    contiguous elements per array — and scans it vectorised. 4 gathers per
    query total (vs ~10 for the routed binary search), each HBM-burst
    friendly. Requires keys/taxa padded with pad_keys_for_buckets(maxb).
    """
    shape = q.hi.shape
    qh = q.hi.reshape(-1)
    ql = q.lo.reshape(-1)
    pfx = u64.shr(U64(qh, ql), key_bits - bits).lo.astype(jnp.int32)
    pos = router[pfx]

    kh = jax.vmap(lambda p: jax.lax.dynamic_slice(keys.hi, (p,), (maxb,)))(pos)
    kl = jax.vmap(lambda p: jax.lax.dynamic_slice(keys.lo, (p,), (maxb,)))(pos)
    tx = jax.vmap(lambda p: jax.lax.dynamic_slice(taxa, (p,), (maxb,)))(pos)
    eq = (kh == qh[:, None]) & (kl == ql[:, None])
    taxon = jnp.max(jnp.where(eq, tx, 0), axis=-1).astype(jnp.int32)
    return taxon.reshape(shape)


# ---------------------------------------------------------------------------
# Tiled probe: router + aligned row-pair gather
# ---------------------------------------------------------------------------


def build_tiled(keys: np.ndarray, taxa: np.ndarray, router: np.ndarray, tile: int = 16):
    """Interleave the sorted (key, taxon) arrays into a row-major table
    [n_rows, tile, 3] uint32 (hi, lo, taxon) so one row gather fetches a
    whole aligned run of `tile` records as a single contiguous burst.

    A router bucket starting at `pos` spans at most max_bucket_span(router)
    records, so rows pos//tile and pos//tile + 1 always cover it provided
    maxb <= tile + 1; callers grow `tile` until that holds. Sentinel-padded
    (all-ones keys, taxon 0) so probes never match padding. Memory = 1.5x
    the flat arrays (taxon limb) + one pad row — no per-bucket blowup.
    """
    n = len(keys)
    tile = tile_for_span(max_bucket_span(router), tile)
    n_rows = -(-n // tile) + 2  # +1 straddle row, +1 for row+1 gather
    keys = np.ascontiguousarray(keys, np.uint64)
    table = np.empty((n_rows * tile, 3), np.uint32)
    table[:n, 0] = (keys >> np.uint64(32)).astype(np.uint32)
    table[:n, 1] = keys.astype(np.uint32)
    table[:n, 2] = np.asarray(taxa, np.int32).view(np.uint32)
    table[n:, 0] = 0xFFFFFFFF
    table[n:, 1] = 0xFFFFFFFF
    table[n:, 2] = 0
    return table.reshape(n_rows, tile, 3), tile


@partial(jax.jit, static_argnums=(3, 4, 5))
def lookup_taxa_tiled(
    table: jnp.ndarray, router: jnp.ndarray, q: U64, tile: int,
    bits: int = ROUTER_BITS, key_bits: int = 62,
) -> jnp.ndarray:
    """Tiled-table lookup: one router gather + two contiguous row gathers.

    Replaces the ~4-round dependent binary search (8+ scattered 4-byte
    gathers per query) with a single dependent chain of 2 gathers whose
    payload is a contiguous `tile*12`-byte burst — the HBM-friendly shape.
    Exact-match semantics are preserved because equality is checked on the
    full key: neighbouring buckets' keys in the fetched rows can never
    equal a query whose prefix differs. Misses return 0.
    """
    shape = q.hi.shape
    qh = q.hi.reshape(-1)
    ql = q.lo.reshape(-1)
    pfx = u64.shr(U64(qh, ql), key_bits - bits).lo.astype(jnp.int32)
    pos = router[pfx]
    row = pos // tile
    r0 = table[row]        # [Q, tile, 3]
    r1 = table[row + 1]
    kh = jnp.concatenate([r0[:, :, 0], r1[:, :, 0]], axis=1)
    kl = jnp.concatenate([r0[:, :, 1], r1[:, :, 1]], axis=1)
    tx = jnp.concatenate([r0[:, :, 2], r1[:, :, 2]], axis=1).view(jnp.int32)
    eq = (kh == qh[:, None]) & (kl == ql[:, None])
    taxon = jnp.max(jnp.where(eq, tx, 0), axis=-1).astype(jnp.int32)
    return taxon.reshape(shape)


# ---------------------------------------------------------------------------
# Hashed probe: routerless, displacement-bounded home slots
# ---------------------------------------------------------------------------


def _xorshift64_np(x: "np.ndarray") -> "np.ndarray":
    """Bijective xorshift64 mix (Marsaglia shift triple 13/7/17): makes the
    top bits of canonical m-mer keys uniform. Canonical keys min(fw, rc) are
    VALUE-biased toward the low half of the keyspace (density 2(1-x)), which
    would otherwise force oversized hashed tables; mixing low-bit entropy
    upward removes the bias without a multiply (u64s are u32 limb pairs,
    so shift/xor is ~1 op/limb while 64-bit multiplies are emulated)."""
    x = x.astype(np.uint64, copy=True)
    x ^= x << np.uint64(13)
    x ^= x >> np.uint64(7)
    x ^= x << np.uint64(17)
    return x


def _xorshift64_u64(x: U64) -> U64:
    x = u64.bxor(x, u64.shl(x, 13))
    x = u64.bxor(x, u64.shr(x, 7))
    return u64.bxor(x, u64.shl(x, 17))


def _sort_by_key(skeys: np.ndarray, taxa: np.ndarray):
    """Sort (u64 key, i32 taxon) pairs by key — the C++ OpenMP LSD radix
    sort when available (np.argsort of 131M u64 keys costs minutes on this
    host; the native sort seconds), numpy fallback otherwise."""
    from .. import native

    return native.radix_sort_kv(skeys, np.asarray(taxa, np.int32))


def build_hashed(
    keys: np.ndarray,
    taxa: np.ndarray,
    key_bits: int = 62,
    tile: int = 16,
    bits=None,
):
    """Place xorshift-scrambled keys at bounded displacement from the home
    slot implied by their scrambled top bits, eliminating the router (and
    its gather).

    The scramble is bijective, so equality on scrambled values is equality
    on keys, and its output is uniform, so h = key' >> (64 - bits) is a good
    hash. Sorting by key' makes h nondecreasing; linear-probing placement
    over sorted hashes is then the vectorised "parking" scan
    pos = cummax(h - i) + i. Slot count (2^bits) grows until every key's
    displacement fits disp <= tile - 1; the key for home slot h is then
    guaranteed inside rows h//tile and h//tile + 1 of the row-major
    [n_rows, tile, 3] table, so lookup is two ALIGNED contiguous row
    gathers with no router (lookup_taxa_hashed) — a depth-0 gather chain
    versus the tiled probe's router + 2-row dependent pair.

    Layout note: an UNALIGNED [tile, 3] slice gather starting at h itself
    would make XLA materialise a [Q, tile, 3] result whose layout may pad
    its minor dims; aligned row gathers keep the result in the table's own
    layout.

    `bits` forces the slot count (2^bits) and lets the tile grow instead:
    fewer, fatter fetches at lower memory. The default grows bits first,
    keeping the fetch at 2*tile slots (24*tile bytes).

    Returns (table [n_rows, tile, 3] uint32 (hi', lo', taxon), tile, bits).
    """
    n = len(keys)
    skeys = _xorshift64_np(np.ascontiguousarray(keys, np.uint64))
    skeys, staxa = _sort_by_key(skeys, taxa)
    auto_bits = bits is None
    if auto_bits:
        bits = max(12, int(np.ceil(np.log2(max(n, 2)))) + 1)
    # the scramble guarantees near-uniform hashes, so a blowout can only
    # mean adversarial inputs; cap the search (<=30 keeps h in int32)
    max_bits = min(30, bits + 6)
    if n == 0:
        pos = np.zeros(0, np.int64)
    else:
        ar = np.arange(n, dtype=np.int64)
        while True:
            h = (skeys >> np.uint64(64 - bits)).astype(np.int64)
            pos = np.maximum.accumulate(h - ar) + ar
            max_disp = int(np.max(pos - h))
            if max_disp <= tile - 1:
                break
            if auto_bits and bits < max_bits:
                bits += 1
            elif tile < 1 << 12:
                tile *= 2
            else:
                raise ValueError(
                    f"hashed layout did not converge (n={n}); "
                    "use the tiled/routed probe"
                )
    # row h//tile + its successor must exist for every occupied slot; a
    # query hash beyond the last occupied row clamps onto sentinel rows —
    # a correct miss (no key can be parked past max_pos)
    max_pos = int(pos[-1]) if n else 0
    n_rows = max_pos // tile + 3  # straddle row + clamp row
    # one contiguous sentinel fill (column-strided fills cost seconds at
    # 100s of MB). The sentinel taxon is therefore -1, which is safe: the
    # probe's max(taxon, 0) reduction absorbs negative taxa into a miss,
    # and a real key whose scramble happens to BE all-ones still wins the
    # max with its own non-negative taxon.
    table = np.full((n_rows * tile, 3), 0xFFFFFFFF, np.uint32)
    table[pos, 0] = (skeys >> np.uint64(32)).astype(np.uint32)
    table[pos, 1] = skeys.astype(np.uint32)
    table[pos, 2] = staxa.view(np.uint32)
    return table.reshape(n_rows, tile, 3), tile, bits


@partial(jax.jit, static_argnums=(2, 3, 4))
def lookup_taxa_hashed(
    table: jnp.ndarray, q: U64, tile: int, bits: int, key_bits: int = 62
) -> jnp.ndarray:
    """Routerless lookup against a build_hashed table: scramble the query
    (pure ALU), then two ALIGNED contiguous row gathers around the home
    slot h = scrambled top bits (rows h//tile and h//tile + 1 always cover
    slots [h, h + tile) — every key sits within tile-1 slots of its home
    by construction), full scrambled-key equality; misses return 0.
    `key_bits` is unused (the scrambled hash spans the full 64-bit domain)
    but kept for probe-signature uniformity."""
    shape = q.hi.shape
    sq = _xorshift64_u64(U64(q.hi.reshape(-1), q.lo.reshape(-1)))
    qh, ql = sq.hi, sq.lo
    h = u64.shr(sq, 64 - bits).lo.astype(jnp.int32)
    row = h // tile
    r0 = table[row]        # [Q, tile, 3] (indices clamp onto sentinel rows)
    r1 = table[row + 1]
    kh = jnp.concatenate([r0[:, :, 0], r1[:, :, 0]], axis=1)
    kl = jnp.concatenate([r0[:, :, 1], r1[:, :, 1]], axis=1)
    tx = jnp.concatenate([r0[:, :, 2], r1[:, :, 2]], axis=1).view(jnp.int32)
    eq = (kh == qh[:, None]) & (kl == ql[:, None])
    taxon = jnp.max(jnp.where(eq, tx, 0), axis=-1).astype(jnp.int32)
    # a garbage query can key-match ONLY sentinel slots (taxon -1); if every
    # compared lane is sentinel the 0 never enters the max
    return jnp.maximum(taxon, 0).reshape(shape)


def build_hashed_cols(
    keys: np.ndarray,
    taxa: np.ndarray,
    key_bits: int = 62,
    tile: int = 128,
    bits=None,
):
    """build_hashed with a COLUMN-BLOCK row layout: [n_rows, 3*tile] uint32
    rows holding [kh | kl | taxon] lane blocks, fetched as two aligned row
    gathers of `tile`*12 contiguous bytes each.

    Rationale: a [Q, tile, 3] gather result has a minor dim of 3, which a
    tiled device layout may pad many-fold, while [Q, 3*tile] with tile >= 128
    is a multiple of 128 elements wide (no padding). The fetched slots
    per query grow from 2*16 to 2*128, which buys a displacement budget of
    tile-1 = 127: the hash can run at load factor ~1 (bits = ceil(log2 n)),
    shrinking the table from ~38 B/key (auto 16-slot layout) to ~12-24 B/key
    — the difference between a 131M-record index probing from a 3.2 GB or a
    1.6 GB table.

    Returns (table [n_rows, 3*tile] uint32, tile, bits).
    """
    n = len(keys)
    skeys = _xorshift64_np(np.ascontiguousarray(keys, np.uint64))
    skeys, staxa = _sort_by_key(skeys, taxa)
    auto_bits = bits is None
    if auto_bits:
        # load factor ~1: the 127-slot displacement budget absorbs the
        # clustering that the 16-slot layout had to dilute with extra bits
        bits = max(12, int(np.ceil(np.log2(max(n, 2)))))
    max_bits = min(30, bits + 6)
    if n == 0:
        pos = np.zeros(0, np.int64)
    else:
        ar = np.arange(n, dtype=np.int64)
        while True:
            h = (skeys >> np.uint64(64 - bits)).astype(np.int64)
            pos = np.maximum.accumulate(h - ar) + ar
            max_disp = int(np.max(pos - h))
            if max_disp <= tile - 1:
                break
            if auto_bits and bits < max_bits:
                bits += 1
            elif tile < 1 << 12:
                tile *= 2
            else:
                raise ValueError(
                    f"hashed layout did not converge (n={n}); "
                    "use the tiled/routed probe"
                )
    max_pos = int(pos[-1]) if n else 0
    n_rows = max_pos // tile + 3
    table = np.full((n_rows, 3 * tile), 0xFFFFFFFF, np.uint32)
    r, c = pos // tile, pos % tile
    table[r, c] = (skeys >> np.uint64(32)).astype(np.uint32)
    table[r, tile + c] = skeys.astype(np.uint32)
    table[r, 2 * tile + c] = staxa.view(np.uint32)
    return table, tile, bits


@partial(jax.jit, static_argnums=(2, 3, 4))
def lookup_taxa_hashed_cols(
    table: jnp.ndarray, q: U64, tile: int, bits: int, key_bits: int = 62
) -> jnp.ndarray:
    """lookup_taxa_hashed against a build_hashed_cols table: two aligned
    [3*tile]-lane row gathers (zero layout padding for tile >= 128), full
    scrambled-key equality over 2*tile slots; misses return 0."""
    shape = q.hi.shape
    sq = _xorshift64_u64(U64(q.hi.reshape(-1), q.lo.reshape(-1)))
    qh, ql = sq.hi, sq.lo
    h = u64.shr(sq, 64 - bits).lo.astype(jnp.int32)
    row = h // tile
    r0 = table[row]        # [Q, 3*tile]
    r1 = table[row + 1]
    kh = jnp.concatenate([r0[:, :tile], r1[:, :tile]], axis=1)
    kl = jnp.concatenate([r0[:, tile : 2 * tile], r1[:, tile : 2 * tile]], axis=1)
    tx = jnp.concatenate([r0[:, 2 * tile :], r1[:, 2 * tile :]], axis=1).view(jnp.int32)
    eq = (kh == qh[:, None]) & (kl == ql[:, None])
    taxon = jnp.max(jnp.where(eq, tx, 0), axis=-1).astype(jnp.int32)
    return jnp.maximum(taxon, 0).reshape(shape)


def fits_hashed_rows(n_keys: int, budget_bytes: Optional[int] = None) -> bool:
    """Conservative device-memory fit test for a build_hashed_rows table of
    n_keys. The default budget is a quarter of the device's memory limit,
    leaving the rest to the classify batches' transients. The auto sizing starts at 2^ceil(log2(n/128)) rows and grows row_bits
    until the fullest row fits 128 slots — one growth step in practice
    (after one doubling the mean row load is <= 64 and the binomial max over
    2^row_bits rows stays under 128) — so the estimate allows 2x over the
    initial slot count. Shared by every auto-probe selection site so the
    policy cannot desynchronize."""
    if budget_bytes is None:
        budget_bytes = utils.device_memory_bytes() // 4
    est_slots = 1 << max(12, int(np.ceil(np.log2(max(n_keys, 2) / 128))) + 7)
    return 12 * 2 * est_slots <= budget_bytes


def build_hashed_rows(
    keys: np.ndarray,
    taxa: np.ndarray,
    key_bits: int = 62,
    tile: int = 128,
    row_bits=None,
):
    """Row-bucket hash table probed with ONE aligned row gather per query.

    The two displacement-bounded layouts above (build_hashed/_cols) park a
    key within tile-1 slots of its home SLOT, which can straddle a row
    boundary, so lookups must fetch two consecutive rows. Here the hash
    addresses a whole ROW instead: every key whose scrambled top `row_bits`
    bits equal r lives somewhere inside row r, so a lookup is a single
    aligned [3*tile]-element gather + tile-wide equality scan: half the
    dependent gathers of the two-row layouts, at 1536 B fetched per query
    (tile=128).

    Row occupancy is binomial with mean n/2^row_bits; `row_bits` grows until
    the fullest row fits in `tile` slots, landing at load factor ~0.3-0.8
    (~15-38 B/key — at or below build_hashed's auto sizing). Layout is the
    column-block [n_rows, 3*tile] (kh | kl | taxon blocks): rows 128-element
    aligned at tile=128, no layout padding.

    Returns (table [2^row_bits, 3*tile] uint32, tile, row_bits).
    """
    n = len(keys)
    skeys = _xorshift64_np(np.ascontiguousarray(keys, np.uint64))
    skeys, staxa = _sort_by_key(skeys, taxa)
    auto = row_bits is None
    if auto:
        row_bits = max(1, int(np.ceil(np.log2(max(n, 2) / tile))))
    max_bits = min(28, row_bits + 8)
    if n == 0:
        rows = np.zeros(0, np.int64)
        cols = np.zeros(0, np.int64)
    else:
        # keys are sorted, so per-row counts come from searchsorted on the
        # 2^row_bits row boundaries — O(rows log n) per growth retry instead
        # of a full O(n) bincount pass (at 131M keys this is the difference
        # between seconds and minutes of table-build time)
        while True:
            bnd = np.arange(1 << row_bits, dtype=np.uint64) << np.uint64(
                64 - row_bits
            )
            starts = np.searchsorted(skeys, bnd, side="left")
            maxc = int(np.max(np.diff(np.append(starts, n))))
            if maxc <= tile:
                break
            if auto and row_bits < max_bits:
                row_bits += 1
            elif tile < 1 << 12:
                tile *= 2
            else:
                raise ValueError(
                    f"hashed-rows layout did not converge (n={n}); "
                    "use the hashed/tiled probe"
                )
        rows = (skeys >> np.uint64(64 - row_bits)).astype(np.int64)
        cols = np.arange(n, dtype=np.int64) - starts[rows]
    n_rows = 1 << row_bits
    # sentinel = all-ones key, taxon lanes read as -1: absorbed by the
    # max(taxon, 0) reduction exactly as in build_hashed
    table = np.full((n_rows, 3 * tile), 0xFFFFFFFF, np.uint32)
    table[rows, cols] = (skeys >> np.uint64(32)).astype(np.uint32)
    table[rows, tile + cols] = skeys.astype(np.uint32)
    table[rows, 2 * tile + cols] = staxa.view(np.uint32)
    return table, tile, row_bits


@jax.jit
def _sort_scrambled_device(kh, kl, tx):
    """Scramble u64 keys (xorshift64) and sort (key, taxon) by scrambled
    value — the device half of build_hashed_rows' preprocessing."""
    sq = _xorshift64_u64(U64(kh, kl))
    return jax.lax.sort((sq.hi, sq.lo, tx), num_keys=2)


@partial(jax.jit, static_argnums=(1,))
def _max_row_count_device(sh, row_bits: int):
    """Fullest-row occupancy at a candidate row_bits (scalar, for the
    auto-growth loop)."""
    rows = (sh >> jnp.uint32(32 - row_bits)).astype(jnp.int32)
    return jnp.zeros(1 << row_bits, jnp.int32).at[rows].add(1).max()


@partial(jax.jit, static_argnums=(3, 4))
def _scatter_rows_device(sh, sl, stx, tile: int, row_bits: int):
    """Scatter sorted scrambled records into the [2^row_bits, 3*tile]
    column-block table (bit-identical layout to build_hashed_rows)."""
    n = sh.shape[0]
    rows = (sh >> jnp.uint32(32 - row_bits)).astype(jnp.int32)
    starts = jnp.searchsorted(
        rows, jnp.arange(1 << row_bits, dtype=jnp.int32), side="left"
    )
    cols = jnp.arange(n, dtype=jnp.int32) - starts[rows]
    table = jnp.full(((1 << row_bits), 3 * tile), 0xFFFFFFFF, jnp.uint32)
    table = table.at[rows, cols].set(sh)
    table = table.at[rows, tile + cols].set(sl)
    table = table.at[rows, 2 * tile + cols].set(stx)
    return table


def build_hashed_rows_device(kh, kl, taxa, tile: int = 128, row_bits=None):
    """build_hashed_rows entirely ON DEVICE, from u32 limb arrays of the
    (unique) keys — the build->serve path that never round-trips records
    through the host. Returns (device table, tile, row_bits), bit-identical to
    the host builder's output for the same geometry; the auto-growth policy
    (row_bits then tile, max_bits = start+8 capped at 28) matches exactly.
    Only the per-retry occupancy scalar crosses the link."""
    n = int(kh.shape[0])
    sh, sl, stx = _sort_scrambled_device(
        jnp.asarray(kh), jnp.asarray(kl), jnp.asarray(taxa).view(jnp.uint32)
    )
    auto = row_bits is None
    if auto:
        row_bits = max(1, int(np.ceil(np.log2(max(n, 2) / tile))))
    max_bits = min(28, row_bits + 8)
    if n:
        while True:
            maxc = int(_max_row_count_device(sh, row_bits))
            if maxc <= tile:
                break
            if auto and row_bits < max_bits:
                row_bits += 1
            elif tile < 1 << 12:
                tile *= 2
            else:
                raise ValueError(
                    f"hashed-rows layout did not converge (n={n}); "
                    "use the hashed/tiled probe"
                )
    table = _scatter_rows_device(sh, sl, stx, tile, row_bits)
    return table, tile, row_bits


@partial(jax.jit, static_argnums=(2, 3, 4))
def lookup_taxa_hashed_rows(
    table: jnp.ndarray, q: U64, tile: int, row_bits: int, key_bits: int = 62
) -> jnp.ndarray:
    """Lookup against a build_hashed_rows table: scramble (pure ALU), ONE
    aligned [3*tile]-lane row gather, tile-wide scrambled-key equality;
    misses return 0. The shortest possible gather chain for an exact-match
    probe: depth 0, one gather. `key_bits` unused (signature uniformity)."""
    shape = q.hi.shape
    sq = _xorshift64_u64(U64(q.hi.reshape(-1), q.lo.reshape(-1)))
    qh, ql = sq.hi, sq.lo
    row = u64.shr(sq, 64 - row_bits).lo.astype(jnp.int32)
    r = table[row]  # [Q, 3*tile]
    eq = (r[:, :tile] == qh[:, None]) & (r[:, tile : 2 * tile] == ql[:, None])
    tx = r[:, 2 * tile :].view(jnp.int32)
    taxon = jnp.max(jnp.where(eq, tx, 0), axis=-1).astype(jnp.int32)
    return jnp.maximum(taxon, 0).reshape(shape)


def _wide_row_hash_np(keys2: np.ndarray) -> np.ndarray:
    """Uniform 64-bit hash of [N, 2] u64 wide keys for row addressing.

    hi64 holds only key_bits-64 significant bits for m just over 31, so the
    hash mixes the (near-uniform, xor-toggled) lo64 upward first:
    h = xorshift64(hi64 ^ xorshift64(lo64)). Collisions are harmless — the
    probe compares the RAW four limbs, the hash only picks the row."""
    keys2 = np.ascontiguousarray(keys2, np.uint64)
    return _xorshift64_np(keys2[:, 0] ^ _xorshift64_np(keys2[:, 1]))


def _wide_row_hash_u64(hi64: U64, lo64: U64) -> U64:
    return _xorshift64_u64(u64.bxor(hi64, _xorshift64_u64(lo64)))


def build_hashed_rows_wide(
    keys2: np.ndarray,
    taxa: np.ndarray,
    key_bits: int = 126,
    tile: int = 128,
    row_bits=None,
):
    """build_hashed_rows for wide ([N, 2] u64) keys: single-gather
    row-bucket table [2^row_bits, 5*tile] uint32 with lane blocks
    (l3 | l2 | l1 | l0 | taxon); raw limbs stored, row picked by
    _wide_row_hash_np. Returns (table, tile, row_bits)."""
    n = len(keys2)
    keys2 = np.ascontiguousarray(keys2, np.uint64)
    h = _wide_row_hash_np(keys2)
    from .. import native

    _, order = native.radix_sort_kv(h, np.arange(len(h), dtype=np.int32))
    h = h[order]
    keys2 = keys2[order]
    staxa = np.asarray(taxa, np.int32)[order]
    auto = row_bits is None
    if auto:
        row_bits = max(1, int(np.ceil(np.log2(max(n, 2) / tile))))
    max_bits = min(28, row_bits + 8)
    if n == 0:
        rows = np.zeros(0, np.int64)
        cols = np.zeros(0, np.int64)
    else:
        # h is sorted: searchsorted row boundaries (see build_hashed_rows)
        while True:
            bnd = np.arange(1 << row_bits, dtype=np.uint64) << np.uint64(
                64 - row_bits
            )
            starts = np.searchsorted(h, bnd, side="left")
            maxc = int(np.max(np.diff(np.append(starts, n))))
            if maxc <= tile:
                break
            if auto and row_bits < max_bits:
                row_bits += 1
            elif tile < 1 << 12:
                tile *= 2
            else:
                raise ValueError(
                    f"wide hashed-rows layout did not converge (n={n}); "
                    "use the tiled probe"
                )
        rows = (h >> np.uint64(64 - row_bits)).astype(np.int64)
        cols = np.arange(n, dtype=np.int64) - starts[rows]
    n_rows = 1 << row_bits
    table = np.full((n_rows, 5 * tile), 0xFFFFFFFF, np.uint32)
    table[rows, cols] = (keys2[:, 0] >> np.uint64(32)).astype(np.uint32)
    table[rows, tile + cols] = keys2[:, 0].astype(np.uint32)
    table[rows, 2 * tile + cols] = (keys2[:, 1] >> np.uint64(32)).astype(np.uint32)
    table[rows, 3 * tile + cols] = keys2[:, 1].astype(np.uint32)
    table[rows, 4 * tile + cols] = staxa.view(np.uint32)
    return table, tile, row_bits


@jax.jit
def _sort_wide_by_hash_device(l3, l2, l1, l0, tx):
    """Row-hash wide records and stable-sort by the hash (device half of
    build_hashed_rows_wide's preprocessing; stability matches the host's
    LSD radix sort on equal hashes)."""
    h = _wide_row_hash_u64(U64(l3, l2), U64(l1, l0))
    return jax.lax.sort((h.hi, h.lo, l3, l2, l1, l0, tx), num_keys=2)


@partial(jax.jit, static_argnums=(6, 7))
def _scatter_rows_device_wide(hh, s3, s2, s1, s0, stx, tile: int, row_bits: int):
    """Scatter hash-sorted wide records into the [2^row_bits, 5*tile]
    lane-block table (bit-identical layout to build_hashed_rows_wide)."""
    n = hh.shape[0]
    rows = (hh >> jnp.uint32(32 - row_bits)).astype(jnp.int32)
    starts = jnp.searchsorted(
        rows, jnp.arange(1 << row_bits, dtype=jnp.int32), side="left"
    )
    cols = jnp.arange(n, dtype=jnp.int32) - starts[rows]
    table = jnp.full(((1 << row_bits), 5 * tile), 0xFFFFFFFF, jnp.uint32)
    for i, lane in enumerate((s3, s2, s1, s0, stx)):
        table = table.at[rows, i * tile + cols].set(lane)
    return table


def build_hashed_rows_wide_device(l3, l2, l1, l0, taxa, tile: int = 128,
                                  row_bits=None):
    """build_hashed_rows_wide entirely ON DEVICE from the four u32 key limb
    arrays (most significant first) — the wide build->serve path. Same
    auto-growth policy as the host builder; bit-identical tables for the
    same input order. Only the per-retry occupancy scalar crosses the
    link."""
    n = int(l3.shape[0])
    hh, _, s3, s2, s1, s0, stx = _sort_wide_by_hash_device(
        jnp.asarray(l3), jnp.asarray(l2), jnp.asarray(l1), jnp.asarray(l0),
        jnp.asarray(taxa).view(jnp.uint32),
    )
    auto = row_bits is None
    if auto:
        row_bits = max(1, int(np.ceil(np.log2(max(n, 2) / tile))))
    max_bits = min(28, row_bits + 8)
    if n:
        while True:
            maxc = int(_max_row_count_device(hh, row_bits))
            if maxc <= tile:
                break
            if auto and row_bits < max_bits:
                row_bits += 1
            elif tile < 1 << 12:
                tile *= 2
            else:
                raise ValueError(
                    f"wide hashed-rows layout did not converge (n={n}); "
                    "use the tiled probe"
                )
    table = _scatter_rows_device_wide(hh, s3, s2, s1, s0, stx, tile, row_bits)
    return table, tile, row_bits


@partial(jax.jit, static_argnums=(2, 3, 4))
def lookup_taxa_hashed_rows_wide(
    table: jnp.ndarray, q: U128, tile: int, row_bits: int, key_bits: int = 126
) -> jnp.ndarray:
    """Single aligned row gather + 4-limb raw equality for wide keys
    (build_hashed_rows_wide tables); misses return 0. A real all-ones key
    cannot exist (keys are <= 126 bits), so sentinel lanes never match."""
    shape = q.hi.hi.shape
    limbs = [x.reshape(-1) for x in (q.hi.hi, q.hi.lo, q.lo.hi, q.lo.lo)]
    h = _wide_row_hash_u64(U64(limbs[0], limbs[1]), U64(limbs[2], limbs[3]))
    row = u64.shr(h, 64 - row_bits).lo.astype(jnp.int32)
    r = table[row]  # [Q, 5*tile]
    eq = (
        (r[:, :tile] == limbs[0][:, None])
        & (r[:, tile : 2 * tile] == limbs[1][:, None])
        & (r[:, 2 * tile : 3 * tile] == limbs[2][:, None])
        & (r[:, 3 * tile : 4 * tile] == limbs[3][:, None])
    )
    tx = r[:, 4 * tile :].view(jnp.int32)
    taxon = jnp.max(jnp.where(eq, tx, 0), axis=-1).astype(jnp.int32)
    return jnp.maximum(taxon, 0).reshape(shape)


def compact_span_queries(wm, cap: int):
    """Compact a batch's span-start minimizers into a [cap] query buffer.

    All windows of a super-mer span share one minimizer, so probing once per
    span (~0.4x positions for typical W = k-m+1) instead of once per window
    cuts probe work — and, in the ring-sharded layout, interconnect traffic — by
    ~2.5x. Returns (q_hi[cap], q_lo[cap], sid[B*L], n_spans): `sid` maps each
    window position to its span's slot; unused slots hold the all-ones
    sentinel (matches nothing). Callers must handle n_spans > cap (fall back
    to probing every position).
    """
    b, l = wm.valid.shape
    n = b * l
    start = wm.span_start.reshape(n)
    hi = wm.minimizer.hi.reshape(n)
    lo = wm.minimizer.lo.reshape(n)
    sid = jnp.cumsum(start) - 1
    q_idx = jnp.where(start, sid, cap)
    sent = jnp.uint32(0xFFFFFFFF)
    q_hi = jnp.full(cap, sent).at[q_idx].set(hi, mode="drop")
    q_lo = jnp.full(cap, sent).at[q_idx].set(lo, mode="drop")
    return q_hi, q_lo, sid, sid[-1] + 1


def compact_span_queries_wide(wm, cap: int):
    """compact_span_queries for wide minimizers: returns
    ((l3, l2, l1, l0) query limb buffers, sid, n_spans)."""
    b, l = wm.valid.shape
    n = b * l
    start = wm.span_start.reshape(n)
    sid = jnp.cumsum(start) - 1
    q_idx = jnp.where(start, sid, cap)
    sent = jnp.uint32(0xFFFFFFFF)
    qs = tuple(
        jnp.full(cap, sent).at[q_idx].set(x.reshape(n), mode="drop")
        for x in wm.minimizer.limbs
    )
    return qs, sid, sid[-1] + 1


def span_query_cap(n_positions: int) -> int:
    """Default compacted-buffer size: ~0.4x window positions (see
    compact_span_queries), floor 256."""
    return max(256, (2 * n_positions) // 5)


@partial(jax.jit, static_argnums=(4, 5, 6))
def lookup_taxa_routed(
    keys: U64, taxa: jnp.ndarray, router: jnp.ndarray, q: U64, rounds: int,
    bits: int = ROUTER_BITS, key_bits: int = 62,
) -> jnp.ndarray:
    """Router-accelerated lookup_taxa."""
    n = keys.hi.shape[0]
    if n == 0:
        return jnp.zeros(q.hi.shape, jnp.int32)
    pos = lower_bound_routed(keys, router, q, rounds, bits, key_bits)
    idx = jnp.minimum(pos, n - 1)
    k_at = U64(keys.hi[idx], keys.lo[idx])
    found = (pos < n) & u64.eq(k_at, q)
    return jnp.where(found, taxa[idx], 0).astype(jnp.int32)
