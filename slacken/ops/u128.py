"""Unsigned 128-bit integers as pairs of U64 (i.e. four uint32 limbs).

Wide minimizers (31 < m <= 63) occupy up to 126 bits; the reference stores
them as ceil(m/32) left-aligned longs (KmerKeyedIndex.scala:33-54,
NTBitArray.scala:194-203). Right-aligned u128 values have identical unsigned
order, and every op needed by the scan pipeline composes from the u64 limb
ops, so the same code needs no 64-bit integer support.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

from . import u64
from .u64 import U64


class U128(NamedTuple):
    """A u128 value (or array) as two U64 halves (four uint32 limbs)."""

    hi: U64  # bits 64..127
    lo: U64  # bits 0..63

    @property
    def shape(self):
        return self.hi.hi.shape

    @property
    def limbs(self):
        """(l3, l2, l1, l0) uint32 arrays, most significant first."""
        return self.hi.hi, self.hi.lo, self.lo.hi, self.lo.lo


def from_limbs(l3, l2, l1, l0) -> U128:
    return U128(U64(l3, l2), U64(l1, l0))


def from_int(value: int, shape=()) -> U128:
    value &= (1 << 128) - 1
    return U128(
        u64.from_int(value >> 64, shape), u64.from_int(value & ((1 << 64) - 1), shape)
    )


def zeros_like(x: U128) -> U128:
    z = jnp.zeros_like(x.hi.hi)
    return U128(U64(z, z), U64(z, z))


def to_ints(x: U128) -> np.ndarray:
    """Materialise to a numpy object array of Python ints (host only)."""
    hi = u64.to_ints(x.hi).astype(object)
    lo = u64.to_ints(x.lo).astype(object)
    return (hi << 64) | lo


def to_u64_pair(x: U128):
    """(hi64, lo64) uint64 numpy arrays (host only)."""
    return u64.to_ints(x.hi), u64.to_ints(x.lo)


def shl(x: U128, n: int) -> U128:
    """Logical left shift by a static amount 0 <= n <= 128."""
    if n == 0:
        return x
    if n >= 128:
        return zeros_like(x)
    if n >= 64:
        return U128(u64.shl(x.lo, n - 64), u64.from_int(0, x.shape))
    # n in (0, 64): hi = hi << n | lo >> (64 - n)
    return U128(u64.bor(u64.shl(x.hi, n), u64.shr(x.lo, 64 - n)), u64.shl(x.lo, n))


def shr(x: U128, n: int) -> U128:
    """Logical right shift by a static amount 0 <= n <= 128."""
    if n == 0:
        return x
    if n >= 128:
        return zeros_like(x)
    if n >= 64:
        return U128(u64.from_int(0, x.shape), u64.shr(x.hi, n - 64))
    return U128(u64.shr(x.hi, n), u64.bor(u64.shr(x.lo, n), u64.shl(x.hi, 64 - n)))


def bor(a: U128, b: U128) -> U128:
    return U128(u64.bor(a.hi, b.hi), u64.bor(a.lo, b.lo))


def band(a: U128, b: U128) -> U128:
    return U128(u64.band(a.hi, b.hi), u64.band(a.lo, b.lo))


def bxor(a: U128, b: U128) -> U128:
    return U128(u64.bxor(a.hi, b.hi), u64.bxor(a.lo, b.lo))


def eq(a: U128, b: U128) -> jnp.ndarray:
    return u64.eq(a.hi, b.hi) & u64.eq(a.lo, b.lo)


def ne(a: U128, b: U128) -> jnp.ndarray:
    return u64.ne(a.hi, b.hi) | u64.ne(a.lo, b.lo)


def ltu(a: U128, b: U128) -> jnp.ndarray:
    return u64.ltu(a.hi, b.hi) | (u64.eq(a.hi, b.hi) & u64.ltu(a.lo, b.lo))


def leu(a: U128, b: U128) -> jnp.ndarray:
    return u64.ltu(a.hi, b.hi) | (u64.eq(a.hi, b.hi) & u64.leu(a.lo, b.lo))


def select(mask: jnp.ndarray, a: U128, b: U128) -> U128:
    return U128(u64.select(mask, a.hi, b.hi), u64.select(mask, a.lo, b.lo))


def minu(a: U128, b: U128) -> U128:
    return select(leu(a, b), a, b)


def wide_toggle_mask(m: int, toggle: int) -> int:
    """The XOR toggle over 2m bits with the reference's multi-long
    replication: every full 32-nt long carries the full 64-bit mask, and a
    trailing partial long of r nts carries the mask's LOW 2r bits
    (left-aligned in the reference; MinimizerPriorities.scala:146-160).
    For m <= 32 this is just the low 2m bits."""
    if m <= 32:
        return toggle & ((1 << (2 * m)) - 1)
    r = m % 32
    val = 0
    for _ in range(m // 32):
        val = (val << 64) | (toggle & ((1 << 64) - 1))
    if r:
        val = (val << (2 * r)) | (toggle & ((1 << (2 * r)) - 1))
    return val
