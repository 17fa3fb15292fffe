"""Unsigned 64-bit integer arithmetic as pairs of uint32 arrays.

JAX runs with 64-bit types disabled by default. We make the representation
explicit so the same code runs identically on every backend without x64
mode: every "u64" is a pair ``(hi, lo)`` of ``uint32`` arrays of identical
shape.

This is the foundation for minimizer math: a 2-bit-packed m-mer of width
m <= 31 occupies 2m <= 62 bits (right-aligned), so one u64 pair holds any
minimizer or priority value. (The reference stores minimizers left-aligned
in 1..N longs — NTBitArray.scala:194-203 — but for m <= 31 a single
right-aligned word is equivalent and the unsigned order is identical.)
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

__all__ = [
    "U64",
    "make",
    "from_int",
    "full",
    "to_ints",
    "shl",
    "shr",
    "bor",
    "band",
    "bxor",
    "bnot",
    "eq",
    "ne",
    "ltu",
    "leu",
    "minu",
    "maxu",
    "select",
    "where",
]

_U32 = jnp.uint32
_MASK32 = 0xFFFFFFFF


class U64(NamedTuple):
    """A u64 value (or array of values) as two uint32 limbs."""

    hi: jnp.ndarray
    lo: jnp.ndarray

    @property
    def shape(self):
        return self.hi.shape


def make(hi, lo) -> U64:
    return U64(jnp.asarray(hi, _U32), jnp.asarray(lo, _U32))


def from_int(value: int, shape=()) -> U64:
    """Broadcast a Python int (0 <= value < 2**64) to a U64 of the given shape."""
    value &= (1 << 64) - 1
    hi = np.uint32((value >> 32) & _MASK32)
    lo = np.uint32(value & _MASK32)
    return U64(jnp.full(shape, hi, _U32), jnp.full(shape, lo, _U32))


def full(shape, value: int) -> U64:
    return from_int(value, shape)


def to_ints(x: U64) -> np.ndarray:
    """Materialise to a numpy object/uint64 array of Python ints (host only)."""
    hi = np.asarray(x.hi, dtype=np.uint64)
    lo = np.asarray(x.lo, dtype=np.uint64)
    return (hi << np.uint64(32)) | lo


def shl(x: U64, n: int) -> U64:
    """Logical left shift by a static amount 0 <= n < 64."""
    if n == 0:
        return x
    if n >= 64:
        z = jnp.zeros_like(x.hi)
        return U64(z, z)
    n = int(n)
    if n < 32:
        hi = (x.hi << n) | (x.lo >> (32 - n))
        lo = x.lo << n
    else:
        hi = x.lo << (n - 32) if n > 32 else x.lo
        lo = jnp.zeros_like(x.lo)
    return U64(hi, lo)


def shr(x: U64, n: int) -> U64:
    """Logical right shift by a static amount 0 <= n < 64."""
    if n == 0:
        return x
    if n >= 64:
        z = jnp.zeros_like(x.hi)
        return U64(z, z)
    n = int(n)
    if n < 32:
        lo = (x.lo >> n) | (x.hi << (32 - n))
        hi = x.hi >> n
    else:
        lo = x.hi >> (n - 32) if n > 32 else x.hi
        hi = jnp.zeros_like(x.hi)
    return U64(hi, lo)


def bor(a: U64, b: U64) -> U64:
    return U64(a.hi | b.hi, a.lo | b.lo)


def band(a: U64, b: U64) -> U64:
    return U64(a.hi & b.hi, a.lo & b.lo)


def bxor(a: U64, b: U64) -> U64:
    return U64(a.hi ^ b.hi, a.lo ^ b.lo)


def bnot(a: U64) -> U64:
    return U64(~a.hi, ~a.lo)


def eq(a: U64, b: U64) -> jnp.ndarray:
    return (a.hi == b.hi) & (a.lo == b.lo)


def ne(a: U64, b: U64) -> jnp.ndarray:
    return (a.hi != b.hi) | (a.lo != b.lo)


def ltu(a: U64, b: U64) -> jnp.ndarray:
    """Unsigned a < b."""
    return (a.hi < b.hi) | ((a.hi == b.hi) & (a.lo < b.lo))


def leu(a: U64, b: U64) -> jnp.ndarray:
    return (a.hi < b.hi) | ((a.hi == b.hi) & (a.lo <= b.lo))


def select(mask: jnp.ndarray, a: U64, b: U64) -> U64:
    """Elementwise: mask ? a : b."""
    return U64(jnp.where(mask, a.hi, b.hi), jnp.where(mask, a.lo, b.lo))


# Alias matching jnp.where argument order
where = select


def minu(a: U64, b: U64) -> U64:
    """Unsigned elementwise minimum. Keeps ``a`` on ties (leftmost-stable)."""
    return select(leu(a, b), a, b)


def maxu(a: U64, b: U64) -> U64:
    return select(leu(a, b), b, a)
