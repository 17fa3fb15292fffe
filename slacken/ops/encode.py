"""2-bit DNA encoding (host side, numpy).

Alphabet: A=0, C=1, G=2, T=U=3 — chosen so that the complement is XOR with
all-ones, matching the reference encoding (BitRepresentation.scala:31-44).
Code 4 marks an invalid/ambiguous base (or padding); whitespace is expected to
have been stripped by the input readers before packing.

Unlike the reference's left-aligned packed NTBitArray, the device pipeline
consumes a dense int8 code per base: elementwise kernels work on dense
arrays, and packing/unpacking 2-bit fields per element would cost more than it
saves.
"""

from __future__ import annotations

import numpy as np

A, C, G, T = 0, 1, 2, 3
INVALID = 4

#: uint8 lookup table: ASCII byte -> 2-bit code (or INVALID)
CODE_LUT = np.full(256, INVALID, dtype=np.uint8)
for _ch, _code in [("A", A), ("C", C), ("G", G), ("T", T), ("U", T)]:
    CODE_LUT[ord(_ch)] = _code
    CODE_LUT[ord(_ch.lower())] = _code

_DECODE = np.frombuffer(b"ACGT", dtype=np.uint8)


def encode_seq(seq) -> np.ndarray:
    """Encode one sequence (str/bytes) to a uint8 code array."""
    if isinstance(seq, str):
        seq = seq.encode("ascii", errors="replace")
    raw = np.frombuffer(seq, dtype=np.uint8)
    return CODE_LUT[raw]


def decode_codes(codes: np.ndarray) -> str:
    """Decode a code array back to an ACGT string ('N' for invalid)."""
    codes = np.asarray(codes)
    out = np.where(codes < 4, _DECODE[np.minimum(codes, 3)], np.uint8(ord("N")))
    return out.astype(np.uint8).tobytes().decode("ascii")


def pack_batch(seqs, length: int, fill: int = INVALID):
    """Pack a list of sequences into a fixed-shape [B, length] code matrix.

    Sequences longer than `length` are truncated (callers should bucket by
    length first); shorter ones are padded with `fill` (INVALID, so no k-mer
    window ever spans padding).

    Returns (codes[B, length] uint8, lengths[B] int32).
    """
    n = len(seqs)
    out = np.full((n, length), fill, dtype=np.uint8)
    lens = np.zeros(n, dtype=np.int32)
    for i, s in enumerate(seqs):
        c = s if isinstance(s, np.ndarray) else encode_seq(s)
        m = min(len(c), length)
        out[i, :m] = c[:m]
        lens[i] = m
    return out, lens


def pack_2bit(codes: np.ndarray):
    """Host-side dense->packed transform for the device transfer path.

    codes [B, L] uint8 (0..4, L % 8 == 0) becomes (packed[B, L/4] uint8 with
    4 bases/byte little-endian, valid[B, L/8] uint8 bitmask). 3.6x fewer
    bytes over the host->device link than dense codes; the device undoes it
    with unpack_2bit_device in a few elementwise ops. (The reference ships packed
    NTBitArrays through Spark for the same reason — NTBitArray.scala:194-203;
    here density only matters on the wire, not in compute.)
    """
    c = codes & np.uint8(3)
    packed = (
        c[:, 0::4] | (c[:, 1::4] << 2) | (c[:, 2::4] << 4) | (c[:, 3::4] << 6)
    ).astype(np.uint8)
    valid = np.packbits(codes < INVALID, axis=1, bitorder="little")
    return packed, valid


def unpack_2bit_device(packed, valid):
    """Device-side inverse of pack_2bit: returns uint8 codes [B, L]."""
    import jax.numpy as jnp

    b = packed.shape[0]
    p = packed.astype(jnp.uint8)
    codes = jnp.stack(
        [(p >> (2 * j)) & jnp.uint8(3) for j in range(4)], axis=-1
    ).reshape(b, -1)
    v = valid.astype(jnp.uint8)
    ok = jnp.stack([(v >> j) & jnp.uint8(1) for j in range(8)], axis=-1).reshape(b, -1)
    return jnp.where(ok == 1, codes, jnp.uint8(INVALID))


def unpack_valid_device(valid, L: int):
    """Device-side char-validity mask [B, L] bool from pack_2bit's bitmask
    (little-endian bits), so consumers that only need validity (e.g. the
    hit-runs reduction) can reuse the already-transferred wire bitmask."""
    import jax.numpy as jnp

    b = valid.shape[0]
    v = valid.astype(jnp.uint8)
    ok = jnp.stack([(v >> j) & jnp.uint8(1) for j in range(8)], axis=-1).reshape(b, -1)
    return ok[:, :L] == 1


def revcomp_str(seq: str) -> str:
    comp = str.maketrans("ACGTUacgtu", "TGCAATGCAA")
    return seq.translate(comp)[::-1]
