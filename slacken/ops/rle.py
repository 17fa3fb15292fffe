"""Device run-length encoding of per-read window-taxon rows.

Detailed (per-read) output needs the full [B, L] window_taxa array on the
host to format hit lines (TaxonCounts.scala:31-48 semantics, implemented in
native/packer.cpp stpu_hit_lines). Consecutive windows overwhelmingly share
a taxon (a read aligning to one genome is one long run; misses merge into
taxon-0 runs; invalid windows merge into sentinel runs), so transferring a
row-capped RLE instead of the dense array cuts device->host bytes ~2.6x —
which matters where that transfer bounds detailed mode.

This per-row one-hot encoder extracts run j of each row with plain
masked reductions over [B, L, cap] (elementwise only, no scatter), at a fixed
  cap of runs per row. Rows that overflow the cap are refetched densely
  (they are rare: a clean read is 2-4 runs, each N adds ~2).

The encoding is lossless; the host reconstructs the exact dense array with
one np.repeat and hands it to the unchanged formatter.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["encode_rows", "decode_rows", "DEFAULT_RUNS_PER_ROW"]

#: runs per row budgeted in the fixed-size bundle. Real reads produce ~2-6
#: runs (hit spans merge by taxon; miss/invalid windows coalesce); 24 leaves
#: room for N-riddled reads. Overflowing rows fall back to a dense refetch.
DEFAULT_RUNS_PER_ROW = 24


@partial(jax.jit, static_argnums=(1,))
def encode_rows(wt: jnp.ndarray, cap: int) -> jnp.ndarray:
    """Per-row RLE of int32 [B, L] into ONE [B, cap + cap//2 + 1] int32
    bundle (cap must be even; L must fit uint16):

      [:, :cap]              run values (undefined past the row's run count)
      [:, cap : cap+cap//2]  run lengths, uint16 pairs packed little-endian
                             into int32 (unused slots are 0)
      [:, -1]                number of runs in the row (> cap => overflow:
                             the row's slots are truncated, refetch dense)

    Uses only cumsum + masked reductions (no scatter — see module note).
    """
    B, L = wt.shape
    prev = jnp.concatenate([wt[:, :1] - 1, wt[:, :-1]], axis=1)
    is_start = wt != prev
    is_start = is_start.at[:, 0].set(True)
    run_idx = jnp.cumsum(is_start.astype(jnp.int32), axis=1) - 1  # [B, L]
    nruns = run_idx[:, -1] + 1  # [B]
    # one-hot extraction of run j's value and length, j < cap
    onehot = run_idx[:, :, None] == jnp.arange(cap, dtype=jnp.int32)  # [B, L, cap]
    values = jnp.max(
        jnp.where(onehot, wt[:, :, None], jnp.iinfo(jnp.int32).min), axis=1
    )
    lengths = jnp.sum(onehot.astype(jnp.int32), axis=1)  # [B, cap]
    lo = lengths[:, 0::2]
    hi = lengths[:, 1::2]
    packed = (lo | (hi << 16)).astype(jnp.int32)  # uint16 pairs
    return jnp.concatenate([values, packed, nruns[:, None]], axis=1)


def decode_rows(bundle: np.ndarray, L: int, cap: int):
    """Reconstruct the dense [B, L] int32 array on the host. Returns
    (dense, overflow_rows): overflowed rows decode as garbage and must be
    refetched densely by the caller."""
    B = bundle.shape[0]
    values = bundle[:, :cap]
    packed = bundle[:, cap : cap + cap // 2].view(np.uint32)
    nruns = bundle[:, -1]
    lengths = np.empty((B, cap), np.int64)
    lengths[:, 0::2] = packed & 0xFFFF
    lengths[:, 1::2] = packed >> 16
    overflow_rows = np.flatnonzero(nruns > cap)
    if len(overflow_rows):
        # make each overflowed row's lengths self-consistent so np.repeat
        # still yields exactly B*L elements (content is discarded anyway)
        lengths = lengths.copy()
        lengths[overflow_rows] = 0
        lengths[overflow_rows, 0] = L
    dense = np.repeat(values.ravel(), lengths.ravel()).reshape(B, L)
    return dense, overflow_rows
