#!/usr/bin/env python
"""Index integrity check: validates a saved index directory.

    python scripts/check_index.py <index-dir>

Checks: params parse, key ordering/uniqueness/width, taxa defined in the
bundled taxonomy, sidecar consistency (when present), and a lookup self-test.
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    from slacken.index import KeyValueIndex
    from slacken.ops import lookup as lookup_ops

    loc = sys.argv[1]
    idx = KeyValueIndex.load(loc)
    p = idx.params
    n = len(idx.keys)
    print(f"params: k={p.k} m={p.m} s={p.spaces} canonical={p.canonical} records={n}")
    errors = 0

    keys = np.asarray(idx.keys)
    if n and not np.all(np.diff(keys) > 0):
        print("ERROR: keys not strictly ascending")
        errors += 1
    if n and int(keys.max()).bit_length() > 2 * p.m:
        print(f"ERROR: key wider than 2m bits ({int(keys.max()).bit_length()})")
        errors += 1
    from slacken.ops.minimizers import space_mask_int

    mask = np.uint64(space_mask_int(p.m, p.spaces))
    if n and np.any(keys & ~mask):
        print("ERROR: keys carry bits outside the spaced-seed mask")
        errors += 1

    taxa = np.asarray(idx.taxa)
    bad = [t for t in np.unique(taxa).tolist() if not idx.taxonomy.is_defined(int(t))]
    if bad:
        print(f"ERROR: {len(bad)} stored taxa undefined in taxonomy, e.g. {bad[:5]}")
        errors += 1

    if idx.record_keys is not None:
        rk = np.asarray(idx.record_keys)
        missing = np.setdiff1d(keys, np.unique(rk))
        if len(missing):
            print(f"ERROR: {len(missing)} index keys missing from the records sidecar")
            errors += 1
        else:
            print(f"sidecar: {len(rk)} (key, taxon) records consistent")

    if n:
        rng = np.random.default_rng(0)
        pick = rng.integers(0, n, min(10000, n))
        qk = lookup_ops.keys_from_numpy(keys[pick])
        got = np.asarray(idx.lookup(qk.hi, qk.lo))
        if not np.array_equal(got, taxa[pick]):
            print("ERROR: lookup self-test mismatch")
            errors += 1
        else:
            print(f"lookup self-test OK ({len(pick)} probes)")

    print("OK" if errors == 0 else f"{errors} ERRORS")
    return 1 if errors else 0


if __name__ == "__main__":
    sys.exit(main())
