#!/usr/bin/env python
"""Micro-benchmark for the native radix sort vs numpy (parity with the
reference's SortTest.java harness for fastutil radixSort, kmers/SortTest.java).

    PYTHONPATH=. python scripts/sort_bench.py [n_millions]
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np

from slacken import native


def main():
    n = int(float(sys.argv[1]) * 1e6) if len(sys.argv) > 1 else 30_000_000
    rng = np.random.default_rng(0)
    k = rng.integers(0, 1 << 62, n, dtype=np.uint64)
    v = rng.integers(1, 2_000_000, n).astype(np.int32)
    print(f"n = {n/1e6:.0f}M, native = {native.available()}")

    t0 = time.time()
    sk, sv = native.radix_sort_kv(k, v, with_vals=True)
    t1 = time.time()
    print(f"radix_sort_kv (key,val):  {t1-t0:6.2f}s  {n/(t1-t0)/1e6:6.1f} M/s")

    t0 = time.time()
    sk2, sv2 = native.radix_sort_kv(k, v)
    t1 = time.time()
    print(f"radix_sort_kv (key only): {t1-t0:6.2f}s  {n/(t1-t0)/1e6:6.1f} M/s")

    t0 = time.time()
    o = np.lexsort((v, k))
    t1 = time.time()
    print(f"np.lexsort:               {t1-t0:6.2f}s  {n/(t1-t0)/1e6:6.1f} M/s")
    assert np.array_equal(sk, k[o]) and np.array_equal(sv, v[o])
    print("parity with numpy: OK")


if __name__ == "__main__":
    main()
