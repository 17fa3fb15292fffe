#!/usr/bin/env python
"""Randomized end-to-end oracle fuzz for the classifier.

Each iteration draws a random taxonomy, genome library, index parameters
(k, m — narrow AND wide — spaced seed), probe, confidence thresholds and
min-hit-groups gate, then classifies a batch of adversarial reads
(mutated / N-riddled / random / short / all-N / paired / boundary-length)
and compares EVERY read's (classified, taxon, hit_details, length_string)
bit-for-bit against the naive string-level oracle
(tests/oracle.py + tests/test_classify.oracle_classify — the
LowestCommonAncestorProps strategy, cf. reference src/test).

Usage:
    python scripts/oracle_fuzz.py [--minutes 30] [--seed 0]

Exits non-zero on the first mismatch with a full repro dump (seed,
params, read). Progress lines go to stderr; a summary JSON line to
stdout. CPU-only (forces jax_platforms=cpu).
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tests"))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

from test_classify import oracle_classify  # noqa: E402
from test_index import make_genomes, oracle_index, random_genome  # noqa: E402
from test_taxonomy import random_taxonomy  # noqa: E402

from slacken.classify import Classifier, ClassifyParams, Fragment  # noqa: E402
from slacken.index import IndexParams, KeyValueIndex  # noqa: E402

KM_CHOICES = [  # (k, m): narrow, boundary (m=31/32), and wide
    (21, 15), (31, 25), (35, 31), (35, 27), (45, 31), (45, 32),
    (45, 33), (51, 45), (63, 55),
]
PROBES = ["routed", "tiled", "hashed", "hashed1"]


def fuzz_iteration(it: int, seed: int) -> int:
    rng = np.random.default_rng(seed)
    t = random_taxonomy(rng, int(rng.integers(12, 60)))
    parents = {i: int(p) for i, p in enumerate(t.parents)}
    n_genomes = int(rng.integers(2, 8))
    glen = int(rng.integers(300, 1500))
    genomes = make_genomes(rng, t, n_genomes=n_genomes, length=glen)
    k, m = KM_CHOICES[int(rng.integers(len(KM_CHOICES)))]
    s = int(rng.choice([0, 3, 7]))
    probes = PROBES if m <= 31 else ["routed", "tiled", "hashed1"]
    probe = probes[int(rng.integers(len(probes)))]
    mhg = int(rng.choice([1, 2, 3]))
    confs = sorted(
        {float(c) for c in rng.choice([0.0, 0.05, 0.15, 0.3, 0.6, 0.9], 3)}
    )
    params = IndexParams(k=k, m=m, spaces=s)
    idx = KeyValueIndex.build(genomes, params, t)
    idx_map = oracle_index(genomes, k, m, s, parents)

    frags = []
    n_reads = int(rng.integers(10, 36))
    for i in range(n_reads):
        _, g = genomes[int(rng.integers(len(genomes)))]
        length = int(rng.integers(max(4, k - 6), min(len(g), 240)))
        start = int(rng.integers(0, max(1, len(g) - length)))
        seq = g[start : start + length]
        r = rng.random()
        if r < 0.15:
            seq = random_genome(rng, length)  # unclassifiable
        elif r < 0.35:
            chars = list(seq)
            for p in rng.integers(0, len(seq), int(rng.integers(1, 12))):
                chars[int(p)] = "N"
            seq = "".join(chars)
        elif r < 0.45:
            chars = list(seq)  # point mutations
            lut = "ACGT"
            for p in rng.integers(0, len(seq), int(rng.integers(1, 6))):
                chars[int(p)] = lut[int(rng.integers(4))]
            seq = "".join(chars)
        if rng.random() < 0.3:
            _, g2 = genomes[int(rng.integers(len(genomes)))]
            s2 = int(rng.integers(0, max(1, len(g2) - 90)))
            frags.append(Fragment(f"r{i}", seq, g2[s2 : s2 + 90]))
        else:
            frags.append(Fragment(f"r{i}", seq))
    frags.append(Fragment("short", "ACGTACG"))
    frags.append(Fragment("allN", "N" * int(rng.integers(10, 90))))
    frags.append(Fragment("kminus1", genomes[0][1][: k - 1]))
    frags.append(Fragment("exactk", genomes[0][1][:k]))

    cpar = ClassifyParams(thresholds=confs, min_hit_groups=mhg)
    res = Classifier(idx, probe=probe).classify(frags, cpar)

    if os.environ.get("STPU_FUZZ_PACKED") == "1":
        # the packed fast path (C++ parser layout) must equal the
        # Fragment path read-for-read under the same random params
        from slacken import native
        from slacken.ops import encode

        def pack_one(seqs):
            width = max(len(x) for x in seqs)
            codes = np.stack(
                [
                    np.pad(
                        encode.encode_seq(x), (0, width - len(x)),
                        constant_values=4,
                    )
                    for x in seqs
                ]
            )
            return codes, np.array([len(x) for x in seqs], np.int32)

        singles = [f for f in frags if f.seq2 is None]
        pairs_f = [f for f in frags if f.seq2 is not None]
        packs = []
        if singles:
            c, l = pack_one([f.seq for f in singles])
            packs.append(
                native.PackedReads(c, l, [f.title for f in singles])
            )
        if pairs_f:
            c1, l1 = pack_one([f.seq for f in pairs_f])
            c2, l2 = pack_one([f.seq2 for f in pairs_f])
            packs.append(
                native.pack_pairs(
                    native.PackedReads(c1, l1, [f.title for f in pairs_f]),
                    native.PackedReads(c2, l2, [f.title for f in pairs_f]),
                )
            )
        pres = Classifier(idx, probe=probe).classify_packed(
            iter(packs), cpar
        )
        for conf in confs:
            by_title = {
                r.title: (r.classified, r.taxon, r.hit_details, r.length_string)
                for r in pres[conf]
            }
            for r in res[conf]:
                got = by_title[r.title]
                want = (r.classified, r.taxon, r.hit_details, r.length_string)
                if got != want:
                    print(
                        json.dumps(
                            {
                                "PACKED_MISMATCH": True, "iteration": it,
                                "seed": seed, "k": k, "m": m, "s": s,
                                "probe": probe, "conf": conf,
                                "title": r.title, "got": got, "want": want,
                            }
                        )
                    )
                    sys.exit(1)

    checked = 0
    for conf in confs:
        for f, r in zip(frags, res[conf]):
            want = oracle_classify(
                f.seq, f.seq2, idx_map, parents, k, m, s, conf, mhg
            )
            got = (r.classified, r.taxon, r.hit_details, r.length_string)
            if got != want:
                print(
                    json.dumps(
                        {
                            "MISMATCH": True, "iteration": it, "seed": seed,
                            "k": k, "m": m, "s": s, "probe": probe,
                            "min_hit_groups": mhg, "conf": conf,
                            "title": f.title, "seq": f.seq, "seq2": f.seq2,
                            "got": got, "want": want,
                        }
                    )
                )
                sys.exit(1)
            checked += 1
    return checked


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--minutes", type=float, default=30.0)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    t0 = time.time()
    it = 0
    total = 0
    while time.time() - t0 < args.minutes * 60:
        seed = args.seed + it
        total += fuzz_iteration(it, seed)
        it += 1
        # every iteration compiles FRESH jit shapes (random k/m/lengths);
        # without this the in-process XLA:CPU executable cache grows
        # unboundedly (~1 GB/iteration) and long runs die of host OOM
        jax.clear_caches()
        if it % 5 == 0:
            print(
                f"[fuzz {time.strftime('%T')}] {it} iterations, "
                f"{total} read-checks, all exact",
                file=sys.stderr, flush=True,
            )
    print(
        json.dumps(
            {
                "iterations": it, "read_threshold_checks": total,
                "mismatches": 0, "minutes": round((time.time() - t0) / 60, 1),
                "base_seed": args.seed,
            }
        )
    )


if __name__ == "__main__":
    main()
