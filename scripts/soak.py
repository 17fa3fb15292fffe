#!/usr/bin/env python
"""Full-system soak: 500 Mbp library build + 2M mutated reads classified in
detailed multi-sample mode at 2 thresholds, on the CPU backend (run time
~11 min on 4 CPU cores).

    PYTHONPATH=. python scripts/soak.py
"""
import os, sys
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import time, numpy as np, resource
import jax
jax.config.update('jax_platforms','cpu')
def log(m): print(f"[{time.time()-T0:7.1f}s] {m}", flush=True)
T0=time.time()
from slacken.index import IndexParams, KeyValueIndex
from slacken.taxonomy import Taxonomy
from slacken.classify import Classifier, ClassifyParams
from slacken import native

rng = np.random.default_rng(99)
lut = np.frombuffer(b'ACGT', dtype=np.uint8)
NG = 50
nodes = [(1,1,'root')] + [(10+i, 1, 'genus') for i in range(10)] + [(100+i, 10 + i % 10, 'species') for i in range(NG)]
tax = Taxonomy.from_nodes_and_names(nodes, [(t, f'n{t}') for t,_,_ in nodes])
def gen(n): return lut[rng.integers(0,4,n)].tobytes().decode()
genomes = [(100+i, gen(10_000_000)) for i in range(NG)]  # 500 Mbp
log(f"library generated: {sum(len(g) for _, g in genomes)/1e6:.0f} Mbp")
idx = KeyValueIndex.build(genomes, IndexParams(), tax, batch_rows=64, row_len=1<<16)
log(f"index built: {len(idx.keys)/1e6:.1f}M records, RSS {resource.getrusage(resource.RUSAGE_SELF).ru_maxrss/1e6:.1f} GB")
idx.save('/tmp/soak_idx')
log("index saved")

# 2M mutated reads across 4 "samples"
from slacken.ops import encode as enc
packs = []
per = 100000
for chunk in range(20):
    src_t, g = genomes[chunk % NG]
    codes_full = enc.encode_seq(g)
    starts = rng.integers(0, len(g)-150, per)
    rows = codes_full[starts[:, None] + np.arange(150)[None, :]].astype(np.uint8)
    mut = rng.random(rows.shape) < 0.02
    rows[mut] = rng.integers(0, 4, mut.sum())
    rows = np.pad(rows, ((0,0),(0,106)), constant_values=4)
    titles = [f"s{chunk % 4}|r{chunk}_{j}" for j in range(per)]
    packs.append(native.PackedReads(rows, np.full(per, 150, np.int32), titles))
n = sum(len(p) for p in packs)
log(f"{n} reads prepared")

cls = Classifier(idx)
cpar = ClassifyParams(thresholds=[0.0, 0.1], per_read_output=True, sample_regex=r"(s\d+)\|.*")
cls.classify_packed(packs[:1], cpar)
t0=time.time()
out = cls.classify_and_write_packed(iter(packs), '/tmp/soak_out', cpar)
dt=time.time()-t0
log(f"classified+wrote {n} reads x 2 thresholds (detailed, multi-sample): {dt:.1f}s = {2*n/dt:.0f} read-evals/s")
log(f"samples: {out}")
log(f"RSS {resource.getrusage(resource.RUSAGE_SELF).ru_maxrss/1e6:.1f} GB")
import gzip, glob
for th in ('_c0.0','_c0.1'):
    files = glob.glob(f'/tmp/soak_out{th}/sample=*/part*.gz')
    total = 0; classified = 0
    for fp in files:
        with gzip.open(fp,'rt') as f:
            for line in f:
                total += 1
                classified += line[0] == 'C'
    log(f"{th}: {total} lines, {classified} classified ({100*classified/max(total,1):.1f}%)")
