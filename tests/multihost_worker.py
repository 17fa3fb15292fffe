"""Worker process for the 2-process jax.distributed multi-host test.

Each process: joins the coordination service, forms the global mesh over all
processes' (virtual CPU) devices, loads only its own key-range shards of the
index (multihost.ring_index_for_host), classifies its own slice of the reads
with the ring kernel (queries cross the process boundary via ppermute), and
writes its local results + the psum'd report counts to a JSON file. The
parent test compares against the single-process kernel. This is the DCN
execution model of SURVEY §5.8 (the reference's Spark cluster analogue),
actually running with process_count > 1.

Usage: python multihost_worker.py <coordinator> <n_procs> <pid> <workdir>
"""

import json
import os
import sys


def main():
    coordinator, n_procs, pid, workdir = sys.argv[1:5]
    n_procs, pid = int(n_procs), int(pid)

    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=2"
    ).strip()
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(
        coordinator_address=coordinator, num_processes=n_procs, process_id=pid
    )
    assert jax.process_count() == n_procs

    import numpy as np

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from slacken.parallel import mesh as pmesh
    from slacken.parallel import multihost

    ctx = multihost.HostContext(
        jax.process_index(), jax.process_count(),
        jax.local_device_count(), jax.device_count(),
    )
    assert ctx.is_distributed
    mesh = multihost.global_mesh()

    kh, kl, tx, rt, rounds, bits, params = multihost.ring_index_for_host(
        os.path.join(workdir, "idx_sharded"), ctx, mesh
    )

    # this process's slice of the reads
    codes_all = np.load(os.path.join(workdir, "codes.npy"))
    b = codes_all.shape[0]
    lo = b * pid // n_procs
    hi = b * (pid + 1) // n_procs
    codes = multihost.global_rows(codes_all[lo:hi], mesh)

    from slacken.taxonomy import Taxonomy

    tax = Taxonomy.load(os.path.join(workdir, "idx_sharded", "taxonomy"))
    table = tax.rpath_table()

    ring = pmesh.classify_ring_fn(mesh, params.minimizer_params, 16, rounds, bits)
    wt, nd, ch, res, hp, counts = ring(codes, kh, kl, tx, rt, table)

    local_taxon = multihost.collect_local(res.max_taxon)
    local_nd = multihost.collect_local(nd)
    counts_h = np.asarray(counts)  # replicated across the mesh

    out = {
        "pid": pid,
        "rows": [int(lo), int(hi)],
        "max_taxon": local_taxon.tolist(),
        "num_distinct": local_nd.tolist(),
        "counts": counts_h.tolist(),
    }
    with open(os.path.join(workdir, f"result_{pid}.json"), "w") as f:
        json.dump(out, f)
    jax.distributed.shutdown()


if __name__ == "__main__":
    main()
