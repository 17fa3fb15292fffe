"""Timing and profiling utilities (SURVEY §5.1: keep the reference's
named-task timer surface — Dynamic.scala:46-54 — and add jax.profiler
traces)."""

from __future__ import annotations

import contextlib
import os
import sys
import time
from typing import Dict, Optional


_CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def backend() -> str:
    """The platform every device policy in the package branches on: "cpu" or
    "gpu". Any other platform is refused: no default was chosen for it."""
    import jax

    platform = jax.default_backend()
    if platform not in ("cpu", "gpu"):
        raise RuntimeError(
            f"unsupported JAX platform {platform!r}: slacken runs on 'cpu' or 'gpu'"
        )
    return platform


def device_memory_bytes() -> int:
    """Bytes the default device lets this process allocate
    (`memory_stats()["bytes_limit"]`). Memory budgets derive from it; a
    device that reports no limit is an error, not a guess."""
    import jax

    dev = jax.devices()[0]
    limit = (dev.memory_stats() or {}).get("bytes_limit")
    if not limit:
        raise RuntimeError(
            f"device {dev.device_kind!r} reports no memory limit; cannot size "
            "device-resident tables for it"
        )
    return int(limit)


def compile_cache_dir() -> str:
    """Where the persistent compile cache lives: $JAX_COMPILATION_CACHE_DIR
    when set, else `.jax_cache` at the root of the checkout."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(
        _CHECKOUT, ".jax_cache"
    )


def enable_compile_cache() -> Optional[str]:
    """Turn JAX's persistent compile cache on for the GPU backend and return
    its directory; on the CPU backend turn it off and return None. XLA:CPU
    cache entries have been seen to load across host-feature differences
    (+prefer-no-scatter/+prefer-no-gather) and compute wrong results."""
    import jax

    if backend() == "cpu":
        jax.config.update("jax_enable_compilation_cache", False)
        return None
    path = compile_cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return path


class Timer:
    """Named task timer, printing Start/Finish lines like the reference."""

    def __init__(self, task: str, quiet: bool = False):
        self.task = task
        self.quiet = quiet
        self.start = time.time()
        self.elapsed: Optional[float] = None
        if not quiet:
            print(f"Start task: {task}", file=sys.stderr)

    def finish(self) -> float:
        self.elapsed = time.time() - self.start
        if not self.quiet:
            s = int(self.elapsed)
            print(f"Finish task: {self.task} [{s // 60} min {s % 60} s]", file=sys.stderr)
        return self.elapsed

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.finish()
        return False


class PhaseTimers:
    """Accumulating per-phase wall-clock timers."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.time()
        try:
            yield
        finally:
            dt = time.time() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self, file=None):
        file = file or sys.stderr
        for name in sorted(self.totals, key=lambda n: -self.totals[n]):
            print(
                f"  {name}: {self.totals[name]:.2f}s over {self.counts[name]} calls",
                file=file,
            )


@contextlib.contextmanager
def device_trace(trace_dir: Optional[str]):
    """Capture a jax.profiler trace (viewable in TensorBoard/Perfetto) around
    a block, when a directory is given."""
    if not trace_dir:
        yield
        return
    import jax

    jax.profiler.start_trace(trace_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
        print(f"Profiler trace written to {trace_dir}", file=sys.stderr)


def prefetch_iterator(it, depth: int = 2):
    """Run a (possibly expensive) iterator in a background thread, keeping up
    to `depth` items ready ahead of the consumer.

    Used to overlap host-side input parsing (the C++ FASTQ/FASTA packer
    releases the GIL during parse) with device compute — the analogue of
    the reference's Spark input stage running concurrently with the shuffle
    (FileInputs.scala readers are lazy Datasets pulled by executor threads).
    Exceptions raised by the producer re-raise at the consumer site."""
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
    sentinel = object()
    error = []

    def worker():
        try:
            for x in it:
                q.put(x)
        except BaseException as e:  # noqa: BLE001 - re-raised at consumer
            error.append(e)
        finally:
            q.put(sentinel)

    t = threading.Thread(target=worker, daemon=True, name="stpu-prefetch")
    t.start()
    while True:
        x = q.get()
        if x is sentinel:
            if error:
                raise error[0]
            return
        yield x
