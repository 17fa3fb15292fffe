import io
import time

import pytest

from slacken.utils import PhaseTimers, Timer, device_trace


def test_timer_and_phases(capsys):
    t = Timer("demo")
    time.sleep(0.01)
    elapsed = t.finish()
    assert elapsed >= 0.01
    err = capsys.readouterr().err
    assert "Start task: demo" in err and "Finish task: demo" in err

    with Timer("ctx", quiet=True) as t2:
        pass
    assert t2.elapsed is not None

    pt = PhaseTimers()
    with pt.phase("a"):
        time.sleep(0.005)
    with pt.phase("a"):
        pass
    with pt.phase("b"):
        pass
    assert pt.counts["a"] == 2 and pt.counts["b"] == 1
    buf = io.StringIO()
    pt.report(buf)
    assert "a:" in buf.getvalue()


def test_device_trace_noop():
    # no directory -> pure no-op (the jax.profiler path needs a real backend)
    with device_trace(None):
        x = 1
    assert x == 1


def test_prefetch_iterator_order_and_errors():
    from slacken.utils import prefetch_iterator

    assert list(prefetch_iterator(iter(range(100)), depth=3)) == list(range(100))
    assert list(prefetch_iterator(iter([]), depth=1)) == []

    def boom():
        yield 1
        raise ValueError("producer failed")

    it = prefetch_iterator(boom(), depth=2)
    assert next(it) == 1
    import pytest

    with pytest.raises(ValueError, match="producer failed"):
        list(it)


def test_parallel_gzip_writer_roundtrip(tmp_path):
    """ParallelGzipWriter output is a valid (multi-member) gzip stream,
    byte-equal to the concatenated input."""
    import gzip

    from slacken.zio import ParallelGzipWriter

    path = str(tmp_path / "out.txt.gz")
    chunks = [f"line{i}\n" * 100 for i in range(200)]
    with ParallelGzipWriter(path, level=1, block_bytes=4096) as w:
        for c in chunks:
            w.write(c)
    with gzip.open(path, "rt") as f:
        assert f.read() == "".join(chunks)


def test_open_gz_subprocess(tmp_path):
    import gzip

    from slacken.zio import open_gz_subprocess

    path = str(tmp_path / "in.gz")
    data = b"ACGT" * 100000
    with gzip.open(path, "wb") as f:
        f.write(data)
    with open_gz_subprocess(path) as f:
        assert f.read() == data
    # streamed reads too
    with open_gz_subprocess(path) as f:
        got = b""
        while True:
            b = f.read(8192)
            if not b:
                break
            got += b
    assert got == data


@pytest.mark.parametrize(
    "platform, want", [("cpu", "cpu"), ("gpu", "gpu"), ("rocm", None), ("metal", None)]
)
def test_backend_helper(monkeypatch, platform, want):
    """Every device policy reads utils.backend(): "cpu" or "gpu", and a loud
    error on any platform no default was chosen for."""
    import jax

    from slacken import utils

    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    if want is None:
        with pytest.raises(RuntimeError, match="unsupported JAX platform"):
            utils.backend()
    else:
        assert utils.backend() == want


@pytest.mark.parametrize("env_dir", [None, "custom_cache"])
def test_compile_cache_placement(monkeypatch, tmp_path, env_dir):
    """JAX_COMPILATION_CACHE_DIR wins when set; otherwise the cache sits at
    <checkout>/.jax_cache. On the GPU the helper points JAX there and
    nowhere else; on the CPU it turns the cache off."""
    import os

    import jax

    from slacken import utils

    checkout = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if env_dir is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        want = os.path.join(checkout, ".jax_cache")
    else:
        want = str(tmp_path / env_dir)
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", want)
    assert utils.compile_cache_dir() == want

    updates = []
    monkeypatch.setattr(jax.config, "update", lambda k, v: updates.append((k, v)))
    monkeypatch.setattr(utils, "backend", lambda: "gpu")
    assert utils.enable_compile_cache() == want
    assert [v for k, v in updates if k == "jax_compilation_cache_dir"] == [want]
    updates.clear()
    monkeypatch.setattr(utils, "backend", lambda: "cpu")
    assert utils.enable_compile_cache() is None
    assert updates == [("jax_enable_compilation_cache", False)]


def test_device_memory_budgets(monkeypatch):
    """Memory budgets derive from the device's reported limit; a device
    that reports none (the CPU here) is an error, not a guessed size."""
    import jax

    from slacken import utils
    from slacken.index import (
        BUILD_BYTES_PER_ENTRY,
        CPU_BUILD_BUDGET_ENTRIES,
        device_build_budget_entries,
    )
    from slacken.ops import lookup as lookup_ops

    with pytest.raises(RuntimeError, match="reports no memory limit"):
        utils.device_memory_bytes()
    with pytest.raises(RuntimeError, match="reports no memory limit"):
        lookup_ops.fits_hashed_rows(1000)
    assert device_build_budget_entries() == CPU_BUILD_BUDGET_ENTRIES

    class FakeDevice:
        device_kind = "fake"

        def memory_stats(self):
            return {"bytes_limit": 64 << 30}

    monkeypatch.setattr(jax, "devices", lambda *a: [FakeDevice()])
    monkeypatch.setattr(utils, "backend", lambda: "gpu")
    assert utils.device_memory_bytes() == 64 << 30
    assert device_build_budget_entries() == (64 << 30) // BUILD_BYTES_PER_ENTRY
    # a quarter of 64 GiB holds a ~537M-key table, not a ~700M-key one
    assert lookup_ops.fits_hashed_rows(300_000_000)
    assert not lookup_ops.fits_hashed_rows(700_000_000)
