"""chip_smoke.py and bench.py: no CPU fallback, and the smoke's phases at a
tiny size on the CPU backend (on the GPU they run at full size)."""

import os
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _smoke():
    sys.path.insert(0, ROOT)
    import chip_smoke

    return chip_smoke


@pytest.mark.parametrize(
    "script, alone", [("chip_smoke.py", False), ("chip_smoke.py", True), ("bench.py", False)]
)
def test_scripts_exit_nonzero_without_gpu(tmp_path, script, alone):
    """Without a GPU (and, for the smoke, without the rest of the repo) the
    scripts exit non-zero and print no result line."""
    path, cwd = os.path.join(ROOT, script), ROOT
    if alone:
        path, cwd = shutil.copy(path, tmp_path), str(tmp_path)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, path], cwd=cwd, env=env, capture_output=True, text=True,
        timeout=300,
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout and '"metric"' not in proc.stdout


def test_smoke_oracle_phase_on_cpu():
    records, lines = _smoke().oracle_phase(n_genomes=3, genome_len=3000, n_reads=100)
    assert records > 1000
    assert lines == 200  # 100 reads x 2 thresholds


@pytest.mark.parametrize("devices", [1, 4])
def test_smoke_cli_phases_on_cpu(tmp_path, capsys, devices):
    """Main, cross-check and probe phases (devices=1) or the mesh comparison
    (devices=4, on virtual CPU devices) at a tiny size."""
    smoke = _smoke()
    if devices == 1:
        smoke.main_phase(str(tmp_path), 2000, n_reads=300, n_background=100)
    else:
        smoke.mesh_phase(str(tmp_path), 2000, devices, n_reads=300, n_background=100)
    out = capsys.readouterr().out
    if devices == 1:
        assert "byte-identical on CPU and GPU" in out
        assert all(f"[probe] {p}:" in out for p in ("routed", "tiled", "hashed1"))
    else:
        assert "replicated and ring outputs byte-identical" in out
