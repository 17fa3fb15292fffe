"""Checks that need a GPU. They skip elsewhere; on a GPU host run

    JAX_PLATFORMS=cuda python -m pytest -o addopts= -m gpu tests/test_gpu.py

chip_smoke.py runs the same checks at full size."""

import os
import sys

import pytest

pytestmark = pytest.mark.gpu


@pytest.fixture
def gpu():
    import jax

    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU")


def test_gpu_platform_policies(gpu, rng):
    """On the GPU: the backend helper, a reported memory limit, the compile
    cache, and the classifier's GPU defaults (hashed1, dense probing,
    wire-packed transfer)."""
    from slacken import utils
    from slacken.classify import Classifier
    from test_classify import setup

    assert utils.backend() == "gpu"
    assert utils.device_memory_bytes() > 0
    assert utils.enable_compile_cache() == utils.compile_cache_dir()
    _, _, _, idx, _ = setup(rng, n_genomes=2, glen=300)
    cls = Classifier(idx)
    assert cls._probe_static[0] == "hashed1" and cls._probe_static[-1] is True
    assert cls._packed_transfer


def test_gpu_oracle_phase(gpu):
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke

    records, lines = chip_smoke.oracle_phase(n_genomes=4, genome_len=20_000, n_reads=500)
    assert records > 10_000 and lines == 1000
