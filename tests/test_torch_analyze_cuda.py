"""The auditor's launch models held to the library on a card: for every
config of each kernel's space at its canonical keys, and every version
that launches a kernel, the shared memory a block (dynamic + static) and
the blocks the library's own launch-shape query gives equal the
descriptor's `config_smem_bytes` and `launch_grid`; and no config of a
space the tuner ranks models more shared memory than a block may use.
Every test here needs a CUDA card with sm_90a and skips without one; the
file imports nothing of jax:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_analyze_cuda.py
"""

import pytest
import torch

from repro_torch.analyze import audit_registry
from repro_torch.core import hw
from repro_torch.kernels import api

pytestmark = pytest.mark.cuda


@pytest.fixture
def spec():
    """The card's spec, decided when the test runs (skips without one)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card with sm_90a")
    return hw.spec_for_device("cuda")


def _launching(k, key):
    """(version, [configs]): every config of the version's space at `key`,
    and its static config, for the versions that launch a kernel."""
    for version in k.versions:
        static = k.static_config(key, version)
        if static is None:          # a plain-only version
            continue
        yield version, [static] + k.config_space(key, version)


@pytest.mark.parametrize("name", ["gpp", "flash", "ssm", "paged_decode"])
def test_launch_shape_models_equal_the_library(spec, name):
    k = api.get_kernel(name)
    checked = 0
    for key in k.canonical_keys():
        for version, configs in _launching(k, key):
            for cfg in configs:
                cfg = k.clamp(cfg, key)
                model = (k.config_smem_bytes(cfg, key, version=version,
                                             spec=spec),
                         k.launch_grid(cfg, key, version=version, spec=spec))
                assert k.library_launch_shape(cfg, key, version) == model, \
                    (name, version, key, cfg)
                checked += 1
    assert checked > 0


@pytest.mark.parametrize("name", ["gpp", "flash", "ssm", "paged_decode"])
def test_space_fits_a_block(spec, name):
    k = api.get_kernel(name)
    for key in k.canonical_keys():
        for version in k.tunable:
            for cfg in k.config_space(key, version):
                assert k.config_smem_bytes(
                    k.clamp(cfg, key), key, version=version,
                    spec=spec) <= spec.smem_per_block, (name, version, cfg)


def test_card_audit_reads_the_library(spec):
    report = audit_registry(["ssm", "paged_decode"], skip_cache=True,
                            device="cuda")
    assert report.errors == [] and report.spec == spec.name
    for c in report.censuses:
        assert c.smem_launch_bytes == c.smem_config_bytes, c
