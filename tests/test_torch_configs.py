"""repro_torch.configs against repro.configs: every assigned config field
for field (dataclasses.asdict), the aliases, reduce_config and
param_count. Exact equality: the port keeps a copy of the dataclass."""

import dataclasses

import pytest

from repro.configs import base as jb
from repro_torch.configs import base as tb


@pytest.mark.parametrize("arch", jb.ARCH_IDS)
def test_config_equals_jax(arch):
    j, t = jb.get_config(arch), tb.get_config(arch)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert j.param_count() == t.param_count()
    assert j.active_param_count() == t.active_param_count()


def test_ids_aliases_families():
    assert tb.ARCH_IDS == jb.ARCH_IDS
    assert tb.ALIASES == jb.ALIASES
    assert tb.FAMILIES == jb.FAMILIES
    for alias, arch in tb.ALIASES.items():
        assert tb.get_config(alias) is tb.get_config(arch)
    with pytest.raises(AssertionError):
        tb.get_config("gpt-5")


@pytest.mark.parametrize("arch", jb.ARCH_IDS)
def test_reduce_config_equals_jax(arch):
    kw = dict(layers=2, d_model=64, vocab=128)
    j = jb.reduce_config(jb.get_config(arch), **kw)
    t = tb.reduce_config(tb.get_config(arch), **kw)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert j.param_count() == t.param_count()


def test_qwen2_shape():
    c = tb.get_config("qwen2-1.5b")
    assert (c.n_layers, c.d_model, c.n_heads, c.n_kv_heads, c.head_dim,
            c.d_ff, c.vocab_size) == (28, 1536, 12, 2, 128, 8960, 151936)
    assert c.qkv_bias and c.tie_embeddings and not c.use_flash_attention
    assert 1.5e9 < c.param_count() < 1.6e9
