"""Speculative decoding's parts on a card: Threefry on CUDA tensors gives
the CPU's bits (`rng.random_bits`, `fold_in`, `uniform`, `gumbel` and
`categorical` at qwen2's vocabulary of 151,936); `Model.decode_verify` on
a reduced qwen2 within SERVE_LOGIT_RTOL of Q sequential `decode_step`
calls on a copy of the cache; a verify line past the cache end dropped
with every live line unchanged; and `ServeEngine.evict_inflight` on a
paged spec engine releasing an evicted request's pages once. Every test
here needs a CUDA card and skips without one; the file imports nothing
of jax:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_spec_cuda.py

SERVE_LOGIT_RTOL = 6e-2 of max |logit| is chip_smoke.py's serving
tolerance: on the card a verify of M = B * Q rows and a decode of M = B
rows may take different GEMM algorithms, and bf16 activations carry the
difference through the layers."""

import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_config, reduce_config
from repro_torch.models.registry import build_model
from repro_torch.serve import rng
from repro_torch.serve.engine import Request, ServeEngine

pytestmark = pytest.mark.cuda

SERVE_LOGIT_RTOL = 6e-2
VOCAB = 151936


@pytest.fixture
def cuda():
    """A CUDA device, decided when the test runs (skips without a card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _keys(dev, n=64):
    """n (seed, rid, n_gen) keys on dev and on the CPU."""
    r = np.random.default_rng(0)
    trip = [(int(r.integers(-2 ** 31, 2 ** 31)), int(r.integers(0, 2 ** 32)),
             int(r.integers(0, 64))) for _ in range(n)]

    def build(device):
        return torch.stack([rng.fold_in(rng.fold_in(
            rng.prng_key(s, device=device), rid), g) for s, rid, g in trip])
    return build(dev), build("cpu")


def test_threefry_on_the_card_equals_the_cpu(cuda):
    kd, kc = _keys(cuda)
    assert torch.equal(kd.cpu(), kc)
    assert torch.equal(rng.random_bits(kd, (VOCAB,)).cpu(),
                       rng.random_bits(kc, (VOCAB,)))
    for fn in (rng.uniform, rng.gumbel):
        a, b = fn(kd, (VOCAB,)).cpu(), fn(kc, (VOCAB,))
        assert torch.equal(a.view(torch.int32), b.view(torch.int32)), fn
    logits = torch.randn((64, VOCAB), generator=torch.Generator().manual_seed(
        1)) * 3.0
    got = rng.categorical(kd, logits.to(cuda)).cpu()
    assert torch.equal(got, rng.categorical(kc, logits))


def _reduced(dev, seed=0):
    cfg = reduce_config(get_config("qwen2-1.5b"), layers=2, d_model=64,
                        vocab=128)
    model = build_model(cfg)
    return cfg, model, model.init_params(seed, device=dev)


def _slot_cache(model, params, dev, lens, cache_len):
    cache = model.init_cache(len(lens), cache_len, device=dev)
    cache["pos"] = torch.zeros((len(lens),), dtype=torch.int32, device=dev)
    g = torch.Generator().manual_seed(3)
    for slot, n in enumerate(lens):
        toks = torch.randint(0, 128, (1, n), generator=g).to(dev)
        _, cache = model.prefill_into_slot(params, cache, slot,
                                           {"tokens": toks}, n)
    return cache


def test_decode_verify_equals_sequential_decode_steps(cuda):
    _, model, params = _reduced(cuda)
    cache = _slot_cache(model, params, cuda, (9, 30, 17, 4), 64)
    toks = torch.randint(0, 128, (4, 4), generator=torch.Generator()
                         .manual_seed(5)).to(cuda)
    seq = {k: v.clone() for k, v in cache.items()}
    vl, vc = model.decode_verify(params, cache, toks)
    for j in range(4):
        sl, seq = model.decode_step(params, seq, toks[:, j:j + 1])
        err = float((vl[:, j] - sl[:, 0]).abs().max())
        assert err <= SERVE_LOGIT_RTOL * float(sl.abs().max()), (j, err)
    assert torch.equal(vc["pos"], seq["pos"])


def test_verify_lines_past_the_cache_end_are_dropped(cuda):
    _, model, params = _reduced(cuda)
    lc = 32
    cache = _slot_cache(model, params, cuda, (lc - 1, 5), lc)
    before = {k: cache[k].clone() for k in ("k", "v")}
    toks = torch.randint(0, 128, (2, 4), generator=torch.Generator()
                         .manual_seed(6)).to(cuda)
    logits, new = model.decode_verify(params, cache, toks)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(logits).all())
    for key in ("k", "v"):
        # row 0: lines 0..L-2 as they were, L-1 written, three dropped;
        # row 1: lines 0..4 and 9.. as they were
        assert torch.equal(new[key][:, 0, :lc - 1], before[key][:, 0, :lc - 1])
        assert not torch.equal(new[key][:, 0, lc - 1], before[key][:, 0, lc - 1])
        assert torch.equal(new[key][:, 1, :5], before[key][:, 1, :5])
        assert torch.equal(new[key][:, 1, 9:], before[key][:, 1, 9:])
    assert new["pos"].tolist() == [lc + 3, 9]


def test_evict_inflight_releases_pages_once_on_the_card(cuda):
    cfg, _, params = _reduced(cuda)
    dcfg = reduce_config(get_config("qwen2-1.5b"), layers=1, d_model=64,
                         vocab=128)
    dparams = build_model(dcfg).init_params(1, device=cuda)
    eng = ServeEngine(cfg, params, max_batch=2, cache_len=64, device=cuda,
                      kv_page_size=8, draft_cfg=dcfg, draft_params=dparams,
                      spec_k=2)
    eng.reset()
    for rid in range(3):
        eng.submit(Request(rid=rid, prompt=np.arange(20 + rid) % 128,
                           max_new_tokens=8))
    eng.step()
    kv = eng.kv
    released = []
    real = kv.release
    kv.release = lambda rid: (released.append(rid), real(rid))[1]
    evicted, _ = eng.evict_inflight(rids={1, 2})
    assert [r.rid for r in evicted] == [1, 2]
    assert released == [1]              # rid 2 was queued: it held no pages
    kv.check_conservation()
    evicted, _ = eng.evict_inflight()
    assert [r.rid for r in evicted] == [0] and released == [1, 0]
    assert eng.idle and kv.pages_live == kv._index_pages
    kv.check_conservation()
    assert eng._cache["pos"].device.type == "cuda"
