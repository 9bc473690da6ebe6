"""Tensor-parallel serving on the card: a 2-rank gloo world on cuda:0
(tests/_torch_tp_worker.py; NCCL refuses two ranks on one GPU, gloo takes
CUDA tensors) serving a reduced qwen2 (12 q / 2 kv heads, flash on: the
kernel on each rank's 6 q / 1 kv heads) against the unsharded engine on
the same card: tokens equal, and every model call's logits bit-equal,
printed with their distance where they are not. Every test here needs a
CUDA card and skips without one; the file imports nothing of jax."""

import pytest
import torch

import _torch_tp_worker as W

pytestmark = pytest.mark.cuda

PAYLOAD = dict(arch="qwen2-1.5b", reduce=dict(layers=2, d_model=384,
                                               vocab=512),
               replace=dict(use_flash_attention=True), seed=0, max_batch=2,
               cache_len=288, device="cuda",
               requests=dict(lens=(5, 9, 256, 12, 7), seed=3,
                             temps=(0.0, 0.7), max_new=(9, 3)))


@pytest.fixture
def cuda():
    """A CUDA device, decided when the test runs (skips without a card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def test_tp2_on_the_card_matches_unsharded(cuda, tmp_path):
    ref = W.serve(None, PAYLOAD)            # builds the kernels first
    world = W.run_world(tmp_path, 2, [("serve", PAYLOAD)], device="cuda")
    for rank in (0, 1):
        got = world[rank]["serve"]
        dist = [float((a - b).abs().max()) for a, b in
                zip(got["logits"], ref["logits"])]
        print(f"rank {rank}: {len(dist)} model calls, logits max |diff| "
              f"{max(dist)}, calls that differ "
              f"{sum(d > 0 for d in dist)}")
        assert got["tokens"] == ref["tokens"]
        assert max(dist) == 0.0
    shapes = world[0]["serve"]["shapes"]
    assert shapes["layers/attn/wq"] == ((2, 384, 192), (2, 384, 384))
    assert world[0]["serve"]["device_stats"] == \
        world[1]["serve"]["device_stats"]


def test_shard_products_keep_their_bits_on_the_card(cuda):
    """The ops exact-TP needs bit-equal on the card (ROADMAP queue 3,
    tools/tp_exactness_probe.py): decode and chunked attention on a rank's
    heads (heads=: inside the whole head count's products) against the
    same heads of the whole, and the untied f32 head's vocab halves at
    one row and at four (lm_logits(blocked=True), as exact-TP runs it)."""
    from repro_torch import backend
    from repro_torch.models import attention, layers
    gen = torch.Generator(device=cuda).manual_seed(0)

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=cuda)
                * scale).bfloat16()

    def heads(t, r, n):
        return t[:, :, r * n:(r + 1) * n].contiguous()

    with backend.f32_accumulation(), torch.no_grad():
        q, k, v = randn(4, 1, 12, 128), randn(4, 1024, 2, 128), \
            randn(4, 1024, 2, 128)
        clen = torch.tensor([700, 1000, 33, 512], device=cuda)
        whole = attention.decode_attention(q, k, v, clen)
        qp, kp, vp = randn(1, 160, 12, 128), randn(1, 160, 2, 128), \
            randn(1, 160, 2, 128)
        whole_p = attention.chunked_causal_attention(qp, kp, vp)
        for r in range(2):
            assert torch.equal(attention.decode_attention(
                heads(q, r, 6), heads(k, r, 1), heads(v, r, 1), clen,
                heads=(r, 2)), whole[:, :, 6 * r:6 * (r + 1)])
            assert torch.equal(attention.chunked_causal_attention(
                heads(qp, r, 6), heads(kp, r, 1), heads(vp, r, 1),
                heads=(r, 2)), whole_p[:, :, 6 * r:6 * (r + 1)])
        w = randn(2048, 102400, scale=0.02)
        for m in (1, 4):
            x = randn(m, 1, 2048)
            full = layers.lm_logits(x, w, blocked=True)
            for r in range(2):
                assert torch.equal(layers.lm_logits(
                    x, w[:, r * 51200:(r + 1) * 51200].contiguous(),
                    blocked=True), full[..., r * 51200:(r + 1) * 51200])


# the hybrid, ssm, encdec and vlm families at the CPU tests' sizes
# (tests/test_torch_serve_tp.py), on the card: hymba with the "pallas"
# scan (the kernel on each rank's half of the channels), internvl2 with
# flash on (the kernel on a rank's 6 / 1 heads at 256 rows)
FAMILIES = {
    "hybrid": dict(arch="hymba-1.5b", reduce=dict(layers=2, d_model=128,
                                                   vocab=128),
                   replace=dict(ssm_impl="pallas"), seed=5,
                   requests=dict(lens=(5, 70, 64, 12, 7), seed=3,
                                 temps=(0.0, 0.7), max_new=(9, 3))),
    "ssm": dict(arch="rwkv6-7b", reduce=dict(layers=2, d_model=128,
                                              vocab=128),
                replace={}, seed=6,
                requests=dict(lens=(5, 70, 64, 12, 7), seed=3,
                              temps=(0.0, 0.7), max_new=(9, 3))),
    "encdec": dict(arch="whisper-small", reduce=dict(layers=2, d_model=128,
                                                      vocab=128),
                   replace={}, seed=7,
                   requests=dict(lens=(5, 9, 30, 12, 7), seed=3,
                                 temps=(0.0, 0.7), max_new=(9, 3))),
    "vlm": dict(arch="internvl2-26b", reduce=dict(layers=2, d_model=384,
                                                   vocab=128),
                replace=dict(use_flash_attention=True, n_vis_tokens=248),
                seed=8,
                requests=dict(lens=(5, 9, 7, 12, 6), seed=3,
                              temps=(0.0, 0.7), max_new=(9, 3)))}


@pytest.fixture(scope="module")
def family_world(tmp_path_factory):
    """Every family on both ranks of one 2-rank world on the card, and
    each unsharded engine's run in this process (first: it builds the
    kernels)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    payloads = {k: dict(p, max_batch=2, cache_len=288, device="cuda")
                for k, p in FAMILIES.items()}
    refs = {k: W.serve(None, p) for k, p in payloads.items()}
    world = W.run_world(tmp_path_factory.mktemp("tp2_cuda"), 2,
                        [(f"serve:{k}", p) for k, p in payloads.items()],
                        device="cuda")
    return refs, world


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_tp2_family_on_the_card_matches_unsharded(family_world, family):
    """Tokens and every model call's logits bit-equal to the unsharded
    engine on the card; hymba's scans are kernel launches on a rank's
    half of the channels with the unsharded scans' states a thread."""
    refs, world = family_world
    ref = refs[family]
    for rank in (0, 1):
        got = world[rank][f"serve:{family}"]
        dist = [float((a - b).abs().max()) for a, b in
                zip(got["logits"], ref["logits"])]
        print(f"{family} rank {rank}: {len(dist)} model calls, logits max "
              f"|diff| {max(dist)}, calls that differ "
              f"{sum(d > 0 for d in dist)}")
        assert got["tokens"] == ref["tokens"]
        assert len(dist) == len(ref["logits"]) and max(dist) == 0.0
        if family == "hybrid":
            assert len(got["scans"]) == len(ref["scans"]) == 10
            assert {(c * 2, s, d) for c, _, s, d in got["scans"]} == \
                {(c, s, d) for c, _, s, d in ref["scans"]} == \
                {(c, s, "cuda") for c, _, s, _ in ref["scans"]}
