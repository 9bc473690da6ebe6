#!/usr/bin/env python3
"""Which ops of the port's decode step give a rank's heads (or columns)
other bits than the same heads (columns) of the whole computation, on
the card: exact-TP's premise, op by op, at qwen2-1.5b's decode shape
(B=4, H=12, KvH=2, Hd=128, cache 1024, per-row lengths) and
deepseek-moe-16b's (H = KvH = 16), for a rank of 2.

    python3 tools/tp_exactness_probe.py

Prints, per op, whether rank 0's and rank 1's slices are bit-equal to the
whole result's and the largest |difference|: the bf16 column-parallel
products (wq, wk, wi at the decode's M = B and a prefill's M = 512),
the f32 head (one product, and lm_logits(blocked=True)), the
experts' batched up-projections, the attention as a rank runs it
(decode_attention and chunked_causal_attention with heads=: its heads
inside the whole head count's products) against the whole, one batched
f32 score product over a rank's heads alone, and one f32 score product
a kv head (the unpadded route a rank could take: its bf16 output often
hides the f32 difference on random inputs, not on a model's); with the
launches a call of the whole, the rank's and the one-product-a-kv-head
decode (cudaLaunchKernel under torch.profiler). Needs a card.
"""

from __future__ import annotations

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    from repro_torch import backend
    from repro_torch.models import attention, layers
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    tp = 2

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev)
                * scale).bfloat16()

    def compare(tag, whole, parts, dim):
        """parts[r] against whole's r-th block along dim."""
        n = whole.shape[dim] // len(parts)
        res = []
        for r, p in enumerate(parts):
            w = whole.narrow(dim, r * n, n)
            res.append((bool(torch.equal(p, w)),
                        float((p.float() - w.float()).abs().max())))
        print(f"{tag}: {res} [{card}]", flush=True)

    def heads(t, r, n):
        """Rank r's block of n heads (axis 2), contiguous as a rank holds
        it."""
        return t[:, :, r * n:(r + 1) * n].contiguous()

    def launches(fn):
        """cudaLaunchKernel calls of one fn() (after a warm-up call)."""
        from torch.profiler import ProfilerActivity, profile
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        return sum(e.count for e in prof.key_averages()
                   if e.key == "cudaLaunchKernel")

    def per_head_decode(q, k, v, clen):
        """decode_attention on a rank's heads as one product a kv head
        over the rank's own (unpadded) tensors."""
        b, _, h, hd = q.shape
        n = k.shape[2]
        g = h // n
        qr = q.reshape(b, n, g, hd).float()
        kf, vf = k.float(), v.float()
        pos = torch.arange(k.shape[1], device=q.device)
        mask = (pos[None, :] < clen[:, None])[:, None, :]
        outs = []
        for j in range(n):
            s = torch.einsum("bgd,bsd->bgs", qr[:, j], kf[:, :, j]) \
                * hd ** -0.5
            p = torch.softmax(torch.where(mask, s, attention.NEG_INF),
                              dim=-1).to(torch.bfloat16)
            outs.append(torch.einsum("bgs,bsd->bgd", p.float(), vf[:, :, j]))
        return torch.stack(outs, 1).to(torch.bfloat16).reshape(b, 1, h, hd)

    with backend.f32_accumulation(), torch.no_grad():
        # the column-parallel products: bf16 at the decode's M = B = 4 and
        # a prefill's M = 512; the f32 head (deepseek's untied 2048 x
        # 102400); the experts' batched up-projections (64 experts)
        for m in (4, 512):
            x = randn(1, m, 1536) if m > 4 else randn(m, 1, 1536)
            for name, n in (("wq", 1536), ("wk", 256), ("wi", 8960)):
                w = randn(1536, n, scale=0.02)
                nl = n // tp
                compare(f"bf16 matmul M={m} @ {name} (1536,{n})", x @ w,
                        [x @ w[:, r * nl:(r + 1) * nl].contiguous()
                         for r in range(tp)], -1)
        wh = randn(2048, 102400, scale=0.02)
        for m in (1, 4):
            xh = randn(m, 1, 2048)
            compare(f"f32 head M={m} (2048,102400), one product",
                    xh.float() @ wh.float(),
                    [xh.float() @ wh[:, r * 51200:(r + 1) * 51200].float()
                     for r in range(tp)], -1)
            compare(f"f32 head M={m}, layers.lm_logits (K-blocked)",
                    layers.lm_logits(xh, wh, blocked=True),
                    [layers.lm_logits(
                        xh, wh[:, r * 51200:(r + 1) * 51200].contiguous(),
                        blocked=True) for r in range(tp)], -1)
        for c in (1, 10):
            xe = randn(64, c, 2048)
            we = randn(64, 2048, 1408, scale=0.02)
            compare(f"bf16 expert bmm (64,{c},2048) @ (64,2048,1408)",
                    xe @ we, [xe @ we[..., r * 704:(r + 1) * 704].contiguous()
                              for r in range(tp)], -1)
        for label, b, h, kvh in (("qwen2", 4, 12, 2), ("deepseek", 4, 16,
                                                      16)):
            hd, lc = 128, 1024
            hl, kl = h // tp, kvh // tp
            q = randn(b, 1, h, hd)
            k = randn(b, lc, kvh, hd)
            v = randn(b, lc, kvh, hd)
            clen = torch.tensor([700, 1000, 33, 512], device=dev)
            whole = attention.decode_attention(q, k, v, clen)
            compare(f"{label} decode_attention (B={b}, H={h}, KvH={kvh}, "
                    f"Hd={hd}, L={lc}; a rank's route, heads=)", whole,
                    [attention.decode_attention(
                        heads(q, r, hl), heads(k, r, kl), heads(v, r, kl),
                        clen, heads=(r * kl, kvh)) for r in range(tp)], 2)
            # one batched product over a rank's heads alone (B x KvH/tp)
            g = h // kvh
            qr = q.reshape(b, kvh, g, hd).float()
            s_whole = torch.einsum("bkgd,bskd->bkgs", qr, k.float())
            compare(f"{label} scores, one batched f32 einsum", s_whole,
                    [torch.einsum("bkgd,bskd->bkgs",
                                  qr[:, r * kl:(r + 1) * kl].contiguous(),
                                  heads(k, r, kl).float())
                     for r in range(tp)], 1)
            compare(f"{label} scores, one f32 product a kv head", s_whole,
                    [torch.stack([torch.einsum(
                        "bgd,bsd->bgs", qr[:, j].contiguous(),
                        k[:, :, j].float().contiguous())
                        for j in range(r * kl, (r + 1) * kl)], 1)
                     for r in range(tp)], 1)
            r0 = (heads(q, 0, hl), heads(k, 0, kl), heads(v, 0, kl))
            print(f"{label} decode launches a call: whole "
                  f"{launches(lambda: attention.decode_attention(q, k, v, clen))}"
                  f", a rank's route (heads=) "
                  f"{launches(lambda: attention.decode_attention(*r0, clen, heads=(0, kvh)))}"
                  f", one product a kv head "
                  f"{launches(lambda: per_head_decode(*r0, clen))} "
                  f"[{card}]", flush=True)
            compare(f"{label} softmax of the same rows, fewer rows a call",
                    torch.softmax(s_whole, -1),
                    [torch.softmax(s_whole[:, r * kl:(r + 1) * kl]
                                   .contiguous(), -1) for r in range(tp)], 1)
            # a prefill that the chunked route takes (S = 160)
            qp, kp, vp = (randn(1, 160, n, hd) for n in (h, kvh, kvh))
            compare(f"{label} chunked_causal_attention S=160, heads=",
                    attention.chunked_causal_attention(qp, kp, vp),
                    [attention.chunked_causal_attention(
                        heads(qp, r, hl), heads(kp, r, kl),
                        heads(vp, r, kl), heads=(r * kl, kvh))
                     for r in range(tp)], 2)
            rp = (heads(qp, 0, hl), heads(kp, 0, kl), heads(vp, 0, kl))
            print(f"{label} chunked S=160 launches a call: whole "
                  f"{launches(lambda: attention.chunked_causal_attention(qp, kp, vp))}"
                  f", a rank's route (heads=) "
                  f"{launches(lambda: attention.chunked_causal_attention(*rp, heads=(0, kvh)))}"
                  f" [{card}]", flush=True)

if __name__ == "__main__":
    main()
