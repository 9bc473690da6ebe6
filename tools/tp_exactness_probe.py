#!/usr/bin/env python3
"""Which ops of the port's decode step give a rank's heads (or columns)
other bits than the same heads (columns) of the whole computation, on
the card: exact-TP's premise, op by op, at qwen2-1.5b's decode shape
(B=4, H=12, KvH=2, Hd=128, cache 1024, per-row lengths) and
deepseek-moe-16b's (H = KvH = 16), for a rank of 2.

    python3 tools/tp_exactness_probe.py
    python3 tools/tp_exactness_probe.py --families

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

--families runs, instead, the ops that hymba-1.5b, rwkv6-7b,
whisper-small and internvl2-26b serve under exact-TP, at their full
widths, for a rank of 2 (`family_ops`).
"""

from __future__ import annotations

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))


def main() -> None:
    import torch
    if "--families" in sys.argv[1:]:
        family_ops()
        return
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

def family_ops() -> None:
    """The products and reductions that the hybrid, ssm, encdec and vlm
    families compute on a rank's channels or heads under exact-TP, each
    against the same block of the whole computation, at full width: a
    rank's share (tp = 2) is bit-equal or it is not."""
    import torch
    from repro_torch import backend
    from repro_torch.kernels.ssm import ssm_cuda
    from repro_torch.kernels.ssm.kernel_def import SsmKey
    from repro_torch.models import attention, layers, rwkv6
    from repro_torch.tune import tuner
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    tp = 2

    def randn(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(*shape, generator=gen, device=dev)
                * scale).to(dtype)

    def report(tag, pairs):
        res = [(bool(torch.equal(a, b)),
                float((a.float() - b.float()).abs().max())) for a, b in pairs]
        print(f"{tag}: {res} [{card}]", flush=True)

    def cols(fn, x, w, dim=-1):
        """fn(x, w) whole against fn(x, w's rank block) on each rank."""
        whole = fn(x, w)
        n = w.shape[dim] // tp
        return [(fn(x, w.narrow(dim, r * n, n).contiguous()),
                 whole.narrow(-1, r * n, n)) for r in range(tp)]

    def f32(x, w):
        return torch.matmul(x.float(), w.float())

    def blocked(x, w):
        return layers._blocked_product(x, w)

    def heads_of(t, ax, r, n):
        return t.narrow(ax, r * n, n).contiguous()

    def padded(t, ax, r, n):
        """Rank r's n heads of t inside the whole head count, zeros at the
        others (the rule of attention._f32_heads)."""
        full = torch.zeros_like(t)
        full.narrow(ax, r * n, n).copy_(t.narrow(ax, r * n, n))
        return full

    with backend.f32_accumulation(), torch.no_grad():
        # hymba-1.5b: d 1600, Ci 3200, dt_rank 100, N 16
        for m in (4, 512):
            x = randn(1, m, 1600)
            w = randn(1600, 6400, scale=0.02)
            whole = x @ w
            pairs = []
            for r in range(tp):
                # the rank's block of xs and of z, packed side by side
                wl = torch.cat([w[:, r * 1600:(r + 1) * 1600],
                                w[:, 3200 + r * 1600:3200 + (r + 1) * 1600]],
                               -1).contiguous()
                got = x @ wl
                pairs.append((got, torch.cat(
                    [whole[..., r * 1600:(r + 1) * 1600],
                     whole[..., 3200 + r * 1600:3200 + (r + 1) * 1600]], -1)))
            report(f"hymba bf16 in_proj M={m} (1600,6400), a rank's xs|z",
                   pairs)
            dt_in = randn(1, m, 100, dtype=torch.float32)
            dtp = randn(100, 3200, scale=0.1)
            report(f"hymba f32 dt_in @ dt_proj M={m} (100,3200), one "
                   f"product", cols(f32, dt_in, dtp))
            report(f"hymba f32 dt_in @ dt_proj M={m}, K-blocked",
                   cols(blocked, dt_in, dtp))
            for name, k, n in (("ffn wi", 1600, 5504), ("wq", 1600, 1600),
                               ("wk", 1600, 320)):
                report(f"hymba bf16 {name} M={m} ({k},{n})",
                       cols(torch.matmul, x, randn(k, n, scale=0.02)))
        h = randn(4, 3200, 16, dtype=torch.float32)
        ct = randn(4, 16, dtype=torch.float32)
        whole = torch.einsum("bcn,bn->bc", h, ct)
        report("hymba ssm_decode's einsum bcn,bn->bc (B=4, C=3200, N=16)",
               [(torch.einsum("bcn,bn->bc", heads_of(h, 1, r, 1600), ct),
                 whole[:, r * 1600:(r + 1) * 1600]) for r in range(tp)])
        for t in (100, 512):
            picks = {c: tuner.tune_kernel("ssm", SsmKey(1, t, c, 16),
                                          measure_mode=False,
                                          device=dev).config
                     for c in (3200, 1600)}
            print(f"hymba ssm_scan model pick at T={t}: "
                  f"{ {c: (p.blk_c, p.states) for c, p in picks.items()} } "
                  f"[{card}]", flush=True)
            x = randn(1, t, 3200, dtype=torch.float32)
            dt = torch.nn.functional.softplus(
                randn(1, t, 3200, dtype=torch.float32) - 4.6)
            bm = randn(1, t, 16, dtype=torch.float32)
            cm = randn(1, t, 16, dtype=torch.float32)
            alog = torch.log(torch.arange(1, 17, device=dev).float())[
                None].repeat(3200, 1).bfloat16()
            dd = torch.ones(3200, device=dev).bfloat16()
            h0 = randn(1, 3200, 16, scale=0.1, dtype=torch.float32)
            for st in sorted({p.states for p in picks.values()}):
                cfg = ssm_cuda.SsmScanConfig("probe", 8, st)
                y, ht = ssm_cuda.ssm_scan(x, dt, bm, cm, alog, dd, h0, cfg)
                pairs = []
                for r in range(tp):
                    part = [heads_of(a, ax, r, 1600) for a, ax in (
                        (x, 2), (dt, 2), (alog, 0), (dd, 0), (h0, 1))]
                    yl, hl = ssm_cuda.ssm_scan(part[0], part[1], bm, cm,
                                               part[2], part[3], part[4],
                                               cfg)
                    pairs += [(yl, y[..., r * 1600:(r + 1) * 1600]),
                              (hl, ht[:, r * 1600:(r + 1) * 1600])]
                report(f"hymba ssm_scan kernel T={t} C=1600 of 3200 "
                       f"(blk_c 8, states {st}): y and hT a rank", pairs)
        # rwkv6-7b: d 4096, 64 heads of 64, d_ff 14336
        for m in (4, 512):
            x = randn(1, m, 4096)
            for name, n in (("wr", 4096), ("cm/wk", 14336)):
                report(f"rwkv bf16 {name} M={m} (4096,{n})",
                       cols(torch.matmul, x, randn(4096, n, scale=0.02)))
        b, hh, hd = 4, 64, 64
        r_, k_, v_, w_ = (randn(b, hh, hd, dtype=torch.float32, scale=s)
                          for s in (1.0, 1.0, 1.0, 0.1))
        w_ = torch.exp(-torch.exp(w_))
        u = randn(hh, hd, dtype=torch.float32, scale=0.5)
        st = randn(b, hh, hd, hd, dtype=torch.float32, scale=0.5)
        y, s2 = rwkv6.wkv6_decode(r_, k_, v_, w_, u, st)
        pairs = []
        for r in range(tp):
            sl = [heads_of(a, 1, r, 32) for a in (r_, k_, v_, w_)]
            yl, sl2 = rwkv6.wkv6_decode(*sl, heads_of(u, 0, r, 32),
                                        heads_of(st, 1, r, 32))
            pairs += [(yl, y[:, r * 32:(r + 1) * 32]),
                      (sl2, s2[:, r * 32:(r + 1) * 32])]
        report("rwkv wkv6_decode (B=4, H=64 -> 32 a rank): y, state", pairs)
        pairs = []
        for r in range(tp):
            yl, sl2 = rwkv6.wkv6_decode(
                *[padded(a, 1, r, 32) for a in (r_, k_, v_, w_)],
                padded(u, 0, r, 32), padded(st, 1, r, 32))
            pairs += [(heads_of(yl, 1, r, 32), y[:, r * 32:(r + 1) * 32]),
                      (heads_of(sl2, 1, r, 32), s2[:, r * 32:(r + 1) * 32])]
        report("rwkv wkv6_decode, a rank's heads inside all 64 (zeros "
               "elsewhere): y, state", pairs)
        for t, form in ((40, "one chunk"), (256, "chunks of 64"),
                        (100, "scan")):
            seq = [randn(1, t, hh, hd, dtype=torch.float32, scale=s)
                   for s in (1.0, 1.0, 1.0, 0.1)]
            seq[3] = torch.exp(-torch.exp(seq[3]))
            st0 = torch.zeros(1, hh, hd, hd, device=dev)

            def wkv(a, uu, s0):
                if form == "scan":
                    return rwkv6.wkv6_scan(*a, uu, s0)
                return rwkv6.wkv6_chunked(*a, uu, s0,
                                          chunk=t if t < 64 else 64)

            y, s2 = wkv(seq, u, st0)
            pairs = []
            for r in range(tp):
                yl, sl2 = wkv([heads_of(a, 2, r, 32) for a in seq],
                              heads_of(u, 0, r, 32), heads_of(st0, 1, r, 32))
                pairs += [(yl, y[:, :, r * 32:(r + 1) * 32]),
                          (sl2, s2[:, r * 32:(r + 1) * 32])]
            report(f"rwkv wkv6 T={t} ({form}), H=64 -> 32: y, state", pairs)
            pairs = []
            for r in range(tp):
                yl, sl2 = wkv([padded(a, 2, r, 32) for a in seq],
                              padded(u, 0, r, 32), padded(st0, 1, r, 32))
                pairs += [(heads_of(yl, 2, r, 32), y[:, :, r * 32:(r + 1) * 32]),
                          (heads_of(sl2, 1, r, 32), s2[:, r * 32:(r + 1) * 32])]
            report(f"rwkv wkv6 T={t} ({form}), a rank's heads inside all 64:"
                   f" y, state", pairs)
            yy = seq[0]
            mu = yy.mean(-1, keepdim=True)
            var = yy.var(-1, keepdim=True, correction=0)
            report(f"rwkv group-norm mean/var T={t} over 32 of 64 heads",
                   [(heads_of(yy, 2, r, 32).var(-1, keepdim=True,
                                                correction=0),
                     var[:, :, r * 32:(r + 1) * 32]) for r in range(tp)]
                   + [(heads_of(yy, 2, r, 32).mean(-1, keepdim=True),
                       mu[:, :, r * 32:(r + 1) * 32]) for r in range(tp)])
        # whisper-small: d 768, 12 heads of 64, d_ff 3072, 1500 frames,
        # the encoder's stream in f32 (f32 frames)
        xf = randn(1, 1500, 768, dtype=torch.float32)
        for name, n in (("wq", 768), ("wi", 3072)):
            wb = randn(768, n, scale=0.02)
            report(f"whisper f32 x (1500,768) @ bf16 {name} (768,{n}), one "
                   f"f32 product", cols(f32, xf, wb))
            report(f"whisper f32 x @ bf16 {name}, K-blocked",
                   cols(blocked, xf, wb))
            xb = randn(4, 1, 768)
            report(f"whisper bf16 decode M=4 @ {name}",
                   cols(torch.matmul, xb, wb))
        q, k, v = (randn(1, 1500, 12, 64) for _ in range(3))
        whole = attention.chunked_causal_attention(q, k, v, causal=False)
        report("whisper encoder attention (S=1500, 12 heads -> 6), heads=",
               [(attention.chunked_causal_attention(
                   heads_of(q, 2, r, 6), heads_of(k, 2, r, 6),
                   heads_of(v, 2, r, 6), causal=False, heads=(r * 6, 12)),
                 whole[:, :, r * 6:(r + 1) * 6]) for r in range(tp)])
        qd = randn(4, 1, 12, 64)
        xk, xv = randn(4, 1500, 12, 64), randn(4, 1500, 12, 64)
        whole = attention.decode_attention(qd, xk, xv, 1500)
        report("whisper cross decode (B=4, 1500 lines, 12 -> 6), heads=",
               [(attention.decode_attention(
                   heads_of(qd, 2, r, 6), heads_of(xk, 2, r, 6),
                   heads_of(xv, 2, r, 6), 1500, heads=(r * 6, 12)),
                 whole[:, :, r * 6:(r + 1) * 6]) for r in range(tp)])
        # internvl2-26b: d 6144, 48 / 8 heads of 128, d_ff 16384
        for m in (4, 512):
            x = randn(1, m, 6144)
            for name, n in (("wq", 6144), ("wk", 1024), ("wi", 16384)):
                report(f"internvl2 bf16 {name} M={m} (6144,{n})",
                       cols(torch.matmul, x, randn(6144, n, scale=0.02)))
        q = randn(1, 512, 48, 128)
        k, v = randn(1, 512, 8, 128), randn(1, 512, 8, 128)
        whole = attention.flash_attention(q, k, v)
        report("internvl2 flash_fwd S=512 (48 / 8 heads -> 24 / 4)",
               [(attention.flash_attention(heads_of(q, 2, r, 24),
                                           heads_of(k, 2, r, 4),
                                           heads_of(v, 2, r, 4)),
                 whole[:, :, r * 24:(r + 1) * 24]) for r in range(tp)])
        q = randn(1, 296, 48, 128)
        k, v = randn(1, 296, 8, 128), randn(1, 296, 8, 128)
        whole = attention.chunked_causal_attention(q, k, v)
        report("internvl2 chunked S=296 (48 / 8 heads -> 24 / 4), heads=",
               [(attention.chunked_causal_attention(
                   heads_of(q, 2, r, 24), heads_of(k, 2, r, 4),
                   heads_of(v, 2, r, 4), heads=(r * 4, 8)),
                 whole[:, :, r * 24:(r + 1) * 24]) for r in range(tp)])


if __name__ == "__main__":
    main()
