"""`paged_decode` family registration for the port's kernel registry — the
port of `repro.kernels.paged.kernel_def` (:48-283).

The paged serving cache (serve/kvcache.py) stores K/V as fixed-size pages
addressed through per-request block tables, so its decode attention is a
gather-then-contract problem:

  * `PagedKey` — (b, h, kvh, page, npt, hd, qlen): the pool page size and
    the block-table length are part of the problem, not the config; a
    multi-query key (qlen > 1) appends a 7th part to its dims;
  * `PagedBlockConfig(pages_per_block)` — how many pages each online-
    softmax step stages (PPB_MENU), clamped to a divisor of npt;
  * versions ("ref", "gather", "int8", "verify"), default "gather", the
    last three tunable: the full-gather oracle (plain torch), and the
    three entry points of csrc/paged_decode.cu through paged_cuda.py (the
    plain versions of kernels/paged/paged.py on CPU tensors). `run`
    routes as the JAX package does: a rank-4 q under "gather" goes to the
    verify route; "int8" given a float pool quantizes it on the fly
    (`paged.quantize_pool`); an int8 pool without kscale/vscale raises.

The config space is empty at a head dim the kernel is not built for
(`paged_cuda.HEAD_DIMS`), and keeps a block only when the kernel's shared
memory for it at one split (`paged_cuda.smem_bytes`, bf16 lines for
"gather" and "verify", int8 for "int8"; a split's stage is never larger)
fits one CTA (`GpuSpec.smem_per_block`), not the TPU's VMEM. The split
count is not a config: the wrapper sets it from the shape and the SM
count of the card it launches on.
The ranking model is `core.gpu_model.paged_step_s`. The static-analysis
hooks wait, as they did for GPP, flash and ssm.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.core import gpu_model, hw
from repro_torch.kernels import api
from repro_torch.kernels.paged import paged, paged_cuda

PPB_MENU = (1, 2, 4, 8, 16)


@dataclasses.dataclass(frozen=True)
class PagedKey:
    """ProblemKey for one paged decode layer: B rows of `qlen` query
    tokens each (1 for plain decode, k+1 for the speculative verify)
    attending over npt pages of `page` K/V lines from the pool."""
    b: int
    h: int
    kvh: int
    page: int
    npt: int
    hd: int
    qlen: int = 1
    name: str = "paged_decode"

    def key_dims(self) -> str:
        base = (f"{self.b}x{self.h}x{self.kvh}x{self.page}"
                f"x{self.npt}x{self.hd}")
        # qlen 1 keeps the 6-part form; multi-query keys append a 7th part
        return base if self.qlen == 1 else f"{base}x{self.qlen}"


def _div_clamp(blk: int, n: int) -> int:
    """Largest block <= blk that exactly tiles n (a plain min() on a
    non-dividing count would drop tail pages silently)."""
    blk = min(blk, n)
    while n % blk:
        blk -= 1
    return blk


@dataclasses.dataclass(frozen=True)
class PagedBlockConfig:
    name: str = "paged"
    pages_per_block: int = 8

    def clamped(self, key: PagedKey) -> "PagedBlockConfig":
        return dataclasses.replace(
            self, pages_per_block=_div_clamp(self.pages_per_block, key.npt))

    def smem_bytes(self, key: PagedKey, kv_itemsize: int) -> int:
        """The kernel's dynamic shared memory at this block and one split,
        where a stage is largest: a block that fits there fits at every
        split count the wrapper may take."""
        return paged_cuda.smem_bytes(key.h // key.kvh * key.qlen, key.hd,
                                     key.page, key.npt, self.pages_per_block,
                                     1, kv_itemsize)


def kv_itemsize(version: str) -> int:
    return 1 if version == "int8" else 2


class PagedDecodeKernel(api.Kernel):
    name = "paged_decode"
    versions = ("ref", "gather", "int8", "verify")
    default_version = "gather"
    tunable = ("gather", "int8", "verify")

    def problem_key(self, q, kpool, vpool, block_table, cache_len,
                    **kwargs) -> PagedKey:
        if q.dim() == 4:
            b, qlen, h, hd = q.shape
        else:
            b, h, hd = q.shape
            qlen = 1
        _, page, kvh, _ = kpool.shape
        return PagedKey(b=b, h=h, kvh=kvh, page=page,
                        npt=block_table.shape[1], hd=hd, qlen=qlen)

    def config_space(self, key: PagedKey, version: str
                     ) -> List[PagedBlockConfig]:
        if version == "ref" or key.hd not in paged_cuda.HEAD_DIMS:
            return []
        out = []
        for ppb in PPB_MENU:
            if ppb > key.npt or key.npt % ppb:
                continue
            cfg = PagedBlockConfig("tune", ppb)
            if (cfg.smem_bytes(key, kv_itemsize(version))
                    <= hw.DEFAULT_SPEC.smem_per_block):
                out.append(cfg)
        return out

    def static_config(self, key: PagedKey, version: str
                      ) -> Optional[PagedBlockConfig]:
        return PagedBlockConfig().clamped(key)

    def tie_break(self, config: PagedBlockConfig) -> Tuple:
        # bigger blocks first: fewer steps at equal modeled time
        return (-config.pages_per_block,)

    def finalize_config(self, config: PagedBlockConfig, version: str
                        ) -> PagedBlockConfig:
        return dataclasses.replace(config, name=version)

    def model_step_s(self, key: PagedKey, config: PagedBlockConfig,
                     version: str, device=None) -> float:
        spec = hw.spec_for_device(device or "cpu")
        return gpu_model.paged_step_s(key, config.clamped(key),
                                      kv_itemsize(version), spec)

    def make_example(self, key: PagedKey, seed: int = 0, device="cpu"
                     ) -> Tuple[tuple, dict]:
        # a pool of exactly b*npt pages with a disjoint identity table, as
        # the JAX package's example
        gen = torch.Generator(device=torch.device(device)).manual_seed(seed)
        n_pages = key.b * key.npt
        qshape = ((key.b, key.h, key.hd) if key.qlen == 1
                  else (key.b, key.qlen, key.h, key.hd))

        def rnd(*shape):
            return torch.randn(shape, generator=gen, device=device).to(
                torch.bfloat16)

        q = rnd(*qshape)
        kpool = rnd(n_pages, key.page, key.kvh, key.hd)
        vpool = rnd(n_pages, key.page, key.kvh, key.hd)
        table = torch.arange(n_pages, dtype=torch.int32,
                             device=device).reshape(key.b, key.npt)
        ctx = key.npt * key.page
        cache_len = ctx - (torch.arange(key.b, dtype=torch.int32,
                                        device=device) % max(ctx - 1, 1))
        # every query position must exist: cache_len counts the qlen
        # candidate lines already written to the pool
        cache_len = torch.clamp_min(cache_len, key.qlen).to(torch.int32)
        return (q, kpool, vpool, table, cache_len), {}

    def config_from_json(self, d: Dict) -> PagedBlockConfig:
        return PagedBlockConfig(**d)

    def run(self, q, kpool, vpool, block_table, cache_len, *, version: str,
            config: Optional[PagedBlockConfig], device, kscale=None,
            vscale=None):
        """q: (B,H,Hd) single-token decode or (B,Q,H,Hd) multi-query
        verify; pools: (P,page,KvH,Hd); block_table: (B,npt) int32;
        cache_len: (B,) -> out matching q's rank, on `device`. "int8"
        takes per-page kscale/vscale (the serve pool's layout); given a
        float pool it quantizes on the fly."""
        q, kpool, vpool, block_table, cache_len = (
            x.to(device) for x in (q, kpool, vpool, block_table, cache_len))
        kscale, vscale = (None if x is None else x.to(device)
                          for x in (kscale, vscale))
        if version == "ref":
            return paged.paged_decode_ref(q, kpool, vpool, block_table,
                                          cache_len)
        key = self.problem_key(q, kpool, vpool, block_table, cache_len)
        ppb = (config or PagedBlockConfig()).clamped(key).pages_per_block
        if version == "verify":
            if not kpool.dtype.is_floating_point \
                    and (kscale is None or vscale is None):
                raise ValueError("paged_decode verify needs kscale/vscale "
                                 "for an int8 pool")
            return paged_cuda.paged_decode_verify(
                q, kpool, vpool, block_table, cache_len, ppb, kscale, vscale)
        if version == "gather":
            if q.dim() == 4:
                # the single-token loop has no query axis: multi-query
                # problems take the verify route (same blockwise loader,
                # per-query causal mask)
                return paged_cuda.paged_decode_verify(
                    q, kpool, vpool, block_table, cache_len, ppb)
            return paged_cuda.paged_decode_gather(
                q, kpool, vpool, block_table, cache_len, ppb)
        if kpool.dtype.is_floating_point:
            kpool, kscale = paged.quantize_pool(kpool)
            vpool, vscale = paged.quantize_pool(vpool)
        elif kscale is None or vscale is None:
            raise ValueError("paged_decode int8 needs kscale/vscale for an "
                             "int8 pool")
        if q.dim() == 4:
            return paged_cuda.paged_decode_verify(
                q, kpool, vpool, block_table, cache_len, ppb, kscale, vscale)
        return paged_cuda.paged_decode_int8(
            q, kpool, vpool, block_table, cache_len, kscale, vscale, ppb)


KERNEL = api.register(PagedDecodeKernel())
