"""Selective-scan (ssm) family registration for the port's kernel
registry — the port of `repro.kernels.ssm.kernel_def` (:41-196).

Versions ("ref", "chunked", "cuda"), behind the contract of
models/mamba.ssm_scan (x, dt: (B,T,C); bmat/cmat: (B,T,N); a_log: (C,N);
d: (C,); h0: (B,C,N)):

  ref      — the sequential oracle (models/mamba.ssm_scan)
  chunked  — the chunk-parallel form (models/mamba.ssm_chunked)
  cuda     — the hand-written Hopper kernel (csrc/ssm_scan.cu through
             ssm_cuda.ssm_scan; its plain version on CPU tensors)

The JAX version name "pallas" maps to "cuda". Default and tunable: "cuda",
whose config is the channel block `blk_c` and the states a thread
`states`. The config space is re-derived for Hopper: states in
{2, 4, 8} dividing N, blk_c a multiple of 8 (a CTA's x, dt and y rows
cover whole 32-byte sectors) dividing C, blk_c x N / states threads within
the kernel's 256, and the staged ring within the shared memory a block can
use (`GpuSpec.smem_per_block`), not the TPU's VMEM. The static config is
8 channels x 2 states (two warps at N = 16, the model's pick at
hymba-1.5b's prefill), clamped to C. The ranking
model is `core.gpu_model.ssm_step_s`. The static-analysis hooks wait, as
they did for GPP and flash.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.core import gpu_model, hw
from repro_torch.kernels import api
from repro_torch.kernels.ssm import ssm_cuda
from repro_torch.kernels.ssm.ssm_cuda import SsmScanConfig
from repro_torch.models import mamba

BLK_C_MENU = (8, 16, 32, 64, 128)

_div_clamp = ssm_cuda.div_clamp


@dataclasses.dataclass(frozen=True)
class SsmKey:
    b: int
    t: int
    c: int
    n: int
    name: str = "ssm"

    def key_dims(self) -> str:
        return f"{self.b}x{self.t}x{self.c}x{self.n}"


class SsmKernel(api.Kernel):
    name = "ssm"
    versions = ("ref", "chunked", "cuda")
    default_version = "cuda"
    tunable = ("cuda",)

    def problem_key(self, x, dt, bmat, cmat, a_log, d, h0) -> SsmKey:
        b, t, c = x.shape
        return SsmKey(b=b, t=t, c=c, n=a_log.shape[1])

    def config_space(self, key: SsmKey, version: str) -> List[SsmScanConfig]:
        spec = hw.DEFAULT_SPEC
        out = []
        for states in ssm_cuda.STATE_INSTANCES:
            if states > key.n or key.n % states:
                continue
            for blk in BLK_C_MENU:
                if blk > key.c or key.c % blk:
                    continue
                cfg = SsmScanConfig("tune", blk, states)
                if (cfg.threads(key.n) <= ssm_cuda.MAX_THREADS
                        and cfg.smem_bytes(key.n) <= spec.smem_per_block):
                    out.append(cfg)
        return out

    def static_config(self, key: SsmKey, version: str
                      ) -> Optional[SsmScanConfig]:
        return SsmScanConfig().clamped(key)

    def tie_break(self, config: SsmScanConfig) -> Tuple:
        # of configs the model ties, the one spread over the most SMs
        return (config.blk_c, -config.states)

    def finalize_config(self, config: SsmScanConfig, version: str
                        ) -> SsmScanConfig:
        return dataclasses.replace(config, name=version)

    def model_step_s(self, key: SsmKey, config: SsmScanConfig, version: str,
                     device=None) -> float:
        spec = hw.spec_for_device(device or "cpu")
        return gpu_model.ssm_step_s(key, config.clamped(key), spec)

    def make_example(self, key: SsmKey, seed: int = 0, device="cpu"
                     ) -> Tuple[tuple, dict]:
        gen = torch.Generator(device=torch.device(device)).manual_seed(seed)

        def rnd(*shape):
            return torch.randn(shape, generator=gen, device=device)

        x = rnd(key.b, key.t, key.c)
        dt = torch.nn.functional.softplus(rnd(key.b, key.t, key.c) - 2)
        bm = rnd(key.b, key.t, key.n)
        cm = rnd(key.b, key.t, key.n)
        alog = torch.log(torch.arange(1, key.n + 1, dtype=torch.float32,
                                      device=device))[None].repeat(key.c, 1)
        d = rnd(key.c)
        h0 = 0.1 * rnd(key.b, key.c, key.n)
        return (x, dt, bm, cm, alog, d, h0), {}

    def config_from_json(self, d: Dict) -> SsmScanConfig:
        return SsmScanConfig(**d)

    def run(self, x, dt, bmat, cmat, a_log, d, h0, *, version: str,
            config: Optional[SsmScanConfig], device):
        x, dt, bmat, cmat, a_log, d, h0 = (
            v.to(device) for v in (x, dt, bmat, cmat, a_log, d, h0))
        if version == "ref":
            return mamba.ssm_scan(x, dt, bmat, cmat, a_log, d, h0)
        if version == "chunked":
            t = x.shape[1]
            chunk = max(cc for cc in range(1, min(64, t) + 1) if t % cc == 0)
            return mamba.ssm_chunked(x, dt, bmat, cmat, a_log, d, h0,
                                     chunk=chunk)
        cfg = (config or SsmScanConfig()).clamped(
            self.problem_key(x, dt, bmat, cmat, a_log, d, h0))
        return ssm_cuda.ssm_scan(x, dt, bmat, cmat, a_log, d, h0, cfg)


KERNEL = api.register(SsmKernel())
