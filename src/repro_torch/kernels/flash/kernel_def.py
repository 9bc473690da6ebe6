"""Flash-attention family registration for the port's kernel registry —
the port of `repro.kernels.flash.kernel_def` (:41-216).

Versions ("ref", "cuda"): "ref" is the one-shot f32 oracle (ref.py) on
planar heads, differentiable by plain autograd; "cuda" is the
hand-written Hopper kernels through `flash_cuda.flash_attention_diff`
(csrc/flash.cu forward, csrc/flash_bwd.cu backward; their plain versions
on CPU tensors), the counterpart of the JAX custom VJP. The JAX version
name "pallas" maps to "cuda". Default and tunable: "cuda"; the config
tunes the forward, the backward takes `flash_cuda.bwd_configs`.

The config space is (blk_q, blk_kv) over the card kernel's compiled
instances (blk_q 64 or 128: one or two consumer warpgroups of wgmma's 64
rows; blk_kv 64 or 128 rows a stage of the K/V ring), each dividing its
sequence length and fitting Hopper's shared memory a block can use
(`GpuSpec.smem_per_block`), not the TPU's VMEM. The static config is
re-chosen for Hopper: 64 x 64 (one consumer warpgroup and a producer
warp, two CTAs an SM; the TPU's 256 x 256 tiles would need registers the
card does not have), clamped to the problem as the JAX one is. The
ranking model is `core.gpu_model.flash_step_s`. The static-analysis hooks
(`repro_torch.analyze`) model the forward's launch: its dynamic shared
memory at the compiled head dim (Hd 32 runs on the Hd 64 instance) and
its (B x H, Sq / blk_q) grid.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.core import gpu_model, hw
from repro_torch.kernels import api
from repro_torch.kernels.flash import flash_cuda
from repro_torch.kernels.flash.flash_cuda import FlashBlockConfig

BLK_Q_MENU = flash_cuda.BLK_Q_INSTANCES
BLK_KV_MENU = flash_cuda.BLK_KV_INSTANCES

_div_clamp = flash_cuda.div_clamp


@dataclasses.dataclass(frozen=True)
class FlashKey:
    """ProblemKey for one attention call, model-native (B,S,H,Hd) layout."""
    b: int
    h: int
    kvh: int
    sq: int
    skv: int
    hd: int
    causal: bool = True
    name: str = "attn"

    def key_dims(self) -> str:
        return (f"{self.b}x{self.h}x{self.kvh}x{self.sq}x{self.skv}"
                f"x{self.hd}{'c' if self.causal else 'f'}")


def _visited_pairs(key: FlashKey, cfg: FlashBlockConfig) -> int:
    """(q, kv) block pairs one head runs (causal skips the strictly-upper
    wedge as the kernel's loop bound)."""
    return flash_cuda.visited_pairs(key.sq, key.skv, cfg, key.causal)


class FlashKernel(api.Kernel):
    name = "flash"
    versions = ("ref", "cuda")
    default_version = "cuda"
    tunable = ("cuda",)

    def problem_key(self, q, k, v, *, causal: bool = True) -> FlashKey:
        b, sq, h, hd = q.shape
        _, skv, kvh, _ = k.shape
        return FlashKey(b=b, h=h, kvh=kvh, sq=sq, skv=skv, hd=hd,
                        causal=causal)

    def config_space(self, key: FlashKey, version: str
                     ) -> List[FlashBlockConfig]:
        spec = hw.DEFAULT_SPEC
        out = []
        for bq in BLK_Q_MENU:
            if bq > key.sq or key.sq % bq:
                continue
            for bkv in BLK_KV_MENU:
                if bkv > key.skv or key.skv % bkv:
                    continue
                cfg = FlashBlockConfig("tune", bq, bkv)
                if cfg.smem_bytes(key.hd) <= spec.smem_per_block:
                    out.append(cfg)
        return out

    def clamp(self, config: FlashBlockConfig, key: FlashKey
              ) -> FlashBlockConfig:
        return config.clamped(key)

    def static_config(self, key: FlashKey, version: str
                      ) -> Optional[FlashBlockConfig]:
        if version == "ref":
            return None     # the plain oracle takes no config
        return FlashBlockConfig().clamped(key)

    def tie_break(self, config: FlashBlockConfig) -> Tuple:
        return (-config.blk_q, -config.blk_kv)

    def finalize_config(self, config: FlashBlockConfig, version: str
                        ) -> FlashBlockConfig:
        return dataclasses.replace(config, name=version)

    def model_step_s(self, key: FlashKey, config: FlashBlockConfig,
                     version: str, device=None) -> float:
        spec = hw.spec_for_device(device or "cpu")
        return gpu_model.flash_step_s(key, config.clamped(key), spec)

    def make_example(self, key: FlashKey, seed: int = 0, device="cpu"
                     ) -> Tuple[tuple, dict]:
        gen = torch.Generator(device=torch.device(device)).manual_seed(seed)

        def rnd(shape):
            return torch.randn(shape, generator=gen, device=device
                               ).to(torch.bfloat16)

        q = rnd((key.b, key.sq, key.h, key.hd))
        k = rnd((key.b, key.skv, key.kvh, key.hd))
        v = rnd((key.b, key.skv, key.kvh, key.hd))
        return (q, k, v), {"causal": key.causal}

    def config_from_json(self, d: Dict) -> FlashBlockConfig:
        return FlashBlockConfig(**d)

    def canonical_keys(self) -> List[FlashKey]:
        # Hd 32 launches the zero-padded Hd 64 instance
        return [FlashKey(b=2, h=2, kvh=2, sq=128, skv=128, hd=32,
                         causal=True)]

    def key_from_dims(self, dims: str) -> FlashKey:
        causal = dims.endswith("c")
        b, h, kvh, sq, skv, hd = (int(d) for d in dims[:-1].split("x"))
        return FlashKey(b=b, h=h, kvh=kvh, sq=sq, skv=skv, hd=hd,
                        causal=causal)

    def config_smem_bytes(self, config: FlashBlockConfig, key: FlashKey, *,
                          version=None, spec=None) -> int:
        # the forward declares no static __shared__ array
        return config.smem_bytes(flash_cuda.run_head_dim(key.hd))

    def launch_grid(self, config: FlashBlockConfig, key: FlashKey, *,
                    version=None, spec=None) -> int:
        return key.b * key.h * (key.sq // config.blk_q)

    def config_divides(self, config: FlashBlockConfig, key: FlashKey
                       ) -> List[str]:
        out = []
        for axis, n, blk in (("sq", key.sq, config.blk_q),
                             ("skv", key.skv, config.blk_kv)):
            if blk <= 0 or n % blk:
                out.append(f"{axis}={n} not tiled by block {blk}")
        return out

    def allowed_float_dtypes(self, version: str) -> frozenset:
        # bf16 operands, f32 stats/accumulator
        return frozenset({"bfloat16", "float32"})

    def library_launch_shape(self, config: FlashBlockConfig, key: FlashKey,
                             version: str) -> Optional[Tuple[int, int]]:
        if version == "ref":
            return None
        dynamic, static, blocks = flash_cuda.launch_shape(
            key.b, key.h, key.sq, key.hd, config)
        return dynamic + static, blocks

    def run(self, q, k, v, *, version: str,
            config: Optional[FlashBlockConfig], device, causal: bool = True):
        """q: (B,S,H,Hd); k/v: (B,S,KvH,Hd) -> (B,S,H,Hd), differentiable.
        "cuda" hands the model layout to the kernels as it is (they read
        through strides and write (B,S,H,Hd): no copies); "ref" goes
        through planar heads as the JAX descriptor does."""
        q, k, v = (x.to(device) for x in (q, k, v))
        b, sq, h, hd = q.shape
        _, skv, kvh, _ = k.shape
        if version == "ref":
            from repro_torch.kernels.flash.ref import reference
            qp = q.transpose(1, 2).reshape(b * h, sq, hd)
            kp = k.transpose(1, 2).reshape(b * kvh, skv, hd)
            vp = v.transpose(1, 2).reshape(b * kvh, skv, hd)
            out = reference(qp, kp, vp, causal=causal)
            return out.reshape(b, h, sq, hd).transpose(1, 2)
        cfg = (config or FlashBlockConfig()).clamped(
            self.problem_key(q, k, v, causal=causal))
        return flash_cuda.flash_attention_diff(q, k, v, cfg, causal)


KERNEL = api.register(FlashKernel())
