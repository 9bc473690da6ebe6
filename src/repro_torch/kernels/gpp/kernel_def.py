"""GPP family registration for the port's kernel registry
(`repro_torch.kernels.api`): v0–v5 plain-torch variants, v6–v9 static
Hopper configs, v10 tuned — the port of `repro.kernels.gpp.kernel_def`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.core import gpu_model, hw
from repro_torch.kernels import api
from repro_torch.kernels.gpp import gpp_cuda, problem, variants
from repro_torch.tune import space


class GppKernel(api.Kernel):
    name = "gpp"
    versions = ("v0", "v1", "v2", "v3", "v4", "v5", "v6", "v7", "v8", "v9",
                "v10")
    default_version = "v10"
    tunable = ("v10",)

    def problem_key(self, inputs: Dict) -> problem.GppSize:
        return problem.size_of(inputs)

    def config_space(self, key: problem.GppSize, version: str
                     ) -> List[gpp_cuda.BlockConfig]:
        fused = version not in ("v6", "v7", "v8")
        return space.candidates(key, fused=fused)

    def static_config(self, key: problem.GppSize, version: str
                      ) -> Optional[gpp_cuda.BlockConfig]:
        if version in gpp_cuda.CONFIGS:
            return gpp_cuda.CONFIGS[version].clamped(key)
        if version == "v10":
            # shapes the tune menu cannot tile (e.g. ngpown < 32): v9's
            # blocks, clamped
            return dataclasses.replace(gpp_cuda.V9.clamped(key), name="v10")
        return None    # v0–v5 take no config

    def tie_break(self, config: gpp_cuda.BlockConfig) -> Tuple:
        # bigger blocks first — fewer blocks
        return (-config.blk_band, -config.blk_ig, -config.blk_igp,
                -config.threads)

    def finalize_config(self, config: gpp_cuda.BlockConfig, version: str
                        ) -> gpp_cuda.BlockConfig:
        return dataclasses.replace(config, name=version)

    def model_step_s(self, key: problem.GppSize,
                     config: gpp_cuda.BlockConfig, version: str,
                     device=None) -> float:
        spec = hw.spec_for_device(device or "cpu")
        return gpu_model.step_s(key, config, spec)

    def make_example(self, key: problem.GppSize, seed: int = 0, device="cpu"
                     ) -> Tuple[tuple, dict]:
        return (problem.to_tensors(problem.make_inputs(key, seed=seed),
                                   device),), {}

    def config_from_json(self, d: Dict) -> gpp_cuda.BlockConfig:
        return gpp_cuda.BlockConfig(**d)

    def canonical_keys(self) -> List[problem.GppSize]:
        return [problem.TINY, problem.BENCH]

    def key_from_dims(self, dims: str) -> problem.GppSize:
        ncouls, ngpown, nbands, nw = (int(d) for d in dims.split("x"))
        for s in problem.SIZES.values():
            if (s.ncouls, s.ngpown, s.nbands, s.nw) == (ncouls, ngpown,
                                                        nbands, nw):
                return s
        return problem.GppSize("custom", nbands=nbands, ngpown=ngpown,
                               ncouls=ncouls, nw=nw)

    def config_smem_bytes(self, config: gpp_cuda.BlockConfig,
                          key: problem.GppSize, *, version=None,
                          spec=None) -> int:
        # the staged band chunk (dynamic) and the reduction scratch (static)
        return config.smem_bytes(key.nw)

    def launch_grid(self, config: gpp_cuda.BlockConfig, key: problem.GppSize,
                    *, version=None, spec=None) -> int:
        return gpp_cuda.grid_blocks(key, config)

    def config_divides(self, config: gpp_cuda.BlockConfig,
                       key: problem.GppSize) -> List[str]:
        out = []
        for axis, n, blk in (("ncouls", key.ncouls, config.blk_ig),
                             ("ngpown", key.ngpown, config.blk_igp),
                             ("nbands", key.nbands, config.blk_band)):
            if blk <= 0 or n % blk:
                out.append(f"{axis}={n} not tiled by block {blk}")
        return out

    def allowed_float_dtypes(self, version: str) -> frozenset:
        # planar f32 arithmetic; outputs assemble to complex64
        return frozenset({"float32", "complex64"})

    def library_launch_shape(self, config: gpp_cuda.BlockConfig,
                             key: problem.GppSize, version: str
                             ) -> Optional[Tuple[int, int]]:
        if version in variants.VARIANTS:
            return None
        dynamic, static, blocks = gpp_cuda.launch_shape(key, config)
        return dynamic + static, blocks

    def run(self, inputs: Dict, *, version: str,
            config: Optional[gpp_cuda.BlockConfig], device) -> Tuple[Any, Any]:
        t = problem.to_tensors(inputs, device)
        if version in variants.VARIANTS:
            return variants.VARIANTS[version](t)
        if config is None:
            raise ValueError(f"gpp {version} needs a BlockConfig")
        return gpp_cuda.gpp_cuda(t, config)


KERNEL = api.register(GppKernel())
