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

    def run(self, inputs: Dict, *, version: str,
            config: Optional[gpp_cuda.BlockConfig], device) -> Tuple[Any, Any]:
        t = problem.to_tensors(inputs, device)
        if version in variants.VARIANTS:
            return variants.VARIANTS[version](t)
        if config is None:
            raise ValueError(f"gpp {version} needs a BlockConfig")
        return gpp_cuda.gpp_cuda(t, config)


KERNEL = api.register(GppKernel())
