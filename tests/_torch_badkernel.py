"""Deliberately broken fixture kernel for the port's static-auditor tests
— the torch counterpart of tests/fixture_badkernel.py.

Registers `badfix`: a kernel whose only config declares a shared-memory
working set twice what a Hopper block may use, so the auditor flags it
SMEM001 (error) and `python -m repro_torch.analyze --device cpu --strict
--extra-module _torch_badkernel --kernel badfix` exits nonzero.
Registration happens at import, which is what `--extra-module` is for.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.core.hw import DEFAULT_SPEC
from repro_torch.kernels import api


@dataclasses.dataclass(frozen=True)
class FixKey:
    n: int = 256
    name: str = "fix"

    def key_dims(self) -> str:
        return str(self.n)


@dataclasses.dataclass(frozen=True)
class FixConfig:
    name: str = "bad"
    # f32 elements; twice a block's shared memory on purpose
    blk: int = 2 * DEFAULT_SPEC.smem_per_block // 4


class BadKernel(api.Kernel):
    name = "badfix"
    versions = ("cuda",)
    default_version = "cuda"

    def static_config(self, key: FixKey, version: str) -> FixConfig:
        return FixConfig()

    def make_example(self, key: FixKey, seed: int = 0, device="cpu"
                     ) -> Tuple[tuple, dict]:
        return (torch.linspace(0, 1, key.n, device=device),), {}

    def config_from_json(self, d: Dict) -> FixConfig:
        return FixConfig(**d)

    def canonical_keys(self) -> List[FixKey]:
        return [FixKey()]

    def key_from_dims(self, dims: str) -> FixKey:
        return FixKey(n=int(dims))

    def config_smem_bytes(self, config: FixConfig, key: FixKey, *,
                          version=None, spec=None) -> Optional[int]:
        return 4 * config.blk

    def run(self, x, *, version: str, config: Optional[FixConfig], device):
        return torch.tanh(x) * x + x


KERNEL = api.register(BadKernel())
