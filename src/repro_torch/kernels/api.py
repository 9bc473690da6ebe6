"""Kernel registry: one dispatch/tune API for every kernel family — the
port of `repro.kernels.api`.

  * `Kernel` — descriptor for one kernel family: named, versioned
    implementations (plain torch → hand-written CUDA), a `ProblemKey` for
    cache keying, a tunable config space with clamping rules, an analytic
    model hook (the tuner's ranking function), and the static-analysis
    hooks `repro_torch.analyze` reads (canonical keys, the launch's shared
    memory and grid, the library's own count of both).
  * `ProblemKey` — anything with a `.name` and `.key_dims()`.
  * a process-wide registry: `register(kernel)`, `get_kernel(name)`,
    `list_kernels()`, and `dispatch(name, *args, version=, config=,
    device=, problem_key=, **kwargs)` — the single public entry point.

The JAX registry's `interpret=` becomes `device=`: the entry points run on
the card ('cuda') unless the caller passes device='cpu'.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Protocol, Tuple, runtime_checkable

from repro_torch import backend


@runtime_checkable
class ProblemKey(Protocol):
    """What the tune cache keys on: a named problem instance whose
    `key_dims()` string is stable across processes."""

    name: str

    def key_dims(self) -> str:
        """e.g. '8192x1024x1024x2' — joined into the JSON cache key."""
        ...


class Kernel:
    """Descriptor for one kernel family. Subclasses fill in the class
    attributes and override the hooks their family supports.

    Class attributes:
      name             registry key ('gpp')
      versions         ordered implementation names, reference → fastest
      default_version  what dispatch runs when version=None
      tunable          versions whose config comes from repro_torch.tune
                       when dispatch is called without an explicit config
    """

    name: str = ""
    versions: Tuple[str, ...] = ()
    default_version: str = ""
    tunable: Tuple[str, ...] = ()

    # -- identity / cache keying ------------------------------------------
    def problem_key(self, *args, **kwargs) -> ProblemKey:
        """Recover the ProblemKey from a dispatch call's arguments."""
        raise NotImplementedError

    # -- config space (the tuner's menu) ----------------------------------
    def config_space(self, key: ProblemKey, version: str) -> List[Any]:
        """Feasible configs for `key`, deterministic order. Empty =
        nothing to tune."""
        return []

    def clamp(self, config: Any, key: ProblemKey) -> Any:
        """The config a launch at `key` runs under (`run` shrinks a
        config to fit a smaller problem)."""
        return config

    def static_config(self, key: ProblemKey, version: str) -> Optional[Any]:
        """The frozen per-version config, clamped to `key`; None when the
        version takes no config or must be tuned."""
        return None

    def tie_break(self, config: Any) -> Tuple:
        """Deterministic sort tail for model-score ties."""
        return ()

    def finalize_config(self, config: Any, version: str) -> Any:
        """Stamp the winning config before it is cached."""
        return config

    # -- model hook ---------------------------------------------------------
    def model_step_s(self, key: ProblemKey, config: Any, version: str,
                     device=None) -> float:
        """Analytic modeled seconds on `device`'s card — the tuner's
        ranking function."""
        raise NotImplementedError(f"{self.name} has no model")

    # -- measurement hooks -------------------------------------------------
    def make_example(self, key: ProblemKey, seed: int = 0, device="cpu"
                     ) -> Tuple[tuple, dict]:
        """(args, kwargs) for a representative dispatch of `key` with its
        tensors on `device`, for the tuner's measurement pass."""
        raise NotImplementedError(f"{self.name} cannot synthesize inputs")

    # -- config (de)serialization for the JSON tune cache ------------------
    def config_to_json(self, config: Any) -> Dict:
        return dataclasses.asdict(config)

    def config_from_json(self, d: Dict) -> Any:
        raise NotImplementedError

    # -- static-analysis hooks (repro_torch.analyze) -----------------------
    # The launch hooks take the config as `clamp` leaves it. `version`
    # (None: the default one) and `spec` (None: hw.DEFAULT_SPEC) matter
    # where a launch's shape depends on them (paged_decode: the pool's
    # line bytes, and the split count the card's SM count sets).
    def canonical_keys(self) -> List[ProblemKey]:
        """Representative shapes the `repro_torch.analyze` auditor
        censuses this family at (small enough for the CPU). Empty = the
        auditor skips the family."""
        return []

    def key_from_dims(self, dims: str) -> ProblemKey:
        """Inverse of `ProblemKey.key_dims()`, so the tune-cache validator
        can re-derive a cached entry's config space. A family without it
        gets existence-only validation."""
        raise NotImplementedError(f"{self.name} cannot parse key dims")

    def config_smem_bytes(self, config: Any, key: ProblemKey, *,
                          version: Optional[str] = None, spec=None
                          ) -> Optional[int]:
        """Shared memory a block takes under `config` at `key`: the
        dynamic shared memory the launch asks for plus the kernel's static
        `__shared__` arrays. The auditor's SMEM001 holds it to
        `GpuSpec.smem_per_block`. None = no shared-memory model."""
        return None

    def launch_grid(self, config: Any, key: ProblemKey, *,
                    version: Optional[str] = None, spec=None
                    ) -> Optional[int]:
        """Blocks the launch of `config` at `key` runs (the kernel whose
        shared memory `config_smem_bytes` models). None = no launch."""
        return None

    def gather_buffer_bytes(self, config: Any, key: ProblemKey, *,
                            version: Optional[str] = None, spec=None
                            ) -> Optional[int]:
        """For a kernel that gathers operands through an index (paged
        decode's block-table K/V fetch): the staging ring's bytes, which
        `config_smem_bytes` must cover (the auditor's KV001). None = the
        family gathers nothing."""
        return None

    def config_divides(self, config: Any, key: ProblemKey) -> List[str]:
        """Divisibility violations of the clamped `config` at `key`, one
        string per axis its blocks cannot tile (BLK001 for each)."""
        return []

    def allowed_float_dtypes(self, version: str) -> frozenset:
        """Float/complex dtype names ('float32', 'bfloat16', ...) the
        version's plain version may touch; any other is a DTYPE001 leak.
        Empty = unchecked."""
        return frozenset()

    def library_launch_shape(self, config: Any, key: ProblemKey,
                             version: str) -> Optional[Tuple[int, int]]:
        """The library's own (shared memory a block: dynamic + static,
        blocks) of the launch, from the C entry points the launcher's
        arithmetic shares (card only: builds the library). None = the
        version launches nothing."""
        return None

    # -- execution ---------------------------------------------------------
    def run(self, *args, version: str, config: Any, device, **kwargs) -> Any:
        """Run `version` under `config` (already resolved by dispatch;
        config may be None for versions that need none) on `device`."""
        raise NotImplementedError


# ---------------------------------------------------------------------------
# process-wide registry
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, Kernel] = {}
_BUILTINS_LOADED = False


def register(kernel: Kernel) -> Kernel:
    """Add a kernel to the registry (last registration wins, so tests can
    shadow a builtin). Returns the kernel."""
    if not kernel.name:
        raise ValueError("kernel.name must be set")
    if kernel.default_version not in kernel.versions:
        raise ValueError(f"{kernel.name}: default_version "
                         f"{kernel.default_version!r} not in versions")
    _REGISTRY[kernel.name] = kernel
    return kernel


def _ensure_builtins() -> None:
    """Import the builtin kernel families exactly once (deferred so the
    kernel_def modules can import repro_torch.tune without a cycle). The
    flag is only set on success."""
    global _BUILTINS_LOADED
    if _BUILTINS_LOADED:
        return
    from repro_torch.kernels.flash import kernel_def as _f  # noqa: F401
    from repro_torch.kernels.gpp import kernel_def as _g    # noqa: F401
    from repro_torch.kernels.paged import kernel_def as _p  # noqa: F401
    from repro_torch.kernels.ssm import kernel_def as _s    # noqa: F401
    _BUILTINS_LOADED = True


def get_kernel(name: str) -> Kernel:
    """Look up a registered Kernel descriptor by name — the object that
    knows a family's versions, problem keys, config space and model.
    Raises KeyError listing what IS registered for an unknown name.

    Example::

        import repro_torch
        gpp = repro_torch.get_kernel("gpp")
        gpp.versions            # ('v0', ..., 'v10')
        gpp.default_version     # 'v10'
    """
    _ensure_builtins()
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown kernel {name!r}; registered: "
                       f"{sorted(_REGISTRY)}") from None


def list_kernels() -> List[str]:
    """Sorted names of every registered kernel family (the builtins
    register lazily on first call).

    Example::

        import repro_torch
        repro_torch.list_kernels()    # ['flash', 'gpp', 'paged_decode', 'ssm']
    """
    _ensure_builtins()
    return sorted(_REGISTRY)


@backend.f32_accumulation()
def dispatch(name: str, *args, version: Optional[str] = None,
             config: Any = None, device=backend.DEFAULT_DEVICE,
             problem_key: Any = None, **kwargs) -> Any:
    """Run kernel `name` on `args` — the one public entry point for every
    registered kernel family.

    version=None uses the kernel's default; config=None resolves per
    version — the frozen static config (clamped) for static versions, the
    repro_torch.tune winner for tunable ones. device defaults to the card
    ('cuda') and raises RuntimeError when there is none; pass device='cpu'
    for the plain versions. Extra kwargs are the kernel's own; a name the
    kernel doesn't accept raises TypeError rather than being swallowed.

    problem_key: optional pre-built ProblemKey overriding the one derived
    from args (the tuner then keys and tunes for it).

    Example::

        import repro_torch
        from repro_torch.kernels.gpp import problem
        ach, asx = repro_torch.dispatch("gpp", problem.make_inputs(problem.SI214))
        ach, asx = repro_torch.dispatch("gpp", problem.make_inputs(problem.TINY),
                                        device="cpu")
    """
    k = get_kernel(name)
    version = version or k.default_version
    device = backend.resolve_device(device)
    if config is None:
        config = resolve_config(name, *args, version=version, device=device,
                                problem_key=problem_key, **kwargs)
    elif version not in k.versions:
        raise ValueError(f"unknown {k.name} version {version!r}; "
                         f"have {list(k.versions)}")
    return k.run(*args, version=version, config=config, device=device,
                 **kwargs)


def resolve_config(name: str, *args, version: Optional[str] = None,
                   device=backend.DEFAULT_DEVICE, problem_key: Any = None,
                   **kwargs) -> Any:
    """The config `dispatch` runs `version` under when given none: the
    repro_torch.tune winner for tunable versions, else (and for tunable
    ones at shapes the candidate menu can't tile) the clamped static
    config; None for versions that take no config."""
    k = get_kernel(name)
    version = version or k.default_version
    if version not in k.versions:
        raise ValueError(f"unknown {k.name} version {version!r}; "
                         f"have {list(k.versions)}")
    key = problem_key if problem_key is not None \
        else k.problem_key(*args, **kwargs)
    if version in k.tunable and k.config_space(key, version):
        from repro_torch.tune import tuner   # deferred: tune is optional here
        return tuner.tune_kernel(k.name, key, version=version,
                                 device=device).config
    config = k.static_config(key, version)
    if config is None and version in k.tunable:
        raise ValueError(f"no feasible {k.name} config for {key}")
    return config
