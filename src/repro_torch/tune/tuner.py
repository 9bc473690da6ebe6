"""Model-then-measure config tuner with a persisted JSON cache — the port
of `repro.tune.tuner`.

  1. `rank_kernel(kernel, key)` — enumerate the kernel's feasible config
     space and sort it by the kernel's model (for gpp:
     core.gpu_model.step_s on the device's card spec).
  2. `tune_kernel(kernel, key)` — on the card, time the model's top-K
     and the version's static config (so a tuned version is never slower
     than the frozen one) with CUDA events (tune.measure) and let
     measurement pick. On the CPU the model's pick stands unless
     measure_mode=True asks for timing of the plain versions.
  3. The winner is persisted to `<cache_dir>/kernel_tune_torch.json`,
     keyed `kernel|dims|device tag|version` (backend.device_tag), so a
     winner picked on the CPU is never served on the card. The file is
     the port's own: the JAX package's kernel_tune.json is neither read
     nor written. Cache dir: $REPRO_TUNE_CACHE, else ./runs/tune.

An in-process memo sits in front of the JSON file; `clear_memo()` resets it.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
from typing import Any, Dict, List, Optional, Tuple

from repro_torch import backend
from repro_torch.tune import measure

CACHE_ENV = "REPRO_TUNE_CACHE"
CACHE_FILE = "kernel_tune_torch.json"

_MEMO: Dict[Tuple[str, str], "TunedConfig"] = {}


@dataclasses.dataclass(frozen=True)
class TunedConfig:
    config: Any                      # kernel-specific (BlockConfig, ...)
    modeled_s: float
    measured_s: Optional[float]      # None when the measurement pass skipped
    key: str
    source: str                      # "model" | "measured" | "cache"
    kernel: str = "gpp"
    # this process's measurement pass, not persisted: the number of ranked
    # candidates and (config, measured_s, modeled_s) of each timed one
    ranked: int = 0
    timings: Tuple = ()

    def to_json(self) -> Dict:
        from repro_torch.kernels import api
        return {"kernel": self.kernel,
                "config": api.get_kernel(self.kernel).config_to_json(self.config),
                "modeled_s": self.modeled_s, "measured_s": self.measured_s,
                "key": self.key, "source": self.source}

    @staticmethod
    def from_json(d: Dict) -> "TunedConfig":
        from repro_torch.kernels import api
        kernel = d["kernel"]
        return TunedConfig(
            config=api.get_kernel(kernel).config_from_json(d["config"]),
            modeled_s=d["modeled_s"], measured_s=d.get("measured_s"),
            key=d["key"], source="cache", kernel=kernel)


def cache_key_for(kernel: str, key, tag: str, version: str) -> str:
    """The cache key: (kernel, ProblemKey dims, device tag, version)."""
    return f"{kernel}|{key.key_dims()}|{tag}|{version}"


def _cache_path(cache_dir: Optional[str]) -> str:
    root = cache_dir or os.environ.get(CACHE_ENV, os.path.join("runs", "tune"))
    return os.path.join(root, CACHE_FILE)


def _load_cache(cache_dir: Optional[str]) -> Dict:
    try:
        with open(_cache_path(cache_dir)) as fh:
            return json.load(fh)
    except (OSError, ValueError):
        return {}


def _store_cache(cache_dir: Optional[str], entries: Dict) -> None:
    path = _cache_path(cache_dir)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    # atomic replace: a crashed writer never leaves a truncated cache
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path), suffix=".tmp")
    with os.fdopen(fd, "w") as fh:
        json.dump(entries, fh, indent=1, sort_keys=True)
    os.replace(tmp, path)


def clear_memo() -> None:
    _MEMO.clear()


def rank_kernel(kernel: str, key, *, version: Optional[str] = None,
                device="cpu") -> List[Tuple[Any, float]]:
    """Feasible configs for (kernel, key) sorted by the kernel's modeled
    time on `device`'s card (deterministic tie-break via Kernel.tie_break)."""
    from repro_torch.kernels import api
    k = api.get_kernel(kernel)
    version = version or k.default_version
    scored = [(cfg, k.model_step_s(key, cfg, version, device))
              for cfg in k.config_space(key, version)]
    scored.sort(key=lambda ct: (ct[1],) + tuple(k.tie_break(ct[0])))
    return scored


def tune_kernel(kernel: str, key, *, version: Optional[str] = None,
                device=backend.DEFAULT_DEVICE,
                measure_mode: Optional[bool] = None, top_k: int = 6,
                warmup: int = 1, reps: int = 3,
                cache_dir: Optional[str] = None) -> TunedConfig:
    """Pick the best config for (kernel, key, device, version): rank the
    kernel's feasible configs by its model, then (when measuring) time the
    top_k, and the version's static config where it is feasible, on
    synthetic inputs on `device` and keep the fastest.

    measure_mode: None (default) measures on the card and not on the CPU;
    True/False force it. The result is memoized in-process and persisted
    to the JSON cache; TunedConfig.source records which path chose it
    (model | measured | cache).

    Example::

        import repro_torch
        from repro_torch.kernels.gpp import problem
        tc = repro_torch.tune_kernel("gpp", problem.SI214)     # on the card
        tc.config, tc.measured_s, tc.key
        tc = repro_torch.tune_kernel("gpp", problem.BENCH, device="cpu")
        tc.source                                              # 'model'
    """
    from repro_torch.kernels import api
    k = api.get_kernel(kernel)
    version = version or k.default_version
    device = backend.resolve_device(device)
    ckey = cache_key_for(kernel, key, backend.device_tag(device), version)
    # memo per cache *file*, not just per key
    memo_key = (os.path.abspath(_cache_path(cache_dir)), ckey)

    if memo_key in _MEMO:
        return _MEMO[memo_key]
    disk = _load_cache(cache_dir)
    if ckey in disk:
        try:
            tc = TunedConfig.from_json(disk[ckey])
        except (KeyError, TypeError):
            pass    # schema-stale entry -> fall through and re-tune
        else:
            _MEMO[memo_key] = tc
            return tc

    ranked = rank_kernel(kernel, key, version=version, device=device)
    if not ranked:
        raise ValueError(f"no feasible {kernel} config for {key}")

    do_measure = (measure_mode if measure_mode is not None
                  else device.type == "cuda")
    best_cfg, best_model_s = ranked[0]
    measured_s = None
    timed = []
    if do_measure and top_k > 0:
        args, kwargs = k.make_example(key, device=device)
        to_time = ranked[:top_k]
        static = k.static_config(key, version)
        if static is not None:
            stamp = k.finalize_config(static, version)
            to_time += [ct for ct in ranked[top_k:]
                        if k.finalize_config(ct[0], version) == stamp][:1]
        for cfg, model_s in to_time:
            t = measure.time_callable(
                lambda cfg=cfg: k.run(*args, version=version, config=cfg,
                                      device=device, **kwargs),
                device=device, warmup=warmup, reps=reps)
            timed.append((cfg, t, model_s))
        best_cfg, measured_s, best_model_s = min(timed, key=lambda x: x[1])

    tc = TunedConfig(config=k.finalize_config(best_cfg, version),
                     modeled_s=best_model_s, measured_s=measured_s, key=ckey,
                     source="measured" if measured_s is not None else "model",
                     kernel=kernel, ranked=len(ranked), timings=tuple(timed))
    _MEMO[memo_key] = tc
    disk = _load_cache(cache_dir)
    disk[ckey] = tc.to_json()
    _store_cache(cache_dir, disk)
    return tc
