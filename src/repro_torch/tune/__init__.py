"""Model-then-measure tuner (tuner.py) over the Hopper config space
(space.py), timed by measure.py; the cache's hygiene (cache_tools.py,
`python -m repro_torch.tune validate|prune`). The names the JAX
package's `repro.tune` exports, with the GPP shorthands `rank`, `tune`
and `best_config`."""

from repro_torch.tune.space import candidates
from repro_torch.tune.tuner import (TunedConfig, best_config, cache_key_for,
                                    rank, rank_kernel, tune, tune_kernel)

__all__ = ["candidates", "rank", "rank_kernel", "tune", "tune_kernel",
           "best_config", "cache_key_for", "TunedConfig"]
