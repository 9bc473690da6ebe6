"""Model-then-measure tuner (tuner.py) over the Hopper config space
(space.py), timed by measure.py; the cache's hygiene (cache_tools.py,
`python -m repro_torch.tune validate|prune`)."""
