"""Model-then-measure tuner (tuner.py) over the Hopper config space
(space.py), timed by measure.py."""
