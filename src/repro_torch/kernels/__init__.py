"""Kernel layer: the registry (api.py), the build of the CUDA sources
(_build.py) and one package per kernel family."""
