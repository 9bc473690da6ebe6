"""Mesh construction for explicit SPMD (one process a mesh rank)."""
