"""Paged decode attention: the plain versions (paged.py), the three
hand-written Hopper entry points and their wrappers (paged_cuda.py over
csrc/paged_decode.cu) and the registry descriptor (kernel_def.py)."""
