"""The GPP family: problem, oracles, v0-v5 variants, the Hopper kernels
(gpp_cuda.py over csrc/gpp.cu) and their registration (kernel_def.py)."""
