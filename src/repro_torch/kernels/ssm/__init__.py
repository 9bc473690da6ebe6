"""The selective-scan (ssm) family: the hand-written Hopper kernel and its
plain version (ssm_cuda.py over csrc/ssm_scan.cu), the registry
descriptor (kernel_def.py) and the op layer (ops.py)."""
