"""Device policy: one place that turns a caller's `device=` into a torch
device, and names the device for the tune cache.

The entry points run on the card unless the caller asks for the CPU. A
request for the card on a machine without one raises; nothing falls back
to the CPU. Whether a kernel or its plain version runs is decided by the
device of the tensors a wrapper is given (a CUDA tensor launches the
kernel, a CPU tensor takes the plain version), so there is no override
switch like the JAX package's REPRO_INTERPRET.

The numerics contract: the JAX package's bf16 matmuls accumulate in f32
(`preferred_element_type`) and its f32 matmuls are full f32. On the card
PyTorch's defaults let cuBLAS reduce bf16 partial sums in bf16
(`torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction` is
True), and a caller may turn TF32 on. So the port's entry points
(`Model`'s loss_fn, prefill, decode_step and prefill_into_slot, the train
step, `ServeEngine.step`, `Trainer.run`, `api.dispatch`) run under
`f32_accumulation()`, which turns both off and gives the caller's values
back on exit.
"""

from __future__ import annotations

import contextlib

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device=DEFAULT_DEVICE) -> torch.device:
    """torch.device for `device` ('cuda' when None). Raises RuntimeError
    when the card is asked for and CUDA is not available."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but CUDA is not available; "
            "pass device='cpu' to run the plain versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r}")
    return dev


def device_tag(device=DEFAULT_DEVICE) -> str:
    """Cache-key name of a device: 'cpu', or 'cuda:<name>:sm<major><minor>'
    for a card (e.g. 'cuda:NVIDIA H100 80GB HBM3:sm90'), so a winner picked
    on one device is never served on another."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return "cpu"
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    major, minor = torch.cuda.get_device_capability(index)
    return f"cuda:{torch.cuda.get_device_name(index)}:sm{major}{minor}"


@contextlib.contextmanager
def f32_accumulation():
    """While open (a `with` block, or a decorator: @f32_accumulation()),
    bf16 matmuls on the card reduce in f32 and f32 matmuls run in full
    f32: allow_bf16_reduced_precision_reduction and allow_tf32 of
    torch.backends.cuda.matmul are False. The caller's values are put
    back on exit; nesting is fine. The flags touch only CUDA matmuls."""
    m = torch.backends.cuda.matmul
    saved = (m.allow_bf16_reduced_precision_reduction, m.allow_tf32)
    m.allow_bf16_reduced_precision_reduction = False
    m.allow_tf32 = False
    try:
        yield
    finally:
        m.allow_bf16_reduced_precision_reduction, m.allow_tf32 = saved
