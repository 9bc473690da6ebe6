"""repro_torch: the port of `repro` to PyTorch and hand-written CUDA for
NVIDIA Hopper (H100). It imports torch and never jax, and nothing of the
JAX package `repro`, which stays the reference.

`import repro_torch` is the entry point; the public surface is lazy:

    dispatch(name, *args, version=, config=, device=, problem_key=)
        Run a registered kernel; config resolves from the tune cache.
        Runs on the card unless device='cpu' is passed.
    get_kernel(name) / list_kernels()
        The Kernel descriptor registry.
    tune_kernel(kernel, key, device=)
        Model-then-measure tuner; winners persist to kernel_tune_torch.json.
    run_journey(size, device=, measure=)
        The paper's Table I, v0-v10, measured on the card beside each
        version's modeled Hopper roofline (measure=False: modeled only).
    get_config(arch) / build_model(cfg)
        Model configs (a copy of the JAX package's) and the models of
        every family: dense, moe, ssm (rwkv6), hybrid (hymba), encdec
        (whisper) and vlm (internvl2) (init_params / loss_fn / prefill /
        decode_step / prefill_into_slot).
    ServeEngine(cfg, params, max_batch=, cache_len=, device=) / Request
        The slot-level continuous-batching server.

    import repro_torch
    from repro_torch.kernels.gpp import problem
    ach, asx = repro_torch.dispatch("gpp", problem.make_inputs(problem.SI214))
    rows = repro_torch.run_journey("si214")

    cfg = repro_torch.get_config("qwen2-1.5b")
    params = repro_torch.build_model(cfg).init_params(0)
    eng = repro_torch.ServeEngine(cfg, params, max_batch=4, cache_len=1024)
    out = eng.run([repro_torch.Request(rid=0, prompt=np.arange(300))])
"""

_EXPORTS = {
    "get_kernel": "repro_torch.kernels.api",
    "dispatch": "repro_torch.kernels.api",
    "list_kernels": "repro_torch.kernels.api",
    "tune_kernel": "repro_torch.tune.tuner",
    "run_journey": "repro_torch.core.journey",
    "get_config": "repro_torch.configs.base",
    "build_model": "repro_torch.models.registry",
    "ServeEngine": "repro_torch.serve.engine",
    "Request": "repro_torch.serve.engine",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    try:
        module = _EXPORTS[name]
    except KeyError:
        raise AttributeError(f"module 'repro_torch' has no attribute {name!r}"
                             ) from None
    import importlib
    value = getattr(importlib.import_module(module), name)
    globals()[name] = value        # cache: subsequent access skips __getattr__
    return value


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))
