"""repro_torch's kernel registry and device policy: the gpp parts of
tests/test_kernel_api.py for the port (unknown kernel and version, default
v10, stray kwargs, problem_key=, the clamped-static fallback at shapes the
tune menu cannot tile), dispatch on the card by default, the lazy public
surface, and that the port imports neither jax nor repro."""

import ast
import dataclasses
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch import backend
from repro_torch.kernels import api
from repro_torch.kernels.gpp import gpp_cuda, problem, ref
from repro_torch.tune import tuner

RTOL = 5e-5


def _rel(a, b):
    return float(np.max(np.abs(np.asarray(a) - b)) / np.max(np.abs(b)))


def test_gpp_registered():
    assert api.list_kernels() == ["flash", "gpp", "paged_decode", "ssm"]
    k = api.get_kernel("gpp")
    assert k.versions == ("v0", "v1", "v2", "v3", "v4", "v5", "v6", "v7",
                          "v8", "v9", "v10")
    assert k.default_version == "v10"
    assert k.tunable == ("v10",)


def test_unknown_kernel_and_version():
    with pytest.raises(KeyError):
        api.get_kernel("nope")
    inp = problem.make_inputs(problem.TINY)
    with pytest.raises(ValueError):
        api.dispatch("gpp", inp, version="v99", device="cpu")
    with pytest.raises(ValueError):
        api.dispatch("gpp", inp, version="v99", device="cpu",
                     config=gpp_cuda.V9)


def test_register_validates():
    class Bad(api.Kernel):
        name = "bad"
        versions = ("a",)
        default_version = "b"
    with pytest.raises(ValueError):
        api.register(Bad())
    with pytest.raises(ValueError):
        api.register(api.Kernel())


@pytest.mark.parametrize("version", list(api.get_kernel("gpp").versions))
def test_dispatch_every_version_on_cpu(version):
    inp = problem.make_inputs(problem.TINY, seed=3)
    ach, asx = ref.ref_numpy(inp)
    a, x = api.dispatch("gpp", inp, version=version, device="cpu")
    assert a.dtype == torch.complex64 and a.device.type == "cpu"
    assert _rel(a, ach) < RTOL and _rel(x, asx) < RTOL


def test_default_is_tuned_v10(tmp_path, monkeypatch):
    monkeypatch.setenv(tuner.CACHE_ENV, str(tmp_path))
    tuner.clear_memo()
    size = problem.GppSize("d", nbands=8, ngpown=32, ncouls=64)
    inp = problem.make_inputs(size, seed=1)
    ach, asx = ref.ref_numpy(inp)
    a, x = api.dispatch("gpp", inp, device="cpu")
    assert _rel(a, ach) < RTOL and _rel(x, asx) < RTOL
    key = tuner.cache_key_for("gpp", size, "cpu", "v10")
    assert any(mk[1] == key for mk in tuner._MEMO)
    assert api.resolve_config("gpp", inp, device="cpu").name == "v10"


def test_dispatch_rejects_stray_kwargs():
    inp = problem.make_inputs(problem.TINY)
    with pytest.raises(TypeError):
        api.dispatch("gpp", inp, blk_ig=32, device="cpu")
    with pytest.raises(TypeError):
        api.dispatch("gpp", inp, version="v5", interpret=True, device="cpu")


def test_problem_key_override(tmp_path, monkeypatch):
    """problem_key= keys and tunes for the given problem instead of the
    one the arguments imply."""
    monkeypatch.setenv(tuner.CACHE_ENV, str(tmp_path))
    tuner.clear_memo()
    big = problem.GppSize("big", nbands=16, ngpown=64, ncouls=128)
    small = problem.GppSize("small", nbands=8, ngpown=32, ncouls=64)
    inp = problem.make_inputs(big, seed=2)
    ach, asx = ref.ref_numpy(inp)
    a, x = api.dispatch("gpp", inp, device="cpu", problem_key=small)
    assert _rel(a, ach) < RTOL and _rel(x, asx) < RTOL
    keys = {mk[1] for mk in tuner._MEMO}
    assert tuner.cache_key_for("gpp", small, "cpu", "v10") in keys
    assert tuner.cache_key_for("gpp", big, "cpu", "v10") not in keys


def test_dispatch_odd_shapes_fall_back_to_clamped_static():
    """Shapes the tune menu cannot tile (ngpown < 32: empty space) still
    dispatch v10, through v9's blocks clamped to the problem."""
    k = api.get_kernel("gpp")
    for size in (problem.TINY, problem.GppSize("s2", nbands=16, ngpown=4,
                                               ncouls=128)):
        assert k.config_space(size, "v10") == []
        inp = problem.make_inputs(size, seed=5)
        cfg = api.resolve_config("gpp", inp, device="cpu")
        assert cfg == dataclasses.replace(gpp_cuda.V9.clamped(size), name="v10")
        a, x = api.dispatch("gpp", inp, device="cpu")
        ach, asx = ref.ref_numpy(inp)
        assert _rel(a, ach) < RTOL and _rel(x, asx) < RTOL


def test_dispatch_defaults_to_the_card_and_raises_without_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    inp = problem.make_inputs(problem.TINY)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        api.dispatch("gpp", inp)
    with pytest.raises(RuntimeError):
        repro_torch.dispatch("gpp", inp, version="v5")
    with pytest.raises(RuntimeError):
        backend.device_tag()
    assert backend.resolve_device("cpu").type == "cpu"
    assert backend.device_tag("cpu") == "cpu"
    with pytest.raises(ValueError):
        backend.resolve_device("meta")


def test_public_surface():
    assert set(repro_torch.__all__) == {"dispatch", "get_kernel",
                                        "list_kernels", "run_journey",
                                        "tune_kernel", "get_config",
                                        "build_model", "ServeEngine",
                                        "Request"}
    assert repro_torch.dispatch is api.dispatch
    assert repro_torch.get_kernel is api.get_kernel
    with pytest.raises(AttributeError):
        repro_torch.not_a_symbol
    for name in repro_torch.__all__:
        doc = getattr(repro_torch, name).__doc__ or ""
        assert len(doc.strip()) > 80, name
        assert "Example" in doc, name


IMPORT_GUARD = r"""
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for n in names:
    importlib.import_module(n)
for name in repro_torch.__all__:
    getattr(repro_torch, name)
bad = sorted(m for m in sys.modules
             if m in ("jax", "repro", "ml_dtypes")
             or m.startswith(("jax.", "repro.", "ml_dtypes.")))
print(len(names), bad)
"""


ROOT = pathlib.Path(__file__).resolve().parent.parent


def _imported_roots(path: pathlib.Path):
    """Top-level names of every import statement in one source file."""
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            roots.add(node.module.split(".")[0])
    return roots


def test_port_imports_neither_jax_nor_repro():
    """In a fresh interpreter, importing repro_torch and every submodule
    that pkgutil.walk_packages finds — which must be every .py file of the
    package — leaves `jax`, `repro` and `ml_dtypes` (the exact names, and
    their submodules) out of sys.modules: the card's machine has none of
    them. No source file of the package, and not chip_smoke.py, names any
    of them in an import statement."""
    src = ROOT / "src"
    r = subprocess.run([sys.executable, "-c", IMPORT_GUARD],
                       capture_output=True, text=True, timeout=300,
                       env=dict(os.environ, PYTHONPATH=str(src)))
    assert r.returncode == 0, r.stderr
    count, bad = r.stdout.strip().split(" ", 1)
    files = sorted((src / "repro_torch").rglob("*.py"))
    modules = [f for f in files if f.name != "__init__.py" or
               f.parent != src / "repro_torch"]
    assert int(count) == len(modules) >= 40
    assert bad == "[]", bad
    for f in files + [ROOT / "chip_smoke.py"]:
        assert not _imported_roots(f) & {"jax", "jaxlib", "repro",
                                         "ml_dtypes"}, f
