"""The port's dry-run (`repro_torch.launch.specs`, `launch.dryrun`)
held to the JAX package's on the CPU.

  * `input_specs` against `repro.launch.specs.input_specs`: every leaf's
    shape and dtype, for every arch x applicable shape;
  * in one subprocess (the reference's dryrun module forces 512 host
    devices at import, so it never enters this process):
    `model_flops_for_cell`, `auto_microbatches`, `flash_adjustment` at
    the reference's blk_q 256 and `ssm_kernel_adjustment` for every cell
    on both production meshes, and the state bytes a rank against the
    reference's `_donated_bytes`, to the byte but in the cells named in
    ADAFACTOR_FSDP_CELLS (the reason beside it);
  * the refused FSDP-prefix plan: the CLI prints FAIL with
    `sharding.data_dims`' words and exits 1;
  * one full-width cell, qwen2-1.5b decode_32k on (16, 16): its row
    carries every key of the reference's row, and its census what the
    plan implies.
"""

import ast
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from repro_torch.configs.base import (ARCH_IDS, SHAPES, applicable_shapes,
                                      get_config)
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import abstract_mesh, production_shape
from repro_torch.train import step as step_lib

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELLS = [(a, s) for a in ARCH_IDS for s in applicable_shapes(get_config(a))]
# the port's names for the reference's MXU columns
RENAMED = {"mxu_frac": "tc_frac"}
# The train cells whose state differs from the reference's: FSDP beside a
# model axis with Adafactor (qwen2.5-32b, internvl2-26b). The port's
# factored stats keep their param's spec without the reduced dim
# (sharding.opt_state_specs); the reference recomputes spec_for on each
# stat's own shape, which splits some of them further: the port holds a
# few MB more a rank (values and checkpoints are the same).
ADAFACTOR_FSDP_CELLS = {("qwen2_5_32b", "train_4k"),
                        ("internvl2_26b", "train_4k")}

REF_SCRIPT = r'''
import json, sys
from repro.launch import dryrun as D
from repro.configs.base import ARCH_IDS, SHAPES, applicable_shapes, get_config
from repro.launch.mesh import make_production_mesh
from repro.train import step as step_lib
out = {}
for mp in (False, True):
    mesh = make_production_mesh(multi_pod=mp)
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for sh in applicable_shapes(cfg):
            plan = step_lib.make_plan(cfg, mesh, kind=SHAPES[sh].kind)
            out[f"{arch}|{sh}|{int(mp)}"] = dict(
                flops=D.model_flops_for_cell(cfg, sh),
                mb=D.auto_microbatches(cfg, SHAPES[sh], mesh),
                flash=D.flash_adjustment(cfg, sh, mesh, plan),
                ssm=D.ssm_kernel_adjustment(cfg, sh, mesh),
                donated=D._donated_bytes(arch, sh, mesh, plan))
json.dump(out, sys.stdout)
'''


def _leaves(tree, pre=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{pre}/{k}" if pre else k))
        return out
    return {pre: tree}


@pytest.mark.parametrize("arch,shape", CELLS)
def test_input_specs_match_reference(arch, shape):
    """Every leaf of the cell's abstract inputs (batch, and a decode
    cell's cache) has the reference's shape and dtype; the port's sit on
    the "meta" device."""
    from repro.configs.base import get_config as jget_config
    from repro.launch.specs import input_specs as jinput_specs
    from repro_torch.launch.specs import input_specs
    got = input_specs(get_config(arch), shape)
    want = jinput_specs(jget_config(arch), shape)
    assert got["kind"] == want["kind"] == SHAPES[shape].kind
    assert sorted(got) == sorted(want)
    for part in ("batch", "cache"):
        if part not in want:
            continue
        g, w = _leaves(got[part]), _leaves(want[part])
        assert sorted(g) == sorted(w)
        for path, t in g.items():
            assert t.device.type == "meta"
            assert tuple(t.shape) == tuple(w[path].shape), path
            assert str(t.dtype).replace("torch.", "") == \
                np.dtype(w[path].dtype).name, path


@pytest.fixture(scope="module")
def reference_cells():
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(REPO, "src"))
    res = subprocess.run([sys.executable, "-c", REF_SCRIPT], env=env,
                         capture_output=True, text=True, timeout=300,
                         cwd=REPO)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout)


def test_cell_helpers_match_reference(reference_cells):
    """model_flops_for_cell, auto_microbatches, flash_adjustment (blk_q
    256, the reference's q block) and ssm_kernel_adjustment equal the
    reference's for every cell on (16, 16) and (2, 16, 16); the state
    bytes a rank equal `_donated_bytes` to the byte in every cell but
    ADAFACTOR_FSDP_CELLS', where they stay within 5%."""
    assert len(reference_cells) == 2 * len(CELLS)
    differ = set()
    for key, ref in reference_cells.items():
        arch, sh, mp = key.split("|")
        cfg = get_config(arch)
        mesh = abstract_mesh(production_shape(bool(int(mp))))
        plan = step_lib.make_plan(cfg, mesh, kind=SHAPES[sh].kind)
        assert dryrun.model_flops_for_cell(cfg, sh) == ref["flops"], key
        assert dryrun.auto_microbatches(cfg, SHAPES[sh], mesh) == \
            ref["mb"], key
        assert dryrun.flash_adjustment(cfg, sh, mesh, plan, blk_q=256) == \
            ref["flash"], key
        assert dryrun.ssm_kernel_adjustment(cfg, sh, mesh) == ref["ssm"], \
            key
        got = dryrun.donated_bytes(arch, sh, mesh)
        if got != ref["donated"]:
            differ.add((arch, sh))
            assert abs(got - ref["donated"]) <= 0.05 * ref["donated"], key
    assert differ == ADAFACTOR_FSDP_CELLS


def test_fsdp_prefix_plan_is_refused(capsys):
    """qwen2-1.5b's train cell with fsdp=True on (2, 16, 16) splits a dim
    over ('model', 'pod'), a strict prefix of the data axes: the plan is
    refused by sharding.data_dims, the cell prints FAIL with its words and
    the run exits 1."""
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "qwen2-1.5b", "--shape", "train_4k",
                     "--multi-pod", "--fsdp", "1"])
    assert e.value.code == 1
    out = capsys.readouterr().out
    assert "FAIL [qwen2-1.5b x train_4k multi_pod=True]" in out
    assert "a leaf split over the data axes ('pod', 'data') on one dim" \
        in out


def _reference_row_keys():
    """The keys of the reference's dry-run row, read from its source (no
    import: the module forces 512 host devices): RooflineReport.row()'s
    and run_cell's row.update(...)'s."""
    def read(rel):
        with open(os.path.join(REPO, "src", "repro", rel)) as fh:
            return ast.parse(fh.read())

    keys = set()
    for node in ast.walk(read("core/roofline.py")):
        if isinstance(node, ast.FunctionDef) and node.name == "row":
            for d in ast.walk(node):
                if isinstance(d, ast.Dict):
                    keys |= {k.value for k in d.keys}
    for node in ast.walk(read("launch/dryrun.py")):
        if (isinstance(node, ast.Call) and isinstance(node.func,
                                                      ast.Attribute)
                and node.func.attr == "update"):
            keys |= {kw.arg for kw in node.keywords}
    return keys


def test_full_width_decode_cell_row():
    """qwen2-1.5b decode_32k on (16, 16), uncut: the row has every key of
    the reference's (mxu_frac as tc_frac), fits the card, and its census
    counts what the decode plan implies: the cache's seq dim over the
    model axis (a rank's 1/16 of 32,768 lines of its 8 rows), each layer's
    flash decode (3 all-reduces), wo's and the FFN's sums and the
    embedding's, the gathers of q, k, v and the logits."""
    cfg = get_config("qwen2-1.5b")
    row = dryrun.run_cell("qwen2-1.5b", "decode_32k", multi_pod=False,
                          save=False, verbose=False)
    want = _reference_row_keys()
    assert len(want) > 20
    missing = {k for k in want if RENAMED.get(k, k) not in row}
    assert not missing, missing
    assert row["fits_hbm"] and row["modeled"] and row["kv_seq_shard"]
    assert row["mesh"] == "16x16" and row["chips"] == 256
    layers = cfg.n_layers
    model = row["collectives_by_group"]["model"]["calls"]
    assert model == {"all_reduce": 5 * layers + 1,
                     "all_gather": 3 * layers + 1}
    cache_lines = 32768 // 16 * (128 // 16)
    kv = 2 * layers * cache_lines * cfg.n_kv_heads * cfg.head_dim * 2
    assert round(row["donated_gib"] * 2 ** 30) == kv + 4     # and pos
    assert row["hbm_gib_per_chip"] > row["donated_gib"]
