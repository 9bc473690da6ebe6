"""An instruction census of compiled SASS — the paper's instruction-level
roofline, read from what the card runs instead of modeled.

    text = disassemble(library_path)              # cuobjdump -sass (card machine)
    c = term_census(text, r"gpp_fused_kernelILi2ELi1ELb1E", rcp_per_term=2)
    s = loop_census(text, r"ssm_scan_kernelILi16ELi4E", "MUFU.EX2", 1)

`loop_census` finds one kernel's innermost loop that holds a marker
instruction, one or more per element of work (the selective scan's
MUFU.EX2, one per (t, c, n)), and counts its instructions by class per
element, with the warp shuffles (SHFL) apart. `term_census` is its GPP
form: it finds one kernel's innermost loop that holds a reciprocal
(`MUFU.RCP`) and ends in a backward branch — GPP's band loop — and counts
its instructions by opcode class. The loop may hold several (element,
band, iw) terms (EPT elements, NW frequencies, any unrolling); the caller
says how many reciprocals a term issues, and terms = MUFU.RCP / that.

The loop's static count includes, for each IEEE reciprocal or division,
the call stub of its slow path (MOV of the return address, CALL, and the
BRA back over the fast path), which the fast path branches around; the
census also gives the count without those stubs (`fast_path_per_term`),
what a term issues when no operand needs the slow path.

Classes: FFMA, FMUL, FADD, MUFU, SELECT (FSETP, FSEL, SEL, FMNMX, ISETP,
PLOP3, P2R/R2P), LDS, INT (IMAD, IADD3, LEA, LOP3, SHF, MOV, ...) and
CONTROL (BRA, BSSY, BSYNC, CALL, NOP, ...). The FMA ratio is the paper's:
FFMA over all FP32 arithmetic instructions (FFMA + FMUL + FADD).

Bounds at `terms` terms on a card (`core.hw.GpuSpec`):
  issue_bound_s  terms x instructions a term / (SMs x 4 schedulers x 32
                 lanes x clock): one warp instruction a scheduler a clock;
  mufu_bound_s   terms x MUFU a term / (SMs x 16 x clock): 16 MUFU results
                 an SM a clock.
"""

from __future__ import annotations

import collections
import os
import re
import shutil
import subprocess
from typing import Dict, List, Optional, Tuple

SCHEDULERS_PER_SM = 4
LANES_PER_WARP = 32
MUFU_PER_SM_CLOCK = 16

CLASSES = ("FFMA", "FMUL", "FADD", "MUFU", "SELECT", "LDS", "INT",
           "CONTROL", "OTHER")
_SELECT = {"FSETP", "FSEL", "SEL", "FMNMX", "ISETP", "PLOP3", "P2R", "R2P",
           "FCHK", "PSETP"}
_INT = {"IMAD", "IADD3", "IADD", "LEA", "LOP3", "LOP", "SHF", "SHL", "SHR",
        "MOV", "IABS", "IMNMX", "FLO", "POPC", "BREV", "PRMT", "S2R", "S2UR",
        "CS2R", "ULDC", "UMOV", "UIADD3", "ULEA", "ULOP3", "USHF", "UIMAD",
        "VOTEU", "I2F", "F2I", "F2F", "I2I", "IMUL", "ISCADD"}
_CONTROL = {"BRA", "BSSY", "BSYNC", "CALL", "RET", "EXIT", "NOP", "BAR",
            "WARPSYNC", "BMOV", "JMP", "BRX", "YIELD", "DEPBAR"}

# "        /*01a0*/                   @!P0 FFMA R3, R2, R5, R4 ;    /* 0x... */"
_LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?);")
_FUNC = re.compile(r"Function\s*:\s*(\S+)")
_TARGET = re.compile(r"0x([0-9a-f]+)")


def disassemble(library: str) -> Tuple[str, str]:
    """(SASS text of every kernel in `library`, the tool that made it):
    cuobjdump -sass, found on PATH or under the CUDA toolkit (card
    machine only; raises when the toolkit has none)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        raise RuntimeError("cuobjdump not found (it ships with the CUDA "
                           "toolkit)")
    proc = subprocess.run([tool, "-sass", library], capture_output=True,
                          text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"{tool} -sass {library} failed: "
                           f"{proc.stderr[-2000:]}")
    return proc.stdout, tool


def functions(text: str) -> Dict[str, List[Tuple[int, str]]]:
    """{mangled kernel name: [(address, instruction text up to its ';'),
    ...]} from cuobjdump -sass output."""
    out: Dict[str, List[Tuple[int, str]]] = {}
    current: Optional[List[Tuple[int, str]]] = None
    for line in text.splitlines():
        m = _FUNC.search(line)
        if m:
            current = out.setdefault(m.group(1), [])
            continue
        m = _LINE.search(line)
        if m and current is not None:
            current.append((int(m.group(1), 16), m.group(2).strip()))
    return out


def opcode(ins: str) -> str:
    """The opcode with its modifiers ('MUFU.RCP', 'FFMA.FTZ'), the guard
    predicate ('@P0', '@!PT') dropped."""
    parts = ins.split()
    if parts and parts[0].startswith("@"):
        parts = parts[1:]
    return parts[0] if parts else ""


def op_class(op: str) -> str:
    base = op.split(".")[0]
    if base in ("FFMA", "FMUL", "FADD", "MUFU", "LDS"):
        return base
    if base in _SELECT:
        return "SELECT"
    if base in _INT:
        return "INT"
    if base in _CONTROL:
        return "CONTROL"
    return "OTHER"


def loops(instrs: List[Tuple[int, str]]) -> List[Tuple[int, int]]:
    """(first, last) index ranges of the loops: each backward branch
    (a BRA whose target address is at or before its own) closes one."""
    index = {addr: i for i, (addr, _) in enumerate(instrs)}
    found = []
    for i, (addr, ins) in enumerate(instrs):
        if opcode(ins).split(".")[0] != "BRA":
            continue
        m = _TARGET.search(ins.split("BRA", 1)[1])
        if m is None:
            continue
        target = int(m.group(1), 16)
        if target <= addr and target in index:
            found.append((index[target], i))
    return found


def innermost_loop(instrs: List[Tuple[int, str]], must_hold: str = "MUFU.RCP"
                   ) -> List[Tuple[int, str]]:
    """The body of an innermost loop holding `must_hold` instructions (no
    other such loop inside it); of several (an unrolled loop and its
    remainder), the one with the most of them."""
    def held(lo, hi):
        return sum(opcode(ins) == must_hold for _, ins in instrs[lo:hi + 1])

    cands = [(lo, hi) for lo, hi in loops(instrs) if held(lo, hi)]
    inner = [(lo, hi) for lo, hi in cands
             if not any((a, b) != (lo, hi) and lo <= a and b <= hi
                        for a, b in cands)]
    if not inner:
        raise ValueError(f"no loop holds {must_hold}")
    lo, hi = max(inner, key=lambda r: (held(*r), -(r[1] - r[0])))
    return instrs[lo:hi + 1]


def count_classes(body: List[Tuple[int, str]]) -> Dict[str, int]:
    counts = collections.Counter(op_class(opcode(ins)) for _, ins in body)
    return {c: counts.get(c, 0) for c in CLASSES}


def slow_path_stubs(body: List[Tuple[int, str]]) -> int:
    """Instructions of the slow-path call stubs in `body`: each CALL with
    the MOV before it and the BRA after it."""
    n = 0
    for i, (_, ins) in enumerate(body):
        if opcode(ins).split(".")[0] == "CALL":
            n += 1
            n += i > 0 and opcode(body[i - 1][1]).split(".")[0] == "MOV"
            n += (i + 1 < len(body)
                  and opcode(body[i + 1][1]).split(".")[0] == "BRA")
    return n


def loop_census(text: str, kernel: str, marker: str,
                marker_per_element: int) -> Dict:
    """The census of the innermost loop holding `marker` instructions (e.g.
    MUFU.EX2) of the one kernel whose mangled name matches the regex
    `kernel`, per element of work, where one element issues
    `marker_per_element` of them: elements an iteration, total and
    per-class instructions an element, the shuffles (SHFL, classed OTHER)
    and MUFU an element, the FMA ratio and the raw counts. Also returns
    the loop body (`body`)."""
    funcs = {n: ins for n, ins in functions(text).items()
             if re.search(kernel, n)}
    if len(funcs) != 1:
        raise ValueError(f"{len(funcs)} kernels match {kernel!r}: "
                         f"{sorted(funcs)}")
    (name, instrs), = funcs.items()
    body = innermost_loop(instrs, must_hold=marker)
    counts = count_classes(body)
    marks = sum(opcode(ins) == marker for _, ins in body)
    if marks % marker_per_element:
        raise ValueError(f"{marks} {marker} in the loop is not a multiple of "
                         f"{marker_per_element} an element")
    elements = marks // marker_per_element
    shfl = sum(opcode(ins).split(".")[0] == "SHFL" for _, ins in body)
    fp32 = counts["FFMA"] + counts["FMUL"] + counts["FADD"]
    return {"kernel": name, "loop_instructions": len(body),
            "elements_per_iteration": elements,
            "instructions_per_element": len(body) / elements,
            "per_element": {c: n / elements for c, n in counts.items()},
            "shfl_per_element": shfl / elements,
            "mufu_per_element": counts["MUFU"] / elements,
            "fma_ratio": counts["FFMA"] / fp32 if fp32 else 0.0,
            "counts": counts, "shfl": shfl, "body": body}


def term_census(text: str, kernel: str, rcp_per_term: int) -> Dict:
    """The census of the innermost reciprocal loop of the one kernel whose
    mangled name matches the regex `kernel`: total and per-class
    instructions a term, the same without the slow-path call stubs, MUFU
    a term, the FMA ratio and the raw counts."""
    c = loop_census(text, kernel, "MUFU.RCP", rcp_per_term)
    terms = c["elements_per_iteration"]
    body = c["body"]
    return {"kernel": c["kernel"], "loop_instructions": len(body),
            "terms_per_iteration": terms,
            "instructions_per_term": len(body) / terms,
            "fast_path_per_term": (len(body) - slow_path_stubs(body)) / terms,
            "per_term": c["per_element"],
            "mufu_per_term": c["mufu_per_element"],
            "fma_ratio": c["fma_ratio"], "counts": c["counts"]}


def issue_bound_s(terms: float, instr_per_term: float, spec,
                  sms: Optional[int] = None) -> float:
    """Seconds to issue terms x instr_per_term lane-instructions at one
    warp instruction a scheduler a clock, on `sms` SMs (all the card's by
    default)."""
    rate = ((sms or spec.sms) * SCHEDULERS_PER_SM * LANES_PER_WARP
            * spec.boost_hz)
    return terms * instr_per_term / rate


def mufu_bound_s(terms: float, mufu_per_term: float, spec,
                 sms: Optional[int] = None) -> float:
    """Seconds for the SFUs to return terms x mufu_per_term results at 16
    an SM a clock, on `sms` SMs (all the card's by default)."""
    return terms * mufu_per_term / ((sms or spec.sms) * MUFU_PER_SM_CLOCK
                                    * spec.boost_hz)
