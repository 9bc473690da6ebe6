"""The SASS instruction census (repro_torch.core.sass) on inline fixtures
in cuobjdump's format: kernels split by their headers, opcodes stripped of
guard predicates, classes, the loops closed by backward branches, the
innermost reciprocal loop (also when an unrolled loop sits beside its
remainder), the slow-path call stubs, the per-term census with the
paper's FMA ratio, and the issue and MUFU bounds on the H100 spec. The
census of the built kernel itself runs on the card (chip_smoke.py)."""

import pytest

from repro_torch.core import hw, sass

# gpp_fused-like: an outer loop over band chunks holding the band loop,
# whose body is two terms (one MUFU.RCP each here); then a second kernel
FIXTURE = """
	code for sm_90a
		Function : _ZN12_GLOBAL__N_116gpp_fused_kernelILi2ELi1ELb1EEEv4Args
	.headerflags	@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS"
        /*0000*/                   LDC R1, c[0x0][0x28] ;                    /* 0x00000a00ff017b82 */
                                                                             /* 0x000fe20000000800 */
        /*0010*/                   S2R R0, SR_TID.X ;                        /* 0x0000000000007919 */
        /*0020*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;
        /*0030*/                   LDS.64 R4, [R2] ;
        /*0040*/                   FADD R5, R4, -R3 ;
        /*0050*/                   FFMA R6, R5, R5, R7 ;
        /*0060*/                   MUFU.RCP R8, R6 ;
        /*0070*/                   FFMA R9, R6, R8, -1 ;
        /*0080*/                   FMUL R10, R9, R8 ;
        /*0090*/                   FSETP.GEU.AND P0, PT, R10, 16, PT ;
        /*00a0*/               @!P0 FSEL R11, R10, RZ, !P0 ;
        /*00b0*/                   FADD R5, R4, -R12 ;
        /*00c0*/                   FFMA R6, R5, R5, R7 ;
        /*00d0*/                   MUFU.RCP R8, R6 ;
        /*00e0*/                   FFMA R9, R6, R8, -1 ;
        /*00f0*/                   IADD3 R2, R2, 0x4, RZ ;
        /*0100*/                   ISETP.NE.AND P1, PT, R2, R13, PT ;
        /*0110*/               @P1 BRA 0x30 ;
        /*0120*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;
        /*0130*/               @P2 BRA 0x20 ;
        /*0140*/                   EXIT ;
        /*0150*/                   BRA 0x150;
		Function : _ZN12_GLOBAL__N_117gpp_banded_kernelILi2ELi1ELb1EEEv4Args
        /*0000*/                   MUFU.RCP R8, R6 ;
        /*0010*/                   BRA 0x0 ;
"""


def test_functions_split_by_kernel():
    funcs = sass.functions(FIXTURE)
    assert len(funcs) == 2
    fused = funcs["_ZN12_GLOBAL__N_116gpp_fused_kernelILi2ELi1ELb1EEEv4Args"]
    assert len(fused) == 22 and fused[0] == (0, "LDC R1, c[0x0][0x28]")
    assert fused[10] == (0xa0, "@!P0 FSEL R11, R10, RZ, !P0")


@pytest.mark.parametrize("ins,op,cls", [
    ("@!P0 FSEL R11, R10, RZ, !P0", "FSEL", "SELECT"),
    ("MUFU.RCP R8, R6", "MUFU.RCP", "MUFU"),
    ("FFMA.FTZ R6, R5, R5, R7", "FFMA.FTZ", "FFMA"),
    ("LDS.64 R4, [R2]", "LDS.64", "LDS"),
    ("@P1 BRA 0x30", "BRA", "CONTROL"),
    ("IMAD.MOV.U32 R1, RZ, RZ, R2", "IMAD.MOV.U32", "INT"),
    ("ISETP.NE.AND P1, PT, R2, R13, PT", "ISETP.NE.AND", "SELECT"),
    ("STG.E [R2.64], R4", "STG.E", "OTHER")])
def test_opcode_and_class(ins, op, cls):
    assert sass.opcode(ins) == op
    assert sass.op_class(op) == cls


def test_loops_and_the_innermost_reciprocal_loop():
    fused = sass.functions(FIXTURE)[
        "_ZN12_GLOBAL__N_116gpp_fused_kernelILi2ELi1ELb1EEEv4Args"]
    # the band loop (0x30..0x110), the chunk loop (0x20..0x130) and the
    # trap loop after EXIT
    assert sorted(sass.loops(fused)) == [(2, 19), (3, 17), (21, 21)]
    body = sass.innermost_loop(fused)
    assert (body[0][0], body[-1][0]) == (0x30, 0x110)
    with pytest.raises(ValueError):
        sass.innermost_loop(fused, must_hold="MUFU.EX2")


def test_unrolled_loop_beside_its_remainder():
    text = """
		Function : k
        /*0000*/                   MUFU.RCP R1, R2 ;
        /*0010*/                   MUFU.RCP R1, R2 ;
        /*0020*/               @P0 BRA 0x0 ;
        /*0030*/                   MUFU.RCP R1, R2 ;
        /*0040*/               @P1 BRA 0x30 ;
        /*0050*/                   EXIT ;
"""
    instrs = sass.functions(text)["k"]
    assert sass.loops(instrs) == [(0, 2), (3, 4)]
    body = sass.innermost_loop(instrs)
    assert len(body) == 3                       # the unrolled one, 2 RCP


def test_term_census_and_fma_ratio():
    c = sass.term_census(FIXTURE, r"gpp_fused_kernelILi2ELi1ELb1E",
                         rcp_per_term=1)
    assert c["loop_instructions"] == 15 and c["terms_per_iteration"] == 2
    assert c["instructions_per_term"] == 7.5
    assert c["counts"] == {"FFMA": 4, "FMUL": 1, "FADD": 2, "MUFU": 2,
                           "SELECT": 3, "LDS": 1, "INT": 1, "CONTROL": 1,
                           "OTHER": 0}
    assert c["fma_ratio"] == 4 / 7
    assert c["mufu_per_term"] == 1.0
    with pytest.raises(ValueError):          # 2 reciprocals, 3 a term
        sass.term_census(FIXTURE, r"gpp_fused_kernel", rcp_per_term=3)
    with pytest.raises(ValueError):          # two kernels match
        sass.term_census(FIXTURE, r"gpp_", rcp_per_term=1)


def test_slow_path_call_stubs_are_counted_apart():
    text = """
		Function : k
        /*0000*/                   FFMA R0, R1, R1, R2 ;
        /*0010*/                   ISETP.GT.U32.AND P0, PT, R3, 0x1ffffff, PT ;
        /*0020*/               @P0 BRA 0x60 ;
        /*0030*/                   MOV R2, 0x50 ;
        /*0040*/                   CALL.REL.NOINC 0x200 ;
        /*0050*/                   BRA 0x70 ;
        /*0060*/                   MUFU.RCP R4, R0 ;
        /*0070*/               @P1 BRA 0x0 ;
"""
    c = sass.term_census(text, "k", rcp_per_term=1)
    assert c["instructions_per_term"] == 8
    assert c["fast_path_per_term"] == 5
    assert c["counts"]["CONTROL"] == 4 and c["counts"]["INT"] == 1


def test_issue_and_mufu_bounds():
    spec = hw.H100_SXM5
    terms = 1024 * 1024 * 8192 * 2                # Si-214's (ig, igp, band, iw)
    issue = sass.issue_bound_s(terms, 71.0, spec)
    assert issue == pytest.approx(terms * 71 / (132 * 4 * 32 * 1.98e9))
    assert issue == pytest.approx(36.45e-3, rel=1e-3)
    assert sass.mufu_bound_s(terms, 3.0, spec) == pytest.approx(
        terms * 3 / (132 * 16 * 1.98e9))


# ssm_scan-like: a step loop of two (t, c, n) elements (S = 2 states, one
# MUFU.EX2 each) with a butterfly stage, in the S = 4 bf16 instance; the
# f32-params instance and the one-state kernel's name beside it
SCAN_FIXTURE = """
		Function : _ZN12_GLOBAL__N_115ssm_scan_kernelILi16ELi4E13__nv_bfloat16EEvNS_6ParamsE
        /*0000*/                   S2R R0, SR_TID.X ;
        /*0010*/                   LDS R2, [R1] ;
        /*0020*/                   LDS R3, [R1+0x100] ;
        /*0030*/                   FMUL R4, R3, R2 ;
        /*0040*/                   LDS.64 R6, [R5] ;
        /*0050*/                   LDS.64 R8, [R5+0x40] ;
        /*0060*/                   FMUL R10, R3, R20 ;
        /*0070*/                   MUFU.EX2 R10, R10 ;
        /*0080*/                   FMUL R11, R4, R6 ;
        /*0090*/                   FFMA R21, R10, R21, R11 ;
        /*00a0*/                   FMUL R12, R3, R22 ;
        /*00b0*/                   MUFU.EX2 R12, R12 ;
        /*00c0*/                   FMUL R13, R4, R7 ;
        /*00d0*/                   FFMA R23, R12, R23, R13 ;
        /*00e0*/                   FMUL R14, R21, R8 ;
        /*00f0*/                   FFMA R14, R23, R9, R14 ;
        /*0100*/                   SHFL.BFLY PT, R15, R14, 0x1, 0x1f ;
        /*0110*/                   FADD R14, R14, R15 ;
        /*0120*/                   IADD3 R1, R1, 0x4, RZ ;
        /*0130*/                   ISETP.NE.AND P0, PT, R1, R30, PT ;
        /*0140*/               @P0 BRA 0x10 ;
        /*0150*/                   EXIT ;
		Function : _ZN12_GLOBAL__N_115ssm_scan_kernelILi16ELi4EfEEvNS_6ParamsE
        /*0000*/                   MUFU.EX2 R8, R6 ;
        /*0010*/                   BRA 0x0 ;
		Function : _ZN12_GLOBAL__N_115ssm_scan_kernelILi16E13__nv_bfloat16EEvNS_6ParamsE
        /*0000*/                   MUFU.EX2 R8, R6 ;
        /*0010*/                   MUFU.EX2 R9, R6 ;
        /*0020*/                   BRA 0x0 ;
"""
SCAN_BF16 = r"ssm_scan_kernelILi16ELi4E13__nv_bfloat16E"


def test_loop_census_of_an_ex2_loop():
    c = sass.loop_census(SCAN_FIXTURE, SCAN_BF16, "MUFU.EX2", 1)
    assert c["loop_instructions"] == 20 and c["elements_per_iteration"] == 2
    assert c["instructions_per_element"] == 10.0
    assert c["counts"] == {"FFMA": 3, "FMUL": 6, "FADD": 1, "MUFU": 2,
                           "SELECT": 1, "LDS": 4, "INT": 1, "CONTROL": 1,
                           "OTHER": 1}
    assert c["per_element"]["LDS"] == 2.0 and c["per_element"]["FMUL"] == 3.0
    assert c["shfl"] == 1 and c["shfl_per_element"] == 0.5
    assert c["mufu_per_element"] == 1.0
    assert c["fma_ratio"] == 3 / 10
    assert (c["body"][0][0], c["body"][-1][0]) == (0x10, 0x140)
    with pytest.raises(ValueError):          # 2 EX2 is not a multiple of 3
        sass.loop_census(SCAN_FIXTURE, SCAN_BF16, "MUFU.EX2", 3)
    with pytest.raises(ValueError):          # no loop holds a reciprocal
        sass.loop_census(SCAN_FIXTURE, SCAN_BF16, "MUFU.RCP", 1)


def test_scan_census_finds_every_instance():
    from repro_torch.kernels.ssm import ssm_cuda
    got = ssm_cuda.census(SCAN_FIXTURE)
    # the S = 4 instance and the one-state kernel (S = 1), both bf16
    assert sorted(got) == [1, 4]
    assert got[4]["instructions_per_element"] == 10.0
    assert got[1]["elements_per_iteration"] == 2
    assert got[1]["loop_instructions"] == 3
    f32 = ssm_cuda.census(SCAN_FIXTURE, bf16_params=False)
    assert sorted(f32) == [4] and f32[4]["loop_instructions"] == 2
    with pytest.raises(ValueError):
        ssm_cuda.census(SCAN_FIXTURE, n=8)


def test_bounds_on_the_sms_a_grid_uses():
    spec = hw.H100_SXM5
    elems = 1152 * 3200 * 16                      # hymba-1.5b's prefill
    all_sms = sass.issue_bound_s(elems, 22.0, spec)
    assert sass.issue_bound_s(elems, 22.0, spec, sms=100) == pytest.approx(
        all_sms * 132 / 100)
    assert sass.mufu_bound_s(elems, 1.0, spec, sms=100) == pytest.approx(
        elems / (100 * 16 * 1.98e9))
