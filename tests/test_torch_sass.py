"""PyTorch port: the SASS step-loop reader (kernels/sass.py) on a canned
``cuobjdump -sass`` listing shaped like a whole-scan kernel's: a staging
loop with a barrier, then a step loop whose hot path jumps over a
slow path holding an inner loop and a load from device memory."""
from lowlevelparticlefilters_jl_tpu_torch.kernels import sass

# control words: stall 1 and no scoreboards (0x000fe2...), stall 4 waiting
# on scoreboard 0 (0x001fc8...), stall 2 setting scoreboard 0 (0x000e24...)
_S1, _W0, _B0 = "0x000fe20000000000", "0x001fc80000000000", \
    "0x000e240000000000"
_BODY = [
    (0x00, "LDC R1, c[0x0][0x28]", _S1),
    (0x10, "BAR.SYNC.DEFER_BLOCKING 0x0", _S1),
    (0x20, "LDS R4, [R2]", _B0),               # step loop head
    (0x30, "FFMA R6, R4, R5, R6", _W0),
    (0x40, "MUFU.RSQ R7, R6", _B0),
    (0x50, "FMUL R6, R7, R6", _W0),
    (0x60, "FSETP.GE.AND P0, PT, |R6|, 105615, PT", _S1),
    (0x70, "@!P0 BRA `(.L_x_2)", _S1),         # over the slow path
    (0x80, "LDG.E.CONSTANT R8, desc[UR4][R10.64]", _B0),
    (0x90, "IADD3 R10, R10, 0x4, RZ", _W0),
    (0xa0, "@P1 BRA `(.L_x_3)", _S1),          # the slow path's own loop
    (0xb0, "FADD R6, R6, R8", _S1),
    (0xc0, "ISETP.NE.AND P2, PT, R2, R3, PT", _S1),   # .L_x_2
    (0xd0, "@P2 BRA `(.L_x_1)", _S1),          # the back edge
    (0xe0, "EXIT", _S1),
]
_LABELS = {0x20: ".L_x_1", 0x80: ".L_x_3", 0xc0: ".L_x_2"}


def _listing(name):
    lines = ["\tcode for sm_90a", f"\t\tFunction : {name}"]
    for addr, text, hi in _BODY:
        if addr in _LABELS:
            lines.append(f"{_LABELS[addr]}:")
        lines.append(f"        /*{addr:04x}*/    {text} ;    "
                     f"/* 0x0000000000000000 */")
        lines.append(f"                          /* {hi} */")
    return "\n".join(lines) + "\n"


def test_parse_reads_operands_targets_and_control_bits():
    funcs = sass.parse(_listing("_Z15ekf_scan_kernelILb0EEvPKf"))
    (instrs,) = funcs.values()
    by = {i.addr: i for i in instrs}
    assert by[0x70].pred == "!P0" and by[0x70].target == 0xc0
    assert by[0xa0].target == 0x80 and by[0xd0].target == 0x20
    assert (by[0x30].stall, by[0x30].wait) == (4, 1)
    assert (by[0x20].stall, by[0x20].wr_bar) == (2, 0)
    assert sass._defs_uses(by[0x30]) == (["R6"], ["R4", "R5", "R6"])


def test_step_loop_follows_the_hot_path():
    """The step loop is the longest backward branch without a barrier; its
    hot path jumps over the slow path, so the device load inside it counts
    only in ``LDG_all``.  A warp issues nothing past an unresolved branch,
    so the chain of a pass is LDS, FFMA, MUFU, FMUL, the FSETP the branch
    waits on and the ISETP of the back edge."""
    text = _listing("_Z15ekf_scan_kernelILb0EEvPKf") + _listing(
        "_Z15ekf_scan_kernelILb1EEvPKf")
    loop = sass.step_loop(text, "ekf_scan_kernel", traj=False)
    assert loop["instructions"] == 12 and loop["hot_instructions"] == 8
    assert "LDG" not in loop and loop["LDG_all"] == 1
    assert loop["LDS"] == 1 and loop["MUFU"] == 1
    lat = sass.VAR_LATENCY
    assert loop["chain_cycles"] == lat["LDS"] + lat["MUFU"] \
        + 4 * sass.ALU_LATENCY
    assert loop["issue_cycles"] >= 8
