"""Read the step loop of a compiled whole-scan kernel from its SASS.

The whole-scan kernels (G, H, I) run their recursion on one thread or one
warp, so their time is the number of cycles one warp spends on a step
times T.  This module reads that loop from ``cuobjdump -sass`` output:

- :func:`disassemble` runs ``cuobjdump -sass`` on a built library;
- :func:`parse` splits the text into functions of :class:`Instr`, each
  with its address, opcode, operands and the control bits the compiler
  set in the instruction's high word (the stall count, the scoreboards it
  sets and the ones it waits on: bits 105-125 of the 128-bit word);
- :func:`step_loop` finds the step loop of a kernel (the longest
  backward branch whose body holds no ``BAR``: the chunk loop around it
  synchronises with the staging warp) and summarises it, on its
  :func:`hot_path` (the slow paths of the precise functions not taken).

The summary's two cycle estimates come from the hot path, replayed four
times in a row (the per-step figure is the steady-state difference):

- ``issue_cycles``: the warp alone, in order, as the control bits
  schedule it: each instruction waits its predecessor's stall count and
  the scoreboards it names; a scoreboard clears ``VAR_LATENCY`` cycles
  after the instruction that set it issued;
- ``chain_cycles``: the dependent chain, with unlimited issue: an
  instruction starts when its source registers and predicates are ready
  and, after a branch, when the branch's predicate is (a warp does not
  issue past an unresolved branch); fixed-latency ALU work takes
  ``ALU_LATENCY`` cycles.

The latencies are round figures for Hopper from public microbenchmarks,
not measured here; both estimates are models to read beside the measured
cycles a step, not measurements.  Nothing here needs a card: the CPU tests
parse a canned listing.
"""
from __future__ import annotations

import re
import shutil
import subprocess
from dataclasses import dataclass
from pathlib import Path

ALU_LATENCY = 4
#: cycles from issue to result of the variable-latency instructions (by
#: opcode prefix); anything else with a destination is fixed-latency ALU
VAR_LATENCY = {"MUFU": 16, "LDS": 28, "LDG": 450, "LDL": 33, "LDC": 12,
               "ULDC": 12, "SHFL": 24, "S2R": 24, "I2F": 8, "F2I": 8,
               "F2F": 8, "FRND": 8, "POPC": 8, "FLO": 8, "BREV": 8,
               "DADD": 8, "DMUL": 8, "DFMA": 8, "ATOM": 450, "RED": 450}
_NO_DEST = ("ST", "BRA", "BAR", "BSSY", "BSYNC", "EXIT", "RET", "CALL",
            "NOP", "WARPSYNC", "JMP", "BRX", "YIELD", "DEPBAR", "MEMBAR",
            "ERRBAR", "CCTL", "FENCE", "RED", "ARRIVES", "SYNCS")
_BRANCH = ("BRA", "JMP", "BRX", "CALL", "RET", "EXIT")

_INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;\s*/\*\s*"
                    r"(0x[0-9a-f]{16})\s*\*/")
_HI = re.compile(r"^\s*/\*\s*(0x[0-9a-f]{16})\s*\*/\s*$")
_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
_FUNC = re.compile(r"Function\s*:\s*(\S+)")
_REG = re.compile(r"(?<![\w.])(U?R\d+|U?P\d)(?![\w])")


@dataclass
class Instr:
    addr: int
    pred: str            # guard predicate ("P0", "!P1") or ""
    op: str              # opcode with modifiers, e.g. "FFMA.FTZ"
    operands: list
    stall: int = 1
    wr_bar: int = 7      # scoreboard set on write (7: none)
    rd_bar: int = 7      # scoreboard set on read (7: none)
    wait: int = 0        # mask of scoreboards waited on
    target: int = -1     # branch target address

    @property
    def base(self) -> str:
        return self.op.split(".")[0]


def disassemble(path) -> str:
    """``cuobjdump -sass`` of a library (raises without the tool)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        raise RuntimeError("cuobjdump not found")
    return subprocess.run([tool, "-sass", str(path)], capture_output=True,
                          text=True, check=True).stdout


def parse(text: str) -> dict:
    """{function name: [Instr]} of a ``cuobjdump -sass`` listing."""
    funcs: dict = {}
    cur, labels, pending = None, {}, []
    lines = text.splitlines()
    for k, line in enumerate(lines):
        m = _FUNC.search(line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            labels = {}
            pending.append((cur, labels))
            continue
        m = _LABEL.match(line)
        if m and cur is not None:
            labels[m.group(1)] = None  # the next instruction's address
            continue
        m = _INSTR.search(line)
        if not m or cur is None:
            continue
        addr, body = int(m.group(1), 16), m.group(2).strip()
        for name, at in labels.items():
            if at is None:
                labels[name] = addr
        pred = ""
        if body.startswith("@"):
            pred, body = body[1:].split(None, 1)
        parts = body.split(None, 1)
        ops = [o.strip() for o in parts[1].split(",")] if len(parts) > 1 \
            else []
        ins = Instr(addr, pred, parts[0], ops)
        hi = None
        if k + 1 < len(lines):
            h = _HI.match(lines[k + 1])
            if h:
                hi = int(h.group(1), 16)
        if hi is not None:
            ctl = hi >> 41
            ins.stall, ins.wr_bar = ctl & 0xF, (ctl >> 5) & 7
            ins.rd_bar, ins.wait = (ctl >> 8) & 7, (ctl >> 11) & 0x3F
        cur.append(ins)
    for instrs, labels in pending:
        for ins in instrs:
            if ins.base in ("BRA", "JMP", "CALL") and ins.operands:
                t = ins.operands[-1].strip()
                m = re.search(r"\((\.L_x_\d+)\)", t)
                if m and labels.get(m.group(1)) is not None:
                    ins.target = labels[m.group(1)]
                elif re.fullmatch(r"0x[0-9a-f]+", t):
                    ins.target = int(t, 16)
    return funcs


def _width(op: str) -> int:
    for w, n in ((".128", 4), (".64", 2)):
        if w in op:
            return n
    return 1


def _regs(operand: str) -> list:
    return [r for r in _REG.findall(operand) if r not in ("RZ", "PT")]


def _expand(reg: str, n: int) -> list:
    if n == 1 or not reg[-1].isdigit():
        return [reg]
    head = reg.rstrip("0123456789")
    i = int(reg[len(head):])
    return [f"{head}{i + j}" for j in range(n)]


def _defs_uses(ins: Instr):
    """(registers written, registers read) of one instruction."""
    uses = []
    if ins.pred:
        uses.append(ins.pred.lstrip("!"))
    ops = ins.operands
    if ins.base.startswith(_NO_DEST) or not ops:
        w = _width(ins.op) if ins.base.startswith("ST") else 1
        for o in ops:
            regs = _regs(o)
            if ins.base.startswith("ST") and "[" not in o:
                regs = [x for r in regs for x in _expand(r, w)]
            uses += regs
        return [], uses
    nd = 2 if ins.base.endswith("SETP") else 1
    defs = []
    for o in ops[:nd]:
        defs += [x for r in _regs(o) for x in _expand(
            r, _width(ins.op) if ins.base.startswith("LD") else 1)]
    for o in ops[nd:]:
        uses += _regs(o)
    if ins.pred:
        uses += defs  # a guarded write keeps the old value otherwise
    return defs, uses


def _latency(ins: Instr) -> int:
    for p, lat in VAR_LATENCY.items():
        if ins.base == p or ins.base.startswith(p):
            return lat
    return ALU_LATENCY


def _replay(body: list, reps: int = 4):
    """(issue, chain) cycles of the body, the steady-state per-pass
    difference of ``reps`` passes (see the module doc)."""
    bar_free = [0.0] * 8
    issue = 0.0
    ready: dict = {}
    gate = 0.0
    marks_i, marks_c = [], []
    top = 0.0
    for _ in range(reps):
        for ins in body:
            t = issue
            for b in range(6):
                if ins.wait >> b & 1:
                    t = max(t, bar_free[b])
            defs, uses = _defs_uses(ins)
            lat = _latency(ins)
            if ins.wr_bar < 6:
                bar_free[ins.wr_bar] = t + lat
            if ins.rd_bar < 6:
                bar_free[ins.rd_bar] = t + 2
            issue = t + max(ins.stall, 1)
            start = max([gate] + [ready.get(r, 0.0) for r in uses])
            for r in defs:
                ready[r] = start + lat
            top = max(top, start + lat)
            if ins.base in _BRANCH:
                gate = max(gate, start)
        marks_i.append(issue)
        marks_c.append(top)
    k = reps // 2
    return ((marks_i[-1] - marks_i[k - 1]) / (reps - k),
            (marks_c[-1] - marks_c[k - 1]) / (reps - k))


def hot_path(body: list) -> list:
    """The instructions one pass of a loop body runs when no slow path is
    taken: from the loop head, straight on; a forward branch, guarded or
    not, is followed (the compiler lays the slow paths of the precise
    functions, such as ``sincosf``'s Payne-Hanek reduction for
    |x| >= 105615 and the subnormal fix-ups of divisions and square roots,
    between a guarded branch and its target); a backward branch other
    than the back edge, a ``CALL`` (the out-of-line slow paths) and the
    back edge itself are not followed."""
    at = {x.addr: k for k, x in enumerate(body)}
    path, k = [], 0
    while k < len(body):
        ins = body[k]
        path.append(ins)
        if ins.base in ("BRA", "JMP") and ins.addr < ins.target \
                and ins.target in at:
            k = at[ins.target]
            continue
        if ins.base == "EXIT" or (ins.base == "BRA" and not ins.pred
                                  and ins.target <= ins.addr):
            break
        k += 1
    return path


def step_loop(text: str, kernel: str, traj=None) -> dict:
    """The summary of ``kernel``'s step loop in a SASS listing (the first
    function whose name holds ``kernel`` and, when ``traj`` is a bool, the
    template flag ``Lb1E``/``Lb0E``): its instructions and basic blocks;
    on its :func:`hot_path`, the instructions, the loads and stores by
    kind, ``MUFU`` and ``SHFL``, and the two cycle estimates of the module
    doc; the loads from device and local memory anywhere in the loop
    (``LDG_all``, ``LDL_all``: slow paths included)."""
    funcs = parse(text)
    flag = None if traj is None else ("Lb1E" if traj else "Lb0E")
    names = [n for n in funcs if kernel in n and (flag is None or flag in n)]
    if not names:
        raise ValueError(f"no function {kernel} ({flag}) in the listing")
    name = names[0]
    instrs = funcs[name]
    best = None
    for ins in instrs:
        if ins.base != "BRA" or ins.target < 0 or ins.target > ins.addr:
            continue
        body = [x for x in instrs if ins.target <= x.addr <= ins.addr]
        if any(x.base == "BAR" for x in body):
            continue
        if best is None or len(body) > len(best[2]):
            best = (ins.target, ins.addr, body)
    if best is None:
        raise ValueError(f"{name}: no loop without a barrier")
    start, end, body = best
    targets = {x.target for x in body if start < x.target <= end}
    after = sum(1 for x in body[:-1] if x.base in _BRANCH)
    hot = hot_path(body)
    counts: dict = {}
    for x in hot:
        kind = "LDC" if x.base == "ULDC" else x.base
        if kind in ("LDG", "LDL", "LDS", "LDC", "STG", "STL", "STS", "MUFU",
                    "SHFL"):
            counts[kind] = counts.get(kind, 0) + 1
    for kind in ("LDG", "LDL"):
        counts[f"{kind}_all"] = sum(1 for x in body if x.base == kind)
    issue, chain = _replay(hot)
    return dict(instructions=len(body), blocks=1 + len(targets) + after,
                hot_instructions=len(hot), **counts, issue_cycles=issue,
                chain_cycles=chain)
