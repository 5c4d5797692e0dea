"""User callbacks as scalar code for the whole-scan kernels G and I.

The JAX kernels trace the user's dynamics, measurement and UT hooks into
the Mosaic kernel (``ops/pallas/ukf_scan.py::_flatten``,
``_flatten_hook``), after a jaxpr walk admits their primitives
(``_HOOK_OK``, ``_jaxpr_lowerable``).  Here a callback is traced with
``torch.fx.experimental.proxy_tensor.make_fx`` at its example shapes into
a flat aten graph, and the graph is unrolled into a straight-line
program over scalars (:class:`Program`):

- every value is a small tensor of static shape, held as a numpy object
  array of scalar references (:class:`Lit`, :class:`In`, :class:`Const`,
  :class:`Var`), so views, slices, stacks and broadcasts are index
  bookkeeping and only arithmetic becomes an instruction;
- every tensor constant of the graph (a closed-over matrix, a tensor
  built inside the callback) is hoisted into a kernel input, read on
  each call, in the order of :attr:`Program.consts`; Python scalars are
  baked into the code as literals;
- an op outside :data:`ADMITTED`, a trace that fails, or a value of an
  integer type raises :class:`CodegenError`; the caller then takes the
  sequential route, as the JAX package does when ``_supported`` is false.

A program prints as a CUDA C++ function over floats,
``void name(const float* in0, ..., const float* c, float* out)``
(:meth:`Program.cpp`), over the helpers of ``csrc/callback_ops.cuh``.
Kernel I needs each callback's Jacobian in x as well: :meth:`Program.jacobian`
differentiates the program symbolically, in forward mode, at code
generation (the counterpart of the in-kernel ``jax.jacfwd``), so the
kernel runs one straight-line float program for the value and the
Jacobian, and the structural zeros and unit factors of the tangents cost
nothing: the Jacobian entry of an affine term is the constant itself.
:meth:`Program.evaluate` runs any program in Python, so the CPU tests
hold the lowering and the derivative rules against the callback and
``torch.func.jacfwd``.

``atan2`` is admitted: its exclusion in the JAX package is a Mosaic
lowering gap, and CUDA has ``atan2f``.
"""
from __future__ import annotations

import math
import operator
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch


class CodegenError(Exception):
    """A callback the code generator cannot lower."""


@dataclass(frozen=True)
class Lit:
    """A literal (float or bool) baked into the code."""
    v: object


@dataclass(frozen=True)
class In:
    """Element ``i`` (row-major) of input ``k``."""
    k: int
    i: int


@dataclass(frozen=True)
class Const:
    """Element ``i`` of the hoisted constants buffer."""
    i: int


@dataclass(frozen=True)
class Var:
    """The result of instruction ``i``."""
    i: int


# ---------------------------------------------------------------------------
# Scalar semantics: the Python evaluation of every instruction, mirrored
# by csrc/callback_ops.cuh, and its derivative rules
# ---------------------------------------------------------------------------

def _sigmoid(v):
    return 1.0 / (1.0 + math.exp(-v))


def _sign(v):
    return float((v > 0) - (v < 0))


def _rem(a, b):
    m = math.fmod(a, b)
    if m != 0 and ((b < 0) != (m < 0)):
        m += b
    return m


def _div(a, b):
    if b == 0:
        return math.copysign(math.inf, a) if a != 0 else math.nan
    return a / b


def _log(v):
    return math.log(v) if v > 0 else (-math.inf if v == 0 else math.nan)


def _sqrt(v):
    return math.sqrt(v) if v >= 0 else math.nan


def _pow(a, c):
    try:
        return math.pow(a, c)
    except (ValueError, ZeroDivisionError):
        return math.nan if a < 0 else math.inf


_EVAL = {
    "add": operator.add, "sub": operator.sub, "mul": operator.mul,
    "div": _div, "neg": operator.neg, "sqrt": _sqrt, "exp": math.exp,
    "log": _log, "expm1": math.expm1, "log1p": math.log1p,
    "sin": math.sin, "cos": math.cos, "tanh": math.tanh,
    "sigmoid": _sigmoid, "abs": abs, "sign": _sign,
    "floor": lambda v: float(math.floor(v)),
    "ceil": lambda v: float(math.ceil(v)),
    "round": lambda v: float(round(v)),
    "trunc": lambda v: float(math.trunc(v)),
    "powc": _pow, "powt": _pow, "atan2": math.atan2, "rem": _rem,
    "fmod": math.fmod,
    "lt": operator.lt, "le": operator.le, "gt": operator.gt,
    "ge": operator.ge, "eq": operator.eq, "ne": operator.ne,
    "and": lambda a, b: bool(a) and bool(b),
    "or": lambda a, b: bool(a) or bool(b),
    "xor": lambda a, b: bool(a) != bool(b),
    "not": lambda a: not a,
    "isfinite": math.isfinite,
    "tofloat": lambda a: 1.0 if a else 0.0,
    "tobool": lambda a: a != 0.0,
    "sel": lambda c, a, b: a if c else b,
}


# the C++ spelling of each instruction (csrc/callback_ops.cuh); {0}, {1},
# {2} are the operands
_CPP = {
    "add": "({0} + {1})", "sub": "({0} - {1})", "mul": "({0} * {1})",
    "div": "({0} / {1})", "neg": "(-{0})",
    "lt": "({0} < {1})", "le": "({0} <= {1})", "gt": "({0} > {1})",
    "ge": "({0} >= {1})", "eq": "({0} == {1})", "ne": "({0} != {1})",
    "and": "({0} && {1})", "or": "({0} || {1})", "xor": "({0} != {1})",
    "not": "(!{0})", "isfinite": "isfinite({0})",
    "tofloat": "({0} ? 1.0f : 0.0f)", "tobool": "({0} != 0.0f)",
    "sel": "({0} ? {1} : {2})",
}
for _name in ("sqrt", "exp", "log", "expm1", "log1p", "sin", "cos", "tanh",
              "sigmoid", "abs", "sign", "floor", "ceil", "round", "trunc"):
    _CPP[_name] = f"m_{_name}({{0}})"
for _name in ("powc", "powt", "atan2", "rem", "fmod"):
    _CPP[_name] = f"m_{_name}({{0}}, {{1}})"

#: instructions whose value is locally constant in every input (a
#: comparison, a rounding, a logical value): no tangent
_FLAT = frozenset(["lt", "le", "gt", "ge", "eq", "ne", "and", "or", "xor",
                   "not", "isfinite", "tofloat", "tobool", "sign", "floor",
                   "ceil", "round", "trunc"])


def _partials(op: str, a: list, v, emit) -> list:
    """The partial derivative of instruction ``op`` at operands ``a`` (its
    value ``v``) in each operand, as callables that emit it (None for an
    operand the value does not depend on): ``jax.jacfwd``'s rules."""
    one = Lit(1.0)
    if op == "mul":
        return [lambda: a[1], lambda: a[0]]
    if op == "div":
        return [lambda: emit("div", one, a[1]),
                lambda: emit("neg", emit("div", a[0],
                                         emit("mul", a[1], a[1])))]
    unary = {
        "sqrt": lambda: emit("div", Lit(0.5), v),
        "exp": lambda: v,
        "log": lambda: emit("div", one, a[0]),
        "expm1": lambda: emit("exp", a[0]),
        "log1p": lambda: emit("div", one, emit("add", one, a[0])),
        "sin": lambda: emit("cos", a[0]),
        "cos": lambda: emit("neg", emit("sin", a[0])),
        "tanh": lambda: emit("sub", one, emit("mul", v, v)),
        "sigmoid": lambda: emit("mul", v, emit("sub", one, v)),
        "abs": lambda: emit("sign", a[0]),
    }
    if op in unary:
        return [unary[op]]
    if op in ("powc", "powt"):
        d0 = lambda: emit("mul", a[1], emit("powc", a[0],  # noqa: E731
                                            emit("sub", a[1], one)))
        if op == "powc":  # a constant exponent
            return [d0, lambda: None]
        return [d0, lambda: emit("mul", v, emit("log", a[0]))]
    if op == "atan2":
        den = []

        def d(k):
            if not den:
                den.append(emit("add", emit("mul", a[0], a[0]),
                                emit("mul", a[1], a[1])))
            q = emit("div", a[1 - k], den[0])
            return q if k == 0 else emit("neg", q)
        return [lambda: d(0), lambda: d(1)]
    if op in ("rem", "fmod"):
        rnd = "floor" if op == "rem" else "trunc"
        return [lambda: one, lambda: emit("neg", emit(rnd, emit(
            "div", a[0], a[1])))]
    raise CodegenError(f"no derivative rule for {op}")  # pragma: no cover


def _flit(v) -> str:
    """A float or bool literal as C++ (f32, round-tripping)."""
    if isinstance(v, (bool, np.bool_)):
        return "true" if v else "false"
    f = float(np.float32(v))
    if math.isnan(f):
        return "__int_as_float(0x7fc00000)"
    if math.isinf(f):
        return "__int_as_float(0x7f800000)" if f > 0 else \
            "__int_as_float(0xff800000)"
    return f"{f!r}f"


def _is(r, v) -> bool:
    return isinstance(r, Lit) and not isinstance(r.v, bool) and r.v == v


# ---------------------------------------------------------------------------
# The program
# ---------------------------------------------------------------------------


class Program:
    """A callback lowered to scalar instructions.

    ``inputs``: (shape, kind) per argument, kind ``"S"`` for the state
    argument, the one :meth:`jacobian` differentiates in, and ``"f"`` for
    the others; ``consts``: the hoisted constant tensors in buffer order;
    ``instrs``: ``(op, args)``, instruction ``i`` defining ``Var(i)``;
    ``out``: the output's scalar references (row-major) and ``out_shape``
    its shape."""

    def __init__(self, name: str, inputs, consts, instrs, out, out_shape):
        self.name = name
        self.inputs = inputs
        self.consts = consts
        self.instrs = instrs
        self.out = out
        self.out_shape = tuple(out_shape)

    @property
    def n_consts(self) -> int:
        return sum(c.numel() for c in self.consts)

    def const_buffer(self, device=None) -> torch.Tensor:
        """The hoisted constants, read now, as one float32 vector."""
        if not self.consts:
            return torch.zeros(0, dtype=torch.float32, device=device)
        return torch.cat([c.detach().reshape(-1).to(
            dtype=torch.float32, device=device) for c in self.consts])

    # -- evaluation in Python ------------------------------------------
    def evaluate(self, inputs: Sequence[Sequence], consts: Sequence) -> list:
        """Run the program on flat per-input lists of floats and a flat
        constants list."""
        vals: list = []

        def get(r):
            if isinstance(r, Var):
                return vals[r.i]
            if isinstance(r, In):
                return inputs[r.k][r.i]
            if isinstance(r, Const):
                return consts[r.i]
            return r.v

        for op, args in self.instrs:
            vals.append(_EVAL[op](*[get(a) for a in args]))
        return [get(r) for r in self.out]

    def value_and_jacobian(self, *args: torch.Tensor, wrt: int = 0):
        """The program's output at ``args`` and its Jacobian in argument
        ``wrt``: :meth:`jacobian`'s program evaluated in Python in float64
        (for the tests)."""
        flat = [a.detach().double().reshape(-1).tolist() for a in args]
        n, m = len(flat[wrt]), len(self.out)
        consts = [v for c in self.consts
                  for v in c.detach().double().reshape(-1).tolist()]
        out = [float(o) for o in self.jacobian(wrt).evaluate(flat, consts)]
        val = torch.tensor(out[:m], dtype=torch.float64)
        jac = torch.tensor(out[m:], dtype=torch.float64)
        return val.reshape(self.out_shape), jac.reshape(*self.out_shape, n)

    # -- symbolic forward mode -----------------------------------------
    def jacobian(self, wrt: Optional[int] = None,
                 name: Optional[str] = None) -> "Program":
        """A program that computes this one's output and then its
        Jacobian in input ``wrt`` (default: the ``"S"`` input), row-major:
        ``[f (m), df/dx (m x n)]``.  The tangents are built symbolically,
        one instruction at a time, keeping only the entries that are not
        structurally zero and dropping products by 1: a Jacobian entry
        of an affine term is the constant itself, no instruction."""
        if wrt is None:
            wrt = next((k for k, (_, kind) in enumerate(self.inputs)
                        if kind == "S"), 0)
        n = int(np.prod(self.inputs[wrt][0], dtype=np.int64))
        L = _Lowering()
        new: list = []   # old Var index -> the new reference
        tan: list = []   # old Var index -> {column: reference}

        def ref(r):
            return new[r.i] if isinstance(r, Var) else r

        def tangent(r) -> dict:
            if isinstance(r, Var):
                return tan[r.i]
            if isinstance(r, In) and r.k == wrt:
                return {r.i: Lit(1.0)}
            return {}

        def mul(p, t):
            return t if _is(p, 1.0) else p if _is(t, 1.0) else L.emit(
                "mul", p, t)

        def add(out, j, t, sign=1):
            if j in out:
                out[j] = L.emit("add" if sign > 0 else "sub", out[j], t)
            elif sign > 0:
                out[j] = t
            else:
                out[j] = Lit(-t.v) if isinstance(t, Lit) else L.emit("neg", t)

        for op, args in self.instrs:
            a = [ref(x) for x in args]
            v = L.emit(op, *a)
            new.append(v)
            ts = [tangent(x) for x in args]
            out: dict = {}
            if not any(ts) or op in _FLAT:
                pass
            elif op in ("add", "sub", "neg"):
                signs = {"add": (1, 1), "sub": (1, -1), "neg": (-1,)}[op]
                for tk, sign in zip(ts, signs):
                    for j, t in tk.items():
                        add(out, j, t, sign)
            elif op == "sel":
                for j in sorted(set(ts[1]) | set(ts[2])):
                    out[j] = L.emit("sel", a[0], ts[1].get(j, Lit(0.0)),
                                    ts[2].get(j, Lit(0.0)))
            else:
                parts = _partials(op, a, v, L.emit)
                for tk, part in zip(ts, parts):
                    p = part() if tk else None
                    for j, t in (tk.items() if p is not None else ()):
                        add(out, j, mul(p, t))
            tan.append(out)
        vals = [ref(r) for r in self.out]
        jac = [tangent(r).get(j, Lit(0.0)) for r in self.out
               for j in range(n)]
        m = len(vals)
        return Program(name or self.name, self.inputs, self.consts,
                       L.instrs, vals + jac, (m + m * n,))

    # -- C++ -----------------------------------------------------------
    def cpp(self, const_base: int = 0) -> str:
        """The program as a ``__device__`` function over floats; its
        constants start at ``c[const_base]``.  A sine and a cosine of the
        same operand print as one ``sincosf``."""
        def ref(r):
            if isinstance(r, Var):
                return f"v{r.i}"
            if isinstance(r, In):
                return f"in{r.k}[{r.i}]"
            if isinstance(r, Const):
                return f"c[{const_base + r.i}]"
            return _flit(r.v)

        pair: dict = {}    # first of a sin/cos pair -> (sin index, cos)
        skip: set = set()
        seen: dict = {}
        for i, (op, args) in enumerate(self.instrs):
            if op not in ("sin", "cos"):
                continue
            other = ("cos" if op == "sin" else "sin", args[0])
            if other in seen:
                j = seen.pop(other)
                pair[j] = (j, i) if op == "cos" else (i, j)
                skip.add(i)
            else:
                seen.setdefault((op, args[0]), i)
        params = [f"const float* __restrict__ in{k}"
                  for k in range(len(self.inputs))]
        lines = [f"__device__ __forceinline__ void {self.name}("
                 + ", ".join(params + ["const float* __restrict__ c",
                                       "float* __restrict__ out"]) + ") {"]
        for i, (op, args) in enumerate(self.instrs):
            if i in pair:
                s, c = pair[i]
                lines.append(f"  float v{s}, v{c};")
                lines.append(f"  m_sincos({ref(args[0])}, &v{s}, &v{c});")
            elif i not in skip:
                lines.append(f"  const auto v{i} = "
                             + _CPP[op].format(*[ref(a) for a in args])
                             + ";")
        for i, r in enumerate(self.out):
            lines.append(f"  out[{i}] = (float)({ref(r)});")
        lines.append("}")
        return "\n".join(lines)


def concat(name: str, progs: Sequence[Program]) -> Program:
    """One program computing the outputs of ``progs`` (callbacks of the
    same inputs) one after another, flat: the constants and instructions
    of each follow the previous ones'."""
    instrs, out, consts = [], [], []
    vbase = cbase = 0

    def shift(r):
        return (Var(r.i + vbase) if isinstance(r, Var) else
                Const(r.i + cbase) if isinstance(r, Const) else r)

    for p in progs:
        instrs += [(op, tuple(shift(a) for a in args))
                   for op, args in p.instrs]
        out += [shift(r) for r in p.out]
        consts += list(p.consts)
        vbase += len(p.instrs)
        cbase += p.n_consts
    return Program(name, progs[0].inputs, consts, instrs, out, (len(out),))


# ---------------------------------------------------------------------------
# Lowering an aten graph
# ---------------------------------------------------------------------------

_UNARY = {"neg": "neg", "abs": "abs", "sqrt": "sqrt", "exp": "exp",
          "log": "log", "expm1": "expm1", "log1p": "log1p", "sin": "sin",
          "cos": "cos", "tanh": "tanh", "sigmoid": "sigmoid",
          "sign": "sign", "sgn": "sign", "floor": "floor", "ceil": "ceil",
          "round": "round", "logical_not": "not", "bitwise_not": "not",
          "isfinite": "isfinite"}
_BINARY = {"add": "add", "sub": "sub", "mul": "mul", "div": "div",
           "atan2": "atan2", "remainder": "rem", "fmod": "fmod",
           "eq": "eq", "ne": "ne", "lt": "lt", "le": "le", "gt": "gt",
           "ge": "ge", "logical_and": "and", "logical_or": "or",
           "logical_xor": "xor", "bitwise_and": "and", "bitwise_or": "or",
           "bitwise_xor": "xor"}
_IDENTITY = frozenset(["clone", "alias", "detach", "lift_fresh_copy",
                       "contiguous"])
_RESHAPE = frozenset(["view", "_unsafe_view", "reshape", "unsqueeze",
                      "unsqueeze_", "squeeze", "squeeze_", "flatten",
                      "expand", "broadcast_to"])
_CREATE = frozenset(["zeros", "ones", "full", "scalar_tensor", "zeros_like",
                     "ones_like", "full_like", "new_zeros", "new_ones",
                     "new_full"])
_OTHER = frozenset(["rsub", "pow", "square", "reciprocal", "rsqrt", "relu",
                    "diag_embed", "diagonal", "diagonal_copy", "eye",
                    "maximum", "minimum", "clamp", "clamp_min", "clamp_max",
                    "where", "t", "transpose", "permute", "slice", "select",
                    "stack", "cat", "unbind", "sum", "mean", "amax", "amin",
                    "prod", "mv", "mm", "dot", "matmul", "_to_copy"])

#: the aten ops a callback may use (overload packet names), the
#: counterpart of the JAX package's ``_HOOK_OK``
ADMITTED = frozenset(_UNARY) | frozenset(_BINARY) | _IDENTITY | _RESHAPE \
    | _CREATE | _OTHER


class _Lowering:
    def __init__(self):
        self.instrs: list = []
        self.consts: list = []
        self._const_base: dict = {}
        self._n_const = 0

    # -- scalar emission -----------------------------------------------
    def emit(self, op: str, *args):
        if all(isinstance(a, Lit) for a in args):
            return Lit(_EVAL[op](*[a.v for a in args]))
        self.instrs.append((op, args))
        return Var(len(self.instrs) - 1)

    def ew(self, op: str, *arrs, out_bool=False):
        """Elementwise ``op`` over broadcast object arrays."""
        arrs = np.broadcast_arrays(*arrs)
        out = np.empty(arrs[0].shape, dtype=object)
        for idx in np.ndindex(out.shape):
            out[idx] = self.emit(op, *[a[idx] for a in arrs])
        return out

    def chain(self, op: str, terms: list):
        acc = terms[0]
        for t in terms[1:]:
            acc = self.emit(op, acc, t)
        return acc

    def select(self, c, a, b):
        return self.ew("sel", c, a, b)

    def constant(self, t: torch.Tensor):
        if not t.dtype.is_floating_point:
            raise CodegenError(f"constant of type {t.dtype}")
        key = id(t)
        if key not in self._const_base:
            self._const_base[key] = self._n_const
            self.consts.append(t)
            self._n_const += t.numel()
        base = self._const_base[key]
        out = np.empty(tuple(t.shape), dtype=object)
        for j, idx in enumerate(np.ndindex(out.shape)):
            out[idx] = Const(base + j)
        return out


def _scalar_array(r) -> np.ndarray:
    out = np.empty((), dtype=object)
    out[()] = r
    return out


def _lit_array(shape, v):
    out = np.empty(tuple(shape), dtype=object)
    for idx in np.ndindex(out.shape):
        out[idx] = Lit(v)
    return out


def _matmul(L: _Lowering, a, b):
    """``a @ b`` for 1-D and 2-D operands, each sum a left-to-right chain
    of products."""
    a2 = a[None, :] if a.ndim == 1 else a
    b2 = b[:, None] if b.ndim == 1 else b
    n, k = a2.shape
    m = b2.shape[1]
    if b2.shape[0] != k:
        raise CodegenError("matmul shapes")
    out = np.empty((n, m), dtype=object)
    for i in range(n):
        for j in range(m):
            out[i, j] = L.chain("add", [L.emit("mul", a2[i, q], b2[q, j])
                                        for q in range(k)]) if k else Lit(0.0)
    if a.ndim == 1:
        out = out[0]
    if b.ndim == 1:
        out = out[..., 0]
    return out


def _reduce(L: _Lowering, x, dims, keepdim, op, out_shape):
    if dims is None or (isinstance(dims, (list, tuple)) and len(dims) == 0):
        dims = list(range(x.ndim))
    dims = [d % max(x.ndim, 1) for d in ([dims] if isinstance(dims, int)
                                          else dims)]
    keep = [d for d in range(x.ndim) if d not in dims]
    moved = np.transpose(x, keep + dims) if x.ndim else x
    lead = moved.shape[:len(keep)]
    flat = moved.reshape(*lead, -1) if x.ndim else moved.reshape(1)
    out = np.empty(lead, dtype=object)
    for idx in np.ndindex(lead):
        terms = list(flat[idx])
        if op == "mean":
            out[idx] = L.emit("div", L.chain("add", terms),
                              Lit(float(len(terms))))
        elif op in ("amax", "amin"):
            cmp = "gt" if op == "amax" else "lt"
            acc = terms[0]
            for t in terms[1:]:
                acc = L.emit("sel", L.emit(cmp, t, acc), t, acc)
            out[idx] = acc
        else:
            out[idx] = L.chain("add" if op == "sum" else "mul", terms)
    return out.reshape(out_shape)


def _shape_of(node) -> tuple:
    val = node.meta.get("val")
    if val is None or not isinstance(val, torch.Tensor):
        raise CodegenError(f"no shape for {node}")
    return tuple(val.shape)


def _dtype_kind(node) -> str:
    val = node.meta.get("val")
    if isinstance(val, torch.Tensor):
        if val.dtype == torch.bool:
            return "b"
        if val.dtype.is_floating_point:
            return "f"
        raise CodegenError(f"{node.target} gives {val.dtype}")
    return "f"


def _lower_node(L: _Lowering, node, get):
    fn = node.target
    if fn is operator.getitem:
        return get(node.args[0])[node.args[1]]
    name = getattr(getattr(fn, "overloadpacket", None), "__name__", None)
    if name not in ADMITTED:
        raise CodegenError(f"op {fn} is not admitted")
    kind = _dtype_kind(node)
    shape = _shape_of(node) if name != "unbind" else None
    args = [get(a) for a in node.args]
    kw = {k: get(v) for k, v in node.kwargs.items()}

    if name in _IDENTITY:
        return args[0]
    if name == "_to_copy":
        x = args[0]
        src = _dtype_kind(node.args[0])
        if src == kind:
            return x
        return L.ew("tofloat" if kind == "f" else "tobool", x)
    if name in _RESHAPE:
        return np.broadcast_to(args[0], shape).copy() if name in (
            "expand", "broadcast_to") else args[0].reshape(shape)
    if name in _CREATE:
        if name in ("zeros", "zeros_like", "new_zeros"):
            v = 0.0
        elif name in ("ones", "ones_like", "new_ones"):
            v = 1.0
        elif name == "scalar_tensor":
            v = args[0].item().v
        else:
            v = args[-1].item().v
        return _lit_array(shape, bool(v) if kind == "b" else float(v))
    if name in _UNARY:
        return L.ew(_UNARY[name], args[0])
    if name in _BINARY:
        a, b = args[0], args[1]
        alpha = kw.get("alpha")
        if alpha is not None and name in ("add", "sub"):
            b = L.ew("mul", b, alpha)
        if kw.get("rounding_mode") is not None:
            raise CodegenError("division with a rounding mode")
        return L.ew(_BINARY[name], a, b)
    if name == "rsub":  # rsub(a, b, alpha) = b - alpha * a
        a = args[0]
        if kw.get("alpha") is not None:
            a = L.ew("mul", a, kw["alpha"])
        return L.ew("sub", args[1], a)
    if name == "pow":
        a, b = args
        if b.ndim == 0 and isinstance(b.item(), Lit):
            c = float(b.item().v)
            if c == 2.0:
                return L.ew("mul", a, a)
            if c == 1.0:
                return a
            if c == 0.5:
                return L.ew("sqrt", a)
            return L.ew("powc", a, b)
        return L.ew("powt", a, b)
    if name == "square":
        return L.ew("mul", args[0], args[0])
    if name == "reciprocal":
        return L.ew("div", _lit_array((), 1.0), args[0])
    if name == "rsqrt":
        return L.ew("div", _lit_array((), 1.0), L.ew("sqrt", args[0]))
    if name == "relu":
        x = args[0]
        zero = _lit_array((), 0.0)
        return L.select(L.ew("gt", x, zero), x, zero)
    if name in ("maximum", "minimum"):
        a, b = args
        return L.select(L.ew("gt" if name == "maximum" else "lt", a, b),
                        a, b)
    if name in ("clamp", "clamp_min", "clamp_max"):
        x = args[0]
        lo = args[1] if name in ("clamp", "clamp_min") and len(args) > 1 \
            else kw.get("min")
        hi = (args[2] if name == "clamp" and len(args) > 2 else
              args[1] if name == "clamp_max" else kw.get("max"))
        if lo is not None and lo is not _NONE:
            x = L.select(L.ew("lt", x, lo), np.broadcast_to(lo, x.shape), x)
        if hi is not None and hi is not _NONE:
            x = L.select(L.ew("gt", x, hi), np.broadcast_to(hi, x.shape), x)
        return x
    if name == "where":
        return L.select(*args[:3])
    if name == "eye":
        n = node.args[0]
        m = node.args[1] if len(node.args) > 1 else n
        return np.array([[Lit(float(i == j)) for j in range(m)]
                         for i in range(n)], dtype=object).reshape(shape)
    if name == "diag_embed" and args[0].ndim == 1 and len(node.args) == 1:
        v = args[0]
        out = _lit_array(shape, 0.0)
        for i in range(v.shape[0]):
            out[i, i] = v[i]
        return out
    if name in ("diagonal", "diagonal_copy") and len(node.args) == 1:
        return np.diagonal(args[0]).copy()
    if name == "t":
        return args[0].T
    if name == "transpose":
        return np.swapaxes(args[0], node.args[1], node.args[2])
    if name == "permute":
        return np.transpose(args[0], node.args[1])
    if name == "slice":
        x = args[0]
        dim = node.args[1] if len(node.args) > 1 else 0
        start = node.args[2] if len(node.args) > 2 else None
        end = node.args[3] if len(node.args) > 3 else None
        step = node.args[4] if len(node.args) > 4 else 1
        sl = [slice(None)] * x.ndim
        sl[dim] = slice(start, end, step)
        return x[tuple(sl)]
    if name == "select":
        return np.take(args[0], node.args[2], axis=node.args[1])
    if name in ("stack", "cat"):
        dim = node.args[1] if len(node.args) > 1 else 0
        parts = list(args[0])
        if name == "stack":
            return np.stack(parts, axis=dim)
        parts = [p for p in parts if p.size or p.ndim > 1] or parts
        return np.concatenate(parts, axis=dim)
    if name == "unbind":
        dim = node.args[1] if len(node.args) > 1 else 0
        return tuple(np.moveaxis(args[0], dim, 0))
    if name in ("sum", "mean", "amax", "amin", "prod"):
        dims = node.args[1] if len(node.args) > 1 else node.kwargs.get("dim")
        return _reduce(L, args[0], dims, None, name, shape)
    if name in ("mv", "mm", "dot", "matmul"):
        return _matmul(L, args[0], args[1])
    raise CodegenError(f"op {fn} has no lowering")  # pragma: no cover


_NONE = object()


def lower(fn, example_inputs: Sequence[torch.Tensor], kinds: Sequence[str],
          name: str) -> Program:
    """Trace ``fn(*example_inputs)`` and lower it to a :class:`Program`;
    raises :class:`CodegenError` where the JAX package's ``_supported``
    would be false."""
    from torch.fx.experimental.proxy_tensor import make_fx

    # distinct tensors: make_fx tracks inputs by identity
    example_inputs = [x.clone() for x in example_inputs]
    try:
        gm = make_fx(fn)(*example_inputs)
    except Exception as exc:  # a callback that does not trace
        raise CodegenError(f"make_fx failed: {exc!r}") from exc
    L = _Lowering()
    env: dict = {}
    placeholders = []
    out = None

    def get(a):
        if isinstance(a, torch.fx.Node):
            return env[a]
        if isinstance(a, (list, tuple)):
            return [get(x) for x in a]
        if isinstance(a, (bool, int, float)):
            return _lit_array((), a if isinstance(a, bool) else float(a))
        if a is None:
            return _NONE
        return a  # dtypes, devices, layouts: metadata only

    for node in gm.graph.nodes:
        if node.op == "placeholder":
            k = len(placeholders)
            placeholders.append(node)
            shp = tuple(example_inputs[k].shape)
            arr = np.empty(shp, dtype=object)
            for j, idx in enumerate(np.ndindex(shp)):
                arr[idx] = In(k, j)
            env[node] = arr
        elif node.op == "get_attr":
            env[node] = L.constant(getattr(gm, node.target))
        elif node.op == "call_function":
            res = _lower_node(L, node, get)
            env[node] = res if isinstance(res, (np.ndarray, tuple)) \
                else _scalar_array(res)
        elif node.op == "output":
            res = node.args[0]
            if isinstance(res, (list, tuple)):
                if len(res) != 1:
                    raise CodegenError("a callback must return one tensor")
                res = res[0]
            if _dtype_kind(res) != "f":
                raise CodegenError("a callback must return a float tensor")
            out = env[res]
        else:
            raise CodegenError(f"graph node {node.op}")
    flat_out = list(out.reshape(-1))
    return Program(name, [(tuple(x.shape), k) for x, k in
                          zip(example_inputs, kinds)],
                   L.consts, L.instrs, flat_out, np.shape(out))


def lower_or_none(fn, example_inputs, kinds, name) -> Optional[Program]:
    """:func:`lower`, or None when the callback is not admitted."""
    try:
        return lower(fn, example_inputs, kinds, name)
    except CodegenError:
        return None


#: instructions through which a value that depends on x stays affine in x
#: (``mul`` and ``div`` also need the other factor, or the divisor, free
#: of x, and ``sel`` its predicate); the JAX package's ``_AFFINE_OK``
_AFFINE_OK = frozenset(["add", "sub", "neg", "mul", "div", "sel"])


def affine_in(prog: Program, k: int = 0) -> bool:
    """Static check that ``prog`` is affine in its input ``k`` for every
    value of the other inputs: the counterpart of the JAX package's jaxpr
    walk ``_jaxpr_affine_in_x``.  Fails closed: any value that depends on
    input ``k`` entering another instruction (a comparison, a function,
    a product of two such values) fails it, used or not."""
    dep: list = []

    def d(r):
        return dep[r.i] if isinstance(r, Var) else (
            isinstance(r, In) and r.k == k)

    for op, args in prog.instrs:
        ins = [d(a) for a in args]
        if not any(ins):
            dep.append(False)
            continue
        if (op not in _AFFINE_OK or (op == "mul" and all(ins))
                or (op == "div" and ins[1]) or (op == "sel" and ins[0])):
            return False
        dep.append(True)
    return True
