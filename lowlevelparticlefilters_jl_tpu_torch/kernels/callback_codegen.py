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

A program prints as a CUDA C++ function template
``template <class S> void name(const S* in0, const float* in1, ...,
const float* c, S* out)`` (:meth:`Program.cpp`) over the helpers of
``csrc/dual.cuh``: with ``S = float`` it computes the value, with
``S = Dual<N>`` also its Jacobian by forward-mode dual numbers, the
counterpart of the in-kernel ``jax.jacfwd``.  :meth:`Program.evaluate`
runs the same program in Python, on floats or on :class:`PyDual`
numbers with the same derivative rules, so the CPU tests hold the
lowering against the callback and ``torch.func.jacfwd``.

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
# Scalar semantics: the Python evaluation (floats or PyDual) of every
# instruction, mirrored by csrc/dual.cuh
# ---------------------------------------------------------------------------


class PyDual:
    """A forward-mode dual number: value ``v`` and tangent vector ``d``."""

    __slots__ = ("v", "d")

    def __init__(self, v: float, d: np.ndarray):
        self.v, self.d = float(v), d


def _val(a):
    return a.v if isinstance(a, PyDual) else a


def _lift(fn, dfn):
    """A unary op from its value and derivative functions."""
    def op(a):
        if isinstance(a, PyDual):
            return PyDual(fn(a.v), dfn(a.v) * a.d)
        return fn(a)
    return op


def _binary(fn, da, db):
    """A binary op from its value and partial derivatives."""
    def op(a, b):
        if isinstance(a, PyDual) or isinstance(b, PyDual):
            av, bv = _val(a), _val(b)
            d = 0.0
            if isinstance(a, PyDual):
                d = d + da(av, bv) * a.d
            if isinstance(b, PyDual):
                d = d + db(av, bv) * b.d
            return PyDual(fn(av, bv), d)
        return fn(a, b)
    return op


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


def _powc(a, c):
    try:
        return math.pow(a, c)
    except (ValueError, ZeroDivisionError):
        return math.nan if a < 0 else math.inf


def _sel(c, a, b):
    return a if c else b


_ZERO = lambda v: 0.0  # noqa: E731

_EVAL = {
    "add": _binary(operator.add, lambda a, b: 1.0, lambda a, b: 1.0),
    "sub": _binary(operator.sub, lambda a, b: 1.0, lambda a, b: -1.0),
    "mul": _binary(operator.mul, lambda a, b: b, lambda a, b: a),
    "div": _binary(_div, lambda a, b: _div(1.0, b),
                   lambda a, b: _div(-a, b * b)),
    "neg": _lift(operator.neg, lambda v: -1.0),
    "sqrt": _lift(_sqrt, lambda v: _div(0.5, _sqrt(v))),
    "exp": _lift(math.exp, math.exp),
    "log": _lift(_log, lambda v: _div(1.0, v)),
    "expm1": _lift(math.expm1, math.exp),
    "log1p": _lift(math.log1p, lambda v: _div(1.0, 1.0 + v)),
    "sin": _lift(math.sin, math.cos),
    "cos": _lift(math.cos, lambda v: -math.sin(v)),
    "tanh": _lift(math.tanh, lambda v: 1.0 - math.tanh(v) ** 2),
    "sigmoid": _lift(_sigmoid, lambda v: _sigmoid(v) * (1.0 - _sigmoid(v))),
    "abs": _lift(abs, _sign),
    "sign": _lift(_sign, _ZERO),
    "floor": _lift(lambda v: float(math.floor(v)), _ZERO),
    "ceil": _lift(lambda v: float(math.ceil(v)), _ZERO),
    "round": _lift(lambda v: float(round(v)), _ZERO),
    "powc": _binary(_powc, lambda a, c: c * _powc(a, c - 1.0),
                    lambda a, c: 0.0),
    "powt": _binary(_powc, lambda a, b: b * _powc(a, b - 1.0),
                    lambda a, b: _powc(a, b) * _log(a)),
    "atan2": _binary(math.atan2, lambda y, x: _div(x, x * x + y * y),
                     lambda y, x: _div(-y, x * x + y * y)),
    "rem": _binary(_rem, lambda a, b: 1.0,
                   lambda a, b: -float(math.floor(a / b))),
    "fmod": _binary(math.fmod, lambda a, b: 1.0,
                    lambda a, b: -float(math.trunc(a / b))),
    "lt": lambda a, b: _val(a) < _val(b),
    "le": lambda a, b: _val(a) <= _val(b),
    "gt": lambda a, b: _val(a) > _val(b),
    "ge": lambda a, b: _val(a) >= _val(b),
    "eq": lambda a, b: _val(a) == _val(b),
    "ne": lambda a, b: _val(a) != _val(b),
    "and": lambda a, b: bool(a) and bool(b),
    "or": lambda a, b: bool(a) or bool(b),
    "xor": lambda a, b: bool(a) != bool(b),
    "not": lambda a: not a,
    "isfinite": lambda a: math.isfinite(_val(a)),
    "tofloat": lambda a: 1.0 if a else 0.0,
    "tobool": lambda a: _val(a) != 0.0,
    "sel": _sel,
}

# the C++ spelling of each instruction (csrc/dual.cuh); {0}, {1}, {2} are
# the operands
_CPP = {
    "add": "({0} + {1})", "sub": "({0} - {1})", "mul": "({0} * {1})",
    "div": "({0} / {1})", "neg": "(-{0})",
    "lt": "(m_val({0}) < m_val({1}))", "le": "(m_val({0}) <= m_val({1}))",
    "gt": "(m_val({0}) > m_val({1}))", "ge": "(m_val({0}) >= m_val({1}))",
    "eq": "(m_val({0}) == m_val({1}))", "ne": "(m_val({0}) != m_val({1}))",
    "and": "({0} && {1})", "or": "({0} || {1})", "xor": "({0} != {1})",
    "not": "(!{0})", "isfinite": "isfinite(m_val({0}))",
    "tofloat": "({0} ? 1.0f : 0.0f)", "tobool": "(m_val({0}) != 0.0f)",
    "sel": "m_sel({0}, {1}, {2})",
}
for _name in ("sqrt", "exp", "log", "expm1", "log1p", "sin", "cos", "tanh",
              "sigmoid", "abs", "sign", "floor", "ceil", "round"):
    _CPP[_name] = f"m_{_name}({{0}})"
for _name in ("powc", "powt", "atan2", "rem", "fmod"):
    _CPP[_name] = f"m_{_name}({{0}}, {{1}})"


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


# ---------------------------------------------------------------------------
# The program
# ---------------------------------------------------------------------------


class Program:
    """A callback lowered to scalar instructions.

    ``inputs``: (shape, kind) per argument, kind ``"S"`` for an argument
    of the template type and ``"f"`` for a float one; ``consts``: the
    hoisted constant tensors in buffer order; ``instrs``: ``(op, args)``,
    instruction ``i`` defining ``Var(i)``; ``out``: the output's scalar
    references (row-major) and ``out_shape`` its shape."""

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
        """Run the program on flat per-input lists of floats or
        :class:`PyDual` numbers and a flat constants list."""
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
        ``wrt``, evaluated in Python in float64 (for the tests)."""
        flat = [a.detach().double().reshape(-1).tolist() for a in args]
        n = len(flat[wrt])
        flat[wrt] = [PyDual(v, np.eye(n)[i]) for i, v in enumerate(flat[wrt])]
        consts = [v for c in self.consts
                  for v in c.detach().double().reshape(-1).tolist()]
        out = self.evaluate(flat, consts)
        val = torch.tensor([float(_val(o)) for o in out], dtype=torch.float64)
        jac = torch.tensor(np.stack([o.d if isinstance(o, PyDual)
                                     else np.zeros(n) for o in out]),
                           dtype=torch.float64)
        return val.reshape(self.out_shape), jac.reshape(*self.out_shape, n)

    # -- C++ -----------------------------------------------------------
    def cpp(self, const_base: int = 0) -> str:
        """The program as a ``__device__`` function template; its
        constants start at ``c[const_base]``."""
        def ref(r):
            if isinstance(r, Var):
                return f"v{r.i}"
            if isinstance(r, In):
                return f"in{r.k}[{r.i}]"
            if isinstance(r, Const):
                return f"c[{const_base + r.i}]"
            return _flit(r.v)

        params = [f"const {'S' if kind == 'S' else 'float'}* __restrict__ "
                  f"in{k}" for k, (_, kind) in enumerate(self.inputs)]
        lines = ["template <class S>",
                 f"__device__ __forceinline__ void {self.name}("
                 + ", ".join(params + ["const float* __restrict__ c",
                                       "S* __restrict__ out"]) + ") {"]
        for i, (op, args) in enumerate(self.instrs):
            lines.append(f"  const auto v{i} = "
                         + _CPP[op].format(*[ref(a) for a in args]) + ";")
        for i, r in enumerate(self.out):
            lines.append(f"  out[{i}] = S({ref(r)});")
        lines.append("}")
        return "\n".join(lines)


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
