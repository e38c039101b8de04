"""Symbolic scalar tracer: builds CoreIR-style dataflow graphs.

The paper lowers Halide apps to per-output-pixel dataflow graphs of primitive
ops (Fig. 3 shows an unrolled convolution).  We reproduce that front-end with
an operator-overloading tracer: application code is written once against the
functional API below and executes either on plain numpy values (the oracle
path) or on :class:`Sym` values (the graph-building path).

Hash-consing is applied so shared subexpressions become shared nodes — the
paper's overlap analysis (Sec. III-B) is only meaningful on graphs with
sharing.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np

from .graph import Graph

Number = Union[int, float]


class Tracer:
    """Builds a :class:`Graph` from traced scalar arithmetic."""

    def __init__(self) -> None:
        self.graph = Graph()
        self._cse: Dict[Tuple, int] = {}

    # -- leaves -------------------------------------------------------------
    def input(self, name: str) -> "Sym":
        key = ("input", name)
        if key not in self._cse:
            self._cse[key] = self.graph.add_node("input", name=name)
        return Sym(self, self._cse[key])

    def const(self, value: Number) -> "Sym":
        key = ("const", float(value))
        if key not in self._cse:
            self._cse[key] = self.graph.add_node("const", value=value)
        return Sym(self, self._cse[key])

    def output(self, sym: "Sym", name: Optional[str] = None) -> None:
        out = self.graph.add_node("output", name=name)
        self.graph.add_edge(sym.nid, out, 0)
        self.graph.mark_output(sym.nid)

    # -- interior -------------------------------------------------------------
    def emit(self, op: str, *operands: "Sym") -> "Sym":
        key = (op,) + tuple(o.nid for o in operands)
        if key in self._cse:
            return Sym(self, self._cse[key])
        nid = self.graph.add_node(op)
        for port, o in enumerate(operands):
            self.graph.add_edge(o.nid, nid, port)
        self._cse[key] = nid
        return Sym(self, nid)

    def lift(self, v: Union["Sym", Number]) -> "Sym":
        if isinstance(v, Sym):
            return v
        return self.const(v)


class Sym:
    """A traced scalar value (node reference)."""

    __slots__ = ("tracer", "nid")
    __array_priority__ = 100  # beat numpy broadcasting

    def __init__(self, tracer: Tracer, nid: int) -> None:
        self.tracer = tracer
        self.nid = nid

    # binary arithmetic -------------------------------------------------------
    def _bin(self, op: str, other: Union["Sym", Number],
             swap: bool = False) -> "Sym":
        other = self.tracer.lift(other)
        a, b = (other, self) if swap else (self, other)
        return self.tracer.emit(op, a, b)

    def __add__(self, o):   return self._bin("add", o)
    def __radd__(self, o):  return self._bin("add", o, swap=True)
    def __sub__(self, o):   return self._bin("sub", o)
    def __rsub__(self, o):  return self._bin("sub", o, swap=True)
    def __mul__(self, o):   return self._bin("mul", o)
    def __rmul__(self, o):  return self._bin("mul", o, swap=True)
    def __truediv__(self, o):  return self._bin("div", o)
    def __rtruediv__(self, o): return self._bin("div", o, swap=True)
    def __lshift__(self, o):   return self._bin("shl", o)
    def __rshift__(self, o):   return self._bin("ashr", o)
    def __and__(self, o):   return self._bin("and", o)
    def __or__(self, o):    return self._bin("or", o)
    def __xor__(self, o):   return self._bin("xor", o)
    def __neg__(self):      return self.tracer.emit("neg", self)
    def __abs__(self):      return self.tracer.emit("abs", self)

    # comparisons ---------------------------------------------------------------
    def __lt__(self, o):  return self._bin("lt", o)
    def __le__(self, o):  return self._bin("lte", o)
    def __gt__(self, o):  return self._bin("gt", o)
    def __ge__(self, o):  return self._bin("gte", o)

    def eq(self, o):  return self._bin("eq", o)
    def neq(self, o): return self._bin("neq", o)

    def __repr__(self) -> str:  # pragma: no cover
        return f"Sym(#{self.nid}:{self.tracer.graph.nodes[self.nid]})"


# ---------------------------------------------------------------------------
# Functional API — dispatches on Sym vs. numeric so the same application code
# runs under the tracer and under numpy (oracle).
# ---------------------------------------------------------------------------

def _is_sym(*vs: Any) -> Optional[Tracer]:
    for v in vs:
        if isinstance(v, Sym):
            return v.tracer
    return None


def _emit_or_eval(op: str, fallback: Callable, *vs: Any):
    t = _is_sym(*vs)
    if t is None:
        return fallback(*vs)
    return t.emit(op, *(t.lift(v) for v in vs))


def fmax(a, b):   return _emit_or_eval("max", lambda x, y: np.maximum(x, y), a, b)
def fmin(a, b):   return _emit_or_eval("min", lambda x, y: np.minimum(x, y), a, b)
def fabs_(a):     return _emit_or_eval("abs", abs, a)
def fexp(a):      return _emit_or_eval("exp", np.exp, a)
def flog(a):      return _emit_or_eval("log", np.log, a)
def fsqrt(a):     return _emit_or_eval("sqrt", np.sqrt, a)
def frsqrt(a):    return _emit_or_eval("rsqrt", lambda x: 1.0 / np.sqrt(x), a)
def ftanh(a):     return _emit_or_eval("tanh", np.tanh, a)
def fsigmoid(a):  return _emit_or_eval("sigmoid", lambda x: 1.0 / (1.0 + np.exp(-x)), a)
def fsign(a):     return _emit_or_eval("sign", np.sign, a)
def ffloor(a):    return _emit_or_eval("floor", np.floor, a)


def fsel(cond, if_false, if_true):
    """select: cond ? if_true : if_false (port order matches select_n)."""
    return _emit_or_eval(
        "sel", lambda c, f, t: np.where(c, t, f), cond, if_false, if_true)


def fshr(a, bits):
    # NOTE: matches interp/kernel semantics (scale by 2^-b, no floor) —
    # the fixed-point truncation is a quantization detail the float
    # dataflow graphs do not model
    return _emit_or_eval(
        "ashr", lambda x, b: x / (2 ** b), a, bits)


def fshl(a, bits):
    return _emit_or_eval("shl", lambda x, b: x * (2 ** b), a, bits)


def fclamp(x, lo, hi):
    return fmin(fmax(x, lo), hi)


def frelu(x):
    return fmax(x, 0.0)


def trace(fn: Callable[..., Any], input_names: List[str]) -> Graph:
    """Trace `fn(tracer_inputs...) -> value or list of values` into a Graph."""
    t = Tracer()
    args = [t.input(n) for n in input_names]
    out = fn(*args)
    outs = out if isinstance(out, (tuple, list)) else [out]
    for i, o in enumerate(outs):
        t.output(o, name=f"out{i}")
    return t.graph
