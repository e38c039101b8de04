"""ATen graph -> dataflow-graph front end (tensor level).

The counterpart of the JAX package's jaxpr front end.  A torch function
is traced on example tensors with ``torch.fx.experimental.proxy_tensor.
make_fx`` (ATen ops, the closest analogue of a jaxpr) and each call in
the FX graph becomes a graph node at the tensor level, with the op names
of the JAX package's ``PRIM2OP``: elementwise ops map 1:1 onto the PE op
vocabulary; matmuls and reductions become zero-PE-cost macro nodes;
structural ops (views, expands, dtype casts, ``clone``, ``detach``) are
elided so mined patterns see the *compute* idioms.

Where ATen keeps as one op what a jaxpr spells as several primitives,
the tracer decomposes it into the jaxpr's sequence, operand order and
node order included, so a torch function and its JAX twin give the same
graph op for op:

* ``mean``: ``rsum`` then ``div`` by the reduced size;
* ``silu``: ``sigmoid`` then ``mul(x, .)`` (``jax.nn.silu``);
* ``gelu(approximate="tanh")``: ``jax.nn.gelu``'s ``integer_pow`` chain;
* ``_softmax``: ``rmax``, ``max(-inf, .)``, ``sub``, ``exp``, ``rsum``,
  ``div`` (``jax.nn.softmax``);
* ``softplus``: ``jax.nn.softplus``'s ``logaddexp(x, 0)`` (``max``,
  ``sub``, ``neq``, ``add``, ``abs``, ``neg``, ``exp``, ``log1p``,
  ``add``, ``sel``, one shared constant 0);
* ``s / x`` (ATen's ``reciprocal`` then ``mul`` by ``s``): ``div(s, x)``.

A Python number that is an operand of an elementwise op becomes a
``const`` node holding its value rounded to float32, as a jaxpr literal
(one node per use, as ``from_jaxpr`` reads each literal afresh); numbers
that are op parameters (dims, ``k``, an integral power) do not.  Ops
with no mapping become ``"opaque"`` nodes, or raise under ``strict``.

Scalar unrolled graphs (MAC chains a la the paper's Fig. 3) come from the
:mod:`repro_torch.graphir.symtrace` front end instead.
"""

from __future__ import annotations

import math
import operator
from typing import Any, Callable, Dict, List

import numpy as np
import torch
from torch import fx

from .graph import Graph

__all__ = ["ATEN2OP", "PASSTHROUGH", "from_fx", "trace_fn"]

# ATen op ("packet" or "packet.overload", overload first) -> op name
ATEN2OP: Dict[str, str] = {
    "add": "add", "sub": "sub", "mul": "mul", "div": "div",
    "true_divide": "div", "neg": "neg", "abs": "abs", "sign": "sign",
    "exp": "exp", "exp2": "exp", "expm1": "exp",
    "log": "log", "log1p": "log",
    "tanh": "tanh", "sigmoid": "sigmoid", "rsqrt": "rsqrt", "sqrt": "sqrt",
    "erf": "erf", "pow": "pow", "square": "mul",
    "maximum": "max", "max.other": "max", "fmax": "max", "clamp": "max",
    "clamp_min": "max", "clamp_max": "min",
    "minimum": "min", "min.other": "min", "fmin": "min",
    "bitwise_and": "and", "logical_and": "and",
    "bitwise_or": "or", "logical_or": "or",
    "bitwise_xor": "xor", "logical_xor": "xor",
    "bitwise_not": "not", "logical_not": "not",
    "eq": "eq", "ne": "neq", "lt": "lt", "le": "lte", "gt": "gt",
    "ge": "gte",
    "bitwise_left_shift": "shl", "__lshift__": "shl",
    "bitwise_right_shift": "ashr", "__rshift__": "ashr",
    "floor": "floor", "round": "round", "nextafter": "add",
    "mm": "matmul", "bmm": "matmul", "matmul": "matmul", "dot": "matmul",
    "mv": "matmul", "einsum": "matmul",
    "sum": "rsum", "amax": "rmax", "max": "rmax", "max.dim": "rmax",
    "amin": "rmin", "min": "rmin", "min.dim": "rmin",
    "all": "rmax", "any": "rmax",
    "cumsum": "cumsum", "logcumsumexp": "cumsum",
    "argmax": "argmax", "argmin": "argmax",
    "sort": "sort", "topk": "top_k",
    "cat": "cat", "gather": "gather", "index": "gather",
    "index_select": "gather", "embedding": "gather",
    "scatter": "scatter", "scatter_add": "scatter", "index_put": "scatter",
    "slice_scatter": "scatter", "select_scatter": "scatter",
    "arange": "iota",
    "atan2": "pow", "remainder": "div", "fmod": "div",
    "cos": "exp", "sin": "exp",
}

# ops forwarded to their first tensor operand (no compute)
PASSTHROUGH = {
    "view", "_unsafe_view", "reshape", "expand", "expand_as", "unsqueeze",
    "squeeze", "permute", "transpose", "t", "slice", "select", "narrow",
    "contiguous", "_to_copy", "to", "type_as", "clone", "detach", "alias",
    "lift_fresh_copy", "flip", "constant_pad_nd", "split",
    "split_with_sizes", "chunk", "unbind", "_reshape_alias", "as_strided",
    "repeat", "view_as", "copy", "_conj", "real", "unflatten", "flatten",
}

# the op names whose Python-number operands become const nodes
_ELEMENTWISE = {
    "add", "sub", "mul", "div", "neg", "abs", "sign", "exp", "log", "tanh",
    "sigmoid", "rsqrt", "sqrt", "erf", "pow", "max", "min", "and", "or",
    "xor", "not", "eq", "neq", "lt", "lte", "gt", "gte", "sel", "shl",
    "shr", "ashr", "floor", "round",
}

# creation ops: a const node with the fill value
_FILL = {"full": 1, "full_like": 1, "scalar_tensor": 0, "zeros": None,
         "zeros_like": None, "ones": None, "ones_like": None}


class _Const:
    """An operand that becomes a fresh const node when it is wired."""

    def __init__(self, value):
        self.value = value


def _f32(v) -> float:
    """A jaxpr literal's value: floats rounded to float32."""
    if isinstance(v, bool):
        return float(v)
    return float(np.float32(v)) if isinstance(v, float) else float(v)


def _names(target):
    """(``"packet.overload"``, ``"packet"``) of an ATen op."""
    packet = getattr(target, "_overloadpacket", None)
    if packet is None:
        return None, getattr(target, "__name__", str(target))
    base = packet.__name__
    return f"{base}.{target._overloadname}", base


def _tensor_operands(args) -> List[fx.Node]:
    out = []
    for a in args:
        if isinstance(a, fx.Node):
            out.append(a)
        elif isinstance(a, (list, tuple)):
            out.extend(_tensor_operands(a))
    return out


def _reduced_size(node: fx.Node, dims) -> int:
    val = node.meta.get("val")
    if val is None:
        return 1
    if dims is None or (isinstance(dims, (list, tuple)) and not dims):
        return int(val.numel())
    dims = [dims] if isinstance(dims, int) else dims
    return int(math.prod(val.shape[d] for d in dims))


class _GraphWriter:
    """Writes one FX graph's nodes into a :class:`Graph`."""

    def __init__(self, g: Graph, env: Dict[fx.Node, int]):
        self.g, self.env = g, env

    def read(self, a) -> int:
        """An operand's node: an FX node's, a node id as it is, or a
        fresh const node."""
        if isinstance(a, _Const):
            return self.g.add_node("const", value=_f32(a.value))
        return a if isinstance(a, int) else self.env[a]

    def emit(self, op: str, operands, prim: str) -> int:
        """The op node, then its operands wired port by port (a const
        node is made when its port is wired, as ``from_jaxpr`` reads a
        literal after it adds the equation's node)."""
        nid = self.g.add_node(op, prim=prim)
        for port, a in enumerate(operands):
            self.g.add_edge(self.read(a), nid, port)
        return nid

    # -- decompositions into the jaxpr's primitive sequences ----------------
    def mean(self, x, dims, prim):
        s = self.emit("rsum", [x], prim)
        return self.emit("div", [s, _Const(float(_reduced_size(x, dims)))],
                         prim)

    def silu(self, x, prim):
        sig = self.emit("sigmoid", [x], prim)
        return self.emit("mul", [x, sig], prim)

    def gelu_tanh(self, x, prim):
        cube = self.emit("pow", [x], prim)                     # integer_pow
        a = self.emit("mul", [_Const(0.044715), cube], prim)
        a = self.emit("add", [x, a], prim)
        a = self.emit("mul", [_Const(math.sqrt(2 / math.pi)), a], prim)
        a = self.emit("tanh", [a], prim)
        a = self.emit("add", [_Const(1.0), a], prim)
        a = self.emit("mul", [_Const(0.5), a], prim)
        return self.emit("mul", [x, a], prim)

    def softmax(self, x, prim):
        m = self.emit("rmax", [x], prim)
        m = self.emit("max", [_Const(-math.inf), m], prim)
        e = self.emit("sub", [x, m], prim)
        e = self.emit("exp", [e], prim)
        s = self.emit("rsum", [e], prim)
        return self.emit("div", [e, s], prim)

    def softplus(self, x, prim):
        # logaddexp(x, 0): its two operands bound once, the 0 shared
        c = self.g.add_node("const", value=0.0)
        j = self.emit("max", [x, c], prim)
        k = self.emit("sub", [x, c], prim)
        nan = self.emit("neq", [k, k], prim)
        m = self.emit("add", [x, c], prim)
        q = self.emit("abs", [k], prim)
        q = self.emit("neg", [q], prim)
        q = self.emit("exp", [q], prim)
        q = self.emit("log", [q], prim)                        # log1p
        r = self.emit("add", [j, q], prim)
        return self.emit("sel", [nan, r, m], prim)


def from_fx(gm, *, strict: bool = False) -> Graph:
    """Convert an ATen-level FX graph (a ``GraphModule`` from ``make_fx``,
    or its ``fx.Graph``) into a tensor-level dataflow Graph: constants
    first, then one ``input`` node per placeholder, the calls in order,
    and one ``output`` node per result."""
    fxg = gm.graph if hasattr(gm, "graph") else gm
    owner = gm if hasattr(gm, "graph") else None
    g = Graph()
    env: Dict[fx.Node, int] = {}
    b = _GraphWriter(g, env)

    for node in fxg.nodes:                      # closed-over constants
        if node.op == "get_attr":
            val = getattr(owner, node.target) if owner is not None else None
            scalar = 0.0
            if isinstance(val, torch.Tensor) and val.numel():
                scalar = float(val.reshape(-1)[0])
            env[node] = g.add_node("const", value=scalar)
    for node in fxg.nodes:
        if node.op == "placeholder":
            name = f"in{sum(1 for op in g.nodes.values() if op == 'input')}"
            env[node] = g.add_node("input", name=name)

    # `s / x` is traced as reciprocal(x) * s: one div, as the jaxpr has it
    folded: Dict[fx.Node, Any] = {}
    for node in fxg.nodes:
        if node.op != "call_function" or _names(node.target)[0] != \
                "mul.Tensor":
            continue
        a0, a1 = node.args[:2]
        for r, s in ((a0, a1), (a1, a0)):
            if isinstance(r, fx.Node) and isinstance(s, (int, float)) and \
                    r.op == "call_function" and \
                    _names(r.target)[1] == "reciprocal" and len(r.users) == 1:
                folded[r] = None
                folded[node] = (r.args[0], s)
                break

    for node in fxg.nodes:
        if node.op != "call_function":
            continue
        target = node.target
        if target is operator.getitem:      # one node for all results
            env[node] = env[node.args[0]]
            continue
        if isinstance(target, torch._ops.HigherOrderOperator):
            raise NotImplementedError(
                f"trace single-layer functions without {target.name()!r}")
        if node in folded:
            if folded[node] is not None:
                x, s = folded[node]
                env[node] = b.emit("div", [_Const(s), x], str(target))
            continue
        full, base = _names(target)
        prim = str(target)
        args = node.args
        kwargs = node.kwargs
        if base in PASSTHROUGH:
            env[node] = env[_tensor_operands(args)[0]]
            continue
        if base in _FILL:
            pos = _FILL[base]
            value = 1.0 if base.startswith("ones") else 0.0
            if pos is not None:
                value = kwargs.get("fill_value", args[pos] if len(args) >
                                   pos else 0.0)
            env[node] = g.add_node("const", value=_f32(value))
            continue
        if base == "mean":
            dims = args[1] if len(args) > 1 else kwargs.get("dim")
            env[node] = b.mean(args[0], dims, prim)
            continue
        if base == "silu":
            env[node] = b.silu(args[0], prim)
            continue
        if base == "gelu" and kwargs.get("approximate", "none") == "tanh":
            env[node] = b.gelu_tanh(args[0], prim)
            continue
        if base in ("_softmax", "softmax"):
            env[node] = b.softmax(args[0], prim)
            continue
        if base == "softplus":
            env[node] = b.softplus(args[0], prim)
            continue
        if base == "reciprocal":
            env[node] = b.emit("div", [_Const(1.0), args[0]], prim)
            continue
        if base == "rsub":                  # rsub(x, y) = y - x
            env[node] = b.emit("sub", [_operand(args[1]), args[0]], prim)
            continue
        if base == "where":                 # select_n(pred, false, true)
            c, t, f = (_operand(a) for a in args[:3])
            env[node] = b.emit("sel", [c, f, t], prim)
            continue
        if base == "pow" and full == "pow.Tensor_Scalar" and \
                float(args[1]).is_integer():
            env[node] = b.emit("pow", [args[0]], prim)   # integer_pow
            continue

        op = ATEN2OP.get(full, ATEN2OP.get(base))
        if op is None:
            if strict:
                raise NotImplementedError(f"unmapped ATen op {prim!r}")
            op = "opaque"
        if op in _ELEMENTWISE:
            operands = [_operand(a) for a in args
                        if isinstance(a, (fx.Node, int, float))]
        else:
            operands = _tensor_operands(args)
        env[node] = b.emit(op, operands, prim)

    out = next(n for n in fxg.nodes if n.op == "output")
    for res in _tensor_operands(out.args):
        nid = env[res]
        o = g.add_node("output")
        g.add_edge(nid, o, 0)
        g.mark_output(nid)
    return g


def _operand(a):
    return a if isinstance(a, fx.Node) else _Const(a)


def trace_fn(fn: Callable, *example_args, strict: bool = False) -> Graph:
    """Trace a torch function on example tensors into a dataflow Graph.
    The function runs once, on the tensors' device."""
    from torch.fx.experimental.proxy_tensor import make_fx

    def call(*args):                    # the example args only, no defaults
        return fn(*args)
    return from_fx(make_fx(call)(*example_args), strict=strict)
