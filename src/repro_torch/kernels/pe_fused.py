"""Generated fused-PE kernel (K4) — the paper's technique on the card.

A CGRA PE specialized for a mined subgraph executes the whole multi-op
dataflow graph in one configured datapath pass.  The accelerator analogue:
given the same subgraph (an elementwise op-DAG from mining and merging),
*generate* a kernel whose body evaluates the DAG in registers, so each
application of the PE reads every operand once and writes every sink
once instead of going through memory once per primitive op.

:func:`lower_pattern` walks ``pattern.topo_order()`` once into a short
typed program (:class:`PEProgram`) and renders it twice:

* as Triton code — kernel K4, replacing the reference's Pallas
  ``pe_kernel_body`` (``repro/kernels/pe_fused.py``).  One straight-line
  ``@triton.jit`` function per pattern, with the constants baked in, over
  a flat 1-D grid of the ``n`` elements with a mask (the reference pads
  to (256, 256) tiles and crops back; the valid region is the same).  K4
  reads each input once and writes each output once: bytes bound it.
  Triton compiles a new pattern in-process, where ``nvcc`` would take
  seconds per pattern, and ``jit`` reads the function's source through
  ``inspect``, so each rendering is written to
  ``build/kernels/pe_<hash>.py`` and imported from there;
* as PyTorch code — :func:`pe_apply_plain`, the plain version.  Both
  renderings come from the same walk, so the CPU tests that hold the
  plain version to the JAX package test the walk itself: port order,
  argument order and constant baking.

Semantics are the reference's ``_JNP_SEMANTICS`` (:data:`_TORCH_SEMANTICS`
is its torch copy), not the simulator's ALU table: ``shr``/``ashr`` are
``a * exp2(-b)``, ``sigmoid`` is the logistic function, ``round`` is half
to even, ``sign`` keeps NaN.  Comparisons and ``and``/``or``/``xor``/``not``
give booleans; the walk tracks which values are boolean and lowers an op
on booleans the way JAX types it (``add``/``max`` of two booleans is
``or``, ``mul``/``min`` is ``and``, ``abs``/``floor`` keep them, other ops
promote them to 0.0/1.0), and records the ``TypeError``/``ValueError``
JAX raises where it refuses booleans (``sub`` of two, ``neg``, ``sign``,
``sigmoid``, ``rsqrt``, ``erf``, ``round``, a boolean shift count), raised
when the kernel is called, as the reference raises when it is traced.
``pow`` of two booleans is int32 in JAX and float here (same values).

Both versions compute in float32: bfloat16 or float16 inputs are loaded
and widened, and each output is rounded once to ``inputs[0].dtype``.
JAX promotes per op on bfloat16 (the baked constants are float32, so some
ops promote and others stay bfloat16); the port is held to the reference
tests' bfloat16 tolerance of 5e-2.
"""

from __future__ import annotations

import hashlib
import importlib.util
import json
import math
import os
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..graphir.graph import Graph, free_in_ports, sink_nodes
from ..graphir.ops import OPS
from ..obs import buildprof

__all__ = ["PEProgram", "block_size", "lower_pattern", "make_pe_kernel",
           "kernel_from_config", "pe_apply", "pe_apply_plain"]


def _sign(a):
    # keeps -0.0, +0.0 and NaN, as jnp.sign does
    return torch.where(a > 0, 1.0, torch.where(a < 0, -1.0, a))


def _sel(c, f, t):
    return torch.where(c if c.dtype == torch.bool else c != 0, t, f)


# torch copy of the reference's _JNP_SEMANTICS (float32 operands)
_TORCH_SEMANTICS: Dict[str, Callable] = {
    "add": lambda a, b: a + b,
    "sub": lambda a, b: a - b,
    "neg": lambda a: -a,
    "abs": lambda a: torch.abs(a),
    "mul": lambda a, b: a * b,
    "mac": lambda a, b, c: a * b + c,
    "div": lambda a, b: a / b,
    "recip": lambda a: 1.0 / a,
    "shl": lambda a, b: a * torch.exp2(b),
    "shr": lambda a, b: a * torch.exp2(-b),
    "ashr": lambda a, b: a * torch.exp2(-b),
    "eq": lambda a, b: a == b,
    "neq": lambda a, b: a != b,
    "lt": lambda a, b: a < b,
    "lte": lambda a, b: a <= b,
    "gt": lambda a, b: a > b,
    "gte": lambda a, b: a >= b,
    "min": lambda a, b: torch.minimum(a, b),
    "max": lambda a, b: torch.maximum(a, b),
    "and": lambda a, b: torch.logical_and(a, b),
    "or": lambda a, b: torch.logical_or(a, b),
    "xor": lambda a, b: torch.logical_xor(a, b),
    "not": lambda a: torch.logical_not(a),
    "sign": _sign,
    "sel": _sel,
    "exp": lambda a: torch.exp(a),
    "log": lambda a: torch.log(a),
    "tanh": lambda a: torch.tanh(a),
    "sigmoid": lambda a: torch.sigmoid(a),
    "rsqrt": lambda a: torch.rsqrt(a),
    "sqrt": lambda a: torch.sqrt(a),
    "erf": lambda a: torch.erf(a),
    "pow": lambda a, b: torch.pow(a, b),
    "floor": lambda a: torch.floor(a),
    "round": lambda a: torch.round(a),
}

_BOOL_RESULT = {"eq", "neq", "lt", "lte", "gt", "gte", "and", "or", "xor",
                "not"}
_LOGICAL = {"and", "or", "xor", "not"}
# op -> (argument positions that must not be boolean, error JAX raises)
_NO_BOOL = {"neg": ((0,), TypeError), "sign": ((0,), TypeError),
            "sigmoid": ((0,), TypeError), "rsqrt": ((0,), TypeError),
            "erf": ((0,), TypeError), "round": ((0,), ValueError),
            "shr": ((1,), TypeError), "ashr": ((1,), TypeError)}

#: dtypes K4 loads and stores; other inputs are converted to float32
_IO_DTYPES = (torch.float32, torch.bfloat16, torch.float16)


@dataclass(frozen=True)
class Stmt:
    """``dst = op(*args)``; ``op`` is a key of :data:`_TORCH_SEMANTICS`,
    ``"const"`` (``value``), ``"cast"`` (boolean to float) or ``"copy"``."""

    dst: str
    op: str
    args: Tuple[str, ...] = ()
    value: float = 0.0


@dataclass(frozen=True)
class PEProgram:
    """One pattern lowered: inputs ``p0..`` (one per free in-port, in
    ``free_in_ports`` order), statements in topological order, and the
    variable of each sink (``sink_nodes`` order)."""

    n_in: int
    stmts: Tuple[Stmt, ...]
    outs: Tuple[str, ...]
    bools: frozenset                  # variables holding booleans
    error: Optional[Tuple[type, str]]  # what JAX raises when traced
    key: str                          # hash of the pattern's to_dict()

    @property
    def n_compute(self) -> int:
        """Operations per element (constants, casts and copies excluded)."""
        return sum(s.op not in ("const", "cast", "copy") for s in self.stmts)

    def raise_error(self) -> None:
        if self.error is not None:
            raise self.error[0](self.error[1])


def pattern_key(pattern: Graph) -> str:
    blob = json.dumps(pattern.to_dict(), sort_keys=True)
    return hashlib.sha256(blob.encode()).hexdigest()


_PROGRAMS: Dict[str, PEProgram] = {}


def lower_pattern(pattern: Graph) -> PEProgram:
    """Walk the pattern once into a :class:`PEProgram` (cached by the
    hash of ``pattern.to_dict()``).  Raises ``ValueError`` as the
    reference's ``make_pe_kernel`` does: no free in-port, or an op
    outside the semantics table."""
    key = pattern_key(pattern)
    prog = _PROGRAMS.get(key)
    if prog is None:
        prog = _PROGRAMS[key] = _Walk(pattern, key).program()
    return prog


class _Walk:
    def __init__(self, pattern: Graph, key: str) -> None:
        free = free_in_ports(pattern)
        if not free:
            raise ValueError("pattern has no free in-ports")
        for op in pattern.nodes.values():
            if op not in _TORCH_SEMANTICS and op != "const":
                raise ValueError(f"op {op!r} not supported in PE kernels")
        self.pattern, self.key = pattern, key
        self.port = {fp: f"p{i}" for i, fp in enumerate(free)}
        self.stmts: List[Stmt] = []
        self.bools: set = set()
        self.error: Optional[Tuple[type, str]] = None
        self.n_tmp = 0

    def program(self) -> PEProgram:
        g = self.pattern
        var: Dict[int, str] = {}
        for n in g.topo_order():
            op = g.nodes[n]
            if op == "const":
                value = float(np.float32(g.attr(n, "value", 0.0)))
                var[n] = self._emit("const", (), value, dst=f"v{n}")
                continue
            ins = g.in_edges(n)
            args = [var[ins[p]] if p in ins else self.port[(n, p)]
                    for p in range(OPS[op].arity)]
            var[n] = self._op(op, args, dst=f"v{n}")
        return PEProgram(len(self.port), tuple(self.stmts),
                         tuple(var[s] for s in sink_nodes(g)),
                         frozenset(self.bools), self.error, self.key)

    def _emit(self, op, args, value=0.0, *, dst=None, boolean=False) -> str:
        if dst is None:
            dst = f"t{self.n_tmp}"
            self.n_tmp += 1
        self.stmts.append(Stmt(dst, op, tuple(args), value))
        if boolean:
            self.bools.add(dst)
        return dst

    def _float(self, a: str) -> str:
        return self._emit("cast", (a,)) if a in self.bools else a

    def _op(self, op: str, args: List[str], dst=None) -> str:
        isb = [a in self.bools for a in args]
        if op in _LOGICAL:             # truth tests of floats or booleans
            return self._emit(op, args, dst=dst, boolean=True)
        if all(isb):                   # ops JAX keeps boolean
            if op in ("add", "max"):
                return self._emit("or", args, dst=dst, boolean=True)
            if op in ("mul", "min"):
                return self._emit("and", args, dst=dst, boolean=True)
            if op in ("abs", "floor"):
                return self._emit("copy", args, dst=dst, boolean=True)
            if op == "sub" and self.error is None:
                self.error = (TypeError, "sub does not accept dtype bool")
        if op == "mac" and any(isb):   # a * b + c with JAX's promotion
            return self._op("add", [self._op("mul", args[:2]), args[2]],
                            dst=dst)
        if op == "sel":
            c, f, t = args
            if f in self.bools and t in self.bools:
                return self._emit("sel", (c, f, t), dst=dst, boolean=True)
            return self._emit("sel", (c, self._float(f), self._float(t)),
                              dst=dst)
        if op in _NO_BOOL and self.error is None:
            pos, exc = _NO_BOOL[op]
            if any(isb[p] for p in pos):
                self.error = (exc, f"{op} does not accept dtype bool")
        return self._emit(op, [self._float(a) for a in args], dst=dst,
                          boolean=op in _BOOL_RESULT)


# ---------------------------------------------------------------------------
# the two renderings
# ---------------------------------------------------------------------------
def _py_float(value: float) -> str:
    return f"float.fromhex({float.hex(value)!r})"


def torch_source(prog: PEProgram) -> str:
    """The PyTorch rendering: ``pe_plain(p0, .., dev) -> tuple``."""
    ports = ", ".join(f"p{i}" for i in range(prog.n_in))
    lines = [f"def pe_plain({ports}, dev):"]
    for s in prog.stmts:
        if s.op == "const":
            rhs = (f"torch.tensor({_py_float(s.value)}, "
                   f"dtype=torch.float32, device=dev)")
        elif s.op == "cast":
            rhs = f"{s.args[0]}.to(torch.float32)"
        elif s.op == "copy":
            rhs = s.args[0]
        else:
            rhs = f"S[{s.op!r}]({', '.join(s.args)})"
        lines.append(f"    {s.dst} = {rhs}")
    lines.append(f"    return ({''.join(o + ', ' for o in prog.outs)})")
    return "\n".join(lines) + "\n"


_F32_BITS = "tl.full([BLOCK], {bits}, tl.int32).to(tl.float32, bitcast=True)"

_TRITON_EXPR = {
    "add": "{0} + {1}",
    "sub": "{0} - {1}",
    "neg": "-{0}",
    "abs": "tl.abs({0})",
    "mul": "{0} * {1}",
    "mac": "{0} * {1} + {2}",
    "div": "tl.div_rn({0}, {1})",
    "recip": "tl.div_rn(tl.full([BLOCK], 1.0, tl.float32), {0})",
    "shl": "{0} * libdevice.exp2({1})",
    "shr": "{0} * libdevice.exp2(-{1})",
    "ashr": "{0} * libdevice.exp2(-{1})",
    "eq": "{0} == {1}",
    "neq": "{0} != {1}",
    "lt": "{0} < {1}",
    "lte": "{0} <= {1}",
    "gt": "{0} > {1}",
    "gte": "{0} >= {1}",
    "min": "tl.minimum({0}, {1}, propagate_nan=tl.PropagateNan.ALL)",
    "max": "tl.maximum({0}, {1}, propagate_nan=tl.PropagateNan.ALL)",
    "and": "{0} & {1}",
    "or": "{0} | {1}",
    "xor": "{0} ^ {1}",
    "not": "{0} == 0",
    "sign": "tl.where({0} > 0.0, 1.0, tl.where({0} < 0.0, -1.0, {0}))",
    "sel": "tl.where({0}, {2}, {1})",
    "exp": "libdevice.exp({0})",
    "log": "libdevice.log({0})",
    "tanh": "libdevice.tanh({0})",
    "sigmoid": ("tl.div_rn(tl.full([BLOCK], 1.0, tl.float32), "
                "1.0 + libdevice.exp(-{0}))"),
    "rsqrt": "libdevice.rsqrt({0})",
    "sqrt": "tl.sqrt_rn({0})",
    "erf": "libdevice.erf({0})",
    "pow": "libdevice.pow({0}, {1})",
    "floor": "libdevice.floor({0})",
    "round": "libdevice.rint({0})",
}
# ops whose operands are truth-tested (a float operand x becomes x != 0)
_TRUTH_ARGS = {"and": (0, 1), "or": (0, 1), "xor": (0, 1), "not": (0,),
               "sel": (0,)}


def _triton_const(value: float) -> str:
    if math.isfinite(value):
        return f"tl.full([BLOCK], {value!r}, tl.float32)"
    bits = int(np.array(value, np.float32).view(np.int32))
    return _F32_BITS.format(bits=bits)


def triton_source(prog: PEProgram) -> str:
    """The Triton rendering: ``pe_kernel(in0.., out0.., n, BLOCK)``."""
    ins = [f"in{i}" for i in range(prog.n_in)]
    outs = [f"out{j}" for j in range(len(prog.outs))]
    body = ["    offs = tl.program_id(0).to(tl.int64) * BLOCK "
            "+ tl.arange(0, BLOCK)",
            "    mask = offs < n"]
    body += [f"    p{i} = tl.load(in{i} + offs, mask=mask, other=0.0)"
             f".to(tl.float32)" for i in range(prog.n_in)]
    for s in prog.stmts:
        if s.op == "const":
            rhs = _triton_const(s.value)
        elif s.op == "cast":
            rhs = f"{s.args[0]}.to(tl.float32)"
        elif s.op == "copy":
            rhs = s.args[0]
        else:
            args = list(s.args)
            for p in _TRUTH_ARGS.get(s.op, ()):
                if args[p] not in prog.bools:
                    args[p] = f"({args[p]} != 0.0)"
            rhs = _TRITON_EXPR[s.op].format(*args)
        body.append(f"    {s.dst} = {rhs}")
    for o, v in zip(outs, prog.outs):
        cast = ".to(tl.float32)" if v in prog.bools else ""
        body.append(f"    tl.store({o} + offs, {v}{cast}"
                    f".to({o}.dtype.element_ty), mask=mask)")
    head = ["# generated by repro_torch.kernels.pe_fused (kernel K4)",
            "import triton",
            "import triton.language as tl",
            "from triton.language.extra import libdevice",
            "", "",
            "@triton.jit",
            f"def pe_kernel({', '.join(ins + outs)}, n, "
            f"BLOCK: tl.constexpr):"]
    return "\n".join(head + body) + "\n"


# ---------------------------------------------------------------------------
# plain version and kernel
# ---------------------------------------------------------------------------
_TORCH_FNS: Dict[str, Callable] = {}


def _torch_fn(prog: PEProgram) -> Callable:
    fn = _TORCH_FNS.get(prog.key)
    if fn is None:
        scope = {"S": _TORCH_SEMANTICS, "torch": torch}
        exec(compile(torch_source(prog), f"<pe_plain {prog.key[:12]}>",
                     "exec"), scope)
        fn = _TORCH_FNS[prog.key] = scope["pe_plain"]
    return fn


def _as_program(pattern) -> PEProgram:
    return pattern if isinstance(pattern, PEProgram) else \
        lower_pattern(pattern)


def _unwrap(outs: Tuple[torch.Tensor, ...]):
    return outs if len(outs) > 1 else outs[0]


def _prepare(prog: PEProgram, inputs: Sequence[torch.Tensor]
             ) -> List[torch.Tensor]:
    if len(inputs) != prog.n_in:
        raise TypeError(f"expected {prog.n_in} inputs, got {len(inputs)}")
    prog.raise_error()
    xs = [x if x.dtype in _IO_DTYPES else x.to(torch.float32)
          for x in inputs]
    for x in xs[1:]:
        if x.shape != xs[0].shape:
            raise ValueError(f"inputs must share one shape: "
                             f"{tuple(xs[0].shape)} vs {tuple(x.shape)}")
        if x.device != xs[0].device:
            raise ValueError("inputs must lie on one device")
    return xs


def pe_apply_plain(pattern, *inputs: torch.Tensor):
    """Plain version of K4: the PyTorch rendering of the pattern, in
    float32, each output rounded to ``inputs[0].dtype``.  ``pattern`` is
    a :class:`~repro_torch.graphir.graph.Graph` or a :class:`PEProgram`;
    returns one tensor per sink (a tuple when there are several)."""
    prog = _as_program(pattern)
    xs = _prepare(prog, inputs)
    x0 = xs[0]
    outs = _torch_fn(prog)(*[x.to(torch.float32) for x in xs], x0.device)
    return _unwrap(tuple(torch.broadcast_to(o, x0.shape).to(x0.dtype)
                         for o in outs))


_LOCK = threading.Lock()
_KERNELS: Dict[str, Callable] = {}


def _triton_kernel(prog: PEProgram) -> Callable:
    """Write the Triton rendering to ``build/kernels/pe_<hash>.py`` and
    import its ``pe_kernel`` (cached by the source's hash)."""
    src = triton_source(prog)
    tag = hashlib.sha256(src.encode()).hexdigest()[:16]
    with _LOCK:
        fn = _KERNELS.get(tag)
        if fn is not None:
            return fn
        from .build import _build_dir
        out_dir = _build_dir()
        out_dir.mkdir(parents=True, exist_ok=True)
        path = out_dir / f"pe_{tag}.py"
        if not path.exists() or path.read_text() != src:
            tmp = path.with_suffix(f".{os.getpid()}.tmp")
            tmp.write_text(src)
            os.replace(tmp, path)
        spec = importlib.util.spec_from_file_location(f"pe_{tag}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        fn = _KERNELS[tag] = mod.pe_kernel
        return fn


#: K4's elements per program when the caller names none
DEFAULT_BLOCK = 1024


def block_size(block) -> int:
    """K4's elements per program for ``block``: an int is taken as it is;
    the reference's ``(bm, bn)`` tile is a TPU VMEM tiling, accepted as a
    hint that changes no result and mapped to :data:`DEFAULT_BLOCK`."""
    if isinstance(block, (tuple, list)):
        if len(block) != 2 or any(int(b) <= 0 for b in block):
            raise ValueError(f"block must be an int or a (bm, bn) pair of "
                             f"positive ints, got {block!r}")
        return DEFAULT_BLOCK
    return int(block)


def pe_apply(pattern, *inputs: torch.Tensor, block=DEFAULT_BLOCK):
    """Apply a PE pattern elementwise: one input per free in-port, all of
    one shape and device; one output per sink, of the first input's shape
    and dtype (a tuple when there are several sinks).

    Kernel K4 for CUDA tensors (one launch, counted in
    ``pe_apply.launches``; ``block`` elements per program, a power of
    two, or the reference's ``(bm, bn)`` tile, see :func:`block_size`);
    the plain version for CPU tensors.  A Triton failure raises.
    """
    prog = _as_program(pattern)
    xs = _prepare(prog, inputs)
    x0 = xs[0]
    block = block_size(block)
    if x0.device.type != "cuda":
        return pe_apply_plain(prog, *xs)
    if block <= 0 or block & (block - 1):
        raise ValueError(f"block must be a power of two, got {block}")
    import triton
    kernel = _triton_kernel(prog)
    flat = [x.contiguous().view(-1) for x in xs]
    outs = tuple(torch.empty(x0.shape, dtype=x0.dtype, device=x0.device)
                 for _ in prog.outs)
    n = x0.numel()
    if n:
        args = (*flat, *[o.view(-1) for o in outs])
        fresh = _new_specialisation(kernel, args, n, block)
        t0 = time.perf_counter()
        kernel[(triton.cdiv(n, block),)](
            *args, n, BLOCK=block, num_warps=4, enable_fp_fusion=False)
        pe_apply.launches += 1
        if fresh:
            buildprof.record("triton", time.perf_counter() - t0,
                             pattern=prog.key[:16])
    return _unwrap(outs)


pe_apply.launches = 0

_SPECIALISED: set = set()


def _new_specialisation(kernel, args, n: int, block: int) -> bool:
    """True the first time this process launches ``kernel`` with this
    specialisation key, the launch Triton's JIT compiles for: the
    pointers' dtypes and 16-byte alignment, ``n`` equal to 1 or divisible
    by 16 (Triton's integer specialisation), and ``BLOCK``.  ``kernel``
    stays in ``_KERNELS`` for the life of the process, so its id is
    unique."""
    key = (id(kernel),
           tuple((t.dtype, t.data_ptr() % 16 == 0) for t in args),
           n == 1, n % 16 == 0, block)
    with _LOCK:
        fresh = key not in _SPECIALISED
        _SPECIALISED.add(key)
    return fresh


def make_pe_kernel(pattern: Graph, *, block=DEFAULT_BLOCK,
                   device="cuda") -> Callable:
    """Compile a mined/merged PE pattern into a fused elementwise kernel.

    Returns ``f(*inputs) -> output`` (a tuple for multi-sink PEs).  Inputs
    (tensors or arrays, one shape) are moved to ``device``: K4 runs on the
    card (the default; raises without one), the plain version on
    ``device="cpu"``.  Raises ``ValueError`` for a pattern without free
    in-ports or with an unsupported op; ``f`` raises ``TypeError`` for a
    wrong number of inputs.  ``block`` is K4's elements per program or
    the reference's ``(bm, bn)`` tile (:func:`block_size`).
    """
    dev = resolve_device(device)
    prog = lower_pattern(pattern)
    block = block_size(block)

    def run(*inputs):
        return pe_apply(prog, *[torch.as_tensor(x, device=dev)
                                for x in inputs], block=block)

    return run


def kernel_from_config(dp, config_name: str, **kw) -> Callable:
    """Fused kernel for one configuration of a merged PE datapath."""
    cfg = dp.configs[config_name]
    return make_pe_kernel(cfg.pattern, **kw)
