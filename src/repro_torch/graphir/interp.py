"""Dataflow-graph interpreter — the pure-numpy oracle for everything.

Used to (a) validate traced graphs against the original function, (b) prove a
merged PE datapath can execute each source subgraph under some configuration
(core/merge.py tests), and (c) serve as the reference implementation for the
generated fused Pallas kernel (kernels/ref.py delegates here).

All ops execute elementwise over numpy (or jnp) arrays; ``sel`` follows
``select_n`` port order (port0 = predicate, port1 = false, port2 = true).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from .graph import Graph, free_in_ports, sink_nodes

SEMANTICS: Dict[str, Callable] = {
    "add": lambda a, b: a + b,
    "sub": lambda a, b: a - b,
    "neg": lambda a: -a,
    "abs": lambda a: abs(a) if np.isscalar(a) else np.abs(a),
    "mul": lambda a, b: a * b,
    "mac": lambda a, b, c: a * b + c,
    "div": lambda a, b: a / b,
    "recip": lambda a: 1.0 / a,
    "shl": lambda a, b: a * (2.0 ** b),
    "shr": lambda a, b: a / (2.0 ** b),
    "ashr": lambda a, b: a / (2.0 ** b),
    "eq": lambda a, b: a == b,
    "neq": lambda a, b: a != b,
    "lt": lambda a, b: a < b,
    "lte": lambda a, b: a <= b,
    "gt": lambda a, b: a > b,
    "gte": lambda a, b: a >= b,
    "min": lambda a, b: np.minimum(a, b),
    "max": lambda a, b: np.maximum(a, b),
    "and": lambda a, b: np.logical_and(a, b),
    "or": lambda a, b: np.logical_or(a, b),
    "xor": lambda a, b: np.logical_xor(a, b),
    "not": lambda a: np.logical_not(a),
    "sign": lambda a: np.sign(a),
    "sel": lambda c, f, t: np.where(c, t, f),
    "exp": lambda a: np.exp(a),
    "log": lambda a: np.log(a),
    "tanh": lambda a: np.tanh(a),
    "sigmoid": lambda a: 1.0 / (1.0 + np.exp(-a)),
    "rsqrt": lambda a: 1.0 / np.sqrt(a),
    "sqrt": lambda a: np.sqrt(a),
    "erf": lambda a: _erf(a),
    "pow": lambda a, b: a ** b,
    "floor": lambda a: np.floor(a),
    "round": lambda a: np.round(a),
}


def _erf(a):
    try:
        from scipy.special import erf  # pragma: no cover - optional
        return erf(a)
    except Exception:
        # Abramowitz-Stegun rational approx, good to ~1.5e-7
        x = np.asarray(a, dtype=np.float64)
        s = np.sign(x)
        x = np.abs(x)
        t = 1.0 / (1.0 + 0.3275911 * x)
        y = 1.0 - (((((1.061405429 * t - 1.453152027) * t) + 1.421413741)
                    * t - 0.284496736) * t + 0.254829592) * t * np.exp(-x * x)
        return s * y


def interpret(graph: Graph, inputs: Dict[str, Any],
              consts_override: Optional[Dict[int, Any]] = None) -> List[Any]:
    """Execute a full application graph.

    inputs: name -> value for every ``input`` node.
    Returns values of ``graph.outputs`` in order.
    """
    values: Dict[int, Any] = {}
    for n in graph.topo_order():
        op = graph.nodes[n]
        if op == "input":
            name = graph.attr(n, "name")
            if name not in inputs:
                raise KeyError(f"missing input {name!r}")
            values[n] = inputs[name]
        elif op == "const":
            if consts_override and n in consts_override:
                values[n] = consts_override[n]
            else:
                values[n] = graph.attr(n, "value")
        elif op == "output":
            src = graph.in_edges(n)[0]
            values[n] = values[src]
        else:
            ins = graph.in_edges(n)
            args = [values[ins[p]] for p in range(len(ins))]
            if op not in SEMANTICS:
                raise NotImplementedError(f"interpret: op {op!r}")
            values[n] = SEMANTICS[op](*args)
    return [values[o] for o in graph.outputs]


def interpret_pattern(pattern: Graph,
                      port_values: Dict[Tuple[int, int], Any],
                      consts_override: Optional[Dict[int, Any]] = None,
                      ) -> Dict[int, Any]:
    """Execute a pattern graph whose free in-ports are fed externally.

    port_values: (node, port) -> value for every free in-port.
    Returns node -> value for every node (sinks are the PE outputs).
    """
    free = set(free_in_ports(pattern))
    missing = free - set(port_values)
    if missing:
        raise KeyError(f"missing free-port values: {sorted(missing)}")
    values: Dict[int, Any] = {}
    for n in pattern.topo_order():
        op = pattern.nodes[n]
        if op == "const":
            if consts_override and n in consts_override:
                values[n] = consts_override[n]
            else:
                values[n] = pattern.attr(n, "value")
            continue
        if op == "input":
            raise ValueError("pattern graphs must not contain input nodes")
        ins = pattern.in_edges(n)
        from .ops import OPS
        args = []
        for p in range(OPS[op].arity):
            if p in ins:
                args.append(values[ins[p]])
            else:
                args.append(port_values[(n, p)])
        values[n] = SEMANTICS[op](*args)
    return values


def pattern_outputs(pattern: Graph,
                    port_values: Dict[Tuple[int, int], Any],
                    consts_override: Optional[Dict[int, Any]] = None,
                    ) -> List[Any]:
    vals = interpret_pattern(pattern, port_values, consts_override)
    return [vals[s] for s in sink_nodes(pattern)]
