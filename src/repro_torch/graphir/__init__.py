"""Dataflow-graph IR: the CoreIR analogue (see DESIGN.md §2).

Graphs come from the scalar tracer (``trace_scalar``) or, at the tensor
level, from torch functions traced to ATen ops (``trace_fn``,
``from_fx``: the counterparts of the JAX package's jaxpr front end)."""

from .graph import Graph, free_in_ports, pattern_from_spec, sink_nodes
from .interp import interpret, interpret_pattern, pattern_outputs
from .ops import OPS, OpInfo, area_of, energy_of, mergeable, merged_unit, unit_of
from .symtrace import Sym, Tracer
from .symtrace import trace as trace_scalar
from .trace import from_fx, trace_fn

__all__ = [
    "Graph", "free_in_ports", "pattern_from_spec", "sink_nodes",
    "interpret", "interpret_pattern", "pattern_outputs",
    "OPS", "OpInfo", "area_of", "energy_of", "mergeable", "merged_unit",
    "unit_of", "Sym", "Tracer", "trace_scalar", "from_fx", "trace_fn",
]
