"""Dataflow-graph IR: the CoreIR analogue (see DESIGN.md §2).

The jaxpr front end (``from_jaxpr`` / ``trace_fn``) of the JAX package is
not ported yet; graphs come from the scalar tracer."""

from .graph import Graph, free_in_ports, pattern_from_spec, sink_nodes
from .interp import interpret, interpret_pattern, pattern_outputs
from .ops import OPS, OpInfo, area_of, energy_of, mergeable, merged_unit, unit_of
from .symtrace import Sym, Tracer
from .symtrace import trace as trace_scalar

__all__ = [
    "Graph", "free_in_ports", "pattern_from_spec", "sink_nodes",
    "interpret", "interpret_pattern", "pattern_outputs",
    "OPS", "OpInfo", "area_of", "energy_of", "mergeable", "merged_unit",
    "unit_of", "Sym", "Tracer", "trace_scalar",
]
