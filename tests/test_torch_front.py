"""The port's framework-free front (graphir, apps, core) against the JAX
package: graph fingerprints, and the mined, ranked, merged and mapped
results of the Explorer's first four stages.

Tolerance: exact equality — these stages are pure Python over integer
graph structure.  Mining stops on a wall clock, so every config mines a
small pattern size under a time budget far above what it needs, so that
neither package's result depends on speed.
"""

import dataclasses

import numpy as np
import pytest

from repro.apps import IMAGE_APPS, ML_APPS
from repro.apps import image as r_image, mlkernels as r_ml
from repro.core.dse import specialize_per_app as r_specialize
from repro.core.mining import MiningConfig as RMining
from repro.explore import ExploreConfig as RConfig, Explorer as RExplorer
from repro.explore.pipeline import graph_key as r_graph_key
from repro.graphir import trace_scalar as r_trace
from repro_torch.apps import image as t_image, mlkernels as t_ml
from repro_torch.core.dse import specialize_per_app as t_specialize
from repro_torch.core.mining import MiningConfig as TMining
from repro_torch.explore import ExploreConfig as TConfig, Explorer as TExplorer
from repro_torch.explore.pipeline import graph_key as t_graph_key
from repro_torch.graphir import trace_scalar as t_trace

BUDGET_S = 600.0


def canon(x):
    """Package-independent structural view of a stage result."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,
                tuple((f.name, canon(getattr(x, f.name)))
                      for f in dataclasses.fields(x)))
    if hasattr(x, "__slots__") and not isinstance(x, (str, bytes)):
        return (type(x).__name__,
                tuple((s, canon(getattr(x, s))) for s in x.__slots__))
    if isinstance(x, dict):
        return ("dict", tuple(sorted(((canon(k), canon(v))
                                      for k, v in x.items()), key=repr)))
    if isinstance(x, (set, frozenset)):
        return ("set", tuple(sorted((canon(v) for v in x), key=repr)))
    if isinstance(x, (list, tuple)):
        return (type(x).__name__, tuple(canon(v) for v in x))
    if isinstance(x, np.ndarray):
        return ("ndarray", str(x.dtype), x.shape, x.tobytes())
    if isinstance(x, (np.generic,)):
        return canon(x.item())
    return x


def _conv(trace):
    def conv4(i0, i1, i2, i3, w0, w1, w2, w3, c):
        return (((i0 * w0) + (i1 * w1)) + (i2 * w2)) + (i3 * w3) + c

    return {"conv": trace(conv4, ["i0", "i1", "i2", "i3", "w0", "w1", "w2",
                                  "w3", "c"])}


def _suite(name, pkg):
    if name == "conv":
        return _conv(r_trace if pkg == "ref" else t_trace)
    mod = r_ml if pkg == "ref" else t_ml
    return {a: mod.build_graph(a) for a in ML_APPS}


@pytest.mark.parametrize("app", sorted(IMAGE_APPS))
def test_graph_key_image(app):
    assert r_graph_key(r_image.build_graph(app)) \
        == t_graph_key(t_image.build_graph(app))


@pytest.mark.parametrize("app", sorted(ML_APPS))
def test_graph_key_ml(app):
    assert r_graph_key(r_ml.build_graph(app)) \
        == t_graph_key(t_ml.build_graph(app))


@pytest.mark.parametrize("suite,mode", [("ml", "per_app"), ("conv", "per_app"),
                                        ("ml", "domain")])
def test_front_stages_match(suite, mode):
    kw = dict(mode=mode, max_merge=2, per_app_subgraphs=2)
    ref = RExplorer(_suite(suite, "ref"), RConfig(
        mining=RMining(min_support=3, max_pattern_nodes=4,
                       time_budget_s=BUDGET_S), **kw))
    port = TExplorer(_suite(suite, "port"), TConfig(
        mining=TMining(min_support=3, max_pattern_nodes=4,
                       time_budget_s=BUDGET_S), **kw), device="cpu")
    for stage in ("mine", "rank", "merge", "map"):
        r, p = getattr(ref, stage)(), getattr(port, stage)()
        assert r and canon(r) == canon(p), stage
    rr = [x.to_dict() for x in ref.run().records()]
    pr = [x.to_dict() for x in port.run().records()]
    assert rr and rr == pr


def test_legacy_shim_matches():
    mining = dict(min_support=2, max_pattern_nodes=4, time_budget_s=BUDGET_S)
    r = r_specialize(_conv(r_trace), RMining(**mining), max_merge=2)
    p = t_specialize(_conv(t_trace), TMining(**mining), max_merge=2,
                     device="cpu")
    assert canon([v.costs for v in r["conv"].variants]) \
        == canon([v.costs for v in p["conv"].variants])
