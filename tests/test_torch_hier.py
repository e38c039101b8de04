"""The port's hierarchical placer (``device="cpu"``: the annealing
kernel's plain version) against the JAX package's: the partition, every
level of ``place_hierarchical`` (cluster, detail, deblock), the final
coordinates and cost, its metrics, the degenerate ``cluster_grid=1``
case and ``place_and_route(pnr_mode="hierarchical")``.

Tolerance: exact equality.  Coordinates are integers and the detail
level's fixed boxes integers or half-integers (cluster centres), so every
cost is a multiple of 0.5 far below 2^22, exact in float32 in any order.
"""

import dataclasses
import sys

import numpy as np
import pytest

import repro.fabric as R
import repro_torch.fabric as T
from repro.apps import mlkernels as r_ml
from repro.core.dse import app_ops as r_app_ops
from repro.core.mapper import map_application as r_map
from repro.core.merge import baseline_datapath as r_base
from repro.obs.metrics import MetricsRegistry as RReg
from repro_torch.apps import mlkernels as t_ml
from repro_torch.core.dse import app_ops as t_app_ops
from repro_torch.core.mapper import map_application as t_map
from repro_torch.core.merge import baseline_datapath as t_base
from repro_torch.obs.metrics import MetricsRegistry as TReg

r_place_mod = sys.modules["repro.fabric.place"]
t_place_mod = sys.modules["repro_torch.fabric.place"]


def _netlists(rows, cols, seed, locality):
    return (R.synthetic_netlist(R.FabricSpec(rows=rows, cols=cols),
                                seed=seed, locality=locality),
            T.synthetic_netlist(T.FabricSpec(rows=rows, cols=cols),
                                seed=seed, locality=locality))


@pytest.mark.parametrize("rows,cols,g,seed", [
    (8, 8, 2, 0), (12, 12, 3, 1), (16, 16, 4, 2)])
def test_partition_matches_reference(rows, cols, g, seed):
    rn, tn = _netlists(rows, cols, seed, 3)
    cap = (rows // g) * (cols // g)
    want = R.partition(rn, g * g, cap)
    got = T.partition(tn, g * g, cap)
    assert got.clusters == want.clusters
    assert got.cluster_of == want.cluster_of
    assert (got.cut_nets, got.internal_nets) \
        == (want.cut_nets, want.internal_nets)
    assert all(len(c) <= cap for c in got.clusters)


def test_partition_rejects_overfull_as_reference():
    rn, tn = _netlists(8, 8, 0, None)
    n = len(tn.pe_cells)
    with pytest.raises(ValueError):
        R.partition(rn, 2, n // 2 - 1)
    with pytest.raises(ValueError):
        T.partition(tn, 2, n // 2 - 1)


@pytest.mark.parametrize("rows,cols", [
    (4, 4), (8, 8), (16, 16), (24, 24), (32, 48), (64, 64), (128, 128),
    (100, 60)])
def test_auto_cluster_grid_matches_reference(rows, cols):
    assert t_place_mod._auto_cluster_grid(T.FabricSpec(rows=rows, cols=cols)) \
        == r_place_mod._auto_cluster_grid(R.FabricSpec(rows=rows, cols=cols))


def _levels_equal(want, got):
    assert got.cluster_grid == want.cluster_grid
    assert got.clusters == want.clusters
    assert got.region_of == want.region_of
    assert np.array_equal(got.cluster_slots, want.cluster_slots)
    assert got.detail_slots.keys() == want.detail_slots.keys()
    for k in want.detail_slots:
        assert np.array_equal(got.detail_slots[k], want.detail_slots[k]), k
    assert (got.deblock_slots is None) == (want.deblock_slots is None)
    if want.deblock_slots is not None:
        assert np.array_equal(got.deblock_slots, want.deblock_slots)
    assert got.detail_dispatches == want.detail_dispatches
    assert got.level_costs == want.level_costs
    assert got.coords == want.coords
    assert got.cost == want.cost
    assert (got.backend, got.chains, got.sweeps, got.chain_costs) \
        == (want.backend, want.chains, want.sweeps, want.chain_costs)


@pytest.mark.parametrize("size,g,seed", [(8, 2, 9), (12, 3, 4)])
@pytest.mark.parametrize("score_mode", ["delta", "full"])
def test_place_hierarchical_matches_reference(size, g, seed, score_mode):
    rn, tn = _netlists(size, size, seed, 2)
    kw = dict(cluster_grid=g, chains=2, sweeps=4, seed=3,
              score_mode=score_mode)
    rreg, treg = RReg(), TReg()
    want = R.place_hierarchical(rn, R.FabricSpec(rows=size, cols=size),
                                metrics=rreg, **kw)
    got = T.place_hierarchical(tn, T.FabricSpec(rows=size, cols=size),
                               metrics=treg, device="cpu", **kw)
    _levels_equal(want, got)
    # half-integer boxes reach the detail level's costs
    assert got.level_costs["detail"] % 1 in (0.0, 0.5)
    # the reference's metrics, under their names
    assert treg.to_dict() == rreg.to_dict()
    assert treg.counter("pnr.hier.place") == 1
    for name in ("pnr.hier.cut_frac", "pnr.hier.detail_bucket"):
        assert treg.histogram(name).count > 0


def test_place_hierarchical_spans_and_nonces():
    from repro_torch.obs import disable_tracing, enable_tracing
    tn = _netlists(12, 12, 4, 2)[1]
    spec = T.FabricSpec(rows=12, cols=12)
    seen = []
    orig = t_place_mod.anneal_jax_batch

    def record(problems, **kw):
        seen.append(list(kw["nonces"]))
        return orig(problems, **kw)

    t_place_mod.anneal_jax_batch = record
    tracer = enable_tracing()
    try:
        T.place_hierarchical(tn, spec, cluster_grid=3, chains=2, sweeps=2,
                             seed=1, device="cpu")
    finally:
        disable_tracing()
        t_place_mod.anneal_jax_batch = orig
    names = [sp.name for sp, _, _ in tracer.iter_spans()]
    for name in ("pnr.hier.partition", "pnr.hier.cluster", "pnr.hier.io",
                 "pnr.hier.detail", "pnr.hier.deblock"):
        assert name in names
    # 0 for the cluster level, k + 1 for cluster k's detail, k_total + 1
    # for the deblock
    assert seen[0] == [0]
    detail = sorted(n for s in seen[1:-1] for n in s)
    assert detail == list(range(1, 10))[:len(detail)] and detail
    assert seen[-1] == [10]


def test_tracer_open_spans():
    from repro_torch.obs.trace import Tracer
    tr = Tracer()
    assert tr.open_spans() == []
    with tr.span("a"):
        with tr.span("b"):
            assert tr.open_spans() == ["a", "b"]
        tr.event("c")
        assert tr.open_spans() == ["a"]
    assert tr.open_spans() == []


def test_k2_calls_attributed_to_level_spans():
    # chip_smoke.py and tools/hier_layout.py name each K2 call's level by
    # the pnr.hier.* span open around it
    import os
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from chip_smoke import hier_fields_differ, record_k2_calls
    tn = _netlists(12, 12, 4, 2)[1]
    spec = T.FabricSpec(rows=12, cols=12)
    h, calls, _ = record_k2_calls(lambda: T.place_hierarchical(
        tn, spec, cluster_grid=3, chains=2, sweeps=2, seed=1,
        device="cpu"))
    levels = [c[0] for c in calls]
    assert levels[0] == "cluster" and levels[-1] == "deblock"
    assert set(levels[1:-1]) == {"detail"}
    # boxes at the detail and deblock levels only
    assert [("net_fix" in c[1]) for c in calls] \
        == [False] + [True] * (len(calls) - 1)
    # the recording leaves the placement as it was
    assert not hier_fields_differ(h, T.place_hierarchical(
        tn, spec, cluster_grid=3, chains=2, sweeps=2, seed=1, device="cpu"))
    _, flat, _ = record_k2_calls(lambda: T.place(
        tn, spec, chains=2, sweeps=2, seed=1, device="cpu"))
    assert [c[0] for c in flat] == ["flat"]


def test_cluster_grid_1_equals_flat():
    rn, tn = _netlists(8, 8, 5, 2)
    spec = T.FabricSpec(rows=8, cols=8)
    kw = dict(chains=2, sweeps=4, seed=11)
    flat = T.place(tn, spec, backend="jax", device="cpu", **kw)
    hier = T.place_hierarchical(tn, spec, cluster_grid=1, device="cpu", **kw)
    assert hier.cluster_grid == 1
    assert hier.coords == flat.coords and hier.cost == flat.cost
    assert hier.chain_costs == flat.chain_costs
    want = R.place_hierarchical(rn, R.FabricSpec(rows=8, cols=8),
                                cluster_grid=1, **kw)
    assert dataclasses.asdict(hier) == dataclasses.asdict(want)


def test_place_hierarchical_refuses_bad_grids_as_reference():
    rn, tn = _netlists(8, 8, 0, None)
    for g in (0, 3, 8):
        with pytest.raises(ValueError):
            R.place_hierarchical(rn, R.FabricSpec(rows=8, cols=8),
                                 cluster_grid=g, chains=1, sweeps=1)
        with pytest.raises(ValueError):
            T.place_hierarchical(tn, T.FabricSpec(rows=8, cols=8),
                                 cluster_grid=g, chains=1, sweeps=1,
                                 device="cpu")


def test_place_and_route_hierarchical_matches_reference():
    name = sorted(r_ml.ML_APPS)[-1]
    outs = []
    for ml, base, ops, mapper, F, kw in (
            (r_ml, r_base, r_app_ops, r_map, R, {}),
            (t_ml, t_base, t_app_ops, t_map, T, {"device": "cpu"})):
        app = ml.build_graph(name)
        dp = base(ops(app))
        m = mapper(dp, app, name)
        outs.append(F.place_and_route(dp, m, app,
                                      F.FabricSpec(rows=16, cols=16),
                                      chains=2, sweeps=3, seed=1,
                                      pnr_mode="hierarchical", **kw))
        with pytest.raises(ValueError, match="hierarchical"):
            F.place_and_route(dp, m, app, F.FabricSpec(rows=16, cols=16),
                              backend="python", pnr_mode="hierarchical",
                              **kw)
    r, t = outs
    assert t.placement.cluster_grid == r.placement.cluster_grid
    assert t.placement.coords == r.placement.coords
    assert t.placement.cost == r.placement.cost
    assert dataclasses.asdict(r.routes) == dataclasses.asdict(t.routes)
    assert dataclasses.asdict(r.cost) == dataclasses.asdict(t.cost)
