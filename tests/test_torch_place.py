"""The port's placer (plain kernel versions, ``device="cpu"``) against the
JAX package's annealers at equal seeds and nonces: grouped
(``anneal_jax_batch``), flat (``anneal_jax`` / ``place``), the Python
reference chain, and the whole ``place_and_route`` flow.

Tolerance: exact equality of slots, costs, coordinates, routes and
``FabricCost`` — HPWL is integer-valued, and the port reproduces the
reference's move streams bit for bit.
"""

import dataclasses

import numpy as np
import pytest

from repro.apps import ML_APPS
from repro.apps import mlkernels as r_ml
from repro.core.dse import app_ops as r_app_ops
from repro.core.mapper import map_application as r_map
from repro.core.merge import baseline_datapath as r_base
from repro.fabric import FabricSpec as RSpec
from repro.fabric import (anneal_jax as r_anneal_jax,
                          anneal_jax_batch as r_batch,
                          anneal_python as r_python,
                          batch_signature as r_sig,
                          extract_netlist as r_extract, lower as r_lower,
                          place as r_place, place_and_route as r_pnr,
                          synthetic_netlist as r_synth)
from repro_torch.apps import mlkernels as t_ml
from repro_torch.core.dse import app_ops as t_app_ops
from repro_torch.core.mapper import map_application as t_map
from repro_torch.core.merge import baseline_datapath as t_base
from repro_torch.fabric import FabricSpec as TSpec
from repro_torch.fabric import (anneal_jax as t_anneal_jax,
                                anneal_jax_batch as t_batch,
                                anneal_python as t_python,
                                batch_signature as t_sig,
                                extract_netlist as t_extract, lower as t_lower,
                                place as t_place, place_and_route as t_pnr,
                                synthetic_netlist as t_synth)

SPEC = dict(rows=6, cols=6)


def _ml_problems():
    """(reference, port) lowered problems of every ML app on its
    baseline PE (the Explorer's PE1 needs no mining)."""
    out = []
    for name in sorted(ML_APPS):
        pair = []
        for ml, base, ops, mapper, extract, lower, Spec in (
                (r_ml, r_base, r_app_ops, r_map, r_extract, r_lower, RSpec),
                (t_ml, t_base, t_app_ops, t_map, t_extract, t_lower, TSpec)):
            app = ml.build_graph(name)
            dp = base(ops(app))
            m = mapper(dp, app, name)
            spec = Spec(**SPEC)
            nl = extract(m, app, spec)
            spec = spec.fit(len(nl.pe_cells), len(nl.io_cells))
            pair.append(lower(nl, spec))
        out.append(tuple(pair))
    spec_r, spec_t = RSpec(rows=8, cols=8), TSpec(rows=8, cols=8)
    out.append((r_lower(r_synth(spec_r, seed=3), spec_r),
                t_lower(t_synth(spec_t, seed=3), spec_t)))
    return out


PROBLEMS = _ml_problems()


def _groups(sweeps):
    groups = {}
    for rp, tp in PROBLEMS:
        assert r_sig(rp, sweeps) == t_sig(tp, sweeps)
        groups.setdefault(r_sig(rp, sweeps), []).append((rp, tp))
    return sorted(groups.items())


def test_lowering_matches():
    for rp, tp in PROBLEMS:
        for f in ("slot_xy", "net_pins", "net_mask", "ent_nets"):
            assert np.array_equal(getattr(rp, f), getattr(tp, f)), f
        assert rp.cell_names == tp.cell_names


@pytest.mark.parametrize("score_mode", ["delta", "full"])
@pytest.mark.parametrize("telemetry", [False, True])
def test_batch_matches_reference(score_mode, telemetry):
    sweeps, chains = 4, 3
    for sig, items in _groups(sweeps):
        nonces = [0x9E3779B9 * (i + 1) & 0xFFFFFFFF for i in range(len(items))]
        kw = dict(chains=chains, seed=7, sweeps=sweeps, score_mode=score_mode,
                  nonces=nonces, telemetry=telemetry)
        want = r_batch([rp for rp, _ in items], **kw)
        got = t_batch([tp for _, tp in items], device="cpu", **kw)
        for (ws, wc), (gs, gc) in zip(want, got):
            assert np.array_equal(np.asarray(ws), gs), sig
            assert np.array_equal(np.asarray(wc), gc), sig


@pytest.mark.parametrize("score_mode", ["delta", "full"])
def test_flat_matches_reference(score_mode):
    for rp, tp in PROBLEMS[::2]:
        kw = dict(chains=3, seed=5, sweeps=3, score_mode=score_mode)
        ws, wc = r_anneal_jax(rp, **kw)
        gs, gc = t_anneal_jax(tp, device="cpu", **kw)
        assert np.array_equal(ws, gs) and np.array_equal(wc, gc)


def test_python_chain_matches_reference():
    for rp, tp in PROBLEMS[:3]:
        ws, wc = r_python(rp, seed=2, sweeps=6)
        gs, gc = t_python(tp, seed=2, sweeps=6)
        assert np.array_equal(ws, gs) and wc == gc


@pytest.mark.parametrize("backend", ["jax", "python"])
def test_place_matches_reference(backend):
    spec_r, spec_t = RSpec(rows=6, cols=6), TSpec(rows=6, cols=6)
    pr = r_place(r_synth(spec_r, seed=1), spec_r, backend=backend, chains=3,
                 sweeps=4, seed=9)
    pt = t_place(t_synth(spec_t, seed=1), spec_t, backend=backend, chains=3,
                 sweeps=4, seed=9, device="cpu")
    assert dataclasses.asdict(pr) == dataclasses.asdict(pt)
    assert pt.backend == backend


def test_place_and_route_matches_reference():
    name = sorted(ML_APPS)[0]
    outs = []
    for ml, base, ops, mapper, pnr, Spec, kw in (
            (r_ml, r_base, r_app_ops, r_map, r_pnr, RSpec, {}),
            (t_ml, t_base, t_app_ops, t_map, t_pnr, TSpec,
             {"device": "cpu"})):
        app = ml.build_graph(name)
        dp = base(ops(app))
        outs.append(pnr(dp, mapper(dp, app, name), app, Spec(rows=4, cols=4),
                        chains=3, sweeps=4, seed=1, **kw))
    r, t = outs
    assert dataclasses.asdict(r.spec) == dataclasses.asdict(t.spec)
    assert r.placement.coords == t.placement.coords
    assert r.placement.cost == t.placement.cost
    assert dataclasses.asdict(r.routes) == dataclasses.asdict(t.routes)
    assert dataclasses.asdict(r.cost) == dataclasses.asdict(t.cost)
