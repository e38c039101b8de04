"""The CUDA kernels against their plain PyTorch versions, on the card.

Run on a machine with an NVIDIA Hopper card:
``PYTHONPATH=src python -m pytest -m gpu tests/test_torch_kernels_gpu.py``.
Each test decides inside itself whether a card exists and skips with a
reason when none does.  Tolerance: bit equality — the placement kernels
do the plain versions' integer-valued float32 arithmetic, and the cycle
stepper (K3) every IEEE-exact ALU op (NaNs count as equal); its
transcendentals (exp, log, tanh, sigmoid, rsqrt, pow) are held to 2 ulp.
"""

from collections import defaultdict

import numpy as np
import pytest
import torch

from repro_torch.core import baseline_datapath, map_application
from repro_torch.core.dse import app_ops
from repro_torch.fabric import (FabricSpec, anneal_jax_batch,
                                batch_signature, lower, synthetic_netlist)
from repro_torch.graphir.graph import Graph
from repro_torch.graphir.ops import OPS
from repro_torch.kernels import pnr_cost, sim_step
from repro_torch.sim import build_sim, sim_signature
from repro_torch.sim.cycle import bucket_tensors

TRANSCENDENTAL = ("exp", "log", "tanh", "sigmoid", "rsqrt", "pow")
EXACT = [op for op in sim_step.ALU_IMPLS
         if op != "nop" and op not in TRANSCENDENTAL]

pytestmark = pytest.mark.gpu


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (none on this host)")


def _problems():
    out = []
    for rows, cols, seed in ((4, 4, 0), (6, 6, 1), (17, 18, 2)):
        spec = FabricSpec(rows=rows, cols=cols)
        out.append(lower(synthetic_netlist(spec, seed=seed), spec))
    return out


def test_k1_matches_plain():
    _need_card()
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    for p in _problems():
        e = p.n_entities
        slots = np.stack([rng.permutation(e) for _ in range(5)])
        args = [torch.zeros(5, dtype=torch.int32),
                torch.as_tensor(slots, dtype=torch.int32),
                torch.as_tensor(p.slot_xy)[None],
                torch.as_tensor(p.net_pins)[None],
                torch.as_tensor(p.net_mask)[None]]
        before = pnr_cost.net_hpwl_rows.launches
        got = pnr_cost.net_hpwl_rows(*[a.to(dev).contiguous() for a in args])
        torch.cuda.synchronize()
        assert pnr_cost.net_hpwl_rows.launches == before + 1
        assert torch.equal(got.cpu(), pnr_cost.net_hpwl_rows_plain(*args))


@pytest.mark.parametrize("score_mode", ["delta", "full"])
@pytest.mark.parametrize("telemetry", [False, True])
def test_k2_annealer_matches_plain(score_mode, telemetry):
    _need_card()
    for p in _problems():
        kw = dict(chains=4, seed=3, sweeps=4, score_mode=score_mode,
                  telemetry=telemetry, nonces=[11])
        before = pnr_cost.anneal_chains.launches
        got = anneal_jax_batch([p], device="cuda", **kw)
        assert pnr_cost.anneal_chains.launches == before + 1
        want = anneal_jax_batch([p], device="cpu", **kw)
        for (gs, gc), (ws, wc) in zip(got, want):
            assert np.array_equal(gs, ws), batch_signature(p, 4)
            assert np.array_equal(gc, wc), batch_signature(p, 4)


def test_wrapper_rejects_bad_inputs():
    _need_card()
    dev = torch.device("cuda")
    slot_of = torch.arange(4, dtype=torch.int64, device=dev)[None]
    with pytest.raises(TypeError):
        pnr_cost.net_hpwl_rows(
            torch.zeros(1, dtype=torch.int32, device=dev), slot_of,
            torch.zeros((1, 4, 2), device=dev),
            torch.zeros((1, 1, 2), dtype=torch.int32, device=dev),
            torch.ones((1, 1, 2), dtype=torch.bool, device=dev))


# ---------------------------------------------------------------------------
# K3: the cycle stepper
# ---------------------------------------------------------------------------
def _program(g, name):
    dp = baseline_datapath(app_ops(g))
    m = map_application(dp, g, name)
    return build_sim(dp, m, g, FabricSpec(6, 6), place_backend="python",
                     chains=1, sweeps=2, device="cpu")[0]


def _random_graph(rng, ops, n_nodes):
    """A random DAG over ``ops`` (each used at least once), three inputs
    and a constant; every sink is an output."""
    g = Graph()
    vals = [g.add_node("input", name=f"x{i}") for i in range(3)]
    vals.append(g.add_node("const", value=float(rng.integers(1, 4))))
    for j in range(n_nodes):
        op = ops[j] if j < len(ops) else ops[rng.integers(len(ops))]
        nid = g.add_node(op)
        for port in range(OPS[op].arity):
            g.add_edge(vals[rng.integers(len(vals))], nid, port)
        vals.append(nid)
    for nid in vals[4:]:
        if not any(src == nid for src, _, _ in g.edges):
            g.mark_output(nid)
    return g


def _single_op(op):
    g = Graph()
    ins = [g.add_node("input", name=f"x{i}") for i in range(3)]
    n = g.add_node(op)
    for port in range(OPS[op].arity):
        g.add_edge(ins[port], n, port)
    g.mark_output(n)
    return g


def _operands(rng, shape):
    x = (np.exp(rng.uniform(-3, 3, shape))
         * rng.choice([-1.0, 1.0], shape)).astype(np.float32)
    flat = x.reshape(-1)
    flat[rng.integers(0, flat.size, flat.size // 8)] = rng.choice(
        np.float32([0.0, -0.0, np.inf, -np.inf, np.nan, 2.0, 3.0]),
        flat.size // 8)
    return x


def _sim_cases():
    """(program, exact?) over every ALU op: random graphs of the exact ops
    (each tile one micro-op), one single-op program per op, and the
    merged multi-op PEs of a mined convolution (several micro-ops a tile)."""
    from repro_torch.explore.__main__ import _smoke_case
    from repro_torch.explore import Explorer

    rng = np.random.default_rng(0)
    cases = []
    for t in range(3):
        ops = list(rng.permutation(EXACT))
        cases.append((_program(_random_graph(rng, ops, len(ops) + 6),
                               f"rg{t}"), True))
    for op in sim_step.ALU_IMPLS:
        if op != "nop":
            cases.append((_program(_single_op(op), op),
                          op not in TRANSCENDENTAL))
    apps, cfg = _smoke_case()
    progs = Explorer(apps, cfg, device="cpu").schedule()
    cases += [(p, True) for p in progs.values()]
    assert max(p.n_steps for p, _ in cases) > 1
    return cases


def _same_bits(a, b):
    return (a.view(torch.int32) == b.view(torch.int32)) \
        | (torch.isnan(a) & torch.isnan(b))


def _ulp(a, b):
    def ordered(x):
        i = x.view(torch.int32).long()
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)
    d = (ordered(a) - ordered(b)).abs()
    return torch.where(torch.isnan(a) & torch.isnan(b), 0, d)


@pytest.mark.parametrize("force_global", [False, True])
def test_k3_matches_plain(force_global):
    _need_card()
    dev = torch.device("cuda")
    rng = np.random.default_rng(1)
    k_n, b_n = 4, 3
    groups = defaultdict(list)
    for prog, exact in _sim_cases():
        groups[sim_signature(prog, k_n, b_n)].append((prog, exact))
    for sig, items in groups.items():
        progs = [p for p, _ in items]
        arrs = [_operands(rng, (b_n, k_n, p.n_ext)) for p in progs]
        tables, inputs, op_ids = bucket_tensors(progs, arrs, sig, dev)
        before = sim_step.simulate_batch_stepper.launches
        got = sim_step.simulate_batch_stepper(
            tables, inputs, op_ids, cycles=sig[8], latch_depth=sig[9],
            force_global=force_global)
        assert sim_step.simulate_batch_stepper.launches == before + 1
        want = sim_step.simulate_batch_plain(
            tables, inputs, op_ids, cycles=sig[8], latch_depth=sig[9])
        torch.cuda.synchronize()
        for i, (prog, exact) in enumerate(items):
            g, w = got[i], want[i]
            if exact:
                assert bool(_same_bits(g, w).all()), (prog.app_name, sig)
            else:
                assert int(_ulp(g, w).max()) <= 2, (prog.app_name, sig)


def test_k3_rejects_bad_inputs():
    _need_card()
    dev = torch.device("cuda")
    prog = _program(_single_op("add"), "add")
    sig = sim_signature(prog, 2, 1)
    arr = np.ones((1, 2, prog.n_ext), np.float32)
    tables, inputs, op_ids = bucket_tensors([prog], [arr], sig, dev)
    kw = dict(cycles=sig[8], latch_depth=sig[9])
    with pytest.raises(TypeError):
        sim_step.simulate_batch_stepper(tables, inputs.double(), op_ids,
                                        **kw)
    with pytest.raises(ValueError):
        sim_step.simulate_batch_stepper(
            dict(tables, ii=tables["ii"][:0]), inputs, op_ids, **kw)
    bad = dict(tables, op_src=tables["op_src"].clone())
    bad["op_src"][0, 0, 0, 0] = sig[5] + sig[6] + sig[1]   # tile 1's tmp
    with pytest.raises(ValueError, match="tmp slot"):
        sim_step.simulate_batch_stepper(bad, inputs, op_ids, **kw)
