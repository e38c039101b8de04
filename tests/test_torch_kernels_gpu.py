"""The CUDA kernels against their plain PyTorch versions, on the card.

Run on a machine with an NVIDIA Hopper card:
``PYTHONPATH=src python -m pytest -m gpu tests/test_torch_kernels_gpu.py``.
Each test decides inside itself whether a card exists and skips with a
reason when none does.  Tolerance: bit equality — the placement kernels
do the plain versions' integer-valued float32 arithmetic, and the cycle
stepper (K3) every IEEE-exact ALU op (NaNs count as equal); its
transcendentals (exp, log, tanh, sigmoid, rsqrt, pow) are held to 2 ulp.
The generated fused-PE kernel (K4) is held to its plain version at
rtol = atol = 1e-5 in float32 and 5e-2 in bfloat16, and the matmul with a
PE epilogue (K5) at |diff| <= 1e-4 * max(1, |plain|) (float32 sums in
another order; TF32 off), its bfloat16 results within one bfloat16
rounding step.  Flash attention (K6) is held to its plain version and to
the float64 oracle at rtol = atol = 2e-5 (5e-2 in bfloat16, and there
also by its relative error norms against the plain version), the
selective scan (K7) to its plain version at 1e-4: the reference tests'
tolerances, for float32 sums taken in another order.
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
    # K1's function is K2's prologue: the starting per-net costs it writes
    # to pnc0_out, with zero steps and with a sweep after them
    _need_card()
    from repro_torch.fabric.place import KERNEL_INPUTS, batch_inputs
    for p in _problems():
        for sweeps in (0, 2):
            d = batch_inputs([p], chains=5, seed=1, sweeps=max(sweeps, 1))
            if sweeps == 0:
                for k in ("a", "t", "log_u", "temps", "active"):
                    d[k] = d[k][:, :0].contiguous()
            args = [d[k].cuda() for k in KERNEL_INPUTS]
            got = torch.full((5, d["net_pins"].shape[1]), -1.0,
                             device="cuda")
            before = pnr_cost.anneal_chains.launches
            out = pnr_cost.anneal_chains(*args, pnc0_out=got)
            torch.cuda.synchronize()
            assert pnr_cost.anneal_chains.launches == before + 1
            want = pnr_cost.net_hpwl_rows_plain(
                d["prob"], d["slot0"], d["slot_xy"], d["net_pins"],
                d["net_mask"])
            assert torch.equal(got.cpu(), want)
            if sweeps == 0:         # no step: the start is the best
                assert torch.equal(out[0].cpu(), d["slot0"])
                assert torch.equal(out[1].cpu(), want.sum(dim=1))


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


def _same(got, want):
    return all((g is None and w is None) or torch.equal(g, w)
               for g, w in zip(got, want))


def _image_problems():
    """The image suite's apps on their baseline PE: the suite's largest
    pnr signatures (camera: 16384 steps, 512 nets of up to 32 pins)."""
    from repro_torch.apps import image_graphs
    from repro_torch.fabric import extract_netlist
    spec = FabricSpec(rows=16, cols=16)
    out = []
    for name, g in sorted(image_graphs().items()):
        nl = extract_netlist(map_application(baseline_datapath(app_ops(g)),
                                             g, name), g, spec)
        out.append(lower(nl, spec.fit(len(nl.pe_cells), len(nl.io_cells))))
    return out


def _k2_args(problems, chains, sweeps=32):
    """K2's inputs on the card (``net_fix`` last when a problem has
    fixed boxes)."""
    from repro_torch.fabric.place import KERNEL_INPUTS, batch_inputs
    d = {k: v.cuda() for k, v in batch_inputs(
        problems, chains=chains, seed=5, sweeps=sweeps).items()}
    return [d[k] for k in KERNEL_INPUTS] + (
        [d["net_fix"]] if "net_fix" in d else [])


def _k2_check(args, label):
    """K2 bit-equal to its plain version in the three modes, its
    prologue's starting costs too."""
    for full, tele in ((False, False), (True, False), (False, True)):
        r, n = args[10].shape[0], args[2].shape[1]
        got0 = torch.full((r, n), -1.0, device="cuda")
        want0 = torch.full((r, n), -2.0, device="cuda")
        before = pnr_cost.anneal_chains.launches
        got = pnr_cost.anneal_chains(*args, full=full, telemetry=tele,
                                     pnc0_out=got0)
        assert pnr_cost.anneal_chains.launches == before + 1
        torch.cuda.synchronize()
        want = pnr_cost.anneal_chains_plain(*args, full=full, telemetry=tele,
                                            pnc0_out=want0)
        torch.cuda.synchronize()
        assert _same(got, want), (label, full, tele)
        assert torch.equal(got0, want0), (label, "pnc0")


def test_k2_image_suite_signatures_match_plain():
    _need_card()
    for p in _image_problems():
        _k2_check(_k2_args([p], chains=4), batch_signature(p, 32))


def test_k2_mined_image_suite_signatures_match_plain():
    # the pairs chip_smoke.py places: the image suite mined and mapped per
    # app (mining stops on a wall clock, so the front may vary; every
    # signature of the one mined here is checked), several problems of a
    # signature in one launch
    _need_card()
    from repro_torch.apps import image_graphs
    from repro_torch.core.mining import MiningConfig
    from repro_torch.explore import ExploreConfig, Explorer
    from repro_torch.fabric import FabricOptions, extract_netlist
    options = FabricOptions(spec=FabricSpec(rows=16, cols=16))
    cfg = ExploreConfig(mode="per_app", max_merge=3, fabric=options,
                        mining=MiningConfig(min_support=3,
                                            max_pattern_nodes=6,
                                            time_budget_s=15,
                                            max_patterns_per_level=40))
    apps = image_graphs()
    groups = defaultdict(list)
    for (pe, app), m in sorted(Explorer(apps, cfg, device="cpu").map()
                               .items()):
        nl = extract_netlist(m, apps[app], options.spec)
        p = lower(nl, options.spec.fit(len(nl.pe_cells), len(nl.io_cells)))
        groups[batch_signature(p, 32)].append(p)
    assert len(groups) > 1
    for sig, probs in sorted(groups.items()):
        args = _k2_args(probs, chains=4)
        got = pnr_cost.anneal_chains(*args, telemetry=True)
        torch.cuda.synchronize()
        want = pnr_cost.anneal_chains_plain(*args, telemetry=True)
        assert _same(got, want), sig
        assert _same(pnr_cost.anneal_chains(*args)[:2], want[:2]), sig


def test_k2_problems_sharing_a_launch_match_plain():
    _need_card()
    by_sig = defaultdict(list)
    for seed in range(12):
        spec = FabricSpec(rows=6, cols=6)
        p = lower(synthetic_netlist(spec, seed=seed), spec)
        by_sig[batch_signature(p, 4)].append(p)
    probs = max(by_sig.values(), key=len)
    assert len(probs) >= 3
    # four problems in one launch, a block a chain, each chain staging its
    # own problem's tables
    for chains in (4, 3):
        _k2_check(_k2_args(probs[:4], chains=chains, sweeps=4),
                  ("shared launch", chains))


def _synthetic_k2(rng, p_n, chains, e, n, d, s=200):
    """Random problems in the kernels' layout, with entities on many nets
    (K up to 32: two touched nets a lane) and a partly inactive schedule."""
    slot_xy = rng.integers(0, 6, size=(p_n, e, 2)).astype(np.float32)
    pins = rng.integers(0, e, size=(p_n, n, d)).astype(np.int32)
    mask = rng.random((p_n, n, d)) < 0.6
    inc = [[[] for _ in range(e)] for _ in range(p_n)]
    for p in range(p_n):
        for i in range(n):
            for ent in pins[p, i][mask[p, i]]:
                inc[p][int(ent)].append(i)
    k = max(len(x) for row in inc for x in row)
    ent_nets = np.full((p_n, e, k), n, np.int32)
    for p in range(p_n):
        for ent, lst in enumerate(inc[p]):
            ent_nets[p, ent, :len(lst)] = lst
    r = p_n * chains
    slot0 = np.stack([rng.permutation(e) for _ in range(r)]).astype(np.int32)
    active = np.ones((p_n, s), bool)
    active[-1, -7:] = False
    vals = (np.repeat(np.arange(p_n, dtype=np.int32), chains), slot_xy, pins,
            mask, ent_nets,
            np.linspace(4.0, 0.02, s, dtype=np.float32)[None].repeat(p_n, 0),
            active, rng.integers(0, e, size=(r, s)).astype(np.int32),
            rng.integers(0, e, size=(r, s)).astype(np.int32),
            np.log(rng.random((r, s)) + 1e-12).astype(np.float32), slot0)
    return [torch.as_tensor(v).cuda() for v in vals], k


@pytest.mark.parametrize("p_n,chains,e,n,d,want_k", [
    (3, 3, 24, 20, 5, (1, 16)), (2, 5, 24, 60, 12, (17, 32)),
    (2, 4, 48, 80, 10, (17, 32)), (2, 8, 64, 40, 40, (1, 32))])
def test_k2_wide_nets_and_row_orders_match_plain(p_n, chains, e, n, d,
                                                  want_k, monkeypatch):
    _need_card()
    rng = np.random.default_rng(e + n + d)
    args, k = _synthetic_k2(rng, p_n, chains, e, n, d)
    assert want_k[0] <= k <= want_k[1]
    _k2_check(args, ("synthetic", k))
    # chains of the problems interleaved, so neighbouring blocks read
    # different problems' tables
    perm = torch.as_tensor(rng.permutation(args[0].shape[0])).cuda()
    shuffled = [args[0][perm].contiguous()] + args[1:7] + [
        x[perm].contiguous() for x in args[7:]]
    _k2_check(shuffled, ("shuffled", k))
    # tables left in global memory, as when they do not fit: room for the
    # chain's own state (the kernel's count, unstaged), not for the tables
    e_n, n_n = args[1].shape[1], args[2].shape[1]
    w = pnr_cost.anneal_layout(n_n, d, e_n, k)[0]
    monkeypatch.setattr(pnr_cost, "SMEM_LIMIT", pnr_cost._lib()
                        .pnr_anneal_smem_bytes(n_n, w, e_n, k, 0, 0, 1))
    assert pnr_cost.anneal_layout(n_n, d, e_n, k)[1:3] == (False, True)
    _k2_check(args, ("unstaged", k))
    # the chain's own state in the global scratch too, as when it does not
    # fit (the grouped path's 128x128 bucket, the 256x256 deblock)
    monkeypatch.setattr(pnr_cost, "SMEM_LIMIT", pnr_cost.SMEM_LIMIT - 1)
    assert pnr_cost.anneal_layout(n_n, d, e_n, k) == (w, False, False, 0)
    _k2_check(args, ("chain in global memory", k))


def _hier_level_problems(size, g, sweeps=4):
    """The problems each level of the hierarchical placer hands to the
    annealer (cluster, detail groups, deblock), captured from a run on
    the CPU."""
    import sys
    place_mod = sys.modules["repro_torch.fabric.place"]
    spec = FabricSpec(rows=size, cols=size)
    nl = synthetic_netlist(spec, seed=size, locality=3)
    calls = []
    orig = place_mod.anneal_jax_batch

    def record(problems, **kw):
        calls.append(list(problems))
        return orig(problems, **kw)

    place_mod.anneal_jax_batch = record
    try:
        place_mod.place_hierarchical(nl, spec, cluster_grid=g, chains=2,
                                     sweeps=sweeps, seed=1, device="cpu")
    finally:
        place_mod.anneal_jax_batch = orig
    return calls


@pytest.mark.parametrize("size,g", [(16, 2), (24, 3)])
def test_k2_fixed_box_levels_match_plain(size, g):
    # every level's problems as the hierarchical placer builds them: the
    # cluster level (no boxes, more than 32 nets a cluster: full scoring),
    # the detail groups and the deblock (half-integer boxes, several
    # problems a launch)
    _need_card()
    calls = _hier_level_problems(size, g)
    assert calls[0][0].net_fix is None
    assert all(p.net_fix is not None for c in calls[1:] for p in c)
    assert any(((p.net_fix[:, 0] <= p.net_fix[:, 1])
                & (p.net_fix[:, 0] % 1 == 0.5)).any()
               for c in calls[1:] for p in c)     # half-integer boxes
    for i, probs in enumerate(calls):
        _k2_check(_k2_args(probs, chains=3, sweeps=4), ("level", i))


def _boxed_k2(rng, p_n, chains, e, n, d, s=150):
    """Synthetic problems with fixed boxes: integer, half-integer and empty
    boxes, and nets with no movable pin (scored by their box alone)."""
    args, _ = _synthetic_k2(rng, p_n, chains, e, n, d, s)
    mask = args[3].cpu().clone()
    mask[:, :n // 5] = False              # pinless nets
    args[3] = mask.cuda()
    lo = rng.integers(-6, 10, size=(p_n, n, 2)) / 2.0
    ext = rng.integers(0, 8, size=(p_n, n, 2)) / 2.0
    fix = np.stack([lo[..., 0], lo[..., 0] + ext[..., 0],
                    lo[..., 1], lo[..., 1] + ext[..., 1]], -1)
    empty = rng.random((p_n, n)) < 0.3
    fix[empty] = pnr_cost.EMPTY_BOX
    fix[:, 0] = pnr_cost.EMPTY_BOX         # a pinless net with no box
    return args + [torch.as_tensor(fix, dtype=torch.float32).cuda()]


@pytest.mark.parametrize("p_n,chains,e,n,d", [
    (3, 3, 24, 20, 5), (2, 5, 24, 60, 12), (2, 4, 64, 40, 40)])
def test_k2_fixed_boxes_match_plain(p_n, chains, e, n, d, monkeypatch):
    _need_card()
    rng = np.random.default_rng(7 * e + n + d)
    args = _boxed_k2(rng, p_n, chains, e, n, d)
    assert (~args[3].any(dim=-1) & (args[11][..., 0] <= args[11][..., 1])
            ).any()                        # a net scored by its box alone
    _k2_check(args, ("boxes", p_n))
    # the tables, boxes included, left in global memory
    e_n, n_n, k = args[1].shape[1], args[2].shape[1], args[4].shape[2]
    w = pnr_cost.anneal_layout(n_n, d, e_n, k, True)[0]
    monkeypatch.setattr(pnr_cost, "SMEM_LIMIT", pnr_cost._lib()
                        .pnr_anneal_smem_bytes(n_n, w, e_n, k, 0, 1, 1))
    assert pnr_cost.anneal_layout(n_n, d, e_n, k, True)[1:3] == (False, True)
    _k2_check(args, ("boxes unstaged", p_n))
    # and the chain's state in the global scratch
    monkeypatch.setattr(pnr_cost, "SMEM_LIMIT", pnr_cost.SMEM_LIMIT - 1)
    assert pnr_cost.anneal_layout(n_n, d, e_n, k, True)[2:] == (False, 0)
    _k2_check(args, ("boxes, chain in global memory", p_n))


@pytest.mark.parametrize("score_mode", ["delta", "full"])
def test_place_hierarchical_on_card_equals_cpu(score_mode):
    _need_card()
    from repro_torch.fabric import place_hierarchical
    spec = FabricSpec(rows=24, cols=24)
    nl = synthetic_netlist(spec, seed=2, locality=3)
    kw = dict(cluster_grid=3, chains=3, sweeps=3, seed=4,
              score_mode=score_mode)
    before = pnr_cost.anneal_chains.launches
    got = place_hierarchical(nl, spec, device="cuda", **kw)
    assert pnr_cost.anneal_chains.launches > before
    want = place_hierarchical(nl, spec, device="cpu", **kw)
    assert np.array_equal(got.cluster_slots, want.cluster_slots)
    assert got.detail_slots.keys() == want.detail_slots.keys()
    assert all(np.array_equal(got.detail_slots[k], want.detail_slots[k])
               for k in got.detail_slots)
    assert want.deblock_slots is not None
    assert np.array_equal(got.deblock_slots, want.deblock_slots)
    assert got.level_costs == want.level_costs
    assert got.coords == want.coords and got.cost == want.cost


def test_k2_refuses_oversized_problem():
    # the earlier form refused a problem whose chain state alone exceeds
    # 227 KB (here 240,000 B); that state now lives in a global scratch,
    # and the chain equals its plain version
    _need_card()
    rng = np.random.default_rng(20000)
    args, k = _synthetic_k2(rng, 1, 2, 20000, 20000, 3, s=300)
    e_n, n_n = args[1].shape[1], args[2].shape[1]
    assert (2 * e_n + n_n) * 4 > pnr_cost.SMEM_LIMIT
    assert pnr_cost.anneal_layout(n_n, 3, e_n, k)[1:] == (False, False, 0)
    _k2_check(args, ("oversized", k))


def test_wrapper_rejects_bad_inputs():
    _need_card()
    dev = torch.device("cuda")
    p = _problems()[0]
    args = _k2_args([p], chains=2, sweeps=2)
    bad = list(args)
    bad[10] = args[10].long()                       # slot0 in int64
    with pytest.raises(TypeError):
        pnr_cost.anneal_chains(*bad)
    with pytest.raises(ValueError):                 # boxes of the wrong width
        pnr_cost.anneal_chains(*args, torch.zeros(
            (1, args[2].shape[1], 3), device=dev))
    with pytest.raises(ValueError):             # pnc0_out of the wrong shape
        pnr_cost.anneal_chains(*args, pnc0_out=torch.zeros(
            (1, 1), device=dev))


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
    # II > 1, K > 1 and latch FIFOs deeper than 1 among the signatures
    assert any(p.ii > 1 for items in groups.values() for p, _ in items)
    assert all(sig[9] > 1 for sig in groups) and k_n > 1
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


@pytest.mark.parametrize("with_mul", [False, True])
def test_k3_mac_rounds_by_the_table(with_mul):
    """A single-op ``mac`` program alone (its table lacks ``mul``: one
    FMA) and in one bucket with a single-op ``mul`` program (the bucket's
    table holds ``mul``: the product rounded first), on normal float
    inputs: K3 == its plain version bit for bit, and ``mac``'s outputs
    are the rounding the table calls for, on lanes where the two differ."""
    _need_card()
    dev = torch.device("cuda")
    progs = [_program(_single_op(op), op)
             for op in (("mac", "mul") if with_mul else ("mac",))]
    k_n, b_n = 64, 2
    sig = sim_signature(progs[0], k_n, b_n)
    assert {sim_signature(p, k_n, b_n) for p in progs} == {sig}
    x = np.random.default_rng(3).normal(size=(b_n, k_n, 3)).astype(
        np.float32)
    arrs = [np.ascontiguousarray(x[:, :, [int(n[1:]) for n in
                                          p.input_names]]) for p in progs]
    tables, inputs, op_ids = bucket_tensors(progs, arrs, sig, dev)
    mac_id = sim_step.OP_MAC2 if with_mul else sim_step.OP_IDS["mac"]
    assert mac_id in op_ids.tolist()
    kw = dict(cycles=sig[8], latch_depth=sig[9])
    before = sim_step.simulate_batch_stepper.launches
    got = sim_step.simulate_batch_stepper(tables, inputs, op_ids, **kw)
    assert sim_step.simulate_batch_stepper.launches == before + 1
    want = sim_step.simulate_batch_plain(tables, inputs, op_ids, **kw)
    torch.cuda.synchronize()
    assert bool(_same_bits(got, want).all())
    a, b, c = (torch.from_numpy(x[:, :, j]).to(dev) for j in range(3))
    fused, twice = sim_step._fma(a, b, c), a * b + c
    assert not bool(_same_bits(fused, twice).all())
    mac_out = got[0][:, :, progs[0].out_cols[0]]
    assert bool(_same_bits(mac_out, twice if with_mul else fused).all())


def test_k3_state_above_227_kb_runs_from_global_memory():
    """A bucket whose state does not fit in shared memory takes the
    global-memory placement by itself, and stays bit-equal."""
    _need_card()
    dev = torch.device("cuda")
    rng = np.random.default_rng(2)
    prog = next(p for p, exact in _sim_cases() if exact and p.ii > 1)
    sig = list(sim_signature(prog, 3, 2))
    sig = tuple(sig[:4] + [32768] + sig[5:])         # 256 KB of wires
    arr = _operands(rng, (2, 3, prog.n_ext))
    tables, inputs, op_ids = bucket_tensors([prog], [arr], sig, dev)
    assert sim_step.stepper_state_bytes(*sig[:7], sig[9]) \
        > sim_step.SMEM_LIMIT
    kw = dict(cycles=sig[8], latch_depth=sig[9])
    got = sim_step.simulate_batch_stepper(tables, inputs, op_ids, **kw)
    want = sim_step.simulate_batch_plain(tables, inputs, op_ids, **kw)
    torch.cuda.synchronize()
    assert bool(_same_bits(got, want).all())


def test_k3_floor_keeps_outputs_zero():
    """The empty-cycle run (barriers and event walks only) launches the
    same kernel and captures nothing."""
    _need_card()
    dev = torch.device("cuda")
    prog = _program(_single_op("add"), "add")
    sig = sim_signature(prog, 3, 2)
    arr = np.ones((2, 3, prog.n_ext), np.float32)
    tables, inputs, op_ids = bucket_tensors([prog], [arr], sig, dev)
    for fg in (False, True):
        got = sim_step.launch_stepper(sim_step.prepare_stepper(
            tables, inputs, op_ids, cycles=sig[8], latch_depth=sig[9],
            floor=True, force_global=fg))
        torch.cuda.synchronize()
        assert not bool(got.any())


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


# ---------------------------------------------------------------------------
# K4: the generated fused-PE kernel; K5: the matmul with a PE epilogue
# ---------------------------------------------------------------------------
PE_SPECS = {
    "muladd": [("mul", (-1, -1)), ("add", (0, -1))],
    "conv_relu": [("mul", (-1, -1)), ("add", (0, -1)), ("const", ()),
                  ("max", (1, 2))],
    "harris_resp": [("mul", (-1, -1)), ("mul", (-1, -1)), ("sub", (0, 1)),
                    ("abs", (2,))],
    "swiglu_core": [("sigmoid", (-1,)), ("mul", (0, -1)), ("mul", (1, -1))],
    "two_sinks": [("lt", (-1, -1)), ("add", (0, -1)), ("sel", (0, -1, -1)),
                  ("mul", (1, -1))],
    "bool_arith": [("lt", (-1, -1)), ("gt", (-1, -1)), ("add", (0, 1)),
                   ("mac", (0, 1, -1)), ("and", (2, 3)), ("not", (4,))],
}


def _pe_cases():
    from repro_torch.graphir import pattern_from_spec
    from repro_torch.kernels.pe_fused import _TORCH_SEMANTICS
    cases = {name: pattern_from_spec(s) for name, s in PE_SPECS.items()}
    for op in _TORCH_SEMANTICS:
        cases[f"op_{op}"] = pattern_from_spec([(op, (-1,) * OPS[op].arity)])
    inf = pattern_from_spec([("add", (-1, -1)), ("const", ()),
                             ("min", (0, 1))])
    inf.attrs[1]["value"] = float("-inf")
    cases["neg_inf_const"] = inf
    return cases


def _close(got, want, tol):
    got, want = got.double(), want.double()
    ok = torch.isclose(got, want, rtol=tol, atol=tol, equal_nan=True)
    return bool(ok.all())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k4_matches_plain(dtype):
    _need_card()
    from repro_torch.graphir.graph import free_in_ports
    from repro_torch.kernels import make_pe_kernel
    from repro_torch.kernels.pe_fused import pe_apply, pe_apply_plain
    dt = getattr(torch, dtype)
    tol = 1e-5 if dtype == "float32" else 5e-2
    rng = np.random.default_rng(2)
    for name, pat in _pe_cases().items():
        n_in = len(free_in_ports(pat))
        for shape in ((33, 77), (1000, 1000)):
            xs = [torch.as_tensor(_operands(rng, shape)).to(dt).cuda()
                  for _ in range(n_in)]
            before = pe_apply.launches
            got = make_pe_kernel(pat)(*xs)
            assert pe_apply.launches == before + 1
            want = pe_apply_plain(pat, *xs)
            torch.cuda.synchronize()
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            for g, w in zip(got, want):
                assert g.device.type == "cuda" and g.dtype == dt
                assert _close(g, w, tol), (name, shape, dtype)


def test_k4_refuses_like_reference():
    _need_card()
    from repro_torch.graphir import pattern_from_spec
    from repro_torch.kernels import make_pe_kernel
    with pytest.raises(ValueError, match="no free in-ports"):
        make_pe_kernel(pattern_from_spec([("const", ())]))
    fn = make_pe_kernel(pattern_from_spec([("mul", (-1, -1))]))
    x = torch.ones(4, 4, device="cuda")
    with pytest.raises(TypeError, match="expected 2 inputs"):
        fn(x)
    with pytest.raises(TypeError, match="sub does not accept dtype bool"):
        make_pe_kernel(pattern_from_spec([
            ("lt", (-1, -1)), ("gt", (-1, -1)), ("sub", (0, 1))]))(
                x, x, x, x)


GEMM_EPILOGUES = {
    "none": (None, ()),
    "bias_relu": ([("add", (-1, -1)), ("const", ()), ("max", (0, 1))],
                  ("vec",)),
    "residual": ([("add", (-1, -1))], ("full",)),
    "scale_shift_gelu": ([("mul", (-1, -1)), ("add", (0, -1)),
                          ("erf", (1,)), ("mul", (2, -1))],
                         ("vec", "vec", "full")),
    "bool_mix": ([("lt", (-1, -1)), ("sel", (0, -1, -1)),
                  ("add", (0, 1))], ("full", "vec", "full")),
}


def _gemm_close(got, want):
    got, want = got.double(), want.double()
    return bool(((got - want).abs()
                 <= 1e-4 * want.abs().clamp(min=1.0)).all())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k5_matches_plain(dtype):
    _need_card()
    from repro_torch.graphir import pattern_from_spec
    from repro_torch.kernels import gemm_pe
    from repro_torch.kernels.gemm import gemm_pe_plain
    assert not torch.backends.cuda.matmul.allow_tf32
    dev = torch.device("cuda")
    dt = getattr(torch, dtype)
    g = torch.Generator(device=dev).manual_seed(0)
    # ragged against the 128 x 128 tile, the 32-deep step and the 16-byte
    # copies (K = 333, 70, 5 or N = 129, 50: element copies)
    for m, k, n in ((64, 64, 64), (100, 70, 50), (256, 128, 192),
                    (1000, 333, 700), (1, 5, 129), (300, 100, 260),
                    (129, 2048, 136)):
        x = torch.randn(m, k, device=dev, generator=g).to(dt)
        w = (torch.randn(k, n, device=dev, generator=g) / k ** 0.5).to(dt)
        for name, (spec, kinds) in GEMM_EPILOGUES.items():
            epi = None if spec is None else pattern_from_spec(spec)
            extras = [torch.randn((n,) if kd == "vec" else (m, n),
                                  device=dev, generator=g) for kd in kinds]
            kw = dict(epilogue=epi, extra_kinds=kinds)
            before = gemm_pe.launches
            got = gemm_pe(x, w, *extras, out_dtype=torch.float32, **kw)
            assert gemm_pe.launches == before + 1
            want = gemm_pe_plain(x, w, *extras, out_dtype=torch.float32,
                                 **kw)
            torch.cuda.synchronize()
            assert got.shape == (m, n)
            assert _gemm_close(got, want), (name, m, k, n, dtype)
            low = gemm_pe(x, w, *extras, out_dtype=torch.bfloat16, **kw)
            torch.cuda.synchronize()
            assert torch.equal(low, got.to(torch.bfloat16)), (name, m, k, n)


def test_k5_every_epilogue_op_matches_plain():
    _need_card()
    from repro_torch.graphir import pattern_from_spec
    from repro_torch.kernels import gemm_pe
    from repro_torch.kernels.gemm import EPI_OPCODES, gemm_pe_plain
    dev = torch.device("cuda")
    rng = np.random.default_rng(4)
    m, k, n = 96, 40, 160
    # small integers: the product is exact in any order, so the epilogue
    # sees the same accumulator in both versions
    x = torch.as_tensor(rng.integers(-3, 4, (m, k)), dtype=torch.float32,
                        device=dev)
    w = torch.as_tensor(rng.integers(-3, 4, (k, n)), dtype=torch.float32,
                        device=dev)
    for op in EPI_OPCODES:
        arity = OPS[op].arity
        pat = pattern_from_spec([(op, (-1,) * arity)])
        kinds = ("full", "vec")[:arity - 1]
        extras = [torch.as_tensor(_operands(rng, (m, n) if kd == "full"
                                            else (n,)), device=dev)
                  for kd in kinds]
        got = gemm_pe(x, w, *extras, epilogue=pat, extra_kinds=kinds)
        want = gemm_pe_plain(x, w, *extras, epilogue=pat, extra_kinds=kinds)
        torch.cuda.synchronize()
        assert _close(got, want, 1e-5), op


def test_k5_rejects_bad_inputs():
    _need_card()
    from repro_torch.graphir import pattern_from_spec
    from repro_torch.kernels import gemm_pe
    x = torch.ones(8, 6, device="cuda")
    with pytest.raises(ValueError, match="inner dimensions"):
        gemm_pe(x, torch.ones(5, 4, device="cuda"))
    with pytest.raises(ValueError, match="takes 1 extra"):
        gemm_pe(x, torch.ones(6, 4, device="cuda"),
                epilogue=pattern_from_spec([("add", (-1, -1))]))


# ---------------------------------------------------------------------------
# K6: flash attention; K7: the selective scan
# ---------------------------------------------------------------------------
def _attn_inputs(g, b, hq, hkv, s, d, dtype=torch.float32):
    dev = torch.device("cuda")
    return [torch.randn((b, h, s, d), device=dev, generator=g).to(dtype)
            for h in (hq, hkv, hkv)]


#: K6 in bfloat16 against its plain version, beside the reference tests'
#: 5e-2: ||got - want|| / ||want|| over the output and over each row of
#: head_dim values (chip_smoke.py's K6_BF16_REL and K6_BF16_ROW)
K6_BF16_REL, K6_BF16_ROW = 2.0 ** -8, 2.0 ** -6


def _assert_k6_bf16_close(got, want, what):
    assert torch.allclose(got.float(), want.float(), rtol=5e-2,
                          atol=5e-2), what
    d, w = got.double() - want.double(), want.double()
    rel = float(d.norm() / w.norm())
    row = float((d.norm(dim=-1) / w.norm(dim=-1)).max())
    assert rel <= K6_BF16_REL and row <= K6_BF16_ROW, (what, rel, row)


ATTN_CASES = [
    # (B, Hq, Hkv, S, D, kwargs): the reference tests' cases, ragged S,
    # windows with and without causal, softcap, D = 128 and odd D
    (2, 4, 4, 128, 32, dict(causal=True)),
    (2, 4, 2, 256, 32, dict(causal=False)),
    (2, 8, 2, 192, 16, dict(causal=True)),
    (1, 4, 2, 256, 32, dict(causal=True, window=48)),
    (1, 4, 2, 256, 32, dict(causal=True, window=64, softcap=20.0)),
    (1, 4, 2, 100, 32, dict(causal=False)),
    (1, 4, 2, 100, 32, dict(causal=True)),
    (1, 4, 2, 300, 64, dict(causal=False, window=70, softcap=5.0)),
    (1, 4, 2, 513, 128, dict(causal=True, window=200, softcap=50.0,
                             scale=1.0 / 12)),
    (1, 2, 1, 77, 40, dict(causal=True)),
    (1, 2, 2, 1, 8, dict(causal=False)),
    (1, 8, 2, 333, 64, dict(causal=True)),
    (1, 4, 1, 200, 128, dict(causal=False)),
    (1, 8, 2, 150, 64, dict(causal=False, window=40)),
    (1, 2, 1, 70, 50, dict(causal=True)),
]


@pytest.mark.parametrize("case", range(len(ATTN_CASES)))
def test_k6_matches_plain(case):
    _need_card()
    from repro_torch.kernels import flash_attention
    from repro_torch.kernels.flash_attention import attention_plain
    from repro_torch.kernels.ref import ref_attention
    assert not torch.backends.cuda.matmul.allow_tf32
    b, hq, hkv, s, d, kw = ATTN_CASES[case]
    g = torch.Generator(device="cuda").manual_seed(case)
    q, k, v = _attn_inputs(g, b, hq, hkv, s, d)
    before = flash_attention.launches
    got = flash_attention(q, k, v, **kw)
    assert flash_attention.launches == before + 1
    want = attention_plain(q, k, v, **kw)
    oracle = ref_attention(q.double(), k.double(), v.double(), **kw)
    torch.cuda.synchronize()
    assert got.shape == q.shape and got.dtype == q.dtype
    assert torch.allclose(got, want, rtol=2e-5, atol=2e-5), case
    assert torch.allclose(got.double(), oracle, rtol=2e-5, atol=2e-5), case


def test_k6_bfloat16_matches_plain():
    _need_card()
    from repro_torch.kernels import flash_attention
    from repro_torch.kernels.flash_attention import attention_plain
    g = torch.Generator(device="cuda").manual_seed(7)
    for s, d in ((128, 32), (200, 64), (256, 128)):
        q, k, v = _attn_inputs(g, 1, 4, 2, s, d, torch.bfloat16)
        got = flash_attention(q, k, v, causal=True)
        want = attention_plain(q, k, v, causal=True)
        torch.cuda.synchronize()
        assert got.dtype == torch.bfloat16
        _assert_k6_bf16_close(got, want, (s, d))


@pytest.mark.parametrize("case", range(len(ATTN_CASES)))
def test_k6_bfloat16_every_case(case):
    """bfloat16 (one product on the bfloat16 tensor cores each) on every
    case of ``ATTN_CASES``, held to the plain version at 5e-2 and by its
    relative error norms."""
    _need_card()
    from repro_torch.kernels import flash_attention
    from repro_torch.kernels.flash_attention import attention_plain
    b, hq, hkv, s, d, kw = ATTN_CASES[case]
    g = torch.Generator(device="cuda").manual_seed(100 + case)
    q, k, v = _attn_inputs(g, b, hq, hkv, s, d, torch.bfloat16)
    before = flash_attention.launches
    got = flash_attention(q, k, v, **kw)
    assert flash_attention.launches == before + 1
    want = attention_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    assert got.shape == q.shape and got.dtype == torch.bfloat16
    _assert_k6_bf16_close(got, want, case)


def test_k6_rejects_bad_inputs():
    _need_card()
    from repro_torch.kernels import flash_attention
    q, k, v = _attn_inputs(torch.Generator(device="cuda").manual_seed(0),
                           1, 3, 2, 16, 8)
    with pytest.raises(ValueError, match="not a multiple"):
        flash_attention(q, k, v)
    q, k, v = _attn_inputs(torch.Generator(device="cuda").manual_seed(0),
                           1, 2, 2, 16, 8)
    with pytest.raises(TypeError, match="float32 or all bfloat16"):
        flash_attention(q, k.bfloat16(), v)
    with pytest.raises(TypeError, match="float32 or all bfloat16"):
        flash_attention(q.double(), k.double(), v.double())
    with pytest.raises(ValueError, match="must be"):
        flash_attention(q, k[:, :, :8], v)
    big = torch.zeros((1, 1, 4, 160), device="cuda")
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(big, big, big)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,d,n", [(2, 64, 32, 4), (2, 96, 64, 8),
                                     (2, 128, 128, 16), (1, 100, 50, 16),
                                     (1, 37, 19, 5), (1, 300, 70, 40),
                                     (1, 20, 9, 200)])
def test_k7_matches_plain(dtype, b, s, d, n):
    _need_card()
    from repro_torch.kernels import mamba_scan
    from repro_torch.kernels.mamba_scan import mamba_scan_plain
    dev = torch.device("cuda")
    dt = getattr(torch, dtype)
    g = torch.Generator(device=dev).manual_seed(s + d + n)
    a = (torch.rand((b, s, d, n), device=dev, generator=g) * 0.399
         + 0.6).to(dt)
    bx = (torch.randn((b, s, d, n), device=dev, generator=g) * 0.1).to(dt)
    c = torch.randn((b, s, n), device=dev, generator=g).to(dt)
    before = mamba_scan.launches
    got = mamba_scan(a, bx, c)
    assert mamba_scan.launches == before + 1
    want = mamba_scan_plain(a, bx, c)
    torch.cuda.synchronize()
    assert got.shape == (b, s, d) and got.dtype == torch.float32
    assert torch.allclose(got, want, rtol=1e-4, atol=1e-4), (b, s, d, n)


def test_k7_rejects_bad_inputs():
    _need_card()
    from repro_torch.kernels import mamba_scan
    a = torch.ones((1, 4, 3, 2), device="cuda")
    c = torch.ones((1, 4, 2), device="cuda")
    with pytest.raises(ValueError, match="c must be"):
        mamba_scan(a, a, c[:, :3])
    with pytest.raises(TypeError, match="float32 or all bfloat16"):
        mamba_scan(a, a.bfloat16(), c)
    wide = torch.ones((1, 2, 2, 600), device="cuda")
    with pytest.raises(ValueError, match="state size"):
        mamba_scan(wide, wide, torch.ones((1, 2, 600), device="cuda"))
