"""The port's schedule and simulate stages (plain kernel versions,
``device="cpu"``) against the JAX package's on the same inputs: modulo
schedules, lowered and padded programs, the ALU step, batched and
per-program simulation, the Explorer's records with ``simulate=True`` and
the legacy ``evaluate_variants`` shim.

Tolerance: bit equality (NaNs count as equal) on every IEEE-exact op and
every simulated output of the paper suite.  The transcendentals (exp, log,
tanh, sigmoid, rsqrt, pow) are held to 2 ulp: of the JAX package's value,
and for tanh of the correctly rounded value (XLA's CPU tanh is a rational
approximation several ulp from it).  No operand or result is subnormal:
XLA's CPU backend flushes them to zero, the port keeps IEEE subnormals.
"""

import re
import zlib
from collections import Counter, defaultdict
from dataclasses import asdict, replace
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.sim as R
from repro import faultinject as r_faults
from repro.apps import image_graphs as r_images, ml_graphs as r_ml_graphs
from repro.core import baseline_datapath as r_base, map_application as r_map
from repro.core.dse import PEVariant as RVariant, app_ops as r_ops
from repro.core.dse import evaluate_variants as r_evaluate
from repro.core.mining import MiningConfig as RMining
from repro.explore import ExploreConfig as RConfig, Explorer as RExplorer
from repro.fabric import FabricOptions as ROptions, FabricSpec as RSpec
from repro.fabric import place_and_route as r_pnr
from repro.graphir.graph import Graph as RGraph
from repro.kernels import sim_step as r_step
import repro_torch.sim as T
from repro_torch import faultinject as t_faults
from repro_torch.apps import image_graphs as t_images
from repro_torch.apps import ml_graphs as t_ml_graphs
from repro_torch.core import baseline_datapath as t_base
from repro_torch.core import map_application as t_map
from repro_torch.core.dse import PEVariant as TVariant, app_ops as t_ops
from repro_torch.core.dse import evaluate_variants as t_evaluate
from repro_torch.core.mining import MiningConfig as TMining
from repro_torch.explore import ExploreConfig as TConfig
from repro_torch.explore import Explorer as TExplorer
from repro_torch.fabric import FabricOptions as TOptions, FabricSpec as TSpec
from repro_torch.fabric import place_and_route as t_pnr
from repro_torch.graphir.graph import Graph as TGraph
from repro_torch.kernels import sim_step as t_step

ROOT = Path(__file__).resolve().parents[1]
FAST = dict(backend="python", chains=1, sweeps=8)
TRANSCENDENTAL = ("exp", "log", "tanh", "sigmoid", "rsqrt", "pow")
EXACT = tuple(op for op in t_step.ALU_IMPLS
              if op != "nop" and op not in TRANSCENDENTAL)


def _bits(x) -> np.ndarray:
    x = np.ascontiguousarray(np.asarray(x, np.float32))
    return np.where(np.isnan(x), np.int32(0x7FC00000), x.view(np.int32))


def _bit_equal(a, b) -> np.ndarray:
    """Elementwise: same float32 bits, every NaN equal to every NaN."""
    return _bits(a) == _bits(b)


def _ulp(a, b) -> np.ndarray:
    def ordered(x):
        i = np.asarray(x, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    d = np.abs(ordered(a) - ordered(b))
    return np.where(np.isnan(a) & np.isnan(b), 0, d)


# ---------------------------------------------------------------------------
# the Fig. 8 image apps, placed and routed by both packages
# ---------------------------------------------------------------------------
def _flows(name):
    ra, ta = r_images()[name], t_images()[name]
    rdp, tdp = r_base(r_ops(ra)), t_base(t_ops(ta))
    rm, tm = r_map(rdp, ra, name), t_map(tdp, ta, name)
    rp = r_pnr(rdp, rm, ra, RSpec(8, 8), **FAST)
    tp = t_pnr(tdp, tm, ta, TSpec(8, 8), device="cpu", **FAST)
    return (rdp, rm, ra, rp), (tdp, tm, ta, tp)


@pytest.fixture(scope="module")
def fig8():
    return {name: _flows(name) for name in sorted(r_images())}


def _same_schedule(r, t):
    assert (t.ii, t.min_ii, t.rec_mii, t.res_mii, t.latency, t.attempts) \
        == (r.ii, r.min_ii, r.rec_mii, r.res_mii, r.latency, r.attempts)
    assert t.start == r.start and t.hop_time == r.hop_time
    assert t.capture == r.capture and t.latch_depth == r.latch_depth


def test_modulo_schedules_match_reference(fig8):
    r_items, t_items = [], []
    for name, (rf, tf) in fig8.items():
        rp, tp = rf[3], tf[3]
        _same_schedule(
            R.modulo_schedule(rp.netlist, rp.placement, rp.routes, rp.spec),
            T.modulo_schedule(tp.netlist, tp.placement, tp.routes, tp.spec))
        r_items.append((rp.netlist, rp.placement, rp.routes, rp.spec))
        t_items.append((tp.netlist, tp.placement, tp.routes, tp.spec))
    r_stats, t_stats = Counter(), Counter()
    r_batch = R.modulo_schedule_batch(r_items, stats=r_stats)
    t_batch = T.modulo_schedule_batch(t_items, stats=t_stats)
    for r, t in zip(r_batch, t_batch, strict=True):
        _same_schedule(r, t)
    assert t_stats == r_stats and t_stats["sched_group"] > 1


_PROG_ARRAYS = ("opcodes", "op_src", "const_pool", "fire_time", "ext_time",
                "wire_src", "sig_tmp", "sig_owner", "latch_wire",
                "latch_time", "latch_owner", "out_wire", "out_time")


def test_lowered_and_padded_programs_match_reference(fig8):
    for name, (rf, tf) in fig8.items():
        rprog, _ = R.build_sim(*rf[:3], pnr=rf[3])
        tprog, _ = T.build_sim(*tf[:3], pnr=tf[3])
        (tbatch,) = T.build_sim_batch([tf])
        for f in _PROG_ARRAYS:
            assert np.array_equal(getattr(tprog, f), getattr(rprog, f)), f
            assert np.array_equal(getattr(tbatch, f), getattr(rprog, f)), f
        for f in ("ii", "latency", "n_inst", "n_steps", "ops", "n_latch",
                  "n_const", "n_sig", "n_ext", "n_wire", "latch_depth",
                  "out_cols", "input_names"):
            assert getattr(tprog, f) == getattr(rprog, f), f
        for k, b in ((3, 2), (16, 256)):
            sig = T.sim_signature(tprog, k, b)
            assert sig == R.sim_signature(rprog, k, b)
            code_of = {op: i for i, op in enumerate(tprog.ops)}
            got = T.cycle._pad_program(tprog, sig, code_of)
            want = R.cycle._pad_program(rprog, sig, code_of)
            assert set(got) == set(want) == set(T.cycle._BATCH_FIELDS)
            for f, v in want.items():
                assert np.array_equal(got[f], v), (name, f)
    assert T.cycle._SIG_FLOORS == R.cycle._SIG_FLOORS
    assert T.cycle._NEVER == R.cycle._NEVER


# ---------------------------------------------------------------------------
# the ALU step
# ---------------------------------------------------------------------------
_SPECIAL = np.float32([0.0, -0.0, np.inf, -np.inf, np.nan, 1.0, -1.0, 2.5])


def _operands(op, rng, n=512):
    """(a, b, c) float32 with no subnormal operand or result: normal
    values, small integers, and ±0, ±inf, NaN in every position."""
    def normal(lo, hi):
        mag = np.exp(rng.uniform(np.log(lo), np.log(hi), n))
        return (mag * rng.choice([-1.0, 1.0], n)).astype(np.float32)
    a, b, c = normal(1e-3, 1e3), normal(1e-3, 1e3), normal(1e-3, 1e3)
    if op in ("shl", "shr", "ashr"):
        b = rng.integers(-30, 31, n).astype(np.float32)
    elif op in ("exp", "sigmoid"):
        a = rng.uniform(-80.0, 80.0, n).astype(np.float32)
    elif op in ("log", "rsqrt"):
        a = np.abs(a)
    elif op == "pow":
        a, b = np.abs(a), rng.uniform(-4.0, 4.0, n).astype(np.float32)
    elif op in ("floor", "round"):
        a = (rng.integers(-40, 41, n) / 4.0).astype(np.float32)
    for x in (a, b, c):
        x[rng.integers(0, n, 48)] = rng.choice(_SPECIAL, 48)
    if op in ("shl", "shr", "ashr"):
        # 2**b is exact only for integral b; a fractional shift is libm's
        # pow, a transcendental
        b[b != np.floor(b)] = 3.0
    a[:3], b[:3] = np.float32([0.0, -0.0, 0.0]), np.float32([-0.0, 0.0, 0.0])
    return a, b, c


def _step_inputs(op, seed):
    rng = np.random.default_rng(seed)
    ops = t_step.op_table([op, "add"])
    a, b, c = _operands(op, rng)
    codes = np.where(rng.random(a.shape[0]) < 0.9, ops.index(op),
                     rng.integers(0, len(ops), a.shape[0])).astype(np.int32)
    return ops, codes, a, b, c


def _port_step(ops, codes, a, b, c):
    t = [torch.from_numpy(x) for x in (codes, a, b, c)]
    return t_step.alu_step_plain(*t, ops).numpy()


@pytest.mark.parametrize("op", EXACT)
def test_alu_step_exact_ops_bit_equal(op):
    ops, codes, a, b, c = _step_inputs(op, zlib.crc32(op.encode()))
    got = _port_step(ops, codes, a, b, c)
    jnp_out = np.asarray(r_step.alu_step_jnp(codes, a, b, c, ops))
    assert _bit_equal(got, jnp_out).all()
    # the Pallas step in interpret mode rounds as the jitted step does:
    # mac is one FMA here, where the table (op, add) has no mul
    pallas = np.asarray(r_step.alu_step_pallas(codes, a, b, c, ops,
                                               interpret=True))
    assert _bit_equal(got, pallas).all()
    # the numpy oracle rounds mac twice, and orders ±0 in min/max and
    # signs -0 differently from XLA; elsewhere all three agree
    oracle = r_step.alu_step_reference(codes, a, b, c, ops)
    agree = _bit_equal(oracle, jnp_out)
    assert _bit_equal(got, oracle)[agree].all()
    assert agree.mean() > 0.5
    if op not in ("mac", "min", "max", "sign"):
        assert agree.all()


@pytest.mark.parametrize("op", TRANSCENDENTAL)
def test_alu_step_transcendentals_within_2_ulp(op):
    ops, codes, a, b, c = _step_inputs(op, zlib.crc32(op.encode()))
    got = _port_step(ops, codes, a, b, c)
    if op == "tanh":
        want = np.where(codes == 0, 0.0,
                        np.tanh(a.astype(np.float64))).astype(np.float32)
        want = np.where(codes == ops.index("add"), a + b, want)
    else:
        want = np.asarray(r_step.alu_step_jnp(codes, a, b, c, ops))
    assert _ulp(got, want).max() <= 2


def test_alu_step_masked_and_op_table():
    ops, codes, a, b, c = _step_inputs("mul", 3)
    active = np.random.default_rng(4).random(a.shape[0]) < 0.5
    t = [torch.from_numpy(x) for x in (codes, a, b, c)]
    got = t_step.alu_step_masked(*t, ops, torch.from_numpy(active)).numpy()
    assert _bit_equal(got[active], _port_step(ops, codes, a, b, c)[active]).all()
    assert np.all(got[~active] == 0.0) and not np.signbit(got[~active]).any()
    assert t_step.op_table(["sub", "add", "nop"]) == ("nop", "add", "sub")
    with pytest.raises(NotImplementedError):
        t_step.op_table(["add", "matmul"])
    assert list(t_step.ALU_IMPLS) == list(r_step.ALU_IMPLS)


def test_kernel_op_enum_matches_alu_table():
    """The kernel switches on the op id of ``ALU_IMPLS``'s order."""
    src = (ROOT / "src/repro_torch/kernels/csrc/sim_step.cu").read_text()
    body = re.search(r"enum AluOp \{(.*?)\};", src, re.S).group(1)
    names = [m.lower() for m in re.findall(r"\bOP_(\w+)", body)]
    assert names == list(t_step.ALU_IMPLS)


def _periodic_floor(c, t0, ii, k_n):
    d = c - t0
    k = d // ii
    return (d >= 0) and (d % ii == 0) and (k < k_n), min(max(k, 0), k_n - 1)


def _periodic_trunc(c, t0, ii, k_n):
    """The kernel's latch-view iteration: C's truncating ``/`` and
    ``%``."""
    d = c - t0
    q = int(d / ii) if d >= 0 else -((-d) // ii)
    r = d - q * ii
    return (d >= 0) and (r == 0) and (q < k_n), min(max(q, 0), k_n - 1)


def test_kernel_periodic_truncation_matches_floor_semantics():
    never = R.cycle._NEVER
    for ii in (1, 2, 3, 7, 15):
        for k_n in (1, 3, 16):
            for t0 in (0, 1, 5, 40, never):
                for c in range(0, 200):
                    assert _periodic_trunc(c, t0, ii, k_n) \
                        == _periodic_floor(c, t0, ii, k_n), (c, t0, ii, k_n)


# ---------------------------------------------------------------------------
# simulation: batched, per program, every op through the whole flow
# ---------------------------------------------------------------------------
def test_simulate_batch_bit_identical_and_grouping_independent(fig8):
    rp, tp, xs = {}, {}, {}
    for name in ("gaussian", "harris", "laplacian"):
        rf, tf = fig8[name]
        rp[name] = R.build_sim(*rf[:3], pnr=rf[3])[0]
        tp[name] = T.build_sim(*tf[:3], pnr=tf[3])[0]
        xs[name] = R.random_inputs(rp[name], 3, 2,
                                   seed=zlib.crc32(name.encode()) & 0xFFFF)
    by_sig = defaultdict(list)
    for name in rp:
        by_sig[T.sim_signature(tp[name], 3, 2)].append(name)
    assert any(len(v) > 1 for v in by_sig.values())
    for members in by_sig.values():
        want = R.simulate_batch([rp[n] for n in members],
                                [xs[n] for n in members])
        got = T.simulate_batch([tp[n] for n in members],
                               [xs[n] for n in members], device="cpu")
        for n, w, g in zip(members, want, got, strict=True):
            assert np.array_equal(g.outputs, w.outputs), n
            assert (g.ii, g.min_ii, g.latency, g.cycles, g.n_fires,
                    g.active_frac, g.backend) == (
                w.ii, w.min_ii, w.latency, w.cycles, w.n_fires,
                w.active_frac, w.backend)
            alone = T.simulate_batch([tp[n]], [xs[n]], device="cpu")[0]
            assert np.array_equal(alone.outputs, g.outputs), n


@pytest.mark.parametrize("backend", ["jax", "pallas"])
def test_simulate_per_program_equals_batched_and_reference(fig8, backend):
    rf, tf = fig8["gaussian"]
    rprog = R.build_sim(*rf[:3], pnr=rf[3])[0]
    tprog = T.build_sim(*tf[:3], pnr=tf[3])[0]
    x = R.random_inputs(rprog, 2, 2, seed=5)
    got = T.simulate(tprog, x, backend=backend, device="cpu")
    want = R.simulate(rprog, x, backend=backend)
    batched = T.simulate_batch([tprog], [x], device="cpu")[0]
    assert np.array_equal(got.outputs, want.outputs)
    assert np.array_equal(got.outputs, batched.outputs)
    assert got.backend == want.backend == backend
    assert (got.cycles, got.n_fires, got.active_frac) == (
        want.cycles, want.n_fires, want.active_frac)
    by_name = {name: x[:, :, j] for j, name in enumerate(tprog.input_names)}
    assert np.array_equal(T.simulate(tprog, by_name, device="cpu").outputs,
                          got.outputs)
    res, err, exact = T.check_against_interp(tprog, tf[2], x, device="cpu")
    assert exact and err == 0.0 and np.array_equal(res.outputs, got.outputs)


def _single_op_graph(Graph, op):
    from repro_torch.graphir.ops import OPS
    g = Graph()
    ins = [g.add_node("input", name=f"x{i}") for i in range(3)]
    n = g.add_node(op)
    for port in range(OPS[op].arity):
        g.add_edge(ins[port], n, port)
    g.mark_output(n)
    return g


def test_single_op_programs_match_reference():
    """Every ALU op through map -> pnr -> schedule -> one batched
    simulation, on float operands with ±0, ±inf and NaN.  The bucket's
    table holds mul, so mac rounds its product first, as the reference's
    does; these operands give the same bits under one rounding and two
    (``tests/test_torch_mac_rounding.py`` holds lanes where they differ)."""
    ops = [op for op in t_step.ALU_IMPLS if op != "nop"]
    rps, tps, xs = [], [], []
    for op in ops:
        progs = []
        for Graph, base, ops_of, mp, pnr, build, Spec in (
                (RGraph, r_base, r_ops, r_map, r_pnr, R.build_sim, RSpec),
                (TGraph, t_base, t_ops, t_map, t_pnr, T.build_sim, TSpec)):
            g = _single_op_graph(Graph, op)
            dp = base(ops_of(g))
            m = mp(dp, g, op)
            kw = {} if Graph is RGraph else dict(device="cpu")
            p = pnr(dp, m, g, Spec(4, 4), **FAST, **kw)
            progs.append(build(dp, m, g, pnr=p)[0])
        rps.append(progs[0])
        tps.append(progs[1])
        a, b, c = _operands(op, np.random.default_rng(zlib.crc32(op.encode())),
                            n=2 * 8)
        cols = {"x0": a, "x1": b, "x2": c}
        xs.append(np.stack([cols[name].reshape(2, 8)
                            for name in progs[1].input_names], axis=-1))
    sigs = {T.sim_signature(p, 8, 2) for p in tps}
    assert len(sigs) == 1
    want = R.simulate_batch(rps, xs)
    got = T.simulate_batch(tps, xs, device="cpu")
    for op, w, g, x in zip(ops, want, got, xs, strict=True):
        if op == "tanh":                 # x0 is the only input
            truth = np.tanh(x.astype(np.float64)).astype(np.float32)
            assert _ulp(g.outputs, truth).max() <= 2
        elif op in TRANSCENDENTAL:
            assert _ulp(g.outputs, w.outputs).max() <= 2, op
        else:
            assert _bit_equal(g.outputs, w.outputs).all(), op


def test_simulate_batch_rejects_bad_groups(fig8):
    tf = fig8["gaussian"][1]
    prog = T.build_sim(*tf[:3], pnr=tf[3])[0]
    x = T.random_inputs(prog, 2, 1, seed=0)
    with pytest.raises(ValueError, match="backend"):
        T.simulate_batch([prog], [x], backend="pallas", device="cpu")
    with pytest.raises(ValueError, match="1:1"):
        T.simulate_batch([prog], [x, x], device="cpu")
    with pytest.raises(ValueError):
        T.simulate_batch([prog, prog],
                         [x, T.random_inputs(prog, 3, 2, seed=0)],
                         device="cpu")
    with pytest.raises(ValueError, match="backend"):
        T.simulate(prog, x, backend="bogus", device="cpu")


def _tables(prog, k=2, b=1):
    sig = T.sim_signature(prog, k, b)
    code_of = {op: i for i, op in enumerate(prog.ops)}
    d = T.cycle._pad_program(prog, sig, code_of)
    return sig, {f: torch.from_numpy(np.asarray(d[f])[None]).contiguous()
                 for f in T.cycle._BATCH_FIELDS}


def test_stepper_wrapper_runs_plain_on_cpu_tensors(fig8):
    tf = fig8["harris"][1]
    prog = T.build_sim(*tf[:3], pnr=tf[3])[0]
    sig, tables = _tables(prog)
    x = torch.from_numpy(T.random_inputs(prog, 2, 1, seed=1))
    inputs = torch.zeros((1, 1, 2, sig[2]))
    inputs[0, :, :, :prog.n_ext] = x
    op_ids = torch.tensor([t_step.OP_IDS[o] for o in prog.ops],
                          dtype=torch.int32)
    before = t_step.simulate_batch_stepper.launches
    got = t_step.simulate_batch_stepper(tables, inputs, op_ids,
                                        cycles=sig[8], latch_depth=sig[9])
    assert t_step.simulate_batch_stepper.launches == before
    want = t_step.simulate_batch_plain(tables, inputs, op_ids,
                                       cycles=sig[8], latch_depth=sig[9])
    assert torch.equal(got, want)
    assert t_step.stepper_state_bytes(*sig[:7], sig[9]) < t_step.SMEM_LIMIT


def _walk_events(ev, off, g, kind, c, ii, k_n):
    """K3's walk of its lists at cycle c: {(index, k)} of the entries of
    phase c % II whose iteration k = c // II - (t0 div II) is in [0, K)."""
    b, m = c % ii, c // ii
    lo, hi = int(off[kind, g, b]), int(off[kind, g, b + 1])
    return {(int(x), m - int(m0)) for x, m0 in ev[lo:hi].tolist()
            if 0 <= m - int(m0) < k_n}


@pytest.mark.parametrize("name", ["camera", "gaussian", "harris",
                                  "laplacian"])
@pytest.mark.parametrize("ii,k_n,cycles", [(None, 2, None), (1, 3, 40),
                                           (3, 1, 97), (5, 4, 160)])
def test_event_lists_fire_as_periodic(fig8, name, ii, k_n, cycles):
    """Every entity K3's event lists fire at cycle c, and its k, are what
    ``periodic`` gives with floor semantics, for every cycle; two programs
    of other IIs share the lists."""
    tf = fig8[name][1]
    prog = T.build_sim(*tf[:3], pnr=tf[3])[0]
    sig, one = _tables(prog, k=k_n)
    tables = {f: torch.cat([v, v]) for f, v in one.items()}
    tables["ii"] = torch.tensor([ii or prog.ii, 2 * (ii or prog.ii) + 1],
                                dtype=torch.int32)
    tables["ext_time"][1, :3] = -7           # starts before cycle 0
    cycles = cycles or sig[8]
    ev, off, nb = t_step.event_lists(tables, cycles=cycles, iterations=k_n)
    assert off.shape == (len(t_step.EVENT_KINDS), 2, nb)
    assert nb == int(tables["ii"].max()) + 1
    times = [t.numpy() for t in t_step.event_times(tables)]
    for g in range(2):
        ii_g = int(tables["ii"][g])
        for kind, t in enumerate(times):
            listed = []
            for b in range(nb - 1):
                lo, hi = int(off[kind, g, b]), int(off[kind, g, b + 1])
                listed += ev[lo:hi, 0].tolist()
                if b >= ii_g:
                    assert lo == hi
            assert len(listed) == len(set(listed))
            for c in range(cycles):
                want = set()
                d = c - t[g]
                live = (d >= 0) & (d % ii_g == 0) & (d // ii_g < k_n)
                for i in np.flatnonzero(live):
                    fires, k = _periodic_floor(c, int(t[g, i]), ii_g, k_n)
                    assert fires
                    want.add((int(i), k))
                assert _walk_events(ev, off, g, kind, c, ii_g, k_n) == want


def test_micro_ops_fold_the_opcode_table(fig8):
    tf = fig8["harris"][1]
    prog = T.build_sim(*tf[:3], pnr=tf[3])[0]
    sig, tables = _tables(prog)
    op_ids = torch.tensor([t_step.OP_IDS[o] for o in prog.ops],
                          dtype=torch.int32)
    steps = t_step.micro_ops(tables, op_ids)
    assert steps.shape == tables["op_src"].shape[:3] + (4,)
    assert steps.dtype == torch.int32 and steps.is_contiguous()
    assert torch.equal(steps[..., 1:], tables["op_src"])
    assert torch.equal(steps[..., 0], op_ids[tables["opcodes"].long()])


def test_stepper_index_checks(fig8):
    tf = fig8["gaussian"][1]
    prog = T.build_sim(*tf[:3], pnr=tf[3])[0]
    sig, tables = _tables(prog)
    shapes = t_step._shapes(tables)
    op_ids = torch.tensor([t_step.OP_IDS[o] for o in prog.ops],
                          dtype=torch.int32)
    t_step._check_indices(tables, shapes, op_ids)        # a real program
    tmp_off = sig[5] + sig[6]
    bad = dict(tables, op_src=tables["op_src"].clone())
    bad["op_src"][0, 0, 0, 0] = tmp_off + sig[1]         # tile 1's tmp slot
    with pytest.raises(ValueError, match="tmp slot"):
        t_step._check_indices(bad, shapes, op_ids)
    bad = dict(tables, wire_src=tables["wire_src"].clone())
    bad["wire_src"][0, 0] = sig[3] + sig[2] + sig[4]
    with pytest.raises(ValueError, match="out of range"):
        t_step._check_indices(bad, shapes, op_ids)
    with pytest.raises(ValueError, match="out of range"):
        t_step._check_indices(tables, shapes, op_ids + 100)
    bad = dict(tables, sig_tmp=tables["sig_tmp"].clone())
    bad["sig_tmp"][0, 0] = (int(tables["sig_owner"][0, 0]) + 1) * sig[1]
    with pytest.raises(ValueError, match="signal reads another tile"):
        t_step._check_indices(bad, shapes, op_ids)


def test_compare_with_interp_keeps_reference_fault():
    """An output computed from constants only: the interpreter returns a
    0-d value, so the reference reports bit_exact=False with err=0.0
    (it makes tests/test_property.py's sim==interp property flaky).  The
    port reproduces the reference, fault included."""
    got = []
    for Graph, base, ops_of, mp, pnr, mod, Spec, kw in (
            (RGraph, r_base, r_ops, r_map, r_pnr, R, RSpec, {}),
            (TGraph, t_base, t_ops, t_map, t_pnr, T, TSpec,
             dict(device="cpu"))):
        g = Graph()
        i0 = g.add_node("input", name="i0")
        c = g.add_node("const", value=0.0)
        cc = g.add_node("add")
        g.add_edge(c, cc, 0)
        g.add_edge(c, cc, 1)
        ii = g.add_node("add")
        g.add_edge(i0, ii, 0)
        g.add_edge(i0, ii, 1)
        g.mark_output(cc)
        g.mark_output(ii)
        dp = base(ops_of(g))
        m = mp(dp, g, "consts")
        p = pnr(dp, m, g, Spec(4, 4), **FAST, **kw)
        prog = mod.build_sim(dp, m, g, pnr=p)[0]
        x = mod.random_inputs(prog, 2, 2, seed=0)
        _, err, exact = mod.check_against_interp(prog, g, x, **kw)
        got.append((err, exact))
    assert got[0] == got[1] == (0.0, False)


def test_simulate_needs_a_card_by_default(fig8, monkeypatch):
    tf = fig8["gaussian"][1]
    prog = T.build_sim(*tf[:3], pnr=tf[3])[0]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.simulate(prog, T.random_inputs(prog, 2, 1))


# ---------------------------------------------------------------------------
# the Explorer and the legacy shim with simulate=True
# ---------------------------------------------------------------------------
def _cfg(Config, Mining, Options, Spec, **kw):
    return Config(mode="per_app", max_merge=2,
                  mining=Mining(min_support=3, max_pattern_nodes=4,
                                time_budget_s=600.0),
                  fabric=Options(spec=Spec(rows=8, cols=8), chains=4,
                                 sweeps=8, simulate=True), **kw)


@pytest.fixture(scope="module")
def sim_runs():
    out = {}
    for batch in ("grouped", "serial"):
        ref = RExplorer(r_ml_graphs(), _cfg(RConfig, RMining, ROptions,
                                            RSpec, sim_batch=batch))
        port = TExplorer(t_ml_graphs(), _cfg(TConfig, TMining, TOptions,
                                             TSpec, sim_batch=batch),
                         device="cpu")
        out[batch] = (ref, ref.run(), port, port.run())
    return out


@pytest.mark.parametrize("batch", ["grouped", "serial"])
def test_explorer_sim_records_match_reference(sim_runs, batch):
    ref, rres, port, pres = sim_runs[batch]
    want = [r.to_dict() for r in rres.records()]
    got = [r.to_dict() for r in pres.records()]
    assert want and got == want
    assert all(r["sim_verified"] == 1 and r["sim_ii"] >= r["sim_min_ii"] > 0
               for r in got)
    assert pres.sim_buckets == rres.sim_buckets
    assert [f.to_dict() for f in pres.failures] \
        == [f.to_dict() for f in rres.failures]
    for k in ("sim_dispatch", "sim", "sched", "sched_group", "pnr_dispatch"):
        assert port.stats[k] == ref.stats[k], k
    if batch == "grouped":
        assert port.stats["sim_dispatch"] >= 1
        assert all(r["sim_bucket"] not in ("", "serial") for r in got)
    else:
        assert all(r["sim_bucket"] == "serial" for r in got)


@pytest.mark.parametrize("fault", ["schedule", "simulate", "budget"])
def test_explorer_failure_rows_match_reference(sim_runs, fault):
    """A persistent fault at a stage, or a cycle cap no program meets,
    degrades the same pairs to the same StageFailure rows."""
    rows = []
    for faults, ex, opts in ((r_faults, sim_runs["grouped"][0], ROptions),
                             (t_faults, sim_runs["grouped"][2], TOptions)):
        faults.disarm_all()
        if fault == "budget":
            ex = ex.with_config(fabric=replace(ex.config.fabric,
                                               sim_max_cycles=1))
        else:
            faults.arm(f"{fault}:exc:0")
            faults.arm(f"{fault}.retry:exc:0")
            ex.forget("sched", "sim")
        try:
            res = ex.run()
        finally:
            faults.disarm_all()
        assert res.failures and all(f.stage == ("simulate" if fault ==
                                                "budget" else fault)
                                    for f in res.failures)
        rows.append(([f.to_dict() for f in res.failures],
                     [r.to_dict() for r in res.records()]))
    assert rows[1] == rows[0]


def test_evaluate_variants_simulate_matches_reference():
    got = []
    for images, base, ops_of, Variant, evaluate, Options, Spec, kw in (
            (r_images, r_base, r_ops, RVariant, r_evaluate, ROptions, RSpec,
             {}),
            (t_images, t_base, t_ops, TVariant, t_evaluate, TOptions, TSpec,
             dict(device="cpu"))):
        apps = {n: images()[n] for n in ("gaussian", "harris")}
        dp = base(set().union(*(ops_of(a) for a in apps.values())))
        v = Variant("PE1", dp)
        evaluate([v], apps, fabric=Options(spec=Spec(8, 8), simulate=True,
                                           **FAST), **kw)
        got.append({a: asdict(c) for a, c in v.costs.items()})
    assert got[1] == got[0]
    assert all(c["sim_verified"] == 1 for c in got[1].values())
