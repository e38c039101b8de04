"""How ``mac`` rounds, in the port against the JAX package on the CPU.

XLA contracts ``mac``'s ``a * b + c`` into one FMA only when the
dispatch's op table lacks ``mul``; with ``mul`` in the table the product
is shared with ``mul``'s branch and ``mac`` rounds twice.  The JAX
package's jitted ``alu_step_jnp`` / ``alu_step_masked``, its Pallas step in
interpret mode, ``simulate`` (both backends) and ``simulate_batch`` (whose
table is the union over a bucket's programs) all follow that rule; the
port follows it through ``sim_step.kernel_op_ids``.

Inputs come from a numpy seed.  Tolerance: bit equality (NaNs equal) on
``mac`` and every exact op; the transcendentals on the other lanes of a
table are held to 2 ulp (tanh of the correctly rounded value, as
``tests/test_torch_entry_points.py`` holds it).  Every test asserts that
some lanes tell one rounding from two, so it can always see which one
was taken.
"""

import zlib

import numpy as np
import pytest
import torch

import repro.sim as R
import repro_torch.sim as T
import test_torch_sim as sim_tests
from repro.core import baseline_datapath as r_base, map_application as r_map
from repro.core.dse import app_ops as r_ops
from repro.fabric import FabricSpec as RSpec, place_and_route as r_pnr
from repro.graphir.graph import Graph as RGraph
from repro.kernels import sim_step as r_step
from repro_torch.core import baseline_datapath as t_base
from repro_torch.core import map_application as t_map
from repro_torch.core.dse import app_ops as t_ops
from repro_torch.fabric import FabricSpec as TSpec, place_and_route as t_pnr
from repro_torch.graphir.graph import Graph as TGraph
from repro_torch.kernels import sim_step as t_step

ALL_OPS = t_step.op_table(list(t_step.ALU_IMPLS))
OTHERS = [o for o in ALL_OPS if o not in ("nop", "mac")]


def _random_tables(n=8, seed=31):
    """``n`` tables holding ``mac``, from a seed: the even ones with
    ``mul``, the odd ones without."""
    rng = np.random.default_rng(seed)
    rest = [o for o in OTHERS if o != "mul"]
    tables = []
    for i in range(n):
        pick = rng.choice(rest, rng.integers(1, 12), replace=False)
        tables.append(t_step.op_table(
            ["mac", *pick] + (["mul"] if i % 2 == 0 else [])))
    return tables


TABLES = ([t_step.op_table(["mac", o]) for o in OTHERS]
          + [t_step.op_table(["mac"]), ALL_OPS] + _random_tables())


def _fused(a, b, c):
    return t_step._fma(*(torch.from_numpy(np.asarray(x, np.float32))
                         for x in (a, b, c))).numpy()


def _twice(a, b, c):
    with np.errstate(invalid="ignore"):
        return np.float32(a) * np.float32(b) + np.float32(c)


def _table_inputs(ops, seed, mac_lanes=4096, op_lanes=128):
    """(codes, a, b, c, active): ``mac`` on ``mac_lanes`` lanes of normal
    operands, every other op of ``ops`` on ``op_lanes`` lanes of operands
    made for it (``test_torch_sim._operands``: no subnormal operand or
    result), some nop lanes; the lanes shuffled."""
    rng = np.random.default_rng(seed)
    parts = []
    for k, op in enumerate(ops):
        if op == "mac":
            a, b, c = (rng.normal(size=mac_lanes).astype(np.float32)
                       for _ in range(3))
        else:
            a, b, c = sim_tests._operands(op, rng, n=op_lanes)
        parts.append((np.full(a.shape[0], k, np.int32), a, b, c))
    order = rng.permutation(sum(p[0].shape[0] for p in parts))
    codes, a, b, c = (np.concatenate([p[j] for p in parts])[order]
                      for j in range(4))
    active = rng.random(codes.shape[0]) < 0.8
    return codes, a, b, c, active


def _held_by_op(ops, codes, got, want, a, lanes):
    """Each op's ``lanes``: bit-equal, or a transcendental within 2 ulp,
    tanh of the correctly rounded value (XLA's CPU tanh is a rational
    approximation)."""
    for k, op in enumerate(ops):
        on = lanes & (codes == k)
        g, w = got[on], want[on]
        if op == "tanh":
            truth = np.tanh(a[on].astype(np.float64)).astype(np.float32)
            assert sim_tests._ulp(g, truth).max() <= 2
        elif op in sim_tests.TRANSCENDENTAL:
            assert sim_tests._ulp(g, w).max() <= 2, op
        else:
            assert sim_tests._bit_equal(g, w).all(), op


@pytest.mark.parametrize("ops", TABLES, ids=lambda t: "-".join(t[1:]))
def test_alu_entry_points_round_mac_as_the_reference(ops):
    codes, a, b, c, active = _table_inputs(
        ops, zlib.crc32(",".join(ops).encode()))
    mac = codes == ops.index("mac")
    fused, twice = _fused(a, b, c), _twice(a, b, c)
    tells = ~sim_tests._bit_equal(fused, twice) & mac
    assert tells.sum() > 0
    rule = twice if "mul" in ops else fused

    want_jnp = np.asarray(r_step.alu_step_jnp(codes, a, b, c, ops))
    want_pallas = np.asarray(r_step.alu_step_pallas(codes, a, b, c, ops,
                                                    interpret=True))
    want_masked = np.asarray(r_step.alu_step_masked(codes, a, b, c, ops,
                                                    active))
    got_jnp = t_step.alu_step_jnp(codes, a, b, c, ops, device="cpu").numpy()
    got_pallas = t_step.alu_step_pallas(codes, a, b, c, ops,
                                        device="cpu").numpy()
    got_masked = t_step.alu_step_masked(
        *(torch.from_numpy(x) for x in (codes, a, b, c)), ops,
        torch.from_numpy(active)).numpy()
    every = np.ones_like(active)
    for got, want, lanes in ((got_jnp, want_jnp, every),
                             (got_pallas, want_pallas, every),
                             (got_masked, want_masked, active)):
        on = mac & lanes
        assert sim_tests._bit_equal(got[on], want[on]).all()
        assert sim_tests._bit_equal(got[on], rule[on]).all()
        _held_by_op(ops, codes, got, want, a, lanes)
    assert sim_tests._bit_equal(got_masked[~active],
                                want_masked[~active]).all()
    assert (got_masked[~active] == 0.0).all()


def test_kernel_op_ids_name_the_rounding():
    """``mac`` is ``OP_MAC2`` (the kernel's id after its table's, rounded
    twice) in a table with ``mul``; the stepper's checks take that id and
    refuse the next."""
    mac, mul = t_step.OP_IDS["mac"], t_step.OP_IDS["mul"]
    assert t_step.OP_MAC2 == len(t_step.ALU_IMPLS)
    assert t_step.kernel_op_ids(("nop", "mac")) == (0, mac)
    assert t_step.kernel_op_ids(("nop", "mac", "mul")) == (
        0, t_step.OP_MAC2, mul)
    assert t_step.kernel_op_ids(ALL_OPS) == tuple(
        t_step.OP_MAC2 if o == "mac" else t_step.OP_IDS[o] for o in ALL_OPS)
    src = (sim_tests.ROOT / "src/repro_torch/kernels/csrc/sim_step.cu"
           ).read_text()
    assert "enum { OP_MAC2 = N_OPS };" in src
    assert "case OP_MAC2: return __fadd_rn(__fmul_rn(a, b), c);" in src

    progs = [p for _, (_, p), _ in _programs("bucket")]
    arrs = [x for _, _, x in _programs("bucket")]
    sig = T.sim_signature(progs[0], 64, 2)
    tables, inputs, op_ids = T.cycle.bucket_tensors(progs, arrs, sig, "cpu")
    assert op_ids.tolist() == [0, t_step.OP_MAC2, mul]
    shapes = t_step._shapes(tables)
    t_step._check_indices(tables, shapes, op_ids)
    with pytest.raises(ValueError, match="out of range"):
        t_step._check_indices(tables, shapes, op_ids + 1)


# ---------------------------------------------------------------------------
# the simulator
# ---------------------------------------------------------------------------
def _mac_graph(Graph, with_mul):
    """Outputs ``mac(x0, x1, x2)`` and, ``with_mul``, ``mul(x0, x1)``."""
    g = Graph()
    x = [g.add_node("input", name=f"x{i}") for i in range(3)]
    mac = g.add_node("mac")
    for port in range(3):
        g.add_edge(x[port], mac, port)
    g.mark_output(mac)
    if with_mul:
        mul = g.add_node("mul")
        for port in range(2):
            g.add_edge(x[port], mul, port)
        g.mark_output(mul)
    return g


def _flow(graphs, name):
    """(app, reference program, port program) of the graph ``name`` made
    by ``graphs`` ({package: Graph -> app}), on a 4x4 fabric."""
    out = []
    for Graph, base, ops_of, mp, pnr, build, Spec in (
            (RGraph, r_base, r_ops, r_map, r_pnr, R.build_sim, RSpec),
            (TGraph, t_base, t_ops, t_map, t_pnr, T.build_sim, TSpec)):
        g = graphs(Graph)
        dp = base(ops_of(g))
        m = mp(dp, g, name)
        kw = {} if Graph is RGraph else dict(device="cpu")
        p = pnr(dp, m, g, Spec(4, 4), **sim_tests.FAST, **kw)
        out.append((g, build(dp, m, g, pnr=p)[0]))
    return out


#: the columns x0, x1, x2 of every program's inputs: (B, K) = (2, 64)
_X = np.random.default_rng(0).normal(size=(2, 64, 3)).astype(np.float32)


def _programs(kind):
    """[(reference (app, prog), port (app, prog), inputs)] of a program
    set: the ``mac``-only graph, the ``mac`` + ``mul`` graph, or single-op
    ``mac`` and ``mul`` programs that share one bucket."""
    if kind == "bucket":
        flows = [(_flow(lambda G, op=op: sim_tests._single_op_graph(G, op),
                        op)) for op in ("mac", "mul")]
    else:
        flows = [_flow(lambda G: _mac_graph(G, kind == "mac_mul"), kind)]
    out = []
    for (r_app, r_prog), (t_app, t_prog) in flows:
        assert t_prog.input_names == r_prog.input_names
        x = np.ascontiguousarray(np.stack(
            [_X[:, :, int(n[1:])] for n in t_prog.input_names], -1))
        out.append(((r_app, r_prog), (t_app, t_prog), x))
    return out


@pytest.mark.parametrize("path", ["jax", "pallas", "batch"])
@pytest.mark.parametrize("kind", ["mac", "mac_mul", "bucket"])
def test_simulator_rounds_mac_as_the_reference(kind, path):
    progs = _programs(kind)
    r_progs = [p for (_, p), _, _ in progs]
    t_progs = [p for _, (_, p), _ in progs]
    xs = [x for _, _, x in progs]
    if path == "batch":
        assert len({T.sim_signature(p, 64, 2) for p in t_progs}) == 1
        want = R.simulate_batch(r_progs, xs)
        got = T.simulate_batch(t_progs, xs, device="cpu")
    else:
        want = [R.simulate(p, x, backend=path) for p, x in zip(r_progs, xs)]
        got = [T.simulate(p, x, backend=path, device="cpu")
               for p, x in zip(t_progs, xs)]
    # the table the dispatch ran: the bucket's union, or the program's own
    tables = ([set().union(*(p.ops for p in t_progs))] * len(t_progs)
              if path == "batch" else [set(p.ops) for p in t_progs])
    x0, x1, x2 = (_X[:, :, j] for j in range(3))
    fused, twice = _fused(x0, x1, x2), _twice(x0, x1, x2)
    assert (~sim_tests._bit_equal(fused, twice)).sum() > 0
    for ((r_app, rp), (t_app, tp), x), w, g, ops in zip(
            progs, want, got, tables, strict=True):
        assert g.outputs.shape == w.outputs.shape
        assert sim_tests._bit_equal(g.outputs, w.outputs).all()
        if "mac" in tp.ops:
            rule = twice if "mul" in ops else fused
            assert sim_tests._bit_equal(g.outputs[:, :, 0], rule).all()
        # the interpreter rounds mac twice: exact where the table has mul
        assert T.compare_with_interp(tp, t_app, x, g) == \
            R.compare_with_interp(rp, r_app, x, w)


def test_chip_smoke_k3_mac_check_on_the_cpu(monkeypatch, capsys):
    """``chip_smoke.k3_mac_check`` (phase 3's float-input ``mac``
    buckets) on the CPU, K3's plain version in place of its launch: the
    bucket with ``mul`` resolves ``mac`` to ``OP_MAC2``, the one without
    to ``OP_IDS["mac"]``, and neither check fails."""
    monkeypatch.syspath_prepend(str(sim_tests.ROOT))
    import chip_smoke as cs
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    cs.k3_mac_check(torch.device("cpu"))
    out = capsys.readouterr().out
    assert f"op ids [0, {t_step.OP_MAC2}, {t_step.OP_IDS['mul']}] with " \
        f"mul, [0, {t_step.OP_IDS['mac']}] alone" in out
