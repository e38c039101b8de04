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
the float64 oracle at rtol = atol = 2e-5 (5e-2 in bfloat16), the
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
    for m, k, n in ((64, 64, 64), (100, 70, 50), (256, 128, 192),
                    (1000, 333, 700), (1, 5, 129)):
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
        assert torch.allclose(got.float(), want.float(), rtol=5e-2,
                              atol=5e-2), (s, d)


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
