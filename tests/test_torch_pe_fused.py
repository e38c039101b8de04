"""The port's fused-PE path (K4's plain version, ``device="cpu"``)
against the JAX package's Pallas kernel run in interpret mode, on the same
seeded numpy inputs: the reference test's PE patterns, every op of
``_JNP_SEMANTICS`` alone, patterns that mix booleans into arithmetic, the
ML suite's mined and merged configurations, ``kernel_from_config``, the
errors, and the Triton rendering's shape.

Tolerance: rtol = atol = 1e-5 for float32 and 5e-2 for bfloat16 (the
reference tests' own, ``tests/test_kernels.py``), NaNs equal to NaNs.
The port computes bfloat16 inputs in float32 and rounds once; JAX
promotes per op.
"""

import ast
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import MiningConfig as RMining
from repro.core.merge import baseline_datapath as r_base
from repro.core.merge import merge_subgraphs as r_merge
from repro.explore import ExploreConfig as RConfig, Explorer as RExplorer
from repro.apps import ml_graphs as r_ml_graphs
from repro.graphir import pattern_from_spec as r_spec
from repro.graphir.ops import OPS
from repro.kernels import fused_pe_apply as r_apply
from repro.kernels import kernel_from_config as r_from_config
from repro.kernels.pe_fused import _JNP_SEMANTICS
from repro_torch.core.merge import baseline_datapath as t_base
from repro_torch.core.merge import merge_subgraphs as t_merge
from repro_torch.graphir import pattern_from_spec as t_spec
from repro_torch.graphir.graph import Graph as TGraph, free_in_ports
from repro_torch.graphir.graph import sink_nodes
from repro_torch.kernels import (fused_pe_apply as t_apply,
                                 kernel_from_config as t_from_config,
                                 make_pe_kernel)
from repro_torch.kernels.pe_fused import (_TORCH_SEMANTICS, lower_pattern,
                                          pe_apply_plain, torch_source,
                                          triton_source)
from repro_torch.kernels.ref import ref_pe as t_ref_pe

# tests/test_kernels.py's patterns
PE_SPECS = {
    "muladd": [("mul", (-1, -1)), ("add", (0, -1))],
    "conv_relu": [("mul", (-1, -1)), ("add", (0, -1)), ("const", ()),
                  ("max", (1, 2))],
    "harris_resp": [("mul", (-1, -1)), ("mul", (-1, -1)), ("sub", (0, 1)),
                    ("abs", (2,))],
    "swiglu_core": [("sigmoid", (-1,)), ("mul", (0, -1)), ("mul", (1, -1))],
}

# booleans flowing into arithmetic, each lowered the way JAX types it
BOOL_SPECS = {
    "add_of_bools": [("lt", (-1, -1)), ("gt", (-1, -1)), ("add", (0, 1))],
    "mul_of_bools": [("lt", (-1, -1)), ("gte", (-1, -1)), ("mul", (0, 1))],
    "max_min_of_bools": [("lt", (-1, -1)), ("eq", (-1, -1)),
                         ("max", (0, 1)), ("min", (0, 1))],
    "bool_plus_float": [("lt", (-1, -1)), ("add", (0, -1))],
    "abs_floor_of_bool": [("neq", (-1, -1)), ("abs", (0,)), ("floor", (1,))],
    "mac_of_bools": [("lt", (-1, -1)), ("gt", (-1, -1)), ("lte", (-1, -1)),
                     ("mac", (0, 1, 2))],
    "sel_bool_branches": [("lt", (-1, -1)), ("gt", (-1, -1)),
                          ("sel", (-1, 0, 1))],
    "sel_mixed_branches": [("lt", (-1, -1)), ("sel", (0, 0, -1))],
    "logic_of_floats": [("and", (-1, -1)), ("or", (-1, -1)),
                        ("xor", (0, 1)), ("not", (2,))],
    "div_exp_of_bools": [("lt", (-1, -1)), ("gt", (-1, -1)),
                         ("div", (0, 1)), ("exp", (0,))],
    "shl_pow_of_bools": [("lt", (-1, -1)), ("gt", (-1, -1)),
                         ("shl", (0, 1)), ("pow", (0, 1))],
    "cmp_of_bools": [("lt", (-1, -1)), ("gt", (-1, -1)), ("lt", (0, 1)),
                     ("eq", (0, 1))],
}
# JAX refuses these booleans when it traces the kernel
BOOL_ERRORS = {
    "sub_of_bools": ([("lt", (-1, -1)), ("gt", (-1, -1)), ("sub", (0, 1))],
                     TypeError),
    "neg_of_bool": ([("lt", (-1, -1)), ("neg", (0,))], TypeError),
    "shr_by_bool": ([("lt", (-1, -1)), ("shr", (-1, 0))], TypeError),
    "round_of_bool": ([("lt", (-1, -1)), ("round", (0,))], ValueError),
}

# negatives, zeros of both signs, exact halves, infinities and NaN
SPECIAL = np.array([-2.5, -1.5, -1.0, -0.5, -0.0, 0.0, 0.5, 1.0, 1.5, 2.5,
                    3.0, 0.25, 7.0, np.nan, np.inf, -np.inf], np.float32)


def _pair(rspec):
    return r_spec(rspec), t_spec(rspec)


def _inputs(n_in, shape, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return [rng.uniform(-1.5, 1.5, shape).astype(dtype)
            for _ in range(n_in)]


def _jax(pat, xs, dtype=jnp.float32, block=(64, 128)):
    got = r_apply(pat, *[jnp.asarray(x, dtype) for x in xs], block=block,
                  interpret=True)
    return [np.asarray(o, np.float64)
            for o in (got if isinstance(got, tuple) else (got,))]


def _port(pat, xs, dtype=torch.float32):
    got = t_apply(pat, *[torch.as_tensor(x).to(dtype) for x in xs],
                  device="cpu")
    outs = got if isinstance(got, tuple) else (got,)
    for o in outs:
        assert o.dtype == dtype and o.device.type == "cpu"
    return [o.to(torch.float64).numpy() for o in outs]


def _close(got, want, tol):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.broadcast_to(w, g.shape),
                                   rtol=tol, atol=tol, equal_nan=True)


@pytest.mark.parametrize("name", sorted(PE_SPECS))
@pytest.mark.parametrize("shape", [(16, 16), (33, 77), (128, 256)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pe_patterns_match_reference(name, shape, dtype):
    rpat, tpat = _pair(PE_SPECS[name])
    xs = _inputs(len(free_in_ports(tpat)), shape, seed=sum(shape))
    tol = 1e-5 if dtype == "float32" else 5e-2
    got = _port(tpat, xs, getattr(torch, dtype))
    _close(got, _jax(rpat, xs, getattr(jnp, dtype)), tol)
    # and the port's own float64 oracle, as the reference test does
    want = t_ref_pe(tpat, *[torch.as_tensor(x).to(getattr(torch, dtype))
                            for x in xs])
    _close(got, want if isinstance(want, tuple) else (want,), tol)


def test_semantics_table_has_the_reference_ops_in_order():
    assert list(_TORCH_SEMANTICS) == list(_JNP_SEMANTICS)
    assert len(_TORCH_SEMANTICS) == 35


@pytest.mark.parametrize("op", list(_JNP_SEMANTICS))
def test_single_op_matches_reference(op):
    arity = OPS[op].arity
    rpat, tpat = _pair([(op, (-1,) * arity)])
    n = SPECIAL.size
    # every pair of special values, the third operand random
    a = np.repeat(SPECIAL, n).reshape(n, n)
    b = np.tile(SPECIAL, n).reshape(n, n)
    c = np.random.default_rng(7).choice(SPECIAL, (n, n)).astype(np.float32)
    xs = [a, b, c][:arity]
    _close(_port(tpat, xs), _jax(rpat, xs, block=(8, 128)), 1e-5)


@pytest.mark.parametrize("name", sorted(BOOL_SPECS))
def test_booleans_in_arithmetic_match_reference(name):
    rpat, tpat = _pair(BOOL_SPECS[name])
    n_in = len(free_in_ports(tpat))
    rng = np.random.default_rng(len(name))
    # small integers: comparisons come out both ways and ties happen
    xs = [rng.integers(-2, 3, (16, 24)).astype(np.float32)
          for _ in range(n_in)]
    _close(_port(tpat, xs), _jax(rpat, xs, block=(8, 128)), 1e-5)


@pytest.mark.parametrize("name", sorted(BOOL_ERRORS))
def test_booleans_refused_like_reference(name):
    spec, exc = BOOL_ERRORS[name]
    rpat, tpat = _pair(spec)
    xs = _inputs(len(free_in_ports(tpat)), (8, 8), seed=1)
    with pytest.raises(exc):
        _jax(rpat, xs, block=(8, 128))
    fn = make_pe_kernel(tpat, device="cpu")     # refused when called
    with pytest.raises(exc):
        fn(*xs)


def _ml_configs():
    """Every configuration of the ML suite's merged PEs (PE_ML and the
    per-app variants), mined once by the JAX package with the Fig. 11
    benchmark's settings and a budget far above what mining needs, and
    carried across as ``to_dict`` blobs."""
    mining = RMining(min_support=4, max_pattern_nodes=8, time_budget_s=600,
                     max_patterns_per_level=60)
    ex = RExplorer(r_ml_graphs(), RConfig(mode="domain", mining=mining,
                                          per_app_subgraphs=2,
                                          domain_name="PE_ML"))
    runs = [ex.run(), ex.with_config(mode="per_app", max_merge=3).run()]
    out = []
    for res in runs:
        for dse in res.results.values():
            for v in dse.variants:
                for name, cfg in sorted(v.datapath.configs.items()):
                    out.append((f"{v.name}/{name}", cfg.pattern))
    return out


def test_ml_suite_configurations_match_reference():
    configs = _ml_configs()
    assert len(configs) > 50
    distinct = {}
    for name, rpat in configs:
        blob = json.dumps(rpat.to_dict(), sort_keys=True)
        distinct.setdefault(blob, (name, rpat))
    assert len(distinct) >= 8
    refused = 0
    for k, (blob, (name, rpat)) in enumerate(sorted(distinct.items())):
        tpat = TGraph.from_dict(json.loads(blob))
        try:
            n_in = len(free_in_ports(tpat))
            xs = _inputs(n_in, (33, 77), seed=k)
            want = _jax(rpat, xs)
        except ValueError as e:
            refused += 1
            with pytest.raises(ValueError, match=str(e)):
                make_pe_kernel(tpat, device="cpu")
            continue
        _close(_port(tpat, xs), want, 1e-5)
    assert refused < len(distinct)


def test_kernel_from_config_on_merged_datapath():
    specs = [("sg:muladd", PE_SPECS["muladd"]),
             ("sg:conv_relu", PE_SPECS["conv_relu"]),
             ("sg:harris", PE_SPECS["harris_resp"])]
    ops = {"mul", "add", "max", "sub", "abs"}
    rdp = r_merge([(n, r_spec(s)) for n, s in specs], base=r_base(ops))
    tdp = t_merge([(n, t_spec(s)) for n, s in specs], base=t_base(ops))
    assert sorted(rdp.configs) == sorted(tdp.configs)
    for k, name in enumerate(sorted(tdp.configs)):
        n_in = len(free_in_ports(tdp.configs[name].pattern))
        xs = _inputs(n_in, (16, 40), seed=100 + k)
        want = r_from_config(rdp, name, block=(8, 128), interpret=True)(
            *[jnp.asarray(x) for x in xs])
        got = t_from_config(tdp, name, device="cpu")(*xs)
        want = want if isinstance(want, tuple) else (want,)
        got = got if isinstance(got, tuple) else (got,)
        _close([g.numpy() for g in got], [np.asarray(w) for w in want],
               1e-5)


def test_errors_match_reference():
    no_port = [("const", ())]
    with pytest.raises(ValueError, match="no free in-ports"):
        r_apply(r_spec(no_port), interpret=True)
    with pytest.raises(ValueError, match="no free in-ports"):
        make_pe_kernel(t_spec(no_port), device="cpu")
    bad = [("add", (-1, -1)), ("output", (0,))]
    with pytest.raises(ValueError, match="not supported"):
        r_apply(r_spec(bad), np.zeros((8, 8), np.float32),
                np.zeros((8, 8), np.float32), interpret=True)
    with pytest.raises(ValueError, match="not supported"):
        make_pe_kernel(t_spec(bad), device="cpu")
    rpat, tpat = _pair(PE_SPECS["muladd"])
    x = np.zeros((8, 8), np.float32)
    with pytest.raises(TypeError, match="expected 3 inputs, got 2"):
        r_apply(rpat, x, x, interpret=True)
    with pytest.raises(TypeError, match="expected 3 inputs, got 2"):
        make_pe_kernel(tpat, device="cpu")(x, x)


def test_constants_baked_as_float32():
    # 0.1 is not a float32: both packages round the baked constant once
    spec = [("add", (-1, -1)), ("const", ()), ("mul", (0, 1))]
    rpat, tpat = _pair(spec)
    for g in (rpat, tpat):
        g.attrs[1]["value"] = 0.1
    xs = _inputs(2, (8, 16), seed=3)
    got = _port(tpat, xs)
    _close(got, _jax(rpat, xs, block=(8, 128)), 1e-7)
    assert "0x1.99999a0000000p-4" in torch_source(lower_pattern(tpat))


def _renderings():
    specs = dict(PE_SPECS, **BOOL_SPECS)
    specs.update({f"op_{op}": [(op, (-1,) * OPS[op].arity)]
                  for op in _JNP_SEMANTICS})
    inf = [("add", (-1, -1)), ("const", ()), ("min", (0, 1))]
    specs["inf_const"] = inf
    out = {name: t_spec(s) for name, s in specs.items()}
    out["inf_const"].attrs[1]["value"] = float("inf")
    return out


def test_triton_rendering_parses_with_one_pointer_per_port_and_sink():
    for name, pat in _renderings().items():
        prog = lower_pattern(pat)
        src = triton_source(prog)
        tree = ast.parse(src)
        (fn,) = [n for n in tree.body if isinstance(n, ast.FunctionDef)]
        assert fn.name == "pe_kernel", name
        assert [ast.unparse(d) for d in fn.decorator_list] == ["triton.jit"]
        n_in = len(free_in_ports(pat))
        n_out = len(sink_nodes(pat))
        assert [a.arg for a in fn.args.args] == (
            [f"in{i}" for i in range(n_in)]
            + [f"out{j}" for j in range(n_out)] + ["n", "BLOCK"]), name
        loads = [c for c in ast.walk(fn) if isinstance(c, ast.Call)
                 and ast.unparse(c.func) == "tl.load"]
        stores = [c for c in ast.walk(fn) if isinstance(c, ast.Call)
                  and ast.unparse(c.func) == "tl.store"]
        assert len(loads) == n_in and len(stores) == n_out, name
        # only Triton's language, libdevice and dtype conversions
        for c in ast.walk(fn):
            if isinstance(c, ast.Call):
                f = ast.unparse(c.func)
                assert f.startswith(("tl.", "libdevice.")) or \
                    f.endswith(".to"), (name, f)
        ast.parse(torch_source(prog))


def test_inf_constant_rendered_by_its_bits():
    prog = lower_pattern(_renderings()["inf_const"])
    assert "2139095040" in triton_source(prog)
    x = torch.tensor([[1.0, -2.0, float("nan")]])
    got = pe_apply_plain(prog, x, x)
    np.testing.assert_array_equal(got.numpy(), [[2.0, -4.0, np.nan]])


@pytest.mark.parametrize("block", [(64, 128), (8, 128), [256, 256], 256])
def test_reference_block_keyword_changes_no_result(block):
    # the reference's block=(bm, bn) tile is accepted as a tiling hint
    from repro_torch.kernels.pe_fused import DEFAULT_BLOCK, block_size
    rpat, tpat = _pair(PE_SPECS["conv_relu"])
    xs = _inputs(len(free_in_ports(tpat)), (33, 77), seed=1)
    want = t_apply(tpat, *xs, device="cpu")
    assert torch.equal(t_apply(tpat, *xs, block=block, device="cpu"), want)
    assert torch.equal(make_pe_kernel(tpat, block=block, device="cpu")(*xs),
                       want)
    dp = t_base({"add", "mul"})
    got = t_from_config(dp, "op:mul", block=block, device="cpu")(*xs[:2])
    assert torch.equal(got, t_from_config(dp, "op:mul", device="cpu")(
        *xs[:2]))
    assert block_size(block) == (block if isinstance(block, int)
                                 else DEFAULT_BLOCK)
    _close([want.numpy()], _jax(rpat, xs, block=(64, 128)), 1e-5)


@pytest.mark.parametrize("block", [(64,), (0, 128), (64, 128, 2)])
def test_bad_block_tuples_refused(block):
    _, tpat = _pair(PE_SPECS["muladd"])
    with pytest.raises(ValueError, match="block must be"):
        make_pe_kernel(tpat, block=block, device="cpu")
