"""The port's tensor-level front end (``repro_torch.graphir.trace``,
``repro_torch.apps.lm``) against the JAX package's jaxpr front end on the
CPU: the same graphs by ``canonical_label()`` and op histogram, the same
ranked mining lists, and a mined LM idiom through K4's plain version.

Mining runs with no time budget (``time_budget_s=inf``): the reference
test's 15 s budget makes the lists depend on the host's load."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.apps.lm import lm_idiom_graphs as r_lm_graphs
from repro.core import MiningConfig as RMining
from repro.core import mine_and_rank as r_mine
from repro.graphir import trace_fn as r_trace
from repro_torch.apps.lm import lm_idiom_graphs
from repro_torch.core import MiningConfig, mine_and_rank
from repro_torch.core.isomorphism import find_embeddings
from repro_torch.core.merge import is_pe_pattern
from repro_torch.graphir import trace_fn
from repro_torch.graphir.graph import free_in_ports
from repro_torch.kernels import fused_pe_apply
from repro_torch.kernels.ref import ref_pe

NO_BUDGET = dict(min_support=2, max_pattern_nodes=5,
                 time_budget_s=float("inf"), max_patterns_per_level=40)

#: (nodes, compute nodes, op counts) of the JAX package's graphs
EXPECTED = {
    "lm_dense": (43, 33, {"mul": 10, "add": 4, "div": 2, "rsqrt": 2,
                          "rsum": 2, "matmul": 6, "sigmoid": 1, "tanh": 1,
                          "const": 5, "input": 9}),
    "lm_gemma": (57, 47, {"mul": 14, "add": 6, "div": 3, "pow": 1,
                          "tanh": 2, "rsqrt": 2, "rsum": 3, "matmul": 6,
                          "const": 10}),
    "lm_router": (16, None, {"rmax": 1, "top_k": 1, "exp": 1}),
    "lm_ssm": (29, None, {"neq": 1, "sel": 1, "abs": 1, "log": 1}),
}


@pytest.fixture(scope="module")
def graphs():
    return r_lm_graphs(), lm_idiom_graphs(device="cpu")


def _same_graph(a, b):
    assert a.op_histogram() == b.op_histogram()
    assert a.num_nodes() == b.num_nodes()
    assert a.canonical_label() == b.canonical_label()


def test_trace_rmsnorm_equals_jaxpr():
    """Twin of ``test_graphir.py::test_jaxpr_trace_rmsnorm``."""
    def rms(x, w):
        v = torch.mean(x * x, dim=-1, keepdim=True)
        return x * (1.0 / torch.sqrt(v + 1e-6)) * w

    def r_rms(x, w):
        v = jnp.mean(x * x, axis=-1, keepdims=True)
        return x * (1.0 / jnp.sqrt(v + 1e-6)) * w
    g = trace_fn(rms, torch.ones(4, 8), torch.ones(8))
    hist = g.op_histogram()
    assert hist.get("mul", 0) >= 3
    assert hist.get("rsum", 0) == 1
    assert "sqrt" in hist
    _same_graph(g, r_trace(r_rms, jnp.ones((4, 8)), jnp.ones((8,))))


def test_trace_silu_decomposes_like_custom_jvp():
    """Twin of ``test_graphir.py::test_jaxpr_trace_inlines_custom_jvp``."""
    g = trace_fn(F.silu, torch.ones(4))
    assert "sigmoid" in g.op_histogram()
    assert "opaque" not in g.op_histogram()
    _same_graph(g, r_trace(jax.nn.silu, jnp.ones((4,))))


# each ATen op the tracer decomposes, and its jaxpr twin
DECOMPOSED = {
    "mean": (lambda x: torch.mean(x, -1, keepdim=True),
             lambda x: jnp.mean(x, -1, keepdims=True)),
    "mean_all": (torch.mean, jnp.mean),
    "silu": (F.silu, jax.nn.silu),
    "gelu_tanh": (lambda x: F.gelu(x, approximate="tanh"),
                  lambda x: jax.nn.gelu(x, approximate=True)),
    "softmax": (lambda x: torch.softmax(x, -1),
                lambda x: jax.nn.softmax(x, -1)),
    "softplus": (F.softplus, jax.nn.softplus),
    "scalar_over": (lambda x: 2.0 / x, lambda x: 2.0 / x),
    "where_rsub": (lambda x: torch.where(x > 0, x, 1.0 - x),
                   lambda x: jnp.where(x > 0, x, 1.0 - x)),
    "cube_and_pow": (lambda x: x ** 3 + x ** 2.5,
                     lambda x: x ** 3 + x ** 2.5),
    "topk": (lambda x: torch.topk(x, 2)[0].sum(-1),
             lambda x: jax.lax.top_k(x, 2)[0].sum(-1)),
}


@pytest.mark.parametrize("name", sorted(DECOMPOSED))
def test_decomposed_ops_equal_jaxpr(name):
    fn, r_fn = DECOMPOSED[name]
    g = trace_fn(fn, torch.ones(2, 8))
    assert "opaque" not in g.op_histogram()
    _same_graph(g, r_trace(r_fn, jnp.ones((2, 8))))


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_lm_idiom_graph_equals_reference(graphs, name):
    want, got = graphs[0][name], graphs[1][name]
    _same_graph(got, want)
    nodes, compute, ops = EXPECTED[name]
    assert got.num_nodes() == nodes
    if compute is not None:
        assert got.num_compute_nodes() == compute
    hist = got.op_histogram()
    assert {k: hist.get(k, 0) for k in ops} == ops
    assert "opaque" not in hist
    # node ids and their ops too: the traced order is the jaxpr's
    assert got.nodes == want.nodes
    assert [got.attr(n, "value") for n in got.nodes] == \
        [want.attr(n, "value") for n in want.nodes]


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_ranked_mining_equals_reference(graphs, name):
    want = r_mine(graphs[0][name], RMining(**NO_BUDGET))
    got = mine_and_rank(graphs[1][name], MiningConfig(**NO_BUDGET))
    key = lambda ms: [(m.label, m.occurrences, m.mni, m.mis_size)
                      for m in ms]
    assert key(got) == key(want)
    if name in ("lm_dense", "lm_gemma", "lm_ssm"):
        assert got


def _valued(pattern, graph):
    """``pattern`` with each mined constant given its value at the
    pattern's first occurrence in ``graph`` (a mined pattern carries no
    constant values, and K4 bakes a missing one as 0.0, which can make an
    idiom's output inf or nan everywhere)."""
    emb = find_embeddings(pattern, graph, max_embeddings=1)
    assert emb
    p = pattern.copy()
    for n, op in p.nodes.items():
        if op == "const":
            p.attrs.setdefault(n, {})["value"] = graph.attr(
                emb[0].mapping[n], "value")
    return p


@pytest.mark.parametrize("name", ["lm_dense", "lm_gemma", "lm_ssm"])
def test_mined_idiom_through_k4_plain_equals_ref_pe(graphs, name):
    ranked = [m for m in mine_and_rank(graphs[1][name],
                                       MiningConfig(**NO_BUDGET))
              if is_pe_pattern(m.pattern)]
    assert ranked
    rng = np.random.default_rng(0)
    for m in ranked[:5]:
        pat = _valued(m.pattern, graphs[1][name])
        xs = [rng.uniform(0.1, 1.0, (16, 32)).astype(np.float32)
              for _ in free_in_ports(pat)]
        got = fused_pe_apply(pat, *[torch.from_numpy(x) for x in xs],
                             device="cpu")
        exp = ref_pe(pat, *xs)
        gots = got if isinstance(got, tuple) else (got,)
        exps = exp if isinstance(exp, tuple) else (exp,)
        for g_, e_ in zip(gots, exps):
            # finite everywhere, so that the comparison holds a value
            assert np.isfinite(e_).all(), m.label
            np.testing.assert_allclose(np.asarray(g_, np.float64), e_,
                                       rtol=1e-5, atol=1e-6,
                                       equal_nan=False)


def test_strict_raises_on_unmapped_op():
    fn = lambda x: torch.lgamma(x) + 1.0
    g = trace_fn(fn, torch.ones(4))
    assert g.op_histogram()["opaque"] == 1
    with pytest.raises(NotImplementedError, match="lgamma"):
        trace_fn(fn, torch.ones(4), strict=True)


def test_idiom_graphs_need_a_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lm_idiom_graphs()
