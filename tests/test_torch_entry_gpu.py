"""The JAX package's kernel entry points in the port, on the card, against
their plain versions on the card: ``hpwl_pallas`` and ``hpwl_batched``
(one zero-step launch of K2, ``anneal_kernel``), ``hpwl_delta_pallas``
(``swap_delta_kernel``: K2's ``row_cost`` over the touched nets) and
``alu_step_pallas`` (``alu_step_kernel``: K3's ALU dispatch).

Run on a machine with an NVIDIA Hopper card:
``PYTHONPATH=src python -m pytest -m gpu tests/test_torch_entry_gpu.py``.
Each test skips with a reason when there is no card; the file imports no
JAX (``tests/test_torch_entry_points.py`` holds the plain versions to the
JAX package on the CPU).

Tolerance: bit equality.  Coordinates are integers, so every HPWL, total
and delta is exact in any summation order; the ALU ops are bit-equal
(NaNs equal) on operands and results that are not subnormal, the
transcendentals (exp, log, tanh, sigmoid, rsqrt, pow) within 2 ulp.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import pnr_cost, sim_step

TRANSCENDENTAL = ("exp", "log", "tanh", "sigmoid", "rsqrt", "pow")
ALL_OPS = sim_step.op_table(list(sim_step.ALU_IMPLS))

pytestmark = pytest.mark.gpu


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (none on this host)")


def _placements(seed, c, e, n, d, grid=64):
    """C placements (C, E, 2) on integer coordinates and nets (N, D), some
    masked pins, pinless nets and repeated pins."""
    rng = np.random.default_rng(seed)
    pos = rng.integers(0, grid, size=(c, e, 2)).astype(np.float32)
    pins = rng.integers(0, e, size=(n, d)).astype(np.int32)
    mask = rng.random((n, d)) < rng.uniform(0.1, 1.0, (n, 1))
    mask[rng.integers(0, n, size=3)] = False
    return (torch.from_numpy(x).cuda() for x in (pos, pins, mask))


@pytest.mark.parametrize("c, e, n, d", [(1, 40, 30, 5), (16, 200, 150, 12),
                                        (256, 96, 120, 3),
                                        (3, 40000, 9000, 9)])
def test_hpwl_entry_points_equal_plain(c, e, n, d):
    """Per-net costs and totals of K2's zero-step launch equal the plain
    version's, with the tables staged, not staged and the chain state in
    global memory (E = 40,000); one launch a call."""
    _need_card()
    pos, pins, mask = _placements(c + e, c, e, n, d)
    per_net, total = pnr_cost._rows_k2(pos, pins, mask)
    want_net, want_total = pnr_cost._rows_plain(pos, pins, mask)
    assert torch.equal(per_net, want_net) and torch.equal(total, want_total)
    before = pnr_cost.hpwl_batched.launches
    got = pnr_cost.hpwl_batched(pos, pins, mask)
    assert pnr_cost.hpwl_batched.launches == before + 1
    assert torch.equal(got, want_total)
    before = pnr_cost.hpwl_pallas.launches
    one = pnr_cost.hpwl_pallas(pos[0], pins, mask)
    assert pnr_cost.hpwl_pallas.launches == before + 1
    assert one.shape == () and float(one) == float(want_total[0])


@pytest.mark.parametrize("seed", range(4))
def test_hpwl_delta_pallas_equals_plain(seed):
    """Touched lists shorter and longer than a warp, with duplicates and
    padding, any per-net costs, and a swap of an entity with itself."""
    _need_card()
    rng = np.random.default_rng(seed)
    pos, pins, mask = _placements(seed, 1, 300, 200, 10)
    slot_xy = pos[0]
    slot_of = torch.from_numpy(rng.permutation(300).astype(np.int32)).cuda()
    t = (5, 32, 77, 200)[seed]
    touched = torch.from_numpy(rng.integers(0, 201, t).astype(np.int32)).cuda()
    costs = torch.from_numpy(
        rng.integers(0, 90, 200).astype(np.float32)).cuda()
    a, b = (int(v) for v in rng.choice(300, 2, replace=False))
    if seed == 3:
        b = a
    before = pnr_cost.hpwl_delta_pallas.launches
    new, delta = pnr_cost.hpwl_delta_pallas(slot_xy, slot_of, pins, mask,
                                            costs, touched, a, b)
    assert pnr_cost.hpwl_delta_pallas.launches == before + 1
    want_new, want_delta = pnr_cost.hpwl_delta_pallas_plain(
        slot_xy, slot_of, pins, mask, costs, touched, a, b)
    assert torch.equal(new, want_new) and torch.equal(delta, want_delta)


def test_hpwl_delta_pallas_refuses_negative_ids():
    """A negative net id in ``touched`` is refused before any launch."""
    _need_card()
    pos, pins, mask = _placements(9, 1, 50, 40, 6)
    slot_of = torch.arange(50, dtype=torch.int32, device="cuda")
    touched = torch.tensor([0, -1, 40], dtype=torch.int32, device="cuda")
    before = pnr_cost.hpwl_delta_pallas.launches
    with pytest.raises(ValueError, match="touched"):
        pnr_cost.hpwl_delta_pallas(pos[0], slot_of, pins, mask,
                                   torch.zeros(40, device="cuda"), touched,
                                   1, 2)
    assert pnr_cost.hpwl_delta_pallas.launches == before


def test_anneal_chains_xy_chain_equals_plain():
    """K2 with each chain its own slot coordinates, over steps (delta
    scoring, telemetry), equals its plain version on the card."""
    _need_card()
    rng = np.random.default_rng(11)
    r, e, n, d, k, s = 8, 120, 90, 6, 8, 256
    pos, pins, mask = _placements(11, r, e, n, d)
    p_np, m_np = pins.cpu().numpy(), mask.cpu().numpy()
    ent_nets = np.full((1, e, k), n, np.int32)
    for i in range(e):
        on = sorted({j for j in range(n) if (p_np[j][m_np[j]] == i).any()})
        ent_nets[0, i, :len(on[:k])] = on[:k]
    cuda = lambda x: torch.from_numpy(x).cuda()
    args = (torch.zeros(r, dtype=torch.int32, device="cuda"), pos,
            pins[None].contiguous(), mask[None].contiguous(), cuda(ent_nets),
            cuda(rng.uniform(0.5, 4, (1, s)).astype(np.float32)),
            torch.ones((1, s), dtype=torch.bool, device="cuda"),
            cuda(rng.integers(0, e, (r, s)).astype(np.int32)),
            cuda(rng.integers(0, e, (r, s)).astype(np.int32)),
            cuda(np.log(rng.random((r, s))).astype(np.float32)),
            cuda(np.stack([rng.permutation(e) for _ in range(r)])
                 .astype(np.int32)))
    got = pnr_cost.anneal_chains(*args, telemetry=True, xy_chain=True)
    want = pnr_cost.anneal_chains_plain(*args, telemetry=True, xy_chain=True)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _bits(x):
    x = x.contiguous()
    return torch.where(torch.isnan(x), torch.full_like(x, float("nan")),
                       x).view(torch.int32)


def _ulp(a, b):
    def ordered(x):
        i = x.view(torch.int32).long()
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)
    d = (ordered(a) - ordered(b)).abs()
    return torch.where(torch.isnan(a) & torch.isnan(b), 0, d)


@pytest.mark.parametrize("shared", [True, False])
def test_alu_step_pallas_equals_plain(shared):
    """Every op of the whole table on (rows, lanes) operands: normal
    values, small integers, ±0, ±inf and NaN; codes shared by the rows or
    one a lane, some outside the table (0.0)."""
    _need_card()
    rng = np.random.default_rng(int(shared))
    rows, n = 6, 4096
    mag = np.exp(rng.uniform(np.log(1e-3), np.log(1e3), (3, rows, n)))
    a, b, c = (mag * rng.choice([-1.0, 1.0], (3, rows, n))).astype(
        np.float32)
    b[:, : n // 4] = rng.integers(-20, 21, (rows, n // 4))
    special = np.float32([0.0, -0.0, np.inf, -np.inf, np.nan, 1.0, -1.0])
    for x in (a, b, c):
        x[rng.random(x.shape) < 0.05] = rng.choice(special)
    shape = (n,) if shared else (rows, n)
    codes = rng.integers(-1, len(ALL_OPS) + 2, shape).astype(np.int32)
    t = [torch.from_numpy(x).cuda() for x in (codes, a, b, c)]
    before = sim_step.alu_step_pallas.launches
    got = sim_step.alu_step_pallas(*t, ALL_OPS)
    assert sim_step.alu_step_pallas.launches == before + 1
    want = sim_step.alu_step_plain(*t, ALL_OPS)
    tiny = float(torch.finfo(torch.float32).tiny)
    normal = ~((want.abs() < tiny) & (want != 0))
    code = torch.broadcast_to(t[0], got.shape)
    for k, op in enumerate(ALL_OPS):
        lanes = (code == k) & normal
        if op in TRANSCENDENTAL:
            assert int(_ulp(got[lanes], want[lanes]).max()) <= 2, op
        else:
            assert torch.equal(_bits(got[lanes]), _bits(want[lanes])), op
    out = (code < 0) | (code >= len(ALL_OPS))
    assert bool((got[out] == 0).all())
    jnp = sim_step.alu_step_jnp(*t, ALL_OPS)
    assert torch.equal(_bits(jnp), _bits(sim_step.alu_step_plain(
        torch.clamp(t[0], 0, len(ALL_OPS) - 1), *t[1:], ALL_OPS)))


@pytest.mark.parametrize("with_mul", [False, True])
def test_alu_step_kernel_mac_rounds_by_the_table(with_mul):
    """``mac`` on normal float operands under the whole table without and
    with ``mul``: the kernel == its plain version bit for bit, one FMA
    without ``mul`` and the product rounded first with it, on lanes where
    the two differ."""
    _need_card()
    ops = ALL_OPS if with_mul else tuple(o for o in ALL_OPS if o != "mul")
    rng = np.random.default_rng(5)
    rows, n = 4, 4096
    a, b, c = (torch.from_numpy(rng.normal(size=(rows, n)).astype(
        np.float32)).cuda() for _ in range(3))
    codes = torch.from_numpy(np.where(
        rng.random(n) < 0.9, ops.index("mac"),
        rng.integers(0, len(ops), n)).astype(np.int32)).cuda()
    before = sim_step.alu_step_pallas.launches
    got = sim_step.alu_step_pallas(codes, a, b, c, ops)
    assert sim_step.alu_step_pallas.launches == before + 1
    want = sim_step.alu_step_plain(codes, a, b, c, ops)
    mac = torch.broadcast_to(codes == ops.index("mac"), got.shape)
    assert torch.equal(_bits(got[mac]), _bits(want[mac]))
    fused, twice = sim_step._fma(a, b, c), a * b + c
    assert not torch.equal(_bits(fused[mac]), _bits(twice[mac]))
    rule = twice if with_mul else fused
    assert torch.equal(_bits(got[mac]), _bits(rule[mac]))
