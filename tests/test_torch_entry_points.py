"""The JAX package's remaining kernel entry points in the port, against
the JAX package on the CPU on inputs made from a seed with numpy:
``pnr_cost.hpwl_pallas`` (the reference's Pallas kernel in interpret
mode), ``hpwl_batched``, ``hpwl_delta_pallas`` (interpret mode),
``sim_step.alu_step_jnp`` and ``alu_step_pallas`` (interpret mode), and
``tiling.round_up`` / ``pad2d``.  On the CPU each entry point takes its
kernel's plain version (``device="cpu"``); ``tests/test_torch_entry_gpu.py``
holds the card's launches against those.

Tolerance: bit equality.  The placements' coordinates are integers, so
every per-net HPWL, total and delta is exact in any summation order.  The
ALU ops are bit-equal (NaNs equal) on operands and results that are not
subnormal (XLA's CPU backend flushes them; the port keeps them); the
transcendentals (exp, log, tanh, sigmoid, rsqrt, pow) are held to 2 ulp,
tanh of the correctly rounded value (XLA's CPU tanh is a rational
approximation).  ``mac`` is one FMA where XLA contracts it, in a table
with no ``mul``, and rounds its product first in a table with ``mul``
(the product shared with ``mul``'s branch), in the reference's jitted
step and its Pallas step in interpret mode alike; the port follows that
rule (:func:`test_mac_is_one_fma`, ``tests/test_torch_mac_rounding.py``).
"""

import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_sim as sim_tests
from repro.kernels import pnr_cost as ref
from repro.kernels import sim_step as r_step
from repro.kernels import tiling as r_tiling
from repro_torch.kernels import pnr_cost as port
from repro_torch.kernels import sim_step as t_step
from repro_torch.kernels import tiling as t_tiling

ALL_OPS = t_step.op_table(list(t_step.ALU_IMPLS))


def _placement(seed, e=48, n=40, d=12, grid=16):
    """Entity positions on integer slots of a grid, nets of up to ``d``
    pins (more than the 7 K2 loads with its row's header) with some pins
    masked, some nets pinless and some pins repeated."""
    rng = np.random.default_rng(seed)
    pos = rng.integers(0, grid, size=(e, 2)).astype(np.float32)
    pins = rng.integers(0, e, size=(n, d)).astype(np.int32)
    mask = rng.random((n, d)) < rng.uniform(0.2, 0.9, (n, 1))
    mask[rng.integers(0, n, size=3)] = False
    if d > 1:
        pins[0, 1] = pins[0, 0]
    return pos, pins, mask


@pytest.mark.parametrize("seed", range(4))
def test_hpwl_pallas_equals_reference(seed):
    pos, pins, mask = _placement(seed, d=1 + 4 * seed)
    want = ref.hpwl_pallas(jnp.asarray(pos), jnp.asarray(pins),
                           jnp.asarray(mask), interpret=True)
    got = port.hpwl_pallas(pos, pins, mask, device="cpu")
    assert got.shape == () and got.dtype == torch.float32
    assert float(got) == float(want) == port.hpwl_reference(pos, pins, mask)
    # the reference's keyword changes no result
    assert float(port.hpwl_pallas(pos, pins, mask, interpret=False,
                                  device="cpu")) == float(got)
    per_net, total = port._rows_plain(torch.from_numpy(pos)[None],
                                      torch.from_numpy(pins),
                                      torch.from_numpy(mask))
    assert (per_net[0].numpy() == np.asarray(ref.net_hpwl(
        jnp.asarray(pos), jnp.asarray(pins), jnp.asarray(mask)))).all()
    assert float(total[0]) == float(got)


@pytest.mark.parametrize("seed", range(3))
def test_hpwl_batched_equals_reference(seed):
    """C placements of one problem, each a permutation of its slots as
    ``benchmarks/pnr_bench.py`` makes them."""
    slot_xy, pins, mask = _placement(seed)
    rng = np.random.default_rng(10 + seed)
    pos = slot_xy[np.stack([rng.permutation(slot_xy.shape[0])
                            for _ in range(16)])]
    want = np.asarray(ref.hpwl_batched(jnp.asarray(pos), jnp.asarray(pins),
                                       jnp.asarray(mask)))
    got = port.hpwl_batched(pos, pins, mask, device="cpu")
    assert got.shape == (16,) and got.dtype == torch.float32
    assert (got.numpy() == want).all()
    for c in range(16):
        assert float(got[c]) == float(port.hpwl_pallas(
            pos[c], pins, mask, device="cpu"))


@pytest.mark.parametrize("seed", range(4))
def test_hpwl_delta_pallas_equals_reference(seed):
    """The annealer's case (the nets of the two entities, first
    occurrences, per-net costs exact) and the contract's general one:
    any touched list with duplicates and padding, any per-net costs."""
    rng = np.random.default_rng(20 + seed)
    slot_xy, pins, mask = _placement(seed)
    e, n = slot_xy.shape[0], pins.shape[0]
    slot_of = rng.permutation(e).astype(np.int32)
    pnc = np.array(ref.net_hpwl(jnp.asarray(slot_xy[slot_of]),
                                  jnp.asarray(pins), jnp.asarray(mask)))
    a, b = (int(v) for v in rng.choice(e, 2, replace=False))
    if seed == 3:
        b = a                                    # a swap with itself
    nets = sorted({i for i in range(n)
                   if np.isin(pins[i][mask[i]], (a, b)).any()})
    cases = [(np.asarray(nets + [n] * 3, np.int32), pnc),
             (rng.integers(0, n + 1, 37).astype(np.int32),
              rng.integers(0, 40, n).astype(np.float32))]
    for touched, costs in cases:
        want_new, want_delta = ref.hpwl_delta_pallas(
            jnp.asarray(slot_xy), jnp.asarray(slot_of), jnp.asarray(pins),
            jnp.asarray(mask), jnp.asarray(costs), jnp.asarray(touched),
            a, b, interpret=True)
        got_new, got_delta = port.hpwl_delta_pallas(
            slot_xy, slot_of, pins, mask, costs, touched, a, b,
            device="cpu")
        assert got_new.dtype == torch.float32 and got_delta.shape == ()
        assert (got_new.numpy() == np.asarray(want_new)).all()
        assert float(got_delta) == float(want_delta)
    # the annealer's case: the delta is the change of the whole placement
    cand = slot_of.copy()
    cand[a], cand[b] = slot_of[b], slot_of[a]
    _, delta = port.hpwl_delta_pallas(slot_xy, slot_of, pins, mask, pnc,
                                      cases[0][0], a, b, device="cpu")
    assert port.hpwl_reference(slot_xy[cand], pins, mask) == \
        float(pnc.sum()) + float(delta)


@pytest.mark.parametrize("bad", [-1, -40, -(2 ** 31)])
def test_hpwl_delta_pallas_refuses_negative_ids(bad):
    """A negative net id in ``touched`` is refused on either device (the
    reference wraps it; the card's kernel would read outside its tables),
    before any launch."""
    slot_xy, pins, mask = _placement(5)
    n = pins.shape[0]
    slot_of = np.arange(slot_xy.shape[0], dtype=np.int32)
    costs = np.zeros(n, np.float32)
    touched = np.array([0, bad, n], np.int32)
    before = port.hpwl_delta_pallas.launches
    with pytest.raises(ValueError, match="touched"):
        port.hpwl_delta_pallas(slot_xy, slot_of, pins, mask, costs, touched,
                               1, 2, device="cpu")
    assert port.hpwl_delta_pallas.launches == before


@pytest.mark.parametrize("seed", range(2))
def test_anneal_chains_xy_chain_scores_each_placement(seed):
    """``anneal_chains`` with ``xy_chain`` (each chain its own slot
    coordinates, the launch behind ``hpwl_batched``): with no steps its
    starting per-net costs are the reference's ``net_hpwl`` of each
    placement and its best costs their totals; with steps, each chain
    anneals as it would alone over a problem of its own coordinates."""
    slot_xy, pins, mask = _placement(seed)
    rng = np.random.default_rng(40 + seed)
    r, (e, n) = 6, (slot_xy.shape[0], pins.shape[0])
    pos = np.stack([slot_xy[rng.permutation(e)] for _ in range(r)])
    t_pos, t_pins, t_mask = (torch.from_numpy(x) for x in (pos, pins, mask))
    i32 = dict(dtype=torch.int32)
    per_net, total = port._rows_plain(t_pos, t_pins, t_mask)
    pnc0 = torch.empty((r, n))
    no = torch.empty((r, 0), **i32)
    best = port.anneal_chains(
        torch.zeros(r, **i32), t_pos, t_pins[None], t_mask[None],
        torch.full((1, e, 1), n, **i32), torch.empty((1, 0)),
        torch.empty((1, 0), dtype=torch.bool), no, no, torch.empty((r, 0)),
        torch.arange(e, **i32).expand(r, e).contiguous(), xy_chain=True,
        pnc0_out=pnc0)[1]
    for c in range(r):
        assert (pnc0[c].numpy() == np.asarray(ref.net_hpwl(
            jnp.asarray(pos[c]), jnp.asarray(pins), jnp.asarray(mask)))).all()
    assert torch.equal(pnc0, per_net) and torch.equal(best, total)
    # with steps: the same as R problems of one chain each
    s, k = 24, 4
    ent_nets = np.full((1, e, k), n, np.int32)
    for i in range(e):
        on = np.flatnonzero((pins == i) & mask).tolist()
        on = sorted({j // pins.shape[1] for j in on})[:k]
        ent_nets[0, i, :len(on)] = on
    temps = torch.from_numpy(rng.uniform(0.5, 4, (1, s)).astype(np.float32))
    active = torch.ones((1, s), dtype=torch.bool)
    a = torch.from_numpy(rng.integers(0, e, (r, s)).astype(np.int32))
    t = torch.from_numpy(rng.integers(0, e, (r, s)).astype(np.int32))
    log_u = torch.from_numpy(np.log(rng.random((r, s))).astype(np.float32))
    slot0 = torch.from_numpy(np.stack([rng.permutation(e) for _ in range(r)])
                             .astype(np.int32))
    en = torch.from_numpy(ent_nets)
    got = port.anneal_chains(torch.zeros(r, **i32), t_pos, t_pins[None],
                             t_mask[None], en, temps, active, a, t, log_u,
                             slot0, telemetry=True, xy_chain=True)
    tile = (lambda x: x.expand(r, *x.shape[1:]).contiguous())
    want = port.anneal_chains(torch.arange(r, **i32), t_pos,
                              tile(t_pins[None]), tile(t_mask[None]),
                              tile(en), tile(temps), tile(active), a, t,
                              log_u, slot0, telemetry=True)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


#: the ops of the lanes that do not run the op under test: exact, and
#: with no subnormal result on any op's operands
OTHER = ("nop", "add", "sub", "mul", "min", "max", "eq", "sel")


def _alu_inputs(op, seed, rows=None):
    """(codes, a, b, c) for the whole op table, ``op`` on 90% of the
    lanes and the ops of :data:`OTHER` on the rest (``test_torch_sim``'s
    operands for ``op``: no subnormal operand or result), optionally as
    ``rows`` rows sharing the codes."""
    rng = np.random.default_rng(seed)
    a, b, c = sim_tests._operands(op, rng)
    n = a.shape[0]
    other = np.int32([ALL_OPS.index(o) for o in OTHER])
    codes = np.where(rng.random(n) < 0.9, ALL_OPS.index(op),
                     rng.choice(other, n)).astype(np.int32)
    if rows:
        a, b, c = (np.stack([np.roll(x, r) for r in range(rows)])
                   for x in (a, b, c))
    return codes, a, b, c


def _held(op, got, want, a):
    """Bit-equal, or within 2 ulp for a transcendental (tanh of the
    correctly rounded value where its lane runs tanh)."""
    if op not in sim_tests.TRANSCENDENTAL:
        assert sim_tests._bit_equal(got, want).all(), op
        return
    if op == "tanh":
        truth = np.tanh(a.astype(np.float64)).astype(np.float32)
        want = np.where(want == np.tanh(a), truth, want)
        assert sim_tests._ulp(got, truth)[np.isfinite(truth)].max() <= 2
    assert sim_tests._ulp(got, want).max() <= 2, op


#: every op but nop, and mac (:func:`test_mac_is_one_fma`)
STEP_OPS = [o for o in ALL_OPS if o not in ("nop", "mac")]


@pytest.mark.parametrize("op", STEP_OPS)
def test_alu_step_jnp_equals_reference(op):
    codes, a, b, c = _alu_inputs(op, zlib.crc32(op.encode()), rows=3)
    want = np.asarray(r_step.alu_step_jnp(codes, a, b, c, ALL_OPS))
    got = t_step.alu_step_jnp(codes, a, b, c, ALL_OPS, device="cpu")
    assert got.shape == a.shape and got.dtype == torch.float32
    if op == "tanh":
        lanes = codes == ALL_OPS.index("tanh")
        truth = np.tanh(a.astype(np.float64)).astype(np.float32)
        assert sim_tests._ulp(got.numpy()[:, lanes],
                              truth[:, lanes]).max() <= 2
        assert sim_tests._bit_equal(got.numpy()[:, ~lanes],
                                    want[:, ~lanes]).all()
    else:
        _held(op, got.numpy(), want, a)


@pytest.mark.parametrize("op", STEP_OPS)
def test_alu_step_pallas_equals_reference(op):
    codes, a, b, c = _alu_inputs(op, zlib.crc32(op.encode()) + 1)
    got = t_step.alu_step_pallas(codes, a, b, c, ALL_OPS, interpret=False,
                                 device="cpu")
    want = np.asarray(r_step.alu_step_pallas(codes, a, b, c, ALL_OPS,
                                             interpret=True))
    if op == "tanh":
        lanes = codes == ALL_OPS.index("tanh")
        truth = np.tanh(a.astype(np.float64)).astype(np.float32)
        assert sim_tests._ulp(got.numpy()[lanes], truth[lanes]).max() <= 2
        assert sim_tests._bit_equal(got.numpy()[~lanes], want[~lanes]).all()
    else:
        _held(op, got.numpy(), want, a)


@pytest.mark.parametrize("with_mul", [False, True])
def test_mac_is_one_fma(with_mul):
    """The port's ``mac`` (both entry points) equals the reference's
    jitted step and its Pallas step in interpret mode bit for bit under
    the whole op table with and without ``mul``: one FMA without ``mul``
    (XLA contracts it), the product rounded first with it (the product
    shared with ``mul``'s branch); on some lanes the two differ."""
    codes, a, b, c = _alu_inputs("mac", zlib.crc32(b"mac"))
    ops = ALL_OPS if with_mul else tuple(o for o in ALL_OPS if o != "mul")
    codes = np.int32([ops.index(ALL_OPS[k]) if ALL_OPS[k] in ops else 0
                      for k in codes])
    mac = codes == ops.index("mac")
    fused = t_step._fma(*(torch.from_numpy(x) for x in (a, b, c))).numpy()
    rounded = (a * b) + c
    assert not sim_tests._bit_equal(fused[mac], rounded[mac]).all()
    rule = rounded if with_mul else fused
    for rf in (r_step.alu_step_jnp(codes, a, b, c, ops),
               r_step.alu_step_pallas(codes, a, b, c, ops, interpret=True)):
        assert sim_tests._bit_equal(np.asarray(rf)[mac], rule[mac]).all()
    for fn in (t_step.alu_step_jnp, t_step.alu_step_pallas):
        got = fn(codes, a, b, c, ops, device="cpu").numpy()
        assert sim_tests._bit_equal(got[mac], rule[mac]).all()


def test_alu_step_codes_outside_the_table():
    """``alu_step_jnp`` clamps a code to the table (``lax.switch``), the
    Pallas step retires 0.0 for it; codes shared by rows or one a lane."""
    ops = t_step.op_table(["add", "mul", "sub"])
    rng = np.random.default_rng(7)
    a, b, c = (rng.normal(size=(2, 9)).astype(np.float32) for _ in range(3))
    for codes in (np.int32([-3, -1, 0, 1, 2, 3, 4, 9, 2]),
                  rng.integers(-2, 6, (2, 9)).astype(np.int32)):
        got = t_step.alu_step_jnp(codes, a, b, c, ops, device="cpu")
        want = np.asarray(r_step.alu_step_jnp(codes, a, b, c, ops))
        assert sim_tests._bit_equal(got.numpy(), want).all()
        got = t_step.alu_step_pallas(codes, a, b, c, ops, device="cpu")
        want = np.asarray(r_step.alu_step_pallas(codes, a, b, c, ops,
                                                 interpret=True))
        assert sim_tests._bit_equal(got.numpy(), want).all()


@pytest.mark.parametrize("shape", [(1, 1), (8, 128), (9, 129), (3, 300),
                                   (16, 64)])
def test_tiling_equals_reference(shape):
    for n, k in ((0, 8), (1, 8), (8, 8), (9, 8), (127, 128), (300, 128)):
        assert t_tiling.round_up(n, k) == r_tiling.round_up(n, k)
    assert (t_tiling.SUBLANE, t_tiling.LANE) == \
        (r_tiling.SUBLANE, r_tiling.LANE)
    x = np.arange(np.prod(shape), dtype=np.int32).reshape(shape)
    for fill in (0, -1):
        want = np.asarray(r_tiling.pad2d(jnp.asarray(x), fill=fill))
        got = t_tiling.pad2d(torch.from_numpy(x), fill=fill)
        assert got.dtype == torch.int32 and (got.numpy() == want).all()
    on_grid = torch.zeros((8, 128))
    assert t_tiling.pad2d(on_grid) is on_grid
