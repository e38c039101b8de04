"""The port's HPWL functions (plain and with fixed boxes) and the plain
version of its placement kernel against the JAX package's jnp functions,
its Pallas kernels (in interpret mode, as the JAX package's own tests run
them) and the pure-Python oracle.

K2's layout (its pin table and shared-memory formula) is checked against
the image suite's largest pnr signature.

Tolerance: exact equality.  Coordinates are small integers and box
corners integers or half-integers, so every per-net HPWL, total and
delta is a multiple of 0.5 far below 2^22, exact in any summation order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import pnr_cost as ref
from repro_torch.kernels import pnr_cost as port


def _netlist(seed, e=40, n=30, d=6, grid=9):
    rng = np.random.default_rng(seed)
    pos = rng.integers(0, grid, size=(e, 2)).astype(np.float32)
    pins = rng.integers(0, e, size=(n, d)).astype(np.int32)
    mask = rng.random((n, d)) < 0.7
    mask[rng.integers(0, n, size=3)] = False          # pinless nets
    return pos, pins, mask


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("seed", range(6))
def test_hpwl_matches_reference(seed):
    pos, pins, mask = _netlist(seed)
    want = np.asarray(ref.net_hpwl(jnp.asarray(pos), jnp.asarray(pins),
                                   jnp.asarray(mask)))
    got = port.net_hpwl(_t(pos), _t(pins), _t(mask)).numpy()
    assert (want == got).all()
    total = float(port.hpwl(_t(pos), _t(pins), _t(mask)))
    assert total == float(ref.hpwl(pos, pins, mask))
    assert total == float(ref.hpwl_pallas(jnp.asarray(pos),
                                          jnp.asarray(pins),
                                          jnp.asarray(mask), interpret=True))
    assert total == port.hpwl_reference(pos, pins, mask)


@pytest.mark.parametrize("seed", range(6))
def test_hpwl_delta_matches_reference(seed):
    rng = np.random.default_rng(100 + seed)
    pos, pins, mask = _netlist(seed)
    e = pos.shape[0]
    slot_xy = pos
    slot_of = rng.permutation(e).astype(np.int32)
    pnc = np.asarray(ref.net_hpwl(jnp.asarray(slot_xy[slot_of]),
                                  jnp.asarray(pins), jnp.asarray(mask)))
    a, b = (int(v) for v in rng.choice(e, 2, replace=False))
    cand = slot_of.copy()
    cand[a], cand[b] = slot_of[b], slot_of[a]
    touched = sorted({i for i in range(pins.shape[0])
                      if ((pins[i] == a) | (pins[i] == b))[mask[i]].any()})
    n = pins.shape[0]
    tn = np.asarray(touched + [n] * (8 - len(touched) % 8), np.int32)
    r_new, r_delta = ref.hpwl_delta(jnp.asarray(slot_xy), jnp.asarray(cand),
                                    jnp.asarray(pins), jnp.asarray(mask),
                                    jnp.asarray(pnc), jnp.asarray(tn))
    p_new, p_delta = port.hpwl_delta(_t(slot_xy), _t(cand), _t(pins),
                                     _t(mask), _t(pnc), _t(tn))
    k_new, k_delta = ref.hpwl_delta_pallas(
        jnp.asarray(slot_xy), jnp.asarray(slot_of), jnp.asarray(pins),
        jnp.asarray(mask), jnp.asarray(pnc), jnp.asarray(tn), a, b,
        interpret=True)
    assert (np.asarray(r_new) == p_new.numpy()).all()
    assert (np.asarray(k_new) == p_new.numpy()).all()
    assert float(r_delta) == float(p_delta) == float(k_delta)
    # delta == full recompute
    full_new = float(port.hpwl(_t(slot_xy[cand]), _t(pins), _t(mask)))
    assert full_new == float(pnc.sum()) + float(p_delta)


def _problem_batch(seed, p_n=2, chains=3, e=24, n=20, d=5, s=64):
    """Random padded problem arrays + streams in the kernels' layout."""
    rng = np.random.default_rng(seed)
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
    prob = np.repeat(np.arange(p_n, dtype=np.int32), chains)
    slot0 = np.stack([rng.permutation(e) for _ in range(r)]).astype(np.int32)
    a = rng.integers(0, e, size=(r, s)).astype(np.int32)
    t = rng.integers(0, e, size=(r, s)).astype(np.int32)
    log_u = np.log(rng.random((r, s)).astype(np.float32) + 1e-12)
    temps = np.linspace(4.0, 0.02, s, dtype=np.float32)[None].repeat(p_n, 0)
    active = np.arange(s)[None] < np.array([[s], [s - 7]])[:p_n]
    return [_t(x) for x in (prob, slot_xy, pins, mask, ent_nets, temps,
                            active, a, t, log_u.astype(np.float32), slot0)]


@pytest.mark.parametrize("seed", range(3))
def test_net_hpwl_rows_plain(seed):
    prob, slot_xy, pins, mask, *_, slot0 = _problem_batch(seed)
    out = port.net_hpwl_rows_plain(prob, slot0, slot_xy, pins, mask)
    for r in range(slot0.shape[0]):
        p = int(prob[r])
        want = ref.net_hpwl(jnp.asarray(slot_xy[p][slot0[r].long()].numpy()),
                            jnp.asarray(pins[p].numpy()),
                            jnp.asarray(mask[p].numpy()))
        assert (np.asarray(want) == out[r].numpy()).all()


@pytest.mark.parametrize("seed", range(3))
def test_anneal_plain_delta_equals_full(seed):
    args = _problem_batch(seed)
    prob, slot_xy, pins, mask, *_, slot0 = args
    pnc0 = port.net_hpwl_rows_plain(prob, slot0, slot_xy, pins, mask)
    before = port.anneal_chains.launches
    outs = {}
    for full in (False, True):
        for tele in (False, True):
            got = torch.full_like(pnc0, -1.0)
            outs[(full, tele)] = port.anneal_chains(
                *args, full=full, telemetry=tele, pnc0_out=got)
            assert torch.equal(got, pnc0)       # the prologue's costs
    assert port.anneal_chains.launches == before
    base = outs[(False, False)]
    for (full, tele), o in outs.items():
        assert torch.equal(o[0], base[0]) and torch.equal(o[1], base[1])
        if tele:
            assert torch.equal(o[2], outs[(False, True)][2])
            assert torch.equal(o[3], outs[(False, True)][3])
        else:
            assert o[2] is None and o[3] is None
    # the returned best cost is the HPWL of the returned best slots
    best_slot, best = base[0], base[1]
    for r in range(best_slot.shape[0]):
        p = int(prob[r])
        assert float(port.hpwl(slot_xy[p][best_slot[r].long()], pins[p],
                               mask[p])) == float(best[r])
    assert (best <= pnc0.sum(dim=1)).all()


# ---------------------------------------------------------------------------
# K2's layout: the pin table and the shared-memory formula
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", range(3))
def test_pin_table_keeps_each_nets_pins(seed):
    prob, slot_xy, pins, mask, *_ = _problem_batch(seed)
    tab = port.pin_table(pins, mask)
    p_n, n, d = pins.shape
    assert tab.dtype == torch.int32 and tab.shape[:2] == (p_n, n)
    assert tab.shape[2] >= 8 and tab.shape[2] % 4 == 0 and tab.shape[2] > d
    for p in range(p_n):
        for i in range(n):
            real = pins[p, i][mask[p, i]].tolist()
            row = tab[p, i].tolist()
            assert row[0] == len(real)
            assert row[1:1 + len(real)] == real
            assert all(v == -1 for v in row[1 + len(real):])


def _image_problems():
    """The image suite's apps lowered on their baseline PE (one op a PE:
    the most cells, so the largest pnr signatures of the suite)."""
    from repro_torch.apps import image_graphs
    from repro_torch.core import baseline_datapath, map_application
    from repro_torch.core.dse import app_ops
    from repro_torch.fabric import FabricSpec, extract_netlist, lower
    spec = FabricSpec(rows=16, cols=16)
    out = {}
    for name, g in image_graphs().items():
        nl = extract_netlist(map_application(baseline_datapath(app_ops(g)),
                                             g, name), g, spec)
        out[name] = lower(nl, spec.fit(len(nl.pe_cells), len(nl.io_cells)))
    return out


def _smem_mirror(n, w, e, k, stage, chain=True):
    # pnr_anneal_smem_bytes in csrc/pnr_anneal.cu, term by term: the pin
    # table (N rows of W int32), slot_xy (E float2), ent_nets (E x K
    # int32), then the chain's slot_of and occupant (E int32 each) and its
    # per-net costs (N float32)
    tables = n * w * 4 + e * 8 + e * k * 4 if stage else 0
    return tables + (e * 4 + e * 4 + n * 4 if chain else 0)


def test_anneal_layout_fits_image_suite_largest_signature():
    from repro_torch.fabric import batch_signature
    sigs = {name: batch_signature(p, 32)
            for name, p in _image_problems().items()}
    # (steps, N, D, E, K) of camera on PE1, the largest signature of the
    # image suite in chip_smoke.py's run
    assert max(sigs.values()) == sigs["camera"] == (16384, 512, 32, 512, 4)
    for sig in sigs.values():
        _, n, d, e, k = sig
        w, stage, chain, smem = port.anneal_layout(n, d, e, k)
        assert stage and chain and w == max(8, (d + 4) // 4 * 4)
        assert smem == _smem_mirror(n, w, e, k, stage)
        assert smem <= port.SMEM_LIMIT == 227 * 1024


def test_anneal_layout_shrinks_then_refuses():
    # tables and chain exactly at 227 KB: staged; one net more: the chain
    # reads the tables from global memory
    w, stage, chain, smem = port.anneal_layout(6400, 4, 64, 4)
    assert stage and chain and smem == port.SMEM_LIMIT
    assert smem == _smem_mirror(6400, w, 64, 4, stage)
    w, stage, chain, smem = port.anneal_layout(6401, 4, 64, 4)
    assert not stage and chain
    assert smem == _smem_mirror(6401, w, 64, 4, stage)
    w, stage, chain, smem = port.anneal_layout(4096, 32, 2048, 8)
    assert not stage and chain
    assert smem == _smem_mirror(4096, w, 2048, 8, stage)
    # one chain's state alone above 227 KB goes to the global scratch and
    # the block asks for no shared memory (the grouped path's flat 128x128
    # bucket; the 256x256 deblock)
    for n, e in ((20000, 20000), (16384, 32768), (32768, 16384)):
        assert _smem_mirror(n, 8, e, 4, False) > port.SMEM_LIMIT
        w, stage, chain, smem = port.anneal_layout(n, 4, e, 4)
        assert (stage, chain, smem) == (False, False, 0)
        assert smem == _smem_mirror(n, w, e, 4, stage, chain)
    # the largest chain that fits keeps its state in shared memory
    w, stage, chain, smem = port.anneal_layout(port.SMEM_LIMIT // 4 - 2,
                                               4, 1, 4)
    assert chain and not stage and smem == port.SMEM_LIMIT


# ---------------------------------------------------------------------------
# fixed boxes (the hierarchical placer's sub-problems)
# ---------------------------------------------------------------------------
def _boxes(rng, n, half=True):
    """(N, 4) boxes: integer or half-integer corners (cluster centres are
    origin + (rw - 1) / 2), some EMPTY_BOX."""
    step = 2.0 if half else 1.0
    lo = rng.integers(-8, 12, size=(n, 2)) / step
    ext = rng.integers(0, 10, size=(n, 2)) / step
    fix = np.stack([lo[:, 0], lo[:, 0] + ext[:, 0],
                    lo[:, 1], lo[:, 1] + ext[:, 1]], -1).astype(np.float32)
    fix[rng.random(n) < 0.3] = np.asarray(ref.EMPTY_BOX, np.float32)
    return fix


@pytest.mark.parametrize("points", [
    [], [(3, 4)], [(1, 2), (5, -1), (0, 0)], [(2.5, 3.5), (-1.5, 7.0)]])
def test_fixed_box_matches_reference(points):
    got = port.fixed_box(points)
    want = ref.fixed_box(points)
    assert got.dtype == want.dtype == np.float32
    assert np.array_equal(got, want)
    assert port.EMPTY_BOX == ref.EMPTY_BOX


@pytest.mark.parametrize("seed", range(6))
def test_hpwl_fixed_matches_reference(seed):
    rng = np.random.default_rng(200 + seed)
    pos, pins, mask = _netlist(seed)
    fix = _boxes(rng, pins.shape[0], half=seed % 2 == 0)
    # a pinless net with a box scores the box; with EMPTY_BOX it scores 0
    pinless = ~mask.any(axis=1)
    assert pinless.any()
    want = np.asarray(ref.net_hpwl_fixed(jnp.asarray(pos), jnp.asarray(pins),
                                         jnp.asarray(mask), jnp.asarray(fix)))
    got = port.net_hpwl_fixed(_t(pos), _t(pins), _t(mask), _t(fix)).numpy()
    assert np.array_equal(want, got)
    assert float(port.hpwl_fixed(_t(pos), _t(pins), _t(mask), _t(fix))) \
        == float(ref.hpwl_fixed(pos, pins, mask, fix))
    boxed = fix[:, 0] <= fix[:, 1]
    assert np.array_equal(got[pinless & boxed],
                          (fix[:, 1] - fix[:, 0] + fix[:, 3]
                           - fix[:, 2])[pinless & boxed])
    assert (got[pinless & ~boxed] == 0).all()
    if seed % 2 == 0:                         # half-integer costs occur
        assert (got % 1 == 0.5).any()


@pytest.mark.parametrize("seed", range(3))
def test_empty_box_is_a_bit_exact_noop(seed):
    pos, pins, mask = _netlist(seed)
    empty = np.tile(np.asarray(port.EMPTY_BOX, np.float32),
                    (pins.shape[0], 1))
    got = port.net_hpwl_fixed(_t(pos), _t(pins), _t(mask), _t(empty))
    assert torch.equal(got, port.net_hpwl(_t(pos), _t(pins), _t(mask)))
    assert np.array_equal(got.numpy(), np.asarray(ref.net_hpwl_fixed(
        jnp.asarray(pos), jnp.asarray(pins), jnp.asarray(mask),
        jnp.asarray(empty))))


@pytest.mark.parametrize("seed", range(6))
def test_hpwl_delta_fixed_matches_reference(seed):
    rng = np.random.default_rng(300 + seed)
    pos, pins, mask = _netlist(seed)
    e, n = pos.shape[0], pins.shape[0]
    fix = _boxes(rng, n)
    fix[n - 1] = (0.5, 9.5, -2.0, 3.0)    # the pads' clamped gather target
    slot_of = rng.permutation(e).astype(np.int32)
    pnc = np.asarray(ref.net_hpwl_fixed(
        jnp.asarray(pos[slot_of]), jnp.asarray(pins), jnp.asarray(mask),
        jnp.asarray(fix)))
    a, b = (int(v) for v in rng.choice(e, 2, replace=False))
    cand = slot_of.copy()
    cand[a], cand[b] = slot_of[b], slot_of[a]
    touched = sorted({i for i in range(n)
                      if ((pins[i] == a) | (pins[i] == b))[mask[i]].any()})
    # pads (n) and a duplicate entry (also n): both must score 0
    tn = np.asarray(touched + [n] * (8 - len(touched) % 8), np.int32)
    r_new, r_delta = ref.hpwl_delta_fixed(
        jnp.asarray(pos), jnp.asarray(cand), jnp.asarray(pins),
        jnp.asarray(mask), jnp.asarray(pnc), jnp.asarray(tn),
        jnp.asarray(fix))
    p_new, p_delta = port.hpwl_delta_fixed(_t(pos), _t(cand), _t(pins),
                                           _t(mask), _t(pnc), _t(tn), _t(fix))
    assert np.array_equal(np.asarray(r_new), p_new.numpy())
    assert float(r_delta) == float(p_delta)
    assert (p_new.numpy()[len(touched):] == 0).all()
    full_new = float(port.hpwl_fixed(_t(pos[cand]), _t(pins), _t(mask),
                                     _t(fix)))
    assert full_new == float(pnc.sum()) + float(p_delta)


def _boxed_batch(seed):
    args = _problem_batch(seed)
    rng = np.random.default_rng(400 + seed)
    p_n, n = args[2].shape[:2]
    mask = args[3].clone()
    mask[:, :3] = False                   # nets scored by their box alone
    args[3] = mask
    return args + [_t(np.stack([_boxes(rng, n) for _ in range(p_n)]))]


@pytest.mark.parametrize("seed", range(3))
def test_net_hpwl_rows_plain_fixed(seed):
    prob, slot_xy, pins, mask, *_, slot0, fix = _boxed_batch(seed)
    out = port.net_hpwl_rows_plain(prob, slot0, slot_xy, pins, mask, fix)
    for r in range(slot0.shape[0]):
        p = int(prob[r])
        want = ref.net_hpwl_fixed(
            jnp.asarray(slot_xy[p][slot0[r].long()].numpy()),
            jnp.asarray(pins[p].numpy()), jnp.asarray(mask[p].numpy()),
            jnp.asarray(fix[p].numpy()))
        assert np.array_equal(np.asarray(want), out[r].numpy())


@pytest.mark.parametrize("seed", range(3))
def test_anneal_plain_fixed_delta_equals_full(seed):
    args = _boxed_batch(seed)
    prob, slot_xy, pins, mask, *_, slot0, fix = args
    pnc0 = port.net_hpwl_rows_plain(prob, slot0, slot_xy, pins, mask, fix)
    outs = {}
    for full in (False, True):
        got = torch.empty_like(pnc0)
        outs[full] = port.anneal_chains(*args, full=full, telemetry=True,
                                        pnc0_out=got)
        assert torch.equal(got, pnc0)
    for x, y in zip(outs[False], outs[True]):
        assert torch.equal(x, y)
    best_slot, best = outs[False][:2]
    for r in range(best_slot.shape[0]):
        p = int(prob[r])
        assert float(port.hpwl_fixed(slot_xy[p][best_slot[r].long()],
                                     pins[p], mask[p], fix[p])) \
            == float(best[r])
    # EMPTY_BOX everywhere: the box-free program, bit for bit
    empty = torch.tensor(port.EMPTY_BOX).expand_as(fix).contiguous()
    plain = port.anneal_chains(*args[:-1], telemetry=True)
    boxed = port.anneal_chains(*args[:-1], empty, telemetry=True)
    for x, y in zip(plain, boxed):
        assert torch.equal(x, y)


def test_anneal_layout_counts_the_boxes():
    n, d, e, k = 512, 32, 512, 4
    w, stage, chain, smem = port.anneal_layout(n, d, e, k, True)
    assert stage and chain
    assert smem == _smem_mirror(n, w, e, k, stage) + 16 * n
    # boxes push a problem that stages without them to global tables
    w, stage, _, _ = port.anneal_layout(6400, 4, 64, 4)
    assert stage
    w, stage, chain, smem = port.anneal_layout(6400, 4, 64, 4, True)
    assert not stage and chain
    assert smem == _smem_mirror(6400, w, 64, 4, stage)
