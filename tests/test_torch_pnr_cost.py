"""The port's HPWL functions and the plain versions of its placement
kernels against the JAX package's jnp functions, its Pallas kernels (in
interpret mode, as the JAX package's own tests run them) and the
pure-Python oracle.

Tolerance: exact equality.  Coordinates are small integers, so every
per-net HPWL, total and delta is an integer-valued float32 far below
2^24 and exact in any summation order.
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
    before = port.net_hpwl_rows.launches
    out = port.net_hpwl_rows(prob, slot0, slot_xy, pins, mask)
    assert port.net_hpwl_rows.launches == before      # CPU: plain version
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
    pnc0 = port.net_hpwl_rows(prob, slot0, slot_xy, pins, mask)
    before = port.anneal_chains.launches
    outs = {(full, tele): port.anneal_chains(*args, pnc0, full=full,
                                             telemetry=tele)
            for full in (False, True) for tele in (False, True)}
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
