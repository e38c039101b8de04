"""The port's matmul with a fused PE epilogue (K5's plain version,
``device="cpu"``) against the JAX package's Pallas kernel run in interpret
mode, on the same seeded numpy inputs; K5's encoded op list, evaluated
in numpy through a mirror of ``csrc/gemm_pe.cu``'s device table, against
the float64 oracle ``ref_gemm_pe``; and a plain emulation of K5's 3xTF32
product (each operand rounded to TF32 as ``cvt.rna`` does, by bit
arithmetic, split into hi + lo, three products a step) against the
float64 product at the main path's depth (within 1e-5 of max(1, |x|):
float32 accuracy) and, with the encoded epilogue, against the Pallas
kernel on shapes ragged against K5's tile.

Tolerance: rtol = atol = 1e-4 (the reference tests' own,
``tests/test_kernels.py``): float32 products summed in another order.
A bfloat16 result is held two ways: bit-equal to the rounding of the
port's own float32 result, and within one bfloat16 rounding step
(2**-8 relative) of the JAX package's, since float32 sums that differ in
the last bits can round to neighbouring bfloat16 values.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.graphir import pattern_from_spec as r_spec
from repro.kernels import matmul_fused as r_matmul
from repro.kernels.ref import ref_gemm_pe as r_ref_gemm
from repro_torch.graphir import pattern_from_spec as t_spec
from repro_torch.graphir.graph import free_in_ports
from repro_torch.kernels import gemm_pe, matmul_fused as t_matmul
from repro_torch.kernels.gemm import EPI_OPCODES, MAX_OPS, encode_epilogue
from repro_torch.kernels.pe_fused import pe_apply_plain
from repro_torch.kernels.ref import ref_gemm_pe as t_ref_gemm

CU = Path(__file__).resolve().parents[1] / "src/repro_torch/kernels/csrc/gemm_pe.cu"

BIAS_RELU = [("add", (-1, -1)), ("const", ()), ("max", (0, 1))]   # Conv tail
RESIDUAL = [("add", (-1, -1))]                                    # Block tail
EPILOGUES = {
    "bias_relu": (BIAS_RELU, ("vec",)),
    "residual": (RESIDUAL, ("full",)),
    "residual_relu": ([("add", (-1, -1)), ("const", ()), ("max", (0, 1))],
                      ("full",)),
    "scale_shift": ([("mul", (-1, -1)), ("add", (0, -1))], ("vec", "vec")),
    "requant": ([("mul", (-1, -1)), ("round", (0,)), ("const", ()),
                 ("min", (1, 2))], ("vec",)),
    "gelu_like": ([("mul", (-1, -1)), ("erf", (0,)), ("const", ()),
                   ("add", (1, 2)), ("mul", (3, -1))], ("vec", "full")),
    "leaky_sel": ([("const", ()), ("gt", (-1, 0)), ("mul", (-1, -1)),
                   ("sel", (1, 2, -1))], ("vec", "full", "vec")),
    "bool_sum": ([("lt", (-1, -1)), ("gt", (-1, -1)), ("add", (0, 1)),
                  ("add", (2, -1))], ("vec", "full", "full", "vec")),
}
CONST_VALUES = {"bias_relu": 0.0, "residual_relu": 0.0, "requant": 4.0,
                "gelu_like": 1.0, "leaky_sel": 0.0}


def _pats(name):
    spec, kinds = EPILOGUES[name]
    rpat, tpat = r_spec(spec), t_spec(spec)
    for g in (rpat, tpat):
        for n, op in g.nodes.items():
            if op == "const":
                g.attrs[n]["value"] = CONST_VALUES[name]
    return rpat, tpat, kinds


def _operands(m, k, n, kinds, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(m, k)).astype(np.float32)
    w = rng.normal(size=(k, n)).astype(np.float32)
    extras = [rng.normal(size=(n,) if kind == "vec" else (m, n))
              .astype(np.float32) for kind in kinds]
    return x, w, extras


def _jax(x, w, extras=(), block=64, **kw):
    return np.asarray(r_matmul(
        jnp.asarray(x), jnp.asarray(w), *[jnp.asarray(e) for e in extras],
        bm=block, bn=block, bk=block, interpret=True, **kw), np.float32)


@pytest.mark.parametrize("m,k,n", [(64, 64, 64), (100, 70, 50),
                                   (256, 128, 192)])
def test_plain_product_matches_reference(m, k, n):
    x, w, _ = _operands(m, k, n, (), seed=m + k + n)
    got = t_matmul(x, w, device="cpu")
    assert got.shape == (m, n) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), _jax(x, w), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("name", sorted(EPILOGUES))
@pytest.mark.parametrize("m,k,n", [(64, 64, 64), (100, 70, 50),
                                   (256, 128, 192)])
def test_epilogue_matches_reference(name, m, k, n):
    rpat, tpat, kinds = _pats(name)
    x, w, extras = _operands(m, k, n, kinds, seed=len(name) + m)
    got = t_matmul(x, w, *extras, epilogue=tpat, extra_kinds=kinds,
                   device="cpu")
    want = _jax(x, w, extras, epilogue=rpat, extra_kinds=kinds)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", ["bias_relu", "residual"])
def test_bfloat16_result(name):
    rpat, tpat, kinds = _pats(name)
    x, w, extras = _operands(100, 70, 50, kinds, seed=5)
    kw = dict(epilogue=tpat, extra_kinds=kinds, device="cpu")
    got = t_matmul(x, w, *extras, out_dtype=torch.bfloat16, **kw)
    f32 = t_matmul(x, w, *extras, **kw)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, f32.to(torch.bfloat16))
    want = _jax(x, w, extras, epilogue=rpat, extra_kinds=kinds,
                out_dtype=jnp.bfloat16)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2.0 ** -8,
                               atol=1e-4)
    np.testing.assert_allclose(
        f32.numpy(), _jax(x, w, extras, epilogue=rpat, extra_kinds=kinds),
        rtol=1e-4, atol=1e-4)


def test_bfloat16_operands():
    x, w, _ = _operands(100, 70, 50, (), seed=9)
    xb, wb = torch.as_tensor(x).bfloat16(), torch.as_tensor(w).bfloat16()
    got = t_matmul(xb, wb, out_dtype=torch.float32, device="cpu")
    want = _jax(np.asarray(xb.float()), np.asarray(wb.float()))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    assert t_matmul(xb, wb, device="cpu").dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# the encoded op list, evaluated as csrc/gemm_pe.cu's device table does
# ---------------------------------------------------------------------------
def _t(a):
    return a != 0                                  # NaN is true


def _b(v):
    return np.asarray(v, np.float32)


DEVICE_TABLE = {
    "add": lambda a, b, c: a + b,
    "sub": lambda a, b, c: a - b,
    "neg": lambda a, b, c: -a,
    "abs": lambda a, b, c: np.abs(a),
    "mul": lambda a, b, c: a * b,
    "mac": lambda a, b, c: a * b + c,
    "div": lambda a, b, c: a / b,
    "recip": lambda a, b, c: np.float32(1) / a,
    "shl": lambda a, b, c: a * np.exp2(b),
    "shr": lambda a, b, c: a * np.exp2(-b),
    "ashr": lambda a, b, c: a * np.exp2(-b),
    "eq": lambda a, b, c: _b(a == b),
    "neq": lambda a, b, c: _b(a != b),
    "lt": lambda a, b, c: _b(a < b),
    "lte": lambda a, b, c: _b(a <= b),
    "gt": lambda a, b, c: _b(a > b),
    "gte": lambda a, b, c: _b(a >= b),
    "min": lambda a, b, c: np.minimum(a, b),
    "max": lambda a, b, c: np.maximum(a, b),
    "and": lambda a, b, c: _b(_t(a) & _t(b)),
    "or": lambda a, b, c: _b(_t(a) | _t(b)),
    "xor": lambda a, b, c: _b(_t(a) ^ _t(b)),
    "not": lambda a, b, c: _b(~_t(a)),
    "sign": lambda a, b, c: np.where(a > 0, 1, np.where(a < 0, -1, a)),
    "sel": lambda a, b, c: np.where(_t(a), c, b),
    "exp": lambda a, b, c: np.exp(a),
    "log": lambda a, b, c: np.log(a),
    "tanh": lambda a, b, c: np.tanh(a),
    "sigmoid": lambda a, b, c: 1 / (1 + np.exp(-a)),
    "rsqrt": lambda a, b, c: 1 / np.sqrt(a),
    "sqrt": lambda a, b, c: np.sqrt(a),
    "erf": lambda a, b, c: __import__("scipy.special").special.erf(a),
    "pow": lambda a, b, c: np.power(a, b),
    "floor": lambda a, b, c: np.floor(a),
    "round": lambda a, b, c: np.round(a),
}


def _eval_encoded(epi, acc, extras, kinds):
    m, n = acc.shape
    slots = [acc] + [np.broadcast_to(e[None, :] if kd == "vec" else e,
                                     (m, n)) for e, kd in zip(extras, kinds)]
    slots += [np.full((m, n), c, np.float32) for c in epi.consts]
    slots += [None] * len(epi.ops)
    with np.errstate(all="ignore"):
        for code, dst, a, b, c in epi.ops.tolist():
            slots[dst] = np.asarray(DEVICE_TABLE[EPI_OPCODES[code]](
                slots[a], slots[b], slots[c]), np.float32)
    return slots[epi.out]


def test_device_table_order_matches_opcodes():
    text = CU.read_text()
    enum = re.search(r"enum Opcode : int \{(.*?)\};", text, re.S).group(1)
    names = [t.strip().removeprefix("OP_").lower()
             for t in enum.split(",") if t.strip()]
    assert names[:-1] == list(EPI_OPCODES) and names[-1] == "n_opcodes"
    assert sorted(DEVICE_TABLE) == sorted(EPI_OPCODES)
    for op in EPI_OPCODES:
        assert f"case OP_{op.upper()}:" in text, op
    assert f"MAX_OPS = {MAX_OPS}" in text


@pytest.mark.parametrize("name", sorted(EPILOGUES))
def test_encoded_epilogue_matches_oracle(name):
    _, tpat, kinds = _pats(name)
    m, k, n = 100, 70, 50
    x, w, extras = _operands(m, k, n, kinds, seed=11)
    epi = encode_epilogue(tpat)
    assert epi.n_extra == len(kinds) == len(free_in_ports(tpat)) - 1
    acc = (torch.as_tensor(x) @ torch.as_tensor(w)).numpy()
    got = _eval_encoded(epi, acc, extras, kinds)
    want = t_ref_gemm(x, w, *extras, epilogue=tpat, extra_kinds=kinds)
    np.testing.assert_allclose(got, want.numpy(), rtol=1e-4, atol=1e-4)
    # the port's oracle is the JAX package's
    rpat = _pats(name)[0]
    r_want = np.asarray(r_ref_gemm(jnp.asarray(x), jnp.asarray(w),
                                   *[jnp.asarray(e) for e in extras],
                                   epilogue=rpat, extra_kinds=kinds))
    np.testing.assert_allclose(want.numpy(), r_want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("op", list(EPI_OPCODES))
def test_encoded_single_op_matches_plain(op):
    from repro_torch.graphir.ops import OPS
    arity = OPS[op].arity
    pat = t_spec([(op, (-1,) * arity)])
    kinds = ("full",) * (arity - 1)
    rng = np.random.default_rng(3)
    special = np.array([-2.5, -1.5, -0.5, -0.0, 0.0, 0.5, 1.5, 2.5, np.nan,
                        np.inf], np.float32)
    acc = rng.choice(special, (10, 10)).astype(np.float32)
    extras = [rng.choice(special, (10, 10)).astype(np.float32)
              for _ in kinds]
    got = _eval_encoded(encode_epilogue(pat), acc, extras, kinds)
    # the epilogue of gemm_pe_plain is K4's plain rendering of the pattern
    plain = pe_apply_plain(pat, *map(torch.as_tensor, [acc] + extras))
    plain = plain[0] if isinstance(plain, tuple) else plain
    np.testing.assert_allclose(got, plain.numpy(), rtol=1e-5, atol=1e-5,
                               equal_nan=True)


def test_checks_match_reference():
    x = np.zeros((8, 6), np.float32)
    with pytest.raises(ValueError, match="inner dimensions"):
        gemm_pe(x, np.zeros((5, 4), np.float32), device="cpu")
    pat = t_spec(BIAS_RELU)
    w = np.zeros((6, 4), np.float32)
    with pytest.raises(ValueError, match="takes 1 extra"):
        gemm_pe(x, w, epilogue=pat, device="cpu")
    with pytest.raises(ValueError, match="takes 1 extra"):
        gemm_pe(x, w, np.zeros(4, np.float32), epilogue=pat, device="cpu")
    with pytest.raises(ValueError, match="shape"):
        gemm_pe(x, w, np.zeros(5, np.float32), epilogue=pat,
                extra_kinds=("vec",), device="cpu")
    big = t_spec([("add", (-1, -1))] + [("add", (i, -1)) for i in range(40)])
    with pytest.raises(ValueError, match="too large"):
        encode_epilogue(big)


@pytest.mark.parametrize("block", [32, 64, 128])
def test_reference_tile_keywords_change_no_result(block):
    # the reference's bm/bn/bk are accepted: K5 masks ragged edges itself
    rpat, tpat, kinds = _pats("bias_relu")
    x, w, extras = _operands(100, 70, 50, kinds, seed=block)
    kw = dict(epilogue=tpat, extra_kinds=kinds, device="cpu")
    want = t_matmul(x, w, *extras, **kw)
    got = t_matmul(x, w, *extras, bm=block, bn=block, bk=block, **kw)
    assert torch.equal(got, want)
    assert torch.equal(t_matmul(x, w, bm=64, bn=64, bk=64, device="cpu"),
                       t_matmul(x, w, device="cpu"))


# ---------------------------------------------------------------------------
# K5's product as the kernel computes it: 3xTF32 on the tensor cores
# ---------------------------------------------------------------------------
def _tf32(a):
    """Round float32 to TF32 as ``cvt.rna.tf32.f32`` does: to nearest, ties
    away from zero, keeping 10 mantissa bits (the low 13 bits zero)."""
    bits = np.asarray(a, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def _k5_product(x, w):
    """x @ w as K5 computes it: each operand split into TF32 parts hi =
    tf32(a), lo = tf32(a - hi); per 32-deep step of K the tensor cores sum
    lo*hi + hi*lo + hi*hi from zero (modelled as one rounding of the exact
    sum), and the step's sum is added to the float32 result."""
    xh, wh = _tf32(x), _tf32(w)
    xl, wl = _tf32(x - xh), _tf32(w - wh)
    acc = np.zeros((x.shape[0], w.shape[1]), np.float32)
    for k0 in range(0, x.shape[1], 32):
        s = slice(k0, k0 + 32)
        step = sum(a[:, s].astype(np.float64) @ b[s].astype(np.float64)
                   for a, b in ((xl, wh), (xh, wl), (xh, wh)))
        acc = acc + step.astype(np.float32)
    return acc


def test_tf32_rounding_and_split_are_exact():
    rng = np.random.default_rng(18)
    a = (rng.normal(size=4096) * 10.0 ** rng.integers(-6, 6, 4096)).astype(
        np.float32)
    hi = _tf32(a)
    assert not (hi.view(np.uint32) & 0x1FFF).any()
    # round to nearest: |a - hi| <= half a TF32 ulp (2^-11 relative)
    assert (np.abs(a - hi) <= np.abs(hi) * 2.0 ** -11).all()
    lo = _tf32(a - hi)
    # hi + lo keeps 21 bits or more of a's 24
    assert (np.abs(a.astype(np.float64) - hi - lo)
            <= np.abs(a) * 2.0 ** -21).all()
    # ties go away from zero
    tie = np.float32([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11)])
    assert _tf32(tie).tolist() == [1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10)]
    # bfloat16 operands are TF32 values: K5 takes them in one product
    b = torch.as_tensor(a).bfloat16().float().numpy()
    assert np.array_equal(_tf32(b), b)


def test_tf32x3_product_holds_float32_accuracy():
    # the main path's depth (d_model 2048) and a layer's initialisation
    rng = np.random.default_rng(2048)
    m, k, n = 64, 2048, 48
    x = rng.normal(size=(m, k)).astype(np.float32)
    w = (rng.normal(size=(k, n)) / np.sqrt(k)).astype(np.float32)
    exact = x.astype(np.float64) @ w.astype(np.float64)
    scale = np.maximum(1.0, np.abs(exact))
    assert (np.abs(_k5_product(x, w) - exact) / scale).max() <= 1e-5
    # one TF32 product alone is not float32-accurate
    one = _tf32(x).astype(np.float64) @ _tf32(w).astype(np.float64)
    assert (np.abs(one - exact) / scale).max() > 1e-4


@pytest.mark.parametrize("m,k,n", [(200, 72, 136), (130, 37, 129),
                                   (64, 2048, 64)])
@pytest.mark.parametrize("name", ["bias_relu", "residual", "gelu_like"])
def test_tf32x3_emulation_matches_reference(name, m, k, n):
    # ragged M, N against K5's 128 x 128 tile and K against its 32-deep
    # step; K = 37 and N = 129 also off its 16-byte copies
    rpat, tpat, kinds = _pats(name)
    x, w, extras = _operands(m, k, n, kinds, seed=m + k + n)
    acc = _k5_product(x, w)
    got = _eval_encoded(encode_epilogue(tpat), acc, extras, kinds)
    want = _jax(x, w, extras, epilogue=rpat, extra_kinds=kinds)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
