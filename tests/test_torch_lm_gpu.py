"""The LM substrate on the card against the port's own CPU run.

Run on a machine with an NVIDIA Hopper card:
``PYTHONPATH=src python -m pytest -m gpu tests/test_torch_lm_gpu.py``.
Each test decides inside itself whether a card exists and skips with a
reason when none does; the file imports nothing of the JAX package.
Tolerance: rtol = atol = 1e-4 in float32 (K6 is 3xTF32, cuBLAS float32
products are not TF32, K7 sums the states in another order), greedy
tokens equal.  ``chip_smoke.py`` phases 10 and 11 run :func:`card_vs_cpu`
on every arch too, phase 12 :func:`moe_layer_card_vs_cpu`, and phase 15
:func:`train_card_vs_cpu` on every arch and :func:`trainer_fault_run`.
"""

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention, mamba_scan
from repro_torch.kernels.mamba_scan import mamba_scan_plain
from repro_torch.models import decode_step, forward, init_params, prefill
from repro_torch.models.moe import (capacity_of, dispatch, moe_mlp,
                                    router_topk)
from repro_torch.models.transformer import _moe_shapes
from repro_torch.models.tree import leaves, tree_map
from repro_torch.serve.lm_engine import Request, ServeEngine
from repro_torch.train import (AdamWConfig, Trainer, TrainerConfig,
                               adamw_update, build_train_step,
                               init_opt_state)
from repro_torch.checkpoint import latest_step
from repro_torch.data import DataConfig

pytestmark = pytest.mark.gpu

ARCHS = ["llama3.2-1b", "deepseek-coder-33b", "gemma2-27b", "gemma3-27b",
         "musicgen-large", "llama-3.2-vision-90b", "falcon-mamba-7b",
         "hymba-1.5b", "qwen2-moe-a2.7b", "qwen3-moe-235b-a22b"]
TOL = 1e-4
#: two router probabilities this close (the k-th and the (k+1)-th of a
#: token) may be taken in either order on the card and on the CPU
MOE_TIE = 1e-6


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (none on this host)")


def _both(cfg, seed=0, dev="cuda"):
    return [init_params(cfg, torch.Generator().manual_seed(seed),
                        device="cpu").to(d) for d in ("cpu", dev)]


def _inputs(cfg, b=2, s=24, seed=0):
    rng = np.random.default_rng(seed)
    if cfg.input_mode == "embeddings":
        toks = rng.normal(size=(b, s, cfg.d_model)).astype(np.float32)
    else:
        toks = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    enc = (rng.normal(size=(b, cfg.encoder_len, cfg.d_model))
           .astype(np.float32) if cfg.n_cross_layers else None)
    return toks, enc


def card_vs_cpu(arch, dev="cuda"):
    """``arch`` at ``.reduced()`` in float32 on the card and on the CPU
    from one set of weights: forward, prefill and 4 decode steps; the
    prompt (20) is longer than the reduced window (16), so local layers
    mask.  Asserts every logit and cache leaf finite and within
    :data:`TOL`, and K6 launched once a self-attention layer and K7 once a
    Mamba mixer layer in forward and in prefill and never in decode;
    returns the largest |card - CPU|."""
    cfg = get_config(arch).reduced()
    cpu, card = _both(cfg, dev=dev)
    toks, enc = _inputs(cfg)
    kw = dict(enc=enc, compute_dtype=torch.float32)
    worst = 0.0

    def close(got, want, what):
        nonlocal worst
        got, want = got.float().cpu(), want.float()
        assert bool(torch.isfinite(got).all()), what
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=TOL,
                                   atol=TOL, err_msg=f"{arch}: {what}")
        worst = max(worst, float((got - want).abs().max()))

    k6 = 0 if cfg.mixer == "mamba" else 2 * cfg.n_self_layers
    k7 = 0 if cfg.mixer == "attn" else 2 * cfg.n_layers
    flash_attention.launches = mamba_scan.launches = 0
    close(forward(card, cfg, toks, **kw), forward(cpu, cfg, toks, **kw),
          "forward")
    lc, cc = prefill(card, cfg, toks[:, :20], smax=32, **kw)
    lh, ch = prefill(cpu, cfg, toks[:, :20], smax=32, **kw)
    assert (flash_attention.launches, mamba_scan.launches) == (k6, k7)
    close(lc, lh, "prefill")
    for key in sorted(ch):
        if key != "len":
            close(cc[key], ch[key], f"prefill cache {key}")
    for t in range(20, 24):
        lc, cc = decode_step(card, cfg, toks[:, t], cc,
                             compute_dtype=torch.float32)
        lh, ch = decode_step(cpu, cfg, toks[:, t], ch,
                             compute_dtype=torch.float32)
        close(lc, lh, f"decode step {t}")
    for key in sorted(ch):
        if key != "len":
            close(cc[key], ch[key], f"decoded cache {key}")
    assert (flash_attention.launches, mamba_scan.launches) == (k6, k7)
    return worst


@pytest.mark.parametrize("arch", ARCHS)
def test_card_equals_cpu(arch):
    _need_card()
    card_vs_cpu(arch)


def test_served_run_card_equals_cpu():
    """A 2-slot served run of 4 requests: K6 once a layer a prefill,
    tokens equal to the CPU run's."""
    _need_card()
    cfg = get_config("llama3.2-1b").reduced(n_layers=2, d_model=128,
                                            d_ff=256, vocab=512)
    cpu, card = _both(cfg)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, 32, dtype=np.int32)
               for _ in range(4)]
    outs = []
    for params, dev in ((card, "cuda"), (cpu, "cpu")):
        eng = ServeEngine(cfg, params, slots=2, smax=64,
                          compute_dtype=torch.float32, device=dev)
        for rid, p in enumerate(prompts):
            eng.submit(Request(rid, p, max_new=8))
        flash_attention.launches = 0
        outs.append(eng.run())
        if dev == "cuda":
            assert flash_attention.launches == 4 * cfg.n_layers
    assert outs[0] == outs[1]
    assert all(len(t) == 8 for t in outs[0].values())


@pytest.mark.parametrize("s", [13, 509])
@pytest.mark.parametrize("with_h0", [False, True])
def test_k7_state_equals_plain(s, with_h0):
    """K7 with ``h_out`` (and from ``h0``) against its plain version at
    the falcon-mamba-7b widths (d_inner 8192, d_state 16) cut to 256
    channels, at S not a multiple of K7's 4-step chunk: ``h_last`` is the
    state after step S-1, not after the padded chunk."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(s)
    shape = (2, s, 256, 16)
    a = torch.rand(shape, generator=gen, device="cuda") * 0.399 + 0.6
    bx = torch.randn(shape, generator=gen, device="cuda") * 0.1
    c = torch.randn((2, s, 16), generator=gen, device="cuda")
    h0 = torch.randn((2, 256, 16), generator=gen, device="cuda") \
        if with_h0 else None
    launches = mamba_scan.launches
    y, h = mamba_scan(a, bx, c, h0=h0, return_state=True)
    torch.cuda.synchronize()
    assert mamba_scan.launches == launches + 1
    want_y, want_h = mamba_scan_plain(a, bx, c, h0=h0, return_state=True)
    assert h.shape == (2, 256, 16) and h.dtype == torch.float32
    # one multiply and one add a step, as the plain version: h bit for bit
    assert torch.equal(h, want_h)
    np.testing.assert_allclose(y.cpu().numpy(), want_y.cpu().numpy(),
                               rtol=TOL, atol=TOL)
    assert torch.equal(mamba_scan(a, bx, c, h0=h0), y)


def moe_layer_card_vs_cpu(arch="qwen2-moe-a2.7b", s=512, dev="cuda",
                          seed=0):
    """One MoE layer of ``arch`` at full width in float32, card against
    CPU: the same weights (drawn by ``init_params``'s rule) and a
    ``s``-token input through ``moe_mlp`` on both.  The expert ids must be
    equal but for tokens whose k-th and (k+1)-th probabilities lie within
    :data:`MOE_TIE` (those must be under 1% of the tokens); on every token
    before a row's first differing id the drops must be equal and the
    output's relative error norm at most :data:`TOL`.  Returns (near ties,
    tokens whose ids differ, entries dropped, relative error norm)."""
    cfg = get_config(arch)
    moe = cfg.moe
    gen = torch.Generator().manual_seed(seed)
    cpu = {}
    for name, shape in sorted(_moe_shapes(cfg).items()):
        fan_in = shape[-2] if len(shape) >= 2 else cfg.n_layers
        cpu[name] = torch.randn(shape, generator=gen) / fan_in ** 0.5
    x = torch.randn((1, s, cfg.d_model), generator=gen)
    card = {k: v.to(dev) for k, v in cpu.items()}
    xc = x.to(dev)
    e_pad = cpu["w_router"].shape[1]
    cap = capacity_of(s, moe)
    ids_h = router_topk(x, cpu["w_router"], moe)[1]
    ids_c = router_topk(xc, card["w_router"], moe)[1].cpu()
    probs = torch.softmax(x @ cpu["w_router"][:, :moe.n_experts], -1)
    top = torch.sort(probs, -1, descending=True).values
    near = (top[..., moe.top_k - 1] - top[..., moe.top_k]) < MOE_TIE
    differ = (ids_h != ids_c).any(-1)
    assert not bool((differ & ~near).any()), "ids differ away from a tie"
    assert int(near.sum()) <= s // 100, f"{int(near.sum())} near ties"
    # tokens before a row's first differing id are dispatched alike
    same = torch.cumsum(differ.int(), -1) == 0
    keep_h = dispatch(ids_h, e_pad, cap)[1].reshape(1, s, moe.top_k)
    keep_c = dispatch(ids_c, e_pad, cap)[1].reshape(1, s, moe.top_k)
    assert torch.equal(keep_h[same], keep_c[same])
    y_h = moe_mlp(x, cpu, moe)
    y_c = moe_mlp(xc, card, moe).cpu()
    assert y_c.shape == y_h.shape and bool(torch.isfinite(y_c).all())
    d = (y_c[same].double() - y_h[same].double()).norm()
    rel = float(d / y_h[same].double().norm())
    assert rel <= TOL, f"relative error norm {rel}"
    return int(near.sum()), int(differ.sum()), int((~keep_h).sum()), rel


def test_moe_layer_card_equals_cpu():
    _need_card()
    assert not torch.backends.cuda.matmul.allow_tf32
    moe_layer_card_vs_cpu()


def train_card_vs_cpu(arch, dev="cuda"):
    """``arch`` at ``.reduced()`` in float32, one train step on the card
    and on the CPU from one set of weights and one batch of 24 tokens
    (longer than the reduced window): the loss, the gradient norm, the
    learning rate, every leaf's gradient, updated value and moments
    within :data:`TOL`, each leaf's moments also by relative error norm,
    and K6 launched once a self-attention layer and K7 once a Mamba mixer
    layer, all in the forward (their backward is the plain version).  The
    learning rate is small (1e-5 at step 1), so that a gradient's sign
    flipped by roundoff near zero moves a leaf by less than the
    tolerance; the update itself is compared by relative error norm with
    each device's gradients through an optimizer at eps 1e-2 and lr 0.05,
    where it is about lr g / eps, smooth in g.  Returns the largest |card
    - CPU| over the leaves' gradients."""
    cfg = get_config(arch).reduced()
    cpu, card = _both(cfg, dev=dev)
    toks, enc = _inputs(cfg)
    targets = np.random.default_rng(1).integers(0, cfg.vocab, toks.shape[:2])
    batch = {"inputs": toks, "targets": targets.astype(np.int32)}
    if enc is not None:
        batch["enc"] = enc
    opt_cfg = AdamWConfig(lr_peak=1e-5, warmup_steps=1, total_steps=10,
                          moment_dtype=torch.float32)
    out = {}
    for name, params in (("cpu", cpu), ("card", card)):
        seen = {}

        def capture(g, seen=seen):
            seen["g"] = g
            return g
        step = build_train_step(cfg, opt_cfg, compute_dtype=torch.float32,
                                grad_transform=capture)
        flash_attention.launches = mamba_scan.launches = 0
        new, opt, metrics = step(params, init_opt_state(params, opt_cfg),
                                 batch)
        out[name] = (new, opt, metrics, seen["g"],
                     (flash_attention.launches, mamba_scan.launches))
    k6 = 0 if cfg.mixer == "mamba" else cfg.n_self_layers
    k7 = 0 if cfg.mixer == "attn" else cfg.n_layers
    if torch.device(dev).type != "cuda":      # plain versions: no launch
        k6 = k7 = 0
    assert out["card"][4] == (k6, k7), f"{arch}: launches {out['card'][4]}"
    assert out["cpu"][4] == (0, 0)
    for k in ("loss", "grad_norm", "lr"):
        got, want = float(out["card"][2][k]), float(out["cpu"][2][k])
        assert np.isfinite(got), f"{arch}: {k}"
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL,
                                   err_msg=f"{arch}: {k}")
    worst = 0.0
    for what, i in (("gradient", 3), ("updated", 0), ("m", 1), ("v", 1)):
        tree_c, tree_h = out["card"][i], out["cpu"][i]
        if what in ("m", "v"):
            tree_c, tree_h = getattr(tree_c, what), getattr(tree_h, what)
        for a, b in zip(leaves(tree_c), leaves(tree_h)):
            got, want = a.value.detach().cpu(), b.value.detach()
            assert bool(torch.isfinite(got).all()), f"{arch}: {what}"
            np.testing.assert_allclose(
                got.numpy(), want.numpy(), rtol=TOL, atol=TOL,
                err_msg=f"{arch}: {what} {a.name}[{a.index}]")
            if what == "gradient":
                worst = max(worst, float((got - want).abs().max()))
    assert max(float(b.value.abs().max()) for b in leaves(out["cpu"][3])) \
        > 0, f"{arch}: all gradients zero"
    smooth = AdamWConfig(lr_peak=0.1, warmup_steps=2, total_steps=10,
                         eps=1e-2, moment_dtype=torch.float32)
    for name, params in (("cpu", cpu), ("card", card)):
        new, opt, _ = adamw_update(params, out[name][3],
                                   init_opt_state(params, smooth), smooth)
        out[name] += (tree_map(torch.sub, new, params), opt.v)
    for what, i in (("m", 1), ("v", 1), ("update", 5), ("v at eps 1e-2", 6)):
        tree_c, tree_h = out["card"][i], out["cpu"][i]
        if what in ("m", "v"):
            tree_c, tree_h = getattr(tree_c, what), getattr(tree_h, what)
        for a, b in zip(leaves(tree_c), leaves(tree_h)):
            got, want = a.value.detach().cpu().double(), b.value.double()
            ref = float(torch.linalg.vector_norm(want))
            rel = float(torch.linalg.vector_norm(got - want)) / (ref or 1.0)
            assert rel <= TOL, \
                f"{arch}: {what} {a.name}[{a.index}] relative {rel:.3e}"
    return worst


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_card_equals_cpu(arch):
    _need_card()
    assert not torch.backends.cuda.matmul.allow_tf32
    train_card_vs_cpu(arch)


def trainer_fault_run(ckpt_dir, dev="cuda"):
    """``tests/test_train_substrate.py::test_trainer_fault_injection_resumes``
    on ``dev``, at its dims (one layer, d_model 32, d_ff 64, vocab 64; 20
    steps of batch 2 x 16 tokens, a checkpoint every 5, a fault at step
    12): one restart, step 20 reached, latest checkpoint 20.  Returns the
    trainer."""
    cfg = get_config("llama3.2-1b").reduced(n_layers=1, d_model=32,
                                            d_ff=64, vocab=64)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    opt_cfg = AdamWConfig(lr_peak=1e-3, warmup_steps=2, total_steps=20)
    tr = Trainer(TrainerConfig(total_steps=20, ckpt_every=5,
                               ckpt_dir=str(ckpt_dir), log_every=5,
                               data_timeout_s=120.0),
                 build_train_step(cfg, opt_cfg), params,
                 init_opt_state(params, opt_cfg),
                 DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=2),
                 device=dev)
    state = tr.run(fail_at=12)
    assert (state.restarts, state.step) == (1, 20)
    assert latest_step(str(ckpt_dir)) == 20
    assert all(np.isfinite(h["loss"]) for h in tr.history)
    return tr


def test_trainer_fault_injection_on_card(tmp_path):
    _need_card()
    trainer_fault_run(tmp_path)
