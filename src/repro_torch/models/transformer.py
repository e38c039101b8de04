"""Decoder layers of the unified LM, in PyTorch.

The port of the JAX package's ``repro.models.transformer``: the ``attn``
mixer (GQA + RoPE, per-layer local/global window, logit softcap,
QK-norm), the ``mamba`` mixer (``models.ssm.mamba_mixer``) and the
``hymba`` one (attention and the Mamba mixer on the same normed input,
averaged), gated cross-attention (VLM backbone), the SwiGLU / GELU /
GEGLU MLPs and the MoE MLP (``models.moe.moe_mlp``).  A layer's
parameters live in a :class:`DecoderLayer` or :class:`CrossLayer` (a
``ParameterDict`` keyed by the JAX package's names, one layer each, not
stacked); the model's in a :class:`DecoderLM`.

Self-attention whose queries and keys are the same fresh sequence
(``forward``, and ``prefill`` into an empty cache) runs on the
flash-attention kernel K6 through ``repro_torch.kernels.ops.attention``
(its plain version for tensors on the CPU).  That is the function the
JAX package computes over its ``smax`` cache: there the keys past the
prompt carry position ``2**30`` and fall outside the causal mask, and a
global layer's window ``2**30`` admits every key, as window 0 does.
Decode and cross-attention run the port's ``layers.blockwise_attention``
(its ``chunk`` the flag ``attn_kv_chunk``), or, with the flag
``attention_impl="q_outer"`` and more than ``attn_q_chunk`` queries,
``layers.blockwise_attention_qouter``, as the JAX package chooses; a
prefill with no cache stays on K6 under that flag, since K6 already runs
in q-outer order (``models.perf_flags``).  With ``moe_impl="shard_map"``
and a mesh registered by ``perf_flags.set_mesh``, an MoE layer's MLP is
``moe.moe_mlp_shardmap``.

Sharding is injected as the JAX package injects it: an optional
``shard(x, name)`` callback (``sharding.specs.activation_shard_fn``),
applied to the residual stream (``"hidden"``) after each sublayer and
passed to the MoE MLP; the default :func:`_noshard` returns ``x``.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..device import resolve_device
from ..kernels.ops import attention
from ..kernels.sharded import constrain, divisible, is_dtensor
from .config import ArchConfig
from .layers import (FAR, apply_rope, blockwise_attention,
                     blockwise_attention_qouter, mlp_gelu, mlp_geglu,
                     mlp_swiglu, rms_norm, rope_tables)
from .moe import moe_mlp, moe_mlp_shardmap
from .perf_flags import get_flags, get_mesh
from .ssm import mamba_mixer

__all__ = ["CrossLayer", "DecoderLM", "DecoderLayer", "cast_for_compute",
           "cross_layer_body", "cross_layer_shapes",
           "init_params", "layer_body", "layer_shapes", "param_shapes",
           "params_from_reference"]

Shapes = Dict[str, Tuple[int, ...]]
ShardFn = Callable[[torch.Tensor, str], torch.Tensor]


def _noshard(x: torch.Tensor, name: str) -> torch.Tensor:
    return x

#: the matrices the JAX package casts to ``compute_dtype`` at every use;
#: norm weights and gates it reads in float32
COMPUTE_MATRICES = frozenset(("wq", "wk", "wv", "wo", "wg", "wu", "wd", "wi",
                              "wom", "embed", "lm_head"))
#: the leaves an MoE layer casts besides (every key of ``_moe_shapes``):
#: the router and the shared gate are read bfloat16-rounded in bfloat16
MOE_CAST = frozenset(("w_router", "sg", "su", "sd", "shared_gate"))
#: the Mamba leaves the ``mamba`` mixer reads in float32 (``hymba`` casts
#: none of its ``ssm_*`` leaves)
SSM_FLOAT32 = frozenset(("ssm_A_log", "ssm_D"))


def _as_used(cfg: ArchConfig, name: str, v: torch.Tensor, compute_dtype):
    """Leaf ``name`` as the JAX package reads it at every use: the
    matrices of :data:`COMPUTE_MATRICES` in ``compute_dtype``, in an MoE
    layer also those of :data:`MOE_CAST`, and in a ``mamba`` layer every
    float32 ``ssm_*`` leaf but ``A_log`` and ``D``; any other leaf as it
    is."""
    if name in COMPUTE_MATRICES or (
            cfg.moe is not None and name in MOE_CAST) or (
            cfg.mixer == "mamba" and name.startswith("ssm_") and
            name not in SSM_FLOAT32 and v.dtype == torch.float32):
        return v.to(compute_dtype)
    return v


# ---------------------------------------------------------------------------
# parameter shapes (the JAX package's, every mixer and MLP)
# ---------------------------------------------------------------------------

def _attn_shapes(cfg: ArchConfig) -> Shapes:
    d, hd = cfg.d_model, cfg.head_dim_of
    shapes = {
        "wq": (d, cfg.n_heads * hd),
        "wk": (d, cfg.n_kv * hd),
        "wv": (d, cfg.n_kv * hd),
        "wo": (cfg.n_heads * hd, d),
    }
    if cfg.qk_norm:
        shapes["q_norm"] = (hd,)
        shapes["k_norm"] = (hd,)
    return shapes


def _mlp_shapes(cfg: ArchConfig) -> Shapes:
    d, f = cfg.d_model, cfg.d_ff
    if cfg.mlp == "gelu":
        return {"wi": (d, f), "wom": (f, d)}
    return {"wg": (d, f), "wu": (d, f), "wd": (f, d)}


def _moe_shapes(cfg: ArchConfig) -> Shapes:
    moe = cfg.moe
    d = cfg.d_model
    e = moe.n_experts_padded
    shapes = {
        "w_router": (d, e),
        "wg": (e, d, moe.d_expert),
        "wu": (e, d, moe.d_expert),
        "wd": (e, moe.d_expert, d),
    }
    if moe.n_shared:
        shapes.update({
            "sg": (d, moe.d_shared), "su": (d, moe.d_shared),
            "sd": (moe.d_shared, d), "shared_gate": (d,),
        })
    return shapes


def _ssm_shapes(cfg: ArchConfig) -> Shapes:
    ssm = cfg.ssm
    d = cfg.d_model
    di = ssm.expand * d
    r = ssm.dt_rank_of(d)
    n = ssm.d_state
    return {
        "in_proj": (d, 2 * di),
        "conv_w": (ssm.d_conv, di),
        "conv_b": (di,),
        "x_proj": (di, r + 2 * n),
        "dt_proj": (r, di),
        "dt_bias": (di,),
        "A_log": (di, n),
        "D": (di,),
        "out_proj": (di, d),
    }


def layer_shapes(cfg: ArchConfig) -> Shapes:
    """Per-layer parameter shapes (without the stacked L dim)."""
    shapes: Shapes = {"ln1": (cfg.d_model,)}
    if cfg.mixer in ("attn", "hymba"):
        shapes.update(_attn_shapes(cfg))
    if cfg.mixer in ("mamba", "hymba"):
        shapes.update({f"ssm_{k}": v for k, v in _ssm_shapes(cfg).items()})
    if cfg.moe is not None:
        shapes["ln2"] = (cfg.d_model,)
        shapes.update(_moe_shapes(cfg))
    elif cfg.d_ff:
        shapes["ln2"] = (cfg.d_model,)
        shapes.update(_mlp_shapes(cfg))
    return shapes


def cross_layer_shapes(cfg: ArchConfig) -> Shapes:
    shapes = {"ln1": (cfg.d_model,), "ln2": (cfg.d_model,),
              "gate_attn": (), "gate_mlp": ()}
    shapes.update(_attn_shapes(cfg))
    shapes.update(_mlp_shapes(cfg))
    return shapes


def _n_self(cfg: ArchConfig) -> int:
    return cfg.n_self_layers if cfg.mixer != "mamba" else cfg.n_layers


def param_shapes(cfg: ArchConfig) -> dict:
    """The JAX package's parameter tree as shapes, layers stacked (L, ...)."""
    p = {
        "embed": (cfg.vocab, cfg.d_model),
        "final_norm": (cfg.d_model,),
        "layers": {k: (_n_self(cfg),) + s
                   for k, s in layer_shapes(cfg).items()},
    }
    if cfg.n_cross_layers:
        p["cross_layers"] = {k: (cfg.n_cross_layers,) + s
                             for k, s in cross_layer_shapes(cfg).items()}
    if not cfg.tie_embeddings:
        p["lm_head"] = (cfg.d_model, cfg.vocab)
    return p


# ---------------------------------------------------------------------------
# parameter modules
# ---------------------------------------------------------------------------

def _param(t: torch.Tensor) -> nn.Parameter:
    # no autograd graph is built through the weights unless a train step
    # gives them Parameters that require a gradient (``models.tree``)
    return t if isinstance(t, nn.Parameter) else \
        nn.Parameter(t, requires_grad=False)


class DecoderLayer(nn.ParameterDict):
    """One self-attention decoder layer's parameters, keyed by the JAX
    package's names (``layer_shapes``)."""


class CrossLayer(nn.ParameterDict):
    """One gated cross-attention layer's parameters
    (``cross_layer_shapes``)."""


class DecoderLM(nn.Module):
    """The model's parameters: ``embed``, ``final_norm``, ``lm_head``
    (untied configurations only), ``layers`` (self-attention layers in
    order) and ``cross_layers`` (one every ``cfg.cross_attn_every``)."""

    def __init__(self, embed: torch.Tensor, final_norm: torch.Tensor,
                 layers, cross_layers=(),
                 lm_head: Optional[torch.Tensor] = None):
        super().__init__()
        self.embed = _param(embed)
        self.final_norm = _param(final_norm)
        self.lm_head = None if lm_head is None else _param(lm_head)
        self.layers = nn.ModuleList(layers)
        self.cross_layers = nn.ModuleList(cross_layers)


def _build(cfg: ArchConfig, leaf) -> DecoderLM:
    """A :class:`DecoderLM` whose tensors ``leaf(path, name, shape)``
    makes; ``path`` is ``("layers", i)``, ``("cross_layers", i)`` or
    ``()``."""
    shapes = layer_shapes(cfg)
    layers = [DecoderLayer({k: _param(leaf(("layers", i), k, s))
                            for k, s in sorted(shapes.items())})
              for i in range(_n_self(cfg))]
    cshapes = cross_layer_shapes(cfg)
    cross = [CrossLayer({k: _param(leaf(("cross_layers", i), k, s))
                         for k, s in sorted(cshapes.items())})
             for i in range(cfg.n_cross_layers)]
    head = None if cfg.tie_embeddings else \
        leaf((), "lm_head", (cfg.d_model, cfg.vocab))
    return DecoderLM(leaf((), "embed", (cfg.vocab, cfg.d_model)),
                     leaf((), "final_norm", (cfg.d_model,)), layers, cross,
                     head)


def init_params(cfg: ArchConfig, generator: Optional[torch.Generator] = None,
                *, dtype=torch.float32, device="cuda") -> DecoderLM:
    """Random init by the rules the JAX package's ``init_params`` applies
    (its draws are threefry's, these ``generator``'s): norms and the q/k
    norms are ones, gates (names starting ``gate``) are zero,
    ``ssm_A_log`` is ``log(1..N)`` on every channel, and every other leaf
    is normal times ``1/sqrt(fan_in)``, ``fan_in`` the second-to-last dim
    of the leaf as the JAX package stacks it, (L, ...) for a layer's: of
    an embedding, the vocabulary; of a layer's vector (``ssm_D``,
    ``ssm_conv_b``, ``ssm_dt_bias``: their ``ssm_`` names miss the JAX
    package's list of ones; and ``shared_gate``, which is no ``gate*``)
    the layer count L; of ``ssm_conv_w`` the kernel width; of the
    experts' ``wg``/``wu`` (L, E, d, f) d, of ``wd`` f.  Each leaf is
    drawn in float32 and then cast to ``dtype``."""
    dev = resolve_device(device)
    depth = {"layers": _n_self(cfg), "cross_layers": cfg.n_cross_layers}

    def leaf(path, name, shape):
        if name.startswith("ln") or name in ("final_norm", "q_norm",
                                             "k_norm"):
            return torch.ones(shape, dtype=dtype, device=dev)
        if name.endswith("A_log"):
            n = torch.arange(1, shape[-1] + 1, dtype=torch.float32,
                             device=dev)
            return torch.log(n).expand(shape).contiguous().to(dtype)
        if name.startswith("gate"):
            return torch.zeros(shape, dtype=dtype, device=dev)
        stacked = ((depth[path[0]],) if path else ()) + tuple(shape)
        fan_in = stacked[-2] if len(stacked) >= 2 else stacked[-1]
        w = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=dev)
        return (w * (1.0 / math.sqrt(max(1, fan_in)))).to(dtype)

    return _build(cfg, leaf)


def _to_torch(a, dev: torch.device) -> torch.Tensor:
    """A numpy array (``ml_dtypes`` bfloat16 included), copied to ``dev``
    in its own dtype."""
    a = np.array(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16) \
            .to(dev)
    return torch.from_numpy(a).to(dev)


def params_from_reference(cfg: ArchConfig, tree: dict, *,
                          device="cuda") -> DecoderLM:
    """The port's modules holding the JAX package's parameter tree: nested
    dicts of numpy arrays, layers stacked (L, ...) as ``param_shapes``
    gives them.  Values and dtypes are kept."""
    dev = resolve_device(device)
    want = param_shapes(cfg)
    got = {}
    for key, shape in want.items():
        group = shape if isinstance(shape, dict) else {None: shape}
        src = tree[key] if isinstance(shape, dict) else {None: tree[key]}
        for name, sh in group.items():
            if tuple(np.shape(src[name])) != sh:
                raise ValueError(f"{key}/{name}: shape "
                                 f"{tuple(np.shape(src[name]))}, expected "
                                 f"{sh}")
            got[key, name] = _to_torch(src[name], dev)

    def leaf(path, name, shape):
        return got[path[0], name][path[1]] if path else got[name, None]

    return _build(cfg, leaf)


def cast_for_compute(params: DecoderLM, cfg: ArchConfig,
                     compute_dtype) -> DecoderLM:
    """A :class:`DecoderLM` holding a ``compute_dtype`` copy, made once, of
    exactly the leaves the JAX package casts at every use (the matrices,
    an MoE layer's router, shared experts and shared gate, and a
    ``mamba`` layer's float32 ``ssm_*`` leaves but ``A_log`` and ``D``);
    norm weights, gates and the leaves a ``hymba`` layer reads uncast are
    shared, in their own dtype, and so is a leaf already in
    ``compute_dtype`` (no second copy).  The values equal a cast at every
    use."""
    def cast(d):
        return {k: _as_used(cfg, k, v, compute_dtype) for k, v in d.items()}
    return DecoderLM(
        params.embed.to(compute_dtype), params.final_norm,
        [DecoderLayer({k: _param(v) for k, v in cast(lp).items()})
         for lp in params.layers],
        [CrossLayer({k: _param(v) for k, v in cast(lp).items()})
         for lp in params.cross_layers],
        None if params.lm_head is None else
        params.lm_head.to(compute_dtype))


# ---------------------------------------------------------------------------
# layer bodies
# ---------------------------------------------------------------------------

def _attention(x, lp, cfg: ArchConfig, *, q_pos, is_global: bool,
               kv_override=None, cache=None, cache_len: Optional[int] = None,
               compute_dtype=torch.bfloat16, shard: ShardFn = _noshard):
    """Self/cross attention.  Returns (out, cache).

    ``cache`` is a layer's (k, v) of (B, Smax, Hkv, hd); the fresh keys and
    values are written into it in place at ``cache_len``."""
    b, s, d = x.shape
    hd = cfg.head_dim_of
    hq, hkv = cfg.n_heads, cfg.n_kv
    # a DTensor's heads dim must split evenly over its ranks
    q = divisible(torch.matmul(x, lp["wq"].to(compute_dtype)), -1, hq
                  ).reshape(b, s, hq, hd)
    if kv_override is not None:
        src = kv_override
        src_pos = torch.arange(src.shape[1], dtype=torch.int32,
                               device=x.device)[None].expand(b, -1)
        causal = False
    else:
        src = x
        src_pos = q_pos
        causal = True
    k = divisible(torch.matmul(src, lp["wk"].to(compute_dtype)), -1, hkv
                  ).reshape(b, -1, hkv, hd)
    v = divisible(torch.matmul(src, lp["wv"].to(compute_dtype)), -1, hkv
                  ).reshape(b, -1, hkv, hd)
    if cfg.qk_norm:
        q = rms_norm(q, lp["q_norm"], cfg.norm_eps)
        k = rms_norm(k, lp["k_norm"], cfg.norm_eps)
    if kv_override is None:                         # RoPE on self-attn only
        cos_q, sin_q = rope_tables(q_pos, hd, cfg.rope_theta)
        cos_k, sin_k = rope_tables(src_pos, hd, cfg.rope_theta)
        q = apply_rope(q, cos_q, sin_q)
        k = apply_rope(k, cos_k, sin_k)

    win = cfg.window if cfg.window and not is_global else 0
    if cache is not None:
        k_cache, v_cache = cache
        k = k.to(k_cache.dtype)
        v = v.to(v_cache.dtype)
        k_cache[:, cache_len:cache_len + s] = k
        v_cache[:, cache_len:cache_len + s] = v

    if kv_override is None and not cache_len:
        # the queries' own keys, none cached before them: K6
        out = attention(q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2), causal=True, window=win,
                        softcap=cfg.attn_softcap, scale=cfg.attn_scale,
                        device=q.device).transpose(1, 2)
    else:
        kv_pos = src_pos
        if cache is not None:                       # decode: the whole cache
            k, v = cache
            smax = k.shape[1]
            pos = torch.arange(smax, dtype=torch.int32, device=x.device)
            kv_pos = torch.where(pos <= cache_len + s - 1, pos,
                                 FAR)[None].expand(b, smax)
        flags = get_flags()
        kw = dict(q_pos=q_pos, kv_pos=kv_pos, causal=causal,
                  window=win or None, softcap=cfg.attn_softcap,
                  scale=cfg.attn_scale)
        if flags.attention_impl == "q_outer" and s > flags.attn_q_chunk:
            out = blockwise_attention_qouter(
                q, k, v, q_chunk=flags.attn_q_chunk,
                kv_chunk=flags.attn_kv_chunk, **kw)
        else:
            out = blockwise_attention(q, k, v, chunk=flags.attn_kv_chunk,
                                      **kw)
    out = out.reshape(b, s, hq * hd)
    if is_dtensor(out):
        # its gradient placed as the heads were: a shard of hq * hd that
        # splits no head (wo's backward gives one that may)
        out = constrain(out, out.placements)
    out = torch.matmul(out, lp["wo"].to(compute_dtype))
    return out, cache


def _mlp(x, lp, cfg: ArchConfig, compute_dtype=torch.bfloat16,
         shard: ShardFn = _noshard):
    if cfg.moe is not None:
        mp = {k: lp[k].to(compute_dtype) for k in _moe_shapes(cfg) if k in lp}
        if get_flags().moe_impl == "shard_map" and get_mesh() is not None:
            mesh, bp_axes = get_mesh()
            return moe_mlp_shardmap(x, mp, cfg.moe, mesh, bp_axes)
        if shard is _noshard:          # the MoE MLP's own call, unplaced
            return moe_mlp(x, mp, cfg.moe)
        return moe_mlp(x, mp, cfg.moe, shard=shard)
    if not cfg.d_ff:
        return torch.zeros_like(x)
    if cfg.mlp == "gelu":
        return mlp_gelu(x, lp["wi"].to(compute_dtype),
                        lp["wom"].to(compute_dtype))
    fn = mlp_geglu if cfg.mlp == "geglu" else mlp_swiglu
    return fn(x, lp["wg"].to(compute_dtype), lp["wu"].to(compute_dtype),
              lp["wd"].to(compute_dtype))


def layer_body(x, lp, cfg: ArchConfig, *, q_pos, is_global: bool,
               cache=None, cache_len: Optional[int] = None, ssm_state=None,
               return_state: bool = False, compute_dtype=torch.bfloat16,
               shard: ShardFn = _noshard):
    """One decoder layer.  Returns (x, cache, new SSM state): the state
    (``{"conv", "h"}``) when the layer has the Mamba mixer and
    ``ssm_state`` is given (decode) or ``return_state`` is set (prefill,
    from a zero state), else None."""
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    new_cache = new_state = None
    if cfg.mixer != "mamba":
        mix, new_cache = _attention(
            h, lp, cfg, q_pos=q_pos, is_global=is_global, cache=cache,
            cache_len=cache_len, compute_dtype=compute_dtype, shard=shard)
    if cfg.mixer != "attn":
        sp = {k[len("ssm_"):]: _as_used(cfg, k, v, compute_dtype)
              for k, v in lp.items() if k.startswith("ssm_")}
        want = return_state or ssm_state is not None
        out = mamba_mixer(h, sp, cfg.ssm, state=ssm_state, return_state=want)
        ssm_out, new_state = out if want else (out, None)
        # hymba: the two heads on the same normed input, averaged
        mix = ssm_out if cfg.mixer == "mamba" else 0.5 * (mix + ssm_out)
    x = shard(x + mix.to(x.dtype), "hidden")
    if "ln2" in lp:                           # attn-free mamba: no MLP
        h2 = rms_norm(x, lp["ln2"], cfg.norm_eps)
        x = x + _mlp(h2, lp, cfg, compute_dtype, shard).to(x.dtype)
        x = shard(x, "hidden")
    return x, new_cache, new_state


def cross_layer_body(x, lp, cfg: ArchConfig, enc, *, q_pos,
                     compute_dtype=torch.bfloat16, shard: ShardFn = _noshard):
    """Gated cross-attention layer (llama-3.2-vision style)."""
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    attn, _ = _attention(h, lp, cfg, q_pos=q_pos, is_global=True,
                         kv_override=enc, compute_dtype=compute_dtype,
                         shard=shard)
    x = x + torch.tanh(lp["gate_attn"]).to(x.dtype) * attn.to(x.dtype)
    h2 = rms_norm(x, lp["ln2"], cfg.norm_eps)
    return shard(x + torch.tanh(lp["gate_mlp"]).to(x.dtype) * _mlp(
        h2, lp, cfg, compute_dtype).to(x.dtype), "hidden")
