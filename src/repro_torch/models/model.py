"""Model-level entry points: forward / prefill / decode_step.

The port of the JAX package's ``repro.models.model``, with its signatures,
the ``shard`` callback included (``sharding.specs.activation_shard_fn``;
the default returns its argument): the residual stream is placed under
``"hidden"`` after the embedding and each sublayer, ``forward``'s logits
under ``"logits"``, as the JAX package places them.  Layers run in a Python loop over
``params.layers``; VLM backbones run groups of ``cross_attn_every - 1``
self-attention layers, each followed by one cross-attention layer.  The
entry points run where ``params`` lie; tokens (or, for
``input_mode="embeddings"``, embeddings) may be numpy arrays or tensors.

``decode_step`` writes the new token's keys and values into the cache's
tensors in place and returns a new dict holding them (the JAX package
returns fresh arrays); the Mamba state (``ssm_conv``, ``ssm_h``) it
replaces by the layers' new states, stacked, in the dtype the mixer gave
them, as the JAX package's ``lax.scan`` outputs (``hymba`` cuts its conv
window from float32 activations: its ``ssm_conv`` turns float32 after a
``prefill`` or a ``decode_step``, though ``init_cache`` makes it in the
compute dtype).  ``cache["len"]`` is a 0-d int32 tensor on the host, as
the JAX package's is an int32 scalar; the Mamba mixer reads no position.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..kernels.sharded import batch_only, divisible, is_dtensor
from .config import ArchConfig
from .layers import blockwise_attention, rms_norm, soft_cap
from .transformer import (DecoderLM, ShardFn, _mlp, _n_self, _noshard,
                          _to_torch, cross_layer_body, layer_body)

__all__ = ["cache_from_reference", "cache_shapes", "cache_to_numpy",
           "decode_step", "forward", "init_cache", "prefill"]


def _embed(params: DecoderLM, cfg: ArchConfig, tokens_or_embeds,
           compute_dtype) -> torch.Tensor:
    dev = params.embed.device
    if cfg.input_mode == "embeddings":
        x = torch.as_tensor(tokens_or_embeds, device=dev).to(compute_dtype)
    else:
        toks = torch.as_tensor(tokens_or_embeds, device=dev).long()
        if is_dtensor(params.embed):
            # the vocab-parallel lookup DTensor has strategies for, forward
            # and backward (its index_put backward fails in some versions),
            # its masked partial sums reduced at once
            x = F.embedding(toks, params.embed)
            x = x.redistribute(x.device_mesh, batch_only(x.placements))
            x = x.to(compute_dtype)
        else:
            x = params.embed[toks].to(compute_dtype)
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=compute_dtype)
    return x


def _unembed(params: DecoderLM, cfg: ArchConfig, x) -> torch.Tensor:
    x = rms_norm(x, params.final_norm, cfg.norm_eps)
    if params.lm_head is None:
        logits = torch.matmul(x, params.embed.to(x.dtype).t())
    else:
        logits = torch.matmul(x, params.lm_head.to(x.dtype))
    if cfg.final_softcap:
        logits = soft_cap(logits.float(), cfg.final_softcap)
    return logits


def _positions(b: int, s: int, start: int, dev) -> torch.Tensor:
    return torch.arange(start, start + s, dtype=torch.int32,
                        device=dev)[None].expand(b, s)


def _groups(cfg: ArchConfig):
    """(index of each self-attention layer, its global flag, the cross
    layer after it or None), in order."""
    kinds = cfg.layer_kinds()
    g = cfg.cross_attn_every - 1 if cfg.n_cross_layers else 0
    for i, kind in enumerate(kinds):
        cross = (i + 1) // g - 1 if g and (i + 1) % g == 0 else None
        yield i, bool(kind), cross


def _enc(params: DecoderLM, enc, compute_dtype):
    return torch.as_tensor(enc, device=params.embed.device).to(compute_dtype)


def _placed_like(cache, x):
    """``cache`` as ``x`` is placed: for a ``DTensor`` residual stream x
    (B, S, d), every leaf but ``len`` a ``DTensor`` with its batch dim
    (1) sharded as x's dim 0, the rest replicated; else ``cache``."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not isinstance(x, DTensor):
        return cache
    from torch.distributed.tensor import distribute_tensor
    pl = [Shard(1) if p == Shard(0) else Replicate() for p in x.placements]
    return {k: v if k == "len" else distribute_tensor(v, x.device_mesh, pl)
            for k, v in cache.items()}


def _layer_cache(cache, i: int):
    """Layer ``i``'s (k, v) cache, or None for an attention-free model."""
    return (cache["k"][i], cache["v"][i]) if "k" in cache else None


def _set_ssm_state(cache, states) -> None:
    """The layers' new Mamba states into ``cache``, stacked (L, B, ...)."""
    if states:
        cache["ssm_conv"] = torch.stack([st["conv"] for st in states])
        cache["ssm_h"] = torch.stack([st["h"] for st in states])


# ---------------------------------------------------------------------------
# forward (teacher-forced logits)
# ---------------------------------------------------------------------------

def forward(params: DecoderLM, cfg: ArchConfig, tokens, *,
            enc=None, compute_dtype=torch.bfloat16,
            return_hidden: bool = False,
            shard: ShardFn = _noshard) -> torch.Tensor:
    b, s = tokens.shape[:2]
    x = shard(_embed(params, cfg, tokens, compute_dtype), "hidden")
    q_pos = _positions(b, s, 0, x.device)
    enc_c = _enc(params, enc, compute_dtype) if cfg.n_cross_layers else None
    for i, is_global, cross in _groups(cfg):
        x, _, _ = layer_body(x, params.layers[i], cfg, q_pos=q_pos,
                             is_global=is_global, compute_dtype=compute_dtype,
                             shard=shard)
        if cross is not None:
            x = cross_layer_body(x, params.cross_layers[cross], cfg, enc_c,
                                 q_pos=q_pos, compute_dtype=compute_dtype,
                                 shard=shard)
    if return_hidden:
        return x
    return shard(_unembed(params, cfg, x), "logits")


# ---------------------------------------------------------------------------
# prefill: run the prompt, return caches sized `smax`
# ---------------------------------------------------------------------------

def cache_shapes(cfg: ArchConfig, batch: int, smax: int,
                 dtype=torch.bfloat16) -> Dict[str, tuple]:
    """``{name: (shape, dtype)}`` of :func:`init_cache`'s leaves."""
    n_self = _n_self(cfg)
    hd = cfg.head_dim_of
    out = {"len": ((), torch.int32)}
    if cfg.mixer in ("attn", "hymba"):
        out["k"] = ((n_self, batch, smax, cfg.n_kv, hd), dtype)
        out["v"] = out["k"]
    if cfg.mixer in ("mamba", "hymba"):
        di = cfg.ssm.expand * cfg.d_model
        kw = max(cfg.ssm.d_conv - 1, 1)
        out["ssm_conv"] = ((n_self, batch, kw, di), dtype)
        out["ssm_h"] = ((n_self, batch, di, cfg.ssm.d_state), torch.float32)
    if cfg.n_cross_layers:
        out["cross_k"] = ((cfg.n_cross_layers, batch, cfg.encoder_len,
                           cfg.n_kv, hd), dtype)
        out["cross_v"] = out["cross_k"]
    return out


def init_cache(cfg: ArchConfig, batch: int, smax: int,
               dtype=torch.bfloat16, *, device="cuda") -> Dict[str, Any]:
    """Zeroed caches on ``device`` (``"meta"`` allowed: shapes only);
    ``len`` is a 0-d int32 tensor on the host."""
    device = torch.device(device) if str(device) == "meta" else \
        resolve_device(device)
    cache: Dict[str, Any] = {}
    for key, (shape, dt) in cache_shapes(cfg, batch, smax, dtype).items():
        cache[key] = torch.zeros(shape, dtype=dt,
                                 device="cpu" if key == "len" else device)
    return cache


def prefill(params: DecoderLM, cfg: ArchConfig, tokens, *, smax: int,
            enc=None, compute_dtype=torch.bfloat16,
            shard: ShardFn = _noshard
            ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Returns (last-position logits (B, V), filled caches)."""
    b, s = tokens.shape[:2]
    x = shard(_embed(params, cfg, tokens, compute_dtype), "hidden")
    q_pos = _positions(b, s, 0, x.device)
    cache = _placed_like(init_cache(cfg, b, smax, compute_dtype,
                                    device=x.device), x)
    enc_c = _enc(params, enc, compute_dtype) if cfg.n_cross_layers else None
    hd = cfg.head_dim_of
    has_ssm = cfg.mixer != "attn"
    states = []
    for i, is_global, cross in _groups(cfg):
        # the Mamba mixer from a zero state: no state given, one returned
        x, _, st = layer_body(x, params.layers[i], cfg, q_pos=q_pos,
                              is_global=is_global,
                              cache=_layer_cache(cache, i), cache_len=0,
                              return_state=has_ssm,
                              compute_dtype=compute_dtype, shard=shard)
        if has_ssm:
            states.append(st)
        if cross is not None:
            lp = params.cross_layers[cross]
            # the cross layer's K/V, cached for decode
            for key, w in (("cross_k", "wk"), ("cross_v", "wv")):
                kv = divisible(torch.matmul(enc_c, lp[w].to(compute_dtype)),
                               -1, cfg.n_kv)
                cache[key][cross] = kv.reshape(b, -1, cfg.n_kv, hd)
            x = cross_layer_body(x, lp, cfg, enc_c, q_pos=q_pos,
                                 compute_dtype=compute_dtype, shard=shard)
    _set_ssm_state(cache, states)
    cache["len"] = torch.tensor(s, dtype=torch.int32)
    logits = _unembed(params, cfg, x[:, -1:])[:, 0]
    return logits, cache


# ---------------------------------------------------------------------------
# decode: one token against the caches
# ---------------------------------------------------------------------------

def decode_step(params: DecoderLM, cfg: ArchConfig, token, cache, *,
                compute_dtype=torch.bfloat16, shard: ShardFn = _noshard
                ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """token: (B,) ints (or (B, 1, D) embeddings).  Returns (logits (B,V),
    the cache with the token's keys and values written in place, the
    Mamba state replaced and ``len`` advanced)."""
    b = token.shape[0]
    if cfg.input_mode == "embeddings":
        x = torch.as_tensor(token, device=params.embed.device)
        x = x.reshape(b, 1, -1).to(compute_dtype)
        if cfg.embed_scale:
            x = x * torch.tensor(cfg.d_model ** 0.5, dtype=compute_dtype)
    else:
        x = _embed(params, cfg, torch.as_tensor(token).reshape(b, 1),
                   compute_dtype)
    pos = int(cache["len"])
    q_pos = _positions(b, 1, pos, x.device)
    hd = cfg.head_dim_of
    has_ssm = cfg.mixer != "attn"
    states = []
    for i, is_global, cross in _groups(cfg):
        state = ({"conv": cache["ssm_conv"][i], "h": cache["ssm_h"][i]}
                 if has_ssm else None)
        x, _, st = layer_body(x, params.layers[i], cfg, q_pos=q_pos,
                              is_global=is_global,
                              cache=_layer_cache(cache, i), cache_len=pos,
                              ssm_state=state, compute_dtype=compute_dtype,
                              shard=shard)
        if has_ssm:
            states.append(st)
        if cross is not None:
            # cross attention against the cached encoder K/V
            lp = params.cross_layers[cross]
            ck, cv = cache["cross_k"][cross], cache["cross_v"][cross]
            hq = rms_norm(x, lp["ln1"], cfg.norm_eps)
            q = torch.matmul(hq, lp["wq"].to(compute_dtype)).reshape(
                b, 1, cfg.n_heads, hd)
            kv_pos = _positions(b, ck.shape[1], 0, x.device)
            att = blockwise_attention(
                q, ck, cv, q_pos=q_pos, kv_pos=kv_pos, causal=False,
                softcap=cfg.attn_softcap, scale=cfg.attn_scale)
            att = torch.matmul(att.reshape(b, 1, cfg.n_heads * hd),
                               lp["wo"].to(compute_dtype))
            x = x + torch.tanh(lp["gate_attn"]).to(x.dtype) * att.to(x.dtype)
            h2 = rms_norm(x, lp["ln2"], cfg.norm_eps)
            x = x + torch.tanh(lp["gate_mlp"]).to(x.dtype) * _mlp(
                h2, lp, cfg, compute_dtype).to(x.dtype)
    new_cache = dict(cache)
    _set_ssm_state(new_cache, states)
    new_cache["len"] = cache["len"] + 1
    logits = _unembed(params, cfg, x)[:, 0]
    return logits, new_cache


# ---------------------------------------------------------------------------
# caches carried across from and back to the JAX package
# ---------------------------------------------------------------------------

def cache_from_reference(cache: Dict[str, Any], *,
                         device="cuda") -> Dict[str, Any]:
    """The JAX package's cache (a dict of numpy arrays, bfloat16 ones as
    ``ml_dtypes`` arrays) as the port's: the arrays on ``device`` in their
    own dtype, ``len`` a 0-d int32 tensor on the host."""
    dev = resolve_device(device)
    out = {k: _to_torch(v, dev) for k, v in cache.items() if k != "len"}
    out["len"] = torch.tensor(int(np.asarray(cache["len"])),
                              dtype=torch.int32)
    return out


def cache_to_numpy(cache: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """The port's cache as numpy arrays for the JAX package: bfloat16
    leaves widen to float32 (exactly; cast back with ``astype``), ``len``
    is an int32 scalar array."""
    out = {}
    for k, v in cache.items():
        v = v.detach().cpu()
        out[k] = (v.float() if v.dtype == torch.bfloat16 else v).numpy()
    out["len"] = np.asarray(int(cache["len"]), np.int32)
    return out
