"""Performance-variant flags of the port's LM substrate.

The port of the JAX package's ``repro.models.perf_flags``, field for
field, with the same names and defaults.  With every flag at its
default the port computes what it computes without this module; each
flag selects one variant of a layer, and the dry run
(``repro_torch.launch.dryrun --set K=V``) counts the step's FLOPs, bytes
and collectives under it.  Flags are process-global, so a launcher sets
them once instead of threading them through every call site.

What each flag selects in the port:

* ``attention_impl="q_outer"`` (with ``s > attn_q_chunk``):
  ``layers.blockwise_attention_qouter`` where the port calls
  ``blockwise_attention`` (cross-attention, and attention after a cached
  prefix); a prefill with no cache stays on the flash-attention kernel
  (K6), which already runs in q-outer order.  ``attn_kv_chunk`` is
  ``blockwise_attention``'s ``chunk``.
* ``ssm_impl``: ``"materialized"`` discretizes the whole sequence, (B,
  S, d_inner, N) float32 ``da``/``dbx``, and runs the selective scan
  (K7) once; ``"streamed"`` discretizes ``ssm_chunk`` steps at a time and
  runs K7 on each chunk with the state carried across; ``"sequential"``
  is the per-step recurrence in plain PyTorch.  ``ssm_state_dtype="bf16"``
  rounds the streamed ``da``/``dbx`` to bfloat16.
* ``norm_dtype="bf16"``: RMSNorm's elementwise math in bfloat16 with a
  float32 variance.
* ``ce_impl="chunked"``: the unembed and cross entropy run ``ce_chunk``
  positions at a time under activation checkpointing, so the (B, S, V)
  float32 logits never exist.
* ``moe_combine``: the name the MoE expert outputs are constrained under
  before the combine, ``"sharded"`` for the expert-sharded one (the JAX
  package's code tests ``== "sharded"`` although its comment names the
  other choice ``"replicated"``; the port keeps the code's meaning).
* ``moe_impl="shard_map"`` with a mesh registered by :func:`set_mesh`:
  ``moe_mlp_shardmap`` in place of ``moe_mlp``.
* ``seq_shard``: the sharding callback puts the residual stream's
  sequence dim on the ``model`` axis between layers.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

__all__ = ["PerfFlags", "get_flags", "get_mesh", "reset_flags",
           "set_flags", "set_mesh"]


@dataclass
class PerfFlags:
    # attention loop order: "kv_scan" = kv-chunk inner loop with a full-S
    # accumulator; "q_outer" = q-chunks outside, an accumulator a q-tile
    attention_impl: str = "kv_scan"
    attn_q_chunk: int = 512
    attn_kv_chunk: int = 512
    # SSM scan: "materialized" | "streamed" | "sequential"
    ssm_impl: str = "materialized"
    ssm_chunk: int = 256
    # dtype the streamed da/dbx are rounded to: "f32" | "bf16"
    ssm_state_dtype: str = "f32"
    # RMSNorm intermediate dtype: "f32" | "bf16"
    norm_dtype: str = "f32"
    # cross entropy: "full" (B, S, V) float32 logits | "chunked"
    ce_impl: str = "full"
    ce_chunk: int = 512
    # MoE combine: "gather" (expert outputs replicated) | "sharded"
    moe_combine: str = "gather"
    # MoE implementation: "pjit" (moe_mlp) | "shard_map" (moe_mlp_shardmap)
    moe_impl: str = "pjit"
    # residual-stream sequence sharding over `model` between layers
    seq_shard: bool = False


_FLAGS = PerfFlags()
_MESH = None           # (mesh, batch_axes) registered by the launcher


def get_flags() -> PerfFlags:
    return _FLAGS


def set_mesh(mesh, batch_axes) -> None:
    """Registers the ``DeviceMesh`` (with a ``model`` axis) and the batch
    axes ``moe_impl="shard_map"`` runs on; None unregisters it."""
    global _MESH
    _MESH = None if mesh is None else (mesh, tuple(batch_axes))


def get_mesh():
    return _MESH


def set_flags(**kw) -> PerfFlags:
    global _FLAGS
    _FLAGS = replace(_FLAGS, **kw)
    return _FLAGS


def reset_flags() -> PerfFlags:
    global _FLAGS
    _FLAGS = PerfFlags()
    return _FLAGS
