"""Model zoo: unified decoder LM for the assigned architectures, in
PyTorch (the ``attn``, ``mamba`` and ``hymba`` mixers, the dense and
MoE MLPs), with the conversions that carry the JAX package's parameters
and caches across."""

from .config import ArchConfig, MoEConfig, SSMConfig
from .model import (cache_from_reference, cache_shapes, cache_to_numpy,
                    decode_step, forward, init_cache, prefill)
from .transformer import (cast_for_compute, init_params, layer_shapes,
                          param_shapes, params_from_reference)

__all__ = [
    "ArchConfig", "MoEConfig", "SSMConfig", "cache_shapes", "decode_step",
    "forward", "init_cache", "prefill", "init_params", "layer_shapes",
    "param_shapes",
    # the port's own
    "cache_from_reference", "cache_to_numpy", "cast_for_compute",
    "params_from_reference",
]
