"""Distribution layer on ``torch.distributed``: sharding rules, gradient
compression, pipelining."""

from .specs import (PartitionSpec, activation_shard_fn, batch_axes,
                    batch_pspecs, cache_pspecs, distribute_params,
                    param_pspecs, to_placements)

__all__ = ["PartitionSpec", "activation_shard_fn", "batch_axes",
           "batch_pspecs", "cache_pspecs", "distribute_params",
           "param_pspecs", "to_placements"]
