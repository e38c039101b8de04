"""Roofline terms of a counted step, against the H100's data-sheet peaks.

Three terms per (arch x shape x mesh), all in seconds, from one rank's
counts (``launch.hlo_cost``):

  compute    = flops_per_device            / PEAK_FLOPS_BF16
  memory     = bytes_per_device            / HBM_BW
  collective = collective_bytes_per_device / LINK_BW

with ``launch.mesh``'s constants for an NVIDIA H100 SXM: 989e12 FLOP/s
dense bfloat16, 3.35e12 B/s of HBM3, 450e9 B/s of NVLink 4 a GPU a
direction.  The counts are a rank's, so the global numbers are the
per-device ones times the ranks.  ``model_flops`` is 6·N·D for training
(2·N·D for inference), N the parameters a token uses (an MoE's routed
experts counted top_k of them).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict

from .mesh import HBM_BW, LINK_BW, PEAK_FLOPS_BF16

__all__ = ["Roofline", "count_active_params", "count_params", "model_flops"]


@dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_device: float
    bytes_per_device: float
    collective_bytes_per_device: float
    collective_breakdown: Dict[str, float] = field(default_factory=dict)
    model_flops: float = 0.0            # 6*N*D (dense) / 6*N_active*D (MoE)
    peak_memory_bytes: float = 0.0      # counted, not measured
    collective_count: int = 0

    @property
    def compute_s(self) -> float:
        return self.flops_per_device / PEAK_FLOPS_BF16

    @property
    def memory_s(self) -> float:
        return self.bytes_per_device / HBM_BW

    @property
    def collective_s(self) -> float:
        return self.collective_bytes_per_device / LINK_BW

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_ratio(self) -> float:
        """MODEL_FLOPS / counted FLOPs over all ranks: catches
        recomputation and redundant work."""
        total = self.flops_per_device * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def roofline_fraction(self) -> float:
        """compute_s / bound_s: how close the step would run to the
        compute roofline at the bound."""
        return self.compute_s / self.bound_s if self.bound_s else 0.0

    def row(self) -> str:
        return (f"{self.arch:<22} {self.shape:<12} {self.mesh:<7} "
                f"cmp={self.compute_s*1e3:9.3f}ms "
                f"mem={self.memory_s*1e3:9.3f}ms "
                f"col={self.collective_s*1e3:9.3f}ms "
                f"dom={self.dominant:<10} "
                f"useful={self.useful_ratio:5.2f} "
                f"roof={self.roofline_fraction:5.2f}")

    def to_dict(self) -> Dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips,
            "flops_per_device": self.flops_per_device,
            "bytes_per_device": self.bytes_per_device,
            "collective_bytes_per_device": self.collective_bytes_per_device,
            "collective_breakdown": self.collective_breakdown,
            "collective_count": self.collective_count,
            "model_flops": self.model_flops,
            "peak_memory_bytes": self.peak_memory_bytes,
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s, "dominant": self.dominant,
            "useful_ratio": self.useful_ratio,
            "roofline_fraction": self.roofline_fraction,
        }


def _leaf_shapes(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaf_shapes(v)
        else:
            yield v


def count_params(cfg) -> int:
    from ..models.transformer import param_shapes
    return int(sum(math.prod(s) for s in _leaf_shapes(param_shapes(cfg))))


def count_active_params(cfg) -> int:
    """Active params per token (MoE: top_k + shared experts only)."""
    n = count_params(cfg)
    if cfg.moe is None:
        return n
    moe = cfg.moe
    per_expert = 3 * cfg.d_model * moe.d_expert
    n_self = cfg.n_self_layers if cfg.mixer != "mamba" else cfg.n_layers
    routed_total = n_self * moe.n_experts_padded * per_expert
    routed_active = n_self * moe.top_k * per_expert
    return n - routed_total + routed_active


def model_flops(cfg, shape_name: str, batch: int, seq: int) -> float:
    """6*N_active*D for training, 2*N_active*D for inference steps."""
    n_active = count_active_params(cfg)
    if shape_name.startswith("train"):
        return 6.0 * n_active * batch * seq
    if shape_name.startswith("prefill"):
        return 2.0 * n_active * batch * seq
    # decode shapes: one token per sequence
    return 2.0 * n_active * batch
