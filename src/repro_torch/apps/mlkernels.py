"""Machine-learning kernel suite (paper Sec. V-B).

The paper analyzes ResNet-50 and U-Net and specializes PEs for the common
kernels of both: multi-channel convolution (Conv), residual block (Block),
strided convolution (StrC) and down-sample (DS).  As in Sec. V-A, each
function is the per-output-element computation (unrolled MAC chains over a
stencil x input channels) with constant weights.

Channel/taps counts are kept small (the paper mines *patterns*, not full
layers; frequency is what matters and repeats are already present).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from ..graphir.graph import Graph
from ..graphir.symtrace import fclamp, fmax, fshr, trace

# 3x3 window x 2 input channels
CONV_IN = [f"x{ch}_{r}{c}" for ch in range(2) for r in range(3) for c in range(3)]
# deterministic pseudo-weights (constants in the graph)
_RNG = np.random.default_rng(7)
_W = {name: round(float(_RNG.uniform(-2, 2)), 3) for name in CONV_IN}


def _conv_acc(args: List, names: List[str]):
    w = dict(zip(names, args))
    acc = None
    for name in names:
        term = w[name] * _W[name]
        acc = term if acc is None else acc + term
    return acc


def conv_pixel(*p):
    """Multi-channel conv + bias + ReLU (the Conv kernel)."""
    acc = _conv_acc(list(p), CONV_IN)
    acc = acc + 0.5                       # bias
    return fmax(acc, 0.0)                 # ReLU


def residual_block_pixel(*p):
    """Conv + bias + skip-add + ReLU (the Block kernel).

    Inputs: conv window + the skip-path activation ``skip``.
    """
    *win, skip = p
    acc = _conv_acc(list(win), CONV_IN)
    acc = acc + 0.5
    acc = acc + skip
    return fmax(acc, 0.0)


def strided_conv_pixel(*p):
    """Stride-2 conv: same MAC structure, decimated sampling + requant."""
    acc = _conv_acc(list(p), CONV_IN)
    acc = acc + 0.5
    acc = fshr(acc, 1.0)                  # requantize after stride
    return fmax(acc, 0.0)


def downsample_pixel(*p):
    """2x2 average-pool over 2 channels + channel mix (the DS kernel)."""
    x0 = list(p[:4])
    x1 = list(p[4:8])
    a0 = fshr(x0[0] + x0[1] + x0[2] + x0[3], 2.0)
    a1 = fshr(x1[0] + x1[1] + x1[2] + x1[3], 2.0)
    mixed = a0 * 0.7 + a1 * 0.3
    return fmax(mixed, 0.0)


DS_IN = [f"x{ch}_{i}" for ch in range(2) for i in range(4)]

ML_APPS: Dict[str, Dict] = {
    "conv": {"fn": conv_pixel, "inputs": CONV_IN},
    "block": {"fn": residual_block_pixel, "inputs": CONV_IN + ["skip"]},
    "strc": {"fn": strided_conv_pixel, "inputs": CONV_IN},
    "ds": {"fn": downsample_pixel, "inputs": DS_IN},
}


def build_graph(name: str) -> Graph:
    spec = ML_APPS[name]
    return trace(spec["fn"], spec["inputs"])


def run_reference(name: str, inputs: np.ndarray) -> float:
    spec = ML_APPS[name]
    return spec["fn"](*[float(v) for v in inputs])
