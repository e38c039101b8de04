"""Image-processing application suite (paper Sec. V-A).

The paper specializes PEs across four Halide apps: Harris corner detection,
Gaussian blur, camera pipeline, and Laplacian pyramid.  Each function below
describes the per-output-pixel computation over a stencil window of named
scalar inputs — exactly the shape of graph the Halide->CoreIR flow produces
(unrolled convolutions, Fig. 3).  The same code executes on numpy scalars
(oracle) and on the symbolic tracer (graph building).

Kernel weights are constants (Fig. 2c: constant registers), written as
Python literals so the tracer lowers them to ``const`` nodes.
"""

from __future__ import annotations

from typing import Callable, Dict, List

import numpy as np

from ..graphir.graph import Graph
from ..graphir.symtrace import (Tracer, fclamp, fmax, fmin, fsel, fshl, fshr,
                                trace)

# 3x3 window input names, row-major
W33 = [f"p{r}{c}" for r in range(3) for c in range(3)]
W55 = [f"p{r}{c}" for r in range(5) for c in range(5)]


def _w(args: List, names: List[str]) -> Dict[str, object]:
    return dict(zip(names, args))


# ---------------------------------------------------------------------------
# Gaussian blur — 3x3 binomial kernel [1 2 1; 2 4 2; 1 2 1] / 16.
# Fixed-point friendly: weights realized with shifts and adds.
# ---------------------------------------------------------------------------
def gaussian_blur_pixel(*p):
    w = _w(list(p), W33)
    acc = w["p00"] * 1.0
    acc = acc + w["p01"] * 2.0
    acc = acc + w["p02"] * 1.0
    acc = acc + w["p10"] * 2.0
    acc = acc + w["p11"] * 4.0
    acc = acc + w["p12"] * 2.0
    acc = acc + w["p20"] * 1.0
    acc = acc + w["p21"] * 2.0
    acc = acc + w["p22"] * 1.0
    return fshr(acc, 4.0)          # / 16


# ---------------------------------------------------------------------------
# Harris corner detection: Sobel gradients, structure tensor, response.
# ---------------------------------------------------------------------------
def harris_pixel(*p):
    w = _w(list(p), W33)
    gx = (w["p02"] + w["p12"] * 2.0 + w["p22"]) \
        - (w["p00"] + w["p10"] * 2.0 + w["p20"])
    gy = (w["p20"] + w["p21"] * 2.0 + w["p22"]) \
        - (w["p00"] + w["p01"] * 2.0 + w["p02"])
    gxx = gx * gx
    gyy = gy * gy
    gxy = gx * gy
    det = gxx * gyy - gxy * gxy
    tr = gxx + gyy
    resp = det - (tr * tr) * 0.04          # k = 0.04
    thresh = resp > 1000.0
    return fsel(thresh, 0.0, resp)


# ---------------------------------------------------------------------------
# Camera pipeline: denoise -> demosaic (bilinear) -> white balance ->
# color-correction matrix -> luma sharpen -> tone curve, per output RGB
# pixel.  This is the most complex app (paper: 221 ops per output pixel;
# this unrolled graph is the same order of magnitude).
# ---------------------------------------------------------------------------
def camera_pipeline_pixel(*p):
    w = _w(list(p), W55)

    def raw(r, c):
        return w[f"p{r}{c}"]

    # --- denoise: 3x3 thresholded smoothing on the raw mosaic ------------
    # (same-color neighbors are 2 apart on a Bayer mosaic)
    def at(r, c):
        if not (1 <= r <= 3 and 1 <= c <= 3):
            return raw(r, c)
        center = raw(r, c)
        acc = center * 4.0
        for dr, dc in ((-1, -1), (-1, 1), (1, -1), (1, 1)):
            n = raw(r + dr, c + dc)
            d = n - center
            # reject outliers: keep neighbor only if |d| small
            keep = abs(d) < 64.0
            acc = acc + fsel(keep, center, n)
        return fshr(acc, 3.0)

    # --- demosaic around center (2,2), GRBG pattern assumed -------------
    # green at center
    g_c = at(2, 2)
    # red: average of horizontal neighbors; blue: vertical
    r_c = fshr(at(2, 1) + at(2, 3), 1.0)
    b_c = fshr(at(1, 2) + at(3, 2), 1.0)
    # refine green with laplacian correction
    g_h = fshr(at(2, 0) + at(2, 4), 1.0)
    g_v = fshr(at(0, 2) + at(4, 2), 1.0)
    lap = g_c * 2.0 - fshr(g_h + g_v, 1.0)
    g_ref = g_c + fshr(lap, 2.0)

    # neighbor demosaics for a 3-tap cross sharpen on luma ----------------
    def demosaic_at(r, c):
        g = at(r, c)
        rr = fshr(at(r, c - 1) + at(r, c + 1), 1.0)
        bb = fshr(at(r - 1, c) + at(r + 1, c), 1.0)
        return rr, g, bb

    r_l, g_l, b_l = demosaic_at(2, 1)
    r_r, g_r, b_r = demosaic_at(2, 3)
    r_u, g_u, b_u = demosaic_at(1, 2)
    r_d, g_d, b_d = demosaic_at(3, 2)

    # --- white balance ----------------------------------------------------
    r_wb = r_c * 1.4
    g_wb = g_ref * 1.0
    b_wb = b_c * 1.6

    # --- color correction matrix (3x3) --------------------------------------
    r_cc = r_wb * 1.66 + g_wb * -0.44 + b_wb * -0.22
    g_cc = r_wb * -0.36 + g_wb * 1.42 + b_wb * -0.06
    b_cc = r_wb * -0.12 + g_wb * -0.52 + b_wb * 1.64

    # --- luma sharpen using neighbor demosaics -----------------------------
    def luma(r, g, b):
        return fshr(r + g * 2.0 + b, 2.0)

    l_c = luma(r_cc, g_cc, b_cc)
    l_n = fshr(luma(r_l, g_l, b_l) + luma(r_r, g_r, b_r)
               + luma(r_u, g_u, b_u) + luma(r_d, g_d, b_d), 2.0)
    sharp = l_c * 2.0 - fshr(l_n, 1.0)
    gain = sharp - l_c
    r_sh = r_cc + fshr(gain, 1.0)
    g_sh = g_cc + fshr(gain, 1.0)
    b_sh = b_cc + fshr(gain, 1.0)

    # --- two-segment tone curve (gamma approx), clamp to range --------------
    def tone(x):
        lo = x * 2.0                      # boost shadows
        hi = x * 0.5 + 384.0              # compress highlights
        y = fsel(x > 256.0, lo, hi)
        return fclamp(y, 0.0, 1023.0)

    return tone(r_sh), tone(g_sh), tone(b_sh)


# ---------------------------------------------------------------------------
# Laplacian pyramid: one level — band = center - upsampled(blur(decimate)).
# Per-pixel: gaussian blur at coarse level + bilinear upsample + subtract,
# followed by a remap curve (local contrast).
# ---------------------------------------------------------------------------
def laplacian_pyramid_pixel(*p):
    w = _w(list(p), W55)

    def at(r, c):
        return w[f"p{r}{c}"]

    # coarse = blur(5x5 center region) (decimated grid sample)
    def blur3(r, c):
        acc = at(r - 1, c - 1) + at(r - 1, c + 1) \
            + at(r + 1, c - 1) + at(r + 1, c + 1)
        acc = acc + (at(r - 1, c) + at(r + 1, c)
                     + at(r, c - 1) + at(r, c + 1)) * 2.0
        acc = acc + at(r, c) * 4.0
        return fshr(acc, 4.0)

    c00 = blur3(1, 1)
    c01 = blur3(1, 3)
    c10 = blur3(3, 1)
    c11 = blur3(3, 3)
    up = fshr(c00 + c01 + c10 + c11, 2.0)    # bilinear upsample at center
    band = at(2, 2) - up
    # remap: alpha * band with soft knee
    mag = abs(band)
    knee = fsel(mag > 64.0, band * 2.0, band * 0.5)
    out = up + knee
    return fclamp(out, 0.0, 1023.0)


APPS: Dict[str, Dict] = {
    "gaussian": {"fn": gaussian_blur_pixel, "inputs": W33, "window": 3},
    "harris": {"fn": harris_pixel, "inputs": W33, "window": 3},
    "camera": {"fn": camera_pipeline_pixel, "inputs": W55, "window": 5},
    "laplacian": {"fn": laplacian_pyramid_pixel, "inputs": W55, "window": 5},
}


def build_graph(name: str) -> Graph:
    spec = APPS[name]
    return trace(spec["fn"], spec["inputs"])


def run_reference(name: str, image: np.ndarray) -> np.ndarray:
    """Run the scalar oracle over an image (valid region only)."""
    spec = APPS[name]
    k = spec["window"]
    h, w = image.shape
    outs = []
    for r in range(h - k + 1):
        row = []
        for c in range(w - k + 1):
            window = [float(image[r + dr, c + dc])
                      for dr in range(k) for dc in range(k)]
            v = spec["fn"](*window)
            row.append(v[0] if isinstance(v, tuple) else v)
        outs.append(row)
    return np.array(outs)
