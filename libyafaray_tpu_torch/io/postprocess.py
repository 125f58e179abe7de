"""Image post-processing: the Sobel edge layers, the toon layer and denoise.

A copy of those functions of `libyafaray_tpu/io/postprocess.py` (numpy
only): the Sobel-based DebugFacesEdges / object-edge and toon layers of the
reference (src/image/image_manipulation.cc:103-113), which `film.resolve`
derives at flush, and its non-local-means denoise of outputs
(image_manipulation_opencv.cc). The badge banner comes with the C API's
slice.
"""
from __future__ import annotations

from typing import Optional

import numpy as np


def sobel_edges(img: np.ndarray, threshold: float = 0.3) -> np.ndarray:
    """Edge magnitude of an [H,W,C] image (DebugFacesEdges layer)."""
    gray = np.asarray(img, np.float32)
    if gray.ndim == 3:
        gray = gray[..., :3].mean(-1)
    gx = np.zeros_like(gray)
    gy = np.zeros_like(gray)
    p = np.pad(gray, 1, mode="edge")
    kx = np.array([[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]], np.float32)
    ky = kx.T
    for dy in range(3):
        for dx in range(3):
            win = p[dy:dy + gray.shape[0], dx:dx + gray.shape[1]]
            gx += kx[dy, dx] * win
            gy += ky[dy, dx] * win
    mag = np.sqrt(gx * gx + gy * gy)
    return (mag > threshold).astype(np.float32)


def toon(img: np.ndarray, edge_img: Optional[np.ndarray] = None,
         levels: int = 4, edge_color=(0, 0, 0),
         edge_threshold: float = 0.3) -> np.ndarray:
    """Toon layer: posterized color + dark edges
    (image_manipulation.cc toon post)."""
    img = np.asarray(img, np.float32)
    q = np.floor(np.clip(img[..., :3], 0, 1) * levels) / max(levels - 1, 1)
    q = np.clip(q, 0.0, 1.0)
    edges = edge_img if edge_img is not None else sobel_edges(
        img, edge_threshold)
    ec = np.asarray(edge_color, np.float32)
    out = np.where(edges[..., None] > 0, ec, q)
    if img.shape[-1] == 4:
        out = np.concatenate([out, img[..., 3:]], -1)
    return out


def _box3(x: np.ndarray) -> np.ndarray:
    """3x3 box filter with edge replication (patch-SSD aggregation)."""
    p = np.pad(x, ((1, 1), (1, 1)), mode="edge")
    return (p[:-2, :-2] + p[:-2, 1:-1] + p[:-2, 2:]
            + p[1:-1, :-2] + p[1:-1, 1:-1] + p[1:-1, 2:]
            + p[2:, :-2] + p[2:, 1:-1] + p[2:, 2:]) / 9.0


def denoise(img: np.ndarray, strength: float = 0.5, radius: int = 2,
            hlum: float | None = None, hcol: float | None = None,
            mix: float = 1.0) -> np.ndarray:
    """Non-local-means denoise — the reference's OpenCV
    fastNlMeansDenoisingColored analogue (image_manipulation_opencv.cc:29)
    with the same DenoiseParams surface (h_lum / h_col on the 0-255
    luminance scale, mix blend back to the original; image.h:37-41,
    image_output.cc:90-93). Patch-based: 3x3 patch SSDs aggregated with a
    box filter, weights exp(-D/h^2), separate luminance/chroma strengths
    in an opponent (Y, Cb, Cr) decomposition. Legacy (strength, radius)
    callers map strength to h when hlum/hcol are not given."""
    img = np.asarray(img, np.float32)
    rgb = img[..., :3]
    if hlum is None:
        hlum = max(strength, 1e-3) * 10.0
    if hcol is None:
        hcol = hlum
    # h given on the LDR 0-255 scale like OpenCV; images here are linear 0-1
    hl2 = (hlum / 255.0) ** 2
    hc2 = (hcol / 255.0) ** 2
    y = 0.299 * rgb[..., 0] + 0.587 * rgb[..., 1] + 0.114 * rgb[..., 2]
    cb = rgb[..., 2] - y
    cr = rgb[..., 0] - y
    search = max(int(radius) * 2 + 1, 5)  # search-window radius
    acc_y = np.zeros_like(y)
    acc_cb = np.zeros_like(y)
    acc_cr = np.zeros_like(y)
    wacc_l = np.zeros_like(y)
    wacc_c = np.zeros_like(y)
    for dy in range(-search, search + 1):
        for dx in range(-search, search + 1):
            ys = np.roll(y, (dy, dx), axis=(0, 1))
            cbs = np.roll(cb, (dy, dx), axis=(0, 1))
            crs = np.roll(cr, (dy, dx), axis=(0, 1))
            d_lum = _box3((y - ys) ** 2)
            d_col = _box3((cb - cbs) ** 2 + (cr - crs) ** 2)
            wl = np.exp(-d_lum / max(hl2, 1e-12))
            wc = wl * np.exp(-d_col / max(hc2, 1e-12))
            acc_y += wl * ys
            wacc_l += wl
            acc_cb += wc * cbs
            acc_cr += wc * crs
            wacc_c += wc
    yd = acc_y / np.maximum(wacc_l, 1e-9)
    cbd = acc_cb / np.maximum(wacc_c, 1e-9)
    crd = acc_cr / np.maximum(wacc_c, 1e-9)
    r = crd + yd
    b = cbd + yd
    g = (yd - 0.299 * r - 0.114 * b) / 0.587
    out = np.stack([r, g, b], -1)
    out = mix * out + (1.0 - mix) * rgb
    if img.shape[-1] == 4:
        out = np.concatenate([out, img[..., 3:]], -1)
    return out
