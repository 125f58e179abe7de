"""Image post-processing: the Sobel edge layers, the toon layer, denoise and
the badge banner.

A copy of `libyafaray_tpu/io/postprocess.py` (numpy only): the Sobel-based
DebugFacesEdges / object-edge and toon layers of the reference
(src/image/image_manipulation.cc:103-113), which `film.resolve` derives at
flush, its non-local-means denoise of outputs
(image_manipulation_opencv.cc), and the render-stats badge (badge.cc:47-148)
with its text: antialiased through Pillow where it is installed, else the
built-in 5x7 bitmap font, as in the JAX package (the choice is of a font,
not of a device).
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


# ---------------------------------------------------------------------------
# 5x7 bitmap font (ASCII 32..95 subset) for the badge banner
# ---------------------------------------------------------------------------

_FONT = {
    "0": "0E11151913110E", "1": "040C040404040E", "2": "0E11010609101F",
    "3": "0E1101060111 0E", "4": "02060A121F0202", "5": "1F101E0101110E",
    "6": "060810 1E11110E", "7": "1F01020408 0808", "8": "0E11110E11110E",
    "9": "0E11110F01020C", " ": "00000000000000", ".": "0000000000 0C0C",
    ":": "000C0C000C0C00", "/": "01010204081010", "-": "0000001F000000",
    "%": "1901020408 1013", "A": "0E11111F111111", "B": "1E11111E11111E",
    "C": "0E111010 10110E", "D": "1E11111111111E", "E": "1F10101E10101F",
    "F": "1F10101E101010", "G": "0E111017 11110F", "H": "11111F1F111111",
    "I": "0E04040404040E", "J": "070202 0202120C", "K": "11121C181C1211",
    "L": "101010101010 1F", "M": "111B1515111111", "N": "1119151311 1111",
    "O": "0E11111111110E", "P": "1E11111E101010", "Q": "0E1111111512 0D",
    "R": "1E11111E141211", "S": "0F10100E01011E", "T": "1F040404 040404",
    "U": "111111111111 0E", "V": "111111110A0A04", "W": "111111 15151B11",
    "X": "110A040404 0A11", "Y": "110A0404040404", "Z": "1F010204 08101F",
    "p": "00001E111E1010", "s": "00000F 0E 011E0", "x": "0000110A040A11",
    "m": "00001A15151515", "r": "0000161810 1010", "a": "00000E011F110F",
    "y": "0000110A04 0810", "d": "0101 0F11 11 0F", "e": "00000E111E100F",
}


def _glyph(ch: str) -> np.ndarray:
    hexs = _FONT.get(ch, _FONT.get(ch.upper(), _FONT[" "])).replace(" ", "")
    rows = [int(hexs[i:i + 2], 16) for i in range(0, min(len(hexs), 14), 2)]
    rows += [0] * (7 - len(rows))
    g = np.zeros((7, 5), np.float32)
    for y, r in enumerate(rows):
        for x in range(5):
            g[y, 4 - x] = (r >> x) & 1
    return g


def draw_text(img: np.ndarray, text: str, x: int, y: int,
              color=(1, 1, 1), scale: int = 1) -> np.ndarray:
    """Stamp bitmap text into the image (in place), top-left at (x, y)."""
    col = np.asarray(color, np.float32)
    cx = x
    for ch in text:
        g = _glyph(ch)
        if scale > 1:
            g = np.repeat(np.repeat(g, scale, 0), scale, 1)
        h, w = g.shape
        y1 = min(y + h, img.shape[0])
        x1 = min(cx + w, img.shape[1])
        if y1 > y and x1 > cx:
            mask = g[: y1 - y, : x1 - cx, None]
            img[y:y1, cx:x1, :3] = (img[y:y1, cx:x1, :3] * (1 - mask)
                                    + col * mask)
        cx += w + scale
    return img


def _draw_text_pil(img: np.ndarray, text: str, x: int, y: int,
                   color, scale: int) -> bool:
    """Antialiased text via PIL's built-in scalable font (FreeType-backed
    in Pillow — the quality tier of the reference's FreeType badge,
    badge.cc:120-148, without an external font file). Returns False when
    PIL is unavailable so the caller can fall back to the 5x7 bitmap."""
    try:
        from PIL import Image, ImageDraw, ImageFont
    except Exception:
        return False
    try:
        font = ImageFont.load_default(size=10 * scale)
    except TypeError:     # older Pillow: fixed-size bitmap default font
        font = ImageFont.load_default()
    h, w = img.shape[:2]
    mask_img = Image.new("L", (w, h), 0)
    ImageDraw.Draw(mask_img).text((x, y), text, fill=255, font=font)
    mask = np.asarray(mask_img, np.float32)[..., None] / 255.0
    col = np.asarray(color, np.float32)
    img[..., :3] = img[..., :3] * (1.0 - mask) + col * mask
    return True


def draw_badge(img: np.ndarray, lines, position: str = "bottom",
               bg_color=(0.05, 0.05, 0.05), text_color=(0.9, 0.9, 0.9),
               scale: int = 1) -> np.ndarray:
    """Render-stats banner (Badge analogue, badge.cc:47-148): a solid strip
    at top/bottom with one or more text lines (title/author/render
    params). Text is antialiased via PIL/FreeType when available; the
    built-in 5x7 bitmap font keeps it dependency-free otherwise."""
    img = np.array(img, np.float32, copy=True)
    line_h = 12 * scale
    strip_h = line_h * len(lines) + 4 * scale
    h = img.shape[0]
    if position == "top":
        y0 = 0
    else:
        y0 = max(h - strip_h, 0)
    img[y0:y0 + strip_h, :, :3] = np.asarray(bg_color, np.float32)
    for i, line in enumerate(lines):
        ty = y0 + 2 * scale + i * line_h
        if not _draw_text_pil(img, line, 3 * scale, ty, text_color, scale):
            draw_text(img, line, 3 * scale, ty, text_color, scale)
    return img
