"""Image files: PNG, PPM, TGA, HDR and EXR writers and readers.

Counterpart of `libyafaray_tpu/io/__init__.py` (the reference's src/format/*,
factory format.cc:52-64), in numpy and zlib: PNG directly over zlib, HDR
the Radiance RGBE encoding, TGA and PPM as they are, EXR in `io/exr.py`;
JPEG and TIFF through PIL where it is installed. The colour conversions
are the port's (`color.py`), so a file written from the same array is
byte for byte the JAX package's.
"""
from __future__ import annotations

import struct as _struct
import zlib

import numpy as np
import torch

from .. import color as C


def _np(fn, img: np.ndarray) -> np.ndarray:
    """A colour function of `color.py` on a float32 numpy array."""
    return fn(torch.from_numpy(np.ascontiguousarray(img, np.float32))).numpy()


def _to_u8(img: np.ndarray, srgb: bool = True) -> np.ndarray:
    img = np.asarray(img, np.float32)
    if srgb:
        img = _np(C.linear_to_srgb, np.clip(img, 0.0, 1.0))
    return (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def save_png(path: str, img: np.ndarray, srgb: bool = True) -> None:
    """Write [H,W,3|4] float (linear) or uint8 image as PNG."""
    if img.dtype != np.uint8:
        img = _to_u8(img, srgb)
    h, w = img.shape[:2]
    c = img.shape[2] if img.ndim == 3 else 1
    if img.ndim == 2:
        img = img[..., None]
    color_type = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        out = _struct.pack(">I", len(data)) + tag + data
        return out + _struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)

    ihdr = _struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    png = (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
           + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(png)


def load_png(path: str) -> np.ndarray:
    """Minimal PNG reader (8-bit, non-interlaced) -> float32 linear [H,W,C]."""
    with open(path, "rb") as f:
        data = f.read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n", "not a png"
    pos = 8
    idat = b""
    w = h = bitd = ctype = 0
    while pos < len(data):
        (ln,) = _struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        payload = data[pos + 8:pos + 8 + ln]
        if tag == b"IHDR":
            w, h, bitd, ctype, _, _, interlace = _struct.unpack(">IIBBBBB", payload)
            assert bitd == 8 and interlace == 0, "unsupported png"
        elif tag == b"IDAT":
            idat += payload
        elif tag == b"IEND":
            break
        pos += 12 + ln
    c = {0: 1, 2: 3, 4: 2, 6: 4}[ctype]
    raw = zlib.decompress(idat)
    stride = w * c
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros((stride,), np.uint8)
    pos = 0
    for y in range(h):
        ft = raw[pos]
        row = np.frombuffer(raw[pos + 1:pos + 1 + stride], np.uint8).astype(np.int32)
        pos += 1 + stride
        if ft == 0:
            cur = row
        elif ft == 1:
            cur = row.copy()
            for x in range(c, stride):
                cur[x] = (cur[x] + cur[x - c]) & 0xFF
        elif ft == 2:
            cur = (row + prev) & 0xFF
        elif ft == 3:
            cur = row.copy()
            for x in range(stride):
                left = cur[x - c] if x >= c else 0
                cur[x] = (cur[x] + ((left + int(prev[x])) >> 1)) & 0xFF
        elif ft == 4:
            cur = row.copy()
            for x in range(stride):
                a = int(cur[x - c]) if x >= c else 0
                b = int(prev[x])
                cc = int(prev[x - c]) if x >= c else 0
                p = a + b - cc
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - cc)
                pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else cc)
                cur[x] = (cur[x] + pred) & 0xFF
        else:
            raise ValueError(f"bad png filter {ft}")
        out[y] = cur.astype(np.uint8)
        prev = out[y].astype(np.uint8)
    img = out.reshape(h, w, c).astype(np.float32) / 255.0
    img = _np(C.srgb_to_linear, img) if c >= 3 else img
    return img


def save_ppm(path: str, img: np.ndarray, srgb: bool = True) -> None:
    u8 = _to_u8(np.asarray(img)[..., :3], srgb)
    h, w = u8.shape[:2]
    with open(path, "wb") as f:
        f.write(f"P6\n{w} {h}\n255\n".encode())
        f.write(u8.tobytes())


def save_tga(path: str, img: np.ndarray, srgb: bool = True) -> None:
    """Uncompressed 24/32-bit TGA (format_tga.cc analogue)."""
    u8 = _to_u8(np.asarray(img), srgb)
    h, w = u8.shape[:2]
    c = u8.shape[2]
    hdr = _struct.pack("<BBBHHBHHHHBB", 0, 0, 2, 0, 0, 0, 0, 0, w, h,
                       8 * c, 0x20 if c == 3 else 0x28)
    bgr = u8[..., [2, 1, 0]] if c == 3 else u8[..., [2, 1, 0, 3]]
    with open(path, "wb") as f:
        f.write(hdr)
        f.write(bgr.tobytes())


def load_tga(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        data = f.read()
    idlen, cmap, imgtype = data[0], data[1], data[2]
    w, h = _struct.unpack("<HH", data[12:16])
    bpp = data[16]
    desc = data[17]
    assert imgtype in (2, 10), "unsupported tga type"
    c = bpp // 8
    pos = 18 + idlen
    n = w * h * c
    if imgtype == 2:
        px = np.frombuffer(data[pos:pos + n], np.uint8).copy()
    else:  # RLE
        out = bytearray()
        while len(out) < n:
            head = data[pos]
            pos += 1
            cnt = (head & 0x7F) + 1
            if head & 0x80:
                out += data[pos:pos + c] * cnt
                pos += c
            else:
                out += data[pos:pos + c * cnt]
                pos += c * cnt
        px = np.frombuffer(bytes(out[:n]), np.uint8).copy()
    img = px.reshape(h, w, c).astype(np.float32) / 255.0
    if not (desc & 0x20):
        img = img[::-1]
    if c >= 3:
        img = img[..., [2, 1, 0] + ([3] if c == 4 else [])]
        img = np.concatenate([_np(C.srgb_to_linear, img[..., :3]),
                              img[..., 3:]], -1) if c == 4 else \
            _np(C.srgb_to_linear, img)
    return img


def save_hdr(path: str, img: np.ndarray) -> None:
    """Radiance RGBE .hdr writer (format_hdr.cc analogue), flat (no RLE)."""
    img = np.asarray(img, np.float32)[..., :3]
    h, w = img.shape[:2]
    maxc = img.max(axis=-1)
    exp = np.zeros((h, w), np.int32)
    mant = np.frexp(np.maximum(maxc, 1e-32))
    mantissa, exponent = mant
    scale = np.where(maxc > 1e-32, mantissa * 256.0 / np.maximum(maxc, 1e-32), 0.0)
    rgbe = np.zeros((h, w, 4), np.uint8)
    rgbe[..., 0] = np.clip(img[..., 0] * scale, 0, 255).astype(np.uint8)
    rgbe[..., 1] = np.clip(img[..., 1] * scale, 0, 255).astype(np.uint8)
    rgbe[..., 2] = np.clip(img[..., 2] * scale, 0, 255).astype(np.uint8)
    rgbe[..., 3] = np.where(maxc > 1e-32, exponent + 128, 0).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
        f.write(f"-Y {h} +X {w}\n".encode())
        f.write(rgbe.tobytes())


def load_hdr(path: str) -> np.ndarray:
    """Radiance RGBE reader (flat + adaptive RLE scanlines)."""
    with open(path, "rb") as f:
        data = f.read()
    pos = data.index(b"\n\n") + 2 if b"\n\n" in data else 0
    # resolution line
    eol = data.index(b"\n", pos)
    res = data[pos:eol].decode().split()
    h = int(res[1])
    w = int(res[3])
    pos = eol + 1
    rgbe = np.zeros((h, w, 4), np.uint8)
    for y in range(h):
        if (pos + 4 <= len(data) and data[pos] == 2 and data[pos + 1] == 2
                and (data[pos + 2] << 8 | data[pos + 3]) == w):
            pos += 4
            for ch in range(4):
                x = 0
                while x < w:
                    cnt = data[pos]
                    pos += 1
                    if cnt > 128:
                        rgbe[y, x:x + cnt - 128, ch] = data[pos]
                        pos += 1
                        x += cnt - 128
                    else:
                        rgbe[y, x:x + cnt, ch] = np.frombuffer(
                            data[pos:pos + cnt], np.uint8)
                        pos += cnt
                        x += cnt
        else:
            row = np.frombuffer(data[pos:pos + w * 4], np.uint8)
            rgbe[y] = row.reshape(w, 4)
            pos += w * 4
    e = rgbe[..., 3].astype(np.int32)
    scale = np.where(e > 0, np.ldexp(1.0, e - 136), 0.0)
    return (rgbe[..., :3].astype(np.float32) + 0.5) * scale[..., None]


def save_image(path: str, img: np.ndarray, color_space: str = "sRGB",
               gamma: float = 1.0) -> None:
    """Format-dispatching save (ImageOutput::flush analogue)."""
    low = path.lower()
    srgb = color_space == "sRGB"
    if color_space == "RawManualGamma" and gamma != 1.0:
        img = np.power(np.clip(np.asarray(img, np.float32), 0, None), 1.0 / gamma)
        srgb = False
    if low.endswith(".png"):
        save_png(path, img, srgb)
    elif low.endswith(".ppm"):
        save_ppm(path, img, srgb)
    elif low.endswith(".tga"):
        save_tga(path, img, srgb)
    elif low.endswith(".hdr"):
        save_hdr(path, img)
    elif low.endswith(".exr"):
        from .exr import save_exr
        save_exr(path, np.asarray(img, np.float32))
    elif low.endswith((".jpg", ".jpeg", ".tif", ".tiff")):
        from PIL import Image
        arr = _to_u8(np.asarray(img), srgb)
        if low.endswith((".jpg", ".jpeg")) and arr.shape[-1] == 4:
            arr = arr[..., :3]  # JPEG has no alpha
        Image.fromarray(arr).save(path)
    else:
        raise KeyError(f"unknown image format for {path!r}")


def load_image(path: str) -> np.ndarray:
    low = path.lower()
    if low.endswith(".png"):
        return load_png(path)
    if low.endswith(".tga"):
        return load_tga(path)
    if low.endswith(".hdr"):
        return load_hdr(path)
    if low.endswith(".exr"):
        from .exr import load_exr
        return load_exr(path)
    if low.endswith((".jpg", ".jpeg", ".tif", ".tiff")):
        from PIL import Image
        arr = np.asarray(Image.open(path))
        if arr.dtype in (np.uint8, np.uint16):
            arr = arr.astype(np.float32) / (255.0 if arr.dtype == np.uint8
                                            else 65535.0)
            if arr.ndim == 3 and arr.shape[-1] >= 3:  # sRGB-encoded LDR
                arr = _np(C.srgb_to_linear, arr)
            return arr
        return arr.astype(np.float32)
    raise KeyError(f"unknown image format for {path!r}")
