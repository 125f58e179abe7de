"""Native OpenEXR scanline I/O — no external codec dependency.

A copy of `libyafaray_tpu/io/exr.py` (numpy and zlib only).

The reference's EXR format support (src/format/format_exr.cc) wraps the
OpenEXR library and is its only *multi-layer* output: every exported render
layer becomes a channel group "LayerName.R/G/B/A" in one file. This module
implements the same capability directly over the EXR scanline wire format
(magic 20000630, version 2):

- `save_exr` writes uncompressed (NONE) float32 or half scanline files,
  single-part, with multi-layer channel naming exactly like the reference.
- `load_exr` reads NONE / ZIPS / ZIP compressed scanline files (the
  compressions practically all DCC tools emit), reconstructing the ZIP
  predictor+interleave transform in numpy.

Not supported (raises): tiled/deep/multipart files, PIZ/PXR24/B44/DWA
compression, sub-sampled channels.
"""
from __future__ import annotations

import struct as _st
import zlib
from typing import Dict, Optional, Union

import numpy as np

_MAGIC = 20000630
_PIX_UINT, _PIX_HALF, _PIX_FLOAT = 0, 1, 2
_COMP_NONE, _COMP_RLE, _COMP_ZIPS, _COMP_ZIP = 0, 1, 2, 3
_SCANLINES_PER_CHUNK = {_COMP_NONE: 1, _COMP_ZIPS: 1, _COMP_ZIP: 16}


def _attr(name: str, typ: str, data: bytes) -> bytes:
    return (name.encode() + b"\0" + typ.encode() + b"\0"
            + _st.pack("<i", len(data)) + data)


def _chlist(channels, pix_type: int) -> bytes:
    out = b""
    for name in channels:
        out += (name.encode() + b"\0" + _st.pack("<i", pix_type)
                + _st.pack("<i", 0)          # pLinear + 3 reserved
                + _st.pack("<ii", 1, 1))     # x/y sampling
    return out + b"\0"


def save_exr(path: str,
             img: Union[np.ndarray, Dict[str, np.ndarray]],
             half: bool = False) -> None:
    """Write a scanline EXR. `img` is either an [H,W,C<=4] array (channels
    R,G,B,A) or a dict layer-name -> [H,W,C] (multi-layer: channels are
    "name.R" etc., the layer named "combined" or "" maps to plain R/G/B/A
    like the reference's exported-image naming)."""
    if isinstance(img, dict):
        layers = img
    else:
        layers = {"": img}
    plane_names = []
    planes = []
    h = w = None
    for lname, arr in layers.items():
        arr = np.asarray(arr, np.float32)
        if arr.ndim == 2:
            arr = arr[..., None]
        if h is None:
            h, w = arr.shape[:2]
        if arr.shape[:2] != (h, w):
            raise ValueError("all layers must share dimensions")
        comp = "RGBA" if arr.shape[2] != 1 else "Y"
        prefix = "" if lname in ("", "combined") else lname + "."
        for c in range(arr.shape[2]):
            plane_names.append(prefix + comp[c])
            planes.append(np.ascontiguousarray(arr[..., c]))
    order = np.argsort(plane_names)  # chlist must be sorted by name
    names = [plane_names[i] for i in order]
    planes = [planes[i] for i in order]

    pix_type = _PIX_HALF if half else _PIX_FLOAT
    dtype = np.dtype("<f2") if half else np.dtype("<f4")
    psize = dtype.itemsize

    hdr = _st.pack("<ii", _MAGIC, 2)
    hdr += _attr("channels", "chlist", _chlist(names, pix_type))
    hdr += _attr("compression", "compression", bytes([_COMP_NONE]))
    box = _st.pack("<iiii", 0, 0, w - 1, h - 1)
    hdr += _attr("dataWindow", "box2i", box)
    hdr += _attr("displayWindow", "box2i", box)
    hdr += _attr("lineOrder", "lineOrder", bytes([0]))
    hdr += _attr("pixelAspectRatio", "float", _st.pack("<f", 1.0))
    hdr += _attr("screenWindowCenter", "v2f", _st.pack("<ff", 0.0, 0.0))
    hdr += _attr("screenWindowWidth", "float", _st.pack("<f", 1.0))
    hdr += b"\0"

    line_bytes = 8 + len(names) * w * psize
    table_pos = len(hdr)
    data_pos = table_pos + 8 * h
    offsets = _st.pack("<%dQ" % h,
                       *(data_pos + y * line_bytes for y in range(h)))
    rows = np.stack([p.astype(dtype) for p in planes], axis=1)  # [H,C,W]
    with open(path, "wb") as f:
        f.write(hdr)
        f.write(offsets)
        for y in range(h):
            f.write(_st.pack("<ii", y, len(names) * w * psize))
            f.write(rows[y].tobytes())


def _read_str(buf: bytes, pos: int):
    end = buf.index(b"\0", pos)
    return buf[pos:end].decode("latin1"), end + 1


def _exr_unpredict(data: bytes) -> np.ndarray:
    b = np.frombuffer(data, np.uint8).astype(np.int64)
    # delta decode: t[i] = t[i-1] + raw[i] - 128 (t[0] = raw[0])
    d = ((np.cumsum(b - 128) + 128) % 256).astype(np.uint8)
    # de-interleave: first half -> even positions, second half -> odd
    n = len(d)
    out = np.empty(n, np.uint8)
    half = (n + 1) // 2
    out[0::2] = d[:half]
    out[1::2] = d[half:]
    return out


def load_exr(path: str, layer: Optional[str] = None):
    """Read a scanline EXR into float32 [H,W,C]. With multi-layer files,
    `layer=None` returns the base (unprefixed) R/G/B/A channels; pass a
    layer name for its channel group; pass `layer="*"` to get a dict of
    every layer."""
    with open(path, "rb") as f:
        buf = f.read()
    magic, version = _st.unpack_from("<ii", buf, 0)
    if magic != _MAGIC:
        raise ValueError(f"{path}: not an EXR file")
    if version & 0x200 or version & 0x800 or version & 0x1000:
        raise NotImplementedError("tiled/deep/multipart EXR not supported")
    pos = 8
    channels = []
    compression = _COMP_NONE
    xmin = ymin = 0
    xmax = ymax = 0
    while True:
        if buf[pos] == 0:
            pos += 1
            break
        name, pos = _read_str(buf, pos)
        typ, pos = _read_str(buf, pos)
        (size,) = _st.unpack_from("<i", buf, pos)
        pos += 4
        data = buf[pos:pos + size]
        pos += size
        if name == "channels":
            p = 0
            while data[p] != 0:
                cname, p = _read_str(data, p)
                (ptype,) = _st.unpack_from("<i", data, p)
                p += 16  # type + plinear/reserved + samplings
                channels.append((cname, ptype))
        elif name == "compression":
            compression = data[0]
        elif name == "dataWindow":
            xmin, ymin, xmax, ymax = _st.unpack_from("<iiii", data, 0)
    if compression not in _SCANLINES_PER_CHUNK:
        raise NotImplementedError(f"EXR compression {compression} unsupported")
    w = xmax - xmin + 1
    h = ymax - ymin + 1
    chunk_lines = _SCANLINES_PER_CHUNK[compression]
    n_chunks = -(-h // chunk_lines)
    offsets = _st.unpack_from("<%dQ" % n_chunks, buf, pos)

    dtypes = {_PIX_UINT: np.dtype("<u4"), _PIX_HALF: np.dtype("<f2"),
              _PIX_FLOAT: np.dtype("<f4")}
    sizes = [dtypes[t].itemsize for _, t in channels]
    line_raw = w * sum(sizes)
    planes = {c: np.zeros((h, w), np.float32) for c, _ in channels}
    for off in offsets:
        y, nbytes = _st.unpack_from("<ii", buf, off)
        raw = buf[off + 8: off + 8 + nbytes]
        lines = min(chunk_lines, ymax + 1 - y)
        if compression in (_COMP_ZIP, _COMP_ZIPS):
            if nbytes < lines * line_raw:
                raw = _exr_unpredict(zlib.decompress(raw)).tobytes()
        p = 0
        for ln in range(lines):
            for (cname, ptype), csize in zip(channels, sizes):
                row = np.frombuffer(raw, dtypes[ptype], w, p)
                planes[cname][y - ymin + ln] = row.astype(np.float32)
                p += w * csize
    if layer == "*":
        return _group_layers(planes)
    groups = _group_layers(planes)
    if layer is None:
        for key in ("", "combined"):
            if key in groups:
                return groups[key]
        return next(iter(groups.values()))
    if layer in groups:
        return groups[layer]
    raise KeyError(f"layer {layer!r} not in {sorted(groups)}")


def _group_layers(planes: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    comp_order = {"R": 0, "G": 1, "B": 2, "A": 3, "Y": 0}
    groups: Dict[str, Dict[str, np.ndarray]] = {}
    for cname, arr in planes.items():
        if "." in cname:
            lname, comp = cname.rsplit(".", 1)
        else:
            lname, comp = "", cname
        groups.setdefault(lname, {})[comp] = arr
    out = {}
    for lname, comps in groups.items():
        ordered = sorted(comps.items(),
                         key=lambda kv: (comp_order.get(kv[0], 9), kv[0]))
        out[lname] = np.stack([a for _, a in ordered], axis=-1)
    return out
