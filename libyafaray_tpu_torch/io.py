"""Image input: the Radiance RGBE (.hdr) reader of `libyafaray_tpu/io`
(`load_hdr`), for holding renders against the libYafaRay goldens."""
from __future__ import annotations

import numpy as np


def load_hdr(path: str) -> np.ndarray:
    """Radiance RGBE reader (flat and adaptive-RLE scanlines); returns the
    [H, W, 3] radiance (float64, as the JAX package's reader)."""
    with open(path, "rb") as f:
        data = f.read()
    pos = data.index(b"\n\n") + 2 if b"\n\n" in data else 0
    eol = data.index(b"\n", pos)                 # the resolution line
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
