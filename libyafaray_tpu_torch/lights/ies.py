"""IESNA LM-63 photometric file parser (host numpy).

A copy of `libyafaray_tpu/lights/ies.py` (the reference's IES loader,
src/light/light_ies.cc and include/light/light_ies_data.h): the candela
table resampled onto a uniform (horizontal x vertical) angular grid for the
light table's `ies_pool`, which `lights._ies_factor` reads with one
bilinear fetch. Horizontal symmetry (Type C files measured over 0-90 or
0-180 degrees) is unfolded to the full 0-360 range here, as the
reference's getRadiance() folds it at run time.
"""
from __future__ import annotations

import numpy as np

IES_RES = 64      # vertical bins over [0, 180] deg
IES_RES_H = 32    # horizontal bins over [0, 360) deg (periodic)


def _fold_h(a: np.ndarray, max_h: float) -> np.ndarray:
    """Fold an absolute horizontal angle (deg, [0,360)) into the measured
    domain implied by the file's last horizontal angle (LM-63 symmetry)."""
    a = np.mod(a, 360.0)
    if max_h <= 90.0 + 1e-3:
        # quadrant symmetry: mirror every 90 deg
        a = np.mod(a, 180.0)
        a = np.where(a > 90.0, 180.0 - a, a)
    elif max_h <= 180.0 + 1e-3:
        # bilateral symmetry about the 0-180 plane
        a = np.where(a > 180.0, 360.0 - a, a)
    return a


def parse_ies(path_or_text: str) -> np.ndarray:
    """A [IES_RES_H, IES_RES] float32 multiplier grid normalised so that the
    largest candela value maps to 1.0. Axis 0 is the horizontal (azimuthal)
    angle over [0, 360) deg, axis 1 the vertical angle over [0, 180] deg.
    The argument is the file's text or its path."""
    if "\n" in path_or_text or "TILT" in path_or_text[:200]:
        text = path_or_text
    else:
        with open(path_or_text, "r", errors="replace") as f:
            text = f.read()
    # the numeric payload starts after the TILT line
    lines = text.splitlines()
    idx = 0
    for i, ln in enumerate(lines):
        if ln.strip().upper().startswith("TILT="):
            tilt = ln.strip().upper()[5:]
            idx = i + 1
            if tilt == "INCLUDE":
                # skip the tilt block: <lamp-to-luminaire> <n> <angles>
                # <factors>
                nums = _numbers(lines[idx:])
                n_pairs = int(nums[1])
                consumed = 2 + 2 * n_pairs
                flat = []
                while len(flat) < consumed and idx < len(lines):
                    flat += lines[idx].split()
                    idx += 1
            break
    nums = _numbers(lines[idx:])
    # header: lamps, lumens/lamp, multiplier, n_vert, n_horiz, photometric
    # type, units, w, l, h, ballast, future, input watts
    n_vert = int(nums[3])
    n_horiz = int(nums[4])
    mult = nums[2]
    pos = 13
    v_angles = np.asarray(nums[pos:pos + n_vert])
    pos += n_vert
    h_angles = np.asarray(nums[pos:pos + n_horiz])
    pos += n_horiz
    candela = np.asarray(nums[pos:pos + n_vert * n_horiz]).reshape(
        n_horiz, n_vert) * mult

    # vertical resample of each measured horizontal plane onto [0, 180]
    v_grid = np.linspace(0.0, 180.0, IES_RES)
    planes = np.stack([np.interp(v_grid, v_angles, candela[i],
                                 left=candela[i][0], right=candela[i][-1])
                       for i in range(n_horiz)])  # [n_horiz, IES_RES]

    # horizontal unfold onto the uniform periodic [0, 360) grid
    h_grid = np.arange(IES_RES_H) * (360.0 / IES_RES_H)
    if n_horiz == 1:
        grid = np.broadcast_to(planes[0], (IES_RES_H, IES_RES)).copy()
    else:
        folded = _fold_h(h_grid, float(h_angles[-1]))
        # interpolate between measured horizontal planes at each folded
        # angle (full-360 files wrap through the first plane)
        if float(h_angles[-1]) > 180.0 + 1e-3:
            ha = np.concatenate([h_angles, [h_angles[0] + 360.0]])
            pl = np.vstack([planes, planes[:1]])
        else:
            ha, pl = h_angles, planes
        i1 = np.clip(np.searchsorted(ha, folded, side="right"),
                     1, len(ha) - 1)
        i0 = i1 - 1
        denom = np.maximum(ha[i1] - ha[i0], 1e-6)
        fr = np.clip((folded - ha[i0]) / denom, 0.0, 1.0)
        grid = pl[i0] * (1.0 - fr[:, None]) + pl[i1] * fr[:, None]

    peak = grid.max()
    if peak > 0:
        grid = grid / peak
    return grid.astype(np.float32)


def ies_grid(p) -> np.ndarray:
    """A profile in the pool's [IES_RES_H, IES_RES] layout: parse_ies's
    output passes through; a raw 1-D array (a vertical profile the caller
    gives) becomes one axially symmetric row, resampled to IES_RES bins
    (the JAX compile's `_ies_grid`)."""
    p = np.asarray(p, np.float32)
    if p.ndim == 1:
        p = p[None, :]
    if p.shape[-1] != IES_RES:
        p = np.stack([np.interp(np.linspace(0, 1, IES_RES),
                                np.linspace(0, 1, p.shape[-1]), row)
                      for row in p])
    if p.shape[0] == 1:
        p = np.broadcast_to(p, (IES_RES_H, IES_RES))
    return p.astype(np.float32)


def _numbers(lines):
    out = []
    for ln in lines:
        for tok in ln.replace(",", " ").split():
            try:
                out.append(float(tok))
            except ValueError:
                pass
    return out
