"""The wavelength-to-RGB fit of chromatic dispersion.

Counterpart of `wl_to_rgb` in `libyafaray_tpu/color.py` (the reference's
spectrum::wl2Rgb, src/color/spectrum.cc, there as a smooth analytic fit of
its CIE table), the one colour function the port's integrator calls: the
first dispersive refraction of a path tints its throughput by
3 * wl_to_rgb(wavelength).
"""
from __future__ import annotations

import torch

Tensor = torch.Tensor

# (weight, centre nm, width below, width above) of each Gaussian lobe
_R = ((1.056, 599.8, 37.9, 31.0), (0.362, 442.0, 16.0, 26.7),
      (-0.065, 501.1, 20.4, 26.2))
_G = ((0.821, 568.8, 46.9, 40.5), (0.286, 530.9, 16.3, 31.1))
_B = ((1.217, 437.0, 11.8, 36.0), (0.681, 459.0, 26.0, 13.8))


def _g(x: Tensor, mu: float, s1: float, s2: float) -> Tensor:
    s = torch.where(x < mu, s1, s2)
    t = (x - mu) / s
    return torch.exp(-0.5 * t * t)


def _channel(wl: Tensor, lobes) -> Tensor:
    out = None
    for w, mu, s1, s2 in lobes:
        term = w * _g(wl, mu, s1, s2)
        out = term if out is None else out + term
    return out


def wl_to_rgb(wl01: Tensor) -> Tensor:
    """A wavelength parameter in [0, 1] (380..720 nm) to linear RGB,
    normalised so that its mean over uniform wavelengths is about
    (1, 1, 1)."""
    wl = 380.0 + wl01 * 340.0
    rgb = torch.stack([_channel(wl, _R), _channel(wl, _G), _channel(wl, _B)],
                      dim=-1)
    return torch.clamp_min(rgb, 0.0) * 2.985
