"""The sRGB curves and the wavelength-to-RGB fit of chromatic dispersion.

Counterpart of the functions of `libyafaray_tpu/color.py` that the port
calls: the sRGB encode and decode of the image writers and readers (the
reference's ColorSpace conversions, include/color/color.h) and the
wavelength-to-RGB fit (spectrum::wl2Rgb, src/color/spectrum.cc, as a
smooth analytic fit of its CIE table): the first dispersive refraction of
a path tints its throughput by 3 * wl_to_rgb(wavelength). The rest of the
JAX module (luminance, XYZ, the output-space dispatch) comes with the
first slice that calls it.

The sRGB curves raise to a float32 power in float64 and round once. XLA's
float32 pow is not torch's: computed in float32, torch's differs from it by
an ulp on 1.5% of inputs, enough to move an 8-bit value now and then; the
rounded float64 power agrees with it on every 8-bit level and gives the
same 8-bit output on a dense grid of [0, 1] (`tests/test_torch_film.py`).
"""
from __future__ import annotations

import numpy as np
import torch

Tensor = torch.Tensor


def _pow(c: Tensor, e: float) -> Tensor:
    """c ** e for float32 c and the float32 exponent nearest e, computed in
    float64 and rounded once."""
    return torch.pow(c.double(), float(np.float32(e))).to(c.dtype)


def linear_to_srgb(c: Tensor) -> Tensor:
    c = torch.clamp_min(c, 0.0)
    return torch.where(c <= 0.0031308, 12.92 * c,
                       1.055 * _pow(c, 1.0 / 2.4) - 0.055)


def srgb_to_linear(c: Tensor) -> Tensor:
    c = torch.clamp_min(c, 0.0)
    return torch.where(c <= 0.04045, c / 12.92,
                       _pow((c + 0.055) / 1.055, 2.4))


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
