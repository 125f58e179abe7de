"""Colour spaces and spectra, batched over [..., 3] / [..., 4] tensors.

Counterpart of `libyafaray_tpu/color.py` (the reference's Rgb / Rgba and
their colour-space conversions, include/color/color.h:35-133,345, and the
wavelength-to-RGB fit of dispersion, include/color/spectrum.h:31-44,
src/color/spectrum.cc): luminance, energy, the sRGB curves, linear RGB to
and from XYZ, the output and input colour-space dispatch, the colour
difference, premultiplied alpha and `wl_to_rgb`, the smooth analytic fit of
spectrum::wl2Rgb's CIE table (the first dispersive refraction of a path
tints its throughput by 3 * wl_to_rgb(wavelength)).

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

# colour-space ids (the reference's ColorSpace enum)
RAW_MANUAL_GAMMA = 0
LINEAR_RGB = 1
SRGB = 2
XYZ_D65 = 3

COLOR_SPACE_NAMES = {
    "RawManualGamma": RAW_MANUAL_GAMMA,
    "LinearRGB": LINEAR_RGB,
    "sRGB": SRGB,
    "XYZ": XYZ_D65,
}


def luminance(rgb: Tensor) -> Tensor:
    """Rec. 709 luma (CIE Y), the perceptual weight of the JAX package."""
    return 0.2126 * rgb[..., 0] + 0.7152 * rgb[..., 1] + 0.0722 * rgb[..., 2]


def energy(rgb: Tensor) -> Tensor:
    return torch.mean(rgb, dim=-1)


def max_component(rgb: Tensor) -> Tensor:
    return torch.amax(rgb, dim=-1)


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


_RGB_TO_XYZ = np.array(
    [[0.4124564, 0.3575761, 0.1804375],
     [0.2126729, 0.7151522, 0.0721750],
     [0.0193339, 0.1191920, 0.9503041]], np.float32)
_XYZ_TO_RGB = np.array(
    [[3.2404542, -1.5371385, -0.4985314],
     [-0.9692660, 1.8760108, 0.0415560],
     [0.0556434, -0.2040259, 1.0572252]], np.float32)


def _apply(m: np.ndarray, c: Tensor) -> Tensor:
    return torch.einsum("ij,...j->...i",
                        torch.from_numpy(m).to(device=c.device, dtype=c.dtype),
                        c)


def linear_to_xyz(rgb: Tensor) -> Tensor:
    return _apply(_RGB_TO_XYZ, rgb)


def xyz_to_linear(xyz: Tensor) -> Tensor:
    return _apply(_XYZ_TO_RGB, xyz)


def to_output_space(rgb: Tensor, color_space: int,
                    gamma: float = 1.0) -> Tensor:
    """Linear render output to a named colour space (the reference's image
    output path)."""
    if color_space == SRGB:
        return linear_to_srgb(rgb)
    if color_space == XYZ_D65:
        return linear_to_xyz(rgb)
    if color_space == RAW_MANUAL_GAMMA and gamma != 1.0:
        return torch.pow(torch.clamp_min(rgb, 0.0), 1.0 / gamma)
    return rgb


def from_input_space(rgb: Tensor, color_space: int,
                     gamma: float = 1.0) -> Tensor:
    """A texture or image input to the linear working space (the
    reference's texture load)."""
    if color_space == SRGB:
        return srgb_to_linear(rgb)
    if color_space == XYZ_D65:
        return xyz_to_linear(rgb)
    if color_space == RAW_MANUAL_GAMMA and gamma != 1.0:
        return torch.pow(torch.clamp_min(rgb, 0.0), gamma)
    return rgb


def color_difference(a: Tensor, b: Tensor) -> Tensor:
    """The green-weighted colour difference of the JAX package (the
    reference's Rgb::colorDifference, used at src/render/imagefilm.cc:337)."""
    w = torch.tensor([0.25, 0.5, 0.25], dtype=a.dtype, device=a.device)
    return torch.sum(torch.abs(a - b)[..., :3] * w, dim=-1)


def premultiply_alpha(rgba: Tensor) -> Tensor:
    return torch.cat([rgba[..., :3] * rgba[..., 3:4], rgba[..., 3:4]], dim=-1)


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
