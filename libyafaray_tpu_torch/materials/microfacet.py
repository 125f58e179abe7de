"""Microfacet distributions of the glossy material: Blinn and
Ashikhmin-Shirley anisotropic.

Counterpart of the Blinn and Ashikhmin-Shirley functions of
`libyafaray_tpu/materials/microfacet.py` (libYafaRay's
material_utils_microfacet.h blinnD, asAnisoD, asAnisoSample). The GGX
functions belong to rough glass and come with it. Every direction is in the
local shading frame (z = the shading normal).
"""
from __future__ import annotations

import math

import torch

Tensor = torch.Tensor

INV_PI = 1.0 / math.pi


def blinn_d(cos_h: Tensor, exponent: Tensor) -> Tensor:
    # the clamp keeps ln(0) out of the exponent's gradient on masked lanes
    cos_h = torch.clamp_min(cos_h, 1e-12)
    return (exponent + 2.0) * (0.5 * INV_PI) * torch.pow(cos_h, exponent)


def blinn_sample_h(u1: Tensor, u2: Tensor, exponent: Tensor) -> Tensor:
    """A half vector from the Blinn lobe, pdf_h = (e+1)/(2 pi) cos^e."""
    cos_t = torch.pow(torch.clamp_min(u1, 1e-12), 1.0 / (exponent + 1.0))
    sin_t = torch.sqrt(torch.clamp_min(1.0 - cos_t * cos_t, 1e-12))
    phi = 2.0 * math.pi * u2
    return torch.stack([sin_t * torch.cos(phi), sin_t * torch.sin(phi), cos_t],
                       dim=-1)


def blinn_pdf_h(cos_h: Tensor, exponent: Tensor) -> Tensor:
    return (exponent + 1.0) * (0.5 * INV_PI) * torch.pow(
        torch.clamp_min(cos_h, 1e-12), exponent)


def _as_aniso_power(h: Tensor, exp_u: Tensor, exp_v: Tensor):
    cos_h = torch.clamp_min(h[..., 2], 1e-12)
    sin2 = torch.clamp_min(1.0 - cos_h * cos_h, 1e-12)
    e = (exp_u * h[..., 0] * h[..., 0] + exp_v * h[..., 1] * h[..., 1]) / sin2
    return torch.pow(cos_h, e)


def as_aniso_d(h: Tensor, exp_u: Tensor, exp_v: Tensor) -> Tensor:
    """Ashikhmin-Shirley anisotropic distribution (asAnisoD)."""
    norm = torch.sqrt((exp_u + 2.0) * (exp_v + 2.0)) * (0.5 * INV_PI)
    return norm * _as_aniso_power(h, exp_u, exp_v)


def as_aniso_sample_h(u1: Tensor, u2: Tensor, exp_u: Tensor, exp_v: Tensor
                      ) -> Tensor:
    """An Ashikhmin-Shirley half vector (asAnisoSample); phi keeps its
    quadrant through the arctan."""
    phi = 2.0 * math.pi * u2
    t = torch.atan(torch.sqrt((exp_u + 1.0) / (exp_v + 1.0)) * torch.tan(phi))
    quad = torch.floor((phi + 0.5 * math.pi) / math.pi)
    phi_h = t + quad * math.pi
    cp, sp = torch.cos(phi_h), torch.sin(phi_h)
    e = exp_u * cp * cp + exp_v * sp * sp
    cos_t = torch.pow(torch.clamp_min(u1, 1e-12), 1.0 / (e + 1.0))
    sin_t = torch.sqrt(torch.clamp_min(1.0 - cos_t * cos_t, 1e-12))
    return torch.stack([sin_t * cp, sin_t * sp, cos_t], dim=-1)


def as_aniso_pdf_h(h: Tensor, exp_u: Tensor, exp_v: Tensor) -> Tensor:
    norm = torch.sqrt((exp_u + 1.0) * (exp_v + 1.0)) * (0.5 * INV_PI)
    return norm * _as_aniso_power(h, exp_u, exp_v)
