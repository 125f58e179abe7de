"""Microfacet distributions: Blinn and Ashikhmin-Shirley anisotropic (the
glossy and coated-glossy materials) and GGX (rough glass).

Counterpart of `libyafaray_tpu/materials/microfacet.py` (libYafaRay's
material_utils_microfacet.h blinnD, asAnisoD, asAnisoSample, GGX_D,
GGX_Sample, Smith G1). Every direction is in the local shading frame
(z = the shading normal).
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


# --- GGX (rough glass; material_utils_microfacet.h) ---

def ggx_d(cos_h: Tensor, alpha2: Tensor) -> Tensor:
    cos_h = torch.clamp_min(cos_h, 0.0)
    c2 = cos_h * cos_h
    denom = c2 * (alpha2 - 1.0) + 1.0
    return alpha2 * INV_PI / torch.clamp_min(denom * denom, 1e-12)


def ggx_sample_h(u1: Tensor, u2: Tensor, alpha: Tensor) -> Tensor:
    """A GGX half vector, pdf_h = D(h) cos(h)."""
    phi = 2.0 * math.pi * u2
    tan2 = alpha * alpha * u1 / torch.clamp_min(1.0 - u1, 1e-9)
    cos_t = torch.rsqrt(1.0 + tan2)
    sin_t = torch.sqrt(torch.clamp_min(1.0 - cos_t * cos_t, 1e-12))
    return torch.stack([sin_t * torch.cos(phi), sin_t * torch.sin(phi), cos_t],
                       dim=-1)


def ggx_smith_g1(cos_v: Tensor, alpha2: Tensor) -> Tensor:
    cos_v = torch.abs(cos_v)
    c2 = cos_v * cos_v
    return 2.0 * cos_v / torch.clamp_min(
        cos_v + torch.sqrt(alpha2 + (1.0 - alpha2) * c2), 1e-12)


def ggx_g(cos_i: Tensor, cos_o: Tensor, alpha2: Tensor) -> Tensor:
    return ggx_smith_g1(cos_i, alpha2) * ggx_smith_g1(cos_o, alpha2)


def ggx_pdf_h(cos_h: Tensor, alpha2: Tensor) -> Tensor:
    return ggx_d(cos_h, alpha2) * torch.clamp_min(cos_h, 0.0)
