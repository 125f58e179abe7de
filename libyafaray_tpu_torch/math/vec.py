"""Vector math over trailing-3 axes, on torch tensors.

Counterpart of `libyafaray_tpu/math/vec.py`. Dot and cross products are
written out component by component, so their rounding is the same on every
device and matches the order the intersection kernel uses
(`accel/mt_intersect.py`).
"""
from __future__ import annotations

import math

import torch

Tensor = torch.Tensor


def dot(a: Tensor, b: Tensor, keepdim: bool = False) -> Tensor:
    r = a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]
    return r.unsqueeze(-1) if keepdim else r


def cross(a: Tensor, b: Tensor) -> Tensor:
    """a x b with each component a_i*b_j - a_j*b_i rounded once after the
    second product, as the fused multiply-add fma(a_i, b_j, -(a_j*b_i)) that
    XLA emits for `jnp.cross` on the CPU (evaluated exactly in float64).
    An analytically zero component, such as the z of a vertical face's
    normal, then keeps the sign of its rounding residual, and the shading
    frame built from it (`orthonormal_basis` branches on that sign) is the
    JAX package's."""
    def comp(i, j):
        exact = a[..., i].double() * b[..., j].double()
        return (exact - (a[..., j] * b[..., i]).double()).float()
    return torch.stack([comp(1, 2), comp(2, 0), comp(0, 1)], dim=-1)


def length(v: Tensor) -> Tensor:
    return torch.sqrt(torch.clamp_min(dot(v, v), 0.0))


def normalize(v: Tensor, eps: float = 1e-20) -> Tensor:
    return v * torch.rsqrt(torch.clamp_min(dot(v, v, keepdim=True), eps))


def refract(wi: Tensor, n: Tensor, eta: Tensor):
    """Refract `wi` (unit, pointing away from the surface) through normal
    `n` with relative IOR `eta` = n_inside / n_outside seen from the wi
    side. Returns (wt, total internal reflection mask) (Vec3::refract,
    batched and branchless)."""
    if eta.dim() == wi.dim() - 1:
        eta = eta[..., None]
    cos_i = dot(wi, n, keepdim=True)
    inv_eta = 1.0 / eta
    sin2_t = inv_eta * inv_eta * torch.clamp_min(1.0 - cos_i * cos_i, 0.0)
    tir = sin2_t >= 1.0
    cos_t = torch.sqrt(torch.clamp_min(1.0 - sin2_t, 1e-12))
    wt = normalize(-wi * inv_eta + (inv_eta * cos_i - cos_t) * n)
    return wt, tir[..., 0]


def fresnel_dielectric(cos_i: Tensor, eta: Tensor) -> Tensor:
    """Unpolarized Fresnel reflectance for a dielectric; eta = n_t/n_i."""
    cos_i = torch.clamp(torch.abs(cos_i), 0.0, 1.0)
    sin2_t = torch.clamp_min(1.0 - cos_i * cos_i, 0.0) / (eta * eta)
    tir = sin2_t >= 1.0
    cos_t = torch.sqrt(torch.clamp_min(1.0 - sin2_t, 1e-12))
    r_par = (eta * cos_i - cos_t) / (eta * cos_i + cos_t)
    r_perp = (cos_i - eta * cos_t) / (cos_i + eta * cos_t)
    fr = 0.5 * (r_par * r_par + r_perp * r_perp)
    return torch.where(tir, 1.0, fr)


def schlick_fresnel(cos_i: Tensor, r0: Tensor) -> Tensor:
    """Schlick's approximation (material_utils_microfacet.h)."""
    m = torch.clamp(1.0 - torch.abs(cos_i), 0.0, 1.0)
    m2 = m * m
    return r0 + (1.0 - r0) * m2 * m2 * m


def orthonormal_basis(n: Tensor):
    """(u, v) such that (u, v, n) is a right-handed orthonormal frame
    (branchless Duff et al. construction)."""
    nx, ny, nz = n[..., 0:1], n[..., 1:2], n[..., 2:3]
    sign = torch.where(nz >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + nz)
    b = nx * ny * a
    u = torch.cat([1.0 + sign * nx * nx * a, sign * b, -sign * nx], dim=-1)
    v = torch.cat([b, sign + ny * ny * a, -ny], dim=-1)
    return u, v


def to_local(v: Tensor, u: Tensor, w: Tensor, n: Tensor) -> Tensor:
    """World direction -> local shading frame (u, w, n) coordinates."""
    return torch.stack([dot(v, u), dot(v, w), dot(v, n)], dim=-1)


def from_local(l: Tensor, u: Tensor, w: Tensor, n: Tensor) -> Tensor:
    return l[..., 0:1] * u + l[..., 1:2] * w + l[..., 2:3] * n


def cosine_sample_hemisphere(u1: Tensor, u2: Tensor) -> Tensor:
    """Cosine-weighted hemisphere sample around +z (pdf = cos/pi)."""
    r = torch.sqrt(u1)
    phi = (2.0 * math.pi) * u2
    x = r * torch.cos(phi)
    y = r * torch.sin(phi)
    z = torch.sqrt(torch.clamp_min(1.0 - u1, 0.0))
    return torch.stack([x, y, z], dim=-1)


def uniform_sample_sphere(u1: Tensor, u2: Tensor) -> Tensor:
    """Uniform direction on the unit sphere (pdf = 1/(4 pi))."""
    z = 1.0 - 2.0 * u1
    r = torch.sqrt(torch.clamp_min(1.0 - z * z, 0.0))
    phi = (2.0 * math.pi) * u2
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)


def uniform_sample_cone(u1: Tensor, u2: Tensor, cos_max: Tensor) -> Tensor:
    """Uniform direction in a cone around +z with half-angle cos >= cos_max."""
    cos_t = 1.0 - u1 * (1.0 - cos_max)
    sin_t = torch.sqrt(torch.clamp_min(1.0 - cos_t * cos_t, 0.0))
    phi = (2.0 * math.pi) * u2
    return torch.stack([sin_t * torch.cos(phi), sin_t * torch.sin(phi), cos_t],
                       dim=-1)


def sample_triangle_uniform(u1: Tensor, u2: Tensor):
    """Uniform barycentric coordinates on a triangle (sqrt warp)."""
    su1 = torch.sqrt(u1)
    return 1.0 - su1, u2 * su1


def sample_disk_concentric(u1: Tensor, u2: Tensor):
    """Concentric (Shirley) map of [0,1)^2 onto the unit disk."""
    ox = 2.0 * u1 - 1.0
    oy = 2.0 * u2 - 1.0
    zero = (torch.abs(ox) < 1e-12) & (torch.abs(oy) < 1e-12)
    use_x = torch.abs(ox) > torch.abs(oy)
    r = torch.where(use_x, ox, oy)
    safe_div = torch.where(
        use_x, torch.where(ox == 0, 1.0, oy / torch.where(ox == 0, 1.0, ox)),
        torch.where(oy == 0, 1.0, ox / torch.where(oy == 0, 1.0, oy)))
    theta = torch.where(use_x, (math.pi / 4.0) * safe_div,
                        (math.pi / 2.0) - (math.pi / 4.0) * safe_div)
    r = torch.where(zero, 0.0, r)
    return r * torch.cos(theta), r * torch.sin(theta)


def power_heuristic(pdf_a: Tensor, pdf_b: Tensor) -> Tensor:
    """MIS power heuristic (beta=2): a^2 / (a^2 + b^2)."""
    a2 = pdf_a * pdf_a
    b2 = pdf_b * pdf_b
    return torch.where(a2 + b2 > 0.0, a2 / torch.clamp_min(a2 + b2, 1e-30), 0.0)
