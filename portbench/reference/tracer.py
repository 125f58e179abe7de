"""The reference path tracer: for the Lambert scenes of the benchmark's
configurations, the radiance that each camera ray carries, written from
the estimator's definition, one depth after another over a batch of
independent paths.

The estimator (the `pathtracing` integrator with `bounces` B): a path
starts at the camera and takes at most B + 1 hits. At each hit of depth
k, with the counters (pixel, sample, k, dim) of `counters`:

  - a ray that leaves the scene adds the background, weighted against the
    background light's sampling by the power heuristic where the scene
    has one (weight 1 for the camera ray);
  - a ray that hits an area light adds its radiance from the front,
    weighted against that light's sampling (weight 1 for the camera ray),
    and ends;
  - next-event estimation: every light l in turn draws (u1, u2) from
    dim 10 + 2 l: an area light a uniform point of its parallelogram
    (pdf d^2 / (area cos)), the sun a uniform direction of its cone, the
    background a uniform direction of the sphere; the Lambert surface's
    f = albedo / pi where the light is on the side the ray came from
    (by the shading normal), weighted by the power heuristic against the
    surface's cosine-weighted sampling, times a shadow ray's visibility;
  - after the last depth nothing more; else the surface samples the next
    direction from dim 2: (u1, u2) a cosine-weighted direction on the
    side the ray came from, and from depth 2 on Russian roulette with
    u4: the path goes on with probability clamp(max(throughput), 0.05, 1)
    and its throughput is divided by that.

The surface frame: the geometric normal of the triangle (the cross
product of its edges, each component rounded once as a fused
multiply-add rounds it), the tangent dp/du of its texture coordinates
(or, where they are degenerate, the first axis of the branch-free
orthonormal basis of Duff et al., "Building an Orthonormal Basis,
Revisited", JCGT 6(1), 2017) made orthogonal to the normal, and their
cross product. New rays start shadow_bias along their direction from the
hit; a ray never meets the triangle it leaves.

Gradients flow to the material colours through the throughput and the
shading, not through the intersections, as the estimator with fixed
random numbers defines them.
"""
from __future__ import annotations

import math

import torch

from . import counters as C
from . import rays as RY
from .scene import Scene

Tensor = torch.Tensor

INV_PI = 1.0 / math.pi


# ---------------------------------------------------------------- vectors

def _dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def _unit(v):
    return v * torch.rsqrt(torch.clamp_min(_dot(v, v), 1e-20))[..., None]


def _cross_once(a, b):
    """a x b, each component a_i b_j - a_j b_i rounded once after the
    second product (the fused multiply-add fma(a_i, b_j, -(a_j b_i)))."""
    ad, bd = a.double(), b.double()
    af, bf = a, b

    def comp(i, j):
        return (ad[..., i] * bd[..., j]
                - (af[..., j] * bf[..., i]).double()).float()
    return torch.stack([comp(1, 2), comp(2, 0), comp(0, 1)], dim=-1)


def _basis(n):
    """Duff et al.'s orthonormal basis (u, v) around n."""
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    sign = torch.where(nz >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + nz)
    b = nx * ny * a
    u = torch.stack([1.0 + sign * nx * nx * a, sign * b, -sign * nx], -1)
    v = torch.stack([b, sign + ny * ny * a, -ny], -1)
    return u, v


def _power(a, b):
    a2, b2 = a * a, b * b
    return torch.where(a2 + b2 > 0.0, a2 / torch.clamp_min(a2 + b2, 1e-30),
                       0.0)


# ---------------------------------------------------------------- camera

def camera_rays(sc: Scene, px: Tensor, py: Tensor):
    """Rays through film positions (px, py) of the perspective camera."""
    sx = px / float(sc.width) - 0.5
    sy = (py / float(sc.height) - 0.5) * sc.aspect
    d = (sc.cam_z * sc.focal + sc.cam_x * sx[..., None]
         - sc.cam_y * sy[..., None])
    d = _unit(d)
    return sc.cam_origin.expand_as(d), d


# ---------------------------------------------------------------- surface

def _texture(tex: Tensor, uv: Tensor) -> Tensor:
    """Bilinear, repeated image lookup at uv (v up, rows top down)."""
    h, w = tex.shape[:2]
    # the texture mapper's uv space: [0, 1] -> [-1, 1] and back
    u = 0.5 * ((2.0 * uv[..., 0] - 1.0) + 1.0)
    v = 0.5 * ((2.0 * uv[..., 1] - 1.0) + 1.0)
    u = torch.remainder(u, 1.0)
    v = torch.remainder(1.0 - v, 1.0)
    fx = u * float(w) - 0.5
    fy = v * float(h) - 0.5
    x0, y0 = torch.floor(fx), torch.floor(fy)
    tx, ty = (fx - x0)[..., None], (fy - y0)[..., None]
    x0, y0 = x0.long(), y0.long()
    at = lambda x, y: tex[torch.remainder(y, h), torch.remainder(x, w)]
    return ((at(x0, y0) * (1 - tx) + at(x0 + 1, y0) * tx) * (1 - ty)
            + (at(x0, y0 + 1) * (1 - tx) + at(x0 + 1, y0 + 1) * tx) * ty)


class Hits:
    """The surface at each ray's hit."""

    def __init__(self, sc: Scene, colour: Tensor, o, d, found, t, prim, bu,
                 bv):
        self.found = found
        self.prim = torch.where(found, prim, -1)
        t = torch.where(found, t, 1.0)
        self.p = o + d * t[..., None]
        pr = prim.clamp_min(0)
        tri = sc.tri[pr]
        e1 = tri[:, 1] - tri[:, 0]
        e2 = tri[:, 2] - tri[:, 0]
        self.ng = _unit(_cross_once(e1, e2))
        self.n = self.ng
        uvt = sc.tri_uv[pr]
        w = 1.0 - bu - bv
        self.uv = (w[:, None] * uvt[:, 0] + bu[:, None] * uvt[:, 1]
                   + bv[:, None] * uvt[:, 2])
        du1 = uvt[:, 1, 0] - uvt[:, 0, 0]
        du2 = uvt[:, 2, 0] - uvt[:, 0, 0]
        dv1 = uvt[:, 1, 1] - uvt[:, 0, 1]
        dv2 = uvt[:, 2, 1] - uvt[:, 0, 1]
        det = du1 * dv2 - dv1 * du2
        flat = torch.abs(det) <= 1e-12
        inv = torch.where(flat, 0.0, 1.0 / torch.where(det == 0, 1.0, det))
        dpdu = (dv2 * inv)[:, None] * e1 + (-dv1 * inv)[:, None] * e2
        dpdu = torch.where(flat[:, None], _basis(self.ng)[0], dpdu)
        self.nu = _unit(dpdu - self.n * _dot(dpdu, self.n)[..., None])
        self.nv = _cross_once(self.n, self.nu)
        self.light = torch.where(found, sc.tri_light[pr], -1)
        mat = sc.tri_mat[pr].clamp_min(0)
        col = colour[mat]
        if sc.texture is not None:
            col = torch.where(sc.textured[mat][:, None],
                              _texture(sc.texture, self.uv), col)
        self.colour = col
        self.reflect = sc.reflect[mat]

    def f_lambert(self):
        return (self.reflect * INV_PI)[:, None] * self.colour

    def lambert(self, wo, wi):
        """(f, pdf) of the Lambert surface for directions wo, wi."""
        cz_o = _dot(wo, self.n)
        cz_i = _dot(wi, self.n)
        same = (cz_o * cz_i) > 0.0
        f = torch.where(same[:, None], self.f_lambert(), 0.0)
        pdf = torch.where(same, torch.abs(cz_i) * INV_PI, 0.0)
        return f, pdf


# ---------------------------------------------------------------- lights

def _sample_light(sc: Scene, li: int, p: Tensor, u1: Tensor, u2: Tensor):
    """(wi, dist, pdf, radiance, valid) toward light li from points p."""
    L = sc.lights[li]
    n = p.shape[0]
    if L["kind"] == "area":
        lp = L["corner"] + L["e1"] * u1[:, None] + L["e2"] * u2[:, None]
        to = lp - p
        d2 = torch.clamp_min(_dot(to, to), 1e-12)
        dist = torch.sqrt(d2)
        wi = to / dist[:, None]
        cos_l = _dot(-wi, L["normal"])
        pdf = d2 / torch.clamp_min(L["area"] * torch.clamp_min(cos_l, 1e-9),
                                   1e-12)
        return wi, dist, pdf, L["radiance"].expand(n, 3), cos_l > 1e-6
    if L["kind"] == "sun":
        ax = L["toward"]
        bu, bv = _basis(ax)
        cos_t = 1.0 - u1 * (1.0 - L["cos_max"])
        sin_t = torch.sqrt(torch.clamp_min(1.0 - cos_t * cos_t, 0.0))
        phi = (2.0 * math.pi) * u2
        c = torch.stack([sin_t * torch.cos(phi), sin_t * torch.sin(phi),
                         cos_t], -1)
        wi = bu * c[:, 0:1] + bv * c[:, 1:2] + ax * c[:, 2:3]
        pdf = 1.0 / torch.clamp_min(
            2.0 * math.pi * (1.0 - L["cos_max"]), 1e-9)
        return (wi, torch.full((n,), math.inf, device=p.device),
                pdf.expand(n),
                L["radiance"].expand(n, 3),
                torch.ones(n, dtype=torch.bool, device=p.device))
    # the background: uniform over the sphere
    z = 1.0 - 2.0 * u1
    r = torch.sqrt(torch.clamp_min(1.0 - z * z, 0.0))
    phi = (2.0 * math.pi) * u2
    wi = torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], -1)
    return (wi, torch.full((n,), math.inf, device=p.device),
            torch.full((n,), 1.0 / (4.0 * math.pi), device=p.device),
            sc.background.expand(n, 3),
            torch.ones(n, dtype=torch.bool, device=p.device))


def _visible(sc, tris, p, prim, wi, dist):
    """1 where the shadow ray from p toward wi reaches dist unblocked."""
    b = sc.shadow_bias
    t_max = torch.where(torch.isinf(dist), 1e30, dist - 2.0 * b)
    hit = RY.blocked(tris, p + wi * b, wi, t_max, prim)
    return torch.where(hit, 0.0, 1.0)[:, None]


# ---------------------------------------------------------------- paths

def radiance(sc: Scene, tris: RY.Triangles, colour: Tensor, bounces: int,
             rr_min: int, o: Tensor, d: Tensor, pixel: Tensor,
             sample: int):
    """(rgb f32[N, 3], alpha f32[N]) of the paths from rays (o, d) of
    pixels `pixel` at sample index `sample`, with the materials' diffuse
    colours `colour` (f32[M, 3]), in which it is differentiable."""
    n = o.shape[0]
    dev = o.device
    rad = torch.zeros((n, 3), device=dev)
    thr = torch.ones((n, 3), device=dev)
    alpha = torch.zeros(n, device=dev)
    lanes = torch.arange(n, device=dev)       # the paths still going
    prev_prim = torch.full((n,), -1, dtype=torch.int64, device=dev)
    prev_pdf = torch.zeros(n, device=dev)
    prev_p = o
    n_lights = len(sc.lights)
    for depth in range(bounces + 1):
        if lanes.numel() == 0:
            break
        lo, ld = o[lanes], d[lanes]
        found, t, prim, bu, bv = RY.closest(
            tris, lo.detach(), ld.detach(),
            torch.full((lanes.numel(),), sc.min_dist, device=dev),
            torch.full((lanes.numel(),), 1e30, device=dev),
            prev_prim[lanes])
        if depth == 0:
            alpha = alpha.index_put((lanes,), found.float())
        hs = Hits(sc, colour, lo, ld, found, t, prim, bu, bv)
        th = thr[lanes]
        first = depth == 0
        # escaped: the background
        if sc.bg_light:
            w_bg = (torch.ones_like(t) if first else _power(
                prev_pdf[lanes], torch.full_like(t, 1.0 / (4.0 * math.pi))))
            bg = th * sc.background * w_bg[:, None]
        else:
            bg = th * sc.background
        add = torch.where((~found)[:, None], bg, 0.0)
        # an area light: its radiance from the front, weighted against
        # its sampling
        on_light = found & (hs.light >= 0)
        if bool(on_light.any()):
            li = hs.light.clamp_min(0)
            emit = torch.zeros_like(th)
            w_hit = torch.ones_like(t)
            for k, L in enumerate(sc.lights):
                if L["kind"] != "area":
                    continue
                m = on_light & (li == k)
                front = _dot(-ld, hs.ng) > 0.0
                emit = torch.where((m & front)[:, None], L["radiance"], emit)
                if not first:
                    to = hs.p - prev_p[lanes]
                    d2 = torch.clamp_min(_dot(to, to), 1e-12)
                    wv = to * torch.rsqrt(d2)[:, None]
                    cos_l = torch.abs(_dot(-wv, hs.ng))
                    lpdf = d2 / torch.clamp_min(
                        L["area"] * torch.clamp_min(cos_l, 1e-9), 1e-12)
                    w_hit = torch.where(m, _power(prev_pdf[lanes], lpdf),
                                        w_hit)
            add = add + torch.where(on_light[:, None],
                                    th * emit * w_hit[:, None], 0.0)
        live = found & ~on_light
        wo = -ld
        # next-event estimation, every light
        for k in range(n_lights):
            u = C.uniforms(pixel[lanes], sample, depth, 10 + 2 * k)
            wi, dist, lpdf, lrad, lok = _sample_light(sc, k, hs.p, u[:, 0],
                                                      u[:, 1])
            f, bpdf = hs.lambert(wo, wi)
            pot = lok & live & (f.amax(-1) > 0.0)
            vis = torch.ones((lanes.numel(), 1), device=dev)
            idx = torch.nonzero(pot).squeeze(1)
            if idx.numel():
                vis = vis.index_put((idx,), _visible(
                    sc, tris, hs.p[idx].detach(), hs.prim[idx],
                    wi[idx].detach(), dist[idx]))
            cos_s = _dot(wi, hs.n)
            kk = lrad * (torch.abs(cos_s) * _power(lpdf, bpdf) / lpdf)[:, None]
            add = add + torch.where(pot[:, None], th * (f * kk * vis), 0.0)
        rad = rad.index_put((lanes,), add, accumulate=True)
        if depth == bounces:
            break
        # the next direction: cosine-weighted on the side wo lies
        u = C.uniforms(pixel[lanes], sample, depth, 2)
        r = torch.sqrt(u[:, 0])
        phi = (2.0 * math.pi) * u[:, 1]
        cz_o = _dot(wo, hs.n)
        sgn = torch.where(cz_o < 0.0, -1.0, 1.0)
        loc = torch.stack([r * torch.cos(phi), r * torch.sin(phi),
                           torch.sqrt(torch.clamp_min(1.0 - u[:, 0], 0.0))],
                          -1) * sgn[:, None]
        same = (cz_o * loc[:, 2]) > 0.0
        cz = torch.abs(loc[:, 2])
        f = torch.where(same[:, None], hs.f_lambert(), 0.0)
        pdf = torch.where(same, cz * INV_PI, 0.0)
        weight = f * (cz / torch.clamp_min(pdf, 1e-9))[:, None]
        wi = (loc[:, 0:1] * hs.nu + loc[:, 1:2] * hs.nv
              + loc[:, 2:3] * hs.n)
        go = live & (pdf > 1e-9)
        new_thr = th * weight
        if depth >= rr_min:
            keep_p = torch.clamp(new_thr.amax(-1), 0.05, 1.0)
            new_thr = new_thr / keep_p[:, None]
            go = go & ~(u[:, 3] > keep_p)
        thr = thr.index_put((lanes,), torch.where(go[:, None], new_thr, th))
        prev_p = prev_p.index_put((lanes,), hs.p.detach())
        prev_prim = prev_prim.index_put((lanes,), hs.prim)
        prev_pdf = prev_pdf.index_put((lanes,), pdf.detach())
        o = o.index_put((lanes,), (hs.p + wi * sc.shadow_bias).detach())
        d = d.index_put((lanes,), wi.detach())
        lanes = lanes[go]
    return rad, alpha
