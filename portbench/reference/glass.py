"""The reference for scenes with glass: Lambert surfaces, area lights and
the `glass` material, and SGD steps on the glass's IOR and an image
texture's texels.

The scene is staged on the reference's own recorder (`scene.py`); each
glass material is laid out as a Lambert row there and marked here, with
its IOR, filter and mirror colours (`build`). The tracer (`radiance`)
follows `tracer.py`'s estimator, depth after depth, with one more kind of
surface, libYafaRay's glass (src/material/material_glass.cc):

  - its reflectance Kr is the unpolarised Fresnel reflectance of a
    dielectric of index `ior` at |cos wo| (the same index on both sides,
    as material_glass.cc's `fresnel` takes it), and its lobes are delta
    reflection of weight Kr and delta transmission of weight 1 - Kr;
  - u3 of the bounce's uniforms (dim 2) picks reflection where it lies
    below Kr / (Kr + (1 - Kr)), transmission otherwise; the path's
    throughput takes the lobe's colour times its weight over its pick
    probability: the mirror colour on reflection, the filter colour on
    transmission;
  - transmission refracts wo through the normal on wo's side, by the
    relative index `ior` from the normal's side and 1 / `ior` from
    behind; under total internal reflection it reflects, with the mirror
    colour;
  - a delta lobe has no density: next-event estimation adds nothing at
    glass, and a path that reaches the area light through a delta bounce
    takes its emission with weight 1;
  - Russian roulette, from depth 2 on, as at a Lambert surface.

The floor's colour is a bilinear image texture (`tracer._texture`); its
texels are a leaf of the step, beside the glass's IOR.

Gradients flow to the IOR through the sampled directions and the points
where the next rays hit (each hit at o + t d with o and d the sampled
ray's, and t, the triangle and its barycentrics constants of the query,
as the program's estimator takes them), and to the texels through the
colours. The reference's one departure from the derivative of the image:
it leaves out the motion of each hit across its surface as the IOR bends
the ray, which changes t, the barycentrics, the texture coordinates and
at times the triangle (the program leaves it out too: ROADMAP section 3,
"The IOR gradient drops the ray-bending term").

It imports torch and numpy, never the program.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional

import numpy as np
import torch

from . import BLOCK, TRAIN_FAULTS
from . import counters as C
from . import rays as RY
from . import scene as SC
from . import tracer as T

Tensor = torch.Tensor

# the train-step faults of a glass scene: those of every train cell, the
# glass's IOR taken as 1.33 (water's) in place of its parameter, and each
# update at half the learning rate
GLASS_FAULTS = TRAIN_FAULTS + ("ior_133", "half_step")
FAULT_IOR = 1.33

# the reference's leaves: the IOR of every material row, f32[M], and the
# image texture's texels, f32[H, W, 3]
LEAVES = ("ior", "texels")


@dataclasses.dataclass
class GlassScene(SC.Scene):
    """`scene.Scene` with the glass rows of the material table."""
    glass: Tensor        # bool[M] the row is glass
    ior: Tensor          # f32[M] its index of refraction
    filter_colour: Tensor    # f32[M, 3] transmitted colour
    mirror_colour: Tensor    # f32[M, 3] reflected colour


def build(stage: SC.Stage, device) -> GlassScene:
    """The recorded scene as tensors on `device`: `scene.build` of the
    stage with each glass material laid out as a Lambert row, and the
    glass columns beside."""
    lambert = SC.Stage()
    lambert.__dict__.update({k: v for k, v in stage.__dict__.items()
                             if k != "materials"})
    lambert.materials = {}
    glass, ior, filt, mirror = [], [], [], []
    for name in stage.material_order:
        pm, nodes = stage.materials[name]
        is_glass = pm.get("type") == "glass"
        glass.append(is_glass)
        ior.append(float(pm.get("IOR", 1.5)) if is_glass else 1.0)
        filt.append(SC._f32(pm.get("filter_color", (1, 1, 1)))[:3])
        mirror.append(SC._f32(pm.get("mirror_color", (1, 1, 1)))[:3])
        if is_glass:
            for key in ("dispersion_power", "absorption", "fake_shadows",
                        "volume_handler"):
                if key in pm:
                    raise NotImplementedError(f"glass {key}")
            pm, nodes = {"type": "shinydiffusemat"}, []
        lambert.materials[name] = (pm, nodes)
    base = SC.build(lambert, device)
    t = lambda x, dt=torch.float32: torch.as_tensor(
        np.asarray(x), dtype=dt, device=device)
    return GlassScene(**{f.name: getattr(base, f.name)
                         for f in dataclasses.fields(SC.Scene)},
                      glass=t(glass, torch.bool), ior=t(ior),
                      filter_colour=t(np.stack(filt)),
                      mirror_colour=t(np.stack(mirror)))


class GlassReference:
    """A configuration's glass scene, staged and laid out for the
    reference."""

    def __init__(self, config, stage_kwargs: dict, render_params: dict,
                 device):
        st = config.stage(SC.Stage(), **stage_kwargs)
        st.set_render_params(dict(render_params))
        self.scene = build(st, device)
        if self.scene.texture is None:
            raise NotImplementedError("a glass scene without its texture")
        self.tris = RY.Triangles(self.scene.tri, self.scene.tri_shadow)
        icfg = dict(config.CONFIG["integrator"])
        if icfg.get("type", "pathtracing") != "pathtracing":
            raise NotImplementedError(f"integrator {icfg}")
        self.bounces = int(icfg.get("bounces", 4))
        self.rr_min = int(icfg.get("russian_roulette_min_bounces", 2))

    def leaves0(self) -> Dict[str, Tensor]:
        """The leaves as the configuration stages them."""
        return {"ior": self.scene.ior.clone(),
                "texels": self.scene.texture.clone()}


# ---------------------------------------------------------------- glass

def _fresnel(cos_wo: Tensor, ior: Tensor) -> Tensor:
    """The unpolarised Fresnel reflectance of a dielectric of index `ior`
    at incidence cosine |cos_wo| (1 beyond the critical angle)."""
    c = torch.clamp(torch.abs(cos_wo), 0.0, 1.0)
    sin2_t = torch.clamp_min(1.0 - c * c, 0.0) / (ior * ior)
    cos_t = torch.sqrt(torch.clamp_min(1.0 - sin2_t, 1e-12))
    r_par = (ior * c - cos_t) / (ior * c + cos_t)
    r_perp = (c - ior * cos_t) / (c + ior * cos_t)
    return torch.where(sin2_t >= 1.0, 1.0,
                       0.5 * (r_par * r_par + r_perp * r_perp))


def _glass_sample(wo_l: Tensor, ior: Tensor, filt: Tensor, mirror: Tensor,
                  u3: Tensor):
    """(wi_l, weight) of the glass's delta lobes in the local frame (z the
    normal): reflection or transmission picked by u3 against Kr."""
    kr = _fresnel(wo_l[:, 2], ior)
    w_r, w_t = kr, 1.0 - kr
    inv_sum = 1.0 / torch.clamp_min(w_r + w_t, 1e-6)
    p_r, p_t = w_r * inv_sum, w_t * inv_sum
    pick_r = u3 < p_r
    refl = torch.stack([-wo_l[:, 0], -wo_l[:, 1], wo_l[:, 2]], -1)
    # refraction through the normal on wo's side
    outside = wo_l[:, 2] > 0.0
    side = torch.where(wo_l[:, 2] < 0.0, -1.0, 1.0)
    eta = torch.where(outside, ior, 1.0 / ior)
    inv_eta = 1.0 / eta
    cos_i = torch.abs(wo_l[:, 2])
    sin2_t = inv_eta * inv_eta * torch.clamp_min(1.0 - cos_i * cos_i, 0.0)
    tir = sin2_t >= 1.0
    cos_t = torch.sqrt(torch.clamp_min(1.0 - sin2_t, 1e-12))
    n_l = torch.cat([torch.zeros_like(wo_l[:, :2]), side[:, None]], -1)
    refr = T._unit(-wo_l * inv_eta[:, None]
                   + (inv_eta * cos_i - cos_t)[:, None] * n_l)
    trans = torch.where(tir[:, None], refl, refr)
    col_t = torch.where(tir[:, None], mirror, filt)
    wi_l = torch.where(pick_r[:, None], refl, trans)
    col = torch.where(pick_r[:, None], mirror, col_t)
    w = torch.where(pick_r, w_r, w_t)
    p = torch.where(pick_r, p_r, p_t)
    return wi_l, col * (w / torch.clamp_min(p, 1e-9))[:, None]


# ---------------------------------------------------------------- paths

def radiance(sc: GlassScene, tris: RY.Triangles, ior: Tensor,
             texels: Tensor, bounces: int, rr_min: int, o: Tensor,
             d: Tensor, pixel: Tensor, sample: int) -> Tensor:
    """rgb f32[N, 3] of the paths from camera rays (o, d) of pixels `pixel`
    at sample index `sample`, differentiable in `ior` (f32[M]) and
    `texels` (the image texture, f32[H, W, 3])."""
    tsc = dataclasses.replace(sc, texture=texels)
    n = o.shape[0]
    dev = o.device
    rad = torch.zeros((n, 3), device=dev)
    thr = torch.ones((n, 3), device=dev)
    lanes = torch.arange(n, device=dev)       # the paths still going
    prev_prim = torch.full((n,), -1, dtype=torch.int64, device=dev)
    prev_pdf = torch.zeros(n, device=dev)
    prev_delta = torch.ones(n, dtype=torch.bool, device=dev)
    prev_p = o
    for depth in range(bounces + 1):
        if lanes.numel() == 0:
            break
        lo, ld = o[lanes], d[lanes]
        m = lanes.numel()
        found, t, prim, bu, bv = RY.closest(
            tris, lo.detach(), ld.detach(),
            torch.full((m,), sc.min_dist, device=dev),
            torch.full((m,), 1e30, device=dev), prev_prim[lanes])
        hs = T.Hits(tsc, sc.colour, lo, ld, found, t, prim, bu, bv)
        th = thr[lanes]
        add = torch.where((~found)[:, None], th * sc.background, 0.0)
        # an area light: its radiance from the front, weighted against its
        # sampling after a Lambert bounce, with weight 1 after a delta one
        on_light = found & (hs.light >= 0)
        if bool(on_light.any()):
            li = hs.light.clamp_min(0)
            emit = torch.zeros_like(th)
            w_hit = torch.ones_like(t)
            for k, L in enumerate(sc.lights):
                if L["kind"] != "area":
                    continue
                on = on_light & (li == k)
                front = T._dot(-ld, hs.ng) > 0.0
                emit = torch.where((on & front)[:, None], L["radiance"],
                                   emit)
                if depth > 0:
                    to = hs.p - prev_p[lanes]
                    d2 = torch.clamp_min(T._dot(to, to), 1e-12)
                    wv = to * torch.rsqrt(d2)[:, None]
                    cos_l = torch.abs(T._dot(-wv, hs.ng))
                    lpdf = d2 / torch.clamp_min(
                        L["area"] * torch.clamp_min(cos_l, 1e-9), 1e-12)
                    w_mis = torch.where(prev_delta[lanes], 1.0,
                                        T._power(prev_pdf[lanes], lpdf))
                    w_hit = torch.where(on, w_mis, w_hit)
            add = add + torch.where(on_light[:, None],
                                    th * emit * w_hit[:, None], 0.0)
        live = found & ~on_light
        mat = sc.tri_mat[prim.clamp_min(0)].clamp_min(0)
        is_glass = sc.glass[mat]
        wo = -ld
        # next-event estimation at the Lambert surfaces, every light
        for k in range(len(sc.lights)):
            u = C.uniforms(pixel[lanes], sample, depth, 10 + 2 * k)
            wi, dist, lpdf, lrad, lok = T._sample_light(sc, k, hs.p, u[:, 0],
                                                        u[:, 1])
            f, bpdf = hs.lambert(wo, wi)
            pot = lok & live & ~is_glass & (f.amax(-1) > 0.0)
            vis = torch.ones((m, 1), device=dev)
            idx = torch.nonzero(pot).squeeze(1)
            if idx.numel():
                vis = vis.index_put((idx,), T._visible(
                    sc, tris, hs.p[idx].detach(), hs.prim[idx],
                    wi[idx].detach(), dist[idx].detach()))
            cos_s = T._dot(wi, hs.n)
            kk = lrad * (torch.abs(cos_s) * T._power(lpdf, bpdf)
                         / lpdf)[:, None]
            add = add + torch.where(pot[:, None], th * (f * kk * vis), 0.0)
        rad = rad.index_put((lanes,), add, accumulate=True)
        if depth == bounces:
            break
        # the next direction: glass's delta lobes, or cosine-weighted on
        # the side wo lies
        u = C.uniforms(pixel[lanes], sample, depth, 2)
        wo_l = torch.stack([T._dot(wo, hs.nu), T._dot(wo, hs.nv),
                            T._dot(wo, hs.n)], -1)
        g_wi, g_weight = _glass_sample(
            wo_l, ior[mat], sc.filter_colour[mat], sc.mirror_colour[mat],
            u[:, 2])
        r = torch.sqrt(u[:, 0])
        phi = (2.0 * math.pi) * u[:, 1]
        sgn = torch.where(wo_l[:, 2] < 0.0, -1.0, 1.0)
        loc = torch.stack([r * torch.cos(phi), r * torch.sin(phi),
                           torch.sqrt(torch.clamp_min(1.0 - u[:, 0], 0.0))],
                          -1) * sgn[:, None]
        same = (wo_l[:, 2] * loc[:, 2]) > 0.0
        cz = torch.abs(loc[:, 2])
        f = torch.where(same[:, None], hs.f_lambert(), 0.0)
        pdf = torch.where(same, cz * T.INV_PI, 0.0)
        weight = torch.where(
            is_glass[:, None], g_weight,
            f * (cz / torch.clamp_min(pdf, 1e-9))[:, None])
        loc = torch.where(is_glass[:, None], g_wi, loc)
        pdf = torch.where(is_glass, 0.0, pdf)
        wi = (loc[:, 0:1] * hs.nu + loc[:, 1:2] * hs.nv
              + loc[:, 2:3] * hs.n)
        go = live & (is_glass | (pdf > 1e-9))
        new_thr = th * weight
        if depth >= rr_min:
            keep_p = torch.clamp(new_thr.amax(-1), 0.05, 1.0)
            new_thr = new_thr / keep_p[:, None]
            go = go & ~(u[:, 3] > keep_p)
        thr = thr.index_put((lanes,), torch.where(go[:, None], new_thr, th))
        prev_p = prev_p.index_put((lanes,), hs.p)
        prev_prim = prev_prim.index_put((lanes,), hs.prim)
        prev_pdf = prev_pdf.index_put((lanes,), pdf.detach())
        prev_delta = prev_delta.index_put((lanes,), is_glass)
        o = o.index_put((lanes,), hs.p + wi * sc.shadow_bias)
        d = d.index_put((lanes,), wi)
        lanes = lanes[go]
    return rad


# ---------------------------------------------------------------- steps

def train_steps(ref: GlassReference, params0: Dict[str, Tensor],
                target: Tensor, samples: List[int], lr: float,
                bf16: bool = False, fault: Optional[str] = None) -> dict:
    """SGD steps on the leaves {"ior": f32[M], "texels": f32[H, W, 3]} from
    `params0`, one at each sample index of `samples`: the whole frame, one
    sample at each pixel's centre, the mean squared error against `target`
    (f32[H, W, 3]). Returns {"losses": [float], "grads": the first step's
    gradients, "states": [leaves after each step]}, on the CPU. `bf16`
    rounds the radiance to bfloat16 before the loss, and its gradient
    with it (the control); `fault` plants one of GLASS_FAULTS."""
    if fault is not None and fault not in GLASS_FAULTS:
        raise ValueError(f"unknown fault {fault!r}")
    if set(params0) != set(LEAVES):
        raise NotImplementedError(f"parameters {sorted(params0)}")
    sc = ref.scene
    w, h = sc.width, sc.height
    dev = target.device
    n = h * w
    tgt = target.reshape(-1, 3)
    n_used = n // 2 if fault == "half_batch" else n
    cur = {k: v.to(dev) for k, v in params0.items()}
    if fault == "ior_133":
        cur["ior"] = torch.where(sc.glass, FAULT_IOR, cur["ior"])
    losses, states, grads0 = [], [], None
    for s in samples:
        leaves = {k: v.detach().clone().requires_grad_(True)
                  for k, v in cur.items()}
        total = torch.zeros((), dtype=torch.float64, device=dev)
        grad = {k: torch.zeros_like(v) for k, v in leaves.items()}
        for lo in range(0, n_used, BLOCK):
            pid = torch.arange(lo, min(n_used, lo + BLOCK), device=dev)
            px = (pid % w).to(torch.float32) + 0.5
            py = (pid // w).to(torch.float32) + 0.5
            o, d = T.camera_rays(sc, px, py)
            rgb = radiance(sc, ref.tris, leaves["ior"], leaves["texels"],
                           ref.bounces, ref.rr_min, o, d, pid,
                           int(s) & C.MASK)
            if bf16:
                rgb = rgb.to(torch.bfloat16).to(torch.float32)
            err = ((rgb - tgt[pid]) ** 2).sum() / (3.0 * n_used)
            gs = torch.autograd.grad(err, list(leaves.values()))
            for k, g in zip(leaves, gs):
                grad[k] += g
            total += err.detach().double()
        loss = float(total)
        if fault == "altered_loss":
            loss = loss * (1.0 + 1e-3)
        if grads0 is None:
            grads0 = {k: g.cpu() for k, g in grad.items()}
        if fault != "unchanged":
            rate = lr / 2 if fault == "half_step" else lr
            cur = {k: (leaves[k] - rate * grad[k]).detach() for k in leaves}
        losses.append(loss)
        states.append({k: v.cpu() for k, v in cur.items()})
    return {"losses": losses, "grads": grads0, "states": states}
