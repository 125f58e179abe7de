"""Backgrounds: constant, gradient, sunsky, darksky and texture (an
environment map), with `make_background` and `eval_background`.

Counterpart of `libyafaray_tpu/backgrounds/__init__.py`. The background
kind is static, so `eval_background` runs only the active kind's math.
Sunsky is the Preetham analytic sky as the reference evaluates it
(background_sunsky.cc); darksky the reference's extended Preetham model
(background_darksky.cc). A background with `ibl` also lights the scene:
`SceneBuilder` then adds a background light (`lights.LIGHT_BACKGROUND`),
which samples an environment map through its importance tables and every
other background uniformly over the sphere.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .. import params as P
from ..math import vec
from ..scene_types import Background, _Table

Tensor = torch.Tensor


def _f32(x) -> Tensor:
    return torch.tensor(np.asarray(x, np.float32))


# XYZ -> linear sRGB (D65)
_XYZ_TO_RGB = np.array([[3.2404542, -1.5371385, -0.4985314],
                        [-0.9692660, 1.8760108, 0.0415560],
                        [0.0556434, -0.2040259, 1.0572252]], np.float32)
# XYZ -> linear CIE RGB with the equal-energy white: the darksky default
_CIE_E_MAT = np.array([[2.3706743, -0.9000405, -0.4706338],
                       [-0.5138850, 1.4253036, 0.0885814],
                       [0.0052982, -0.0146949, 1.0093968]], np.float32)


def _mat3(xyz: Tensor, m: np.ndarray) -> Tensor:
    return xyz @ torch.from_numpy(m).to(xyz.device).T


@dataclass
class SunSky(_Table):
    """Preetham sky coefficients from the turbidity and the sun direction
    (background_sunsky.cc)."""
    sun_dir: Tensor        # f32[3] unit, toward the sun
    theta_s: Tensor        # f32[] sun zenith angle
    zenith_Y: Tensor       # f32[]
    zenith_x: Tensor       # f32[]
    zenith_y: Tensor       # f32[]
    perez_Y: Tensor        # f32[5]
    perez_x: Tensor        # f32[5]
    perez_y: Tensor        # f32[5]
    power: Tensor          # f32[]


def _perez(coef, cos_theta, gamma, cos_gamma):
    a, b, c, d, e = coef[0], coef[1], coef[2], coef[3], coef[4]
    ct = torch.clamp_min(cos_theta, 0.01)
    return ((1.0 + a * torch.exp(b / ct))
            * (1.0 + c * torch.exp(d * gamma) + e * cos_gamma * cos_gamma))


def make_sunsky(pm: P.ParamMap) -> SunSky:
    sd = np.asarray(pm.get_vector("from", (0.0, 0.0, 1.0)), np.float64)
    sd = sd / max(np.linalg.norm(sd), 1e-12)
    T = pm.get_float("turbidity", 3.0)
    theta_s = math.acos(max(min(sd[2], 1.0), -1.0))
    t2 = theta_s * theta_s
    t3 = t2 * theta_s
    T2 = T * T
    chi = (4.0 / 9.0 - T / 120.0) * (math.pi - 2.0 * theta_s)
    zenith_Y = (4.0453 * T - 4.9710) * math.tan(chi) - 0.2155 * T + 2.4192
    zenith_Y = max(zenith_Y * 1000.0, 1e-3)
    zenith_x = ((0.00165 * t3 - 0.00375 * t2 + 0.00209 * theta_s) * T2
                + (-0.02903 * t3 + 0.06377 * t2 - 0.03202 * theta_s
                   + 0.00394) * T
                + (0.11693 * t3 - 0.21196 * t2 + 0.06052 * theta_s + 0.25886))
    zenith_y = ((0.00275 * t3 - 0.00610 * t2 + 0.00317 * theta_s) * T2
                + (-0.04214 * t3 + 0.08970 * t2 - 0.04153 * theta_s
                   + 0.00516) * T
                + (0.15346 * t3 - 0.26756 * t2 + 0.06670 * theta_s + 0.26688))
    perez_Y = [0.17872 * T - 1.46303, -0.35540 * T + 0.42749,
               -0.02266 * T + 5.32505, 0.12064 * T - 2.57705,
               -0.06696 * T + 0.37027]
    perez_x = [-0.01925 * T - 0.25922, -0.06651 * T + 0.00081,
               -0.00041 * T + 0.21247, -0.06409 * T - 0.89887,
               -0.00325 * T + 0.04517]
    perez_y = [-0.01669 * T - 0.26078, -0.09495 * T + 0.00921,
               -0.00792 * T + 0.21023, -0.04405 * T - 1.65369,
               -0.01092 * T + 0.05291]
    return SunSky(
        sun_dir=_f32(sd), theta_s=_f32(theta_s), zenith_Y=_f32(zenith_Y),
        zenith_x=_f32(zenith_x), zenith_y=_f32(zenith_y),
        perez_Y=_f32(perez_Y), perez_x=_f32(perez_x), perez_y=_f32(perez_y),
        power=_f32(pm.get_float("power", 1.0)))


def _eval_sunsky(ss: SunSky, d: Tensor) -> Tensor:
    """The Preetham sky as the reference's getSkyCol evaluates it: below
    the horizon at the horizon (theta clamped to pi/2, the sun angle too)
    with a smoothstep fade to black, a night fade when the sun is below the
    horizon, luminance scaled by 1/15000, the RGB clamped to [0, 1] before
    the power."""
    z = torch.clamp(d[..., 2], -1.0, 1.0)
    theta_raw = torch.acos(z)
    half_pi = 0.5 * math.pi
    below = theta_raw > half_pi
    hf = 1.0 - (theta_raw / math.pi - 0.5) * 2.0
    hfade = torch.where(below, hf * hf * (3.0 - 2.0 * hf), 1.0)
    theta = torch.clamp_max(theta_raw, half_pi)
    cos_theta = torch.cos(theta)
    nf = ((1.0 - (0.5 - theta / math.pi) * 2.0)
          * (1.0 - (ss.theta_s / math.pi - 0.5) * 2.0))
    nfc = torch.clamp(nf, 0.0, 1.0)
    nfade = torch.where(ss.theta_s > half_pi, nfc ** 2 * (3.0 - 2.0 * nfc),
                        1.0)
    # gamma from the clamped theta
    phi = torch.atan2(d[..., 1], d[..., 0])
    phi_s = torch.atan2(ss.sun_dir[1], ss.sun_dir[0])
    sin_ts = torch.sin(ss.theta_s)
    cos_ts = torch.cos(ss.theta_s)
    cos_gamma = torch.clamp(torch.sin(theta) * sin_ts * torch.cos(phi_s - phi)
                            + cos_theta * cos_ts, -1.0, 1.0)
    gamma = torch.acos(cos_gamma)

    def rel(coef):
        # relative to the zenith (theta 0, gamma theta_s)
        num = _perez(coef, cos_theta, gamma, cos_gamma)
        den = _perez(coef, torch.ones_like(cos_theta),
                     ss.theta_s.expand(cos_theta.shape),
                     cos_ts.expand(cos_theta.shape))
        return num / torch.clamp_min(den, 1e-9)

    Y = (ss.zenith_Y * rel(ss.perez_Y) * np.float32(6.666666667e-5)
         * nfade * hfade)
    x = ss.zenith_x * rel(ss.perez_x)
    y = ss.zenith_y * rel(ss.perez_y)
    y_safe = torch.clamp_min(y, 1e-6)
    X = x / y_safe * Y
    Z = (1.0 - x - y) / y_safe * Y
    rgb = _mat3(torch.stack([X, Y, Z], dim=-1), _XYZ_TO_RGB)
    return torch.clamp(rgb, 0.0, 1.0) * ss.power


@dataclass
class DarkSky(_Table):
    """The reference's DarkSkyBackground: an altitude shift, the a..e
    Perez variance knobs, a sun-normalised prePerez, the exposure curve
    Y -> exp(Y exposure) - 1, a choice of RGB space and night mode."""
    sun_dir: Tensor        # f32[3] unit, toward the sun (altitude-shifted)
    theta_s: Tensor        # f32[]
    zenith_Y: Tensor       # f32[] (cd/m^2)
    zenith_x: Tensor       # f32[]
    zenith_y: Tensor       # f32[]
    perez_Y: Tensor        # f32[6] (A..E and the prePerez norm)
    perez_x: Tensor        # f32[6]
    perez_y: Tensor        # f32[6]
    power: Tensor          # f32[] power * bright^2
    alt: Tensor            # f32[] altitude shift added to dir.z
    exposure: Tensor       # f32[] (0 disables the exposure curve)
    night: bool = False
    color_space: str = "cie-e"


def make_darksky(pm: P.ParamMap) -> DarkSky:
    sd = np.asarray(pm.get_vector("from", (1.0, 1.0, 1.0)), np.float64)
    alt = pm.get_float("altitude", 0.0)
    sd[2] += alt
    sd = sd / max(np.linalg.norm(sd), 1e-12)
    T = pm.get_float("turbidity", 4.0)
    theta_s = math.acos(max(min(sd[2], 1.0), -1.0))
    t2, t3 = theta_s * theta_s, theta_s ** 3
    T2 = T * T
    cos_ts = math.cos(theta_s)
    chi = (4.0 / 9.0 - T / 120.0) * (math.pi - 2.0 * theta_s)
    zenith_Y = ((4.0453 * T - 4.9710) * math.tan(chi)
                - 0.2155 * T + 2.4192) * 1000.0
    zenith_x = ((0.00165 * t3 - 0.00374 * t2 + 0.00209 * theta_s) * T2
                + (-0.02902 * t3 + 0.06377 * t2 - 0.03202 * theta_s
                   + 0.00394) * T
                + (0.11693 * t3 - 0.21196 * t2 + 0.06052 * theta_s + 0.25885))
    zenith_y = ((0.00275 * t3 - 0.00610 * t2 + 0.00316 * theta_s) * T2
                + (-0.04214 * t3 + 0.08970 * t2 - 0.04153 * theta_s
                   + 0.00515) * T
                + (0.15346 * t3 - 0.26756 * t2 + 0.06669 * theta_s + 0.26688))
    av, bv, cv, dv, ev = (pm.get_float(k, 1.0) for k in
                          ("a_var", "b_var", "c_var", "d_var", "e_var"))

    def pre(c):
        num = ((1.0 + c[0] * math.exp(c[1]))
               * (1.0 + c[2] * math.exp(c[3] * theta_s) + c[4] * cos_ts ** 2))
        return 0.0 if num == 0.0 else 1.0 / num

    perez_Y = [(0.17872 * T - 1.46303) * av, (-0.35540 * T + 0.42749) * bv,
               (-0.02266 * T + 5.32505) * cv, (0.12064 * T - 2.57705) * dv,
               (-0.06696 * T + 0.37027) * ev]
    perez_x = [-0.01925 * T - 0.25922, -0.06651 * T + 0.00081,
               -0.00041 * T + 0.21247, -0.06409 * T - 0.89887,
               -0.00325 * T + 0.04517]
    perez_y = [-0.01669 * T - 0.26078, -0.09495 * T + 0.00921,
               -0.00792 * T + 0.21023, -0.04405 * T - 1.65369,
               -0.01092 * T + 0.05291]
    for c in (perez_Y, perez_x, perez_y):
        c.append(pre(c))
    night = pm.get_bool("night", False)
    return DarkSky(
        sun_dir=_f32(sd), theta_s=_f32(theta_s), zenith_Y=_f32(zenith_Y),
        zenith_x=_f32(zenith_x), zenith_y=_f32(zenith_y),
        perez_Y=_f32(perez_Y), perez_x=_f32(perez_x), perez_y=_f32(perez_y),
        # the reference applies `bright` twice: getSkyCol multiplies by the
        # sky brightness and eval() by power * bright
        power=_f32(pm.get_float("power", 1.0)
                   * pm.get_float("bright", 1.0) ** 2
                   * (0.5 ** 2 if night else 1.0)),
        alt=_f32(alt), exposure=_f32(pm.get_float("exposure", 1.0)),
        night=night,
        color_space=("srgb" if pm.get_string("color_space", "CIE (E)")
                     .startswith("sRGB") else "cie-e"))


def _eval_darksky(ds: DarkSky, d: Tensor) -> Tensor:
    iw = d + torch.tensor([0.0, 0.0, 1.0], device=d.device) * ds.alt
    iw = iw / torch.clamp_min(
        torch.sqrt(torch.sum(iw * iw, -1, keepdim=True)), 1e-12)
    cos_theta = torch.clamp_min(iw[..., 2], 1e-6)
    cos_gamma = torch.clamp(vec.dot(iw, ds.sun_dir), -1.0, 1.0)
    cos_gamma2 = cos_gamma * cos_gamma
    gamma = torch.acos(cos_gamma)

    def perez(lam, lvz):
        num = ((1.0 + lam[0] * torch.exp(lam[1] / cos_theta))
               * (1.0 + lam[2] * torch.exp(lam[3] * gamma)
                  + lam[4] * cos_gamma2))
        return lvz * num * lam[5]

    x = perez(ds.perez_x, ds.zenith_x)
    y = perez(ds.perez_y, ds.zenith_y)
    Y = perez(ds.perez_Y, ds.zenith_Y) * np.float32(6.66666667e-5)
    # the exposure curve (color_conversion.h fromxyY2Xyz)
    Y = torch.where(ds.exposure > 0.0, torch.exp(Y * ds.exposure) - 1.0, Y)
    y_safe = torch.clamp_min(y, 1e-6)
    X = x / y_safe * Y
    Z = (1.0 - x - y) / y_safe * Y
    xyz = torch.stack([X, Y, Z], dim=-1)
    rgb = _mat3(xyz, _XYZ_TO_RGB if ds.color_space == "srgb" else _CIE_E_MAT)
    # the reference's darksky always gamma-encodes (v^(1/2.2)) and clamps
    rgb = torch.clamp(torch.pow(torch.clamp_min(rgb, 0.0),
                                np.float32(1.0 / 2.2)), 0.0, 1.0)
    if ds.night:
        # night mode keeps a faint blue sky
        rgb = rgb * torch.tensor([0.05, 0.05, 0.08], device=d.device)
    return rgb * ds.power


def eval_background(scene, d: Tensor) -> Tensor:
    """Background::operator()(dir) for the whole wavefront."""
    bg: Background = scene.background
    kind = bg.kind
    if kind == "none":
        return torch.zeros(d.shape[:-1] + (3,), dtype=torch.float32,
                           device=d.device)
    if kind == "constant":
        return (bg.color * bg.power).expand(d.shape[:-1] + (3,))
    if kind == "gradient":
        # zenith / horizon colours above the horizon, ground colours below
        z = d[..., 2:3]
        above = torch.clamp(z, 0.0, 1.0)
        below = torch.clamp(-z, 0.0, 1.0)
        sky = bg.horizon_color + (bg.zenith_color - bg.horizon_color) * above
        ground = (bg.ground_horizon_color
                  + (bg.ground_zenith_color - bg.ground_horizon_color) * below)
        return torch.where(z >= 0, sky, ground) * bg.power
    if kind == "darksky":
        return _eval_darksky(bg.sunsky, d)
    if kind == "sunsky":
        return _eval_sunsky(bg.sunsky, d)
    if kind == "texture":
        from ..textures import sample_env
        return sample_env(scene, d, bg) * bg.power
    raise KeyError(f"background kind {kind!r}")


def make_background(pm: P.ParamMap, tex_id: int = -1) -> Background:
    """The background of reference-style params; `tex_id` is the texture of
    a texture background (-1: none)."""
    kind = pm.get_string("type", "constant")
    power = _f32(pm.get_float("power", 1.0))
    color = lambda key, default: _f32(pm.get_color(key, default)[:3])
    if kind == "constant":
        return Background(kind="constant", color=color("color", (1, 1, 1)),
                          power=power)
    if kind in ("gradientback", "gradient"):
        return Background(
            kind="gradient",
            horizon_color=color("horizon_color", (0.8, 0.9, 1.0)),
            zenith_color=color("zenith_color", (0.4, 0.5, 1.0)),
            ground_horizon_color=color("horizon_ground_color",
                                       (0.2, 0.2, 0.2)),
            ground_zenith_color=color("zenith_ground_color", (0.1, 0.1, 0.1)),
            power=power)
    if kind == "darksky":
        return Background(kind="darksky", sunsky=make_darksky(pm), power=power)
    if kind == "sunsky":
        return Background(kind="sunsky", sunsky=make_sunsky(pm), power=power)
    if kind in ("textureback", "texture"):
        return Background(
            kind="texture", tex_id=tex_id,
            rotation=_f32(pm.get_float("rotation", 0.0) * math.pi / 180.0),
            mapping=pm.get_string("mapping", "sphere"), power=power)
    raise KeyError(f"background: unknown type {kind!r}")


def sun_from_background(pm: P.ParamMap) -> Optional[P.ParamMap]:
    """The sunlight that a sunsky or darksky background's `add_sun` adds,
    toward `from`, with a closed-form Rayleigh + aerosol attenuated colour
    (the JAX package's approximation of the reference's solar spectrum
    integral); None without add_sun."""
    if not pm.get_bool("add_sun", False):
        return None
    sd = np.asarray(pm.get_vector("from", (1.0, 1.0, 1.0)), np.float64)
    sd = sd / max(np.linalg.norm(sd), 1e-12)
    turb = pm.get_float("turbidity", 4.0)
    theta = math.acos(max(min(sd[2], 1.0), -1.0))
    am = 1.0 / (math.cos(theta) + 0.15
                * max(93.885 - math.degrees(theta), 1e-3) ** -1.253)
    beta = 0.04608365822050 * turb - 0.04586025928522
    lam = np.array([0.612, 0.549, 0.465])  # um, the RGB primaries
    tau = (np.exp(-0.008735 * am * lam ** -4.08)
           * np.exp(-beta * am * lam ** -1.3))
    return P.ParamMap({
        "type": "sunlight", "direction": tuple(sd.tolist()),
        "color": tuple((tau / max(tau.max(), 1e-6)).tolist()),
        "power": pm.get_float("sun_power", 1.0),
        "cast_shadows": pm.get_bool("cast_shadows_sun", True)})
