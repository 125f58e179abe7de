"""Render orchestration: pixels -> camera rays -> integrator -> film.

Counterpart of `libyafaray_tpu/render.py` (`AAParams`, `render`,
`render_pass_fn`, `_render_ids`, `compute_resample_mask`): the multi-pass
loop of libYafaRay's adaptive anti-aliasing. The first pass renders
`aa_samples` samples of every pixel; each of the `aa_passes - 1` passes
after it renders `aa_inc_samples` samples of the pixels that
`compute_resample_mask` flags, as one compacted wavefront of their ids.
Samples are keyed by (pixel id, sample index + the film's base sampling
offset) alone, so a compacted pass draws exactly the samples that a full
pass with the other pixels masked would (the JAX package runs that masked
pass above half the image, to bound its recompiles; eager torch has none,
and the compacted wavefront never holds more lanes). The film carries the reconstruction filter and the AOV layers; a
render can be saved, resumed from its film file and autosaved. Each pass
runs eagerly on the card (or on the device the caller names). Before the
passes, the single-scatter integrator's "optimize" mode gets its
attenuation grid and the photon-mapping integrator its photon maps (built,
saved or loaded), once per render. The bidirectional integrator's
light-tracing splats go to the film's splat accumulator.
"""
from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from . import film as F
from . import sampler
from .cameras import lens_samples, shoot_rays
from .integrators.mc import IntegratorConfig, integrate
from .integrators.volume import interp
from .scene_types import PhotonData, SceneData
from .utils import profiling as PF

Tensor = torch.Tensor


@dataclass(frozen=True)
class AAParams:
    """Adaptive-AA settings (Scene::setupSceneRenderParams' AA params and
    AaNoiseParams, scene.cc:582-610)."""
    aa_samples: int = 1
    aa_passes: int = 1
    aa_inc_samples: int = 1
    threshold: float = 0.05
    dark_detection_type: str = "none"        # none | linear | curve
    dark_threshold_factor: float = 0.0
    detect_color_noise: bool = False
    variance_edge_size: int = 10
    variance_pixels: int = 0


def pixel_jitter(pixel_id: Tensor, s_idx: int, width: int):
    """The film position (px, py) of sample s_idx of each pixel id: the
    pixel's corner plus an Owen-scrambled (0,2)-sequence per pixel."""
    scramble = sampler.pcg4d(torch.stack(
        [pixel_id, torch.full_like(pixel_id, 0x9E3779B9),
         torch.full_like(pixel_id, 7), torch.full_like(pixel_id, 11)],
        dim=-1))[..., 0]
    ju, jv = sampler.ld02(s_idx, scramble)
    return ((pixel_id % width).to(torch.float32) + ju,
            (pixel_id // width).to(torch.float32) + jv)


def camera_rays(cam, pixel_id: Tensor, s_idx: int, width: int):
    """The camera rays of sample s_idx of each pixel id: the pixel jitter
    and the lens samples. Returns (px, py, origin, direction, valid)."""
    px, py = pixel_jitter(pixel_id, s_idx, width)
    lens_u, lens_v = lens_samples(cam, pixel_id, s_idx)
    return (px, py) + shoot_rays(cam, px, py, lens_u, lens_v)


def _render_ids(scene: SceneData, cfg: IntegratorConfig, film: F.Film,
                sample_idx: int, pixel_id: Tensor, live: Tensor) -> F.Film:
    """Render one sample for each pixel id in `pixel_id` (int64 [M]) and
    accumulate it into the film; `live` masks lanes. Sampling is keyed
    purely by (pixel_id, sample_idx + the film's base sampling offset)."""
    # the per-node sample stream (the reference's adv_base_sampling_offset),
    # uint32 as in the JAX package, held in int64 as the sampler holds it
    s_idx = (int(sample_idx) + film.base_sampling_offset) & sampler.M32
    with PF.span("render.camera"):
        px, py, o, d, valid = camera_rays(scene.camera, pixel_id, s_idx,
                                          film.width)
    valid = valid & live
    rgb, alpha, aux = integrate(scene, cfg, o, d, valid, pixel_id, s_idx)
    weight = valid.to(torch.float32)
    if "splat_px" in aux:
        # the bidirectional integrator's light-tracing splats go to their
        # own accumulator, normalized at resolve by the light subpaths
        # traced: the lanes of this wavefront that traced one (the sum of
        # the lane weights), not height x width, which a compacted pass
        # would under-weight
        film = F.add_splats(film, aux.pop("splat_px"), aux.pop("splat_py"),
                            aux.pop("splat_rgb"), n_paths=weight.sum())
    layer_vals = {"combined": torch.cat([rgb, alpha[..., None]], dim=-1)}
    # the film keeps the layers it carries
    layer_vals.update({k: v for k, v in aux.items() if k in film.layers})
    return F.add_samples(film, px, py, layer_vals, weight)


def render_pass_fn(scene: SceneData, cfg: IntegratorConfig, film: F.Film,
                   sample_idx: int) -> F.Film:
    """Render one sample per pixel and accumulate it into the film."""
    h, w = film.height, film.width
    pixel_id = torch.arange(h * w, dtype=torch.int64, device=film.device)
    live = torch.ones((h * w,), dtype=torch.bool, device=film.device)
    return _render_ids(scene, cfg, film, sample_idx, pixel_id, live)


# darkThresholdCurveInterpolate (imagefilm.cc:799-816) as knots: a
# piecewise-linear map from pixel brightness to the AA threshold
_DARK_CURVE_X = np.asarray([0.10, 0.20, 0.30, 0.40, 0.50, 0.60, 0.70,
                            0.80, 0.90, 1.00, 1.20, 1.40, 1.80], np.float32)
_DARK_CURVE_Y = np.asarray([0.0001, 0.0010, 0.0020, 0.0035, 0.0055,
                            0.0075, 0.0100, 0.0150, 0.0250, 0.0400,
                            0.0800, 0.0950, 0.1000], np.float32)


def _shift_edge(img: Tensor, dy: int, dx: int) -> Tensor:
    """img shifted by (dy, dx) with its edge replicated (jnp.pad "edge"), so
    border pixels compare against themselves, as the reference's bounded
    loops do."""
    h, w = img.shape[:2]
    rows = torch.clamp(torch.arange(h, device=img.device) + dy, 0, h - 1)
    cols = torch.clamp(torch.arange(w, device=img.device) + dx, 0, w - 1)
    return img[rows][:, cols]


def _window(x: Tensor, size: int, dim: int, reduce) -> Tensor:
    """`reduce` (torch.add or torch.maximum) over a window of `size` along
    `dim` at stride 1, as `jax.lax.reduce_window(..., "SAME")` pads it with
    0: (size - 1) // 2 before and size // 2 after. An even window pads
    asymmetrically, so the padding is explicit (torch's pooling pads both
    sides alike)."""
    lo, hi = (size - 1) // 2, size // 2
    pad = [0, 0, 0, 0]
    pad[2 * (1 - dim)] = lo
    pad[2 * (1 - dim) + 1] = hi
    xp = torch.nn.functional.pad(x, pad)
    n = x.shape[dim]
    out = xp.narrow(dim, 0, n)
    for k in range(1, size):
        out = reduce(out, xp.narrow(dim, k, n))
    return out


def compute_resample_mask(film: F.Film, aa: AAParams) -> Tensor:
    """Adaptive-AA noise detection (ImageFilm::nextPass,
    imagefilm.cc:300-426), the JAX package's three criteria:

    1. a per-pixel threshold scaled by brightness: dark detection "linear"
       (thr * ((1 - f) + bri * f)) or "curve" (darkThresholdCurveInterpolate);
    2. the colour difference against the 4 forward neighbours (x+1, y),
       (x, y+1), (x+1, y+1), (x-1, y+1), flagging both pixels of a noisy
       pair;
    3. the variance window: the row and column neighbour pairs over the
       threshold inside a window; where they reach variance_pixels, the
       whole window around the pixel is flagged.

    Unrendered pixels (weight 0, after a film reload) are always flagged.
    Returns f32[H, W] of 0 and 1, equal to the JAX package's on the same
    film."""
    img = F.resolve(film, "combined")[..., :3]
    bri = (0.2126 * torch.abs(img[..., 0]) + 0.7152 * torch.abs(img[..., 1])
           + 0.0722 * torch.abs(img[..., 2]))        # Rgb::abscol2Bri
    if aa.dark_detection_type == "linear" and aa.dark_threshold_factor > 0:
        f = aa.dark_threshold_factor
        thr = aa.threshold * ((1.0 - f) + bri * f)
    elif aa.dark_detection_type == "curve":
        # jnp.interp is jitted, and XLA fuses its last step into a fused
        # multiply-add: `volume.interp` computes it exactly, as XLA does
        knots = lambda a: torch.from_numpy(a).to(bri.device)
        thr = interp(bri, knots(_DARK_CURVE_X), knots(_DARK_CURVE_Y))
    else:
        thr = torch.full_like(bri, aa.threshold)

    def cdiff(a, b):
        # Rgba::colorDifference (color.h:450-468): the luminance
        # difference, optionally maxed with the per-channel differences
        la = 0.2126 * a[..., 0] + 0.7152 * a[..., 1] + 0.0722 * a[..., 2]
        lb = 0.2126 * b[..., 0] + 0.7152 * b[..., 1] + 0.0722 * b[..., 2]
        d = torch.abs(la - lb)
        if aa.detect_color_noise:
            d = torch.maximum(d, torch.amax(torch.abs(a - b), dim=-1))
        return d

    mask = film.weights <= 0.0
    for dy, dx in ((0, 1), (1, 0), (1, 1), (1, -1)):
        noisy = cdiff(img, _shift_edge(img, dy, dx)) >= thr
        # both pixels of a noisy pair (flags_.set on both)
        mask = mask | noisy | _shift_edge(noisy, -dy, -dx)

    if aa.variance_pixels > 0:
        half = max(aa.variance_edge_size // 2, 1)
        ex = (cdiff(img, _shift_edge(img, 0, 1)) >= thr).to(torch.float32)
        ey = (cdiff(img, _shift_edge(img, 1, 0)) >= thr).to(torch.float32)
        win = 2 * half - 1
        cnt = (_window(ex, win, 1, torch.add)
               + _window(ey, win, 0, torch.add))
        vflag = (cnt >= aa.variance_pixels).to(torch.float32)
        # flag the whole window around each trigger: a 2*half x 2*half box
        box = 2 * half
        vflag = _window(_window(vflag, box, 1, torch.maximum), box, 0,
                        torch.maximum) > 0.5
        mask = mask | vflag
    return mask.to(torch.float32)


def _photon_maps(scene: SceneData, cfg: IntegratorConfig, mode: str,
                 path: Optional[str], device) -> PhotonData:
    """The photon maps of a render (SurfaceIntegrator::preprocess,
    integrator_photon_mapping.cc:242; its processing modes, :790-846)."""
    from . import photon as PH
    if (mode in ("load", "reuse-previous") and path is not None
            and os.path.exists(path)):
        return PH.load_maps(path, device)
    PF.count("table_builds.photon_maps")
    dmap, cmap, rcache = PH.make_maps(scene, cfg.n_photons, cfg.pm_bounces,
                                      cfg.pm_radius,
                                      final_gather=cfg.final_gather)
    photons = PhotonData(diffuse=dmap, caustic=cmap, radiance=rcache,
                         n_emitted=cfg.n_photons)
    if mode == "generate-save" and path is not None:
        PH.save_maps(photons, path)
    return photons


@PF.span("render.image")
def render(scene: SceneData, cfg: IntegratorConfig, width: Optional[int] = None,
           height: Optional[int] = None, spp: int = 16,
           aa: Optional[AAParams] = None,
           layer_names: Tuple[str, ...] = ("combined",),
           flt_kind: str = "box", flt_width: float = 1.0,
           computer_node: int = 0, film: Optional[F.Film] = None,
           start_sample: int = 0, progress_cb=None,
           film_path: Optional[str] = None,
           film_load_save_mode: str = "none",
           film_autosave_interval_passes: int = 0,
           photon_maps_processing: str = "generate",
           photon_map_path: Optional[str] = None,
           render_control=None, stats=None, *, device="cuda") -> F.Film:
    """The multi-pass render loop (TiledIntegrator::render) on `device`
    (the CUDA card unless the caller names another device, such as "cpu");
    returns the film.

    Without `aa`, one pass of `spp` samples. width/height default to the
    camera's resx/resy; a different size renders a crop of the camera frame
    (the film addresses camera pixels 1:1). `film_load_save_mode` "load" or
    "load-save" resumes from the film at `film_path` (and its sampling
    offset) when the file exists; "save" or "load-save" saves the film
    there at the end, and every `film_autosave_interval_passes` samples.
    Under photon mapping the maps are built once before the first pass
    (`photon_maps_processing` "generate"; "generate-save" also writes them
    to `photon_map_path`), or read from `photon_map_path` ("load" and
    "reuse-previous", when the file exists; else generated). `stats` (a
    `utils.profiling.RenderStats`) gets each pass's seconds and camera rays,
    the film's device synchronised before each pass ends, and the whole
    loop's "rendert" time."""
    width = scene.camera.resx if width is None else width
    height = scene.camera.resy if height is None else height
    scene = scene.to(device)
    if (scene.volumes is not None and cfg.vol_kind == "single_scatter"
            and cfg.vol_optimize and scene.vol_atten is None
            and scene.lights.num_lights > 0):
        # the per-light attenuation grid ("optimize",
        # integrator_single_scatter.cc:35-108)
        from .integrators.volume import build_attenuation_grid
        PF.count("table_builds.vol_atten")
        scene = dataclasses.replace(scene,
                                    vol_atten=build_attenuation_grid(scene))
    if cfg.kind == "photonmapping" and scene.photons is None:
        scene = dataclasses.replace(scene, photons=_photon_maps(
            scene, cfg, photon_maps_processing, photon_map_path, device))
    # film resume (film_load_save_mode load / load-save, imagefilm.cc:827-938
    # and the resumed render's offset, integrator_tiled.cc:155)
    if film is None and film_path is not None and film_load_save_mode in (
            "load", "load-save") and os.path.exists(film_path):
        film, start_sample = F.load_film(film_path, device)
        if render_control is not None:
            render_control.set_resumed()
    if film is None:
        film = F.make_film(width, height, layer_names, flt_kind, flt_width,
                           computer_node, device)
    cfg = dataclasses.replace(cfg, aov_layers=tuple(
        n for n in layer_names if n != "combined"))
    if aa is None:
        aa = AAParams(aa_samples=spp, aa_passes=1)
    s = start_sample

    def autosave(s_now):
        if (film_path is not None and film_autosave_interval_passes > 0
                and film_load_save_mode in ("save", "load-save")
                and s_now % film_autosave_interval_passes == 0):
            F.save_film(film, film_path, sampling_offset=s_now)

    def canceled():
        return render_control is not None and render_control.canceled

    def progress():
        if progress_cb:
            progress_cb(s, total)
        if render_control is not None:
            render_control.set_progress(s / max(total, 1))

    def begin_pass():
        if stats is not None:
            stats.begin_pass()

    def end_pass(rays):
        if stats is not None:
            # the pass's work, not its launches: wait for the device
            if film.device.type == "cuda":
                torch.cuda.synchronize(film.device)
            stats.end_pass(rays)

    if render_control is not None:
        render_control.set_started()
    total = aa.aa_samples + (aa.aa_passes - 1) * aa.aa_inc_samples
    if stats is not None:
        stats.start("rendert")
    # pass 1: aa_samples samples of every pixel
    for _ in range(aa.aa_samples):
        if canceled():
            break
        with PF.span("render.pass", index=s):
            begin_pass()
            film = render_pass_fn(scene, cfg, film, s)
            end_pass(width * height)
        s += 1
        autosave(s)
        progress()
    # the adaptive passes resample the flagged pixels only, compacted into
    # a short wavefront of their ids
    for _ in range(1, aa.aa_passes):
        if canceled():
            break
        mask = compute_resample_mask(film, aa)
        ids = torch.nonzero(mask.reshape(-1) > 0).squeeze(1)
        if ids.numel() == 0:
            break           # converged: the reference stops flagging too
        live = torch.ones_like(ids, dtype=torch.bool)
        for _ in range(aa.aa_inc_samples):
            with PF.span("render.pass", index=s):
                begin_pass()
                film = _render_ids(scene, cfg, film, s, ids, live)
                end_pass(ids.numel())
            s += 1
            autosave(s)
        progress()
    if (film_path is not None
            and film_load_save_mode in ("save", "load-save")):
        F.save_film(film, film_path, sampling_offset=s)
    if render_control is not None and not canceled():
        render_control.set_finished()
    if stats is not None:
        stats.stop("rendert")
    return film
