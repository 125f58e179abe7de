"""Render orchestration: pixels -> camera rays -> integrator -> film.

Counterpart of `libyafaray_tpu/render.py` (`render`, `render_pass_fn`,
`_render_ids`) for one AA pass of `spp` samples: the whole image is one
batch of rays per sample, run eagerly on the card (or on the device the
caller names). Before the passes, the single-scatter integrator's
"optimize" mode gets its attenuation grid, built once per render.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from . import film as F
from . import sampler
from .cameras import lens_samples, shoot_rays
from .integrators.mc import IntegratorConfig, integrate
from .scene_types import SceneData

Tensor = torch.Tensor


def _render_ids(scene: SceneData, cfg: IntegratorConfig, film: F.Film,
                sample_idx: int, pixel_id: Tensor, live: Tensor) -> F.Film:
    """Render one sample for each pixel id in `pixel_id` (int64 [M]) and
    accumulate it into the film; `live` masks lanes. Sampling is keyed
    purely by (pixel_id, sample_idx)."""
    w = film.width
    xx = pixel_id % w
    yy = pixel_id // w
    # pixel jitter: Owen-scrambled (0,2)-sequence per pixel
    scramble = sampler.pcg4d(torch.stack(
        [pixel_id, torch.full_like(pixel_id, 0x9E3779B9),
         torch.full_like(pixel_id, 7), torch.full_like(pixel_id, 11)],
        dim=-1))[..., 0]
    ju, jv = sampler.ld02(sample_idx, scramble)
    px = xx.to(torch.float32) + ju
    py = yy.to(torch.float32) + jv
    lens_u, lens_v = lens_samples(scene.camera, pixel_id, sample_idx)
    o, d, valid = shoot_rays(scene.camera, px, py, lens_u, lens_v)
    valid = valid & live
    rgb, alpha = integrate(scene, cfg, o, d, valid, pixel_id, sample_idx)
    layer_vals = {"combined": torch.cat([rgb, alpha[..., None]], dim=-1)}
    return F.add_samples(film, px, py, layer_vals, valid.to(torch.float32))


def render_pass_fn(scene: SceneData, cfg: IntegratorConfig, film: F.Film,
                   sample_idx: int) -> F.Film:
    """Render one sample per pixel and accumulate it into the film."""
    h, w = film.height, film.width
    dev = film.weights.device
    pixel_id = torch.arange(h * w, dtype=torch.int64, device=dev)
    live = torch.ones((h * w,), dtype=torch.bool, device=dev)
    return _render_ids(scene, cfg, film, sample_idx, pixel_id, live)


def render(scene: SceneData, cfg: IntegratorConfig, width: Optional[int] = None,
           height: Optional[int] = None, spp: int = 16, *,
           device="cuda", start_sample: int = 0) -> F.Film:
    """Render `spp` samples per pixel on `device` (the CUDA card unless the
    caller names another device, such as "cpu") and return the film.

    width/height default to the camera's resx/resy; a different size renders
    a crop of the camera frame (the film addresses camera pixels 1:1)."""
    width = scene.camera.resx if width is None else width
    height = scene.camera.resy if height is None else height
    scene = scene.to(device)
    if (scene.volumes is not None and cfg.vol_kind == "single_scatter"
            and cfg.vol_optimize and scene.vol_atten is None
            and scene.lights.num_lights > 0):
        # the per-light attenuation grid ("optimize",
        # integrator_single_scatter.cc:35-108)
        from .integrators.volume import build_attenuation_grid
        scene = dataclasses.replace(scene,
                                    vol_atten=build_attenuation_grid(scene))
    film = F.make_film(width, height, device)
    for s in range(start_sample, start_sample + spp):
        film = render_pass_fn(scene, cfg, film, s)
    return film
