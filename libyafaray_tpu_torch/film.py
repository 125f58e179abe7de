"""Image film: weighted sample accumulation with the box filter.

Counterpart of `libyafaray_tpu/film.py` (`make_film`, `add_samples`,
`resolve`) for the `combined` layer. A render pass splats exactly one sample
per pixel, so the scatter-add of a pass touches each pixel once and is
deterministic.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import torch

Tensor = torch.Tensor


@dataclass
class Film:
    weights: Tensor               # f32[H, W]
    layers: Dict[str, Tensor]     # "combined" -> f32[H, W, 4] (rgb, alpha)

    @property
    def height(self) -> int:
        return self.weights.shape[0]

    @property
    def width(self) -> int:
        return self.weights.shape[1]


def make_film(width: int, height: int, device) -> Film:
    zeros = lambda *shape: torch.zeros(shape, dtype=torch.float32,
                                       device=device)
    return Film(weights=zeros(height, width),
                layers={"combined": zeros(height, width, 4)})


def add_samples(film: Film, px: Tensor, py: Tensor,
                layer_values: Dict[str, Tensor], weight: Tensor) -> Film:
    """Splat a wavefront of samples at continuous pixel coords (px, py) with
    the box filter (one tap); `weight` masks dead lanes. In place."""
    h, w = film.height, film.width
    tx = torch.floor(px).long()
    ty = torch.floor(py).long()
    in_img = (tx >= 0) & (tx < w) & (ty >= 0) & (ty < h)
    wgt = torch.where(in_img, weight, 0.0)
    idx = (torch.clamp(ty, 0, h - 1), torch.clamp(tx, 0, w - 1))
    film.weights.index_put_(idx, wgt, accumulate=True)
    for name, val in layer_values.items():
        film.layers[name].index_put_(idx, val * wgt[..., None], accumulate=True)
    return film


def resolve(film: Film, layer: str = "combined") -> Tensor:
    """Normalize the accumulated layer by the weights (ImageFilm::flush)."""
    return film.layers[layer] / torch.clamp_min(film.weights, 1e-12)[..., None]
