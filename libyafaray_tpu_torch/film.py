"""Image film: weighted sample accumulation, reconstruction filters, AOVs.

Counterpart of `libyafaray_tpu/film.py`: per-layer colour accumulators and a
weight buffer, the box, Mitchell, Gauss and Lanczos reconstruction filters
evaluated per tap, the light-tracing splat accumulator, and film checkpoint,
resume and merge in the JAX package's `.film.npz` format (the same keys,
header, dtypes and shapes, so a film saved by either package loads in the
other). Splatting is a scatter-add per filter tap in the JAX order; within
one tap each pixel receives one sample (and lanes outside the image add an
exact 0 at a clamped pixel), so on the card the scatter is deterministic.
Films of several processes merge in memory by `psum_merge`, an all_reduce
over a `parallel.Mesh`.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .utils import profiling as PF

Tensor = torch.Tensor

FILM_HEADER = "YAF_TPU_FILM_v1"

# layer name -> channel count (the reference's layer types,
# include/common/layer_definitions.h:36-111)
LAYER_CHANNELS = {
    "combined": 4,
    "diffuse": 3,
    "emit": 3,
    "env": 3,
    "indirect": 3,
    "shadow": 3,
    "ao": 3,
    "z-depth-norm": 1,
    "z-depth-abs": 1,
    "normal-geom": 3,
    "normal-smooth": 3,
    "albedo": 3,
    "uv": 3,
    "mat-index-abs": 1,
    "obj-index-abs": 1,
    "debug-nu": 3,
    "debug-nv": 3,
    "debug-dpdu": 3,
    "debug-dpdv": 3,
    "debug-dsdu": 3,
    "debug-dsdv": 3,
    "debug-dpdx": 3,
    "debug-dpdy": 3,
    "debug-dpdxy": 3,
    "debug-barycentric-uvw": 3,
    "debug-wireframe": 3,
    "mist": 1,
    "mat-index-norm": 1,
    "obj-index-norm": 1,
    "mat-index-auto": 3,
    "obj-index-auto": 3,
    "mat-index-auto-abs": 3,
    "obj-index-auto-abs": 3,
    "mat-index-mask": 3,
    "obj-index-mask": 3,
    "diffuse-noshadow": 3,
    "diffuse-indirect": 3,
    "glossy-indirect": 3,
    "ao-clay": 3,
    "debug-aa-samples": 1,
    "debug-faces-edges": 3,
    "debug-objects-edges": 3,
    "toon": 3,
    "reflect": 3,
    "refract": 3,
    # adv-* layers: per-BSDF-family direct splits, first-bounce-lobe
    # indirect splits, photon radiance, the perfect specular pair, the
    # volume decomposition
    "adv-diffuse-color": 3,
    "adv-diffuse-indirect": 3,
    "adv-glossy": 3,
    "adv-glossy-color": 3,
    "adv-glossy-indirect": 3,
    "adv-indirect": 3,
    "adv-radiance": 3,
    "adv-reflect": 3,
    "adv-refract": 3,
    "adv-subsurface": 3,
    "adv-subsurface-color": 3,
    "adv-subsurface-indirect": 3,
    "adv-surface-integration": 3,
    "adv-trans": 3,
    "adv-trans-color": 3,
    "adv-trans-indirect": 3,
    "adv-volume-integration": 3,
    "adv-volume-transmittance": 1,
    # index-mask composites
    "mat-index-mask-all": 3,
    "mat-index-mask-shadow": 3,
    "obj-index-mask-all": 3,
    "obj-index-mask-shadow": 3,
    # debug layers
    "debug-dp-lengths": 3,
    "debug-dudx-dvdx": 3,
    "debug-dudy-dvdy": 3,
    "debug-dudxy-dvdxy": 3,
    "debug-light-estimation-light-dirac": 3,
    "debug-light-estimation-light-sampling": 3,
    "debug-light-estimation-mat-sampling": 3,
    "debug-sampling-factor": 1,
    # reference-name aliases of layers whose short names predate them
    "debug-uv": 3,
    "debug-normal-geom": 3,
    "debug-normal-smooth": 3,
}


@dataclass
class Film:
    weights: Tensor                 # f32[H, W]
    layers: Dict[str, Tensor]       # name -> f32[H, W, C]
    # light-tracing splat accumulator: raw sums of camera splats and the
    # number of light subpaths traced; resolved as combined += splat / paths
    splat: Optional[Tensor] = None          # f32[H, W, 3]
    splat_paths: Optional[Tensor] = None    # f32[] light subpaths
    flt_kind: str = "box"
    flt_width: float = 1.0
    base_sampling_offset: int = 0
    computer_node: int = 0

    @property
    def height(self) -> int:
        return self.weights.shape[0]

    @property
    def width(self) -> int:
        return self.weights.shape[1]

    @property
    def device(self) -> torch.device:
        return self.weights.device


def make_film(width: int, height: int, layer_names=("combined",),
              flt_kind: str = "box", flt_width: float = 1.0,
              computer_node: int = 0, device="cuda") -> Film:
    """An empty film on `device` (the CUDA card unless the caller names
    another device)."""
    zeros = lambda *shape: torch.zeros(shape, dtype=torch.float32,
                                       device=device)
    return Film(weights=zeros(height, width),
                layers={name: zeros(height, width, LAYER_CHANNELS[name])
                        for name in layer_names},
                splat=zeros(height, width, 3), splat_paths=zeros(),
                flt_kind=flt_kind, flt_width=float(flt_width),
                base_sampling_offset=computer_node * 100_000,
                computer_node=computer_node)


# --- reconstruction filter kernels (include/math/filter.h). Torch's exp and
# sin may differ from XLA's CPU code by an ulp: the weights are held to the
# JAX package's within 1e-6 relative, not bit for bit.

def _mitchell(x: Tensor) -> Tensor:
    """Mitchell-Netravali B = C = 1/3 on |x| in [0, 2]."""
    x = torch.abs(2.0 * x)
    x2 = x * x
    x3 = x2 * x
    b = c = 1.0 / 3.0
    inner = ((12.0 - 9.0 * b - 6.0 * c) * x3
             + (-18.0 + 12.0 * b + 6.0 * c) * x2 + (6.0 - 2.0 * b)) / 6.0
    outer = ((-b - 6.0 * c) * x3 + (6.0 * b + 30.0 * c) * x2
             + (-12.0 * b - 48.0 * c) * x + (8.0 * b + 24.0 * c)) / 6.0
    return torch.where(x < 1.0, inner, torch.where(x < 2.0, outer, 0.0))


def _gauss(x: Tensor) -> Tensor:
    alpha = 2.0
    x = torch.abs(2.0 * x)
    return torch.clamp_min(torch.exp(-alpha * x * x)
                           - math.exp(-alpha * 4.0), 0.0)


def _lanczos(x: Tensor) -> Tensor:
    x = torch.abs(2.0 * x)
    px = math.pi * x
    s = torch.where(x > 1e-5, torch.sin(px) / torch.clamp_min(px, 1e-9), 1.0)
    s2 = torch.where(x > 1e-5, torch.sin(px * 0.5)
                     / torch.clamp_min(px * 0.5, 1e-9), 1.0)
    return torch.where(x < 2.0, s * s2, 0.0)


def filter_weight(kind: str, dx: Tensor, dy: Tensor, width: float) -> Tensor:
    """The separable 2D filter's value at offset (dx, dy), |d| <= width."""
    if kind == "box":
        return torch.ones_like(dx)
    r = {"mitchell": _mitchell, "gauss": _gauss, "lanczos": _lanczos}[kind]
    return r(dx / width * 0.5) * r(dy / width * 0.5)


def _tap_offsets(kind: str, width: float):
    if kind == "box" or width <= 0.5:
        return [(0, 0)]
    n = int(np.ceil(width - 0.5))
    return [(dy, dx) for dy in range(-n, n + 1) for dx in range(-n, n + 1)]


@PF.span("film.add")
def add_samples(film: Film, px: Tensor, py: Tensor,
                layer_values: Dict[str, Tensor], weight: Tensor) -> Film:
    """Splat a wavefront of samples at continuous pixel coords (px, py)
    (ImageFilm::addSample): for each filter tap, scatter-add w * value into
    the layers and w into the weights; `weight` masks dead lanes. In place."""
    h, w = film.height, film.width
    ix = torch.floor(px).to(torch.int32)
    iy = torch.floor(py).to(torch.int32)
    fx = px - ix.to(torch.float32) - 0.5
    fy = py - iy.to(torch.float32) - 0.5
    for dy, dx in _tap_offsets(film.flt_kind, film.flt_width):
        tx = ix + dx
        ty = iy + dy
        in_img = (tx >= 0) & (tx < w) & (ty >= 0) & (ty < h)
        fw = filter_weight(film.flt_kind, dx - fx, dy - fy, film.flt_width)
        wgt = torch.where(in_img, fw * weight, 0.0)
        idx = (torch.clamp(ty, 0, h - 1).long(), torch.clamp(tx, 0, w - 1).long())
        film.weights.index_put_(idx, wgt, accumulate=True)
        for name, val in layer_values.items():
            film.layers[name].index_put_(idx, val * wgt[..., None],
                                         accumulate=True)
    return film


# layers derived at flush from other layers or the weights rather than
# accumulated per sample (ImageFilm::flush edge / toon post,
# image_manipulation.cc:103-113; debug-aa-samples from the weights)
FLUSH_LAYERS = ("debug-aa-samples", "debug-faces-edges",
                "debug-objects-edges", "toon")


def resolve(film: Film, layer: str = "combined") -> Tensor:
    """Normalize the accumulated layer by the weights (ImageFilm::flush).
    The flush layers go through the numpy post-processing, as in the JAX
    package; every result is a tensor on the film's device."""
    w = torch.clamp_min(film.weights, 1e-12)[..., None]
    if layer == "debug-aa-samples":
        return film.weights[..., None]
    if layer in ("debug-faces-edges", "debug-objects-edges", "toon"):
        from .io import postprocess as PP
        on_dev = lambda a: torch.from_numpy(np.ascontiguousarray(
            a, np.float32)).to(film.device)
        if layer == "debug-objects-edges" and "obj-index-abs" in film.layers:
            src = (film.layers["obj-index-abs"] / w).cpu().numpy()
            e = PP.sobel_edges(np.repeat(src, 3, axis=-1), 1e-4)
            return on_dev(np.repeat(e[..., None], 3, axis=-1))
        base = "normal-geom" if "normal-geom" in film.layers else "combined"
        src = (film.layers[base] / w).cpu().numpy()[..., :3]
        if layer == "toon":
            return on_dev(PP.toon(src))
        e = PP.sobel_edges(src, 0.3)
        return on_dev(np.repeat(e[..., None], 3, axis=-1))
    out = film.layers[layer] / w
    if (layer == "combined" and film.splat is not None
            and film.splat_paths is not None):
        # light-tracing splats: the mean over the traced light subpaths
        out = out.clone()
        out[..., :3] += film.splat / torch.clamp_min(film.splat_paths, 1.0)
    return out


def add_splats(film: Film, px: Tensor, py: Tensor, rgb: Tensor,
               n_paths) -> Film:
    """Scatter light-tracing camera splats into the splat accumulator. They
    carry no filter weight and are normalized by the total number of light
    subpaths at resolve. In place."""
    if film.splat is None:
        return film
    h, w = film.height, film.width
    ix = torch.clamp(torch.floor(px).to(torch.int32), 0, w - 1).long()
    iy = torch.clamp(torch.floor(py).to(torch.int32), 0, h - 1).long()
    film.splat.index_put_((iy, ix), rgb, accumulate=True)
    film.splat_paths = film.splat_paths + torch.as_tensor(
        n_paths, dtype=torch.float32, device=film.device)
    return film


def merge(films) -> Film:
    """Sum the weights and accumulators across films: the in-memory
    counterpart of the reference's film-folder merge
    (imageFilmLoadAllInFolder)."""
    out = films[0]
    for f in films[1:]:
        out = replace(
            out, weights=out.weights + f.weights,
            layers={k: out.layers[k] + f.layers[k] for k in out.layers},
            splat=(out.splat + f.splat if out.splat is not None
                   and f.splat is not None else out.splat),
            splat_paths=(out.splat_paths + f.splat_paths
                         if out.splat_paths is not None
                         and f.splat_paths is not None else out.splat_paths))
    return out


def psum_merge(film: Film, mesh) -> Film:
    """The film merge across a `parallel.Mesh`: an all_reduce (sum) over the
    mesh's group of the weights, every layer and the splat accumulators
    (the JAX package's psum over the mesh axis, SURVEY.md section 2.15).
    Every rank returns the merged film."""
    opt = lambda x: mesh.all_reduce_sum(x) if x is not None else None
    return replace(
        film, weights=mesh.all_reduce_sum(film.weights),
        layers={k: mesh.all_reduce_sum(v) for k, v in film.layers.items()},
        splat=opt(film.splat), splat_paths=opt(film.splat_paths))


# --- film checkpoint / resume (the reference's .film files,
# imagefilm.cc:827-1020), in the JAX package's .film.npz layout

def save_film(film: Film, path: str, sampling_offset: int = 0) -> None:
    arrs = {"__weights__": film.weights.cpu().numpy()}
    if film.splat is not None:
        arrs["__splat__"] = film.splat.cpu().numpy()
        arrs["__splat_paths__"] = film.splat_paths.cpu().numpy()
    for k, v in film.layers.items():
        arrs[f"layer.{k}"] = v.cpu().numpy()
    np.savez_compressed(
        path, __header__=FILM_HEADER, __node__=film.computer_node,
        __sampling_offset__=sampling_offset,
        __flt__=f"{film.flt_kind}:{film.flt_width}", **arrs)


def load_film(path: str, device="cuda") -> Tuple[Film, int]:
    """(the film, its sampling offset) from a checkpoint, on `device`."""
    with np.load(path, allow_pickle=False) as data:
        if str(data["__header__"]) != FILM_HEADER:
            raise ValueError(f"bad film header in {path}")
        flt_kind, flt_width = str(data["__flt__"]).split(":")
        on_dev = lambda k: torch.from_numpy(data[k]).to(device)
        opt = lambda k: on_dev(k) if k in data.files else None
        film = Film(weights=on_dev("__weights__"),
                    layers={k[len("layer."):]: on_dev(k) for k in data.files
                            if k.startswith("layer.")},
                    splat=opt("__splat__"), splat_paths=opt("__splat_paths__"),
                    flt_kind=flt_kind, flt_width=float(flt_width),
                    computer_node=int(data["__node__"]))
        return film, int(data["__sampling_offset__"])


def load_all_in_folder(folder: str, device="cuda") -> Tuple[Film, int]:
    """Merge every film checkpoint in `folder` (render-farm node outputs),
    as imageFilmLoadAllInFolder does; the offset is the largest."""
    import glob
    import os
    films = []
    offset = 0
    for p in sorted(glob.glob(os.path.join(folder, "*.film.npz"))):
        f, off = load_film(p, device)
        films.append(f)
        offset = max(offset, off)
    if not films:
        raise FileNotFoundError(f"no *.film.npz in {folder}")
    return merge(films), offset
