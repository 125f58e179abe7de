"""Multi-device rendering and inverse rendering on `torch.distributed`.

Counterpart of `libyafaray_tpu/parallel/__init__.py`, which shards the pixel
batch over a JAX device mesh with `shard_map`. Here the mesh is a group of
processes, one device each, and the pixel batch is split the way JAX's
`P("batch")` splits it: rank r of the mesh takes the r-th contiguous block
of pixel ids. Every pixel is a pure function of its absolute id and sample
index, so any layout gives the same values.

  - `render_wavefront_sharded`: one sample per pixel; each rank traces its
    block and an `all_gather` hands every rank the whole image, as JAX's
    out_specs do.
  - `render_sharded`: passes of it accumulated into each rank's film at the
    pixel centres with weight 1 (the JAX function's film, not `render`'s,
    which splats at the jittered positions).
  - `make_train_step(..., mesh=)`: each rank's loss is the mean over its
    block; the loss and the gradients are averaged across the mesh by one
    `all_reduce` (JAX's `pmean`), so every rank takes the same step.
    Without a mesh it is the one-device step.

The reference's two layers of parallelism (tile threads and the render
farm's film merge, SURVEY.md section 2.15) map to the pixel split above and
to `film.psum_merge` / `parallel.distributed`. Collectives run on the
mesh's group with the backend its caller chose: NCCL on the card; gloo for
the CPU, and for ranks that share one card (NCCL refuses two ranks on one
GPU). Gloo takes CUDA tensors for both collectives used here (all_gather
and all_reduce), so no tensor is staged through host memory.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

from .. import film as F
from .. import sampler
from ..cameras import lens_samples, shoot_rays
from ..integrators.mc import IntegratorConfig, integrate
from ..render import pixel_jitter
from ..scene_types import SceneData
from ..utils import profiling as PF
from .distributed import local_rank

Tensor = torch.Tensor


@dataclass(frozen=True)
class Mesh:
    """A 1-D data-parallel mesh: the ranks `ranks` of the default process
    group (`group` is their sub-group, None for the whole default group),
    this process's global rank, and the device its tensors live on."""
    ranks: Tuple[int, ...]
    group: Optional[object]
    rank: int
    device: torch.device

    @property
    def size(self) -> int:
        return len(self.ranks)

    @property
    def index(self) -> int:
        """This process's position on the mesh's axis."""
        if self.rank not in self.ranks:
            raise ValueError(f"rank {self.rank} is not on the mesh "
                             f"(ranks {self.ranks})")
        return self.ranks.index(self.rank)

    def block(self, n_pix: int) -> Tuple[int, int]:
        """[lo, hi): this rank's contiguous block of `n_pix` pixel ids. The
        count must divide by the mesh size, as JAX's sharding requires."""
        if n_pix % self.size != 0:
            raise ValueError(f"{n_pix} pixels not divisible by {self.size} "
                             "devices")
        per = n_pix // self.size
        return self.index * per, (self.index + 1) * per

    def all_gather(self, x: Tensor) -> Tensor:
        """The blocks `x` of every rank (equal shapes), concatenated along
        dim 0 in mesh order."""
        parts = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(parts, x.contiguous(), group=self.group)
        return torch.cat(parts)

    def all_reduce_sum(self, x: Tensor) -> Tensor:
        """The sum of `x` over the mesh, on every rank (a new tensor)."""
        buf = x.detach().clone()
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=self.group)
        return buf


def make_mesh(n_devices: Optional[int] = None, *, device="cuda") -> Mesh:
    """A 1-D `batch` mesh over the first `n_devices` ranks (all of them by
    default) of the initialized default process group, as JAX's make_mesh
    takes the first n devices. Every rank of the default group calls it
    (a sub-group is made collectively). The device is `cuda:<local rank>`
    unless the caller names one (such as "cpu", or "cuda:0" for ranks that
    share a card). Raises RuntimeError when no group is initialized."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no process group is initialized "
                           "(call parallel.distributed.init_distributed "
                           "first)")
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if not 1 <= n <= world:
        raise ValueError(f"make_mesh: {n} devices asked, the group has "
                         f"{world}")
    ranks = tuple(range(n))
    group = None if n == world else dist.new_group(list(ranks))
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", local_rank(dist.get_rank()))
    return Mesh(ranks=ranks, group=group, rank=dist.get_rank(), device=dev)


def _pixel_shard_radiance(scene: SceneData, cfg: IntegratorConfig,
                          px: Tensor, py: Tensor, pixel_id: Tensor,
                          sample_idx: int):
    """Camera rays -> integrator for the pixels `pixel_id` at film positions
    (px, py): a pure function of the absolute pixel ids (the lens samples
    too, as in `render`)."""
    lens_u, lens_v = lens_samples(scene.camera, pixel_id, sample_idx)
    o, d, valid = shoot_rays(scene.camera, px, py, lens_u, lens_v)
    rgb, alpha, _ = integrate(scene, cfg, o, d, valid, pixel_id, sample_idx)
    return rgb, alpha, valid


def _sharded_rgba(scene: SceneData, cfg: IntegratorConfig, height: int,
                  width: int, sample_idx: int, mesh: Mesh) -> Tensor:
    """f32[H*W, 4]: rgb and alpha of one sample of every pixel, this rank's
    block traced here and the blocks gathered by one collective."""
    lo, hi = mesh.block(height * width)
    scene = scene.to(mesh.device)
    s_idx = int(sample_idx) & sampler.M32
    pixel_id = torch.arange(lo, hi, dtype=torch.int64, device=mesh.device)
    px, py = pixel_jitter(pixel_id, s_idx, width)
    rgb, alpha, _ = _pixel_shard_radiance(scene, cfg, px, py, pixel_id, s_idx)
    return mesh.all_gather(torch.cat([rgb, alpha[:, None]], dim=1))


def render_wavefront_sharded(scene: SceneData, cfg: IntegratorConfig,
                             height: int, width: int, sample_idx: int,
                             mesh: Mesh) -> Tuple[Tensor, Tensor]:
    """One sample per pixel with the pixel batch split over the mesh.

    Returns (rgb f32[H*W, 3], alpha f32[H*W]) on every rank, in pixel
    order; callers accumulate them into a film. The pixel count must divide
    by the mesh size (pad the film if needed)."""
    rgba = _sharded_rgba(scene, cfg, height, width, sample_idx, mesh)
    return rgba[:, :3], rgba[:, 3]


def render_sharded(scene: SceneData, cfg: IntegratorConfig, width: int,
                   height: int, spp: int, mesh: Mesh,
                   film: Optional[F.Film] = None) -> F.Film:
    """`spp` passes of `render_wavefront_sharded` (samples 0 .. spp-1), each
    added to this rank's film at the pixel centres with weight 1: the
    sharded counterpart of the JAX package's render_sharded."""
    if film is None:
        film = F.make_film(width, height, ("combined",), device=mesh.device)
    pid = torch.arange(height * width, dtype=torch.int64, device=mesh.device)
    cx = (pid % width).to(torch.float32) + 0.5
    cy = (pid // width).to(torch.float32) + 0.5
    ones = torch.ones((height * width,), dtype=torch.float32,
                      device=mesh.device)
    for s in range(spp):
        rgba = _sharded_rgba(scene, cfg, height, width, s, mesh)
        film = F.add_samples(film, cx, cy, {"combined": rgba}, ones)
    return film


_TEXTURES = "textures."


def _with_leaves(scene: SceneData, leaves: Dict[str, Tensor]) -> SceneData:
    """`scene` with its MaterialTable columns and "textures.<field>"
    TexturePool columns replaced by `leaves`."""
    mats, texs = {}, {}
    for k, v in leaves.items():
        if k.startswith(_TEXTURES):
            field, table, group = k[len(_TEXTURES):], scene.textures, texs
        else:
            field, table, group = k, scene.materials, mats
        if table is None or field not in {
                f.name for f in dataclasses.fields(table)}:
            raise KeyError(f"make_train_step: no parameter {k!r}")
        group[field] = v
    return dataclasses.replace(
        scene, materials=dataclasses.replace(scene.materials, **mats),
        textures=(dataclasses.replace(scene.textures, **texs) if texs
                  else scene.textures))


def make_train_step(cfg: IntegratorConfig, height: int, width: int,
                    mesh: Optional[Mesh] = None, lr: float = 0.05, *,
                    device="cuda"):
    """An SGD step on material and texture parameters.

    Returns step(scene, params, target, sample_idx) -> (params, loss), where
    `params` maps names to tensors that override the scene's columns: a
    MaterialTable field name (for example {"diffuse_color": f32[M, 3]} or
    {"ior": f32[M]}), or "textures.<field>" for a TexturePool field (for
    example {"textures.texel_pool": f32[T, 4]}); any other name raises
    KeyError. The loss is the image MSE of one sample pass at the pixel
    centres against `target` (f32[height, width, 3]), and each parameter
    moves by -lr * its gradient, and `step.grads` keeps the last step's
    gradients by the same names. Gradients stop at the intersection
    queries, as in the JAX package.

    Without a mesh the step runs every pixel on `device` (the CUDA card
    unless the caller names another). With a mesh it runs on the mesh's
    device: each rank renders its block of pixels, its loss is the block's
    mean, and the loss and the gradients are averaged across the mesh by
    one all_reduce, so the new parameters and `step.grads` are the same
    on every rank."""
    if mesh is not None:
        device = mesh.device
        lo, hi = mesh.block(height * width)
    else:
        lo, hi = 0, height * width
    pixel_id = torch.arange(lo, hi, dtype=torch.int64, device=device)
    px = (pixel_id % width).to(torch.float32) + 0.5
    py = (pixel_id // width).to(torch.float32) + 0.5

    @PF.span("train.step")
    def step(scene: SceneData, params: Dict[str, Tensor], target: Tensor,
             sample_idx: int) -> Tuple[Dict[str, Tensor], Tensor]:
        scene = scene.to(device)
        # the leaves go in after the move, so that they stay the leaves
        leaves = {k: v.detach().to(device).requires_grad_(True)
                  for k, v in params.items()}
        sc = _with_leaves(scene, leaves)
        with PF.span("train.forward"):
            rgb, _, _ = _pixel_shard_radiance(sc, cfg, px, py, pixel_id,
                                              sample_idx)
        with PF.span("train.loss"):
            tgt = target.to(device).reshape(-1, 3)[lo:hi]
            loss = torch.mean((rgb - tgt) ** 2)
        with PF.span("train.backward"):
            grads = torch.autograd.grad(loss, list(leaves.values()))
        with PF.span("train.update"):
            loss = loss.detach()
            if mesh is not None:
                # pmean of the loss and of every gradient: one all_reduce
                flat = mesh.all_reduce_sum(torch.cat(
                    [loss.reshape(1)] + [g.reshape(-1) for g in grads]))
                flat = flat / mesh.size
                loss = flat[0]
                parts = torch.split(flat[1:], [g.numel() for g in grads])
                grads = [p.reshape(g.shape) for p, g in zip(parts, grads)]
            new = {k: (p - lr * g).detach()
                   for (k, p), g in zip(leaves.items(), grads)}
            step.grads = dict(zip(leaves, grads))
        return new, loss

    step.grads = {}
    return step
