"""Inverse rendering: a differentiable training step on one device.

Counterpart of `libyafaray_tpu/parallel/__init__.py` (`_pixel_shard_radiance`
and `make_train_step`) without the device mesh. The JAX step shards the
pixels over a mesh and takes the mean of the loss and of the gradients
across devices; here every pixel runs on one device, so the loss and the
gradients are the whole image's. The mean across devices (and the sharded
renders) come with the port's `torch.distributed` slice.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from ..cameras import lens_samples, shoot_rays
from ..integrators.mc import IntegratorConfig, integrate
from ..scene_types import SceneData

Tensor = torch.Tensor


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


def make_train_step(cfg: IntegratorConfig, height: int, width: int,
                    lr: float = 0.05, device="cuda"):
    """An SGD step on material parameters, on `device` (the CUDA card unless
    the caller names another).

    Returns step(scene, params, target, sample_idx) -> (params, loss), where
    `params` maps MaterialTable field names to tensors (for example
    {"diffuse_color": f32[M, 3]}) that override the scene's columns, the
    loss is the image MSE of one sample pass at the pixel centres against
    `target` (f32[height, width, 3]), and each parameter moves by
    -lr * its gradient. Gradients stop at the intersection queries, as in
    the JAX package."""
    pixel_id = torch.arange(height * width, dtype=torch.int64, device=device)
    px = (pixel_id % width).to(torch.float32) + 0.5
    py = (pixel_id // width).to(torch.float32) + 0.5

    def step(scene: SceneData, params: Dict[str, Tensor], target: Tensor,
             sample_idx: int) -> Tuple[Dict[str, Tensor], Tensor]:
        scene = scene.to(device)
        # the leaves go in after the move, so that they stay the leaves
        leaves = {k: v.detach().to(device).requires_grad_(True)
                  for k, v in params.items()}
        sc = dataclasses.replace(scene, materials=dataclasses.replace(
            scene.materials, **leaves))
        rgb, _, _ = _pixel_shard_radiance(sc, cfg, px, py, pixel_id,
                                          sample_idx)
        loss = torch.mean((rgb - target.to(device).reshape(-1, 3)) ** 2)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        new = {k: (p - lr * g).detach()
               for (k, p), g in zip(leaves.items(), grads)}
        return new, loss.detach()

    return step
