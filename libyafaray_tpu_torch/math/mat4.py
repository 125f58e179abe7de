"""4x4 affine transforms, batched: counterpart of `libyafaray_tpu/math/mat4.py`
(the reference's `Matrix4`, src/geometry/matrix4.cc), for instances, cameras
and texture mappings.

The functions that apply a matrix work on the device and dtype of their
arguments. The constructors make a matrix on an explicit device and dtype:
the CUDA card unless the caller names another device.
"""
from __future__ import annotations

import numpy as np
import torch

Tensor = torch.Tensor

IDENTITY = np.eye(4, dtype=np.float32)


def transform_point(m: Tensor, p: Tensor) -> Tensor:
    """The affine matrix m [..., 4, 4] applied to points p [..., 3]."""
    return torch.einsum("...ij,...j->...i", m[..., :3, :3], p) + m[..., :3, 3]


def transform_vector(m: Tensor, v: Tensor) -> Tensor:
    return torch.einsum("...ij,...j->...i", m[..., :3, :3], v)


def transform_normal(m_inv: Tensor, n: Tensor) -> Tensor:
    """Normals transform by the inverse transpose of the linear part."""
    return torch.einsum("...ji,...j->...i", m_inv[..., :3, :3], n)


def inverse(m: Tensor) -> Tensor:
    return torch.linalg.inv(m)


def translate(t, *, device="cuda", dtype=torch.float32) -> Tensor:
    m = torch.eye(4, dtype=dtype, device=device)
    m[:3, 3] = torch.as_tensor(t, dtype=dtype, device=device)
    return m


def scale(s, *, device="cuda", dtype=torch.float32) -> Tensor:
    s = torch.broadcast_to(torch.as_tensor(s, dtype=dtype, device=device),
                           (3,))
    return torch.diag(torch.cat([s, torch.ones(1, dtype=dtype,
                                                device=device)]))


def _rotation(a: float, rows, device, dtype) -> Tensor:
    """The matrix whose entries `rows` name by "c" (cos a), "s" (sin a),
    "-s", 0 and 1, with cos and sin rounded to `dtype` as the JAX package
    rounds them (to float32)."""
    ang = torch.as_tensor(a, dtype=dtype)
    val = {"c": torch.cos(ang), "s": torch.sin(ang), "-s": -torch.sin(ang),
           0: torch.zeros((), dtype=dtype), 1: torch.ones((), dtype=dtype)}
    return torch.stack([torch.stack([val[k] for k in row])
                        for row in rows]).to(device)


def rotate_x(a: float, *, device="cuda", dtype=torch.float32) -> Tensor:
    return _rotation(a, ((1, 0, 0, 0), (0, "c", "-s", 0), (0, "s", "c", 0),
                         (0, 0, 0, 1)), device, dtype)


def rotate_y(a: float, *, device="cuda", dtype=torch.float32) -> Tensor:
    return _rotation(a, (("c", 0, "s", 0), (0, 1, 0, 0), ("-s", 0, "c", 0),
                         (0, 0, 0, 1)), device, dtype)


def rotate_z(a: float, *, device="cuda", dtype=torch.float32) -> Tensor:
    return _rotation(a, (("c", "-s", 0, 0), ("s", "c", 0, 0), (0, 0, 1, 0),
                         (0, 0, 0, 1)), device, dtype)
