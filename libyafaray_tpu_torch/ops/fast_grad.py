"""Gathers from small f32 tables whose backward is a one-hot product.

Counterpart of `libyafaray_tpu/ops/fast_grad.py`. The gradient of
`arr[idx]` with respect to the table is the reduction

    grad[t, c] = sum_n (idx_n == t) * g[n, c]

which plain indexing computes with an accumulating scatter, in an order of
its own. Here it is a product of a one-hot matrix and the incoming
gradient, in f32, over chunks of 16,384 lanes, as the JAX package computes
it: pure sums of the lanes that picked each row. The chunks are batched into
one `bmm`, a group of chunks at a time, so that the one-hot never holds more
than `_ONEHOT_ELEMS` elements.

`gather_mp` (`materials/bsdf.py`) gathers every float material column
through `take`, and `textures/image._fetch` every texel. Each caller names
its table (`label`: the column's name, or "texel_pool"), and under the
program's `tracing()` the backward is the span `grad.take` with the table
as its `table` attribute, and counts `grad.take.lanes.<table>` (the lanes
whose gradients it reduces) and `grad.take.rows.<table>` (the table's
rows). With tracing off it records nothing.
"""
from __future__ import annotations

import torch

from ..utils import profiling as PF

Tensor = torch.Tensor

# tables up to this many rows get the one-hot backward; larger ones keep
# plain indexing (the one-hot costs N * rows)
MATMUL_GRAD_ROWS = 4096
_GRAD_CHUNK = 16384
_ONEHOT_ELEMS = 1 << 26       # 256 MiB of f32 one-hot per bmm at most


def onehot_grad(idx: Tensor, g: Tensor, rows: int) -> Tensor:
    """sum_n (idx_n == t) * g[n] for t < rows, as f32 one-hot products over
    chunks of _GRAD_CHUNK lanes, whose partial sums are then added."""
    n = idx.shape[0]
    g2 = g.reshape(n, -1).to(torch.float32)
    npad = -(-n // _GRAD_CHUNK) * _GRAD_CHUNK
    if npad != n:
        # padding lanes index row `rows`, which no one-hot column matches
        idx = torch.cat([idx, idx.new_full((npad - n,), rows)])
        g2 = torch.cat([g2, g2.new_zeros((npad - n, g2.shape[1]))])
    idx = idx.reshape(-1, _GRAD_CHUNK)
    gp = g2.reshape(idx.shape[0], _GRAD_CHUNK, g2.shape[1])
    ar = torch.arange(rows, device=idx.device, dtype=idx.dtype)
    group = max(1, _ONEHOT_ELEMS // (_GRAD_CHUNK * rows))
    acc = g2.new_zeros((rows, g2.shape[1]))
    for c0 in range(0, idx.shape[0], group):
        onehot = (idx[c0:c0 + group, None, :] == ar[None, :, None]
                  ).to(torch.float32)                      # [k, rows, chunk]
        part = torch.bmm(onehot, gp[c0:c0 + group])        # [k, rows, C]
        acc = acc + part.sum(0)
    return acc.reshape((rows,) + g.shape[1:])


class _Take(torch.autograd.Function):
    @staticmethod
    def forward(ctx, arr: Tensor, idx: Tensor, label: str) -> Tensor:
        ctx.save_for_backward(idx)
        ctx.rows = arr.shape[0]
        ctx.label = label
        return arr[idx]

    @staticmethod
    def backward(ctx, g: Tensor):
        idx, = ctx.saved_tensors
        with PF.span("grad.take", table=ctx.label):
            PF.count("grad.take.lanes." + ctx.label, idx.shape[0])
            PF.count("grad.take.rows." + ctx.label, ctx.rows)
            return onehot_grad(idx, g, ctx.rows), None, None


def take(arr: Tensor, idx: Tensor, label: str = "table") -> Tensor:
    """arr[idx] with the one-hot backward when eligible (an f32 table of at
    most MATMUL_GRAD_ROWS rows, a 1-D index); plain indexing otherwise,
    and whenever no gradient is recorded (the same values, without the
    autograd Function's host cost, which PERF.md measures on host-bound
    forward passes). `label` names the table in the backward's span and
    counts."""
    if (arr.requires_grad and torch.is_grad_enabled()
            and arr.dtype == torch.float32 and idx.dim() == 1
            and arr.shape[0] <= MATMUL_GRAD_ROWS):
        return _Take.apply(arr, idx, label)
    return arr[idx]
