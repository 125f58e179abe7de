"""Gathers from small f32 tables whose backward is a reduction onto the
table's rows.

Counterpart of `libyafaray_tpu/ops/fast_grad.py`. The gradient of
`arr[idx]` with respect to the table is the reduction

    grad[t, c] = sum_n (idx_n == t) * g[n, c]

which plain indexing computes with an accumulating scatter, in an order of
its own. Here it is a pure f32 sum of the lanes that picked each row, in a
fixed order, by `take_grad`: on a CUDA device the hand-written kernel
`csrc/take_grad.cu` (each lane read once, no one-hot, no float atomics; its
launch shape from `take_grad_layout`), on the CPU its plain version
`onehot_grad`, the JAX package's one-hot product: a one-hot matrix times
the incoming gradient, in f32, over chunks of 16,384 lanes batched into one
`bmm` a group of chunks at a time, so that the one-hot never holds more
than `_ONEHOT_ELEMS` elements. A CUDA tensor never falls back to it.

`gather_mp` (`materials/bsdf.py`) gathers every float material column
through `take`, and `textures/image._fetch` every texel. Each caller names
its table (`label`: the column's name, or "texel_pool"), and under the
program's `tracing()` the backward is the span `grad.take` with the table
as its `table` attribute, and counts `grad.take.lanes.<table>` (the lanes
whose gradients it reduces) and `grad.take.rows.<table>` (the table's
rows); where `take_grad` launches the kernel it counts
`kernel.take_grad.lanes`, and `csrc_build`'s counter holds
`kernel.take_grad.launches` (one a reduction) and
`kernel.take_grad.kernels` (the kernels the entry reports it launched: one,
or two with the combine). With tracing off it records nothing.
"""
from __future__ import annotations

from ctypes import byref, c_int as CI, c_longlong as CL, c_void_p as VP

import torch

from .. import csrc_build
from ..utils import profiling as PF

Tensor = torch.Tensor

# tables up to this many rows get the backward `take_grad` (the JAX
# package's cut for its one-hot, which costs N * rows); larger ones keep
# plain indexing. On the card the kernel's own limit is take_grad_layout's
# shared-memory test, which every table up to this many rows passes
MATMUL_GRAD_ROWS = 4096
_GRAD_CHUNK = 16384
_ONEHOT_ELEMS = 1 << 26       # 256 MiB of f32 one-hot per bmm at most

# the kernel's launch shape (`take_grad_layout`), for an H100
SMEM_BLOCK = 232_448     # shared memory a block may take (227 KB)
SMEM_SM = 233_472        # shared memory of an SM for its blocks (228 KB)
SMEM_RESERVED = 1024     # the runtime's own shared memory a block
KERNEL_COLS = 4          # most columns one block reduces (csrc: COLS)
MAX_WARPS = 16           # warps a block, each with its own table copy
SM_WARPS = 32            # warps an SM holds at the kernel's 52 registers
LANES_PER_WARP = 128     # least lanes a warp reduces, to pay for its copy
H100_SMS = 132
# take_grad_launch's arguments, the stream last
C_ARGS = (VP, VP) + (CL,) * 3 + (CI,) * 6 + (VP,) * 4

_sms: dict = {}


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


def take_grad_layout(rows: int, cols: int, lanes: int, sms: int = H100_SMS):
    """The kernel's launch shape for `lanes` lanes onto f32[rows, cols]:
    (warps a block, blocks, columns a block, threads an element in the
    second kernel). A block's warps each hold a copy of `rows` x (columns a
    block) floats, together at most SMEM_BLOCK bytes, and at most
    MAX_WARPS; blocks come from the lane count (LANES_PER_WARP a warp at
    least), at most one wave of `sms` streaming multiprocessors, as many
    blocks an SM as its warps (SM_WARPS) and shared memory hold: a warp's
    rounds are bound by their latency, so the most warps win (a sweep on
    an H100: 39.6 us a 262,144-lane texel-pool take at 8 warps x 35
    blocks, 19.5 at 10 x 132). Raises ValueError when one copy alone
    exceeds SMEM_BLOCK."""
    cw = max(1, min(cols, KERNEL_COLS))
    table = 4 * rows * cw
    if table > SMEM_BLOCK:
        raise ValueError(f"take_grad: a table of {rows} rows and {cw} "
                         f"columns ({table} bytes) exceeds a block's "
                         f"{SMEM_BLOCK} bytes of shared memory")
    warps = max(1, min(MAX_WARPS, SMEM_BLOCK // max(table, 1)))
    per_sm = max(1, min(SM_WARPS // warps,
                        SMEM_SM // (warps * table + SMEM_RESERVED)))
    by_lanes = -(-lanes // (warps * LANES_PER_WARP))
    blocks = max(1, min(by_lanes, sms * per_sm))
    split = 1
    while split < 32 and 8 * split <= blocks:
        split *= 2
    return warps, blocks, cw, split


def _sm_count(dev: torch.device) -> int:
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    if index not in _sms:
        _sms[index] = torch.cuda.get_device_properties(
            index).multi_processor_count
    return _sms[index]


def take_grad(idx: Tensor, g: Tensor, rows: int) -> Tensor:
    """sum_n (idx_n == t) * g[n] for t < rows, in f32: f32[rows, *g's
    trailing shape]. idx i64[N] (1-D; lanes outside [0, rows) add
    nothing), g [N, ...], on one device. On the CPU the plain version
    `onehot_grad`; on a CUDA device the kernel `csrc/take_grad.cu` (one or
    two launches, no padding and no one-hot), or it raises."""
    if not csrc_build.on_card("take_grad", g.device):
        return onehot_grad(idx, g, rows)
    dev = g.device
    n = idx.shape[0]
    g2 = g.reshape(n, -1).to(torch.float32)
    idx = idx.to(torch.int64).contiguous()
    cols = g2.shape[1]
    csrc_build.check_arg("take_grad", "idx", idx, torch.int64, (n,), dev)
    out = torch.empty((rows, cols), dtype=torch.float32, device=dev)
    warps, blocks, cw, split = take_grad_layout(rows, cols, n, _sm_count(dev))
    part = (torch.empty((blocks, rows, cols), dtype=torch.float32, device=dev)
            if blocks > 1 else None)
    kernels = CI(0)
    csrc_build.launch(
        "take_grad", csrc_build.entry("take_grad", "take_grad_launch",
                                      C_ARGS), dev,
        idx.data_ptr(), g2.data_ptr(), n, g2.stride(0), g2.stride(1), rows,
        cols, warps, blocks, cw, split,
        part.data_ptr() if part is not None else None, out.data_ptr(),
        byref(kernels))
    csrc_build.launch_counts["kernel.take_grad.kernels"] += kernels.value
    PF.count("kernel.take_grad.lanes", n)
    return out.reshape((rows,) + g.shape[1:])


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
            return take_grad(idx, g, ctx.rows), None, None


def take(arr: Tensor, idx: Tensor, label: str = "table") -> Tensor:
    """arr[idx] with the backward `take_grad` when eligible (an f32 table
    of at most MATMUL_GRAD_ROWS rows, a 1-D index); plain indexing otherwise,
    and whenever no gradient is recorded (the same values, without the
    autograd Function's host cost, which PERF.md measures on host-bound
    forward passes). `label` names the table in the backward's span and
    counts."""
    if (arr.requires_grad and torch.is_grad_enabled()
            and arr.dtype == torch.float32 and idx.dim() == 1
            and arr.shape[0] <= MATMUL_GRAD_ROWS):
        return _Take.apply(arr, idx, label)
    return arr[idx]
