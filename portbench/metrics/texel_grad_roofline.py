"""The texel gradient's backward's share of its roofline, in %: its least
time over its device time in the program window (`texel_grad_ms_per_step`,
the whole window). The least time is its bytes at 3.35 TB/s
(`roofline.HBM_BYTES_PER_S`): each lane's incoming gradient (an rgba row
of float32, 16 bytes) and its index (int64, 8 bytes) read once, and the
table's rows written once (16 bytes each), counted from the program's
`grad.take.lanes.texel_pool` and `grad.take.rows.texel_pool`. The count is
the same whatever implements the reduction (the one-hot product, a sorted
segment sum or a scatter kernel)."""
from portbench import program_trace, roofline

SPAN = "grad.take.texel_pool"
LANE_BYTES = 16 + 8
ROW_BYTES = 16


def texel_grad_bytes(lanes: int, rows: int) -> int:
    """The bytes the reduction of `lanes` lanes' gradients onto a table of
    `rows` rows must move at the least."""
    return lanes * LANE_BYTES + rows * ROW_BYTES


def read(ctx):
    if ctx.kind != "grad":
        return None
    prog = program_trace.read(ctx)
    if prog is None:
        return None
    lanes = prog.counts.get("grad.take.lanes.texel_pool", 0)
    rows = prog.counts.get("grad.take.rows.texel_pool", 0)
    ms = sum(v for p, v in prog.busy.items()
             if program_trace._under(p, SPAN))
    if not lanes or ms <= 0:
        return None
    least_s = texel_grad_bytes(lanes, rows) / roofline.HBM_BYTES_PER_S
    return 100.0 * least_s / (1e-3 * ms)
