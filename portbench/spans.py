"""Spans and counts recorded from the benchmark's own files, around the
program's layer boundaries.

The integrators call the intersection entry points through the module
(`from ..ops import intersect as I`, `I.closest_hit(...)`), the block
accelerator calls `tiles.tile_candidates` and `tiles.tiles_traverse` as
module globals, and `ops/intersect` calls `MT.mt_closest` and
`LB.lbvh_traverse` through their modules; so a wrapper put on the module
attribute sees every call. The wrappers are put on for one window and
taken off after it.

  - `installed`: CUDA events around every query (`closest_hit`, `any_hit`,
    `shadow_hit_surface`; `camera_hit` reaches `closest_hit` through the
    module too) and around the block prepass (`tile_candidates`); on the
    CPU, which only the tests drive, the calls are counted and not timed.
  - `counting`: the rays of every query that reaches a kernel's wrapper,
    and whether it is an any-hit query, for the roofline readers.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Tuple


def _patch(module, name: str, make):
    real = getattr(module, name)
    setattr(module, name, make(real))
    return module, name, real


class SpanRecorder:
    """Spans by kind ("query", "prepass"): CUDA events on the card; on the
    CPU, which only the tests drive, the calls alone."""

    def __init__(self, device):
        import torch
        self.cuda = torch.device(device).type == "cuda"
        self.spans: Dict[str, list] = {"query": [], "prepass": []}

    def wrap(self, kind: str, fn):
        import torch

        def timed(*a, **k):
            if not self.cuda:
                self.spans[kind].append(None)
                return fn(*a, **k)
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
            out = fn(*a, **k)
            ev[1].record()
            self.spans[kind].append(ev)
            return out
        return timed

    def _ms(self, kind: str):
        """Device ms of the spans of `kind`; None off the card, where no
        device time exists."""
        import torch
        if not self.cuda:
            return None
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in self.spans[kind])

    def summary(self, pass_seconds: List[float]) -> dict:
        return {"passes": len(pass_seconds),
                "pass_ms": [1e3 * s for s in pass_seconds],
                "query_ms": self._ms("query"),
                "queries": len(self.spans["query"]),
                "prepass_ms": self._ms("prepass"),
                "prepass_calls": len(self.spans["prepass"])}


@contextlib.contextmanager
def installed(device):
    """Spans around the queries and the prepass for the `with` body."""
    from libyafaray_tpu_torch.accel import tiles as TL
    from libyafaray_tpu_torch.ops import intersect as I
    rec = SpanRecorder(device)
    undo = [_patch(I, n, lambda f: rec.wrap("query", f))
            for n in ("closest_hit", "any_hit", "shadow_hit_surface")]
    undo.append(_patch(TL, "tile_candidates",
                       lambda f: rec.wrap("prepass", f)))
    try:
        yield rec
    finally:
        for module, name, real in reversed(undo):
            setattr(module, name, real)


class QueryCounts:
    """(rays, any hit) of every query, by kernel: "mt_closest",
    "tile_walk", "lbvh_traverse"."""

    def __init__(self):
        self.queries: Dict[str, List[Tuple[int, bool]]] = {
            "mt_closest": [], "tile_walk": [], "lbvh_traverse": []}

    def wrap(self, kernel: str, rays_arg: int, any_hit_kw: str, fn):
        def counted(*a, **k):
            self.queries[kernel].append(
                (int(a[rays_arg].shape[0]), bool(k.get(any_hit_kw, False))))
            return fn(*a, **k)
        return counted


@contextlib.contextmanager
def counting():
    """Count the rays of every kernel query in the `with` body. For
    `mt_closest` a shadow query counts as an any-hit query: its callers
    read only hit or miss, except the transparent-shadow walk, which these
    cells do not run."""
    from libyafaray_tpu_torch.accel import lbvh as LB
    from libyafaray_tpu_torch.accel import mt_intersect as MT
    from libyafaray_tpu_torch.accel import tiles as TL
    qc = QueryCounts()
    undo = [_patch(MT, "mt_closest",
                   lambda f: qc.wrap("mt_closest", 1, "shadow", f)),
            _patch(TL, "tiles_traverse",
                   lambda f: qc.wrap("tile_walk", 3, "any_hit", f)),
            _patch(LB, "lbvh_traverse",
                   lambda f: qc.wrap("lbvh_traverse", 2, "any_hit", f))]
    try:
        yield qc
    finally:
        for module, name, real in reversed(undo):
            setattr(module, name, real)
