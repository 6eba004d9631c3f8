"""Spans at the frame path's layer boundaries, kept in memory.

Off by default: `span(name)` then returns one shared no-op context and
records, allocates and synchronises nothing. `enable()` turns the recorder
on (and numbers spans and frames from 0 again), `disable()` turns it off,
`take()` returns the spans recorded so far and forgets them.

A span records its name, its id, the id of the span open around it (None
for the outermost), a frame id and its host start and end in ns. The
outermost span takes a new frame id and every span inside it shares it;
on the frame path the outermost span is `frame`, so the frame id numbers
the denoiser calls. Spans read the host clock only, `time.time_ns()`:
no CUDA event, no synchronise, no device work. That is the clock
torch.profiler reports its events on, so a device operation's launch
event falls inside the span that launched it. The recorder keeps one
stack of open spans: record from one thread.

The spans, by where they are opened:

  frame     inference/pipeline, each frame denoiser's __call__: the call
  encode    the joint encode (on the card the padded plane with it), the
            group encode (fused or stacked), the rgb encode
  net       the plane's network run, `frame_fn` or its `on_plane`: pad
            (not where the joint encode wrote the padded plane), tile
            gather, chunk fill, crop or stitch (inference/tiled)
  chunk     inference/tiled, each network call over a plane or a chunk
            of tiles
  backbone  models/factory.DenoiserModel.forward: the network under the
            head (the UNet, the tiramisu or the multi-scale wrapper)
  dense     models/tiramisu.Tiramisu.forward, inside `backbone`: each
            dense block with its join [x, block(x)]
  transition  models/tiramisu.Tiramisu.forward, inside `backbone`: each
            transition down (1x1 conv, average pool) and each transition
            up (resize-conv, the [up, skip] join or its 1x1 compression)
  pyramid   models/multiscale.MultiScale.__call__, inside `backbone`: the
            input pyramid's 2x2 average pools
  scale     the same, inside `backbone`: each run of the shared backbone,
            finest scale first
  compose   the same, inside `backbone`: each coarse-to-fine composition
            step, out_s = pred_s + up(out_(s+1) - down(pred_s))
  head      models/factory.DenoiserModel.forward: the rest of the model,
            the KPN head with its signal gather (or the residual add)
  k1        models/kpn.KernelPredictionHead.forward: each filter apply
  decode    inference/pipeline: decode, the passes carried through and
            the recompose

The benchmark's `h100_bench/spans.py` reads them all: it attributes
each device operation to the innermost span whose host interval holds
its launch event, and reads a layer's device time as the time of the
operations whose innermost span it is (`encode_ms`, `plane_ms` from
`net`, `backbone_ms`, `dense_ms`, `pyramid_ms`, `compose_ms`, `head_ms`,
`decode_ms`, K1's from `k1`), and the host's dispatch time of a
frame from `frame`.
"""

from __future__ import annotations

import contextlib
import time
from typing import List, NamedTuple, Optional


class Span(NamedTuple):
    name: str
    id: int
    parent: Optional[int]
    frame: int
    start_ns: int
    end_ns: int


_OFF = contextlib.nullcontext()

_on = False
_done: List[Span] = []
_open: List[tuple] = []  # (name, id, parent, frame, start_ns) of the spans entered
_next_id = 0
_next_frame = 0


class _Recording:
    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        global _next_id, _next_frame
        if _open:
            parent, frame = _open[-1][1], _open[-1][3]
        else:
            parent, frame = None, _next_frame
            _next_frame += 1
        _open.append((self.name, _next_id, parent, frame, time.time_ns()))
        _next_id += 1

    def __exit__(self, *exc):
        end = time.time_ns()
        name, sid, parent, frame, start = _open.pop()
        _done.append(Span(name, sid, parent, frame, start, end))
        return False


def span(name: str):
    """A context manager that records one span while the recorder is on."""
    return _Recording(name) if _on else _OFF


def enable() -> None:
    """Record from now on; span and frame ids start again at 0."""
    global _on, _next_id, _next_frame
    _done.clear()
    _open.clear()
    _next_id = _next_frame = 0
    _on = True


def disable() -> None:
    global _on
    _on = False


def take() -> List[Span]:
    """The spans closed since enable() or the last take(), by closing
    order; they are forgotten here."""
    out = list(_done)
    _done.clear()
    return out
