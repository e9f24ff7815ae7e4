"""The port's spans: its host path named in a ``torch.profiler`` trace, and
the device time of each program launch.

Spans are on exactly while a ``torch.profiler`` session records: a frame
(``renderer.render_image``, ``renderer.Renderer.draw_frame``) reads the
profiler's enabled flag once as it starts (:data:`frame`) and every site of
that frame follows it; outside a frame every site is off.  Off, a site is a
read of a module flag and the shared null context: it records nothing,
makes no CUDA event and keeps nothing.

On, a site is a ``torch.profiler.record_function`` named
``<span>#<frame>``, the frame's number in the name as the profiler numbers
its ``ProfilerStep#<n>``: every span of one frame shares it.  The profiler
stamps these on the clock of its device activity, so an idle stretch of the
card can be put down to the innermost span that covers it.  The spans and
their nesting, all inside the frame's own span ``frame``::

    batch:        plan; camera; [band >] wave > [program.bind], program.launch;
                  [image]; fetch; settle
    progressive:  plan; camera; [program.bind]; program.launch; fetch;
                  present_wait

``plan`` is the frame's set-up on the host (the camera's matrices, the lane
order, bands or not), ``camera`` the frame's inputs on the device (the
camera, and a batch frame's ray counter or a progressive frame's sample
number).  ``band`` and ``image`` are on the banded path only, a band holding
its waves; ``program.bind`` only where the graphs' mirror of the tables is
filled (``render/graphs.py`` ``GraphCache.bind``).  ``settle`` is a batch
frame's one blocking read with its image handed out, ``present_wait`` a
pipelined call's wait for the frame before it and its hand-out, from the
second call on.

Each ``program.launch`` on the card also records a timing CUDA event pair
on the launch stream, directly before and after the graph launch
(:func:`timed`).  Where the stream is idle when the host starts the launch,
the start event completes at once, so a launch's length then includes the
host's graph launch call: the card waited for it.  The pairs are kept as
they are and resolved to milliseconds only when a reader asks
(:func:`launches`, which waits for the stream to pass them): nothing on a
frame's path reads or waits for them.
"""

from __future__ import annotations

import contextlib

import torch
import torch.autograd.profiler as _profiler

_NULL = contextlib.nullcontext()
_on = False  # the current frame's spans are recorded
_number = 0  # the current (or last) frame's number
_pending: list = []  # (frame, start event, end event) of each timed launch


class _Frame:
    """One frame's spans, under the frame's own: on while the profiler
    records as it starts."""

    def __enter__(self):
        global _on, _number
        _on = _profiler._is_profiler_enabled
        if _on:
            _number += 1
            self.root = span("frame")
            self.root.__enter__()

    def __exit__(self, *exc):
        global _on
        if _on:
            self.root.__exit__(*exc)
        _on = False


#: ``with frame:`` around a frame's host path (frames do not nest)
frame = _Frame()


def span(name: str):
    """A host span ``name`` of the current frame, or the null context."""
    if not _on:
        return _NULL
    return torch.profiler.record_function(f"{name}#{_number}")


class _Timed:
    """A timing CUDA event pair around a program launch on ``stream``."""

    def __init__(self, stream):
        self.stream = stream

    def __enter__(self):
        self.start = torch.cuda.Event(enable_timing=True)
        self.start.record(self.stream)

    def __exit__(self, *exc):
        end = torch.cuda.Event(enable_timing=True)
        end.record(self.stream)
        _pending.append((_number, self.start, end))


def timed(stream):
    """Around a program's graph launch on ``stream``: its event pair where
    the frame's spans are on, else the null context."""
    return _Timed(stream) if _on else _NULL


def launches() -> list:
    """[(frame, start ms, end ms)] of every timed program launch since the
    last :func:`reset`, in launch order, from the first one's start (it
    waits for the stream to pass them)."""
    if not _pending:
        return []
    origin = _pending[0][1]
    for _, _, end in _pending:
        end.synchronize()
    return [(n, origin.elapsed_time(start), origin.elapsed_time(end))
            for n, start, end in _pending]


def reset() -> None:
    """Forget the timed launches (``graphs.reset_stats``)."""
    _pending.clear()
