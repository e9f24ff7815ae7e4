"""Arithmetic the per-layer readers share.

A traced run's device work is that of every frame it rendered
(``run["rendered"]``): a batch run's frames, a progressive run's
``draw_frame`` calls, one more than the frames they handed out, since a
pipelined call hands out the frame before its own."""

from __future__ import annotations


def kernel_ms(run, files) -> float | None:
    """Device ms a traced frame of the kernels that ``files`` define; None
    where the trace holds none of them."""
    seconds = run.get("kernel_seconds") or {}
    if not run.get("rendered") or not any(f in seconds for f in files):
        return None
    return sum(seconds.get(f, 0.0) for f in files) / run["rendered"] * 1e3
