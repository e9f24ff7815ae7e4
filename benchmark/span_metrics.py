"""What the port's own spans and counters say of a traced window: the
program launches timed by CUDA events (``utils/spans.py`` ``launches()``)
and the live lanes its bounce tests counted (``integrator.BOUNCE_LIVE``).
The harness's record has no field for them, so each reader imports the
port's store; a port without it reads as nothing (None)."""

from __future__ import annotations


def _launches():
    try:
        from vulkan_raytracer_tpu_torch.utils import spans
    except ImportError:
        return None
    return spans.launches() or None


def program_ms(run, mode: str):
    """Device ms a frame inside the program launches: the sum of each
    launch's event-timed length over the frames rendered."""
    if run["mode"] != mode or not run["rendered"]:
        return None
    launches = _launches()
    if launches is None:
        return None
    return sum(end - start for _, start, end in launches) / run["rendered"]


def launch_gap_ms(run, mode: str):
    """Device ms a frame outside the program launches: the mean time from
    one launch's end to the next one's start, times the launches, over the
    frames rendered."""
    if run["mode"] != mode or not run["rendered"]:
        return None
    launches = _launches()
    if launches is None or len(launches) < 2:
        return None
    gaps = [b[1] - a[2] for a, b in zip(launches, launches[1:])]
    return sum(gaps) / len(gaps) * len(launches) / run["rendered"]


def bounce_live_pct(run, mode: str):
    """The share of the bounces' lanes that entered them alive: the live
    lanes the bounce tests let through over width x bounces."""
    if run["mode"] != mode or not run["bounce_widths"]:
        return None
    try:
        from vulkan_raytracer_tpu_torch.render import integrator
    except ImportError:
        return None
    live = getattr(integrator, "BOUNCE_LIVE", None)
    if not live:
        return None
    lanes = sum(w * n for w, n in run["bounce_widths"].items())
    return 100.0 * sum(live.values()) / lanes
