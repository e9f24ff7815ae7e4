"""What a profiled window's trace says: device intervals, kernels by the
source file that defines them, launches by kernel, the idle gaps and what
the host was doing in them."""

from __future__ import annotations

import re
from pathlib import Path

from benchmark import window

#: the port's launch counters (``integrator.launch_counts()`` keys) -> the
#: kernel whose launches each counts, by the name the trace gives it
KERNEL_OF = {"closest": "closest_kernel", "shadow": "shadow_kernel", "pdf": "pdf_kernel",
             "bvh_closest": "bvh_walk_kernel", "bvh_shadow": "bvh_walk_kernel",
             "treelet_closest": "treelet_walk_kernel", "treelet_shadow": "treelet_walk_kernel",
             "emissive_pdf": "emissive_walk_kernel", "hit": "shade_hit_kernel",
             "scatter": "shade_scatter_kernel", "resolve": "shade_resolve_kernel",
             "primary_rays": "primary_rays_kernel", "alpha_commit": "alpha_commit_kernel",
             "wave_sum": "wave_sum_kernel", "frame_post": "frame_post_kernel",
             "hit_finish": "hit_finish_kernel", "instance_step": "instance_step_kernel",
             "coherence_key": "coherence_key_kernel", "permute": "permute_kernel",
             "permute_copy": "permute_kernel", "loop_cond": "loop_cond_kernel"}

_GLOBAL = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)\s*)?(\w+)\s*[(<]")
_IDENT = re.compile(r"[A-Za-z_]\w*")


def kernel_sources(csrc: Path) -> dict:
    """Each ``__global__`` function of the ``*.cu`` files in ``csrc`` ->
    the file that defines it."""
    out = {}
    for path in sorted(Path(csrc).glob("*.cu")):
        for name in _GLOBAL.findall(path.read_text()):
            out[name] = path.name
    return out


def kernel_name(trace_name: str, known) -> str | None:
    """The kernel a trace's event name is (``void shade_hit_kernel(Args)``,
    ``treelet_walk_kernel<true>(...)``), among ``known``."""
    for ident in _IDENT.findall(trace_name):
        if ident in known:
            return ident
    return None


def device_events(prof) -> list:
    """(name, start s, end s) of every device activity in the trace:
    kernels, copies and sets (not the device rows of the host's
    ``record_function`` annotations)."""
    from torch.autograd import DeviceType

    return [(e.name, e.time_range.start * 1e-6, e.time_range.end * 1e-6)
            for e in prof.events()
            if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)]


def host_events(prof) -> list:
    """(name, start s, end s) of the host's recorded ops."""
    from torch.autograd import DeviceType

    return [(e.name, e.time_range.start * 1e-6, e.time_range.end * 1e-6)
            for e in prof.events() if e.device_type == DeviceType.CPU]


def launches(events, known) -> dict:
    """Device launches by kernel name, for the kernels in ``known``."""
    out: dict = {}
    for name, _, _ in events:
        k = kernel_name(name, known)
        if k is not None:
            out[k] = out.get(k, 0) + 1
    return out


def counted(launch_counts: dict) -> dict:
    """The port's counters (``launch_counts()``) summed by the kernel each
    counts."""
    out: dict = {}
    for group in launch_counts.values():
        for key, n in group.items():
            if n:
                kernel = KERNEL_OF.get(key, key)
                out[kernel] = out.get(kernel, 0) + n
    return out


def seconds_by_source(events, sources: dict) -> dict:
    """Device seconds of the kernels of each source file."""
    out: dict = {}
    for name, s, e in events:
        k = kernel_name(name, sources)
        if k is not None:
            out[sources[k]] = out.get(sources[k], 0.0) + (e - s)
    return out


def top_ops(events, n: int = 10) -> list:
    """[[name, seconds]] of the device operations that took the most time,
    summed by name."""
    by: dict = {}
    for name, s, e in events:
        by[name] = by.get(name, 0.0) + (e - s)
    return [[k[:120], v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def idle_gaps(events, hosts, lo: float, hi: float, n: int = 10) -> list:
    """[[what the host was doing, seconds]] of the longest stretches of
    [lo, hi] with nothing on the device: the innermost host op that covers
    each gap's middle."""
    out = []
    for s, e in window.gaps([(a, b) for _, a, b in events], lo, hi)[:n]:
        mid = 0.5 * (s + e)
        cover = [h for h in hosts if h[1] <= mid <= h[2]]
        what = min(cover, key=lambda h: h[2] - h[1])[0] if cover else "no recorded host op"
        out.append([what[:120], e - s])
    return out
