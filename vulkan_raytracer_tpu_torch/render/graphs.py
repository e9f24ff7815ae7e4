"""Captured bounces: the port's counterpart of the JAX package's ``jit``.

The JAX renderer compiles a frame into one program (render/renderer.py:34,
52, 112): its waves scan under ``lax.scan`` and its bounce loop is a
``lax.while_loop`` whose live-lane test runs on the device
(render/integrator.py:1051-1069).  The port runs the same bounce op by op
from Python, thousands of small launches a bounce.  Here each bounce of a
wave is captured once as a ``torch.cuda.CUDAGraph`` and replayed: the host
then does per bounce what JAX's loop condition does, one read of the live
count (``integrator.render_sample``), and one replay.

Where: CUDA tables of a scene without alpha (:func:`_graphs_preferred`).
The alpha resample loop reads the device on the host once per pass inside
the bounce, so alpha scenes run eagerly.  Tests and tools get the eager side
by patching ``graphs._graphs_preferred`` (there is no switch); a capture or
replay error raises.

The cache (:class:`GraphCache`) of a ``SceneTables`` object
(:func:`cache`) dies with it: ``Scene.refit`` returns new tables, which
capture anew and never replay a graph taken on the old tensors' addresses.
Within one tables object a graph is keyed by what changes the captured
program: the wave width, the bounce, ``max_depth``,
the NEE weighting, whether the step sorts first and whether the scene is
repacked.  At most :data:`MAX_GRAPHS` are kept, the least recently used
dropped first (a viewer's resizes and shard widths make new widths).

Memory.  Each width has one static state: the wave's fields, allocated
outside any capture.  A step copies the caller's state into it (``copy_``,
skipped when the caller hands it back), replays, and the graph writes the
next state over it at its end; the rays the step traced land in a static
scalar of the graph's own.  So nothing a caller reads lies in the graphs'
memory pool, one pool per tables object: the pool holds the graphs'
temporaries only, which replays in any order may share because one stream
runs them one after another.

The eager warm-up before each capture builds the tables a bounce builds on
first use (``SceneTables``' cached properties, the Morton table) outside the
capture: made inside it, they would come from the graphs' pool.

Counters.  The launch counters (``dense.LAUNCHES``, ``traverse.LAUNCHES``),
``instanced.STATS`` and ``integrator.BOUNCE_WIDTHS`` are Python-side: a
replay adds what its capture counted, so a wave counts as it does eagerly.
The warm-up before a capture counts nothing.  That a replay launches what
its capture counted is measured, not assumed: ``chip_smoke.py``'s
``graphs_busy`` phase and ``tools/profile_torch_wave.py`` hold each
kernel's launches in a profiled replay against the counters.
"""

from __future__ import annotations

import collections
import time
import weakref

import torch

from ..ops.math3 import V3

#: Graphs kept per tables object (cfg5 steps three ladder widths over nine
#: bounces: 27).
MAX_GRAPHS = 48

#: Since the last reset: graphs ``captured``, their ``capture_s`` (warm-up,
#: capture and instantiation) and ``replays``.
STATS = {"captured": 0, "capture_s": 0.0, "replays": 0}


def reset_stats() -> None:
    STATS.update(captured=0, capture_s=0.0, replays=0)


#: id of a tables object -> its cache; the entry goes when the tables do
_CACHES: dict = {}


def cache(tables) -> "GraphCache":
    """The captured steps of ``tables``, made on first use."""
    key = id(tables)
    c = _CACHES.get(key)
    if c is None:
        c = _CACHES[key] = GraphCache()
        weakref.finalize(tables, _CACHES.pop, key, None)
    return c


def _graphs_preferred(tables) -> bool:
    """Are this scene's bounces captured and replayed?  On CUDA tables of a
    scene without alpha; the alpha loop synchronises inside the bounce."""
    return tables.device.type == "cuda" and not tables.has_alpha


def _leaves(s: dict):
    """The tensors of a wave state, in field order."""
    for v in s.values():
        yield from (v if isinstance(v, V3) else (v,))


def _empty_state(s: dict) -> dict:
    """Contiguous buffers for a state like ``s``."""
    def empty(t):
        return torch.empty(t.shape, dtype=t.dtype, device=t.device)

    return {k: V3(*map(empty, v)) if isinstance(v, V3) else empty(v) for k, v in s.items()}


def _copy_state(dst: dict, src: dict) -> None:
    for d, s in zip(_leaves(dst), _leaves(src)):
        if d is not s:
            d.copy_(s)


def _snapshot(counters) -> list:
    return [dict(c) for c in counters]


def _restore(counters, kept) -> None:
    for c, was in zip(counters, kept):
        c.clear()
        c.update(was)


class _Graph:
    """One captured step: the graph, the static state it reads and writes,
    its rays scalar and what it counts."""

    def __init__(self, graph, state, rays, delta):
        self.graph, self.state, self.rays, self.delta = graph, state, rays, delta


class GraphCache:
    """The captured steps of one tables object and their static states."""

    def __init__(self):
        self.pool = None  # one memory pool for every graph, made on the first capture
        self.graphs: collections.OrderedDict = collections.OrderedDict()
        self.states: dict = {}  # (wave width, fields) -> static state

    def run(self, key, fn, s: dict, counters):
        """``fn(s)`` -> (next state, rays traced) as a replay of its graph
        under ``key`` and the shape of ``s``, captured on first use.  Returns
        the static state, which the next step of the same width takes back
        without a copy, and the rays scalar, which the next replay of this
        graph overwrites."""
        skey = (s["active"].shape[0], tuple(s))
        gkey = (skey, key)
        with torch.inference_mode(False), torch.no_grad():
            entry = self.graphs.get(gkey)
            if entry is None:
                static = self.states.get(skey)
                if static is None:
                    static = self.states[skey] = _empty_state(s)
                _copy_state(static, s)
                entry = self.graphs[gkey] = self._capture(fn, static, counters)
                while len(self.graphs) > MAX_GRAPHS:
                    self.graphs.popitem(last=False)
                used = {k[0] for k in self.graphs}
                self.states = {k: v for k, v in self.states.items() if k in used}
            else:
                _copy_state(entry.state, s)
            self.graphs.move_to_end(gkey)
            entry.graph.replay()
        STATS["replays"] += 1
        for c, d in zip(counters, entry.delta):
            for k, v in d.items():
                c[k] = c.get(k, 0) + v
        return entry.state, entry.rays

    def _capture(self, fn, static: dict, counters) -> _Graph:
        t0 = time.perf_counter()
        device = static["active"].device
        kept = _snapshot(counters)
        # warm-up on a side stream (torch.cuda.graphs): builds what is built
        # on first use (the lazy tables), outside the capture; it counts nothing
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            fn(static)
        torch.cuda.current_stream(device).wait_stream(side)
        _restore(counters, kept)
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        rays = torch.zeros((), dtype=torch.int64, device=device)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self.pool):
            out, r = fn(static)
            _copy_state(static, out)
            rays.copy_(r)
        delta = [{k: v - was.get(k, 0) for k, v in c.items() if v != was.get(k, 0)}
                 for c, was in zip(counters, kept)]
        _restore(counters, kept)
        STATS["captured"] += 1
        STATS["capture_s"] += time.perf_counter() - t0
        return _Graph(graph, static, rays, delta)

    def pool_bytes(self) -> int:
        """Bytes the allocator holds in the graphs' pool."""
        if self.pool is None:
            return 0
        pool = tuple(self.pool)
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg.get("segment_pool_id", ())) == pool)
