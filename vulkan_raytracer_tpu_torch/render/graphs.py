"""Captured bounces: the port's counterpart of the JAX package's ``jit``.

The JAX renderer compiles a frame into one program (render/renderer.py:34,
52, 112): its waves scan under ``lax.scan``, its bounce loop is a
``lax.while_loop`` whose live-lane test runs on the device
(render/integrator.py:1051-1069), and on a scene with alpha each ray query
is one more ``lax.while_loop``, the accept/reject resample loop
(integrator.py:165-217).  The port runs the same bounce op by op from
Python, thousands of small launches a bounce.  Here each bounce of a wave is
captured once as CUDA graphs and replayed: the host then does per bounce
what JAX's loop conditions do, one read of the live count
(``integrator.render_sample``), and one read of the pending count per pass
of a resample loop.

Where: CUDA tables (:func:`_graphs_preferred`), with alpha or without.
Tests and tools get the eager side by patching ``graphs._graphs_preferred``
(there is no switch); a capture or replay error raises.

A captured step is a program of parts.  Without alpha it is one graph.  On
a scene with alpha the bounce's two resample loops (``integrator._closest``
on the bounce's own ray and on the occlusion ray) split it: at a loop the
capture closes the open segment, captures one pass of the loop
(``integrator._alpha_pass``: a closest-hit launch, the alpha test, the
updates written over the loop's state, then the count of pending lanes) as
a graph of its own, and opens the next segment.  A replay replays each
segment once and each pass while its count, read on the host (JAX's
``jnp.any(pending)`` on the device), is not 0.  Two reads are spared: the
bounce's own loop starts on the wave's live lanes, which the bounce loop
counted and found alive, so its first pass needs none; the occlusion loop
starts on the next state's live lanes, so its first read is the next
bounce's live count (:meth:`_Program.replay` returns it).

The cache is keyed as ``jit`` keys its programs: by the tables'
:func:`signature` (each count, flag and None among their leaves, each
tensor's shape, dtype and device: all a bounce branches on), not by the
tables object.  The graphs are captured against a mirror of the tables, a
copy whose tensors belong to the cache (:meth:`GraphCache.bind`).  A step
with another tables object of the signature first copies that object's
tensors, and the tables it derives from them on first use
(``SceneTables``' cached properties, built on that object), into the
mirror: once per change of tables, timed and counted in :data:`STATS`.  So
``Scene.refit``'s new tables replay the graphs captured before it, and the
old tables go on rendering the old scene.  The mirror holds the scene's
bytes a second time (:meth:`GraphCache.mirror_bytes`).  A cache
(:func:`cache`) goes when the last tables object of its signature does.
Within it a program is keyed by what changes the captured code: the wave
width, the bounce, ``max_depth``, the NEE weighting, whether the step sorts
first and whether the scene is repacked.  At most :data:`MAX_GRAPHS`
programs are kept, the least recently used dropped first (a viewer's
resizes and shard widths make new widths).

Memory.  Each width has one static state: the wave's fields, allocated
outside any capture.  A step copies the caller's state into it (``copy_``,
skipped when the caller hands it back), replays, and the last part writes
the next state over it; the rays the step traced land in a static scalar
of the program's own.  So nothing a caller reads lies in the graphs'
memory pool, one pool per cache: it holds the parts' temporaries, which
every capture takes on the cache's one capture stream and which programs
replayed in any order may share because one stream runs them one after
another, and each resample loop's state and count, which the program keeps
for its lifetime so that no later capture in the pool takes their memory.

The eager warm-up before each capture builds the tables a bounce builds on
first use (the mirror's cached properties, the Morton table) outside the
capture: made inside it, they would come from the graphs' pool.

Counters.  The launch counters (``dense.LAUNCHES``, ``traverse.LAUNCHES``),
``instanced.STATS`` and ``integrator.BOUNCE_WIDTHS`` are Python-side: a
replay of a part adds what its capture counted, so a wave counts as it does
eagerly; ``integrator.ALPHA_LOOP`` is counted on the host per replayed
loop.  The warm-up before a capture counts nothing.  That a replay launches
what its capture counted is measured, not assumed: ``chip_smoke.py``'s
``graphs_busy`` phase and ``tools/profile_torch_wave.py`` hold each
kernel's launches in a profiled replay against the counters.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import time
import weakref

import torch

from ..ops.math3 import V3
from ..scene.scenegraph import map_tables

#: Programs kept per cache (cfg5 steps three ladder widths over nine
#: bounces: 27).
MAX_GRAPHS = 48

#: Since the last reset: programs ``captured``, their ``capture_s`` (warm-up,
#: capture and instantiation), steps replayed (``replays``), resample
#: ``passes`` replayed, and the mirror's fills (``copies``, made or copied
#: into) with their ``copy_bytes``.
STATS = {"captured": 0, "capture_s": 0.0, "replays": 0, "passes": 0, "copies": 0,
         "copy_bytes": 0}
_COPY_EVENTS: list = []  # (start, end) CUDA events of each fill since the last reset


def reset_stats() -> None:
    STATS.update(captured=0, capture_s=0.0, replays=0, passes=0, copies=0, copy_bytes=0)
    _COPY_EVENTS.clear()


def copy_seconds() -> float:
    """Device seconds of the mirror fills on a card since the last reset
    (it waits for them)."""
    total = 0.0
    for start, end in _COPY_EVENTS:
        end.synchronize()
        total += start.elapsed_time(end) / 1e3
    return total


def _graphs_preferred(tables) -> bool:
    """Are this scene's bounces captured and replayed?  On CUDA tables."""
    return tables.device.type == "cuda"


# ---------------------------------------------------------------------------
# Signatures and the caches
# ---------------------------------------------------------------------------


def signature(tables) -> tuple:
    """What a captured bounce depends on beside the values in the tables'
    tensors: each leaf's path with, for a tensor, its shape, dtype and
    device, else its type and value (a count, a flag, None)."""
    out = []

    def leaf(path, v):
        if isinstance(v, torch.Tensor):
            out.append((path, tuple(v.shape), v.dtype, v.device))
        else:
            out.append((path, type(v).__name__, v))
        return v

    map_tables(tables, leaf)
    return tuple(out)


def _tensors(tree) -> list:
    """The tensors of a table tree (or a tensor), in field order."""
    out = []

    def leaf(_, v):
        if isinstance(v, torch.Tensor):
            out.append(v)
        return v

    map_tables(tree, leaf)
    return out


def _derived(tables) -> list:
    """The names of the tables a ``SceneTables`` builds from its tensors on
    first use (its cached properties)."""
    return [k for cls in type(tables).__mro__ for k, v in vars(cls).items()
            if isinstance(v, functools.cached_property)]


_TABLES: dict = {}  # id of a tables object -> its cache, while the object lives
_CACHES: dict = {}  # signature -> its cache, while a tables object of it lives


def cache(tables) -> "GraphCache":
    """The cache of ``tables``' signature, made on first use."""
    key = id(tables)
    c = _TABLES.get(key)
    if c is None:
        sig = signature(tables)
        c = _CACHES.get(sig)
        if c is None:
            c = _CACHES[sig] = GraphCache(sig)
        c.users += 1
        _TABLES[key] = c
        weakref.finalize(tables, _release, key)
    return c


def _release(key) -> None:
    c = _TABLES.pop(key)
    c.users -= 1
    if not c.users:
        del _CACHES[c.signature]


# ---------------------------------------------------------------------------
# Wave states and counters
# ---------------------------------------------------------------------------


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


def _delta(counters, kept) -> list:
    return [{k: v - was.get(k, 0) for k, v in c.items() if v != was.get(k, 0)}
            for c, was in zip(counters, kept)]


def _add(counters, delta) -> None:
    for c, d in zip(counters, delta):
        for k, v in d.items():
            c[k] = c.get(k, 0) + v


# ---------------------------------------------------------------------------
# Capture and replay
# ---------------------------------------------------------------------------


class _Loop:
    """A resample loop of a captured step: its pass's count of pending lanes
    (a device scalar the segment before the loop and the pass write), whether
    its first pass needs no read (``first``) and whether its first count is
    the next state's live count (``live``), the callback that counts the
    passes of a replay, and what the program keeps alive (the pass's inputs
    and the loop's state)."""

    def __init__(self, count, first: bool, live: bool, done, keep):
        self.count, self.first, self.live, self.done, self.keep = count, first, live, done, keep


class _Part:
    """A graph of a program, what its capture counted and, for a pass, its
    loop."""

    def __init__(self, graph, delta, loop: _Loop | None):
        self.graph, self.delta, self.loop = graph, delta, loop


class _Capture:
    """A step being captured into parts, all in one memory pool.  ``graph``
    makes a graph (``torch.cuda.CUDAGraph``; the tests give a stand-in)."""

    def __init__(self, pool, counters, graph=None):
        self.pool, self.counters = pool, counters
        self.new_graph = graph or torch.cuda.CUDAGraph
        self.parts: list = []
        self.graph = None

    def begin(self) -> None:
        self.kept = _snapshot(self.counters)
        self.graph = self.new_graph()
        self.graph.capture_begin(pool=self.pool)

    def end(self, loop: _Loop | None = None) -> None:
        graph, self.graph = self.graph, None
        graph.capture_end()
        self.parts.append(_Part(graph, _delta(self.counters, self.kept), loop))

    def abort(self) -> None:
        """End a capture left open by an error (the error goes on)."""
        if self.graph is not None:
            graph, self.graph = self.graph, None
            with contextlib.suppress(Exception):
                graph.capture_end()

    def loop(self, body, st: dict, *, first: bool, live: bool, done) -> dict:
        """``while a lane of st["pending"] is pending: st = body(st)``, as
        captured parts: the open segment ends with the loop's state in
        buffers of its own and the count of its pending lanes; one pass,
        written over that state, is a part of its own; the next segment
        opens.  Returns the state after the loop (the same buffers)."""
        st = {k: v.clone() for k, v in st.items()}
        count = st["pending"].sum()
        self.end()
        self.begin()
        nxt = body(st)
        for k, v in st.items():
            v.copy_(nxt[k])
        count.copy_(st["pending"].sum())
        self.end(_Loop(count, first, live, done, (body, st)))
        self.begin()
        return st


_CAPTURING: list = []  # the capture in progress


def current_capture() -> _Capture | None:
    """The step capture in progress, if any: the integrator hands it its
    resample loops."""
    return _CAPTURING[-1] if _CAPTURING else None


@contextlib.contextmanager
def capturing(cap: _Capture):
    _CAPTURING.append(cap)
    try:
        yield cap
    except BaseException:
        cap.abort()
        raise
    finally:
        _CAPTURING.pop()


class _Program:
    """One captured step: its parts, the static state it reads and writes
    and its rays scalar."""

    def __init__(self, parts: list, state: dict, rays):
        self.parts, self.state, self.rays = parts, state, rays

    def replay(self, counters) -> int | None:
        """Replay the parts in order, each pass while its loop has a pending
        lane; returns the next state's live count where a loop read it."""
        live = None
        for part in self.parts:
            loop = part.loop
            if loop is None:
                part.graph.replay()
                _add(counters, part.delta)
                continue
            passes = 0
            while True:
                if passes or not loop.first:
                    n = int(loop.count)
                    if loop.live and not passes:
                        live = n
                    if not n:
                        break
                part.graph.replay()
                _add(counters, part.delta)
                passes += 1
            STATS["passes"] += passes
            loop.done(passes)
        return live


class GraphCache:
    """The captured steps of one tables signature, their mirror of the
    tables and their static states."""

    def __init__(self, sig: tuple):
        self.signature = sig
        self.users = 0  # live tables objects of the signature
        self.mirror = None  # the tables the graphs read, made on the first bind
        self._source = None  # weak reference to the tables the mirror holds
        self.pool = None  # one memory pool for every graph, made on the first capture
        # the stream every capture runs on: the allocator hands a freed block
        # only to the stream it was allocated on, so one stream lets each
        # capture take the temporaries of the captures before it
        self.stream = None
        self.graphs: collections.OrderedDict = collections.OrderedDict()
        self.states: dict = {}  # (wave width, fields) -> static state

    def bind(self, tables):
        """The mirror, holding ``tables``' values: made on first use, copied
        into when the last step ran with another tables object."""
        if self.mirror is None:
            mirror = map_tables(tables, lambda _, v: torch.empty_like(v)
                                if isinstance(v, torch.Tensor) else v)
            self._fill(list(zip(_tensors(mirror), _tensors(tables))))
            self.mirror = mirror
        elif self._source() is not tables:
            pairs = list(zip(_tensors(self.mirror), _tensors(tables)))
            built = vars(self.mirror)
            for name in _derived(self.mirror):
                if name in built:  # built on the source, which keeps it
                    pairs += zip(_tensors(built[name]), _tensors(getattr(tables, name)))
            self._fill(pairs)
        else:
            return self.mirror
        self._source = weakref.ref(tables)
        return self.mirror

    @staticmethod
    def _fill(pairs) -> None:
        cuda = bool(pairs) and pairs[0][0].is_cuda
        if cuda:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
        for dst, src in pairs:
            dst.copy_(src)
        if cuda:
            end.record()
            _COPY_EVENTS.append((start, end))
        STATS["copies"] += 1
        STATS["copy_bytes"] += sum(d.numel() * d.element_size() for d, _ in pairs)

    def mirror_bytes(self) -> int:
        """Bytes of the mirror's tensors, its derived tables included."""
        if self.mirror is None:
            return 0
        built = vars(self.mirror)
        tensors = _tensors(self.mirror) + [t for name in _derived(self.mirror) if name in built
                                           for t in _tensors(built[name])]
        return sum(t.numel() * t.element_size() for t in tensors)

    def run(self, tables, key, fn, s: dict, counters):
        """``fn(mirror, s)`` -> (next state, rays traced) as a replay of its
        program under ``key`` and the shape of ``s``, captured on first use.
        Returns the static state, which the next step of the same width
        takes back without a copy, the rays scalar, which the next replay of
        this program overwrites, and the next state's live count where the
        replay read it (else None)."""
        skey = (s["active"].shape[0], tuple(s))
        gkey = (skey, key)
        with torch.inference_mode(False), torch.no_grad():
            mirror = self.bind(tables)
            entry = self.graphs.get(gkey)
            if entry is None:
                static = self.states.get(skey)
                if static is None:
                    static = self.states[skey] = _empty_state(s)
                _copy_state(static, s)
                entry = self.graphs[gkey] = self._capture(lambda st: fn(mirror, st), static,
                                                          counters)
                while len(self.graphs) > MAX_GRAPHS:
                    self.graphs.popitem(last=False)
                used = {k[0] for k in self.graphs}
                self.states = {k: v for k, v in self.states.items() if k in used}
            else:
                _copy_state(entry.state, s)
            self.graphs.move_to_end(gkey)
            live = entry.replay(counters)
        STATS["replays"] += 1
        return entry.state, entry.rays, live

    def _capture(self, fn, static: dict, counters) -> _Program:
        t0 = time.perf_counter()
        device = static["active"].device
        kept = _snapshot(counters)
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
            self.stream = torch.cuda.Stream(device)
        side = self.stream
        # warm-up on the side stream (torch.cuda.graphs): builds what is built
        # on first use (the lazy tables), outside the capture; it counts nothing
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            fn(static)
        torch.cuda.current_stream(device).wait_stream(side)
        _restore(counters, kept)
        rays = torch.zeros((), dtype=torch.int64, device=device)
        cap = _Capture(self.pool, counters)
        torch.cuda.synchronize(device)
        with torch.cuda.stream(side), capturing(cap):
            cap.begin()
            out, r = fn(static)
            _copy_state(static, out)
            rays.copy_(r)
            cap.end()
        _restore(counters, kept)
        STATS["captured"] += 1
        STATS["capture_s"] += time.perf_counter() - t0
        return _Program(cap.parts, static, rays)

    def pool_bytes(self) -> int:
        """Bytes the allocator holds in the graphs' pool."""
        if self.pool is None:
            return 0
        pool = tuple(self.pool)
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg.get("segment_pool_id", ())) == pool)
