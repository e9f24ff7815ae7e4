"""Captured waves: the port's counterpart of the JAX package's ``jit``.

The JAX renderer compiles a frame into one program (render/renderer.py:34,
52, 112): its waves scan under ``lax.scan``, its bounce loop is a
``lax.while_loop`` whose live-lane test runs on the device
(render/integrator.py:1051-1069), the width ladder's phases are further
``while_loop``s (:1071-1124) with ``lax.cond`` re-sorts (:1063, :1089), and
on a scene with alpha each ray query is one more ``lax.while_loop``, the
accept/reject resample loop (:165-217).  Here a wave, from its sample
numbers to its sum in the frame's accumulator, is one program, captured
once and launched once: its straight code as CUDA graphs, its loops as
conditional WHILE nodes and its re-sorts as conditional IF nodes, whose
conditions a hand-written kernel sets on the card (``csrc/graph_loops.cu``
``loop_cond_kernel``).  The host reads nothing inside a wave, and writes
its inputs only on the device (``integrator.Waves``).

Where: CUDA tables (:func:`_graphs_preferred`), with alpha or without.
Tests and tools get the eager side by patching ``graphs._graphs_preferred``
and the plain version of the device loops, the host-read replay, by
patching ``graphs._device_loops_preferred`` (there is no switch); a
capture, build, instantiation or launch error raises, and nothing falls
back to another side.

A program is a tree (``integrator._wave_program`` builds it through a
:class:`_Capture`).  Its leaves are parts: the code between two loop
boundaries, each captured as a ``torch.cuda.CUDAGraph(keep_graph=True)``.
Its inner nodes are a WHILE or an IF with a :class:`Cond` (a device count
above a floor and, for the bounce loop, the device bounce index ``b`` at
most ``max_depth``) and a body of parts and nodes.  A wave is::

    phase(n, floor)  = WHILE (b <= max_depth && live > floor)
                           { [IF sort_next: sort]; bounce(b); b += 1 }
    bounce           = segment; WHILE (pending) { alpha pass }; segment;
                       WHILE (pending) { alpha pass }; segment
    wave             = rays; phase(n, n/2); IF more: sort; split; phase(n/2, n/4);
                       IF more: sort; split; phase(n/4, 0); join; radiance; sum

on a repacked scene whose width divides by 4 (the ladder), else
``rays; phase(n, 0); radiance; sum``; an alpha-free bounce is one segment.
``rays`` is the primary-ray kernel, which writes the initial state from the
wave's inputs; a resample pass is its traversal launch and the alpha
test-and-commit kernel, which writes the loop's count; ``sum`` adds the
wave's radiance, summed over its samples, into the band's sum and its rays
into the frame's counter.
:meth:`_Program.launch` runs it one of two ways:

* **device loops** (the main path): the C side stitches the parts into one
  parent graph (each a child graph node, each WHILE and IF a conditional
  node with a ``loop_cond_kernel`` entry test before it and, for a WHILE,
  one more ending its body), instantiates it once and launches it on the
  current stream;
* **host-read replay** (the plain version): :meth:`_Program.interpret`
  walks the same tree on the host, replays each part's graph and reads
  each condition on the host (one read per test; the stand-in graphs of
  the CPU tests run here).

The cache is keyed as ``jit`` keys its programs: by the tables'
:func:`signature` (each count, flag and None among their leaves, each
tensor's shape, dtype and device: all a wave branches on), not by the
tables object.  The graphs are captured against a mirror of the tables, a
copy whose tensors belong to the cache (:meth:`GraphCache.bind`).  A wave
with another tables object of the signature first copies that object's
tensors, and the tables it derives from them on first use
(``SceneTables``' cached properties, built on that object), into the
mirror: once per change of tables, timed and counted in :data:`STATS`.  So
``Scene.refit``'s new tables replay the programs captured before it, and
the old tables go on rendering the old scene.  The mirror holds the scene's
bytes a second time (:meth:`GraphCache.mirror_bytes`).  A cache
(:func:`cache`) goes when the last tables object of its signature does.
Within it a program is keyed by the wave's pixels and samples, the frame's
width and height, whether its radiance comes back in pixel order,
``max_depth``, the NEE weighting and whether the scene is repacked: one
program per wave shape.  At most :data:`MAX_GRAPHS` programs are kept, the
least recently used dropped first with their parent graph (a viewer's
resizes and shard widths make new widths).

Memory.  A program's inputs (the wave's sample numbers, the band's pixel
lanes, the camera) and its sums (the band's (n, 3) sum, the frame's ray
counter) are the cache's buffers (:meth:`GraphCache.buffer`), allocated
outside any capture and shared by the programs of their shape; the
renderer writes the inputs on the device before a launch and zeroes the
sums.  Everything else the program's parts allocate (the wave's state,
the ladder's narrower states, each resample loop's state and count,
``b``, the live count, the wave's rays and radiance) lies in the graphs'
memory pool, one pool per cache, which every capture takes on the cache's
one capture stream; the program keeps its parts' graphs and what its
conditions read for its lifetime.  Programs of one cache run one after
another on one stream, so they may share the temporaries of the pool.  A
launch hands the caller the program's radiance and rays, which its next
launch overwrites; the sums are what a frame keeps.

The eager warm-up before each capture builds the tables a bounce builds on
first use (the mirror's cached properties) outside the capture: made inside
it, they would come from the graphs' pool.

Counters.  The launch counters (``dense.LAUNCHES``, ``traverse.LAUNCHES``),
``instanced.STATS``, ``integrator.BOUNCE_WIDTHS`` and
``integrator.ALPHA_LOOP`` are Python-side.  Each part's capture records
what it counted; each conditional node has a row of four device counters
that its tests keep (bodies run, entries, the bodies of the current entry
and the most bodies one entry ran).  A launch on the card adds nothing on
the host: :func:`settle` reads every row since the last settle in the read
that ends a frame (``renderer.render_image``'s ray count, the progressive
``Renderer``'s ``rays_traced``) and adds each part's counts times the runs
of its body, and the alpha loops' calls, passes and most passes a call.  A
caller that reads the counters after ``render_sample`` without such a read
calls :func:`settle` first.  :data:`LAUNCHES` counts ``loop_cond_kernel``'s
launches the same way.  The host-read replay counts as it goes.  The
warm-up before a capture counts nothing.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import functools
import time
import warnings
import weakref

import torch

from ..ops import _ext, trace
from ..ops.math3 import V3
from ..scene.scenegraph import map_tables

#: Programs kept per cache: one per wave shape (a frame's waves share one).
MAX_GRAPHS = 16

#: Since the last reset: programs ``captured``, their ``capture_s`` (warm-up,
#: capture and instantiation), program ``launches`` (waves), bounces
#: replayed (``replays``), resample ``passes`` replayed, re-sorts run
#: (``sorts``), and the mirror's fills (``copies``, made or copied into)
#: with their ``copy_bytes``.  A launch on the card counts its bounces,
#: passes and re-sorts at :func:`settle`.
STATS = {"captured": 0, "capture_s": 0.0, "launches": 0, "replays": 0, "passes": 0,
         "sorts": 0, "copies": 0, "copy_bytes": 0}
#: ``loop_cond_kernel``'s launches (each node's entry tests and each WHILE
#: body's closing tests) since the last reset, counted at :func:`settle`.
LAUNCHES = {"loop_cond": 0}
_COPY_EVENTS: list = []  # (start, end) CUDA events of each fill since the last reset
_PENDING: dict = {}  # program -> None: programs launched on the card since the last settle


def reset_stats() -> None:
    STATS.update(captured=0, capture_s=0.0, launches=0, replays=0, passes=0, sorts=0,
                 copies=0, copy_bytes=0)
    LAUNCHES["loop_cond"] = 0
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
    """Is this scene's wave captured and launched as a program?  On CUDA
    tables."""
    return tables.device.type == "cuda"


def _device_loops_preferred(tables) -> bool:
    """Does a program run its loops on the card (else the host-read
    replay)?  On CUDA tables."""
    return tables.device.type == "cuda"


# ---------------------------------------------------------------------------
# Signatures and the caches
# ---------------------------------------------------------------------------


def signature(tables) -> tuple:
    """What a captured wave depends on beside the values in the tables'
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


def _state_like(s: dict, cols) -> dict:
    """A wave state of ``s``'s fields made of the columns ``cols``, in
    ``s``'s field order (:func:`_leaves`)."""
    it = iter(cols)
    return {k: V3(next(it), next(it), next(it)) if isinstance(v, V3) else next(it)
            for k, v in s.items()}


def _copy_state(dst: dict, src: dict) -> None:
    """Copy each column of ``src`` that is not ``dst``'s own into ``dst``'s
    (one ``permute_kernel`` launch on a card)."""
    pairs = [(d, s) for d, s in zip(_leaves(dst), _leaves(src)) if d is not s]
    trace.permute([s for _, s in pairs], mode="copy", out=[d for d, _ in pairs])


def _snapshot(counters) -> list:
    return [dict(c) for c in counters]


def _restore(counters, kept) -> None:
    for c, was in zip(counters, kept):
        c.clear()
        c.update(was)


def _delta(counters, kept) -> list:
    return [{k: v - was.get(k, 0) for k, v in c.items() if v != was.get(k, 0)}
            for c, was in zip(counters, kept)]


def _add(counters, delta, times: int = 1) -> None:
    if not times:  # a body that never ran counts nothing, not a 0 under its key
        return
    for c, d in zip(counters, delta):
        for k, v in d.items():
            c[k] = c.get(k, 0) + v * times


# ---------------------------------------------------------------------------
# Programs: capture
# ---------------------------------------------------------------------------


class Cond:
    """The condition of a loop or an IF: the device count ``count`` (int64)
    above ``floor`` and, where ``b`` (an int32 device scalar) is given, ``b``
    at most ``max_depth``.  The program's parts write both."""

    def __init__(self, count, floor: int = 0, b=None, max_depth: int = 0):
        self.count, self.floor, self.b, self.max_depth = count, floor, b, max_depth

    def test(self) -> bool:
        """The condition read on the host (the plain version of the test
        ``loop_cond_kernel`` makes on the card)."""
        return int(self.count) > self.floor and (self.b is None
                                                 or int(self.b) <= self.max_depth)


class _Part:
    """A leaf of a program: a captured graph and what its capture counted."""

    def __init__(self, graph, delta):
        self.graph, self.delta = graph, delta


class _Node:
    """A WHILE or an IF of a program: its condition, its body (parts and
    nodes), its row of counters, its ``role`` (``"phase"``: the bounce loop;
    ``"alpha"``: a resample loop; ``"sort"``: a re-sort) and, for a
    resample loop, ``done(passes, calls, most)``, which counts them in
    ``integrator.ALPHA_LOOP``."""

    def __init__(self, kind: str, cond: Cond, row: int, role: str, done=None):
        self.kind, self.cond, self.row, self.role, self.done = kind, cond, row, role, done
        self.body: list = []


class _TorchGraph:
    """A part's graph: a ``torch.cuda.CUDAGraph`` that keeps its
    ``cudaGraph_t`` (``keep_graph=True``), which the C side clones into the
    parent graph."""

    def __init__(self):
        if not hasattr(torch.cuda.CUDAGraph, "raw_cuda_graph"):
            raise RuntimeError(f"torch {torch.__version__} has no CUDAGraph(keep_graph=True) "
                               "with raw_cuda_graph(): the device loops need both")
        self.graph = torch.cuda.CUDAGraph(keep_graph=True)

    def capture_begin(self, pool=None) -> None:
        self.graph.capture_begin(pool=pool)

    def capture_end(self) -> None:
        with warnings.catch_warnings():  # an empty part is dropped, not an error
            warnings.filterwarnings("ignore", message=".*CUDA Graph is empty.*")
            self.graph.capture_end()

    def raw(self) -> int:
        return self.graph.raw_cuda_graph()

    def nodes(self) -> int:
        """The part's node count; raises, naming the node, where it holds one
        a conditional body may not."""
        lib = _ext.library()
        n, bad = ctypes.c_int(), ctypes.c_int()
        _ext.check(lib, lib.graph_loops_check(self.raw(), ctypes.byref(n), ctypes.byref(bad)),
                   "graph_loops_check")
        if bad.value >= 0:
            name = lib.graph_loops_node_type_name(bad.value).decode()
            raise RuntimeError(f"a captured part holds a {name} node, which a conditional "
                               "graph body may not hold")
        return n.value

    def replay(self) -> None:
        self.graph.replay()


class _Capture:
    """A program being captured: its tree of parts and nodes, all in one
    memory pool.  ``graph`` makes a part's graph (:class:`_TorchGraph`; the
    CPU tests give a stand-in with the same methods)."""

    def __init__(self, pool, counters, graph=None):
        self.pool, self.counters = pool, counters
        self.new_graph = graph or _TorchGraph
        self.nodes: list = []  # the program's top level
        self.conds: list = []  # every node, in the order of their rows
        self._open = [self.nodes]  # the bodies being filled, innermost last
        self.graph = None

    def begin(self) -> None:
        self.kept = _snapshot(self.counters)
        self.graph = self.new_graph()
        self.graph.capture_begin(pool=self.pool)

    def end(self) -> None:
        graph, self.graph = self.graph, None
        graph.capture_end()
        delta = _delta(self.counters, self.kept)
        if graph.nodes():
            self._open[-1].append(_Part(graph, delta))
        elif any(delta):
            raise RuntimeError(f"a captured part counted {delta} but launched nothing")

    def abort(self) -> None:
        """End a capture left open by an error (the error goes on)."""
        if self.graph is not None:
            graph, self.graph = self.graph, None
            with contextlib.suppress(Exception):
                graph.capture_end()

    def _node(self, kind: str, cond: Cond, body, role: str, done=None) -> None:
        self.end()
        node = _Node(kind, cond, len(self.conds), role, done)
        self.conds.append(node)
        self._open.append(node.body)
        self.begin()
        body()
        self.end()
        self._open.pop()
        self._open[-1].append(node)
        self.begin()

    def while_(self, cond: Cond, body, role: str, done=None) -> None:
        """``while cond: body()``: the open part ends, ``body``'s code is
        captured once as the loop's body, and the next part opens."""
        self._node("while", cond, body, role, done)

    def if_(self, cond: Cond, body, role: str = "sort") -> None:
        """``if cond: body()``, captured as :meth:`while_` captures."""
        self._node("if", cond, body, role)

    def loop(self, body, st: dict, *, done) -> None:
        """The resample loop ``while a lane of st["pending"] is pending:
        body(st, count)``: a WHILE on the count of ``st``'s pending lanes
        (``st`` is the loop's own buffers) whose pass writes the next state
        over ``st`` and the lanes still pending into the count."""
        count = st["pending"].sum()
        self.while_(Cond(count), lambda: body(st, count), "alpha", done)


_CAPTURING: list = []  # the capture in progress


def current_capture() -> _Capture | None:
    """The program capture in progress, if any: the integrator hands it its
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


# ---------------------------------------------------------------------------
# Programs: launch
# ---------------------------------------------------------------------------


def _c(name: str, *args) -> None:
    lib = _ext.library()
    _ext.check(lib, getattr(lib, name)(*args), name)


def _destroy(parent: int, exe: int) -> None:
    _c("graph_loops_destroy", parent, exe)


class _Program:
    """One captured wave: its tree, the buffers it reads and adds into
    (``io``: its inputs and sums, the cache's), its outputs (radiance and
    rays), the counters its parts count into and one row of four int64
    counters per node (``stats``, on the wave's device; the tests of the
    device loops keep them)."""

    def __init__(self, nodes: list, conds: list, io: dict, outputs: tuple, counters):
        self.nodes, self.conds, self.io, self.outputs = nodes, conds, io, outputs
        self.counters = counters
        self.stats = torch.zeros((len(conds), 4), dtype=torch.int64,
                                 device=next(iter(io.values())).device)
        self.pending = 0  # launches on the card since the last settle
        self.exec = None  # the instantiated parent graph, made on the first launch
        self._finalizer = None

    def launch(self, device_loops: bool) -> None:
        """Run the wave once: on the card (``device_loops``), counted at the
        next :func:`settle`, or as the host-read replay, counted now."""
        if not device_loops:
            rows = [[0, 0, 0, 0] for _ in self.conds]
            self.interpret(self.nodes, rows)
            self._fold(rows, 1, device=False)
            return
        device = self.stats.device
        if self.exec is None:
            self._instantiate(device)
        _c("graph_loops_launch", device.index, self.exec,
           torch.cuda.current_stream(device).cuda_stream)
        self.pending += 1
        _PENDING[self] = None

    def interpret(self, nodes: list, rows: list) -> None:
        """The plain version of the device loops: each part's graph replayed,
        each node's condition read on the host, its row kept as
        ``loop_cond_kernel`` keeps it."""
        for node in nodes:
            if isinstance(node, _Part):
                node.graph.replay()
                continue
            go = self._test(node, rows[node.row], entry=True)
            while go:
                self.interpret(node.body, rows)
                if node.kind == "if":
                    break
                go = self._test(node, rows[node.row], entry=False)

    @staticmethod
    def _test(node: _Node, row: list, entry: bool) -> bool:
        go = node.cond.test()
        if entry:
            row[1] += 1
            row[2] = 0
        if go:
            row[0] += 1
            row[2] += 1
        else:
            row[3] = max(row[3], row[2])
        return go

    def _fold(self, rows: list, launches: int, device: bool) -> None:
        """Add what ``launches`` launches counted, from their rows: each
        part's counts times the runs of its body, the nodes' tests (on the
        card, ``loop_cond_kernel``'s launches), bounces and passes."""
        def add(nodes, times):
            for node in nodes:
                if isinstance(node, _Part):
                    _add(self.counters, node.delta, times)
                else:
                    add(node.body, rows[node.row][0])

        add(self.nodes, launches)
        STATS["launches"] += launches
        for node in self.conds:
            runs, entries, _, most = rows[node.row]
            if device:
                LAUNCHES["loop_cond"] += entries + (runs if node.kind == "while" else 0)
            if node.role == "phase":
                STATS["replays"] += runs
            elif node.role == "sort":
                STATS["sorts"] += runs
            elif node.role == "alpha":
                STATS["passes"] += runs
                node.done(runs, entries, most)

    def _instantiate(self, device) -> None:
        """Stitch the parts into one parent graph and instantiate it."""
        parent, exe = ctypes.c_void_p(), ctypes.c_void_p()
        _c("graph_loops_create", ctypes.byref(parent))
        try:
            self._stitch(parent, self.nodes)
            _c("graph_loops_instantiate", device.index, parent, ctypes.byref(exe))
        except BaseException:
            _destroy(parent.value, exe.value)
            raise
        self.exec = exe.value
        self._finalizer = weakref.finalize(self, _destroy, parent.value, exe.value)
        self._finalizer.atexit = False  # the driver may be gone at exit

    def _stitch(self, graph, nodes: list) -> ctypes.c_void_p:
        tail = ctypes.c_void_p()
        row_ptr = self.stats.data_ptr()
        for node in nodes:
            if isinstance(node, _Part):
                _c("graph_loops_add_child", graph, ctypes.byref(tail), node.graph.raw())
                continue
            c = node.cond
            b = None if c.b is None else c.b.data_ptr()
            args = (b, c.max_depth, c.count.data_ptr(), c.floor, row_ptr + 32 * node.row)
            handle, body = ctypes.c_uint64(), ctypes.c_void_p()
            _c("graph_loops_add_conditional", graph, ctypes.byref(tail), node.kind == "while",
               *args, ctypes.byref(handle), ctypes.byref(body))
            body_tail = self._stitch(body, node.body)
            if node.kind == "while":
                _c("graph_loops_add_test", body, ctypes.byref(body_tail), handle.value, *args)
        return tail

    def close(self) -> None:
        """Destroy the parent graph (a launch in flight completes first)."""
        if self._finalizer is not None:
            self._finalizer()
        self.exec = None


def settle(*scalars) -> list:
    """The host values of the 0-d integer tensors ``scalars``, read together
    with the rows of every program launched on the card since the last
    settle (one read per device), whose counts are added to the counters
    here.  The read that ends a frame goes through this."""
    progs = list(_PENDING)
    _PENDING.clear()
    by_device: dict = {}
    for i, t in enumerate(scalars):
        by_device.setdefault(t.device, ([], []))[0].append(i)
    for p in progs:
        by_device.setdefault(p.stats.device, ([], []))[1].append(p)
    values: list = [None] * len(scalars)
    with torch.inference_mode(False), torch.no_grad():
        for idx, ps in by_device.values():
            flat = torch.cat([scalars[i].reshape(1).to(torch.int64) for i in idx]
                             + [p.stats.reshape(-1) for p in ps])
            host = flat.tolist()
            for k, i in enumerate(idx):
                values[i] = host[k]
            at = len(idx)
            for p in ps:
                n = p.stats.shape[0]
                rows = [host[at + 4 * r:at + 4 * r + 4] for r in range(n)]
                at += 4 * n
                p.stats.zero_()
                p._fold(rows, p.pending, device=True)
                p.pending = 0
    return values


# ---------------------------------------------------------------------------
# The cache
# ---------------------------------------------------------------------------


class GraphCache:
    """The captured waves of one tables signature and their mirror of the
    tables."""

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
        self.graphs: collections.OrderedDict = collections.OrderedDict()  # key -> _Program
        # the programs' inputs and sums, outside the pool: (name, shape, dtype) -> tensor
        self.buffers: dict = {}

    def bind(self, tables):
        """The mirror, holding ``tables``' values: made on first use, copied
        into when the last wave ran with another tables object."""
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

    def buffer(self, name: str, shape, dtype, device) -> torch.Tensor:
        """The cache's buffer ``name`` of this shape and dtype, zeros when
        made: a program's input or sum, which the programs of its shape
        share, made outside any capture and outside inference mode."""
        key = (name, tuple(shape), dtype)
        t = self.buffers.get(key)
        if t is None:
            with torch.inference_mode(False):
                t = self.buffers[key] = torch.zeros(shape, dtype=dtype, device=device)
        return t

    def run(self, tables, key, io: dict, eager, build, counters):
        """One wave as a launch of its program under ``key``, captured on
        first use: ``build(mirror, io, capture)`` captures it
        (``eager(mirror, io)``, the same wave run eagerly, warms up first).
        ``io`` holds its buffers (:meth:`buffer`): the inputs it reads
        (``samples``, ``lanes``, ``cam``) and the sums it adds into (``sum``,
        ``rays``).  Returns its outputs, the wave's (radiance, rays): the
        program's own tensors, which its next launch overwrites."""
        with torch.inference_mode(False), torch.no_grad():
            mirror = self.bind(tables)
            program = self.graphs.get(key)
            if program is None:
                program = self.graphs[key] = self._capture(mirror, io, eager, build, counters)
                while len(self.graphs) > MAX_GRAPHS:
                    self.graphs.popitem(last=False)[1].close()
                    self._drop_buffers()
            self.graphs.move_to_end(key)
            program.launch(_device_loops_preferred(tables))
            return program.outputs

    def _drop_buffers(self) -> None:
        """Drop the buffers no kept program reads or adds into (the camera
        and the frame's ray counter stay)."""
        live = {id(t) for p in self.graphs.values() for t in p.io.values()}
        self.buffers = {k: t for k, t in self.buffers.items()
                        if id(t) in live or k[0] in ("cam", "rays")}

    def _capture(self, mirror, io: dict, eager, build, counters) -> _Program:
        t0 = time.perf_counter()
        device = io["cam"].device
        cuda = device.type == "cuda"
        kept = _snapshot(counters)
        # a capture adds nothing into the sums (a stand-in graph of the CPU
        # tests runs its code once as it records it)
        sums = [(t, t.clone()) for t in (io["sum"], io["rays"])]
        if cuda and self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
            self.stream = torch.cuda.Stream(device)
        on_side = torch.cuda.stream(self.stream) if cuda else contextlib.nullcontext()
        # warm-up on the side stream (torch.cuda.graphs): builds what is built
        # on first use (the lazy tables), outside the capture; it counts nothing
        if cuda:
            self.stream.wait_stream(torch.cuda.current_stream(device))
        with on_side:
            eager(mirror, io)
        if cuda:
            torch.cuda.current_stream(device).wait_stream(self.stream)
            torch.cuda.synchronize(device)
        _restore(counters, kept)
        cap = _Capture(self.pool, counters)
        on_side = torch.cuda.stream(self.stream) if cuda else contextlib.nullcontext()
        with on_side, capturing(cap):
            cap.begin()
            outputs = build(mirror, io, cap)
            cap.end()
        _restore(counters, kept)
        for t, was in sums:
            t.copy_(was)
        program = _Program(cap.nodes, cap.conds, io, outputs, counters)
        if cuda:
            program._instantiate(device)
        STATS["captured"] += 1
        STATS["capture_s"] += time.perf_counter() - t0
        return program

    def pool_bytes(self) -> int:
        """Bytes the allocator holds in the graphs' pool."""
        if self.pool is None:
            return 0
        pool = tuple(self.pool)
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg.get("segment_pool_id", ())) == pool)
