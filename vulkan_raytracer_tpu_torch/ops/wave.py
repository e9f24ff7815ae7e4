"""The wave's own kernels: its primary rays and initial state, the test
and commit of one alpha resample pass, the wave's tail; and the frame's
post-processing.

The JAX package compiles a frame's waves into one ``jit``
(render/renderer.py:52-88), and XLA fuses what surrounds the bounce loop
and the Pallas calls: each wave's camera rays and initial state
(``generate_primary_rays`` render/integrator.py:403-442, ``render_sample``
:936-960), inside each alpha resample ``while_loop`` the any-hit test and
the commit after the traversal (``_alpha_test`` :130-162, ``_closest``'s
body :195-214), after the loop the deferred skybox fetch and the repacked
wave's scatter (:1128-1137) and the wave's sum (renderer.py:79-80, :109);
and a frame's post-processing (``_postprocess`` renderer.py:244-251, the
progressive ``_frame_step`` :259-292).  None is a Pallas kernel.  Here each
is one kernel, hand-written for Hopper (``csrc/wave.cu``):

* :func:`primary_rays` (``primary_rays_kernel``): the wave's whole initial
  state in one launch, from the sample numbers, the pixel lanes and the
  camera as device tensors, so a captured program reads what the renderer
  wrote there before its launch (lane i is pixel ``lanes[i % n]`` at
  sample ``samples[i // n]``);
* :func:`alpha_commit` (``alpha_commit_kernel``): the pass's finish on its
  pending lanes only (the traversal's raw hit, ``raw=True`` of the
  closest-hit wrappers; the finish ``hit_finish_kernel`` runs, shared in
  ``csrc/hit_finish.cuh``), the candidate's alpha test and the commit,
  written over the resample loop's own state; the hit id is read beside
  each lane's pending flag.  Given the loop's control block
  (:func:`loop_block`), the lanes still pending are added into it once a
  block, and the last block leaves their count there and, where the loop's
  entry test armed the block on the card, makes the loop's next test
  (``render/graphs.py``);
* :func:`wave_sum` (``wave_sum_kernel``): the wave's tail, each lane's
  radiance with its deferred sky, a repacked wave's scatter to its slots,
  and the sum over the wave's samples (sample 0 first, one after another)
  into the band's sum, with the wave's rays into the frame's counter, a
  thread a lane, a tile of pixels x samples a block; the per-lane radiance
  only for a caller that reads it: one launch, two on a repacked wave (the
  scatter, then the sum);
* :func:`frame_image` and :func:`frame_progressive` (``frame_post_kernel``):
  the headless frame's scatter to pixel order with its mean, tonemap and
  quantisation, and the progressive frame's accumulation, mean, tonemap,
  quantisation and decimation to the display's cells, one launch each.

Each wrapper launches its kernel for CUDA tensors and counts the launch in
:data:`LAUNCHES`, and runs its plain version (``*_reference``) for CPU
tensors; on the card nothing falls back.  The plain versions are the port's
torch code regrouped, not rewritten: :func:`camera_rays` is the body of
``integrator.generate_primary_rays``, :func:`alpha_test` the integrator's
former ``_alpha_test``, :func:`radiance_reference` its former ``_radiance``
and :func:`postprocess` the renderer's ``_postprocess``, so the CPU render
is bit-equal to the one before them (but for the order of a wave's sum
over its samples, which is now stated); a pass's plain version,
:func:`alpha_pass_reference`, is ``hit_finish_reference`` then
:func:`alpha_commit_reference`.  Tests and tools reach a plain version on
the card by patching this module's wrapper.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _ext, rng, trace
from .math3 import V3
from .shade import _uv_at
from .texture import sample_bilinear, sample_equirect
from .tonemap import reinhard_jodie

_F32 = torch.float32

#: Kernel launches since the last reset, by kernel.  Only a launch adds one.
LAUNCHES = {"primary_rays": 0, "alpha_commit": 0, "wave_sum": 0, "frame_post": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _xyz(name: str) -> tuple:
    return tuple(name + c for c in "XYZ")


#: One pointer per column, in the order of ``enum Slot`` in csrc/wave.cu.
SLOTS = (
    "W_SAMPLES", "W_LANES", "W_CAM",
    *_xyz("S_O"), *_xyz("S_D"), *_xyz("S_VAL"), *_xyz("S_TP"), *_xyz("S_SKY"), "S_WL",
    "S_MATPDF", "S_SEED", "S_ACTIVE", "S_PREVIEW", "S_SLOT",
    "A_TLO", "A_PENDING", "A_T", "A_TRI", "A_U", "A_V", "A_SEED", "A_LOOP",
    "R_OX", "R_OY", "R_OZ", "R_DX", "R_DY", "R_DZ", "R_T", "R_HIT",
    *(f"T_V{k}{c}" for k in range(3) for c in "XYZ"), "T_TRIID", "T_INVFLAT",
    "AL_MODE", "AL_VALUE", "AL_CUTOFF", "T_TRIMAT", "T_UV", "M_TEXIDX", "TEX_TEXELS", "TEX_OFF",
    "TEX_H", "TEX_W",
    "E_R", "E_G", "E_B", "E_STRENGTH", "Q_RAYS", "Q_RAD", "Q_SUM", "Q_FRAME_RAYS", "Q_SCRATCH",
    "F_SRC", "F_LANES", "F_ACCUM", "F_SAMPLE", "F_OUT",
)
#: The counts and flags, in the order of ``enum Int`` in csrc/wave.cu.
INTS = ("I_N", "I_PIXELS", "I_WIDTH", "I_HEIGHT", "I_PIXEL_ORDER", "I_TEXTURES", "I_PROTO_TRIS",
        "I_MODE", "I_NUM_INST", "I_K", "I_SUM_MODE", "I_ENV_H", "I_ENV_W", "I_FRAME_MODE", "I_SPP",
        "I_TONEMAP", "I_UINT8", "I_DISP_H", "I_DISP_W", "I_TILE")
#: :func:`wave_sum`'s launches (``enum SumMode``): a wave in lane order in
#: one; a repacked wave's scatter to its slots, then its sum.
SUM_MODES = ("lanes", "scatter", "add")
#: Threads of a tail's block and samples a chunk of its tile at most
#: (``kThreads``, ``kSumRows`` in csrc/wave.cu; :func:`sum_tile`).
SUM_THREADS = 256
SUM_ROWS = 8
#: Lanes a wave's tail takes fewer of: its kernel indexes the lanes' floats
#: (four a lane in a repacked wave's scratch) in 32 bits.
MAX_SUM_LANES = 1 << 29
#: :func:`frame_image`'s and :func:`frame_progressive`'s modes (``enum
#: FrameMode``).
FRAME_MODES = ("image", "progressive")
#: Pixels a thread of the progressive frame's tail at the frame's size
#: works (``kFrameLanes`` in csrc/wave.cu); the headless tail works a lane a
#: thread, the decimating one a display cell.
FRAME_LANES = 4
#: Pixels a frame's tail takes fewer of: its kernel indexes the frame's
#: floats (three a pixel) in 32 bits.
MAX_FRAME_PIXELS = 1 << 29
#: A resample loop's control block, ``enum LoopWord`` in csrc/wave.cu: four
#: int64, zero when made (:func:`loop_block`).
LOOP_WORDS = ("kLoopWord", "kLoopHandle", "kLoopRow", "kLoopCount")
_SLOT = {name: k for k, name in enumerate(SLOTS)}
_INT = {name: k for k, name in enumerate(INTS)}

#: Bytes :func:`primary_rays` writes a lane: five V3 columns, the
#: wavelength, the material pdf, the seed (int64) and two flags; the slot
#: (int64) on top on the repacked wavefront.
STATE_BYTES = 5 * 12 + 4 + 4 + 8 + 2


class _Launch(_ext.Columns):
    """A wave kernel's launch (:class:`_ext.Columns` over :data:`SLOTS` and
    :data:`INTS`)."""

    def __init__(self, n: int, device):
        super().__init__(_SLOT, _INT, n, device, "wave")

    def run(self, kernel: str) -> None:
        self.launch(f"{kernel}_launch")
        LAUNCHES[kernel] += 1


def _on_cuda(t: torch.Tensor) -> bool:
    """True for CUDA tensors, False for CPU tensors."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the wave kernels run on cpu or cuda tensors, not {t.device}")
    return t.device.type == "cuda"


# ---------------------------------------------------------------------------
# Primary rays and the initial state (raygen.rgen:33-43)
# ---------------------------------------------------------------------------


def camera_tensor(view_inv, proj_inv, device=None) -> torch.Tensor:
    """The camera as the kernel reads it: the float32 (4, 4) inverse view
    and inverse projection, row-major, one after the other in a (32,)
    tensor (made from host data: set-up, not a wave's work)."""
    host = np.concatenate([np.asarray(view_inv, np.float32).ravel(),
                           np.asarray(proj_inv, np.float32).ravel()])
    return torch.as_tensor(host, device=device)


def camera_rays(idx, counts, cam, width: int, height: int):
    """Camera rays (integrator.py:403-442): returns (origin V3, direction
    V3, seed) for the pixels ``idx`` (masked int64, one a lane) at the
    samples ``counts`` (masked int64, broadcast to the lanes) through
    ``cam`` (:func:`camera_tensor`, on the lanes' device).

    Seeds are TEA(pixelIdx, sampleCount); jitter is the pixel centre on
    sample 0, else two rnd draws.  The matrices' entries take part as 0-d
    tensors, which round as the Python floats they hold would."""
    px = (idx % width).to(_F32)
    py = (idx // width).to(_F32)
    seed = rng.tea(idx, counts)
    (jx, jy), seed_j = rng.rnd_square(seed)
    preview = counts == 0
    jx = torch.where(preview, 0.5, jx)
    jy = torch.where(preview, 0.5, jy)
    seed = torch.where(preview, seed, seed_j)

    u = (px + jx) / float(width) * 2.0 - 1.0
    v = -((py + jy) / float(height) * 2.0 - 1.0)
    m = [[cam[4 * r + c] for c in range(4)] for r in range(4)]
    p = [[cam[16 + 4 * r + c] for c in range(4)] for r in range(4)]
    # target = projInverse * (d.x, d.y, 1, 1), xyz only (raygen.rgen:41)
    tgt = V3(
        p[0][0] * u + p[0][1] * v + p[0][2] + p[0][3],
        p[1][0] * u + p[1][1] * v + p[1][2] + p[1][3],
        p[2][0] * u + p[2][1] * v + p[2][2] + p[2][3],
    ).normalized()
    direction = V3(
        m[0][0] * tgt.x + m[0][1] * tgt.y + m[0][2] * tgt.z,
        m[1][0] * tgt.x + m[1][1] * tgt.y + m[1][2] * tgt.z,
        m[2][0] * tgt.x + m[2][1] * tgt.y + m[2][2] * tgt.z,
    ).normalized()
    n = idx.shape[0]
    origin = V3(*(m[r][3].expand(n).contiguous() for r in range(3)))
    return origin, direction, seed


def primary_rays_reference(samples, lanes, cam, width: int, height: int, repack: bool,
                           pixel_order: bool = False) -> dict:
    """The wave's initial state (integrator.py:936-960): lane i is pixel
    ``lanes[i % n]`` at sample ``samples[i // n]``, samples-major.  Its
    camera ray and seed (:func:`camera_rays`), a zero value and sky weight,
    unit throughput and material pdf, no wavelength, every lane active, the
    preview flag of sample 0 and, on the repacked wavefront, ``slot``: the
    lane's output position, its pixel with ``pixel_order`` (one sample of a
    whole frame: the radiance comes back in pixel order) and else its
    index."""
    n, k = lanes.shape[0], samples.shape[0]
    dev = lanes.device
    idx = rng.as_u32(lanes.repeat(k))
    counts = rng.as_u32(samples[:, None].expand(k, n).reshape(-1))
    origin, direction, seed = camera_rays(idx, counts, cam, width, height)
    total = n * k
    s = dict(
        origin=origin,
        direction=direction,
        value=V3.full((0.0, 0.0, 0.0), total, dev),
        throughput=V3.full((1.0, 1.0, 1.0), total, dev),
        seed=seed,
        wavelength=torch.zeros(total, dtype=_F32, device=dev),
        mat_pdf=torch.ones(total, dtype=_F32, device=dev),
        active=torch.ones(total, dtype=torch.bool, device=dev),
        sky_w=V3.full((0.0, 0.0, 0.0), total, dev),
        preview=(counts == 0).contiguous(),  # a column: the shading kernels read it
    )
    if repack:
        s["slot"] = lanes.long() if pixel_order else torch.arange(total, device=dev)
    return s


def primary_rays(samples, lanes, cam, width: int, height: int, repack: bool,
                 pixel_order: bool = False) -> dict:
    """The wave's initial state; see :func:`primary_rays_reference`.
    ``samples`` and ``lanes`` are int64, ``cam`` the (32,) float32 of
    :func:`camera_tensor`, all on one device."""
    if pixel_order and samples.shape[0] != 1:
        raise ValueError("pixel order takes one sample a wave")
    if not _on_cuda(lanes):
        return primary_rays_reference(samples, lanes, cam, width, height, repack, pixel_order)
    n, k = lanes.shape[0], samples.shape[0]
    dev = lanes.device
    launch = _Launch(n * k, dev)
    launch.put("W_SAMPLES", samples, torch.int64, (k,))
    launch.put("W_LANES", lanes, torch.int64, (n,))
    launch.put("W_CAM", cam, _F32, (32,))
    launch.count("I_PIXELS", n)
    launch.count("I_WIDTH", width)
    launch.count("I_HEIGHT", height)
    launch.count("I_PIXEL_ORDER", pixel_order)
    rows = torch.empty((17, n * k), dtype=_F32, device=dev).unbind(0)
    flags = torch.empty((2, n * k), dtype=torch.bool, device=dev).unbind(0)
    s = dict(origin=V3(*rows[0:3]), direction=V3(*rows[3:6]), value=V3(*rows[6:9]),
             throughput=V3(*rows[9:12]), seed=torch.empty(n * k, dtype=torch.int64, device=dev),
             wavelength=rows[12], mat_pdf=rows[13], active=flags[0], sky_w=V3(*rows[14:17]),
             preview=flags[1])
    for name, f in (("S_O", "origin"), ("S_D", "direction"), ("S_VAL", "value"),
                    ("S_TP", "throughput"), ("S_SKY", "sky_w")):
        launch.lane3(name, s[f])
    launch.lane("S_WL", s["wavelength"])
    launch.lane("S_MATPDF", s["mat_pdf"])
    launch.lane("S_SEED", s["seed"], torch.int64)
    launch.lane("S_ACTIVE", s["active"], torch.bool)
    launch.lane("S_PREVIEW", s["preview"], torch.bool)
    if repack:
        s["slot"] = torch.empty(n * k, dtype=torch.int64, device=dev)
        launch.lane("S_SLOT", s["slot"], torch.int64)
    launch.run("primary_rays")
    return s


def primary_rays_bytes(n: int, k: int, repack: bool) -> int:
    """The bytes :func:`primary_rays` must move for ``n`` pixels x ``k``
    samples: the lanes, the samples and the camera read once, the state
    written once.  Its bytes bound's numerator."""
    return 8 * n + 8 * k + 4 * 32 + n * k * (STATE_BYTES + 8 * repack)


# ---------------------------------------------------------------------------
# The alpha resample pass (hit.rahit; integrator.py:130-162, 195-214)
# ---------------------------------------------------------------------------


def alpha_test(tables, tri, u, v, seed, cand):
    """Any-hit alpha decision for one candidate per lane (hit.rahit:26-53;
    integrator.py:130-162).

    alpha = baseColourFactor.a x baseColourTexture.a at the candidate's
    barycentrics; MASK ignores a candidate below its cutoff, BLEND ignores
    it with probability 1 - alpha, drawing one rnd per BLEND candidate (the
    seed advances on those lanes only).  Returns (keep, seed).
    """
    ti = torch.clamp_min(tri, 0)
    if tables.inst is not None:  # encoded id -> prototype triangle
        ti, _ = tables.inst.decode(ti)
    mode = torch.index_select(tables.alpha.mode, 0, ti)
    alpha = torch.index_select(tables.alpha.value, 0, ti)
    acut = torch.index_select(tables.alpha.cutoff, 0, ti)
    if tables.has_textures:
        mat_i = torch.index_select(tables.tri_mat, 0, ti)
        tex_b = torch.index_select(tables.materials.tex_idx[:, 0], 0, mat_i)
        uv = _uv_at(torch.index_select(tables.uv, 0, ti), 1.0 - u - v, u, v)
        texel = sample_bilinear(tables.tex, tex_b, uv)
        alpha = torch.where(tex_b >= 0, alpha * texel[:, 3], alpha)
    is_blend = cand & (mode == 2)
    u_rnd, seed_adv = rng.rnd(seed)
    seed = torch.where(is_blend, seed_adv, seed)
    ignore = (cand & (mode == 1) & (alpha < acut)) | (is_blend & (u_rnd < 1.0 - alpha))
    return cand & ~ignore, seed


def alpha_commit_reference(tables, st: dict, t_c, tri_c, u_c, v_c) -> dict:
    """The loop's next state after one pass whose traversal found the
    candidates (``t_c``, ``tri_c``, ``u_c``, ``v_c``) above each pending
    lane's ``t_lo`` (integrator.py:195-214): :func:`alpha_test` on the
    lanes with a candidate; an accepted hit commits; a rejected candidate
    moves the lane's lower bound strictly past it (ignoreIntersectionEXT)
    and keeps the lane pending."""
    pending = st["pending"]
    found = pending & (tri_c >= 0)
    keep, seed_t = alpha_test(tables, tri_c, u_c, v_c, st["seed"], found)
    t_safe = torch.where(torch.isfinite(t_c), t_c, 0.0)
    rejected = found & ~keep
    return dict(
        t_lo=torch.where(rejected, t_safe * (1.0 + 4e-7) + 1e-30, st["t_lo"]),
        pending=rejected,
        t=torch.where(keep, t_c, st["t"]),
        tri=torch.where(keep, tri_c, st["tri"]),
        u=torch.where(keep, u_c, st["u"]),
        v=torch.where(keep, v_c, st["v"]),
        seed=torch.where(pending, seed_t, st["seed"]),
    )


def loop_block(device) -> torch.Tensor:
    """A resample loop's control block (:data:`LOOP_WORDS`), zero: the
    count's accumulator and block ticket, the loop's handle and row where
    its entry test armed it on the card, and the count the last pass left
    pending (``count(block)``)."""
    return torch.zeros(len(LOOP_WORDS), dtype=torch.int64, device=device)


def alpha_pass_reference(tables, st: dict, raw) -> dict:
    """The loop's next state after one pass whose traversal gave ``raw``,
    ``(rays, t, hit, mode)`` (:func:`.trace.hit_finish`'s arguments): the
    closest hit's finish (:func:`.trace.hit_finish_reference`), then
    :func:`alpha_commit_reference`."""
    return alpha_commit_reference(tables, st, *trace.hit_finish_reference(tables, *raw))


def alpha_commit(tables, st: dict, raw, loop=None) -> None:
    """One pass's finish, test and commit (:func:`alpha_pass_reference`)
    written over the loop's state ``st`` (contiguous buffers of the loop's
    own: the lower bound ``t_lo`` of the next candidate, the lanes still
    ``pending``, the accepted ``t``, ``tri``, ``u``, ``v`` and the ``seed``),
    from the traversal's unfinished result ``raw`` (``raw=True`` of the
    closest-hit wrappers).  On a card one launch finishes only the pending
    lanes' candidates; where ``loop`` (:func:`loop_block`) is given it also
    adds the lanes still pending into it, leaves their count there and,
    where the loop's entry test armed it, makes the loop's next test."""
    rays, t, hit, mode = raw
    if not _on_cuda(hit):
        nxt = alpha_pass_reference(tables, st, raw)
        for k, v in st.items():
            v.copy_(nxt[k])
        if loop is not None:
            loop_count(loop).copy_(st["pending"].sum())
        return
    launch = _Launch(hit.shape[0], hit.device)
    for name, f, dtype in (("A_TLO", "t_lo", _F32), ("A_PENDING", "pending", torch.bool),
                           ("A_T", "t", _F32), ("A_TRI", "tri", torch.int32), ("A_U", "u", _F32),
                           ("A_V", "v", _F32), ("A_SEED", "seed", torch.int64)):
        launch.lane(name, st[f], dtype)
    for name, c in zip(("R_OX", "R_OY", "R_OZ", "R_DX", "R_DY", "R_DZ"), rays):
        launch.lane(name, c)
    launch.lane("R_T", t)
    launch.lane("R_HIT", hit, torch.int32)
    for k, v in enumerate((tables.v0, tables.v1, tables.v2)):
        for c, x in zip("XYZ", v):
            launch.put(f"T_V{k}{c}", x, _F32)
    launch.count("I_MODE", trace.FINISH_MODES.index(mode))
    if mode == "bvh":
        launch.put("T_TRIID", tables.pbvh.tri_id, torch.int32)
    elif mode == "instanced":
        launch.put("T_INVFLAT", tables.inst.inv_flat, _F32)
        launch.count("I_NUM_INST", tables.inst.num_instances)
    if loop is not None:
        launch.put("A_LOOP", loop, torch.int64, (len(LOOP_WORDS),))
    a = tables.alpha
    for name, tab, dtype in (("AL_MODE", a.mode, torch.int32), ("AL_VALUE", a.value, _F32),
                             ("AL_CUTOFF", a.cutoff, _F32),
                             ("T_TRIMAT", tables.tri_mat, torch.int32),
                             ("T_UV", tables.uv, _F32),
                             ("M_TEXIDX", tables.materials.tex_idx, torch.int32),
                             ("TEX_TEXELS", tables.tex.texels, torch.int32),
                             ("TEX_OFF", tables.tex.off, torch.int32),
                             ("TEX_H", tables.tex.h, torch.int32),
                             ("TEX_W", tables.tex.w, torch.int32)):
        launch.put(name, tab, dtype, None)
    launch.count("I_TEXTURES", tables.has_textures)
    if tables.inst is not None:
        launch.count("I_PROTO_TRIS", tables.inst.num_proto_tris)
    launch.run("alpha_commit")


def loop_count(loop) -> torch.Tensor:
    """The lanes the last pass that ``loop`` (:func:`loop_block`) was given
    to left pending, a 0-d int64 view."""
    return loop[LOOP_WORDS.index("kLoopCount")]


def alpha_commit_bytes(st: dict, hit, nxt: dict, blend, rows: int = 0) -> int:
    """The bytes one pass's :func:`alpha_commit` must move, the alpha
    tables' gathers aside, from the state ``st`` before it, the traversal's
    hit ids ``hit``, the state ``nxt`` after it and the BLEND candidates
    ``blend``: every lane's pending flag; on a pending lane its hit id and
    the flag written back unless it stays pending; on a pending lane with a
    hit its t and its ray (the finish's), and ``rows``, the finish's table
    rows (:func:`.trace.finish_table_bytes`); a BLEND candidate's seed read
    and written; an accepted hit's four columns, a rejected one's lower
    bound."""
    pending = st["pending"]
    found = pending & (hit >= 0)
    rejected = nxt["pending"]
    keep = found & ~rejected
    return (pending.numel() + 4 * int(pending.sum()) + int((pending & ~rejected).sum())
            + 28 * int(found.sum()) + 16 * int(blend.sum()) + 16 * int(keep.sum())
            + 4 * int(rejected.sum()) + rows)


# ---------------------------------------------------------------------------
# The wave's tail: the deferred sky and the sum (integrator.py:1128-1137,
# renderer.py:79-80, :109)
# ---------------------------------------------------------------------------


def radiance_reference(tables, s: dict):
    """(N, 3) radiance of the wave state ``s`` after its last bounce: the
    value gathered plus the deferred skybox, one equirect fetch for the
    whole loop (:func:`.texture.sample_equirect` times the strength, by the
    lane's sky weight)."""
    sky = sample_equirect(tables.skybox, s["direction"].to_array()) * tables.skybox_strength
    return (s["value"] + s["sky_w"] * V3.from_array(sky)).to_array()


def wave_sum_reference(tables, s: dict, repack: bool, total, frame_rays, rays, k: int,
                       radiance: bool):
    """The wave's tail: each lane's radiance (:func:`radiance_reference`),
    on a repacked wave scattered to its ``slot``, then summed over the
    wave's ``k`` samples (samples-major lanes), sample 0 first and one
    sample after another, and added into ``total`` ((n, 3), the band's
    sum; None: no sum, for a caller that reads only the radiance), and the
    wave's ``rays`` added into ``frame_rays``.  Returns the
    radiance (n * k, 3) in the lanes' own order where ``radiance``, else
    None (the sums are the same either way)."""
    value = radiance_reference(tables, s)
    if repack:
        value = torch.empty_like(value).index_copy_(0, s["slot"], value)
    if total is not None:
        per = value.reshape(k, -1, 3)
        acc = per[0]
        for j in range(1, k):
            acc = acc + per[j]
        total.add_(acc)
    frame_rays.add_(rays)
    return value if radiance else None


def sum_tile(k: int) -> int:
    """Pixels of a tile of :func:`wave_sum`'s kernel for waves of ``k``
    samples: :data:`SUM_THREADS` over the samples of a chunk (``k`` rounded
    up to a power of two, at most :data:`SUM_ROWS`), so a block is a thread
    a lane of its chunk."""
    rows = 1
    while rows < min(k, SUM_ROWS):
        rows *= 2
    return SUM_THREADS // rows


def wave_sum(tables, s: dict, repack: bool, total, frame_rays, rays, k: int,
             radiance: bool):
    """The wave's tail; see :func:`wave_sum_reference`.  On a card one
    launch on a wave in lane order, two on a repacked one (the scatter to
    the slots into a padded scratch, then the sum; one cooperative launch
    with a grid-wide barrier between them measured slower); ``total`` and
    ``frame_rays`` are added into in place, and the radiance, where asked
    for, is a new tensor (in a program, the program's own)."""
    if not _on_cuda(s["active"]):
        return wave_sum_reference(tables, s, repack, total, frame_rays, rays, k, radiance)
    lanes = s["active"].shape[0]
    if lanes >= MAX_SUM_LANES:
        raise ValueError(f"the wave's tail indexes its {lanes} lanes' floats in 32 bits: "
                         f"at most {MAX_SUM_LANES - 1} lanes")
    n = lanes // k
    dev = s["active"].device
    out = torch.empty((lanes, 3), dtype=_F32, device=dev) if radiance else None
    launch = _Launch(lanes, dev)
    for name, f in (("S_D", "direction"), ("S_VAL", "value"), ("S_SKY", "sky_w")):
        launch.lane3(name, s[f])
    env = tables.skybox
    for name, c in zip(("E_R", "E_G", "E_B"), (env.r, env.g, env.b)):
        launch.put(name, c, _F32, (env.h * env.w,))
    launch.put("E_STRENGTH", tables.skybox_strength, _F32, ())
    launch.put("Q_RAYS", rays, torch.int64, ())
    if out is not None:
        launch.put("Q_RAD", out, _F32, (lanes, 3))
    if total is not None:
        launch.put("Q_SUM", total, _F32, (n, 3))
    launch.put("Q_FRAME_RAYS", frame_rays, torch.int64, ())
    tile = sum_tile(k)
    launch.count("I_PIXELS", n)
    launch.count("I_K", k)
    launch.count("I_TILE", tile)
    launch.count("I_ENV_H", env.h)
    launch.count("I_ENV_W", env.w)
    if repack:
        scratch = torch.empty((lanes, 4), dtype=_F32, device=dev)
        launch.put("Q_SCRATCH", scratch, _F32, (lanes, 4))
        launch.lane("S_SLOT", s["slot"], torch.int64)
        launch.count("I_SUM_MODE", SUM_MODES.index("scatter"))
        launch.run("wave_sum")
    launch.count("I_SUM_MODE", SUM_MODES.index("add" if repack else "lanes"))
    launch.count("I_N", -(-n // tile) * SUM_THREADS)
    launch.run("wave_sum")
    return out


def wave_sum_bytes(n: int, k: int, repack: bool, sky_texels: int, radiance: bool) -> int:
    """The bytes the wave's tail must move for ``n`` pixels x ``k``
    samples over a sky map of ``sky_texels`` texels, whatever the design: a
    lane's direction, value and sky weight read, its radiance written where
    ``radiance``, on a repacked wave its slot read; the map read once; the
    band's sum read and written; the strength and the two ray counters.
    Its bytes bound's numerator; the scratch a repacked wave's kernel
    writes and reads back is the design's, not the function's
    (:func:`wave_sum_scratch_bytes`)."""
    per_lane = 36 + 12 * radiance + 8 * repack
    return n * k * per_lane + 24 * n + 12 * sky_texels + 4 + 3 * 8


def wave_sum_scratch_bytes(lanes: int, repack: bool) -> int:
    """The bytes :func:`wave_sum` moves beyond :func:`wave_sum_bytes` over
    ``lanes`` lanes: on a repacked wave each lane's padded 16-byte row of
    the scratch, written by the scatter and read back by the sum."""
    return 2 * 16 * lanes * repack


# ---------------------------------------------------------------------------
# The frame's post-processing (renderer.py:244-251, :259-292)
# ---------------------------------------------------------------------------


def postprocess(acc, spp, tonemap: bool, as_uint8: bool):
    """The frame's image from its linear sum over ``spp`` samples
    (renderer.py:244-251): the mean, Reinhard-Jodie where ``tonemap``, and
    uint8 (clamped to [0, 1], x 255 + 0.5, truncated) where ``as_uint8``."""
    img = acc / float(spp)
    if tonemap:
        img = reinhard_jodie(img)
    if as_uint8:
        img = (torch.clamp(img, 0.0, 1.0) * 255.0 + 0.5).to(torch.uint8)
    return img


def frame_image_reference(acc, lanes, spp: int, tonemap: bool, as_uint8: bool):
    """A headless frame's image (n, 3) in pixel order from its sum ``acc``
    (n, 3) aligned with ``lanes``, a permutation of the frame's pixels:
    scattered to pixel order, then :func:`postprocess`."""
    img = torch.zeros_like(acc)
    img[lanes] = acc
    return postprocess(img, spp, tonemap, as_uint8)


def _frame_pixels(n: int) -> None:
    if n >= MAX_FRAME_PIXELS:
        raise ValueError(f"the frame's tail indexes its {n} pixels' floats in 32 bits: at most "
                         f"{MAX_FRAME_PIXELS - 1} pixels")


def _into(out, img):
    """``img``, or ``img`` copied into ``out`` where given."""
    return img if out is None else out.copy_(img)


def frame_image(acc, lanes, spp: int, tonemap: bool, as_uint8: bool, out=None):
    """A headless frame's image; see :func:`frame_image_reference`.  On a
    card one launch, a thread a lane.  ``out``: the
    (n, 3) uint8 or float32 tensor it writes (else a new one)."""
    if not _on_cuda(acc):
        return _into(out, frame_image_reference(acc, lanes, spp, tonemap, as_uint8))
    n = acc.shape[0]
    _frame_pixels(n)
    dtype = torch.uint8 if as_uint8 else _F32
    if out is None:
        out = torch.empty((n, 3), dtype=dtype, device=acc.device)
    launch = _Launch(n, acc.device)
    launch.put("F_SRC", acc, _F32, (n, 3))
    launch.lane("F_LANES", lanes, torch.int64)
    launch.put("F_OUT", out, dtype, (n, 3))
    launch.count("I_FRAME_MODE", FRAME_MODES.index("image"))
    launch.count("I_PIXELS", n)
    launch.count("I_SPP", spp)
    launch.count("I_TONEMAP", tonemap)
    launch.count("I_UINT8", as_uint8)
    launch.count("I_N", n)
    launch.run("frame_post")
    return out


def frame_progressive_reference(radiance, accum, sample, width: int, height: int,
                                disp_h: int, disp_w: int):
    """A progressive frame's tail (renderer.py:259-292) after its sample
    ``sample``'s ``radiance`` (n, 3) in pixel order: the preview sample 0
    zeroes the accumulation ``accum`` and is shown itself, a later sample
    is added into ``accum`` in place and its mean shown; tonemapped,
    quantised, and mean-pooled (integer) to (disp_h, disp_w) cells of
    height // disp_h x width // disp_w pixels.  ``sample`` is an int, or
    the (1,) int64 tensor a program reads it from (the same ops on its
    value, nothing read on the host).  Returns the uint8 (disp_h, disp_w,
    3) image."""
    if isinstance(sample, torch.Tensor):
        count = sample.reshape(())
        preview = count == 0
        accum.copy_(torch.where(preview, torch.zeros_like(accum), accum + radiance))
        shown = torch.where(preview, radiance, accum / count)
    elif sample == 0:
        accum.zero_()
        shown = radiance
    else:
        accum.add_(radiance)
        shown = accum / float(sample)
    img8 = postprocess(shown, 1, True, True).reshape(height, width, 3)
    if (disp_h, disp_w) != (height, width):
        # decimate to the display's cell grid on the device, so that only
        # disp_h * disp_w cells are fetched (the present blit)
        fy, fx = height // disp_h, width // disp_w
        cells = img8[:disp_h * fy, :disp_w * fx].reshape(disp_h, fy, disp_w, fx, 3)
        img8 = (cells.to(torch.int32).sum(dim=(1, 3)) // (fy * fx)).to(torch.uint8)
    return img8


def frame_progressive(radiance, accum, sample, width: int, height: int, disp_h: int,
                      disp_w: int, out=None):
    """A progressive frame's tail; see :func:`frame_progressive_reference`.
    ``sample`` is the sample's number: an int on the CPU, on a card the (1,)
    int64 tensor the sample's wave read it from, which the one launch reads
    there (a thread :data:`FRAME_LANES` pixels at the frame's own size, a
    display cell where it decimates).  ``out``: the (disp_h, disp_w, 3)
    uint8 tensor it writes (else a new one)."""
    if not _on_cuda(radiance):
        return _into(out, frame_progressive_reference(radiance, accum, sample, width, height,
                                                      disp_h, disp_w))
    n = width * height
    _frame_pixels(n)
    dev = radiance.device
    if out is None:
        out = torch.empty((disp_h, disp_w, 3), dtype=torch.uint8, device=dev)
    cols = disp_w * (width // disp_w)
    rows = disp_h * (height // disp_h)
    launch = _Launch(n, dev)
    launch.put("F_SRC", radiance, _F32, (n, 3))
    launch.put("F_ACCUM", accum, _F32, (n, 3))
    launch.put("F_SAMPLE", sample, torch.int64, (1,))
    launch.put("F_OUT", out, torch.uint8, (disp_h, disp_w, 3))
    launch.count("I_FRAME_MODE", FRAME_MODES.index("progressive"))
    launch.count("I_PIXELS", n)
    launch.count("I_TONEMAP", True)
    launch.count("I_WIDTH", width)
    launch.count("I_HEIGHT", height)
    launch.count("I_DISP_H", disp_h)
    launch.count("I_DISP_W", disp_w)
    if (disp_h, disp_w) == (height, width):
        launch.count("I_N", -(-n // FRAME_LANES))
    else:  # a thread a display cell, then one a pixel no cell shows
        launch.count("I_N", disp_h * disp_w + n - rows * cols)
    launch.run("frame_post")
    return out


def empty_launch(blocks: int, device) -> None:
    """Launch ``empty_kernel`` (csrc/wave.cu), which does nothing, on
    ``blocks`` blocks of :data:`SUM_THREADS` threads: the floor one launch
    sets under a kernel's time.  On no path, counted nowhere."""
    _ext.launch("empty_launch", device, blocks)


def frame_post_bytes(n: int, out_bytes: int, progressive: bool) -> int:
    """The bytes :func:`frame_image` (``progressive`` False: the sum and the
    lanes' pixels read) or :func:`frame_progressive` after a sample past the
    preview (the radiance and the accumulation read, the accumulation
    written, the sample number) must move over ``n`` pixels, with
    ``out_bytes`` of image written.  Its bytes bound's numerator."""
    if progressive:
        return n * 36 + 8 + out_bytes
    return n * (12 + 8) + out_bytes
