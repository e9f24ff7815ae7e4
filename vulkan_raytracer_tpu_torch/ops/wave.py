"""The wave's own kernels: its primary rays and initial state, and the test
and commit of one alpha resample pass.

The JAX package compiles a frame's waves into one ``jit``
(render/renderer.py:52-88), and XLA fuses what surrounds the bounce loop
and the Pallas calls: each wave's camera rays and initial state
(``generate_primary_rays`` render/integrator.py:403-442, ``render_sample``
:936-960) and, inside each alpha resample ``while_loop``, the any-hit test
and the commit after the traversal (``_alpha_test`` :130-162, ``_closest``'s
body :195-214).  Neither is a Pallas kernel.  Here each is one kernel,
hand-written for Hopper (``csrc/wave.cu``), one thread a lane:

* :func:`primary_rays` (``primary_rays_kernel``): the wave's whole initial
  state in one launch, from the sample numbers, the pixel lanes and the
  camera as device tensors, so a captured program reads what the renderer
  wrote there before its launch (lane i is pixel ``lanes[i % n]`` at
  sample ``samples[i // n]``);
* :func:`alpha_commit` (``alpha_commit_kernel``): the candidate's alpha
  test and the commit, written over the resample loop's own state, with
  the lanes still pending added into the loop's count.

Each wrapper launches its kernel for CUDA tensors and counts the launch in
:data:`LAUNCHES`, and runs its plain version (``*_reference``) for CPU
tensors; on the card nothing falls back.  The plain versions are the port's
torch code regrouped, not rewritten: :func:`camera_rays` is the body of
``integrator.generate_primary_rays``, :func:`alpha_test` the integrator's
former ``_alpha_test``, so the CPU render is bit-equal to the one before
them.  Tests and tools reach a plain version on the card by patching this
module's wrapper.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _ext, rng
from .math3 import V3
from .shade import _uv_at
from .texture import sample_bilinear

_F32 = torch.float32

#: Kernel launches since the last reset, by kernel.  Only a launch adds one.
LAUNCHES = {"primary_rays": 0, "alpha_commit": 0}


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
    "A_TLO", "A_PENDING", "A_T", "A_TRI", "A_U", "A_V", "A_SEED", "A_COUNT",
    "C_T", "C_TRI", "C_U", "C_V",
    "AL_MODE", "AL_VALUE", "AL_CUTOFF", "T_TRIMAT", "T_UV", "M_TEXIDX", "TEX_TEXELS", "TEX_OFF",
    "TEX_H", "TEX_W",
)
#: The counts and flags, in the order of ``enum Int`` in csrc/wave.cu.
INTS = ("I_N", "I_PIXELS", "I_WIDTH", "I_HEIGHT", "I_PIXEL_ORDER", "I_TEXTURES", "I_PROTO_TRIS")
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


def alpha_commit(tables, st: dict, t_c, tri_c, u_c, v_c, count=None) -> None:
    """One pass's test and commit (:func:`alpha_commit_reference`) written
    over the loop's state ``st`` (contiguous buffers of the loop's own: the
    lower bound ``t_lo`` of the next candidate, the lanes still ``pending``,
    the accepted ``t``, ``tri``, ``u``, ``v`` and the ``seed``) and, where
    ``count`` (a 0-d int64) is given, the lanes still pending into it, which
    the loop's condition reads."""
    if not _on_cuda(tri_c):
        nxt = alpha_commit_reference(tables, st, t_c, tri_c, u_c, v_c)
        for k, v in st.items():
            v.copy_(nxt[k])
        if count is not None:
            count.copy_(st["pending"].sum())
        return
    launch = _Launch(tri_c.shape[0], tri_c.device)
    for name, f, dtype in (("A_TLO", "t_lo", _F32), ("A_PENDING", "pending", torch.bool),
                           ("A_T", "t", _F32), ("A_TRI", "tri", torch.int32), ("A_U", "u", _F32),
                           ("A_V", "v", _F32), ("A_SEED", "seed", torch.int64)):
        launch.lane(name, st[f], dtype)
    for name, c, dtype in (("C_T", t_c, _F32), ("C_TRI", tri_c, torch.int32), ("C_U", u_c, _F32),
                           ("C_V", v_c, _F32)):
        launch.lane(name, c.contiguous(), dtype)
    if count is None:  # the eager loop reads the pending flags instead
        count = torch.empty((), dtype=torch.int64, device=launch.device)
    count.zero_()
    launch.put("A_COUNT", count, torch.int64, ())
    a = tables.alpha
    for name, t, dtype in (("AL_MODE", a.mode, torch.int32), ("AL_VALUE", a.value, _F32),
                           ("AL_CUTOFF", a.cutoff, _F32), ("T_TRIMAT", tables.tri_mat, torch.int32),
                           ("T_UV", tables.uv, _F32),
                           ("M_TEXIDX", tables.materials.tex_idx, torch.int32),
                           ("TEX_TEXELS", tables.tex.texels, torch.int32),
                           ("TEX_OFF", tables.tex.off, torch.int32),
                           ("TEX_H", tables.tex.h, torch.int32),
                           ("TEX_W", tables.tex.w, torch.int32)):
        launch.put(name, t, dtype, None)
    launch.count("I_TEXTURES", tables.has_textures)
    if tables.inst is not None:
        launch.count("I_PROTO_TRIS", tables.inst.num_proto_tris)
    launch.run("alpha_commit")


def alpha_commit_bytes(st: dict, tri_c, nxt: dict, blend) -> int:
    """The bytes one pass's :func:`alpha_commit` must move, the scene
    tables' gathers aside, from the state ``st`` before it, the candidates'
    ids ``tri_c``, the state ``nxt`` after it and the BLEND candidates
    ``blend``: every lane's pending flag; on a pending lane its candidate's
    id and the flag written back unless it stays pending; on a lane with a
    candidate its t, u and v; a BLEND candidate's seed read and written; an
    accepted hit's four columns, a rejected one's lower bound."""
    pending = st["pending"]
    found = pending & (tri_c >= 0)
    rejected = nxt["pending"]
    keep = found & ~rejected
    return (pending.numel() + 4 * int(pending.sum()) + int((pending & ~rejected).sum())
            + 12 * int(found.sum()) + 16 * int(blend.sum()) + 16 * int(keep.sum())
            + 4 * int(rejected.sum()))
