"""The plain reference: a path tracer in PyTorch that works from the
benchmark's own scene arrays.

Written on the pattern of the JAX package's NumPy oracle (the reference
renderer's GLSL transcribed: shaders/raygen.rgen, hit.rchit, bsdf.glsl,
lightsample.glsl, random.glsl), for the materials the benchmark's scenes
hold: opaque, untextured, isotropic or anisotropic GGX over a Lambert
lobe, emissive triangles with NEE and MIS, an equirect sky on a miss.  It
imports nothing of the program: it flattens the meshes, derives the
emissive CDF, the pdf-probe tables and the sky lookup, and finds hits by
brute force over clusters of triangles, each cluster's box tested first.

Every sample of every pixel is independent (its seed is TEA(pixel,
sample)), so :func:`render` renders any set of (pixel, sample) lanes.
``dtype`` is the precision of every float: float32 is the reference;
bfloat16 is the control, the nearest precision below the configuration's.
"""

from __future__ import annotations

import math

import numpy as np
import torch

M32 = 0xFFFFFFFF
PI = math.pi
TWOPI = 2.0 * math.pi
BIAS = 1e-3
EPS = 1e-7
INF = 1e32
LUMA = np.array([0.2126, 0.7152, 0.0722], np.float32)
#: triangles a cluster holds; a scene of at most this many is one sweep
CLUSTER = 128
#: (lane, cluster, axis) box tests made at once
BOXES = 1 << 24
#: (lane, cluster) pairs whose triangles are tested at once, a slot at a time
PAIRS = 1 << 22


# ---------------------------------------------------------------------------
# RNG (shaders/random.glsl): uint32 values carried in int64, masked
# ---------------------------------------------------------------------------


def tea(v0, v1):
    v0 = v0 & M32
    v1 = v1 & M32
    s = 0
    for _ in range(16):
        s = (s + 0x9E3779B9) & M32
        v0 = (v0 + ((((v1 << 4) + 0xA341316C) ^ (v1 + s) ^ ((v1 >> 5) + 0xC8013EA4)) & M32)) & M32
        v1 = (v1 + ((((v0 << 4) + 0xAD90777D) ^ (v0 + s) ^ ((v0 >> 5) + 0x7E95761E)) & M32)) & M32
    return v0


def rnd(seed, dtype):
    seed = (seed * 1664525 + 1013904223) & M32
    return (seed & 0x00FFFFFF).to(dtype) * (1.0 / (1 << 24)), seed


# ---------------------------------------------------------------------------
# vectors: (n, 3) tensors
# ---------------------------------------------------------------------------


def dot(a, b):
    return (a * b).sum(-1)


def normalize(a):
    return a / torch.clamp_min(torch.linalg.vector_norm(a, dim=-1, keepdim=True), 1e-20)


def cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def reflect(i, n):
    return i - 2.0 * dot(n, i)[..., None] * n


def branchless_onb(n):
    sgn = torch.where(n[..., 2] >= 0.0, 1.0, -1.0).to(n.dtype)
    a = -1.0 / (sgn + n[..., 2])
    b = n[..., 0] * n[..., 1] * a
    t = torch.stack([1.0 + sgn * n[..., 0] ** 2 * a, sgn * b, -sgn * n[..., 0]], -1)
    bt = torch.stack([b, sgn + n[..., 1] ** 2 * a, -n[..., 1]], -1)
    return t, bt


# ---------------------------------------------------------------------------
# the scene
# ---------------------------------------------------------------------------


def _inv_transpose3(m4):
    return np.linalg.inv(m4[:3, :3]).T.astype(np.float32)


class RefScene:
    """World-space triangles, materials, emissive tables and sky of a
    :class:`benchmark.scenedata.SceneData` on ``device`` in ``dtype``."""

    def __init__(self, data, device, dtype=torch.float32):
        v0s, v1s, v2s, ns, cols, mats, mat_ids = [], [], [], [], [], [], {}
        em_h, em_ids = [], []
        base = 0
        for mesh in data.meshes:
            m = mesh.material
            self._check(m)
            world = np.eye(4, dtype=np.float32) if mesh.transform is None else mesh.transform
            idx = mesh.indices.reshape(-1, 3)
            pos = mesh.positions @ world[:3, :3].T + world[:3, 3]
            nrm = mesh.normals @ _inv_transpose3(world).T
            tv0, tv1, tv2 = (pos[idx[:, k]].astype(np.float32) for k in range(3))
            v0s.append(tv0)
            v1s.append(tv1)
            v2s.append(tv2)
            ns.append(np.stack([nrm[idx[:, k]] for k in range(3)], 1).astype(np.float32))
            if id(m) not in mat_ids:
                mat_ids[id(m)] = len(mats)
                mats.append(m)
            n_tri = idx.shape[0]
            cols.append(np.full(n_tri, mat_ids[id(m)], np.int64))
            if np.any(np.asarray(m.emissive_factor) != 0):
                area = 0.5 * np.linalg.norm(np.cross(tv1 - tv0, tv2 - tv0), axis=-1)
                em_h.append((area * float(np.asarray(m.emissive_factor, np.float32) @ LUMA))
                            .astype(np.float32))
                em_ids.append(np.arange(base, base + n_tri))
            base += n_tri
        v0, v1, v2 = (np.concatenate(a) for a in (v0s, v1s, v2s))
        tri_n = np.concatenate(ns)
        tri_mat = np.concatenate(cols)
        self.device, self.dtype = torch.device(device), dtype
        t = self._t
        self.n_tris = v0.shape[0]
        self.v0, self.v1, self.v2 = t(v0), t(v1), t(v2)
        self.e1, self.e2 = t(v1 - v0), t(v2 - v0)
        self.tri_n = t(tri_n)
        self.tri_mat = torch.as_tensor(tri_mat, device=self.device)
        self.base = t(np.stack([m.base_colour_factor[:3] for m in mats]))
        self.emissive = t(np.stack([m.emissive_factor for m in mats]))
        self.metallic = t(np.array([m.metallic_factor for m in mats]))
        self.rough = t(np.array([m.roughness_factor for m in mats]))
        self.ior = t(np.array([m.ior for m in mats]))
        self.aniso_s = t(np.array([m.anisotropy_strength for m in mats]))
        self.aniso_r = t(np.array([m.anisotropy_rotation for m in mats]))
        # the emissive CDF over area x luminance (scene.cpp:288-292)
        self.num_emissive = sum(len(e) for e in em_ids)
        if self.num_emissive:
            cdf = np.cumsum(np.concatenate(em_h), dtype=np.float64)
            cdf = (cdf / (cdf[-1] if cdf[-1] > 0 else 1.0)).astype(np.float32)
            p_delta = np.diff(np.concatenate([[0.0], cdf])).astype(np.float32)
            em = np.concatenate(em_ids)
            area = 0.5 * np.linalg.norm(np.cross(v1[em] - v0[em], v2[em] - v0[em]), axis=-1)
            self.em_cdf, self.em_p, self.em_area = t(cdf), t(p_delta), t(area)
            self.em_tri = torch.as_tensor(em, device=self.device)
        sky = (np.zeros((1, 1, 3), np.float32) if data.skybox is None
               else np.asarray(data.skybox, np.float32))
        self.sky_h, self.sky_w = sky.shape[:2]
        self.skybox = t(sky.reshape(-1, 3))
        self.sky_strength = float(data.skybox_strength)
        self._clusters(v0, v1, v2)

    @staticmethod
    def _check(m):
        unsupported = {
            "alpha_mode": m.alpha_mode != 0,
            "transmission_factor": m.transmission_factor != 0,
            "dispersion": m.dispersion != 0,
        }
        bad = [k for k, v in unsupported.items() if v]
        if bad:
            raise ValueError(f"the reference renders opaque, non-dispersive materials; "
                             f"this scene sets {bad}")

    def _t(self, a):
        return torch.as_tensor(np.asarray(a, np.float32), device=self.device).to(self.dtype)

    def _clusters(self, v0, v1, v2):
        """Triangles grouped ``CLUSTER`` at a time in Morton order of their
        centroids; each cluster's box (widened by a part in 10^4 of the
        scene's size) is tested before its triangles."""
        n = v0.shape[0]
        if n <= CLUSTER:
            self.cluster_tri = torch.arange(n, device=self.device)[None]
            self.box_lo = self.box_hi = None
            return
        c = (v0 + v1 + v2) / 3.0
        lo, hi = c.min(0), c.max(0)
        q = np.clip(((c - lo) / np.maximum(hi - lo, 1e-12) * 1023).astype(np.int64), 0, 1023)

        def spread(x):
            x = (x | (x << 16)) & 0x030000FF
            x = (x | (x << 8)) & 0x0300F00F
            x = (x | (x << 4)) & 0x030C30C3
            return (x | (x << 2)) & 0x09249249

        code = spread(q[:, 0]) | (spread(q[:, 1]) << 1) | (spread(q[:, 2]) << 2)
        order = np.argsort(code, kind="stable")
        k = -(-n // CLUSTER)
        slots = np.full(k * CLUSTER, -1, np.int64)
        slots[:n] = order
        slots = slots.reshape(k, CLUSTER)
        safe = np.where(slots >= 0, slots, slots[:, :1])
        pts = np.stack([v0[safe], v1[safe], v2[safe]], 2).reshape(k, -1, 3)
        pad = 1e-4 * float(np.max(np.ptp(np.concatenate([v0, v1, v2]), 0)))
        self.cluster_tri = torch.as_tensor(slots, device=self.device)
        self.box_lo = self._t(pts.min(1) - pad)
        self.box_hi = self._t(pts.max(1) + pad)

    # -- intersection ----------------------------------------------------

    def _test(self, o, d, tri, t_min, t_max):
        """Moller-Trumbore of each lane against triangle ``tri`` (per lane,
        -1: none): (t, u, v, hit)."""
        safe = torch.clamp_min(tri, 0)
        e1, e2, p0 = self.e1[safe], self.e2[safe], self.v0[safe]
        pvec = cross(d, e2)
        det = dot(e1, pvec)
        bad = torch.abs(det) < 1e-12
        inv = 1.0 / torch.where(bad, torch.ones_like(det), det)
        tvec = o - p0
        u = dot(tvec, pvec) * inv
        qvec = cross(tvec, e1)
        v = dot(d, qvec) * inv
        t = dot(e2, qvec) * inv
        hit = ((tri >= 0) & ~bad & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > t_min)
               & (t <= t_max))
        return t, u, v, hit

    def closest(self, o, d, t_min, t_max):
        """The closest hit in (t_min, t_max] of each lane: (t: inf on a
        miss, triangle: -1 on a miss, u, v).  Among equal t the lowest
        triangle wins, as an argmin would pick."""
        n = o.shape[0]
        t_min = torch.as_tensor(t_min, dtype=self.dtype, device=self.device).expand(n)
        t_max = torch.as_tensor(t_max, dtype=self.dtype, device=self.device).expand(n)
        best_t = torch.full((n,), math.inf, dtype=self.dtype, device=self.device)
        best = torch.full((n,), -1, dtype=torch.int64, device=self.device)
        if n == 0:
            return best_t, best, best_t.clone(), best_t.clone()
        if self.box_lo is None:
            for j in range(self.n_tris):
                tri = torch.full((n,), j, dtype=torch.int64, device=self.device)
                t, _, _, hit = self._test(o, d, tri, t_min, t_max)
                take = hit & (t < best_t)
                best_t = torch.where(take, t, best_t)
                best = torch.where(take, tri, best)
        else:
            best_t, best = self._closest_clusters(o, d, t_min, t_max, best_t, best)
        t, u, v, hit = self._test(o, d, best, t_min, t_max)
        zero = torch.zeros_like(t)
        return (torch.where(hit, t, math.inf), torch.where(hit, best, -1),
                torch.where(hit, u, zero), torch.where(hit, v, zero))

    def _closest_clusters(self, o, d, t_min, t_max, best_t, best):
        k = self.box_lo.shape[0]
        tiny = torch.full_like(d, 1e-30)
        inv = 1.0 / torch.where(torch.abs(d) < 1e-30, torch.copysign(tiny, d), d)
        step = max(1, BOXES // (k * 3))
        lanes, clusters = [], []
        for a in range(0, o.shape[0], step):
            sl = slice(a, a + step)
            oo, ii = o[sl, None, :], inv[sl, None, :]
            t1 = (self.box_lo[None] - oo) * ii
            t2 = (self.box_hi[None] - oo) * ii
            near = torch.minimum(t1, t2).amax(-1)
            far = torch.maximum(t1, t2).amin(-1)
            touch = (near <= far) & (far >= t_min[sl, None]) & (near <= t_max[sl, None])
            lane, clus = touch.nonzero(as_tuple=True)
            lanes.append(lane + a)
            clusters.append(clus)
        lane, clus = torch.cat(lanes), torch.cat(clusters)
        for b in range(0, lane.shape[0], PAIRS):
            ln, cl = lane[b:b + PAIRS], clus[b:b + PAIRS]
            po, pd = o[ln], d[ln]
            pmin, pmax = t_min[ln], t_max[ln]
            pt = torch.full((ln.shape[0],), math.inf, dtype=self.dtype, device=self.device)
            ptri = torch.full((ln.shape[0],), -1, dtype=torch.int64, device=self.device)
            for c in range(CLUSTER):
                tri = self.cluster_tri[cl, c]
                t, _, _, hit = self._test(po, pd, tri, pmin, pmax)
                take = hit & ((t < pt) | ((t == pt) & (tri < ptri)))
                pt = torch.where(take, t, pt)
                ptri = torch.where(take, tri, ptri)
            lane_t = torch.full_like(best_t, math.inf).scatter_reduce(
                0, ln, pt, "amin", include_self=True)
            lane_tri = torch.full_like(best, 1 << 62).scatter_reduce(
                0, ln, torch.where((pt == lane_t[ln]) & (ptri >= 0), ptri, 1 << 62),
                "amin", include_self=True)
            found = lane_tri < (1 << 62)
            take = found & ((lane_t < best_t) | ((lane_t == best_t) & (lane_tri < best)))
            best_t = torch.where(take, lane_t, best_t)
            best = torch.where(take, lane_tri, best)
        return best_t, best

    def occluded(self, o, d, t_max):
        """Is anything hit in (0, t_max]?"""
        _, tri, _, _ = self.closest(o, d, 0.0, t_max)
        return tri >= 0

    def emissive_pdf(self, o, d, t_min):
        """shaders/emissivepdf.rahit over every emissive triangle beyond
        t_min: the sum of p * t^2 / (area * |cos|) of those hit."""
        out = torch.zeros(o.shape[0], dtype=self.dtype, device=self.device)
        for j in range(self.num_emissive):
            tri = self.em_tri[j].expand(o.shape[0])
            t, u, v, hit = self._test(o, d, tri, t_min, math.inf)
            en = self.tri_n[tri]
            w0 = (1 - u - v)[:, None]
            nrm = normalize(w0 * en[:, 0] + u[:, None] * en[:, 1] + v[:, None] * en[:, 2])
            cos = torch.abs(dot(nrm, d))
            contrib = self.em_p[j] * t * t / torch.clamp_min(self.em_area[j] * cos, 1e-30)
            out = out + torch.where(hit, contrib, torch.zeros_like(contrib))
        return out

    def sky(self, d):
        h, w = self.sky_h, self.sky_w
        u = torch.atan2(d[:, 2], d[:, 0]) / TWOPI + 0.5
        v = -(torch.asin(torch.clamp(d[:, 1], -1, 1)) / PI + 0.5)
        x = u * w - 0.5
        y = v * h - 0.5
        x0, y0 = torch.floor(x), torch.floor(y)
        fx, fy = (x - x0)[:, None], (y - y0)[:, None]
        xi, yi = x0.to(torch.int64), y0.to(torch.int64)
        x0i, x1i = torch.remainder(xi, w), torch.remainder(xi + 1, w)
        y0i, y1i = torch.remainder(yi, h), torch.remainder(yi + 1, h)
        sb = self.skybox
        top = sb[y0i * w + x0i] * (1 - fx) + sb[y0i * w + x1i] * fx
        bot = sb[y1i * w + x0i] * (1 - fx) + sb[y1i * w + x1i] * fx
        return (top * (1 - fy) + bot * fy) * self.sky_strength


# ---------------------------------------------------------------------------
# a hit's material (hit.rchit:31-117, no textures, no tangents)
# ---------------------------------------------------------------------------


class Hit:
    pass


def eval_hit(sc: RefScene, o, d, t, tri, u, v):
    h = Hit()
    miss = tri < 0
    ti = torch.clamp_min(tri, 0)
    h.pos = o + torch.where(torch.isfinite(t), t, torch.zeros_like(t))[:, None] * d
    tn = sc.tri_n[ti]
    w0 = (1 - u - v)[:, None]
    shading = normalize(w0 * tn[:, 0] + u[:, None] * tn[:, 1] + v[:, None] * tn[:, 2])
    mi = sc.tri_mat[ti]
    h.tangent, h.bitangent = branchless_onb(shading)
    h.front = dot(shading, -d) >= 0
    h.normal = torch.where(h.front[:, None], shading, -shading)
    h.base = sc.base[mi]
    h.metallic = sc.metallic[mi]
    rough = sc.rough[mi]
    aniso_s, aniso_r = sc.aniso_s[mi], sc.aniso_r[mi]
    a = torch.clamp_min(rough * rough, 0.001)
    h.ax = a + (1 - a) * aniso_s * aniso_s
    h.ay = a
    h.adx, h.ady = torch.cos(aniso_r), torch.sin(aniso_r)
    h.ior = sc.ior[mi]
    h.emissive = torch.where(miss[:, None], sc.sky(d), sc.emissive[mi])
    h.miss = miss
    return h


def to_tangent(h, v):
    return torch.stack([dot(v, h.tangent), dot(v, h.bitangent), dot(v, h.normal)], -1)


def from_tangent(h, v):
    return v[..., 0:1] * h.tangent + v[..., 1:2] * h.bitangent + v[..., 2:3] * h.normal


# ---------------------------------------------------------------------------
# GGX (shaders/bsdf.glsl), the opaque lobes
# ---------------------------------------------------------------------------


def aniso2(h, vx, vy):
    return h.adx * vx + h.ady * vy, h.ady * vx - h.adx * vy


def _safe_div(num, den, floor):
    ok = torch.abs(den) >= floor
    return torch.where(ok, num / torch.where(den == 0, torch.ones_like(den), den),
                       torch.zeros_like(den))


def d_ggx(h, hv):
    ht, hb = aniso2(h, hv[..., 0], hv[..., 1])
    a2 = h.ax * h.ay
    f = a2 / torch.clamp_min((h.ay * ht) ** 2 + (h.ax * hb) ** 2 + (a2 * hv[..., 2]) ** 2, 1e-30)
    return a2 * f * f / PI


def _smith_len(h, v):
    vt, vb = aniso2(h, v[..., 0], v[..., 1])
    return torch.sqrt((h.ax * vt) ** 2 + (h.ay * vb) ** 2 + v[..., 2] ** 2)


def vis(h, v, l):
    den = 2 * (l[..., 2] * _smith_len(h, v) + v[..., 2] * _smith_len(h, l))
    return _safe_div(torch.ones_like(den), den, 1e-20)


def fresnel(f0, c):
    return torch.clamp_min(1 - c, 0) ** 5 * (1 - f0) + f0


def fresnel_vh(f0, v, hv):
    c = torch.abs(dot(v, hv))
    if f0.dim() == 2:
        c = c[..., None]
    return fresnel(f0, c)


def _vndf_k(h, sx, sy, vz):
    s = 1 + torch.sqrt(sx * sx + sy * sy)
    a = torch.minimum(h.ax, h.ay)
    s2, a2 = s * s, a * a
    return (1 - a2) * s2 / (s2 + a2 * vz * vz)


def vndf_refl_pdf(h, v, hv):
    ndf = d_ggx(h, hv)
    ax, ay = aniso2(h, v[..., 0], v[..., 1])
    t = torch.sqrt((h.ax * ax) ** 2 + (h.ay * ay) ** 2 + v[..., 2] ** 2)
    k = _vndf_k(h, ax, ay, v[..., 2])
    return _safe_div(ndf, 2 * (k * v[..., 2] + t), 1e-20)


def sample_vndf(seed, h, v, dtype):
    vstd = normalize(torch.stack([h.ax * v[..., 0], h.ay * v[..., 1], v[..., 2]], -1))
    ux, seed = rnd(seed, dtype)
    uy, seed = rnd(seed, dtype)
    phi = TWOPI * ux
    b = _vndf_k(h, v[..., 0], v[..., 1], v[..., 2]) * vstd[..., 2]
    z = (1 - uy) * (1 + b) - b
    st = torch.sqrt(torch.clamp(1 - z * z, 0, 1))
    hstd = vstd + torch.stack([st * torch.cos(phi), st * torch.sin(phi), z], -1)
    ani = normalize(torch.stack([hstd[..., 0] * h.ax, hstd[..., 1] * h.ay, hstd[..., 2]], -1))
    hx, hy = aniso2(h, ani[..., 0], ani[..., 1])
    return torch.stack([hx, hy, ani[..., 2]], -1), seed


def sample_cosine(seed, dtype):
    ux, seed = rnd(seed, dtype)
    uy, seed = rnd(seed, dtype)
    x = ux * torch.sin(TWOPI * uy)
    y = ux * torch.cos(TWOPI * uy)
    return torch.stack([x, y, 1 - (x * x + y * y)], -1), seed


def _f0(h):
    return ((h.ior - 1) / (h.ior + 1)) ** 2


def _opaque_bsdf(h, v, l, hh):
    """The lobes an opaque material reflects with (bsdf.glsl): Lambert
    under dielectric Fresnel, GGX, the metal's tinted GGX."""
    f0 = _f0(h)
    f_diel = fresnel_vh(f0, v, hh)
    f_met = fresnel_vh(h.base, v, hh)
    spec = vis(h, v, l) * d_ggx(h, hh)
    diffuse = torch.where((l[..., 2] > 0)[:, None], h.base / PI, torch.zeros_like(h.base))
    diel = diffuse * (1 - f_diel[:, None]) + spec[:, None] * f_diel[:, None]
    return diel * (1 - h.metallic[:, None]) + f_met * (spec * h.metallic)[:, None]


def material_pdf(h, v, l):
    p_d = 0.5 * (1 - h.metallic)
    ndotl = l[..., 2]
    ggx = vndf_refl_pdf(h, v, normalize(v + l))
    pdf_pos = (1 - p_d) * ggx + p_d * ndotl / PI
    return torch.where(ndotl < 0, torch.zeros_like(pdf_pos), pdf_pos)


def material_bsdf(h, v, l):
    ndotl = l[..., 2]
    bsdf_pos = _opaque_bsdf(h, v, l, normalize(v + l))
    zero = torch.zeros_like(bsdf_pos)
    return torch.where((ndotl > 0)[:, None], bsdf_pos, zero)


def sample_material(seed, h, view, dtype):
    """The material sample's draws in the renderer's order: the lobe (a
    transmission draw that an opaque material never takes), diffuse or
    specular, then two for the direction.  Returns (direction in tangent
    space, estimate, pdf, seed)."""
    p_d = 0.5 * (1 - h.metallic)
    _, seed = rnd(seed, dtype)
    u_d, seed_r = rnd(seed, dtype)
    is_d = u_d < p_d
    d_cos, seed_cos = sample_cosine(seed_r, dtype)
    h_cos = normalize(view + d_cos)
    h_v, seed_vn = sample_vndf(seed_r, h, view, dtype)
    d_vn = reflect(-view, h_v)
    direction = torch.where(is_d[:, None], d_cos, d_vn)
    hw = torch.where(is_d[:, None], h_cos, h_v)
    seed = torch.where(is_d, seed_cos, seed_vn)
    ok = direction[..., 2] >= 0
    pdf_g = vndf_refl_pdf(h, view, hw)
    ndotl = direction[..., 2]
    bsdf = _opaque_bsdf(h, view, direction, hw)
    pdf = (1 - p_d) * pdf_g + p_d * ndotl / PI
    bsdf = torch.where((ndotl < 0)[:, None], torch.zeros_like(bsdf), bsdf)
    pdf = torch.where(ndotl < 0, torch.zeros_like(pdf), pdf)
    direction = torch.where(ok[:, None], direction, torch.zeros_like(direction))
    zero = torch.all(bsdf == 0, -1) | (pdf <= 0)
    est = torch.where((ok & ~zero)[:, None],
                      bsdf / torch.where(pdf == 0, torch.ones_like(pdf), pdf)[:, None]
                      * torch.abs(ndotl)[:, None], torch.zeros_like(bsdf))
    pdf = torch.where(ok, pdf, torch.zeros_like(pdf))
    return direction, est, pdf, seed


# ---------------------------------------------------------------------------
# NEE over the emissive triangles (shaders/lightsample.glsl)
# ---------------------------------------------------------------------------


def sample_lights(sc: RefScene, h, view_world, seed, mask):
    n = h.pos.shape[0]
    dtype = sc.dtype
    if not sc.num_emissive:
        return torch.zeros((n, 3), dtype=dtype, device=sc.device), seed
    u, s2 = rnd(seed, dtype)
    seed = torch.where(mask, s2, seed)
    te = torch.clamp(torch.searchsorted(sc.em_cdf, u.contiguous(), right=False), 0,
                     sc.num_emissive - 1)
    st = sc.em_tri[te]
    ux, s2 = rnd(seed, dtype)
    uy, s3 = rnd(s2, dtype)
    seed = torch.where(mask, s3, seed)
    fold = ux + uy > 1
    ux = torch.where(fold, 1 - ux, ux)
    uy = torch.where(fold, 1 - uy, uy)
    point = (sc.v0[st] * ux[:, None] + sc.v1[st] * uy[:, None]
             + sc.v2[st] * (1 - ux - uy)[:, None])
    ray = point - h.pos
    dist = torch.clamp_min(torch.linalg.vector_norm(ray, dim=-1), 1e-15)
    ldir = ray / dist[:, None]
    radiance = sc.emissive[sc.tri_mat[st]]
    t_max = dist * (1.0 - 1e-4) - 1e-5
    off = torch.where(dot(h.normal, ldir) >= 0, 1.0, -1.0).to(dtype)
    ro = h.pos + (off * BIAS)[:, None] * h.normal
    occ = torch.zeros(n, dtype=torch.bool, device=sc.device)
    live = mask.nonzero(as_tuple=True)[0]
    occ[live] = sc.occluded(ro[live], ldir[live], t_max[live])
    zero3 = torch.zeros_like(radiance)
    radiance = torch.where((occ | ~mask)[:, None], zero3, radiance)
    visible = mask & ~occ & torch.any(radiance != 0, -1)
    pdf = sc.emissive_pdf(ro, ldir, 0.0)
    radiance = torch.where(visible[:, None], radiance, zero3)
    got = torch.any(radiance != 0, -1) & mask
    tv = to_tangent(h, view_world)
    tl = to_tangent(h, ldir)
    bsdf = material_bsdf(h, tv, tl)
    mis = pdf / torch.clamp_min(pdf + material_pdf(h, tv, tl), 1e-30)
    scale = mis * torch.abs(dot(h.normal, ldir)) / torch.clamp_min(pdf, 1e-30)
    contrib = radiance * bsdf * scale[:, None]
    keep = got & ~torch.all(bsdf == 0, -1)
    return torch.where(keep[:, None], contrib, zero3), seed


# ---------------------------------------------------------------------------
# a sample of each lane (raygen.rgen: trace, then the material, then NEE)
# ---------------------------------------------------------------------------


def render(sc: RefScene, view_inv, proj_inv, width: int, height: int, pixels, samples,
           max_depth: int):
    """The radiance of sample ``samples[i]`` (>= 1) of pixel ``pixels[i]``,
    (n, 3) in the scene's dtype."""
    dtype, dev = sc.dtype, sc.device
    pixels = torch.as_tensor(pixels, dtype=torch.int64, device=dev)
    samples = torch.as_tensor(samples, dtype=torch.int64, device=dev)
    if bool((samples < 1).any()):
        raise ValueError("the reference renders samples from 1 on (0 is the preview)")
    n = pixels.shape[0]
    px = (pixels % width).to(dtype)
    py = (pixels // width).to(dtype)
    seed = tea(pixels, samples)
    jx, seed = rnd(seed, dtype)
    jy, seed = rnd(seed, dtype)
    u = (px + jx) / width * 2 - 1
    v = -((py + jy) / height * 2 - 1)
    vi = torch.as_tensor(np.asarray(view_inv, np.float32), device=dev).to(dtype)
    pi_ = torch.as_tensor(np.asarray(proj_inv, np.float32), device=dev).to(dtype)
    ones = torch.ones_like(u)
    ndc = torch.stack([u, v, ones, ones], -1)
    target = normalize(ndc @ pi_[:3].T)
    direction = normalize(target @ vi[:3, :3].T)
    origin = vi[:3, 3].expand(n, 3).clone()

    value = torch.zeros((n, 3), dtype=dtype, device=dev)
    throughput = torch.ones((n, 3), dtype=dtype, device=dev)
    mat_pdf = torch.ones(n, dtype=dtype, device=dev)
    active = torch.ones(n, dtype=torch.bool, device=dev)
    zero3 = torch.zeros_like(value)
    for b in range(max_depth + 1):
        t = torch.full((n,), math.inf, dtype=dtype, device=dev)
        tri = torch.full((n,), -1, dtype=torch.int64, device=dev)
        uu, vv = torch.zeros_like(t), torch.zeros_like(t)
        live = active.nonzero(as_tuple=True)[0]
        ct, ctri, cu, cv = sc.closest(origin[live], direction[live], EPS, INF)
        t[live], tri[live], uu[live], vv[live] = ct, ctri, cu, cv
        h = eval_hit(sc, origin, direction, t, tri, uu, vv)
        miss = tri < 0
        is_em = torch.any(h.emissive != 0, -1)
        terminal = miss | is_em | (b == max_depth)
        probe_m = active & terminal & is_em & ~miss & (b != 0)
        weight = torch.ones_like(mat_pdf)
        if b != 0 and bool(probe_m.any()):
            pdf_probe = sc.emissive_pdf(origin, direction, EPS)
            weight = torch.where(probe_m, mat_pdf / torch.clamp_min(mat_pdf + pdf_probe, 1e-30),
                                 weight)
        value = value + torch.where((active & terminal)[:, None],
                                    throughput * h.emissive * weight[:, None], zero3)
        cont = active & ~terminal

        view = -direction
        tview = to_tangent(h, view)
        d_t, est, pdf_m, seed_m = sample_material(seed, h, tview, dtype)
        seed = torch.where(cont, seed_m, seed)
        nd = from_tangent(h, d_t)
        throughput = torch.where(cont[:, None], throughput * est, throughput)
        mat_pdf = torch.where(cont, pdf_m, mat_pdf)
        alive = cont & torch.any(throughput != 0, -1)
        offs = torch.where(dot(h.normal, nd) >= 0, 1.0, -1.0).to(dtype)
        origin = torch.where(cont[:, None], h.pos + (offs * BIAS)[:, None] * h.normal, origin)
        direction = torch.where(cont[:, None], nd, direction)

        light, seed = sample_lights(sc, h, view, seed, alive)
        value = value + torch.where(alive[:, None], throughput * light, zero3)
        active = alive
        if not bool(active.any()):
            break
    return value


def tonemap_u8(mean):
    """Reinhard-Jodie (shaders/hdr.glsl:9-13), then clamped to [0, 1],
    x 255 + 0.5 and truncated to uint8."""
    lum = (mean[..., 0] * 0.2126 + mean[..., 1] * 0.7152 + mean[..., 2] * 0.0722)[..., None]
    tv = mean / (1.0 + mean)
    img = (mean / (1.0 + lum)) * (1.0 - tv) + tv * tv
    return (torch.clamp(img, 0.0, 1.0) * 255.0 + 0.5).to(torch.uint8)


def pixel_means(sc: RefScene, view_inv, proj_inv, width: int, height: int, pixels, first: int,
                count: int, max_depth: int, block: int = 1 << 18):
    """The float32 sum of samples ``first .. first + count - 1`` of each of
    ``pixels``, added in sample order, over ``count``: (len(pixels), 3) on
    the scene's device.  Lanes render ``block`` at a time."""
    pixels = torch.as_tensor(pixels, dtype=torch.int64, device=sc.device)
    p = pixels.shape[0]
    acc = torch.zeros((p, 3), dtype=sc.dtype, device=sc.device)
    per = max(1, block // max(p, 1))
    for s0 in range(first, first + count, per):
        k = min(per, first + count - s0)
        samples = torch.arange(s0, s0 + k, device=sc.device).repeat_interleave(p)
        rad = render(sc, view_inv, proj_inv, width, height, pixels.repeat(k), samples,
                     max_depth).reshape(k, p, 3)
        for j in range(k):
            acc = acc + rad[j]
    return acc / count
