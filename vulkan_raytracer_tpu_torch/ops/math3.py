"""Component-form 3-vectors on torch tensors.

Port of :mod:`vulkan_raytracer_tpu.ops.math3` (``V3`` at math3.py:42-143,
``v3_*`` helpers at :145-192).  A wavefront of N rays stores each vector as
three (N,) tensors, the layout the JAX package uses at its public
functions, so the parity tests compare like with like.

Contains the branchless ONB of Duff et al. (reference:
shaders/maths.glsl:13-19) and the GLSL reflect/refract used by the BSDF.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

PI = 3.14159265358979323846
TWOPI = 2.0 * PI
PIINV = 1.0 / PI
TWOPIINV = 0.5 / PI

# Ray-march constants (shaders/constants.glsl:4-6).
BIAS = 1e-3
EPS = 1e-7
INF = 1e32


class V3(NamedTuple):
    """Component-form 3-vector: three (N,) tensors (or Python scalars)."""

    x: object
    y: object
    z: object

    # -- arithmetic (elementwise; scalars broadcast) --
    def __add__(self, o):
        if isinstance(o, V3):
            return V3(self.x + o.x, self.y + o.y, self.z + o.z)
        return V3(self.x + o, self.y + o, self.z + o)

    def __radd__(self, o):
        return self.__add__(o)

    def __sub__(self, o):
        if isinstance(o, V3):
            return V3(self.x - o.x, self.y - o.y, self.z - o.z)
        return V3(self.x - o, self.y - o, self.z - o)

    def __rsub__(self, o):
        return V3(o - self.x, o - self.y, o - self.z)

    def __mul__(self, o):
        if isinstance(o, V3):
            return V3(self.x * o.x, self.y * o.y, self.z * o.z)
        return V3(self.x * o, self.y * o, self.z * o)

    def __rmul__(self, o):
        return self.__mul__(o)

    def __truediv__(self, o):
        if isinstance(o, V3):
            return V3(self.x / o.x, self.y / o.y, self.z / o.z)
        return V3(self.x / o, self.y / o, self.z / o)

    def __neg__(self):
        return V3(-self.x, -self.y, -self.z)

    # -- geometry --
    def dot(self, o):
        return self.x * o.x + self.y * o.y + self.z * o.z

    def cross(self, o):
        return V3(
            self.y * o.z - self.z * o.y,
            self.z * o.x - self.x * o.z,
            self.x * o.y - self.y * o.x,
        )

    def length_sq(self):
        return self.dot(self)

    def normalized(self, eps: float = 1e-20):
        # 1 / sqrt: both are correctly rounded on every device, where a
        # card's rsqrt and the CPU's differ by an ulp on some lanes (and
        # whole paths with them)
        inv = 1.0 / torch.sqrt(torch.clamp_min(self.length_sq(), eps))
        return V3(self.x * inv, self.y * inv, self.z * inv)

    def where(self, cond, other):
        """Lane-select: cond ? self : other."""
        if isinstance(other, V3):
            return V3(*(torch.where(cond, a, b) for a, b in zip(self, other)))
        return V3(*(torch.where(cond, a, other) for a in self))

    def any_nonzero(self):
        return (self.x != 0.0) | (self.y != 0.0) | (self.z != 0.0)

    # -- conversions --
    @staticmethod
    def from_array(a):
        """(N, 3) -> V3."""
        return V3(a[..., 0], a[..., 1], a[..., 2])

    @staticmethod
    def full(v, n: int, device) -> "V3":
        """Constant 3-vector broadcast to (n,) float32 lanes on ``device``."""
        return V3(*(torch.full((n,), float(c), dtype=torch.float32, device=device)
                    for c in v))

    def to_array(self):
        """V3 -> (N, 3)."""
        return torch.stack(torch.broadcast_tensors(self.x, self.y, self.z), dim=-1)


def v3_reflect(i: V3, n: V3) -> V3:
    """GLSL reflect(I, N) = I - 2*dot(N, I)*N on component vectors."""
    return i - n * (2.0 * n.dot(i))


def v3_refract(i: V3, n: V3, eta) -> V3:
    """GLSL refract; zero vector on total internal reflection."""
    cosi = n.dot(i)
    k = 1.0 - eta * eta * (1.0 - cosi * cosi)
    tir = k < 0.0
    coef = eta * cosi + torch.sqrt(torch.clamp_min(k, 0.0))
    out = i * eta - n * coef
    return out.where(~tir, 0.0)


def safe_inv_dir(d: torch.Tensor) -> torch.Tensor:
    """1/d with |d| < 1e-20 replaced by a signed 1e-20 (``safe_inv_dir``,
    vulkan_raytracer_tpu/ops/intersect.py:20)."""
    return torch.reciprocal(torch.where(
        torch.abs(d) < 1e-20, torch.where(d < 0, -1e-20, 1e-20), d))


def v3_gather(v: V3, idx) -> V3:
    """Gather rows of a V3-of-(T,) table by (N,) int indices."""
    return V3(
        torch.index_select(v.x, 0, idx),
        torch.index_select(v.y, 0, idx),
        torch.index_select(v.z, 0, idx),
    )


def v3_onb(n: V3):
    """Branchless ONB (Duff et al., shaders/maths.glsl:13-19) on components."""
    sign = torch.where(n.z >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + n.z)
    b = n.x * n.y * a
    tangent = V3(1.0 + sign * n.x * n.x * a, sign * b, -sign * n.x)
    bitangent = V3(b, sign + n.y * n.y * a, -n.y)
    return tangent, bitangent


def v3_to_tangent(v: V3, t: V3, b: V3, n: V3) -> V3:
    return V3(v.dot(t), v.dot(b), v.dot(n))


def v3_from_tangent(v: V3, t: V3, b: V3, n: V3) -> V3:
    return t * v.x + b * v.y + n * v.z
