// Lane arithmetic shared by csrc/shade.cu, csrc/wave.cu and csrc/trace.cu: the 3-vector,
// aten's rounding of the few operations the kernels repeat, the RNG's LCG
// draw, the bilinear texture fetch and the decode of an instanced hit id.
//
// Every function rounds as the aten op it stands for on the card, under the
// flags of ops/_ext.py (--fmad=false -prec-div=true -prec-sqrt=true, no fast
// math): products and sums in the plain version's order (a dot is
// ((x*x') + (y*y')) + (z*z')), a normalisation is 1/sqrt, clamp, minimum and
// maximum pass NaN through, and a Python float is rounded to float32 from its double
// (K()).  csrc/shade.cu's header note says more.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// A Python float as aten rounds it: the double, then float32.
#define K(x) (static_cast<float>(x))

constexpr double kPi = 3.14159265358979323846;
#define PIINV K(1.0 / kPi)
#define TWOPIINV K(0.5 / kPi)
#define TWOPI K(2.0 * kPi)
#define TINY K(1e-20)
#define BIAS K(1e-3)
#define INF K(1e32)

namespace {

struct V3 {
  float x, y, z;
};

// ---------------------------------------------------------------------------
// Arithmetic as aten rounds it
// ---------------------------------------------------------------------------

__device__ __forceinline__ float clamp_min(float v, float lo) { return isnan(v) ? v : fmaxf(v, lo); }
__device__ __forceinline__ float clamp_max(float v, float hi) { return isnan(v) ? v : fminf(v, hi); }
__device__ __forceinline__ float clamp(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}
__device__ __forceinline__ float minimum(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fminf(a, b));
}
__device__ __forceinline__ float maximum(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fmaxf(a, b));
}
__device__ __forceinline__ float rcp(float x) { return 1.0f / x; }  // torch.reciprocal
__device__ __forceinline__ float safe_div(float a, float b) {      // bsdf._safe_div
  return a / (fabsf(b) < TINY ? (b < 0.0f ? -TINY : TINY) : b);
}

__device__ __forceinline__ V3 add(V3 a, V3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
__device__ __forceinline__ V3 adds(V3 a, float s) { return {a.x + s, a.y + s, a.z + s}; }
__device__ __forceinline__ V3 sub(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
__device__ __forceinline__ V3 mul(V3 a, V3 b) { return {a.x * b.x, a.y * b.y, a.z * b.z}; }
__device__ __forceinline__ V3 scale(V3 a, float s) { return {a.x * s, a.y * s, a.z * s}; }
__device__ __forceinline__ V3 divs(V3 a, float s) { return {a.x / s, a.y / s, a.z / s}; }
__device__ __forceinline__ V3 neg(V3 a) { return {-a.x, -a.y, -a.z}; }
__device__ __forceinline__ V3 zero3() { return {0.0f, 0.0f, 0.0f}; }
__device__ __forceinline__ float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
__device__ __forceinline__ bool nonzero(V3 a) { return a.x != 0.0f || a.y != 0.0f || a.z != 0.0f; }
__device__ __forceinline__ V3 normalized(V3 v) {  // math3.V3.normalized: 1 / sqrt
  float inv = rcp(sqrtf(clamp_min(dot(v, v), TINY)));
  return scale(v, inv);
}
__device__ __forceinline__ V3 to_tangent(V3 v, V3 t, V3 b, V3 n) { return {dot(v, t), dot(v, b), dot(v, n)}; }
__device__ __forceinline__ V3 from_tangent(V3 v, V3 t, V3 b, V3 n) {
  return add(add(scale(t, v.x), scale(b, v.y)), scale(n, v.z));
}
__device__ __forceinline__ V3 reflect(V3 i, V3 n) { return sub(i, scale(n, 2.0f * dot(n, i))); }
__device__ __forceinline__ V3 refract(V3 i, V3 n, float eta) {
  float cosi = dot(n, i);
  float k = 1.0f - eta * eta * (1.0f - cosi * cosi);
  float coef = eta * cosi + sqrtf(clamp_min(k, 0.0f));
  V3 out = sub(scale(i, eta), scale(n, coef));
  return k < 0.0f ? zero3() : out;
}
__device__ __forceinline__ float balance(float p1, float p2) {  // integrator._balance
  return p1 / clamp_min(p1 + p2, K(1e-30));
}
__device__ __forceinline__ int floor_mod(int a, int b) {  // torch.remainder on int32
  int r = a % b;
  if (r != 0 && ((r < 0) != (b < 0))) r += b;
  return r;
}

// ---------------------------------------------------------------------------
// The RNG (ops/rng.py): LCG draws on uint32
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t lcg(uint32_t& s) {
  s = s * 1664525u + 1013904223u;
  return s & 0x00FFFFFFu;
}
__device__ __forceinline__ float rnd(uint32_t& s) {
  return static_cast<float>(lcg(s)) * K(1.0 / 16777216.0);
}

// ---------------------------------------------------------------------------
// Textures (ops/texture.py sample_bilinear) and hit ids
// ---------------------------------------------------------------------------

// The atlas: packed RGBA8 texels and each texture's offset, height and width.
struct Tex {
  const int *texels, *off, *h, *w;
};

__device__ __forceinline__ float4 texel(const Tex& t, int idx) {
  int p = t.texels[idx];
  const float f = K(1.0 / 255.0);
  return {static_cast<float>(p & 0xFF) * f, static_cast<float>((p >> 8) & 0xFF) * f,
          static_cast<float>((p >> 16) & 0xFF) * f, static_cast<float>((p >> 24) & 0xFF) * f};
}

__device__ __forceinline__ float4 lerp4(float4 a, float4 b, float f) {
  float g = 1.0f - f;
  return {a.x * g + b.x * f, a.y * g + b.y * f, a.z * g + b.z * f, a.w * g + b.w * f};
}

__device__ __forceinline__ float4 sample_bilinear(const Tex& t, int tex, float u, float v) {
  int ti = tex < 0 ? 0 : tex;
  int off = t.off[ti], hn = t.h[ti], wn = t.w[ti];
  float x = u * static_cast<float>(wn) - K(0.5);
  float y = v * static_cast<float>(hn) - K(0.5);
  float x0 = floorf(x), y0 = floorf(y);
  float fx = x - x0, fy = y - y0;
  int x0i = static_cast<int>(x0), y0i = static_cast<int>(y0);
  int x1i = floor_mod(x0i + 1, wn), y1i = floor_mod(y0i + 1, hn);
  x0i = floor_mod(x0i, wn);
  y0i = floor_mod(y0i, hn);
  float4 top = lerp4(texel(t, off + y0i * wn + x0i), texel(t, off + y0i * wn + x1i), fx);
  float4 bot = lerp4(texel(t, off + y1i * wn + x0i), texel(t, off + y1i * wn + x1i), fx);
  return lerp4(top, bot, fy);
}

// _uv_at over row ``row`` of a (T, 6) [u0 v0 u1 v1 u2 v2] table
__device__ __forceinline__ void uv_at(const float* rows, long long row, float w0, float w1,
                                      float w2, float& u, float& v) {
  const float* r = rows + row * 6;
  u = w0 * r[0] + w1 * r[2] + w2 * r[4];
  v = w0 * r[1] + w1 * r[3] + w2 * r[5];
}

// InstanceTables.decode: an encoded (non-negative) hit id -> (prototype
// triangle, instance); ``id`` is taken by value, so ``tri`` may alias it
__device__ __forceinline__ void decode_id(long long id, long long proto_tris, long long& tri,
                                          long long& inst) {
  inst = id / proto_tris;
  tri = id % proto_tris;
}

}  // namespace
