// The closest hit's finish of one found lane, shared by hit_finish_kernel
// (csrc/trace.cu: every lane of an opaque closest-hit call) and
// alpha_commit_kernel (csrc/wave.cu: the pending lanes of a resample pass),
// so the two round alike: both are built with the flags of ops/_ext.py
// (--fmad=false), and both are bit-equal to ops/trace.py
// hit_finish_reference.
//
// A traversal launch hands back, per lane, t and what it hit: K1's triangle
// (kDense), a BVH walk's leaf slot (kBvh), or after an instance scan the
// encoded (instance, prototype triangle) id (kInstanced); a negative value is
// a miss.  The finish of a hit maps it to the scene's triangle (a slot through
// the walk's slot -> triangle table; an encoded id stays what it is) and
// recomputes the winner's (u, v) from its three vertices, an instanced winner
// in its instance's object space (the instance's 12 world->object values).
// The reads: the slot's triangle (4 bytes), the triangle's 9 vertex floats
// (36) and an instance's map (48).

#pragma once

#include "lane_math.cuh"

namespace {

// What the traversal's hit id holds (ops/trace.py FINISH_MODES)
enum Finish { kDense, kBvh, kInstanced };

// The tables a finish reads
struct FinishTables {
  const float* v[9];      // v0.x, v0.y, v0.z, v1.x, ... v2.z, one float a triangle
  const int* tri_id;      // kBvh: a slot's triangle
  const float* inv_flat;  // kInstanced: the instances' world->object rows, (12, num_inst)
  long long proto_tris;   // kInstanced: triangles of the prototypes, the id's divisor
  long long num_inst;     // kInstanced: instances
  int mode;               // enum Finish
};

__device__ __forceinline__ V3 finish_vertex(const FinishTables& f, int first, long long t) {
  return {f.v[first][t], f.v[first + 1][t], f.v[first + 2][t]};
}

// trace._apply_affine / _apply_linear: a 3x4 row-major map, rows left to right
__device__ __forceinline__ V3 affine(const float* m, V3 p) {
  return {m[0] * p.x + m[1] * p.y + m[2] * p.z + m[3], m[4] * p.x + m[5] * p.y + m[6] * p.z + m[7],
          m[8] * p.x + m[9] * p.y + m[10] * p.z + m[11]};
}

__device__ __forceinline__ V3 linear(const float* m, V3 v) {
  return {m[0] * v.x + m[1] * v.y + m[2] * v.z, m[4] * v.x + m[5] * v.y + m[6] * v.z,
          m[8] * v.x + m[9] * v.y + m[10] * v.z};
}

// trace.winner_uv's Moller-Trumbore (u, v) of triangle ti for the ray (o, d)
__device__ __forceinline__ void winner_uv(const FinishTables& f, long long ti, V3 o, V3 d,
                                          float& u, float& v) {
  const V3 v0 = finish_vertex(f, 0, ti);
  const V3 e1 = sub(finish_vertex(f, 3, ti), v0);
  const V3 e2 = sub(finish_vertex(f, 6, ti), v0);
  const V3 pvec = cross(d, e2);
  const float det = dot(e1, pvec);
  const float inv = rcp(fabsf(det) < K(1e-12) ? 1.0f : det);
  const V3 tvec = sub(o, v0);
  u = dot(tvec, pvec) * inv;
  v = dot(d, cross(tvec, e1)) * inv;
}

// The finish of a found lane (hit >= 0) whose world ray is (o, d): returns
// its triangle (the scene's; kInstanced: the encoded id) and sets the
// winner's (u, v) and, for the alpha test, `proto`, the triangle whose rows
// the tables hold (the prototype's under kInstanced).
__device__ __forceinline__ int finish_hit(const FinishTables& f, int hit, V3 o, V3 d, float& u,
                                          float& v, long long& proto) {
  long long ti = hit;
  int tri = hit;
  if (f.mode == kBvh) {  // slot -> scene triangle
    tri = f.tri_id[hit];
    ti = tri < 0 ? 0 : tri;  // winner_uv's clamp
  } else if (f.mode == kInstanced) {  // encoded id -> prototype triangle, in its object space
    long long inst;
    decode_id(hit, f.proto_tris, ti, inst);
    inst = inst < f.num_inst - 1 ? inst : f.num_inst - 1;
    float m[12];
#pragma unroll
    for (int k = 0; k < 12; ++k) m[k] = f.inv_flat[k * f.num_inst + inst];
    o = affine(m, o);
    d = linear(m, d);
  }
  winner_uv(f, ti, o, d, u, v);
  proto = ti;
  return tri;
}

}  // namespace
