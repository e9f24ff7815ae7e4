// Dense ray/triangle sweeps for Hopper (sm_90a): closest hit, any-hit
// occlusion and the emissive-pdf probe over every triangle of a small scene.
//
// Replaces the three Pallas kernels of vulkan_raytracer_tpu/ops/pallas_dense.py:
//   closest_kernel  <- _kernel         (pallas_dense.py:112, via pallas_closest :262)
//   shadow_kernel   <- _shadow_kernel  (pallas_dense.py:144, via pallas_shadow  :301)
//   pdf_kernel      <- _pdf_kernel     (pallas_dense.py:318, via pallas_emissive_pdf :371)
// The plain PyTorch versions of the same contracts are closest_sweep_reference,
// shadow_sweep_reference and pdf_sweep_reference in ops/dense.py.
//
// Design.  One thread walks one ray; a block holds kThreads rays.  The
// triangle table (rows of T floats: [v0.xyz, e1.xyz, e2.xyz] for the sweeps,
// plus [p_delta, area, n0.xyz, n1.xyz, n2.xyz] for the pdf probe) is staged
// into shared memory kChunk triangles at a time, each triangle as one row of
// float4s (its 9 or 20 floats in table order, zero padded to 16 bytes), so a
// test reads its constants with 3 (closest, occlusion) or, on a hit, 5 (pdf)
// 16-byte shared loads; every thread walks the chunk in ascending triangle
// id, so a warp's loads are broadcasts.  There is no triangle cap.  Only the
// contract of the TPU kernels is kept (hit test, tie rule, t bounds); their
// (32, 128) ray blocks, SMEM scalar broadcasts and unrolled folds existed for
// TPU limits and are not carried over.
//
// What bounds them.  A launch is arithmetic on the live lanes (54 operations
// per test, 36 more per pdf hit) plus ~30 B of ray I/O per lane; on the
// render most lanes of a launch are dead: inactive bounce lanes, lanes the
// alpha loop has settled, and the pdf's gate, which marks only the lanes
// that reached an emitter.  So every kernel first gathers the block's live
// rays (t_init > t_lo; t_hi > 0; gate != 0) onto its first threads
// (compact()): whole warps then carry live rays only, a block with no live
// ray stages nothing, and a dead lane's thread just writes what the
// contract gives it (t_init and -1; 0; +0) without loading its ray.  The
// Moller-Trumbore test stops after u, which decides most misses, and the
// pdf's weighted term is only evaluated on a hit.  The occlusion kernel
// stops a ray at its first hit and the block once every live ray is
// occluded.  Where a block has few live rays and the table is long, the
// occlusion and pdf kernels give each ray a warp instead of a thread.
//
// Barriers.  Every thread of a block reaches every __syncthreads: the
// decision to stage (n_live > 0) is the block's, read after a barrier, and a
// thread without a ray keeps a flag and skips the arithmetic instead of
// leaving the loop (a missed __syncthreads would deadlock the block or let a
// chunk be overwritten while still being read).
//
// Numerics.  The library is built with --fmad=false -prec-div=true
// -prec-sqrt=true and without --use_fast_math (ops/_ext.py).  nvcc would
// otherwise contract a*b+c into one FMA, which rounds differently from the
// plain PyTorch version (its ops run one at a time and are never contracted)
// and flips hits that sit on an edge or at a t tie.  With contraction off,
// the closest and occlusion sweeps are bit-equal to the plain version; the
// early exits reject only what the full test rejects.  The pdf probe uses
// rsqrtf, which may differ from torch.rsqrt by an ulp, and sums in triangle
// order; it is held to a tolerance on gated lanes and is exactly +0 where
// the gate is 0 (the plain version writes pdf * 0 there).  Without FMA a
// multiply-add issues as two instructions, so these kernels can reach at
// most half of the card's float32 peak, which counts an FMA as two
// operations.
//
// Launches go on the caller's stream (PyTorch's current stream); nothing
// here synchronises or allocates.  Each launcher returns cudaGetLastError()
// and the Python wrapper raises if it is not cudaSuccess.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // rays per block
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = kThreads;  // triangles staged per step: one row per thread
constexpr int kSweepRow = 3;  // float4 per staged triangle: 9 floats of (9, T)
constexpr int kPdfRow = 5;    // float4 per staged triangle: 20 floats of (20, T)

struct Ray {
  float ox, oy, oz, dx, dy, dz;
};

__device__ __forceinline__ Ray load_ray(const float* __restrict__ ox, const float* __restrict__ oy,
                                        const float* __restrict__ oz, const float* __restrict__ dx,
                                        const float* __restrict__ dy, const float* __restrict__ dz,
                                        int i) {
  return Ray{ox[i], oy[i], oz[i], dx[i], dy[i], dz[i]};
}

// Gather the block's live rays onto its first threads: returns n_live, the
// same for every thread, and leaves the live rays' indices in ascending
// order in ray_of[0, n_live).  Must be called by every thread of the block.
__device__ __forceinline__ int compact(bool live, int i, int* ray_of) {
  __shared__ int warp_live[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned ballot = __ballot_sync(0xffffffffu, live);
  if (lane == 0) warp_live[warp] = __popc(ballot);
  __syncthreads();
  int before = 0, n_live = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    before += w < warp ? warp_live[w] : 0;
    n_live += warp_live[w];
  }
  if (live) ray_of[before + __popc(ballot & ((1u << lane) - 1u))] = i;
  __syncthreads();
  return n_live;
}

// Copy triangles [base, base + kChunk) of a (Rows, n_tris) table into
// shared memory, one row of Row float4 per triangle.  Must be called by
// every thread of the block.
template <int Rows, int Row>
__device__ __forceinline__ void stage(float4* s, const float* __restrict__ table, int n_tris,
                                      int base) {
  const int j = base + threadIdx.x;
  if (j >= n_tris) return;
  float f[4 * Row];
#pragma unroll
  for (int k = 0; k < 4 * Row; ++k) f[k] = k < Rows ? table[(size_t)k * n_tris + j] : 0.0f;
#pragma unroll
  for (int m = 0; m < Row; ++m) {
    s[threadIdx.x * Row + m] = make_float4(f[4 * m], f[4 * m + 1], f[4 * m + 2], f[4 * m + 3]);
  }
}

// One Moller-Trumbore test of the triangle whose first three staged float4
// hold [v0.xyz, e1.xyz, e2.xyz, ...], in the operation order of
// vulkan_raytracer_tpu/ops/pallas_dense.py:55-85 (and ops/dense.py's plain
// version): same products, same left-to-right sums, IEEE divide.  Returns
// inside (det not near 0, u, v >= 0, u + v <= 1) and sets t.  It returns
// false as soon as det is near 0 or u lies outside [0, 1], before q, v and
// t: those cannot make such a triangle inside (u > 1 and v >= 0 give
// u + v > 1, since a rounded sum never falls below an addend), and a NaN u
// fails u >= 0 as it fails it in the full test.
__device__ __forceinline__ bool mt_inside(const float4 a, const float4 b, const float4 c,
                                          const Ray& r, float& u, float& v, float& t) {
  const float v0x = a.x, v0y = a.y, v0z = a.z;
  const float e1x = a.w, e1y = b.x, e1z = b.y;
  const float e2x = b.z, e2y = b.w, e2z = c.x;
  const float px = r.dy * e2z - r.dz * e2y;
  const float py = r.dz * e2x - r.dx * e2z;
  const float pz = r.dx * e2y - r.dy * e2x;
  const float det = e1x * px + e1y * py + e1z * pz;
  if (fabsf(det) < 1e-12f) return false;
  const float inv = 1.0f / det;
  const float tx = r.ox - v0x;
  const float ty = r.oy - v0y;
  const float tz = r.oz - v0z;
  u = (tx * px + ty * py + tz * pz) * inv;
  if (!(u >= 0.0f && u <= 1.0f)) return false;
  const float qx = ty * e1z - tz * e1y;
  const float qy = tz * e1x - tx * e1z;
  const float qz = tx * e1y - ty * e1x;
  v = (r.dx * qx + r.dy * qy + r.dz * qz) * inv;
  t = (e2x * qx + e2y * qy + e2z * qz) * inv;
  return v >= 0.0f && u + v <= 1.0f;
}

// Closest hit.  A hit is inside and t_lo < t <= t_best; it replaces the
// best only if t < t_best or nothing has hit yet, so among equal t the
// lowest triangle id wins and a hit at exactly t_init still counts.  A lane
// with t_init <= t_lo (or a NaN bound) cannot hit: it is dead, and its
// thread writes t_init and -1 without testing.
__global__ void __launch_bounds__(kThreads)
closest_kernel(const float* __restrict__ table, int n_tris,
               const float* __restrict__ ox, const float* __restrict__ oy,
               const float* __restrict__ oz, const float* __restrict__ dx,
               const float* __restrict__ dy, const float* __restrict__ dz,
               const float* __restrict__ t_lo, const float* __restrict__ t_init,
               float* __restrict__ t_out, int32_t* __restrict__ tri_out, int n_rays) {
  __shared__ float4 s[kChunk * kSweepRow];
  __shared__ int ray_of[kThreads];
  const int i = blockIdx.x * kThreads + threadIdx.x;
  bool live = false;
  if (i < n_rays) {
    const float init = t_init[i];
    live = init > t_lo[i];
    if (!live) {
      t_out[i] = init;
      tri_out[i] = -1;
    }
  }
  const int n_live = compact(live, i, ray_of);
  if (n_live == 0) return;  // the whole block: no thread reaches a barrier below
  const bool mine = threadIdx.x < n_live;
  const int k = mine ? ray_of[threadIdx.x] : 0;
  Ray r{};
  float lo = 0.0f, t_best = 0.0f;
  int32_t tri_best = -1;
  if (mine) {
    r = load_ray(ox, oy, oz, dx, dy, dz, k);
    lo = t_lo[k];
    t_best = t_init[k];
  }
  for (int base = 0; base < n_tris; base += kChunk) {
    __syncthreads();  // the previous chunk has been read by every thread
    stage<9, kSweepRow>(s, table, n_tris, base);
    __syncthreads();
    if (!mine) continue;
    const int n = min(kChunk, n_tris - base);
    for (int j = 0; j < n; ++j) {
      const float4* row = s + j * kSweepRow;
      float u, v, t;
      if (mt_inside(row[0], row[1], row[2], r, u, v, t) && t > lo && t <= t_best &&
          (t < t_best || tri_best < 0)) {
        t_best = t;
        tri_best = base + j;
      }
    }
  }
  if (mine) {
    t_out[k] = t_best;
    tri_out[k] = tri_best;
  }
}

inline __host__ __device__ int div_up(int a, int b) { return (a + b - 1) / b; }

// Any-hit occlusion: 1 where some triangle hits with 0 < t <= t_hi.  t_hi is
// 0 on inactive lanes: no t can satisfy 0 < t <= 0 (nor a NaN bound), so such
// a lane is dead and its thread writes 0 without loading its ray.  Occlusion
// is a flag, not a sum or a minimum: any split of the table over threads
// gives the same bit, so both paths below equal the plain version bit for bit.
//
// The block's live rays are gathered onto its first threads (compact()), so a
// block with none stages nothing.  The vote "is any ray of the block still
// testing" rides on the loop's first barrier (__syncthreads_or): once every
// live ray is occluded, all threads leave together and the rest of the table
// is neither staged nor tested.
//
// By thread: thread k walks ray k through the staged chunk and stops at its
// first hit.  By warp: each warp takes rays k = warp, warp + kWarps, ..., its
// 32 lanes test 32 triangles of the ray at once, and __any_sync ends the
// ray; which of a warp's rays are occluded is a 32-bit mask in one register
// (a warp has at most kThreads / kWarps = 32 rays).  Counted in warp-steps
// (one warp testing one triangle, or 32 of them, once), the thread path costs
// ceil(n_live / 32) * n_tris and the warp path n_live * ceil(n_tris / 32);
// the longest chain of dependent steps is n_tris against ceil(n_live /
// kWarps) * ceil(n_tris / 32).  The block goes by warp where that costs at
// most 5/4 of the thread path's steps and its chain is the shorter: few live
// rays, or a table that fills its groups of 32.  Measured on an H100 at
// 524,288 lanes (tools/bench_torch_dense.py, microseconds per launch: by
// thread only / by warp wherever its chain is shorter / this rule): 1,000
// triangles with one live lane 151 / 12 / 12, 5% live 481 / 194 / 195, 50%
// live 850 / 639 / 640; 36 triangles (two groups of 32 for 36 tests, 1.8x
// the steps) 5% live 23 / 12 / 16, 50% live 36 / 54 / 38, and the five
// launches of a Cornell-box render's wave 143 / 200 / 151 in all.
static_assert(kThreads / kWarps == 32, "a warp's rays fit one 32-bit mask");

__device__ __forceinline__ bool shadow_by_warp(int n_live, int n_tris) {
  const long long groups = div_up(n_tris, 32);
  return 4 * n_live * groups <= 5LL * div_up(n_live, 32) * n_tris &&
         div_up(n_live, kWarps) * groups < n_tris;
}

__global__ void __launch_bounds__(kThreads)
shadow_kernel(const float* __restrict__ table, int n_tris,
              const float* __restrict__ ox, const float* __restrict__ oy,
              const float* __restrict__ oz, const float* __restrict__ dx,
              const float* __restrict__ dy, const float* __restrict__ dz,
              const float* __restrict__ t_hi, int32_t* __restrict__ occ_out, int n_rays) {
  __shared__ float4 s[kChunk * kSweepRow];
  __shared__ int ray_of[kThreads];
  const int i = blockIdx.x * kThreads + threadIdx.x;
  bool live = false;
  if (i < n_rays) {
    live = t_hi[i] > 0.0f;
    if (!live) occ_out[i] = 0;
  }
  const int n_live = compact(live, i, ray_of);
  if (n_live == 0) return;  // the whole block: no thread reaches a barrier below

  if (shadow_by_warp(n_live, n_tris)) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int n_mine = warp < n_live ? div_up(n_live - warp, kWarps) : 0;  // this warp's rays
    const unsigned all = n_mine == 32 ? 0xffffffffu : (1u << n_mine) - 1u;
    unsigned occluded = 0u;  // bit q: ray_of[warp + q * kWarps] is occluded; the same on every lane
    for (int base = 0; base < n_tris; base += kChunk) {
      // also: the previous chunk has been read by every thread
      if (!__syncthreads_or(occluded != all)) break;
      stage<9, kSweepRow>(s, table, n_tris, base);
      __syncthreads();
      const int n = min(kChunk, n_tris - base);
      for (int q = 0; q < n_mine; ++q) {
        if ((occluded >> q) & 1u) continue;
        const int k = ray_of[warp + q * kWarps];
        const Ray r = load_ray(ox, oy, oz, dx, dy, dz, k);
        const float hi = t_hi[k];
        for (int j0 = 0; j0 < n; j0 += 32) {
          float u, v, t;
          const bool hit = j0 + lane < n &&
                           mt_inside(s[(j0 + lane) * kSweepRow], s[(j0 + lane) * kSweepRow + 1],
                                     s[(j0 + lane) * kSweepRow + 2], r, u, v, t) &&
                           t > 0.0f && t <= hi;
          if (__any_sync(0xffffffffu, hit)) {
            occluded |= 1u << q;
            break;
          }
        }
      }
    }
    if (lane < n_mine) occ_out[ray_of[warp + lane * kWarps]] = (occluded >> lane) & 1u;
    return;
  }

  const bool mine = threadIdx.x < n_live;
  const int k = mine ? ray_of[threadIdx.x] : 0;
  Ray r{};
  float hi = 0.0f;
  if (mine) {
    r = load_ray(ox, oy, oz, dx, dy, dz, k);
    hi = t_hi[k];
  }
  bool testing = mine;
  for (int base = 0; base < n_tris; base += kChunk) {
    // also: the previous chunk has been read by every thread
    if (!__syncthreads_or(testing)) break;
    stage<9, kSweepRow>(s, table, n_tris, base);
    __syncthreads();
    if (!testing) continue;
    const int n = min(kChunk, n_tris - base);
    for (int j = 0; j < n; ++j) {
      const float4* row = s + j * kSweepRow;
      float u, v, t;
      if (mt_inside(row[0], row[1], row[2], r, u, v, t) && t > 0.0f && t <= hi) {
        testing = false;
        break;
      }
    }
  }
  if (mine) occ_out[k] = testing ? 0 : 1;
}

// One emissive triangle's pdf term for a ray, in the operation order of
// pallas_dense.py:325-342: false on a miss (not inside,
// or t <= t_min), else the term p_delta * t^2 / max(area * |n.d|, 1e-30).
// row: the triangle's 5 staged float4, [v0.xyz, e1.x], [e1.yz, e2.xy],
// [e2z, p_delta, area, n0x], [n0y, n0z, n1x, n1y], [n1z, n2.xyz].
__device__ __forceinline__ bool pdf_term(const float4* row, const Ray& r, float t_min,
                                         float& term) {
  const float4 c = row[2];
  float u, v, t;
  if (!(mt_inside(row[0], row[1], c, r, u, v, t) && t > t_min)) return false;
  const float4 d = row[3], e = row[4];
  const float w0 = 1.0f - u - v;
  const float nx = w0 * c.w + u * d.z + v * e.y;
  const float ny = w0 * d.x + u * d.w + v * e.z;
  const float nz = w0 * d.y + u * e.x + v * e.w;
  const float inv_len = rsqrtf(fmaxf(nx * nx + ny * ny + nz * nz, 1e-30f));
  const float cosine = fabsf(nx * r.dx + ny * r.dy + nz * r.dz) * inv_len;
  term = c.y * t * t / fmaxf(c.z * cosine, 1e-30f);
  return true;
}

// Emissive-pdf probe (shaders/emissivepdf.rahit): the sum, in triangle
// order, over every emissive triangle hit with t > t_min, of
// p_delta * t^2 / max(area * |n.d|, 1e-30), with n the barycentric
// interpolation of the vertex normals normalised by rsqrt(max(|n|^2, 1e-30)),
// times the lane's gate.  A lane whose gate is 0 is dead: its thread writes
// +0 without testing.  On a live lane a missed triangle adds nothing: its
// +0.0 term would leave a sum that starts at +0 unchanged, so the result is
// the serial sum over every triangle, bit for bit.
//
// Two ways to spread a block's n_live rays over its threads, chosen per
// block (the choice is the same for every thread).  By thread: thread k
// walks ray k through all n_tris triangles, a dependent chain of n_tris
// tests.  By warp: each warp takes rays k = warp, warp + kWarps, ..., and
// its 32 lanes test 32 triangles of the ray at once; a ballot finds the
// hits and every lane adds their terms in ascending triangle order (so the
// sum is the same, bit for bit), a chain of ceil(n_live / kWarps) *
// ceil(n_tris / 32) steps.  The second wins where few rays of a block are
// live and the table is long, as on the render's probes of a large
// emissive set; both do the same number of tests.
__global__ void __launch_bounds__(kThreads)
pdf_kernel(const float* __restrict__ table, int n_tris,
           const float* __restrict__ ox, const float* __restrict__ oy,
           const float* __restrict__ oz, const float* __restrict__ dx,
           const float* __restrict__ dy, const float* __restrict__ dz,
           const float* __restrict__ gate, float t_min,
           float* __restrict__ pdf_out, int n_rays) {
  __shared__ float4 s[kChunk * kPdfRow];
  __shared__ int ray_of[kThreads];
  __shared__ float acc[kThreads];  // by warp: each live ray's running sum
  const int i = blockIdx.x * kThreads + threadIdx.x;
  bool live = false;
  if (i < n_rays) {
    live = gate[i] != 0.0f;
    if (!live) pdf_out[i] = 0.0f;
  }
  const int n_live = compact(live, i, ray_of);
  if (n_live == 0) return;  // the whole block: no thread reaches a barrier below

  if (div_up(n_live, kWarps) * div_up(n_tris, 32) < n_tris) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    if (threadIdx.x < n_live) acc[threadIdx.x] = 0.0f;
    for (int base = 0; base < n_tris; base += kChunk) {
      __syncthreads();
      stage<20, kPdfRow>(s, table, n_tris, base);
      __syncthreads();
      const int n = min(kChunk, n_tris - base);
      for (int k = warp; k < n_live; k += kWarps) {
        const Ray r = load_ray(ox, oy, oz, dx, dy, dz, ray_of[k]);
        float pdf = acc[k];
        for (int j0 = 0; j0 < n; j0 += 32) {
          float term = 0.0f;
          const bool hit = j0 + lane < n && pdf_term(s + (j0 + lane) * kPdfRow, r, t_min, term);
          for (unsigned m = __ballot_sync(0xffffffffu, hit); m != 0u; m &= m - 1u) {
            pdf = pdf + __shfl_sync(0xffffffffu, term, __ffs(m) - 1);
          }
        }
        if (lane == 0) acc[k] = pdf;
      }
    }
    __syncthreads();
    if (threadIdx.x < n_live) {
      const int k = ray_of[threadIdx.x];
      pdf_out[k] = acc[threadIdx.x] * gate[k];
    }
    return;
  }

  const bool mine = threadIdx.x < n_live;
  const int k = mine ? ray_of[threadIdx.x] : 0;
  Ray r{};
  if (mine) r = load_ray(ox, oy, oz, dx, dy, dz, k);
  float pdf = 0.0f;
  for (int base = 0; base < n_tris; base += kChunk) {
    __syncthreads();
    stage<20, kPdfRow>(s, table, n_tris, base);
    __syncthreads();
    if (!mine) continue;
    const int n = min(kChunk, n_tris - base);
    for (int j = 0; j < n; ++j) {
      float term;
      if (pdf_term(s + j * kPdfRow, r, t_min, term)) pdf = pdf + term;
    }
  }
  if (mine) pdf_out[k] = pdf * gate[k];
}

inline int blocks_for(int n_rays) { return div_up(n_rays, kThreads); }

}  // namespace

extern "C" {

const char* dense_sweep_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int dense_closest_launch(int device, const float* table, int n_tris, const float* ox,
                         const float* oy, const float* oz, const float* dx, const float* dy,
                         const float* dz, const float* t_lo, const float* t_init, float* t_out,
                         int32_t* tri_out, int n_rays, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_rays > 0) {
    closest_kernel<<<blocks_for(n_rays), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        table, n_tris, ox, oy, oz, dx, dy, dz, t_lo, t_init, t_out, tri_out, n_rays);
  }
  return static_cast<int>(cudaGetLastError());
}

int dense_shadow_launch(int device, const float* table, int n_tris, const float* ox,
                        const float* oy, const float* oz, const float* dx, const float* dy,
                        const float* dz, const float* t_hi, int32_t* occ_out, int n_rays,
                        void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_rays > 0) {
    shadow_kernel<<<blocks_for(n_rays), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        table, n_tris, ox, oy, oz, dx, dy, dz, t_hi, occ_out, n_rays);
  }
  return static_cast<int>(cudaGetLastError());
}

int dense_pdf_launch(int device, const float* table, int n_tris, const float* ox,
                     const float* oy, const float* oz, const float* dx, const float* dy,
                     const float* dz, const float* gate, float t_min, float* pdf_out,
                     int n_rays, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_rays > 0) {
    pdf_kernel<<<blocks_for(n_rays), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        table, n_tris, ox, oy, oz, dx, dy, dz, gate, t_min, pdf_out, n_rays);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
