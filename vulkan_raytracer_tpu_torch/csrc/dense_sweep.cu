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
// into shared memory kChunk triangles at a time, one coalesced column per
// thread, and every thread walks the chunk in ascending triangle id.  There
// is no triangle cap: any scene the dense path takes runs through the same
// loop.  Only the contract of the TPU kernels is kept (hit test, tie rule,
// t bounds); their (32, 128) ray blocks, SMEM scalar broadcasts and unrolled
// folds existed for TPU limits and are not carried over.
//
// Every thread of a block takes part in every staging step, including
// threads whose ray index is past n_rays and occlusion threads that already
// found a hit: such threads keep a "done" flag and skip the arithmetic, and
// no thread returns before the loop ends (a missed __syncthreads would
// deadlock the block or let a chunk be overwritten while still being read).
//
// Numerics.  The library is built with --fmad=false -prec-div=true
// -prec-sqrt=true and without --use_fast_math (ops/_ext.py).  nvcc would
// otherwise contract a*b+c into one FMA, which rounds differently from the
// plain PyTorch version (its ops run one at a time and are never contracted)
// and flips hits that sit on an edge or at a t tie.  With contraction off,
// the closest and occlusion sweeps are bit-equal to the plain version.  The
// pdf probe uses rsqrtf, which may differ from torch.rsqrt by an ulp, and
// sums in triangle order; it is held to a tolerance.
//
// Bounds on this card.  For bench cfg1 (Cornell, 36 triangles, 2 emissive) a
// launch sweeps ~524k rays x 36 triangles: ~19M triangle tests (~1 GFLOP)
// against ~40 B of ray I/O per ray (~21 MB), so a launch costs tens of
// microseconds and is bound by memory traffic and launch overhead, not by
// arithmetic.  Making the kernels fast (fewer bytes per ray, fusing the
// launches of one bounce) is work for a later change.
//
// Launches go on the caller's stream (PyTorch's current stream); nothing
// here synchronises or allocates.  Each launcher returns cudaGetLastError()
// and the Python wrapper raises if it is not cudaSuccess.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // rays per block
constexpr int kChunk = kThreads;  // triangles staged per step: one column per thread

struct Ray {
  float ox, oy, oz, dx, dy, dz;
};

__device__ __forceinline__ Ray load_ray(const float* __restrict__ ox, const float* __restrict__ oy,
                                        const float* __restrict__ oz, const float* __restrict__ dx,
                                        const float* __restrict__ dy, const float* __restrict__ dz,
                                        int i) {
  return Ray{ox[i], oy[i], oz[i], dx[i], dy[i], dz[i]};
}

// Copy rows [0, Rows) of triangles [base, base + kChunk) into shared memory.
// Must be called by every thread of the block.
template <int Rows>
__device__ __forceinline__ void stage(float (*s)[kChunk], const float* __restrict__ table,
                                      int n_tris, int base) {
  const int j = base + threadIdx.x;
  for (int k = 0; k < Rows; ++k) {
    s[k][threadIdx.x] = j < n_tris ? table[(size_t)k * n_tris + j] : 0.0f;
  }
}

// One Moller-Trumbore test in the operation order of
// vulkan_raytracer_tpu/ops/pallas_dense.py:55-85 (and ops/dense.py's
// plain version): same products, same left-to-right sums, IEEE divide.
__device__ __forceinline__ void mt_test(float (*s)[kChunk], int j, const Ray& r,
                                        bool& near0, float& u, float& v, float& t) {
  const float v0x = s[0][j], v0y = s[1][j], v0z = s[2][j];
  const float e1x = s[3][j], e1y = s[4][j], e1z = s[5][j];
  const float e2x = s[6][j], e2y = s[7][j], e2z = s[8][j];
  const float px = r.dy * e2z - r.dz * e2y;
  const float py = r.dz * e2x - r.dx * e2z;
  const float pz = r.dx * e2y - r.dy * e2x;
  const float det = e1x * px + e1y * py + e1z * pz;
  near0 = fabsf(det) < 1e-12f;
  const float inv = 1.0f / (near0 ? 1.0f : det);
  const float tx = r.ox - v0x;
  const float ty = r.oy - v0y;
  const float tz = r.oz - v0z;
  u = (tx * px + ty * py + tz * pz) * inv;
  const float qx = ty * e1z - tz * e1y;
  const float qy = tz * e1x - tx * e1z;
  const float qz = tx * e1y - ty * e1x;
  v = (r.dx * qx + r.dy * qy + r.dz * qz) * inv;
  t = (e2x * qx + e2y * qy + e2z * qz) * inv;
}

__device__ __forceinline__ bool inside(bool near0, float u, float v) {
  return !near0 && u >= 0.0f && v >= 0.0f && u + v <= 1.0f;
}

// Closest hit.  A hit is inside() and t_lo < t <= t_best; it replaces the
// best only if t < t_best or nothing has hit yet, so among equal t the
// lowest triangle id wins and a hit at exactly t_init still counts.
__global__ void __launch_bounds__(kThreads)
closest_kernel(const float* __restrict__ table, int n_tris,
               const float* __restrict__ ox, const float* __restrict__ oy,
               const float* __restrict__ oz, const float* __restrict__ dx,
               const float* __restrict__ dy, const float* __restrict__ dz,
               const float* __restrict__ t_lo, const float* __restrict__ t_init,
               float* __restrict__ t_out, int32_t* __restrict__ tri_out, int n_rays) {
  __shared__ float s[9][kChunk];
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool live = i < n_rays;
  Ray r{};
  float lo = 0.0f, t_best = 0.0f;
  int32_t tri_best = -1;
  if (live) {
    r = load_ray(ox, oy, oz, dx, dy, dz, i);
    lo = t_lo[i];
    t_best = t_init[i];
  }
  for (int base = 0; base < n_tris; base += kChunk) {
    __syncthreads();  // the previous chunk has been read by every thread
    stage<9>(s, table, n_tris, base);
    __syncthreads();
    if (!live) continue;
    const int n = min(kChunk, n_tris - base);
    for (int j = 0; j < n; ++j) {
      bool near0;
      float u, v, t;
      mt_test(s, j, r, near0, u, v, t);
      const bool hit = inside(near0, u, v) && t > lo && t <= t_best;
      if (hit && (t < t_best || tri_best < 0)) {
        t_best = t;
        tri_best = base + j;
      }
    }
  }
  if (live) {
    t_out[i] = t_best;
    tri_out[i] = tri_best;
  }
}

// Any-hit occlusion: 0 < t <= t_hi.  t_hi is 0 on inactive lanes, so they
// are never occluded.  A thread stops testing at its first hit.
__global__ void __launch_bounds__(kThreads)
shadow_kernel(const float* __restrict__ table, int n_tris,
              const float* __restrict__ ox, const float* __restrict__ oy,
              const float* __restrict__ oz, const float* __restrict__ dx,
              const float* __restrict__ dy, const float* __restrict__ dz,
              const float* __restrict__ t_hi, int32_t* __restrict__ occ_out, int n_rays) {
  __shared__ float s[9][kChunk];
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool live = i < n_rays;
  Ray r{};
  float hi = 0.0f;
  if (live) {
    r = load_ray(ox, oy, oz, dx, dy, dz, i);
    hi = t_hi[i];
  }
  int32_t occ = 0;
  bool done = !live || !(hi > 0.0f);  // no t can satisfy 0 < t <= hi
  for (int base = 0; base < n_tris; base += kChunk) {
    __syncthreads();
    stage<9>(s, table, n_tris, base);
    __syncthreads();
    if (done) continue;
    const int n = min(kChunk, n_tris - base);
    for (int j = 0; j < n; ++j) {
      bool near0;
      float u, v, t;
      mt_test(s, j, r, near0, u, v, t);
      if (inside(near0, u, v) && t > 0.0f && t <= hi) {
        occ = 1;
        done = true;
        break;
      }
    }
  }
  if (live) occ_out[i] = occ;
}

// Emissive-pdf probe (shaders/emissivepdf.rahit): the sum, in triangle
// order, over every emissive triangle hit with t > t_min, of
// p_delta * t^2 / max(area * |n.d|, 1e-30), with n the barycentric
// interpolation of the vertex normals normalised by rsqrt(max(|n|^2, 1e-30)).
// The sum is multiplied by the lane's gate.
__global__ void __launch_bounds__(kThreads)
pdf_kernel(const float* __restrict__ table, int n_tris,
           const float* __restrict__ ox, const float* __restrict__ oy,
           const float* __restrict__ oz, const float* __restrict__ dx,
           const float* __restrict__ dy, const float* __restrict__ dz,
           const float* __restrict__ gate, float t_min,
           float* __restrict__ pdf_out, int n_rays) {
  __shared__ float s[20][kChunk];
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool live = i < n_rays;
  Ray r{};
  if (live) r = load_ray(ox, oy, oz, dx, dy, dz, i);
  float pdf = 0.0f;
  for (int base = 0; base < n_tris; base += kChunk) {
    __syncthreads();
    stage<20>(s, table, n_tris, base);
    __syncthreads();
    if (!live) continue;
    const int n = min(kChunk, n_tris - base);
    for (int j = 0; j < n; ++j) {
      bool near0;
      float u, v, t;
      mt_test(s, j, r, near0, u, v, t);
      const bool hit = inside(near0, u, v) && t > t_min;
      const float w0 = 1.0f - u - v;
      const float nx = w0 * s[11][j] + u * s[14][j] + v * s[17][j];
      const float ny = w0 * s[12][j] + u * s[15][j] + v * s[18][j];
      const float nz = w0 * s[13][j] + u * s[16][j] + v * s[19][j];
      const float inv_len = rsqrtf(fmaxf(nx * nx + ny * ny + nz * nz, 1e-30f));
      const float cosine = fabsf(nx * r.dx + ny * r.dy + nz * r.dz) * inv_len;
      const float contrib = s[9][j] * t * t / fmaxf(s[10][j] * cosine, 1e-30f);
      pdf = pdf + (hit ? contrib : 0.0f);
    }
  }
  if (live) pdf_out[i] = pdf * gate[i];
}

inline int blocks_for(int n_rays) { return (n_rays + kThreads - 1) / kThreads; }

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
