// Threaded-BVH walks for Hopper (sm_90a): closest hit and first-hit
// occlusion over the per-octant streams of ops/traverse.py (BVHStreams).
//
// Replaces the two Pallas BVH kernels of vulkan_raytracer_tpu/ops/pallas_bvh.py:
//   bvh_walk_kernel      <- _kernel   (pallas_bvh.py:425, via _packet_sweep :672)
//   treelet_walk_kernel  <- _wkernel  (pallas_bvh.py:727, via _windowed_sweep_call :1023,
//                                      fed by the XLA glue _window_glue :1096)
// Each is templated on SHADOW, so each launches in a closest and a shadow
// variant.  Their plain PyTorch versions are bvh_walk_reference and
// treelet_walk_reference in ops/traverse.py, which use the same arithmetic
// and visit each ray's nodes in the same order.
//
// Design.  The TPU kernels walk a packet of 1024 rays with one shared cursor
// and a conservative beam test, because a TPU core has no per-lane gather.
// A Hopper thread can walk its own ray, so one thread walks one ray:
//   * the ray's own octant (bit k set <=> d[k] < 0) picks the near-child-
//     first stream, so every ray walks front to back;
//   * the walk is stackless: a node the ray enters goes to cur + 1, a node
//     it misses to miss[cur]; a leaf runs leaf_size Moller-Trumbore tests
//     (the arithmetic of pallas_bvh.py:614-636) and goes to cur + 1;
//   * a node is entered when the ray's slab interval meets [0, t_best]; the
//     far end and t_best are scaled by kRobust = 1 + 2 gamma_3 (Ize, "Robust
//     BVH Ray Traversal", JCGT 2013), so rounding never culls a box that the
//     ray touches (the dragon's ground plane has a flat box);
//   * the treelet walk slab-tests the ray against every treelet box first
//     (the glue's exact per-ray test, pallas_bvh.py:1120-1140), keeps the
//     entered ones in a per-thread list, and walks them in ascending
//     (entry, treelet id), picking the next-nearest each round and stopping
//     when its entry exceeds t_best (strictly).  A shadow ray stops at its
//     first hit.
// The TPU's tiles, beams, SMEM scalar broadcasts and DMA chunks are not
// carried over.  Dead lanes (t_init < 0) write their outputs and return at
// once: these kernels have no __syncthreads after the treelet boxes are
// staged, so an early return is safe.
//
// Numerics.  Built with --fmad=false -prec-div=true -prec-sqrt=true (see
// dense_sweep.cu), so t and the slot are bit-equal to the plain versions.
// No NaN arises: 1/d comes from the _inv_comp form (|d| < 1e-30 becomes a
// signed 1e-30), so fminf / fmaxf and torch.minimum / maximum agree.
//
// Bounds on this card.  The walk is latency-bound: each visited node is a
// dependent 24-byte load plus an 8-byte load, and a leaf is 576 bytes and 16
// Moller-Trumbore tests; threads of a warp diverge once their rays part.
// A cfg2 wave (524,288 rays over 262,280 triangles in 33,039 nodes) reads
// ~1 GB of node and leaf data if every ray visited ~100 nodes and ~30 leaves,
// most of it from L2 (the streams take ~20 MB per octant).  Making the walks
// fast (wide node layouts, ray sorting, persistent threads) is later work.
//
// Launches go on the caller's stream; nothing here synchronises or
// allocates.  Each launcher returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // rays per block
constexpr int kMaxTreelets = 128;  // ops/traverse.py MAX_TREELETS
constexpr float kRobust = 1.0f + 3.0f / 8388608.0f;  // 1 + 2 gamma_3 = 1 + 3 * 2^-23
constexpr float kTiny = 1e-30f;

struct Ray {
  float ox, oy, oz, dx, dy, dz;
  float ix, iy, iz;  // 1/d, _inv_comp form
};

__device__ __forceinline__ float inv_comp(float d) {
  return 1.0f / (fabsf(d) < kTiny ? (d < 0.0f ? -kTiny : kTiny) : d);
}

__device__ __forceinline__ Ray load_ray(const float* __restrict__ ox, const float* __restrict__ oy,
                                        const float* __restrict__ oz, const float* __restrict__ dx,
                                        const float* __restrict__ dy, const float* __restrict__ dz,
                                        int i) {
  Ray r;
  r.ox = ox[i];
  r.oy = oy[i];
  r.oz = oz[i];
  r.dx = dx[i];
  r.dy = dy[i];
  r.dz = dz[i];
  r.ix = inv_comp(r.dx);
  r.iy = inv_comp(r.dy);
  r.iz = inv_comp(r.dz);
  return r;
}

__device__ __forceinline__ int octant_of(const Ray& r) {
  return (r.dx < 0.0f ? 1 : 0) + (r.dy < 0.0f ? 2 : 0) + (r.dz < 0.0f ? 4 : 0);
}

// One slab interval: near = min, far = max of the two plane distances.
__device__ __forceinline__ void slab(float bmin, float bmax, float o, float inv, float& near,
                                     float& far) {
  const float lo = (bmin - o) * inv;
  const float hi = (bmax - o) * inv;
  near = fminf(lo, hi);
  far = fmaxf(lo, hi);
}

// The streams of one octant.
struct Stream {
  const float* __restrict__ nodes_f;  // (Nn, 6): bmin.xyz, bmax.xyz
  const int32_t* __restrict__ nodes_i;  // (Nn, 2): first_leaf, miss
  const float* __restrict__ leaves;  // (Nleaf, 9 * leaf_size)
  int leaf_size;
};

__device__ __forceinline__ Stream octant_stream(const float* nodes_f, const int32_t* nodes_i,
                                                const float* leaves, int num_nodes,
                                                int n_leaves, int leaf_size, int oct) {
  Stream s;
  s.nodes_f = nodes_f + (size_t)oct * num_nodes * 6;
  s.nodes_i = nodes_i + (size_t)oct * num_nodes * 2;
  s.leaves = leaves + (size_t)oct * n_leaves * 9 * leaf_size;
  s.leaf_size = leaf_size;
  return s;
}

// Walk stream nodes [cur, end).  Returns true when a shadow ray found its
// occluder (t_best = -1 and the walk ends).
template <bool SHADOW>
__device__ bool walk_range(const Stream& s, int cur, int end, const Ray& r, float t_lo,
                           float& t_best, int32_t& slot) {
  while (cur < end) {
    const float* nf = s.nodes_f + (size_t)cur * 6;
    float nx, fx, ny, fy, nz, fz;
    slab(nf[0], nf[3], r.ox, r.ix, nx, fx);
    slab(nf[1], nf[4], r.oy, r.iy, ny, fy);
    slab(nf[2], nf[5], r.oz, r.iz, nz, fz);
    const float near = fmaxf(fmaxf(nx, ny), fmaxf(nz, 0.0f));
    const float far = fminf(fminf(fx, fy), fz);
    const bool enter = near <= far * kRobust && near <= t_best * kRobust;
    const int32_t* ni = s.nodes_i + (size_t)cur * 2;
    if (!enter) {
      cur = ni[1];
      continue;
    }
    const int32_t leaf = ni[0];
    if (leaf >= 0) {
      const float* tri = s.leaves + (size_t)leaf * 9 * s.leaf_size;
      for (int j = 0; j < s.leaf_size; ++j, tri += 9) {
        const float v0x = tri[0], v0y = tri[1], v0z = tri[2];
        const float e1x = tri[3], e1y = tri[4], e1z = tri[5];
        const float e2x = tri[6], e2y = tri[7], e2z = tri[8];
        const float px = r.dy * e2z - r.dz * e2y;
        const float py = r.dz * e2x - r.dx * e2z;
        const float pz = r.dx * e2y - r.dy * e2x;
        const float det = e1x * px + e1y * py + e1z * pz;
        const bool near0 = fabsf(det) < 1e-12f;
        const float inv = 1.0f / (near0 ? 1.0f : det);
        const float tx = r.ox - v0x;
        const float ty = r.oy - v0y;
        const float tz = r.oz - v0z;
        const float u = (tx * px + ty * py + tz * pz) * inv;
        const float qx = ty * e1z - tz * e1y;
        const float qy = tz * e1x - tx * e1z;
        const float qz = tx * e1y - ty * e1x;
        const float v = (r.dx * qx + r.dy * qy + r.dz * qz) * inv;
        const float t = (e2x * qx + e2y * qy + e2z * qz) * inv;
        const bool hit = !near0 && u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t > t_lo &&
                         t <= t_best;
        if (SHADOW) {
          if (hit) {  // any accepted hit occludes (lightsample.glsl:27)
            t_best = -1.0f;
            slot = leaf * s.leaf_size + j;
            return true;
          }
        } else if (hit && (t < t_best || slot < 0)) {
          t_best = t;
          slot = leaf * s.leaf_size + j;
        }
      }
    }
    ++cur;
  }
  return false;
}

// K4': walk the ray's whole octant stream.
template <bool SHADOW>
__global__ void __launch_bounds__(kThreads)
bvh_walk_kernel(const float* __restrict__ nodes_f, const int32_t* __restrict__ nodes_i,
                const float* __restrict__ leaves, int num_nodes, int n_leaves, int leaf_size,
                const float* __restrict__ ox, const float* __restrict__ oy,
                const float* __restrict__ oz, const float* __restrict__ dx,
                const float* __restrict__ dy, const float* __restrict__ dz,
                const float* __restrict__ t_lo, const float* __restrict__ t_init,
                float* __restrict__ t_out, int32_t* __restrict__ slot_out, int n_rays) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n_rays) return;
  float t_best = t_init[i];
  int32_t slot = -1;
  if (t_best >= 0.0f) {
    const Ray r = load_ray(ox, oy, oz, dx, dy, dz, i);
    const Stream s =
        octant_stream(nodes_f, nodes_i, leaves, num_nodes, n_leaves, leaf_size, octant_of(r));
    walk_range<SHADOW>(s, 0, num_nodes, r, t_lo[i], t_best, slot);
  }
  t_out[i] = t_best;
  slot_out[i] = slot;
}

// K5': walk the treelets the ray enters, nearest entry first.
template <bool SHADOW>
__global__ void __launch_bounds__(kThreads)
treelet_walk_kernel(const float* __restrict__ nodes_f, const int32_t* __restrict__ nodes_i,
                    const float* __restrict__ leaves, int num_nodes, int n_leaves,
                    int leaf_size, const float* __restrict__ tl_box,
                    const int32_t* __restrict__ tl_lim, int n_treelets,
                    const float* __restrict__ ox, const float* __restrict__ oy,
                    const float* __restrict__ oz, const float* __restrict__ dx,
                    const float* __restrict__ dy, const float* __restrict__ dz,
                    const float* __restrict__ t_lo, const float* __restrict__ t_init,
                    float* __restrict__ t_out, int32_t* __restrict__ slot_out, int n_rays) {
  __shared__ float box[kMaxTreelets * 6];
  for (int k = threadIdx.x; k < n_treelets * 6; k += kThreads) box[k] = tl_box[k];
  __syncthreads();  // the only barrier: every thread reaches it

  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n_rays) return;
  float t_best = t_init[i];
  int32_t slot = -1;
  if (t_best >= 0.0f) {
    const Ray r = load_ray(ox, oy, oz, dx, dy, dz, i);
    const float lo = t_lo[i];
    const int oct = octant_of(r);

    // entered treelets, in treelet-id order
    float entry[kMaxTreelets];
    uint8_t tid[kMaxTreelets];
    int m = 0;
    for (int k = 0; k < n_treelets; ++k) {
      const float* b = box + 6 * k;
      float nx, fx, ny, fy, nz, fz;
      slab(b[0], b[3], r.ox, r.ix, nx, fx);
      slab(b[1], b[4], r.oy, r.iy, ny, fy);
      slab(b[2], b[5], r.oz, r.iz, nz, fz);
      const float near = fmaxf(fmaxf(nx, ny), nz);
      const float far = fminf(fminf(fx, fy), fz);
      if (near <= far && far >= lo && near <= t_best) {
        entry[m] = near > 0.0f ? near : 0.0f;
        tid[m] = static_cast<uint8_t>(k);
        ++m;
      }
    }

    const Stream s =
        octant_stream(nodes_f, nodes_i, leaves, num_nodes, n_leaves, leaf_size, oct);
    const int32_t* lim = tl_lim + (size_t)oct * n_treelets * 2;
    while (m > 0) {
      int b = 0;  // the least (entry, treelet id) left
      for (int q = 1; q < m; ++q) {
        if (entry[q] < entry[b] || (entry[q] == entry[b] && tid[q] < tid[b])) b = q;
      }
      const float e = entry[b];
      const int k = tid[b];
      --m;
      entry[b] = entry[m];
      tid[b] = tid[m];
      if (e > t_best) break;  // every later entry is >= e
      if (walk_range<SHADOW>(s, lim[2 * k], lim[2 * k + 1], r, lo, t_best, slot)) break;
    }
  }
  t_out[i] = t_best;
  slot_out[i] = slot;
}

inline int blocks_for(int n_rays) { return (n_rays + kThreads - 1) / kThreads; }

}  // namespace

extern "C" {

int bvh_walk_launch(int device, int shadow, const float* nodes_f, const int32_t* nodes_i,
                    const float* leaves, int num_nodes, int n_leaves, int leaf_size,
                    const float* ox, const float* oy, const float* oz, const float* dx,
                    const float* dy, const float* dz, const float* t_lo, const float* t_init,
                    float* t_out, int32_t* slot_out, int n_rays, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_rays > 0) {
    auto kernel = shadow ? bvh_walk_kernel<true> : bvh_walk_kernel<false>;
    kernel<<<blocks_for(n_rays), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        nodes_f, nodes_i, leaves, num_nodes, n_leaves, leaf_size, ox, oy, oz, dx, dy, dz, t_lo,
        t_init, t_out, slot_out, n_rays);
  }
  return static_cast<int>(cudaGetLastError());
}

int treelet_walk_launch(int device, int shadow, const float* nodes_f, const int32_t* nodes_i,
                        const float* leaves, int num_nodes, int n_leaves, int leaf_size,
                        const float* tl_box, const int32_t* tl_lim, int n_treelets,
                        const float* ox, const float* oy, const float* oz, const float* dx,
                        const float* dy, const float* dz, const float* t_lo,
                        const float* t_init, float* t_out, int32_t* slot_out, int n_rays,
                        void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_treelets < 1 || n_treelets > kMaxTreelets) return static_cast<int>(cudaErrorInvalidValue);
  if (n_rays > 0) {
    auto kernel = shadow ? treelet_walk_kernel<true> : treelet_walk_kernel<false>;
    kernel<<<blocks_for(n_rays), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        nodes_f, nodes_i, leaves, num_nodes, n_leaves, leaf_size, tl_box, tl_lim, n_treelets,
        ox, oy, oz, dx, dy, dz, t_lo, t_init, t_out, slot_out, n_rays);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
