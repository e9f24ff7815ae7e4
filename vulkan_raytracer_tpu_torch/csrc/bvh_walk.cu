// Threaded-BVH walks for Hopper (sm_90a): closest hit and first-hit
// occlusion over the streams of ops/traverse.py (BVHStreams).
//
// Replaces the two Pallas BVH kernels of vulkan_raytracer_tpu/ops/pallas_bvh.py:
//   bvh_walk_kernel      <- _kernel   (pallas_bvh.py:425, via _packet_sweep :672)
//   treelet_walk_kernel  <- _wkernel  (pallas_bvh.py:727, via _windowed_sweep_call :1023,
//                                      fed by the XLA glue _window_glue :1096)
// Each is templated on SHADOW, so each launches in a closest and a shadow
// variant.  Their plain PyTorch versions are bvh_walk_reference and
// treelet_walk_reference in ops/traverse.py, which use the same arithmetic
// and visit each ray's nodes and triangles in the same order.
//
// Contract.  The TPU kernels walk a packet of 1024 rays with one shared
// cursor and a conservative beam test, because a TPU core has no per-lane
// gather.  A Hopper thread can walk its own ray, so one thread walks one ray:
//   * the ray's own octant (bit k set <=> d[k] < 0) picks the near-child-
//     first node stream, so every ray walks front to back;
//   * the walk is stackless: a node the ray enters goes to cur + 1, a node
//     it misses to its skip pointer (a leaf's is cur + 1); a leaf tests its
//     real triangles (the arithmetic of pallas_bvh.py:614-636);
//   * a node is entered when the ray's slab interval meets [0, t_best]; the
//     far end and t_best are scaled by kRobust = 1 + 2 gamma_3 (Ize, "Robust
//     BVH Ray Traversal", JCGT 2013), so rounding never culls a box that the
//     ray touches (the dragon's ground plane has a flat box);
//   * the treelet walk applies the glue's exact per-ray test to the treelet
//     boxes (pallas_bvh.py:1120-1140) and walks the entered treelets in
//     ascending (entry, treelet id), stopping when the next entry exceeds
//     t_best (strictly).  A shadow ray stops at its first hit.
//
// What bounds the walks on this card.  Per ray of a cfg2 wave the walks make
// ~30-60 slab tests and ~40 triangle tests (walk_visits in ops/traverse.py
// counts them): ~2 GFLOP for a 524,288-ray wave, ~30 us at the float32 peak,
// against ~40 MB of ray columns and stream rows, ~13 us at the memory rate.
// The kernels take ~50x that (PERF.md): a walk is a chain of dependent loads,
// the next node known only once the current one has been read and tested,
// and the rays of a warp part ways, so latency, divergence and occupancy
// bound them rather than bytes or operations.  What the design does:
//   * the streams fit in L2 (50 MB): the triangles are kept once in one
//     table that the eight octant streams share (the TPU streamed one copy
//     per octant, 8x the bytes), so the dragon's streams take ~22 MB;
//   * every record is read with 16-byte loads through the read-only path:
//     a node is one 32-byte record, (bmin.xyz, leaf) and (bmax.xyz, link),
//     two float4 loads; a triangle is three float4 (v0, e1, e2, each padded
//     to 16 bytes);
//   * a leaf's node record holds its count of real triangles, so padding
//     slots are never tested (44% of the slots of a 147k-triangle glTF);
//   * the treelet walk keeps no per-thread array: the entered treelets are a
//     128-bit mask in four registers and the kList nearest not yet walked a
//     sorted list in registers, refilled from the mask (recomputing their
//     entries from the boxes in shared memory) when it runs out.  Entries
//     beyond t_best are dropped at a refill: t_best only falls, so the walk
//     would stop at them.  The order of walked treelets is exactly the
//     glue's.  The boxes are tested group by group: a ray that misses a
//     group's union box misses each of its boxes (rounding is monotone), so
//     the group's kGroup tests are skipped and the entered set is unchanged.
//     Its registers set its occupancy: kList = 2 with kMinBlocks = 4 was the
//     fastest setting without spills of those timed (tools/bench_torch_walks.py);
//   * one turn of the treelet walk's loop tests one node, and a lane past
//     its treelet's range takes the next treelet in the same turn, so the
//     lanes of a warp stay in step node by node, as in the whole-stream walk;
//   * a block whose lanes are all dead writes its outputs before staging the
//     boxes (the alpha loop re-launches waves with few pending lanes).
//
// Numerics.  Built with --fmad=false -prec-div=true -prec-sqrt=true (see
// dense_sweep.cu), so t and the slot are bit-equal to the plain versions.
// No NaN arises: 1/d comes from the _inv_comp form (|d| < 1e-30 becomes a
// signed 1e-30), so fminf / fmaxf and torch.minimum / maximum agree.
//
// The emissive-pdf walk.  emissive_walk_kernel replaces trace_emissive_pdf
// (vulkan_raytracer_tpu/ops/traverse.py:241), an XLA while_loop in which all
// lanes of a wave step together until the slowest is through, with a gather
// per step; it is not a Pallas kernel, but it is on the render path of every
// scene with more than 1,024 emissive triangles (the MIS probe of each bounce
// and the NEE probe), and a lockstep tensor walk is hundreds of times slower
// here than a walk per ray.  Its plain version is
// emissive_pdf_walk_reference in ops/traverse.py.  One thread walks one ray
// through the emissive-only tree (EmissiveStream: the node records above in
// the tree's own preorder, and one 80-byte row per real leaf slot with the
// triangle, its p_delta, area and vertex normals, so a hit reads nothing
// else) and adds every hit's term; no stack, no octant (a sum has no
// front-to-back order to exploit).  The probes' live lanes are sparse (the
// lanes that reached an emitter, or whose light sample is visible), so a
// block gathers its live rays onto its first threads first, as the dense
// kernels do, and a block with none returns.  What bounds it is what bounds
// the other walks: the dependent loads of a chain of nodes.  Its contract is
// the JAX function's, not the dense pdf kernel's (see ops/traverse.py); the
// sum runs in visit order, a leaf's terms first, as the plain version adds
// them, and is held to a tolerance against it (and against JAX).
//
// Launches go on the caller's stream; nothing here synchronises or
// allocates.  Each launcher returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // rays per block
constexpr int kMaxTreelets = 128;  // ops/traverse.py MAX_TREELETS
constexpr int kGroup = 8;  // treelets per group box, ops/traverse.py TREELET_GROUP
constexpr int kMaxGroups = kMaxTreelets / kGroup;
constexpr int kList = 2;  // nearest entered treelets held in registers
constexpr int kMinBlocks = 4;  // treelet walk: at most 65536 / (4 * 128) = 128 registers
constexpr int kNone = 0x7fffffff;  // an empty list slot's treelet id
constexpr int kOccluded = 0x7fffffff;  // the next node after a shadow ray's occluder
constexpr float kRobust = 1.0f + 3.0f / 8388608.0f;  // 1 + 2 gamma_3 = 1 + 3 * 2^-23
constexpr float kTiny = 1e-30f;
static_assert(32 % kGroup == 0, "a group's treelets lie in one mask word");

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

// The glue's box test (pallas_bvh.py:1120-1140) against b = (bmin.xyz,
// bmax.xyz): whether the ray enters it, and its entry max(near, 0).
__device__ __forceinline__ bool box_enters(const float* b, const Ray& r, float t_lo, float t_hi,
                                           float& entry) {
  float nx, fx, ny, fy, nz, fz;
  slab(b[0], b[3], r.ox, r.ix, nx, fx);
  slab(b[1], b[4], r.oy, r.iy, ny, fy);
  slab(b[2], b[5], r.oz, r.iz, nz, fz);
  const float near = fmaxf(fmaxf(nx, ny), nz);
  const float far = fminf(fminf(fx, fy), fz);
  entry = near > 0.0f ? near : 0.0f;
  return near <= far && far >= t_lo && near <= t_hi;
}

// One step of a walk: the slab test of node cur of one octant's stream and,
// when the ray enters a leaf, the leaf's triangles.  nodes: 2 float4 per
// node, (bmin.xyz, leaf) and (bmax.xyz, link) with leaf and link int32 bit
// patterns; tris: 3 float4 per triangle (v0, e1, e2).  Returns the next
// node, or kOccluded when a shadow ray found its occluder (t_best = -1).
template <bool SHADOW>
__device__ __forceinline__ int walk_node(const float4* __restrict__ nodes,
                                         const float4* __restrict__ tris, int cur, const Ray& r,
                                         float t_lo, float& t_best, int32_t& slot) {
  const float4 lo = __ldg(nodes + 2 * cur);
  const float4 hi = __ldg(nodes + 2 * cur + 1);
  float nx, fx, ny, fy, nz, fz;
  slab(lo.x, hi.x, r.ox, r.ix, nx, fx);
  slab(lo.y, hi.y, r.oy, r.iy, ny, fy);
  slab(lo.z, hi.z, r.oz, r.iz, nz, fz);
  const float near = fmaxf(fmaxf(nx, ny), fmaxf(nz, 0.0f));
  const float far = fminf(fminf(fx, fy), fz);
  const bool enter = near <= far * kRobust && near <= t_best * kRobust;
  const int32_t leaf = __float_as_int(lo.w);  // first triangle, or -1: interior
  const int32_t link = __float_as_int(hi.w);  // a leaf's count, else the skip pointer
  if (enter && leaf >= 0) {
    const float4* tri = tris + 3 * (size_t)leaf;
    for (int j = 0; j < link; ++j, tri += 3) {
      const float4 a = __ldg(tri);
      const float4 b = __ldg(tri + 1);
      const float4 c = __ldg(tri + 2);
      const float px = r.dy * c.z - r.dz * c.y;
      const float py = r.dz * c.x - r.dx * c.z;
      const float pz = r.dx * c.y - r.dy * c.x;
      const float det = b.x * px + b.y * py + b.z * pz;
      const bool near0 = fabsf(det) < 1e-12f;
      const float inv = 1.0f / (near0 ? 1.0f : det);
      const float tx = r.ox - a.x;
      const float ty = r.oy - a.y;
      const float tz = r.oz - a.z;
      const float u = (tx * px + ty * py + tz * pz) * inv;
      const float qx = ty * b.z - tz * b.y;
      const float qy = tz * b.x - tx * b.z;
      const float qz = tx * b.y - ty * b.x;
      const float v = (r.dx * qx + r.dy * qy + r.dz * qz) * inv;
      const float t = (c.x * qx + c.y * qy + c.z * qz) * inv;
      const bool hit = !near0 && u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t > t_lo &&
                       t <= t_best;
      if (SHADOW) {
        if (hit) {  // any accepted hit occludes (lightsample.glsl:27)
          t_best = -1.0f;
          slot = leaf + j;
          return kOccluded;
        }
      } else if (hit && (t < t_best || slot < 0)) {
        t_best = t;
        slot = leaf + j;
      }
    }
  }
  return enter || leaf >= 0 ? cur + 1 : link;
}

// K4': walk the ray's whole octant stream.
template <bool SHADOW>
__global__ void __launch_bounds__(kThreads)
bvh_walk_kernel(const float4* __restrict__ nodes, const float4* __restrict__ tris, int num_nodes,
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
    const float lo = t_lo[i];
    const float4* stream = nodes + (size_t)octant_of(r) * num_nodes * 2;
    for (int cur = 0; cur < num_nodes;) {
      cur = walk_node<SHADOW>(stream, tris, cur, r, lo, t_best, slot);
    }
  }
  t_out[i] = t_best;
  slot_out[i] = slot;
}

// 128 bits in four registers; a word is chosen by selects, never by an
// index into memory.
struct Mask128 {
  uint32_t a, b, c, d;
  __device__ __forceinline__ uint32_t get(int w) const {
    return w == 0 ? a : w == 1 ? b : w == 2 ? c : d;
  }
  __device__ __forceinline__ void put(int w, uint32_t v) {
    a = w == 0 ? v : a;
    b = w == 1 ? v : b;
    c = w == 2 ? v : c;
    d = w == 3 ? v : d;
  }
};

// The kList least (entry, treelet id) pairs inserted, ascending.  Every
// loop is unrolled, so each slot is a register.
struct NearList {
  float e[kList];
  int k[kList];
  __device__ __forceinline__ void clear() {
#pragma unroll
    for (int q = 0; q < kList; ++q) {
      e[q] = __int_as_float(0x7f800000);
      k[q] = kNone;
    }
  }
  __device__ __forceinline__ bool empty() const { return k[0] == kNone; }
  __device__ __forceinline__ void insert(float ee, int kk) {
#pragma unroll
    for (int q = 0; q < kList; ++q) {
      const bool before = ee < e[q] || (ee == e[q] && kk < k[q]);
      const float te = e[q];
      const int tk = k[q];
      e[q] = before ? ee : te;
      k[q] = before ? kk : tk;
      ee = before ? te : ee;
      kk = before ? tk : kk;
    }
  }
  __device__ __forceinline__ void pop() {
#pragma unroll
    for (int q = 0; q + 1 < kList; ++q) {
      e[q] = e[q + 1];
      k[q] = k[q + 1];
    }
    e[kList - 1] = __int_as_float(0x7f800000);
    k[kList - 1] = kNone;
  }
};

// K5': walk the treelets the ray enters, nearest entry first.  The bound of
// kMinBlocks blocks per SM lets ptxas keep the list and the mask in registers
// (without it, it spills a few of them to the stack).
template <bool SHADOW>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
treelet_walk_kernel(const float4* __restrict__ nodes, const float4* __restrict__ tris,
                    int num_nodes, const float* __restrict__ tl_box,
                    const float* __restrict__ tl_group, const int32_t* __restrict__ tl_lim,
                    int n_treelets, const float* __restrict__ ox, const float* __restrict__ oy,
                    const float* __restrict__ oz, const float* __restrict__ dx,
                    const float* __restrict__ dy, const float* __restrict__ dz,
                    const float* __restrict__ t_lo, const float* __restrict__ t_init,
                    float* __restrict__ t_out, int32_t* __restrict__ slot_out, int n_rays) {
  __shared__ float box[kMaxTreelets * 6];
  __shared__ float group[kMaxGroups * 6];
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool live = i < n_rays;
  float t_best = live ? t_init[i] : -1.0f;
  int32_t slot = -1;
  // Every thread reaches both barriers: the condition is the block's.
  if (__syncthreads_or(t_best >= 0.0f)) {
    const int n_groups = (n_treelets + kGroup - 1) / kGroup;
    for (int q = threadIdx.x; q < n_treelets * 6; q += kThreads) box[q] = tl_box[q];
    for (int q = threadIdx.x; q < n_groups * 6; q += kThreads) group[q] = tl_group[q];
    __syncthreads();
    if (t_best >= 0.0f) {
      const Ray r = load_ray(ox, oy, oz, dx, dy, dz, i);
      const float lo = t_lo[i];
      const int oct = octant_of(r);

      // the entered treelets: all in the mask, the nearest in the list
      NearList list;
      list.clear();
      Mask128 mask{0u, 0u, 0u, 0u};
      for (int g = 0; g < n_groups; ++g) {
        float e;
        if (!box_enters(group + 6 * g, r, lo, t_best, e)) continue;
        uint32_t bits = 0;
        const int k_end = min(kGroup * (g + 1), n_treelets);
        for (int k = kGroup * g; k < k_end; ++k) {
          if (box_enters(box + 6 * k, r, lo, t_best, e)) {
            bits |= 1u << (k & 31);
            list.insert(e, k);
          }
        }
        const int w = g / (32 / kGroup);
        mask.put(w, mask.get(w) | bits);
      }

      // One node per turn of the loop, a new treelet whenever the ray is
      // past its range: the lanes of a warp stay in step node by node
      // rather than treelet by treelet.
      const float4* stream = nodes + (size_t)oct * num_nodes * 2;
      const int32_t* lim = tl_lim + (size_t)oct * n_treelets * 2;
      int cur = 0, end = 0;
      while (true) {
        if (cur >= end) {
          if (SHADOW && cur == kOccluded) break;
          if (list.empty()) {  // refill with the nearest entered treelets not yet walked
            for (int w = 0; w < 4; ++w) {
              uint32_t bits = mask.get(w), keep = 0;
              while (bits) {
                const int b = __ffs(bits) - 1;
                bits &= bits - 1;
                float e;
                box_enters(box + 6 * (32 * w + b), r, lo, t_best, e);
                if (!(e > t_best)) {
                  keep |= 1u << b;
                  list.insert(e, 32 * w + b);
                }
              }
              mask.put(w, keep);
            }
            if (list.empty()) break;
          }
          const float e = list.e[0];
          const int k = list.k[0];
          list.pop();
          mask.put(k >> 5, mask.get(k >> 5) & ~(1u << (k & 31)));
          if (e > t_best) break;  // every later entry is >= e
          cur = lim[2 * k];
          end = lim[2 * k + 1];
        }
        cur = walk_node<SHADOW>(stream, tris, cur, r, lo, t_best, slot);
      }
    }
  }
  if (live) {
    t_out[i] = t_best;
    slot_out[i] = slot;
  }
}

// 1/d of the emissive walk: safe_inv_dir (ops/intersect.py:20), |d| < 1e-20
// becomes a signed 1e-20.
__device__ __forceinline__ float safe_inv(float d) {
  return 1.0f / (fabsf(d) < 1e-20f ? (d < 0.0f ? -1e-20f : 1e-20f) : d);
}

constexpr float kPdfTMax = 1e32f;  // the far end of the probe's ray extent
constexpr int kWarpsPerBlock = kThreads / 32;

// The emissive-pdf walk: per active ray, the sum over every emissive triangle
// hit with t_min < t <= 1e32 of p_delta * t^2 / max(area * |n.d|, 1e-30), n
// the interpolated vertex normal over max(|n|, 1e-20); inactive lanes get 0.
// nodes: 2 float4 per node as in walk_node; rows: 5 float4 per real leaf slot,
// [v0.xyz, e1.x], [e1.yz, e2.xy], [e2.z, p_delta, area, n0.x], [n0.yz, n1.xy],
// [n1.z, n2.xyz].  A node is entered when tnear <= tfar, tfar >= t_min and
// tnear <= 1e32 (ray_aabb, ops/intersect.py:31).
__global__ void __launch_bounds__(kThreads)
emissive_walk_kernel(const float4* __restrict__ nodes, const float4* __restrict__ rows,
                     int num_nodes, const float* __restrict__ ox, const float* __restrict__ oy,
                     const float* __restrict__ oz, const float* __restrict__ dx,
                     const float* __restrict__ dy, const float* __restrict__ dz,
                     const uint8_t* __restrict__ active, float t_min,
                     float* __restrict__ pdf_out, int n_rays) {
  __shared__ int warp_live[kWarpsPerBlock];
  __shared__ int ray_of[kThreads];
  const int i = blockIdx.x * kThreads + threadIdx.x;
  bool live = false;
  if (i < n_rays) {
    live = active[i] != 0;
    if (!live) pdf_out[i] = 0.0f;
  }
  // gather the block's live rays onto its first threads; every thread reaches
  // both barriers
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned ballot = __ballot_sync(0xffffffffu, live);
  if (lane == 0) warp_live[warp] = __popc(ballot);
  __syncthreads();
  int before = 0, n_live = 0;
#pragma unroll
  for (int w = 0; w < kWarpsPerBlock; ++w) {
    before += w < warp ? warp_live[w] : 0;
    n_live += warp_live[w];
  }
  if (live) ray_of[before + __popc(ballot & ((1u << lane) - 1u))] = i;
  __syncthreads();
  if (threadIdx.x >= n_live) return;  // no barrier below

  const int k = ray_of[threadIdx.x];
  const float rox = ox[k], roy = oy[k], roz = oz[k];
  const float rdx = dx[k], rdy = dy[k], rdz = dz[k];
  const float ix = safe_inv(rdx), iy = safe_inv(rdy), iz = safe_inv(rdz);
  float pdf = 0.0f;
  for (int cur = 0; cur < num_nodes;) {
    const float4 lo = __ldg(nodes + 2 * cur);
    const float4 hi = __ldg(nodes + 2 * cur + 1);
    float nx, fx, ny, fy, nz, fz;
    slab(lo.x, hi.x, rox, ix, nx, fx);
    slab(lo.y, hi.y, roy, iy, ny, fy);
    slab(lo.z, hi.z, roz, iz, nz, fz);
    const float near = fmaxf(fmaxf(nx, ny), nz);
    const float far = fminf(fminf(fx, fy), fz);
    const bool enter = near <= far && far >= t_min && near <= kPdfTMax;
    const int32_t leaf = __float_as_int(lo.w);  // first row, or -1: interior
    const int32_t link = __float_as_int(hi.w);  // a leaf's count, else the skip pointer
    if (enter && leaf >= 0) {
      float leaf_sum = 0.0f;
      const float4* row = rows + 5 * (size_t)leaf;
      for (int j = 0; j < link; ++j, row += 5) {
        const float4 a = __ldg(row);      // v0.xyz, e1.x
        const float4 b = __ldg(row + 1);  // e1.yz, e2.xy
        const float4 c = __ldg(row + 2);  // e2.z, p_delta, area, n0.x
        const float px = rdy * c.x - rdz * b.w;
        const float py = rdz * b.z - rdx * c.x;
        const float pz = rdx * b.w - rdy * b.z;
        const float det = a.w * px + b.x * py + b.y * pz;
        if (fabsf(det) < 1e-12f) continue;
        const float inv = 1.0f / det;
        const float tx = rox - a.x;
        const float ty = roy - a.y;
        const float tz = roz - a.z;
        const float u = (tx * px + ty * py + tz * pz) * inv;
        const float qx = ty * b.y - tz * b.x;
        const float qy = tz * a.w - tx * b.y;
        const float qz = tx * b.x - ty * a.w;
        const float v = (rdx * qx + rdy * qy + rdz * qz) * inv;
        const float t = (b.z * qx + b.w * qy + c.x * qz) * inv;
        if (!(u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t > t_min && t <= kPdfTMax)) continue;
        const float4 d = __ldg(row + 3);  // n0.yz, n1.xy
        const float4 e = __ldg(row + 4);  // n1.z, n2.xyz
        const float w0 = 1.0f - u - v;
        const float mx = w0 * c.w + u * d.z + v * e.y;
        const float my = w0 * d.x + u * d.w + v * e.z;
        const float mz = w0 * d.y + u * e.x + v * e.w;
        const float len = fmaxf(sqrtf(mx * mx + my * my + mz * mz), 1e-20f);
        const float cosine = fabsf(mx / len * rdx + my / len * rdy + mz / len * rdz);
        leaf_sum = leaf_sum + c.y * t * t / fmaxf(c.z * cosine, 1e-30f);
      }
      pdf = pdf + leaf_sum;
    }
    cur = enter || leaf >= 0 ? cur + 1 : link;
  }
  pdf_out[k] = pdf;
}

inline int blocks_for(int n_rays) { return (n_rays + kThreads - 1) / kThreads; }

}  // namespace

extern "C" {

int bvh_walk_launch(int device, int shadow, const float* nodes, const float* tris, int num_nodes,
                    const float* ox, const float* oy, const float* oz, const float* dx,
                    const float* dy, const float* dz, const float* t_lo, const float* t_init,
                    float* t_out, int32_t* slot_out, int n_rays, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_rays > 0) {
    auto kernel = shadow ? bvh_walk_kernel<true> : bvh_walk_kernel<false>;
    kernel<<<blocks_for(n_rays), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        reinterpret_cast<const float4*>(nodes), reinterpret_cast<const float4*>(tris),
        num_nodes, ox, oy, oz, dx, dy, dz, t_lo, t_init, t_out, slot_out, n_rays);
  }
  return static_cast<int>(cudaGetLastError());
}

int treelet_walk_launch(int device, int shadow, const float* nodes, const float* tris,
                        int num_nodes, const float* tl_box, const float* tl_group,
                        const int32_t* tl_lim, int n_treelets, const float* ox, const float* oy,
                        const float* oz, const float* dx, const float* dy, const float* dz,
                        const float* t_lo, const float* t_init, float* t_out, int32_t* slot_out,
                        int n_rays, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_treelets < 1 || n_treelets > kMaxTreelets) return static_cast<int>(cudaErrorInvalidValue);
  if (n_rays > 0) {
    auto kernel = shadow ? treelet_walk_kernel<true> : treelet_walk_kernel<false>;
    kernel<<<blocks_for(n_rays), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        reinterpret_cast<const float4*>(nodes), reinterpret_cast<const float4*>(tris),
        num_nodes, tl_box, tl_group, tl_lim, n_treelets, ox, oy, oz, dx, dy, dz, t_lo, t_init,
        t_out, slot_out, n_rays);
  }
  return static_cast<int>(cudaGetLastError());
}

int emissive_walk_launch(int device, const float* nodes, const float* rows, int num_nodes,
                         const float* ox, const float* oy, const float* oz, const float* dx,
                         const float* dy, const float* dz, const uint8_t* active, float t_min,
                         float* pdf_out, int n_rays, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_rays > 0) {
    emissive_walk_kernel<<<blocks_for(n_rays), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        reinterpret_cast<const float4*>(nodes), reinterpret_cast<const float4*>(rows), num_nodes,
        ox, oy, oz, dx, dy, dz, active, t_min, pdf_out, n_rays);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
