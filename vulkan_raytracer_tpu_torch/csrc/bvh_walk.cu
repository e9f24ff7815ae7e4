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
// The kernels took ~50x that (PERF.md).  A walk is a chain of dependent
// loads, the next node known only once the current one has been read and
// tested, and the rays of a warp part ways.  Where they part ways cost the
// most: in the first form, one turn of the loop tested one node, and a lane
// that entered a leaf ran the leaf's whole triangle loop (up to 16 tests,
// each with an IEEE division) inside that turn while the other lanes of the
// warp waited.  On the re-sorted bounce rays of the 256k-triangle hall only
// ~8% of the triangle-test slots a warp issued tested a triangle for a lane
// (walk_visits' tris over tri_slots_in_turn), and the triangle loops held
// >90% of the warp's issue.  What the design does:
//   * the streams fit in L2 (50 MB): the triangles are kept once in one
//     table that the eight octant streams share (the TPU streamed one copy
//     per octant, 8x the bytes), so the dragon's streams take ~22 MB;
//   * every record is read with 16-byte loads through the read-only path:
//     a node is one 32-byte record, (bmin.xyz, leaf) and (bmax.xyz, link),
//     two float4 loads; a triangle is three float4 (v0, e1, e2, each padded
//     to 16 bytes);
//   * a leaf's node record holds its count of real triangles, so padding
//     slots are never tested (44% of the slots of a 147k-triangle glTF);
//   * while-while with leaves postponed (Aila and Laine, "Understanding the
//     Efficiency of Ray Traversal on GPUs", HPG 2009), without speculation:
//     in the node phase each lane steps nodes (node_step), taking its next
//     treelet when it is past its range, until it enters a leaf that holds
//     triangles, whose first row and count it keeps, or its walk ends; the
//     phase goes on while any lane of the warp still searches, and a lane
//     that holds a leaf waits.  In the leaf phase every lane that holds a
//     leaf tests it (leaf_test), one triangle a step in slot order, so the
//     warp pays the longest of its lanes' leaves once a phase instead of
//     each lane's leaf in a turn of its own.  A ray makes the same node and
//     triangle tests in the same order against the same t_best as a walk
//     that tests each leaf where it enters it; only the turn of the warp
//     they fall in changes.  walk_visits' tri_slots counts the slots this
//     schedule issues;
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
// and the NEE probe).  Its plain version is emissive_pdf_walk_reference in
// ops/traverse.py, a lockstep walk of the binary tree; the kernel is
// bit-equal to it on every active lane.  The contract fixes the order of the
// sum: each entered leaf's terms in slot order, the leaves in the binary
// preorder.  A probe ray runs to 1e32 and nothing ends it early, so a ray
// makes a long chain of visits.  What bounded the first kernel (one thread a
// ray through the binary tree, 3% of its operations bound): each turn two
// dependent loads at an address the turn before decided; every ray reading
// every record it visits through L1/L2 again; lanes of a warp in different
// subtrees and leaves; and sparse probes (the lanes that hit an emitter, the
// visible light samples) left as a few live lanes in each of thousands of
// blocks.  What the design does:
//   * wide nodes (ops/traverse.py wide_layout): the binary tree's interior
//     nodes collapsed into the fewest nodes of up to kWide = 8 children,
//     each child a 32-byte record (bmin.xyz, ref | bmax.xyz, kind) with the
//     binary node's own exact box, in the binary preorder.  A child's box lies inside its
//     parent's (exact min/max unions) and the slab test is monotone under
//     rounding, so testing a child's box alone enters the same leaves in the
//     same order as the binary walk;
//   * eight lanes walk one ray: lane j tests child j of the node, so one
//     visit is one 256-byte coalesced read and one dependent step where the
//     binary walk took two or three;
//   * a per-group stack of one 32-bit word an entered child (a wide node,
//     or a leaf's first row and count) in shared memory: a visit pushes
//     the node's entered children, the first on top, each lane its own
//     child's word, so the stack pops in the binary preorder and going back
//     up reads nothing again (kStack words; the wrapper refuses a tree whose
//     walk could stack more, EmissiveStream.stack); no thread has a stack
//     frame;
//   * popped leaves fill a batch of eight slots, a lane a slot, across
//     leaves and nodes; the batch is tested when the next leaf does not fit
//     or the walk ends, and its terms added in slot order and leaf by leaf
//     through shuffles, so the sum is the plain version's, bit for bit.  The
//     loop is while-while: the four rays of a warp pop and visit together,
//     then test their batches together;
//   * the top of the tree in shared memory: wide nodes are breadth first,
//     so the block stages the first n_top of them with cp.async, as many as
//     the shared memory left by the list and the stacks holds (~179 KB,
//     ~700 nodes: the whole tree of 5,000 emissive triangles, 281 nodes,
//     and 62% of that of 20,000), and reads deeper nodes and the leaf rows
//     through the read-only path.  Nothing is kept between launches;
//   * persistent blocks: one block of 1,024 threads (128 rays) an SM.  The
//     launch's lanes are cut into 1,024-lane chunks dealt round the blocks;
//     a block writes +0 for its inactive lanes, gathers its live lanes into
//     a list in shared memory (kChunks chunks a round) and its groups take
//     rays from the list through a shared counter, so a sparse launch is
//     spread over every SM, reads nothing on the host and needs nothing
//     reset between launches; a block with no live lane stages nothing.
// What bounds it now (PERF.md, tools/bench_torch_emissive.py): latency.  Its
// 52 registers allow one 1,024-thread block an SM, and each ray is a chain
// of dependent steps; an earlier form of the walk took 1.66x as long with
// half the threads, and forms held to fewer registers spilled.
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
constexpr unsigned kWarpLanes = 0xffffffffu;  // every lane of a warp votes
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

// The node phase's step: the slab test of node cur of one octant's stream.
// nodes: 2 float4 per node, (bmin.xyz, leaf) and (bmax.xyz, link) with leaf
// and link int32 bit patterns.  Returns the next node; a leaf the ray enters
// is handed back as its first row and count of triangles (count 0 where the
// ray entered none).
__device__ __forceinline__ int node_step(const float4* __restrict__ nodes, int cur, const Ray& r,
                                         float t_best, int& row, int& count) {
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
  row = leaf;
  count = enter && leaf >= 0 ? link : 0;
  return enter || leaf >= 0 ? cur + 1 : link;
}

// The leaf phase's step: the triangles of rows [row, row + count) of tris (3
// float4 per triangle: v0, e1, e2), in slot order.  Returns true when a
// shadow ray found its occluder (t_best = -1), which ends its walk.
template <bool SHADOW>
__device__ __forceinline__ bool leaf_test(const float4* __restrict__ tris, int row, int count,
                                          const Ray& r, float t_lo, float& t_best,
                                          int32_t& slot) {
  const float4* tri = tris + 3 * (size_t)row;
  for (int j = 0; j < count; ++j, tri += 3) {
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
        slot = row + j;
        return true;
      }
    } else if (hit && (t < t_best || slot < 0)) {
      t_best = t;
      slot = row + j;
    }
  }
  return false;
}

// One lane's walk over `stream` (its octant's), while-while with leaves
// postponed: a node phase that steps the searching lanes until each holds a
// leaf or has ended, then a leaf phase that tests the held leaves together,
// until no lane of the warp walks.  Every lane of the warp calls it (the
// votes take all 32); a lane with `walking` false only votes.  [cur, end) is
// the lane's first range of the stream; next(cur, end) moves a lane past its
// range to its next one and returns false when the walk is over.
template <bool SHADOW, class Next>
__device__ __forceinline__ void walk(const float4* __restrict__ stream,
                                     const float4* __restrict__ tris, const Ray& r, float t_lo,
                                     bool walking, int cur, int end, float& t_best,
                                     int32_t& slot, Next next) {
  int row = 0, count = 0;
  while (__any_sync(kWarpLanes, walking)) {
    bool searching = walking;
    while (__any_sync(kWarpLanes, searching)) {
      if (searching) {
        if (cur >= end && !next(cur, end)) {
          walking = searching = false;
        } else {
          cur = node_step(stream, cur, r, t_best, row, count);
          searching = count == 0;
        }
      }
    }
    if (count > 0) {
      if (leaf_test<SHADOW>(tris, row, count, r, t_lo, t_best, slot)) walking = false;
      count = 0;
    }
  }
}

// K4': walk the ray's whole octant stream.  Every thread of a warp stays to
// the end, a lane past n_rays too: the walk's votes take all 32.
template <bool SHADOW>
__global__ void __launch_bounds__(kThreads)
bvh_walk_kernel(const float4* __restrict__ nodes, const float4* __restrict__ tris, int num_nodes,
                const float* __restrict__ ox, const float* __restrict__ oy,
                const float* __restrict__ oz, const float* __restrict__ dx,
                const float* __restrict__ dy, const float* __restrict__ dz,
                const float* __restrict__ t_lo, const float* __restrict__ t_init,
                float* __restrict__ t_out, int32_t* __restrict__ slot_out, int n_rays) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool live = i < n_rays;
  float t_best = live ? t_init[i] : -1.0f;
  int32_t slot = -1;
  const bool walking = t_best >= 0.0f;
  Ray r = {};
  float lo = 0.0f;
  const float4* stream = nodes;
  if (walking) {
    r = load_ray(ox, oy, oz, dx, dy, dz, i);
    lo = t_lo[i];
    stream = nodes + (size_t)octant_of(r) * num_nodes * 2;
  }
  walk<SHADOW>(stream, tris, r, lo, walking, 0, num_nodes, t_best, slot,
               [](int&, int&) { return false; });
  if (live) {
    t_out[i] = t_best;
    slot_out[i] = slot;
  }
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
    const bool walking = t_best >= 0.0f;
    Ray r = {};
    float lo = 0.0f;
    int oct = 0;
    // the entered treelets: all in the mask, the nearest in the list
    NearList list;
    list.clear();
    Mask128 mask{0u, 0u, 0u, 0u};
    if (walking) {
      r = load_ray(ox, oy, oz, dx, dy, dz, i);
      lo = t_lo[i];
      oct = octant_of(r);
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
    }
    // A lane past its treelet's range takes the next one in the turn of the
    // node phase that tests the treelet's first node.
    const float4* stream = nodes + (size_t)oct * num_nodes * 2;
    const int32_t* lim = tl_lim + (size_t)oct * n_treelets * 2;
    walk<SHADOW>(stream, tris, r, lo, walking, 0, 0, t_best, slot, [&](int& cur, int& end) {
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
        if (list.empty()) return false;
      }
      const float e = list.e[0];
      const int k = list.k[0];
      list.pop();
      mask.put(k >> 5, mask.get(k >> 5) & ~(1u << (k & 31)));
      if (e > t_best) return false;  // every later entry is >= e
      cur = lim[2 * k];
      end = lim[2 * k + 1];
      return true;
    });
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
constexpr int kWide = 8;  // children of a wide node, lanes a ray (ops/traverse.py EMISSIVE_WIDE)
constexpr int kWalkThreads = 1024;  // one block an SM
constexpr int kGroups = kWalkThreads / kWide;  // rays a block walks at once
constexpr int kStack = 64;  // stack entries a ray (ops/traverse.py EMISSIVE_STACK)
constexpr int kChunks = 4;  // 1,024-lane chunks a block gathers a round
constexpr int kListBytes = kChunks * kWalkThreads * 4;
constexpr int kStackBytes = kGroups * kStack * 4;
constexpr int kNodeFloat4 = 2 * kWide;  // 16-byte words of a wide node
constexpr int kNodeBytes = 16 * kNodeFloat4;
// a leaf's stack word: bit 31, its count of slots less one above kRowBits,
// its first row below (ops/traverse.py EMISSIVE_ROW_BITS: the wrapper
// refuses 2**kRowBits rows or more)
constexpr int kRowBits = 28;
constexpr unsigned kRowMask = (1u << kRowBits) - 1u;
// wide nodes a tree may have (ops/traverse.py EMISSIVE_MAX_NODES)
constexpr int kMaxWideNodes = 1 << 24;
constexpr int kMaxDevices = 64;
static_assert(kWide == 8 && 32 % kWide == 0, "a ray's lanes are one 8-lane segment of a warp");
static_assert(kWide - 1 < (1 << (31 - kRowBits)), "a leaf's count fits between row and bit 31");
static_assert(kMaxWideNodes <= 0x7fffffff / kNodeFloat4, "a node's first word is an int");

// Child j of wide node `node`: (bmin.xyz, ref) and (bmax.xyz, kind), from
// shared memory for the first n_top nodes, else through the read-only path.
__device__ __forceinline__ void wide_child(const float4* __restrict__ wide, const float4* top,
                                           int n_top, int node, int j, float4& lo, float4& hi) {
  const int at = node * kNodeFloat4 + 2 * j;
  if (node < n_top) {
    lo = top[at];
    hi = top[at + 1];
  } else {
    lo = __ldg(wide + at);
    hi = __ldg(wide + at + 1);
  }
}

// Visit `node`: the ray's slab test of every child (ray_aabb,
// ops/intersect.py:31: tnear <= tfar, tfar >= t_min, tnear <= 1e32), lane g
// child g, and each entered child pushed as one stack word, the first child
// on top, so the stack pops in the binary preorder.  A word is an interior
// child's wide node, or a leaf: bit 31, its count of slots less one in bits
// 28-30, its first row below.
__device__ __forceinline__ void push_children(const float4* __restrict__ wide, const float4* top,
                                              int n_top, int node, int g, int shift,
                                              unsigned gmask, const Ray& r, float t_min,
                                              unsigned* stack, int& sp) {
  float4 lo, hi;
  wide_child(wide, top, n_top, node, g, lo, hi);
  const int ref = __float_as_int(lo.w), kind = __float_as_int(hi.w);
  float nx, fx, ny, fy, nz, fz;
  slab(lo.x, hi.x, r.ox, r.ix, nx, fx);
  slab(lo.y, hi.y, r.oy, r.iy, ny, fy);
  slab(lo.z, hi.z, r.oz, r.iz, nz, fz);
  const float near = fmaxf(fmaxf(nx, ny), nz);
  const float far = fminf(fminf(fx, fy), fz);
  const bool enter = kind != 0 && near <= far && far >= t_min && near <= kPdfTMax;
  const unsigned mask = (__ballot_sync(gmask, enter) >> shift) & 0xffu;
  if (enter) {
    const unsigned leaf = 0x80000000u | static_cast<unsigned>(kind - 1) << kRowBits;
    const unsigned word = kind < 0 ? static_cast<unsigned>(ref) : leaf | static_cast<unsigned>(ref);
    stack[sp + __popc(mask >> g >> 1)] = word;
  }
  sp += __popc(mask);
  __syncwarp(gmask);
}

// One slot's term: p_delta * t^2 / max(area * |n.d|, 1e-30) if the ray hits
// the row's triangle with t_min < t <= 1e32, else 0.  rows: 5 float4 a slot,
// [v0.xyz, e1.x], [e1.yz, e2.xy], [e2.z, p_delta, area, n0.x], [n0.yz,
// n1.xy], [n1.z, n2.xyz]; the arithmetic of the plain version (dense.mt and
// emissive_leaf_sums), which --fmad=false keeps bit for bit.
__device__ __forceinline__ float slot_term(const float4* __restrict__ row, const Ray& r,
                                           float t_min) {
  const float4 a = __ldg(row);      // v0.xyz, e1.x
  const float4 b = __ldg(row + 1);  // e1.yz, e2.xy
  const float4 c = __ldg(row + 2);  // e2.z, p_delta, area, n0.x
  const float px = r.dy * c.x - r.dz * b.w;
  const float py = r.dz * b.z - r.dx * c.x;
  const float pz = r.dx * b.w - r.dy * b.z;
  const float det = a.w * px + b.x * py + b.y * pz;
  if (fabsf(det) < 1e-12f) return 0.0f;
  const float inv = 1.0f / det;
  const float tx = r.ox - a.x;
  const float ty = r.oy - a.y;
  const float tz = r.oz - a.z;
  const float u = (tx * px + ty * py + tz * pz) * inv;
  const float qx = ty * b.y - tz * b.x;
  const float qy = tz * a.w - tx * b.y;
  const float qz = tx * b.x - ty * a.w;
  const float v = (r.dx * qx + r.dy * qy + r.dz * qz) * inv;
  const float t = (b.z * qx + b.w * qy + c.x * qz) * inv;
  if (!(u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t > t_min && t <= kPdfTMax)) return 0.0f;
  const float4 d = __ldg(row + 3);  // n0.yz, n1.xy
  const float4 e = __ldg(row + 4);  // n1.z, n2.xyz
  const float w0 = 1.0f - u - v;
  const float mx = w0 * c.w + u * d.z + v * e.y;
  const float my = w0 * d.x + u * d.w + v * e.z;
  const float mz = w0 * d.y + u * e.x + v * e.w;
  const float len = fmaxf(sqrtf(mx * mx + my * my + mz * mz), 1e-20f);
  const float cosine = fabsf(mx / len * r.dx + my / len * r.dy + mz / len * r.dz);
  return c.y * t * t / fmaxf(c.z * cosine, 1e-30f);
}

// Test the batch's slots (lane g: slot g, of row `row`, if g < fill) and add
// their terms to the pdf: the plain version adds every slot's term (0 where
// missed) in slot order and each leaf's sum to the pdf; adding +-0 changes
// neither sum (the pdf is never -0), so only the terms that are not 0 are
// added, and a leaf's sum where its last one is (ends: the batch's last slot
// of each leaf).
__device__ __forceinline__ float flush(const float4* __restrict__ rows, int row, int fill,
                                       unsigned ends, int g, int shift, unsigned gmask,
                                       const Ray& r, float t_min, float pdf) {
  float term = 0.0f;
  if (g < fill) term = slot_term(rows + 5 * static_cast<size_t>(row), r, t_min);
  unsigned hits = (__ballot_sync(gmask, term != 0.0f) >> shift) & 0xffu;
  float leaf_sum = 0.0f;
  while (hits != 0) {
    const int q = __ffs(hits) - 1;
    hits &= hits - 1;
    leaf_sum = leaf_sum + __shfl_sync(gmask, term, q, kWide);
    const int last = __ffs(ends >> q << q) - 1;  // the last slot of q's leaf
    if (hits == 0 || __ffs(hits) - 1 > last) {
      pdf = pdf + leaf_sum;
      leaf_sum = 0.0f;
    }
  }
  return pdf;
}

// One ray's pdf, walked by the 8 lanes of its group (g: this lane's index in
// the group, gmask: the group's lanes, shift: the group's first lane); every
// lane returns it.  stack: the group's kStack words in shared memory.  Popped
// leaves fill a batch of kWide slots, a lane a slot, in preorder; the batch
// is tested when the next leaf does not fit, or at the end (while-while: the
// groups of a warp pop and visit together, then test their batches
// together).
__device__ __forceinline__ float walk_ray(const float4* __restrict__ wide, const float4* top,
                                          int n_top, const float4* __restrict__ rows,
                                          unsigned* stack, const Ray& r, float t_min, int g,
                                          int shift, unsigned gmask) {
  float pdf = 0.0f;
  int sp = 0, fill = 0, row = 0;
  unsigned ends = 0;
  push_children(wide, top, n_top, 0, g, shift, gmask, r, t_min, stack, sp);
  for (;;) {
    while (sp != 0) {
      const unsigned word = stack[sp - 1];
      if (word >> 31) {  // a leaf: into the batch, if it fits
        const int count = static_cast<int>((word & 0x7fffffffu) >> kRowBits) + 1;
        if (fill + count > kWide) break;
        --sp;
        if (g >= fill && g < fill + count) row = static_cast<int>(word & kRowMask) + g - fill;
        fill += count;
        ends |= 1u << (fill - 1);
      } else {
        --sp;
        push_children(wide, top, n_top, static_cast<int>(word), g, shift, gmask, r, t_min,
                      stack, sp);
      }
    }
    pdf = flush(rows, row, fill, ends, g, shift, gmask, r, t_min, pdf);
    if (sp == 0) break;
    fill = 0;
    ends = 0;
  }
  return pdf;
}

// Stage the first n_top wide nodes into shared memory (cp.async, 16 bytes a
// copy); every thread of the block reaches it.
__device__ __forceinline__ void stage_top(float4* top, const float4* __restrict__ wide,
                                          int n_top) {
  for (int i = threadIdx.x; i < n_top * kNodeFloat4; i += kWalkThreads) {
    const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(top + i));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(wide + i)
                 : "memory");
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
}

// The emissive-pdf walk: per active ray, the sum over every emissive triangle
// hit with t_min < t <= 1e32 of p_delta * t^2 / max(area * |n.d|, 1e-30), n
// the interpolated vertex normal over max(|n|, 1e-20); inactive lanes get +0.
// wide: the wide nodes (ops/traverse.py EmissiveStream.wide), rows: the leaf
// rows.  Dynamic shared memory: the list, the stacks, then n_top nodes.
__global__ void __launch_bounds__(kWalkThreads, 1)
emissive_walk_kernel(const float4* __restrict__ wide, const float4* __restrict__ rows, int n_top,
                     const float* __restrict__ ox, const float* __restrict__ oy,
                     const float* __restrict__ oz, const float* __restrict__ dx,
                     const float* __restrict__ dy, const float* __restrict__ dz,
                     const uint8_t* __restrict__ active, float t_min,
                     float* __restrict__ pdf_out, int n_rays) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* list = reinterpret_cast<int*>(smem);
  unsigned* stacks = reinterpret_cast<unsigned*>(list + kChunks * kWalkThreads);
  float4* top = reinterpret_cast<float4*>(smem + kListBytes + kStackBytes);
  __shared__ int n_list, next;
  const int lane = threadIdx.x & 31;
  const int g = lane & (kWide - 1), shift = lane & ~(kWide - 1);
  const unsigned gmask = 0xffu << shift;
  unsigned* stack = stacks + (threadIdx.x / kWide) * kStack;
  const int n_chunks = (n_rays + kWalkThreads - 1) / kWalkThreads;
  bool staged = false;
  for (int first = blockIdx.x; first < n_chunks; first += gridDim.x * kChunks) {
    if (threadIdx.x == 0) {
      n_list = 0;
      next = 0;
    }
    __syncthreads();
    for (int k = 0; k < kChunks; ++k) {  // +0 on inactive lanes, the live ones listed
      const int chunk = first + k * gridDim.x;
      const int i = chunk * kWalkThreads + threadIdx.x;
      bool live = false;
      if (chunk < n_chunks && i < n_rays) {
        live = active[i] != 0;
        if (!live) pdf_out[i] = 0.0f;
      }
      const unsigned ballot = __ballot_sync(0xffffffffu, live);
      int base = 0;
      if (lane == 0 && ballot != 0) base = atomicAdd(&n_list, __popc(ballot));
      base = __shfl_sync(0xffffffffu, base, 0);
      if (live) list[base + __popc(ballot & ((1u << lane) - 1u))] = i;
    }
    __syncthreads();
    const int n_live = n_list;
    if (n_live > 0) {  // uniform across the block
      if (!staged) {
        stage_top(top, wide, n_top);
        staged = true;
      }
      for (;;) {
        int at = g == 0 ? atomicAdd(&next, 1) : 0;
        at = __shfl_sync(gmask, at, 0, kWide);
        if (at >= n_live) break;
        const int k = list[at];
        Ray r;
        r.ox = ox[k];
        r.oy = oy[k];
        r.oz = oz[k];
        r.dx = dx[k];
        r.dy = dy[k];
        r.dz = dz[k];
        r.ix = safe_inv(r.dx);
        r.iy = safe_inv(r.dy);
        r.iz = safe_inv(r.dz);
        const float pdf = walk_ray(wide, top, n_top, rows, stack, r, t_min, g, shift, gmask);
        if (g == 0) pdf_out[k] = pdf;
      }
    }
    __syncthreads();
  }
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

int emissive_walk_launch(int device, const float* wide, const float* rows, int num_wide,
                         const float* ox, const float* oy, const float* oz, const float* dx,
                         const float* dy, const float* dz, const uint8_t* active, float t_min,
                         float* pdf_out, int n_rays, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_rays <= 0) return static_cast<int>(cudaGetLastError());
  if (device < 0 || device >= kMaxDevices || num_wide < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // per device, once: the SMs, and the most shared memory a block may take
  static int sms[kMaxDevices], top_max[kMaxDevices];
  if (sms[device] == 0) {
    int count = 0, optin = 0;
    cudaFuncAttributes attr;
    if ((err = cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, device)) ||
        (err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device)) ||
        (err = cudaFuncGetAttributes(&attr, emissive_walk_kernel))) {
      return static_cast<int>(err);
    }
    const int dynamic = optin - static_cast<int>(attr.sharedSizeBytes);
    err = cudaFuncSetAttribute(emissive_walk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               dynamic);
    if (err != cudaSuccess) return static_cast<int>(err);
    top_max[device] = (dynamic - kListBytes - kStackBytes) / kNodeBytes;
    sms[device] = count;
  }
  const int n_top = num_wide < top_max[device] ? num_wide : top_max[device];
  const size_t bytes = kListBytes + kStackBytes + static_cast<size_t>(n_top) * kNodeBytes;
  const int n_chunks = (n_rays + kWalkThreads - 1) / kWalkThreads;
  const int grid = n_chunks < sms[device] ? n_chunks : sms[device];
  emissive_walk_kernel<<<grid, kWalkThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(wide), reinterpret_cast<const float4*>(rows), n_top, ox, oy,
      oz, dx, dy, dz, active, t_min, pdf_out, n_rays);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
