// What surrounds the traversal launches, for Hopper (sm_90a): four kernels.
//
// Replaces what XLA makes of the JAX package's code around each Pallas call
// inside its jit'd wave (vulkan_raytracer_tpu/render/renderer.py:34, 52).
// Each is an XLA fusion, not a Pallas kernel:
//   hit_finish_kernel    <- the closest hit's finish after the traversal: the
//                           winner's (u, v) from its 9 vertex gathers
//                           (ops/pallas_dense.py:282-292 in pallas_closest
//                           :262-298; ops/pallas_bvh.py packet_closest :1604
//                           with _slot_to_tri :1343 and _winner_uv :1309), and on
//                           an instanced scene the winner's instance transform
//                           (ops/instanced.py :236-262); t = inf, tri = -1,
//                           u = v = 0 on a miss.  One an opaque closest-hit
//                           call: an alpha pass's finish is its commit's
//                           (csrc/wave.cu), on its pending lanes, by the same
//                           function (csrc/hit_finish.cuh)
//   instance_step_kernel <- one step of the instance scans between two
//                           prototype launches (ops/instanced.py:185-234,
//                           :279-317): the last launch's result merged into the
//                           running closest hit (or occlusion), then the next
//                           instance's box test, its object-space rays and its
//                           launch's bounds; in a program also the count of
//                           lanes that touch the box, which sets the IF node
//                           around the instance's launch (jnp.any(touches) of
//                           the lax.cond at :229, :314)
//   coherence_key_kernel <- _coherence_key (render/integrator.py:316-349): dead,
//                           direction octant and the Morton cell of the origin
//                           over 64 cells an axis of the root bounds, one int32;
//                           the bounds are read where the tables keep them (the
//                           BVH root's box, or an instanced scene's union box,
//                           made at upload and refit: the reductions of :322-329
//                           run once a tables, not once a key)
//   permute_kernel       <- the re-sort's gathers (_sort_wavefront :352-373),
//                           the NEE rays' gathers and scatters (_shadow
//                           :234-267): every column of a state in one launch,
//                           and a state's copy into the program's buffers
// The plain PyTorch versions are hit_finish_reference,
// instance_step_reference, coherence_key_reference and permute_reference in
// ops/trace.py: the port's winner_uv, slot_to_tri, the instanced loops'
// bodies and finish, _coherence_key and the index_select / index_copy_ /
// copy_ of the re-sort, regrouped.
//
// Design.  One thread per lane, 256 lanes a block, no shared memory; a lane's
// inputs are its own columns and a few gathers from the scene's tables.  A
// kernel takes one parameter struct (Args): a pointer per column (Slot), a
// few counts and flags (Int) and two floats (Real).  An instance step reads
// the instance's 12 world->object values, its box and its id through device
// pointers into its group's rows, so a captured program replays it against
// whatever a refit copied there.  permute_kernel moves up to kCols columns
// of 1, 4 or 8 bytes an element by the same int64 permutation: a gather
// (dst[i] = src[perm[i]]), a scatter (dst[perm[i]] = src[i]) or a copy;
// a gather or a scatter never runs in place (one thread's write would race
// another thread's read).
//
// permute_kernel moves a gather's or a scatter's lanes a thread a lane, every
// column, the column loop unrolled so that its loads all issue before the
// first store (measured faster on real waves than column-major items of
// four neighbouring lanes a thread with 16-byte stores, and than the same
// body on a persistent grid: PERF.md, PR 19).  A copy runs on a persistent
// grid (kPermBlocksPerSm blocks an SM, from the SM count at launch), each
// block taking every gridDim.x-th item of kCopyChunk bytes of one column,
// 16 a thread, column after column: one 16-byte load and store a thread
// where both ends are aligned, byte by byte elsewhere and at the ragged
// end.
//
// What bounds them.  Bytes, a few dozen a lane: the finish reads the hit and,
// where something was hit, the ray (28 bytes) and writes 16; a step reads
// the ray and the running state and writes the next launch's 6 ray columns
// and its bound (~60 bytes); the key reads the ray and a flag and writes 4;
// the permutation moves each column twice (and the permutation's 8 bytes).
// At 3.35 TB/s a 524,288-lane wave's finish or key is ~10 us, a re-sort's
// gather of the 21-column state (72 bytes a lane) ~23 us.  A gather's or a
// scatter's random side costs one L2 request a lane and column (a 32-byte
// sector for 1 to 8 useful bytes) in either order, so where the permutation
// scatters lanes far apart the L2's request rate, not device memory, is
// what bounds it.
//
// Numerics: those of csrc/lane_math.cuh under --fmad=false.  Products and
// sums in the plain version's order (a dot is ((x*x') + (y*y')) + (z*z'), an
// affine row ((m0*x + m1*y) + m2*z) + m3); torch.reciprocal and 1.0 / x are
// 1 / x (the latter is reciprocal(x) * 1.0 in aten); 64.0 / x is
// reciprocal(x) * 64; minimum / maximum / amin / amax pass NaN through; a
// float's cast to int32 truncates as aten's on the card; the encoded id's
// int32 sums wrap as aten's.
//
// Launches go on the caller's stream; nothing here synchronises or
// allocates.  Each launcher returns cudaGetLastError().

#include "graph_test.cuh"
#include "hit_finish.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kCols = 24;  // columns one permute_kernel launch moves at most
constexpr int kCopyChunk = kThreads * 16;  // a copy's item: bytes of one column
constexpr int kPermBlocksPerSm = 8;         // a copy's persistent grid: blocks an SM

// One pointer per column; ops/trace.py SLOTS lists the same names in the same
// order (the permutation's columns as P_SRC0 .. P_SRC23, P_DST0 .. P_DST23).
enum Slot {
  // the call's world rays
  W_OX, W_OY, W_OZ, W_DX, W_DY, W_DZ,
  // a traversal launch's result: t and the triangle, leaf slot, encoded id
  // or occlusion flag
  H_T, H_HIT,
  // hit_finish_kernel's outputs
  O_T, O_TRI, O_U, O_V,
  // instance_step_kernel: the call's lanes and bound, its running state
  // (inv_d as an (n, 3) block), the next launch's rays and bounds
  X_ACTIVE, X_TMAX, S_INV, S_TBEST, S_ENC, S_OCC, S_TOUCH,
  N_OX, N_OY, N_OZ, N_DX, N_DY, N_DZ, N_TLO, N_TINIT,
  // the next instance's 12 world->object values and its box; the last one's id;
  // the next launch's IF control block (null but in a program)
  X_M, X_BMIN, X_BMAX, X_IID, X_IF,
  // coherence_key_kernel: the root bounds (3 floats each: ops/trace.py key_box),
  // the lanes, the key
  K_LO, K_HI, K_ACTIVE, K_KEY,
  // the scene's tables: the vertices, a BVH's slot -> triangle, the
  // instances' world->object rows (12, I)
  T_V0X, T_V0Y, T_V0Z, T_V1X, T_V1Y, T_V1Z, T_V2X, T_V2Y, T_V2Z, T_TRIID, T_INVFLAT,
  // permute_kernel: the permutation, each column's source and destination
  P_PERM, P_SRC0, P_DST0 = P_SRC0 + kCols, kSlots = P_DST0 + kCols
};

// Counts and flags; ops/trace.py INTS lists the same names in the same order
// (each permuted column's bytes an element as I_WIDTH0 .. I_WIDTH23).
enum Int {
  I_N, I_MODE, I_PROTO_TRIS, I_NUM_INST, I_FIRST, I_PREV, I_NEXT, I_SHADOW, I_PREV_BLAS,
  I_NEXT_BLAS, I_TRI_OFF, I_COLS, I_WIDTH0, kInts = I_WIDTH0 + kCols
};

// Floats; ops/trace.py REALS lists the same names in the same order.
enum Real { F_TMIN, F_TMAX, kReals };

// permute_kernel's modes
enum Permute { kGather, kScatter, kCopy };

// An instance launch's IF control block, four int64 (ops/wave.py LOOP_WORDS,
// the resample loops' layout): the count's accumulator and block ticket, the
// IF's conditional handle and the address of its row of counters (0: not
// armed), and the count the step left.
enum IfWord { kIfWord, kIfHandle, kIfRow, kIfCount };

struct Args {
  void* p[kSlots];
  long long i[kInts];
  float f[kReals];
};

template <class T>
__device__ __forceinline__ T* col(const Args& a, int s) {
  return static_cast<T*>(a.p[s]);
}

__device__ __forceinline__ long long lane_index() {
  return static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
}

__device__ __forceinline__ V3 ray_o(const Args& a, long long i) {
  return {col<const float>(a, W_OX)[i], col<const float>(a, W_OY)[i], col<const float>(a, W_OZ)[i]};
}

__device__ __forceinline__ V3 ray_d(const Args& a, long long i) {
  return {col<const float>(a, W_DX)[i], col<const float>(a, W_DY)[i], col<const float>(a, W_DZ)[i]};
}

// hit_finish_kernel's tables (csrc/hit_finish.cuh)
__device__ __forceinline__ FinishTables finish_tables(const Args& a) {
  FinishTables f;
#pragma unroll
  for (int k = 0; k < 9; ++k) f.v[k] = col<const float>(a, T_V0X + k);
  f.tri_id = col<const int>(a, T_TRIID);
  f.inv_flat = col<const float>(a, T_INVFLAT);
  f.proto_tris = a.i[I_PROTO_TRIS];
  f.num_inst = a.i[I_NUM_INST];
  f.mode = static_cast<int>(a.i[I_MODE]);
  return f;
}

// math3.safe_inv_dir: 1/d with |d| < 1e-20 replaced by a signed 1e-20
__device__ __forceinline__ float safe_inv(float d) {
  return rcp(fabsf(d) < TINY ? (d < 0.0f ? -TINY : TINY) : d);
}

// trace.ray_aabb at t_min = 0: does [0, t_max] meet the box?  The slabs'
// minimum / maximum and the reductions over the axes pass NaN through.
__device__ __forceinline__ bool ray_box(V3 o, const float* inv, const float* bmin,
                                        const float* bmax, float t_max) {
  const float ox[3] = {o.x, o.y, o.z};
  float t_near = 0.0f, t_far = 0.0f;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float t0 = (bmin[k] - ox[k]) * inv[k], t1 = (bmax[k] - ox[k]) * inv[k];
    const float lo = minimum(t0, t1), hi = maximum(t0, t1);
    t_near = k == 0 ? lo : maximum(t_near, lo);
    t_far = k == 0 ? hi : minimum(t_far, hi);
  }
  return (t_near <= t_far) & (t_far >= 0.0f) & (t_near <= t_max);
}

// Morton interleave of a cell's low 6 bits into every third bit
// (integrator._morton6)
__device__ __forceinline__ int morton6(int x) {
  int out = 0;
#pragma unroll
  for (int b = 0; b < 6; ++b) out |= ((x >> b) & 1) << (3 * b);
  return out;
}

// The closest hit's finish: the triangle, found, the winner's (u, v)
__global__ void __launch_bounds__(kThreads) hit_finish_kernel(const __grid_constant__ Args a) {
  const long long i = lane_index();
  if (i >= a.i[I_N]) return;
  const int hit = col<const int>(a, H_HIT)[i];
  float* t_out = col<float>(a, O_T);
  int* tri_out = col<int>(a, O_TRI);
  float* u_out = col<float>(a, O_U);
  float* v_out = col<float>(a, O_V);
  if (hit < 0) {  // a miss: t = inf; K1's id as it is, else -1
    t_out[i] = INFINITY;
    tri_out[i] = a.i[I_MODE] == kDense ? hit : -1;
    u_out[i] = 0.0f;
    v_out[i] = 0.0f;
    return;
  }
  float u, v;
  long long proto;
  const int tri = finish_hit(finish_tables(a), hit, ray_o(a, i), ray_d(a, i), u, v, proto);
  t_out[i] = col<const float>(a, H_T)[i];
  tri_out[i] = tri;
  u_out[i] = u;
  v_out[i] = v;
}

// One lane of an instance step: the last launch merged, where the lane
// touched its instance's box, then the next instance prepared; returns
// whether the lane touches the next instance's box
__device__ __forceinline__ bool instance_step_lane(const Args& a, long long i) {
  const bool shadow = a.i[I_SHADOW], first = a.i[I_FIRST];
  const bool active = col<const uint8_t>(a, X_ACTIVE)[i];
  const float t_max = a.p[X_TMAX] ? col<const float>(a, X_TMAX)[i] : a.f[F_TMAX];
  float* inv_row = col<float>(a, S_INV) + 3 * i;
  float inv[3];
  float t_best = 0.0f;
  int enc = -1;
  bool occ = false;
  if (first) {  // the call's state: 1/d, the bound (closest) or no occlusion
    const V3 d = ray_d(a, i);
    inv[0] = safe_inv(d.x);
    inv[1] = safe_inv(d.y);
    inv[2] = safe_inv(d.z);
#pragma unroll
    for (int k = 0; k < 3; ++k) inv_row[k] = inv[k];
    if (!shadow) t_best = active ? t_max : 0.0f;
    if (a.p[N_TLO]) col<float>(a, N_TLO)[i] = a.f[F_TMIN];
  } else {
#pragma unroll
    for (int k = 0; k < 3; ++k) inv[k] = inv_row[k];
    if (shadow) {
      occ = col<const uint8_t>(a, S_OCC)[i];
    } else {
      t_best = col<const float>(a, S_TBEST)[i];
      enc = col<const int>(a, S_ENC)[i];
    }
  }
  // the last instance's launch, read only where the lane touched its box: a
  // launch that no lane touched may not have run (an IF node skipped it)
  if (a.i[I_PREV] && col<const uint8_t>(a, S_TOUCH)[i]) {
    const int hit = col<const int>(a, H_HIT)[i];
    if (shadow) {  // K2's flag, or a BLAS walk's slot
      occ = occ | (a.i[I_PREV_BLAS] ? hit >= 0 : hit != 0);
    } else {  // strictly closer: the first instance in DFS order keeps a tie
      const int local = !a.i[I_PREV_BLAS] ? hit : (hit >= 0 ? col<const int>(a, T_TRIID)[hit] : -1);
      const float t_n = col<const float>(a, H_T)[i];
      if (local >= 0 && t_n < t_best) {
        t_best = t_n;
        const unsigned base = static_cast<unsigned>(*col<const int>(a, X_IID)) *
                                  static_cast<unsigned>(a.i[I_PROTO_TRIS]) +
                              static_cast<unsigned>(a.i[I_TRI_OFF]);
        enc = static_cast<int>(static_cast<unsigned>(local) + base);
      }
    }
  }
  if (!a.i[I_NEXT]) occ = occ & active;  // the call's last step: its result
  if (shadow) {
    col<uint8_t>(a, S_OCC)[i] = occ;
  } else {
    col<float>(a, S_TBEST)[i] = t_best;
    col<int>(a, S_ENC)[i] = enc;
  }
  if (!a.i[I_NEXT]) return false;
  // the next instance: its box against the bound, its object-space rays and
  // its launch's initial bound (dead lanes: 0 for K1/K2, -1 for a walk)
  const float* m = col<const float>(a, X_M);
  const V3 o = ray_o(a, i);
  const float bound = shadow ? t_max : t_best;
  const bool live = shadow ? active & !occ : active;
  const bool touches = live && ray_box(o, inv, col<const float>(a, X_BMIN),
                                       col<const float>(a, X_BMAX), bound);
  col<uint8_t>(a, S_TOUCH)[i] = touches;
  const V3 o2 = affine(m, o), d2 = linear(m, ray_d(a, i));
  col<float>(a, N_OX)[i] = o2.x;
  col<float>(a, N_OY)[i] = o2.y;
  col<float>(a, N_OZ)[i] = o2.z;
  col<float>(a, N_DX)[i] = d2.x;
  col<float>(a, N_DY)[i] = d2.y;
  col<float>(a, N_DZ)[i] = d2.z;
  col<float>(a, N_TINIT)[i] = touches ? bound : (a.i[I_NEXT_BLAS] ? -1.0f : 0.0f);
  return touches;
}

// One step of an instance scan: merge the last launch, prepare the next and,
// given the next launch's IF control block (X_IF, four int64: the count's
// accumulator and block ticket, the IF's handle and the address of its row
// where the program armed the block on the card, and the count), count the
// lanes that touch the next instance's box: the grid's last block leaves the
// count, keeps the IF node's row and sets its condition, so a launch that no
// lane touches does not run (csrc/graph_test.cuh)
__global__ void __launch_bounds__(kThreads) instance_step_kernel(const __grid_constant__ Args a) {
  const long long i = lane_index();
  const bool touches = i < a.i[I_N] && instance_step_lane(a, i);
  unsigned long long* word = col<unsigned long long>(a, X_IF);
  if (word == nullptr || !a.i[I_NEXT]) return;
  long long total;
  if (!last_block(&word[kIfWord], block_sum(touches), total)) return;
  word[kIfCount] = static_cast<unsigned long long>(total);
  long long* row = reinterpret_cast<long long*>(word[kIfRow]);
  if (row == nullptr) return;  // not armed: a replayed step, whose host reads the flags
  const bool go = total > 0;
  keep_row(row, true, go, total);
  cudaGraphSetConditional(static_cast<cudaGraphConditionalHandle>(word[kIfHandle]),
                          go ? 1u : 0u);
}

// The re-sort key: dead << 30 | octant << 27 | morton << 9
__global__ void __launch_bounds__(kThreads) coherence_key_kernel(const __grid_constant__ Args a) {
  const long long i = lane_index();
  if (i >= a.i[I_N]) return;
  const float* lo = col<const float>(a, K_LO);
  const float* hi = col<const float>(a, K_HI);
  const float o[3] = {col<const float>(a, W_OX)[i], col<const float>(a, W_OY)[i],
                      col<const float>(a, W_OZ)[i]};
  int m[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float scale = rcp(clamp_min(hi[k] - lo[k], TINY)) * 64.0f;
    // clamp to [0, 63], then aten's cast (a NaN cell reads entry 0)
    m[k] = morton6(static_cast<int>(clamp((o[k] - lo[k]) * scale, 0.0f, 63.0f)) & 63);
  }
  const int neg_x = col<const float>(a, W_DX)[i] < 0.0f;
  const int neg_y = col<const float>(a, W_DY)[i] < 0.0f;
  const int neg_z = col<const float>(a, W_DZ)[i] < 0.0f;
  const int dead = !col<const uint8_t>(a, K_ACTIVE)[i];
  col<int>(a, K_KEY)[i] = (((m[0] << 2) | (m[1] << 1) | m[2]) << 9) | (neg_x << 29) |
                          (neg_y << 28) | (neg_z << 27) | (dead << 30);
}

__device__ __forceinline__ bool aligned(const void* p, unsigned bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

template <class T>
__device__ __forceinline__ void copy_element(const void* src, void* dst, long long from,
                                             long long to) {
  static_cast<T*>(dst)[to] = static_cast<const T*>(src)[from];
}

// A copy's item: bytes [b0, b0 + 16) (those below nbytes) of one column
__device__ __forceinline__ void copy_bytes(const uint8_t* src, uint8_t* dst, long long b0,
                                           long long nbytes) {
  if (b0 + 16 <= nbytes && aligned(src + b0, 16) && aligned(dst + b0, 16)) {
    *reinterpret_cast<uint4*>(dst + b0) = *reinterpret_cast<const uint4*>(src + b0);
    return;
  }
  for (long long b = b0; b < b0 + 16 && b < nbytes; ++b) dst[b] = src[b];
}

// A copy's items of one column
__host__ __device__ __forceinline__ long long copy_items(long long n, long long width) {
  return (n * width + kCopyChunk - 1) / kCopyChunk;
}

// Every column of a state gathered, scattered or copied by one permutation
// (see the note at the top)
__global__ void __launch_bounds__(kThreads, kPermBlocksPerSm)
    permute_kernel(const __grid_constant__ Args a) {
  const long long n = a.i[I_N];
  const int mode = static_cast<int>(a.i[I_MODE]), cols = static_cast<int>(a.i[I_COLS]);
  if (mode != kCopy) {  // a thread a lane, every column
    const long long i = lane_index();
    if (i >= n) return;
    const long long j = col<const long long>(a, P_PERM)[i];
    const long long from = mode == kScatter ? i : j, to = mode == kScatter ? j : i;
    // unrolled, so each column's pointers and width are read from the
    // parameters at a fixed offset
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      if (c >= cols) break;
      const void* src = a.p[P_SRC0 + c];
      void* dst = a.p[P_DST0 + c];
      switch (a.i[I_WIDTH0 + c]) {
        case 1: copy_element<uint8_t>(src, dst, from, to); break;
        case 4: copy_element<uint32_t>(src, dst, from, to); break;
        default: copy_element<unsigned long long>(src, dst, from, to); break;
      }
    }
    return;
  }
  int c = 0;  // a copy's item's column, and the items of the columns before it
  long long first = 0;
  for (long long item = blockIdx.x;; item += gridDim.x) {
    for (; c < cols; ++c) {
      const long long end = first + copy_items(n, a.i[I_WIDTH0 + c]);
      if (item < end) break;
      first = end;
    }
    if (c >= cols) return;
    copy_bytes(static_cast<const uint8_t*>(a.p[P_SRC0 + c]),
               static_cast<uint8_t*>(a.p[P_DST0 + c]),
               (item - first) * kCopyChunk + 16LL * threadIdx.x, n * a.i[I_WIDTH0 + c]);
  }
}

// The kernels' parameters from the launcher's arrays.
void fill(Args& args, const void* const* ptrs, const long long* ints, const float* reals) {
  for (int k = 0; k < kSlots; ++k) args.p[k] = const_cast<void*>(ptrs[k]);
  for (int k = 0; k < kInts; ++k) args.i[k] = ints[k];
  for (int k = 0; k < kReals; ++k) args.f[k] = reals[k];
}

// The grids: a thread a lane, or a copy's persistent grid (no more blocks
// than chunks)
cudaError_t lane_grid(const Args& args, int, unsigned int& blocks) {
  blocks = static_cast<unsigned int>((args.i[I_N] + kThreads - 1) / kThreads);
  return cudaSuccess;
}

cudaError_t permute_grid(const Args& args, int device, unsigned int& blocks) {
  if (args.i[I_MODE] != kCopy) return lane_grid(args, device, blocks);
  constexpr int kMaxDevices = 64;
  static int sms[kMaxDevices];  // the device's SM count, read once
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (sms[device] == 0) {
    const cudaError_t err =
        cudaDeviceGetAttribute(&sms[device], cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
  }
  long long items = 0;
  for (int c = 0; c < args.i[I_COLS]; ++c) items += copy_items(args.i[I_N], args.i[I_WIDTH0 + c]);
  const long long most = static_cast<long long>(sms[device]) * kPermBlocksPerSm;
  blocks = static_cast<unsigned int>(items < most ? items : most);
  return cudaSuccess;
}

}  // namespace

// (device, pointers [kSlots], counts [kInts], floats [kReals], stream);
// ops/trace.py fills the three arrays
#define TRACE_LAUNCHER(name, kernel, grid)                                                \
  extern "C" int name(int device, const void* const* ptrs, const long long* ints,        \
                      const float* reals, void* stream) {                                \
    cudaError_t err = cudaSetDevice(device);                                             \
    if (err != cudaSuccess) return static_cast<int>(err);                                \
    Args args;                                                                           \
    fill(args, ptrs, ints, reals);                                                       \
    unsigned int blocks = 0;                                                             \
    if ((err = grid(args, device, blocks)) != cudaSuccess) return static_cast<int>(err); \
    if (blocks > 0) kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(args); \
    return static_cast<int>(cudaGetLastError());                                         \
  }

TRACE_LAUNCHER(hit_finish_launch, hit_finish_kernel, lane_grid)
TRACE_LAUNCHER(instance_step_launch, instance_step_kernel, lane_grid)
TRACE_LAUNCHER(coherence_key_launch, coherence_key_kernel, lane_grid)
TRACE_LAUNCHER(permute_launch, permute_kernel, permute_grid)
