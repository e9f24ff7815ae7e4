// The wave's own kernels for Hopper (sm_90a): its primary rays and initial
// state, and the finish, test and commit of one alpha resample pass.
//
// Replaces two pieces of what XLA makes of the JAX package's jit'd wave
// (vulkan_raytracer_tpu/render/renderer.py:52-88, render/integrator.py), each
// an XLA fusion and not a Pallas kernel:
//   primary_rays_kernel <- generate_primary_rays (integrator.py:403-442) and the
//                          initial state of render_sample (:936-960): the lane's
//                          pixel and sample, the TEA seed, the jitter, the camera
//                          ray, and the constant fields of the state
//   alpha_commit_kernel <- the rest of the resample while_loop's body after its
//                          Pallas call (:195-214): the closest hit's finish
//                          (ops/pallas_dense.py:282-298, ops/pallas_bvh.py:1309,
//                          :1343, ops/instanced.py:236-262), _alpha_test
//                          (:130-162: the candidate's alpha, MASK cutoff, BLEND
//                          draw, the base texture's alpha), the commit of an
//                          accepted hit, the lower bound past a rejected one,
//                          the lanes still pending, and the loop's next test
//                          (:192-193, the while_loop's cond)
// The plain PyTorch versions are primary_rays_reference and
// alpha_pass_reference in ops/wave.py: the port's generate_primary_rays, its
// state build, and hit_finish_reference then alpha_commit_reference
// (_alpha_test and the loop body's commit), regrouped.
//
// Design.  primary_rays_kernel: one thread per lane, 256 lanes a block, no
// shared memory.  It reads the wave from the device: the sample numbers
// (int64, one per sample of the wave), the pixel lanes (int64, one per
// pixel) and the camera (float32: the inverse view, then the inverse
// projection, row-major), so a captured program reads whatever the renderer
// wrote there before its launch; lane i is pixel lanes[i % n] at sample
// samples[i / n] (samples-major).  alpha_commit_kernel reads the pass's
// traversal as it came (t and the hit id, unfinished), finishes the hits of
// the pending lanes only (csrc/hit_finish.cuh, the function hit_finish_kernel
// runs on every lane of an opaque call), and writes the loop's next state
// over the loop's own buffers, only where a value changes.  Inside a
// program it also makes the loop's next test (csrc/graph_test.cuh): every
// block adds its still-pending lanes and its ticket into the loop's control
// block with one atomic, and the last block leaves the count there, keeps the
// loop node's row and sets its condition, where the loop's entry test armed
// the block with the handle (csrc/graph_loops.cu).  So a pass is its
// traversal and this one kernel: no finish over every lane, no memset of a
// count, no test node.
//
// alpha_commit_kernel: a thread a lane.  A lane's test is a chain of
// dependent gathers; the kernel reads the hit id beside the pending flag on
// every lane (4 bytes a lane more than a pending lane needs, one trip to
// memory fewer for each pending lane), then the finish's loads (the slot's
// triangle, the instance's map, the three vertices, the ray), then every
// load that depends only on the lane or that triangle (t, the seed; alpha
// mode, value and cutoff, material row, the three uvs), then the texture's
// row and its four texels.  A block adds its still-pending count once.  (Two
// designs measured slower on real waves: a tile's pending lanes gathered
// into shared memory and worked several a thread, and a persistent grid
// that read the next lane's flag ahead with the small tables staged in
// shared memory; PERF.md, PR 19.)
//
// What bounds them.  Bytes.  primary_rays_kernel writes 78 bytes a lane (86
// with the repacked wave's slot) and reads 8 a pixel: ~14 us at 3.35 TB/s
// for the 524,288 lanes of a cfg1 wave.  alpha_commit_kernel reads a
// pending flag a lane and, on the pending lanes, the candidate and the
// alpha tables' rows; a few bytes a lane on most passes, so a pass is
// bound by its launch and the latency of its chain of gathers.
//
// Numerics: those of csrc/lane_math.cuh.  x / c for a Python number c is
// x * (1 / c) on the card (aten's division by a CPU scalar), so (px + jx) /
// float(width) is (px + jx) * (1 / width) here; t * (1.0 + 4e-7) takes the
// double folded before aten casts it.  Seeds are uint32; the int64 columns
// hold them masked.
//
// Launches go on the caller's stream; nothing here synchronises or
// allocates.  Each launcher returns cudaGetLastError().

#include "graph_test.cuh"
#include "hit_finish.cuh"

namespace {

constexpr int kThreads = 256;

// One pointer per column; ops/wave.py SLOTS lists the same names in the same
// order.
enum Slot {
  // primary_rays_kernel's inputs: the wave
  W_SAMPLES, W_LANES, W_CAM,
  // its outputs: the initial state (S_SLOT null off the repacked wavefront)
  S_OX, S_OY, S_OZ, S_DX, S_DY, S_DZ, S_VALX, S_VALY, S_VALZ, S_TPX, S_TPY, S_TPZ,
  S_SKYX, S_SKYY, S_SKYZ, S_WL, S_MATPDF, S_SEED, S_ACTIVE, S_PREVIEW, S_SLOT,
  // alpha_commit_kernel: the resample loop's state, read and written in place,
  // and its control block (null eagerly)
  A_TLO, A_PENDING, A_T, A_TRI, A_U, A_V, A_SEED, A_LOOP,
  // the pass's traversal: its world rays, t and hit id (enum Finish)
  R_OX, R_OY, R_OZ, R_DX, R_DY, R_DZ, R_T, R_HIT,
  // the scene's tables: the finish's (csrc/hit_finish.cuh), the alpha test's
  T_V0X, T_V0Y, T_V0Z, T_V1X, T_V1Y, T_V1Z, T_V2X, T_V2Y, T_V2Z, T_TRIID, T_INVFLAT,
  AL_MODE, AL_VALUE, AL_CUTOFF, T_TRIMAT, T_UV, M_TEXIDX, TEX_TEXELS, TEX_OFF, TEX_H, TEX_W,
  kSlots
};

// Counts and flags; ops/wave.py INTS lists the same names in the same order.
enum Int {
  I_N, I_PIXELS, I_WIDTH, I_HEIGHT, I_PIXEL_ORDER, I_TEXTURES, I_PROTO_TRIS, I_MODE, I_NUM_INST,
  kInts
};

// A resample loop's control block, four 64-bit words (ops/wave.py LOOP_WORDS):
// the count's accumulator and block ticket (csrc/graph_test.cuh), the loop's
// conditional handle and the address of its row of counters, both written by
// its entry test where the loop runs on the card (0: not armed), and the count
// the last pass left pending.
enum LoopWord { kLoopWord, kLoopHandle, kLoopRow, kLoopCount };

struct Args {
  void* p[kSlots];
  long long i[kInts];
};

template <class T>
__device__ __forceinline__ T* col(const Args& a, int s) {
  return static_cast<T*>(a.p[s]);
}

// ops/rng.py tea: 16 rounds on uint32
__device__ __forceinline__ uint32_t tea(uint32_t v0, uint32_t v1) {
  uint32_t s = 0;
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    s += 0x9E3779B9u;
    v0 += ((v1 << 4) + 0xA341316Cu) ^ (v1 + s) ^ ((v1 >> 5) + 0xC8013EA4u);
    v1 += ((v0 << 4) + 0xAD90777Du) ^ (v0 + s) ^ ((v0 >> 5) + 0x7E95761Eu);
  }
  return v0;
}

// generate_primary_rays and render_sample's initial state, one lane a thread
__global__ void __launch_bounds__(kThreads) primary_rays_kernel(const __grid_constant__ Args a) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= a.i[I_N]) return;
  const long long n = a.i[I_PIXELS], w = a.i[I_WIDTH], h = a.i[I_HEIGHT];
  const long long lane = col<const long long>(a, W_LANES)[i % n];
  // rng.as_u32: the low 32 bits, held non-negative in int64
  const long long idx = lane & 0xFFFFFFFFLL;
  const uint32_t count = static_cast<uint32_t>(col<const long long>(a, W_SAMPLES)[i / n]);
  const float px = static_cast<float>(idx % w), py = static_cast<float>(idx / w);

  // TEA(pixel, sample); jitter: the pixel centre on the preview sample 0,
  // else two draws, which advance the seed (raygen.rgen:33-34)
  uint32_t seed = tea(static_cast<uint32_t>(idx), count);
  const bool preview = count == 0;
  float jx = K(0.5), jy = K(0.5);
  if (!preview) {
    jx = rnd(seed);
    jy = rnd(seed);
  }
  const float u = (px + jx) * (1.0f / static_cast<float>(w)) * 2.0f - 1.0f;
  const float v = -((py + jy) * (1.0f / static_cast<float>(h)) * 2.0f - 1.0f);

  // target = projInverse * (u, v, 1, 1), xyz only; then the inverse view's
  // rotation (raygen.rgen:41-43)
  const float* m = col<const float>(a, W_CAM);
  const float* p = m + 16;
  const V3 tgt = normalized({p[0] * u + p[1] * v + p[2] + p[3], p[4] * u + p[5] * v + p[6] + p[7],
                             p[8] * u + p[9] * v + p[10] + p[11]});
  const V3 d = normalized({m[0] * tgt.x + m[1] * tgt.y + m[2] * tgt.z,
                           m[4] * tgt.x + m[5] * tgt.y + m[6] * tgt.z,
                           m[8] * tgt.x + m[9] * tgt.y + m[10] * tgt.z});

  col<float>(a, S_OX)[i] = m[3];
  col<float>(a, S_OY)[i] = m[7];
  col<float>(a, S_OZ)[i] = m[11];
  col<float>(a, S_DX)[i] = d.x;
  col<float>(a, S_DY)[i] = d.y;
  col<float>(a, S_DZ)[i] = d.z;
  for (int s = S_VALX; s <= S_VALZ; ++s) col<float>(a, s)[i] = 0.0f;
  for (int s = S_TPX; s <= S_TPZ; ++s) col<float>(a, s)[i] = 1.0f;
  for (int s = S_SKYX; s <= S_SKYZ; ++s) col<float>(a, s)[i] = 0.0f;
  col<float>(a, S_WL)[i] = 0.0f;
  col<float>(a, S_MATPDF)[i] = 1.0f;
  col<long long>(a, S_SEED)[i] = static_cast<long long>(seed);
  col<uint8_t>(a, S_ACTIVE)[i] = 1;
  col<uint8_t>(a, S_PREVIEW)[i] = preview ? 1 : 0;
  // the lane's output position: its pixel where the wave's radiance comes
  // back in pixel order, else its own index
  if (a.p[S_SLOT]) col<long long>(a, S_SLOT)[i] = a.i[I_PIXEL_ORDER] ? lane : i;
}

// The finish of the pass's candidates (csrc/hit_finish.cuh), _alpha_test and
// the commit of one resample pass, over the loop's state, and the loop's
// test where the pass runs inside a program (see the note at the top); the
// arithmetic is the plain versions'
__global__ void __launch_bounds__(kThreads) alpha_commit_kernel(const __grid_constant__ Args a) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  // the flag and, beside it, the traversal's hit id
  const bool pend = i < a.i[I_N] && col<const uint8_t>(a, A_PENDING)[i];
  const int hit = i < a.i[I_N] ? col<const int>(a, R_HIT)[i] : -1;
  unsigned int still = 0;
  if (pend) {
    bool rejected = false;
    if (hit >= 0) {  // the finish: the candidate's triangle and (u, v)
      FinishTables f;
#pragma unroll
      for (int k = 0; k < 9; ++k) f.v[k] = col<const float>(a, T_V0X + k);
      f.tri_id = col<const int>(a, T_TRIID);
      f.inv_flat = col<const float>(a, T_INVFLAT);
      f.proto_tris = a.i[I_PROTO_TRIS];
      f.num_inst = a.i[I_NUM_INST];
      f.mode = static_cast<int>(a.i[I_MODE]);
      const V3 o = {col<const float>(a, R_OX)[i], col<const float>(a, R_OY)[i],
                    col<const float>(a, R_OZ)[i]};
      const V3 d = {col<const float>(a, R_DX)[i], col<const float>(a, R_DY)[i],
                    col<const float>(a, R_DZ)[i]};
      float u, v;
      long long ti;  // the triangle whose rows the tables hold
      const int tri = finish_hit(f, hit, o, d, u, v, ti);
      if (tri >= 0) {  // a candidate: test it (hit.rahit:26-53)
        const float tc = col<const float>(a, R_T)[i];
        const uint32_t seed = static_cast<uint32_t>(col<const long long>(a, A_SEED)[i]);
        const int mode = col<const int>(a, AL_MODE)[ti];
        float alpha = col<const float>(a, AL_VALUE)[ti];
        const float cutoff = col<const float>(a, AL_CUTOFF)[ti];
        if (a.i[I_TEXTURES]) {  // the base colour texture's alpha
          const int mat = col<const int>(a, T_TRIMAT)[ti];
          float uvx, uvy;
          uv_at(col<const float>(a, T_UV), ti, 1.0f - u - v, u, v, uvx, uvy);
          const int tex = col<const int>(a, M_TEXIDX)[mat * 6LL];
          if (tex >= 0) {
            const Tex atlas = {col<const int>(a, TEX_TEXELS), col<const int>(a, TEX_OFF),
                               col<const int>(a, TEX_H), col<const int>(a, TEX_W)};
            alpha = alpha * sample_bilinear(atlas, tex, uvx, uvy).w;
          }
        }
        if (mode == 1) {  // MASK: below the cutoff
          rejected = alpha < cutoff;
        } else if (mode == 2) {  // BLEND: with probability 1 - alpha, one draw
          uint32_t s = seed;
          rejected = rnd(s) < 1.0f - alpha;
          col<long long>(a, A_SEED)[i] = static_cast<long long>(s);
        }
        if (rejected) {  // past the candidate (ignoreIntersectionEXT)
          col<float>(a, A_TLO)[i] = (isfinite(tc) ? tc : 0.0f) * K(1.0 + 4e-7) + K(1e-30);
        } else {  // the accepted hit
          col<float>(a, A_T)[i] = tc;
          col<int>(a, A_TRI)[i] = tri;
          col<float>(a, A_U)[i] = u;
          col<float>(a, A_V)[i] = v;
        }
      }
    }
    if (!rejected) col<uint8_t>(a, A_PENDING)[i] = 0;
    still = rejected;
  }
  // the loop's count and test (eagerly there is no control block: the host
  // reads the flags)
  unsigned long long* loop = col<unsigned long long>(a, A_LOOP);
  if (loop == nullptr) return;
  long long total;
  if (!last_block(&loop[kLoopWord], block_sum(still), total)) return;
  loop[kLoopCount] = static_cast<unsigned long long>(total);
  long long* row = reinterpret_cast<long long*>(loop[kLoopRow]);
  if (row == nullptr) return;  // not armed: a replay of the pass, whose host reads the flags
  const bool go = total > 0;
  keep_row(row, false, go);
  cudaGraphSetConditional(static_cast<cudaGraphConditionalHandle>(loop[kLoopHandle]),
                          go ? 1u : 0u);
  if (!go) loop[kLoopRow] = 0;  // the loop ends: disarmed for a replay
}

// The kernels' parameters from the launcher's arrays, and their grid.
unsigned int fill(Args& args, const void* const* ptrs, const long long* ints) {
  for (int k = 0; k < kSlots; ++k) args.p[k] = const_cast<void*>(ptrs[k]);
  for (int k = 0; k < kInts; ++k) args.i[k] = ints[k];
  return static_cast<unsigned int>((args.i[I_N] + kThreads - 1) / kThreads);
}

}  // namespace

// (device, pointers [kSlots], counts [kInts], stream); ops/wave.py fills both
#define WAVE_LAUNCHER(name, kernel)                                                       \
  extern "C" int name(int device, const void* const* ptrs, const long long* ints,        \
                      void* stream) {                                                    \
    cudaError_t err = cudaSetDevice(device);                                             \
    if (err != cudaSuccess) return static_cast<int>(err);                                \
    Args args;                                                                           \
    const unsigned int blocks = fill(args, ptrs, ints);                                  \
    if (blocks > 0) kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(args); \
    return static_cast<int>(cudaGetLastError());                                         \
  }

WAVE_LAUNCHER(primary_rays_launch, primary_rays_kernel)
WAVE_LAUNCHER(alpha_commit_launch, alpha_commit_kernel)
