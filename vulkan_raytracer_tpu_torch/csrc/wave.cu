// The wave's own kernels for Hopper (sm_90a): its primary rays and initial
// state, the finish, test and commit of one alpha resample pass, the wave's
// tail (its deferred sky and its sum), and the frame's post-processing.
//
// Replaces what XLA makes of the JAX package's jit'd wave and frame
// (vulkan_raytracer_tpu/render/renderer.py:52-88, :244-292,
// render/integrator.py), each an XLA fusion and not a Pallas kernel:
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
//   wave_sum_kernel     <- the deferred skybox fetch after the bounce loop
//                          (:1128-1137, ops/texture.py:170 sample_equirect), the
//                          repacked wave's scatter to its lanes' slots and the
//                          wave's sum over its samples into the band's sum
//                          (renderer.py:79-80, :109) with its rays
//   frame_post_kernel   <- _postprocess (renderer.py:244-251) with the headless
//                          frame's scatter to pixel order, and _frame_step's tail
//                          (:259-292): accumulate, divide, tonemap, quantise,
//                          decimate to the display's cells
// The plain PyTorch versions are primary_rays_reference,
// alpha_pass_reference, wave_sum_reference, frame_image_reference and
// frame_progressive_reference in ops/wave.py: the port's
// generate_primary_rays, its state build, hit_finish_reference then
// alpha_commit_reference (_alpha_test and the loop body's commit), the
// integrator's _radiance, index_copy_ and _add_wave, and the renderer's
// _postprocess and _frame_step tail, regrouped.
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
// wave_sum_kernel: a lane's radiance is its gathered value plus its sky
// weight times the equirect sky at its direction (four corner fetches from
// the map's r, g and b columns, the strength read from the device).  A thread
// a lane: a block takes a tile of I_TILE pixels x the wave's k samples
// (samples-major lanes j * n + p, so the tile is k coalesced rows of its
// pixels), kSumRows samples or fewer a chunk (I_TILE x rows = kThreads).
// Each thread copies its lane's value and sky weight, and the block the
// tile's band sums, into shared memory asynchronously (cp.async) while it
// fetches the sky, so a lane waits on memory about once, not three times,
// and holds no register for them; it puts its lane's radiance in shared memory;
// then one thread a pixel adds the chunk's samples to the pixel's running
// sum, sample 0 first and one after another (the order wave_sum_reference
// states), and the tile's sums go back into the band's sum, coalesced.  The
// kernel is an instance a mode and radiance flag (the registers each needs
// fix how many blocks an SM holds: kSumBlocks).  The per-lane radiance is
// written only where a caller reads it (Q_RAD not null: a sample of the
// progressive frame, render_sample), from shared memory as 16-byte stores
// along each row.  On a repacked wave a lane's output position is its slot,
// a permutation of the whole wave, so a pixel's samples can lie anywhere: a
// first launch (kSumScatter, a thread a lane) writes each lane's radiance at
// its slot of a padded (n * k, 4) scratch, one 16-byte store, and a second
// (kSumAdd) works the tiles over the scratch, reading it coalesced.  The
// last launch also adds the wave's rays into the frame's counter.  Lanes and
// their floats are indexed in 32 bits (the wrapper refuses a wave of 2^29
// lanes or more, which no card holds the state of).  A lane
// whose sky weight is zero still fetches the sky: the product is +0 only for
// a finite, non-negative sky at a finite direction, which no table records,
// and the fetch is what decides it.
//
// frame_post_kernel: an instance a job (enum FramePost), its note beside it
// below.
//
// What bounds them.  Bytes.  primary_rays_kernel writes 78 bytes a lane (86
// with the repacked wave's slot) and reads 8 a pixel: ~14 us at 3.35 TB/s
// for the 524,288 lanes of a cfg1 wave.  alpha_commit_kernel reads a
// pending flag a lane and, on the pending lanes, the candidate and the
// alpha tables' rows; a few bytes a lane on most passes, so a pass is
// bound by its launch and the latency of its chain of gathers.
// wave_sum_kernel reads 36 bytes a lane (direction, value, sky weight),
// writes 12 (its radiance) only where asked, 8 more read on a repacked wave
// (the slot) and 16 written and read back (the scratch), and reads and writes
// a pixel's 12 of the sum: ~7.5 us for a cfg1 wave without its radiance; the
// sky's texels mostly come from L2.
// frame_post_kernel reads 12 (headless: 20, with the lane's pixel) and writes
// 3 or 12 bytes a pixel, the accumulation's 12 read and written on top in
// the progressive frame: 6-10 MB at 512x512, ~2-3 us, about what one launch
// costs the card whatever it does.
//
// Numerics: those of csrc/lane_math.cuh.  x / c for a Python number c is
// x * (1 / c) on the card (aten's division by a CPU scalar), so (px + jx) /
// float(width) is (px + jx) * (1 / width) here, and so are the frame's sum
// over spp and the progressive mean; t * (1.0 + 4e-7) takes the double
// folded before aten casts it.  Seeds are uint32; the int64 columns hold them
// masked.  The sky: atan2f and asinf are libdevice's, which aten's kernels
// call; the bilinear weights in aten's order, c00 * (1 - fx) + c01 * fx, then
// the same in y; torch.remainder is a floor-mod.  A float's cast to uint8 goes
// through int64, as c10's does.
//
// Launches go on the caller's stream; nothing here synchronises or
// allocates.  Each launcher returns cudaGetLastError().

#include <cuda_pipeline_primitives.h>

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
  // wave_sum_kernel (beside the state's S_D, S_VAL, S_SKY and S_SLOT): the sky
  // map's r, g and b columns and its strength (0-d), the wave's rays (0-d), its
  // radiance (n * k, 3; null where no caller reads it), the band's sum (n, 3;
  // null where the caller reads only the radiance), the frame's rays (0-d)
  // and a repacked wave's scratch (n * k, 4)
  E_R, E_G, E_B, E_STRENGTH, Q_RAYS, Q_RAD, Q_SUM, Q_FRAME_RAYS, Q_SCRATCH,
  // frame_post_kernel: the frame's (n, 3) sum or the sample's radiance, the
  // lanes' pixels (headless), the accumulation and the sample number
  // (progressive), the image (float32 or uint8)
  F_SRC, F_LANES, F_ACCUM, F_SAMPLE, F_OUT,
  kSlots
};

// Counts and flags; ops/wave.py INTS lists the same names in the same order.
enum Int {
  I_N, I_PIXELS, I_WIDTH, I_HEIGHT, I_PIXEL_ORDER, I_TEXTURES, I_PROTO_TRIS, I_MODE, I_NUM_INST,
  I_K, I_SUM_MODE, I_ENV_H, I_ENV_W, I_FRAME_MODE, I_SPP, I_TONEMAP, I_UINT8, I_DISP_H, I_DISP_W,
  I_TILE, kInts
};

// wave_sum_kernel's launches (ops/wave.py SUM_MODES): a wave in lane order in
// one; a repacked wave's scatter to its slots, then its sum.
enum SumMode { kSumLanes, kSumScatter, kSumAdd };

// Samples a chunk of a tail's tile at most (ops/wave.py SUM_ROWS): a tile is
// kThreads / kSumRows pixels or more.
constexpr int kSumRows = 8;

// frame_post_kernel's modes (ops/wave.py FRAME_MODES).
enum FrameMode { kFrameImage, kFrameProgressive };

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
  keep_row(row, false, go, total);
  cudaGraphSetConditional(static_cast<cudaGraphConditionalHandle>(loop[kLoopHandle]),
                          go ? 1u : 0u);
  if (!go) loop[kLoopRow] = 0;  // the loop ends: disarmed for a replay
}

// ---------------------------------------------------------------------------
// The wave's tail: the deferred sky and the sum
// ---------------------------------------------------------------------------

__device__ __forceinline__ long long floor_mod64(long long a, long long b) {  // torch.remainder
  long long r = a % b;
  if (r != 0 && ((r < 0) != (b < 0))) r += b;
  return r;
}

// The floor-mod of a texel coordinate a by the map's width or height b, in
// 32 bits (|a| < 2^24, 1 <= b < 2^24): a few adds where a lies within two
// periods of [0, b), as every finite direction's does, the division only
// beyond them
__device__ __forceinline__ int wrap(int a, int b) {
  if (a >= 0 && a < b) return a;
  if (a < 0 && a >= -2 * b) return a + b >= 0 ? a + b : a + 2 * b;
  if (a >= b && a < 2 * b) return a - b;
  const int r = a % b;
  return r < 0 ? r + b : r;
}

// The sky at texels k00 .. k11 of the map (columns E_R, E_G, E_B) by the
// bilinear weights of fx and fy, in aten's order, times the strength
template <class Index>
__device__ __forceinline__ void sky_texels(const Args& a, Index k00, Index k01, Index k10,
                                           Index k11, float fx, float fy, float sky[3]) {
  const float gx = 1.0f - fx, gy = 1.0f - fy;
  const float strength = *col<const float>(a, E_STRENGTH);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float* m = col<const float>(a, E_R + c);
    const float top = m[k00] * gx + m[k01] * fx;
    const float bot = m[k10] * gx + m[k11] * fx;
    sky[c] = (top * gy + bot * fy) * strength;
  }
}

// The equirect sky at lane i's direction (sample_equirect), times the
// strength
__device__ __forceinline__ void lane_sky(const Args& a, int i, float sky[3]) {
  const float dx = col<const float>(a, S_DX)[i], dy = col<const float>(a, S_DY)[i],
              dz = col<const float>(a, S_DZ)[i];
  const long long h = a.i[I_ENV_H], w = a.i[I_ENV_W];
  const float u = atan2f(dz, dx) * TWOPIINV + K(0.5);
  const float v = -(asinf(clamp(dy, K(-1.0), K(1.0))) * PIINV + K(0.5));
  const float x = u * static_cast<float>(w) - K(0.5);
  const float y = v * static_cast<float>(h) - K(0.5);
  const float x0 = floorf(x), y0 = floorf(y);
  const float fx = x - x0, fy = y - y0;
  if (fabsf(x0) < K(16777216.0) && fabsf(y0) < K(16777216.0) && w < (1 << 24) &&
      h < (1 << 24) && h * w < (1LL << 31)) {
    // every finite direction on a map of fewer than 2^31 texels: the same
    // integers in 32 bits
    const int w32 = static_cast<int>(w), h32 = static_cast<int>(h);
    const int xi = static_cast<int>(x0), yi = static_cast<int>(y0);
    const int xa = wrap(xi, w32), x1 = wrap(xi + 1, w32);
    const int ya = wrap(yi, h32), y1 = wrap(yi + 1, h32);
    sky_texels(a, ya * w32 + xa, ya * w32 + x1, y1 * w32 + xa, y1 * w32 + x1, fx, fy, sky);
  } else {  // what a NaN direction casts (aten's int64), or a map that large
    const long long x0l = static_cast<long long>(x0), y0l = static_cast<long long>(y0);
    const long long x1 = floor_mod64(x0l + 1, w), y1 = floor_mod64(y0l + 1, h);
    const long long xa = floor_mod64(x0l, w), ya = floor_mod64(y0l, h);
    sky_texels(a, ya * w + xa, ya * w + x1, y1 * w + xa, y1 * w + x1, fx, fy, sky);
  }
}

// A repacked wave's scratch: a lane's radiance as one 16-byte row
__device__ __forceinline__ void store4(float* scratch, int row, V3 v) {
  reinterpret_cast<float4*>(scratch)[row] = make_float4(v.x, v.y, v.z, 0.0f);
}
__device__ __forceinline__ V3 load4(const float* scratch, int row) {
  const float4 q = reinterpret_cast<const float4*>(scratch)[row];
  return {q.x, q.y, q.z};
}

// A tile's shared memory: a chunk's radiance (row j of the tile's pixels at
// j * I_TILE); each lane's value and sky weight, copied in while its thread
// fetches the sky; the band's sum of the tile's pixels, copied in at the
// tile's start and stored back at its end
struct SumTile {
  float v[3][kThreads];
  float pre[6][kThreads];
  float sum[3 * kThreads];
};

// A float from global into shared memory, asynchronously (cp.async): no
// register holds it, and the thread waits for it only where it reads it
__device__ __forceinline__ void copy_in(float* dst, const float* src) {
  __pipeline_memcpy_async(dst, src, sizeof(float));
}

// Lane i's radiance: its value plus its sky weight times the sky
__device__ __forceinline__ V3 lane_radiance(const Args& a, int i) {
  float sky[3];
  lane_sky(a, i, sky);
  return {col<const float>(a, S_VALX)[i] + col<const float>(a, S_SKYX)[i] * sky[0],
          col<const float>(a, S_VALY)[i] + col<const float>(a, S_SKYY)[i] * sky[1],
          col<const float>(a, S_VALZ)[i] + col<const float>(a, S_SKYZ)[i] * sky[2]};
}

// The same, its value and sky weight copied into shared memory (pre[.][t],
// thread t of its block) while the thread fetches the sky: a tile's lanes
// (the scatter, which holds its own loads in 32 registers, measured faster
// without the copies)
__device__ __forceinline__ V3 lane_radiance(const Args& a, int i, SumTile& sm) {
  const int t = threadIdx.x;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    copy_in(&sm.pre[c][t], &col<const float>(a, S_VALX + c)[i]);
    copy_in(&sm.pre[3 + c][t], &col<const float>(a, S_SKYX + c)[i]);
  }
  __pipeline_commit();
  float sky[3];
  lane_sky(a, i, sky);
  __pipeline_wait_prior(0);
  return {sm.pre[0][t] + sm.pre[3][t] * sky[0], sm.pre[1][t] + sm.pre[4][t] * sky[1],
          sm.pre[2][t] + sm.pre[5][t] * sky[2]};
}

// kSumScatter: lane i's radiance at its slot of the scratch
__device__ __forceinline__ void scatter_lane(const Args& a, int i) {
  store4(col<float>(a, Q_SCRATCH), static_cast<int>(col<const long long>(a, S_SLOT)[i]),
         lane_radiance(a, i));
}

// The chunk's m rows of radiance from shared memory into the (n * k, 3)
// output: row j (sample c0 + j) is 3 * width floats from 3 * ((c0 + j) * n +
// p0), stored as 16-byte stores and, where the row's ends are not 16-byte
// aligned, up to three single floats at each end
__device__ __forceinline__ void store_rows(float* rad, int c0, int m, int n, int p0, int width,
                                           int tile, const SumTile& sm) {
  const int units = 3 * tile / 4 + 6;  // a row's stores at most
  const int count = 3 * width;
  for (int w = threadIdx.x; w < m * units; w += kThreads) {
    const int j = w / units, u = w % units;
    const int base = 3 * ((c0 + j) * n + p0);
    const int head = min(count, static_cast<int>((4 - (base & 3)) & 3));
    const int body = (count - head) / 4;
    const int tail = count - head - 4 * body;
    const float* v0 = sm.v[0] + j * tile;
    const float* v1 = sm.v[1] + j * tile;
    const float* v2 = sm.v[2] + j * tile;
    auto at = [&](int e) {
      const int c = e % 3, p = e / 3;
      return c == 0 ? v0[p] : (c == 1 ? v1[p] : v2[p]);
    };
    if (u < head) {
      rad[base + u] = at(u);
    } else if (u < head + body) {
      const int e = head + 4 * (u - head);
      *reinterpret_cast<float4*>(rad + base + e) =
          make_float4(at(e), at(e + 1), at(e + 2), at(e + 3));
    } else if (u < head + body + tail) {
      const int e = head + 4 * body + (u - head - body);
      rad[base + e] = at(e);
    }
  }
}

// One tile of the wave's tail (see the note at the top): pixels tile * I_TILE
// on, all k samples; the radiance computed (kSumLanes) or read from the
// scratch (kSumAdd), and written where a caller reads it (kRad)
template <bool kFromScratch, bool kRad>
__device__ __forceinline__ void tile_sum(const Args& a, int tile, SumTile& sm) {
  const int n = static_cast<int>(a.i[I_PIXELS]), k = static_cast<int>(a.i[I_K]);
  const int size = static_cast<int>(a.i[I_TILE]);
  const int rows = kThreads / size;
  const int t = threadIdx.x, pl = t & (size - 1), jl = t >> (__ffs(size) - 1);  // a power of 2
  const int p0 = tile * size;
  const int width = min(size, n - p0);
  // the tile's 3 * width floats of the band's sum (none where the caller
  // reads only the radiance)
  float* sum = a.p[Q_SUM] ? col<float>(a, Q_SUM) + 3 * p0 : nullptr;
  if (sum != nullptr) {
    for (int e = t; e < 3 * width; e += kThreads) copy_in(&sm.sum[e], &sum[e]);
  }
  __pipeline_commit();
  V3 acc = zero3();
  for (int c0 = 0; c0 < k; c0 += rows) {
    const int m = min(rows, k - c0);
    if (jl < m && pl < width) {
      const int lane = (c0 + jl) * n + p0 + pl;
      const V3 r = kFromScratch ? load4(col<const float>(a, Q_SCRATCH), lane)
                                : lane_radiance(a, lane, sm);
      sm.v[0][t] = r.x;
      sm.v[1][t] = r.y;
      sm.v[2][t] = r.z;
    }
    __pipeline_wait_prior(0);  // the sums' copies, before the barrier shows them
    __syncthreads();
    if (t < width) {  // the pixel's samples of the chunk, one after another
      for (int j = 0; j < m; ++j) {
        const V3 r = {sm.v[0][j * size + t], sm.v[1][j * size + t], sm.v[2][j * size + t]};
        acc = (c0 == 0 && j == 0) ? r : add(acc, r);
      }
    }
    if (kRad) store_rows(col<float>(a, Q_RAD), c0, m, n, p0, width, size, sm);
    __syncthreads();
  }
  if (sum == nullptr) return;
  if (t < width) {
    sm.sum[3 * t] = sm.sum[3 * t] + acc.x;
    sm.sum[3 * t + 1] = sm.sum[3 * t + 1] + acc.y;
    sm.sum[3 * t + 2] = sm.sum[3 * t + 2] + acc.z;
  }
  __syncthreads();
  for (int e = t; e < 3 * width; e += kThreads) sum[e] = sm.sum[e];  // coalesced
}

// Blocks an SM each instance of wave_sum_kernel is built for (its registers'
// bound): eight, all a 2,048-thread SM takes, for the scatter and the sum over
// the scratch, which fit 32 registers; six for the tile that computes its
// lanes' radiance, which measured faster at 40 registers and six blocks than
// at 32 and eight (PERF.md §6).
template <int kMode>
constexpr int kSumBlocks = kMode == kSumLanes ? 6 : 8;

// The deferred sky, the repacked wave's scatter and the wave's sum (see the
// note at the top), an instance a mode and whether the radiance is written
// (Q_RAD not null), so each holds only its own code's registers; I_N
// threads: the lanes (kSumScatter), or kThreads a tile (kSumLanes, kSumAdd)
template <int kMode, bool kRad>
__global__ void __launch_bounds__(kThreads, kSumBlocks<kMode>)
    wave_sum_kernel(const __grid_constant__ Args a) {
  if (kMode == kSumScatter) {
    const int i = blockIdx.x * kThreads + threadIdx.x;
    if (i < a.i[I_N]) scatter_lane(a, i);
    return;
  }
  __shared__ SumTile sm;
  if (blockIdx.x == 0 && threadIdx.x == 0) {  // the frame's rays
    *col<long long>(a, Q_FRAME_RAYS) += *col<const long long>(a, Q_RAYS);
  }
  tile_sum<kMode == kSumAdd, kRad>(a, blockIdx.x, sm);
}

// ---------------------------------------------------------------------------
// The frame's post-processing
// ---------------------------------------------------------------------------

// frame_post_kernel's instances, one a job: the headless frame's image in
// uint8 or float32 (kFrameImage), the progressive frame shown at its own
// size, and the progressive frame decimated to the display's cells
// (kFrameProgressive).
//
// Design.  A launch moves 6-10 MB at 512x512, ~2-3 us at the memory's rate,
// beside ~1.2-1.3 us that an empty kernel's launch takes the card: the grid
// has to hide the memory's latency and drain quickly.  Indices are 32-bit
// (the wrapper refuses a frame of 2^29 pixels or more).  The headless
// instances work a thread a lane: its three sums, its pixel (int64) and its
// three bytes (or floats) at the pixel.  Four lanes a thread, their sums as
// three 16-byte loads, their pixels as two and a run of four pixels stored
// as three 32-bit stores where block order gives one, measured slower at
// every size (at 512x512 a grid of 65,536 threads hides too little of the
// latency), and two lanes a thread between them (PERF.md §6).  The
// progressive frame at its own size works kFrameLanes pixels a thread: the
// radiance and the accumulation three 16-byte loads each, the accumulation
// written back as three 16-byte stores (the preview sample 0 stores zeros
// and reads none), the image as three 32-bit stores; a thread whose pixels
// pass the frame's end, or a launch whose columns are not so aligned, works
// a pixel at a time; the block reads the sample number once.  One and two
// pixels a thread measured slower.  The decimating instance keeps a thread
// a display cell, which works its fy x fx pixels, and one a pixel that no
// cell shows.  Each instance is built for as many blocks an SM as its
// registers allow (kFrameBlocks).  128-thread blocks, loads that prefetch
// 256 bytes into L2 and loads outside the read-only path measured the same
// within their spread, and 32 registers a thread (spilling) slower.
//
// Numerics (unchanged): the mean is x * (1 / spp) and the progressive mean
// x * (1 / sample), Reinhard-Jodie in the plain version's order, the cast to
// uint8 through int64, the cells' integer mean.
enum FramePost { kPostUint8, kPostFloat, kPostPixels, kPostCells };

// Pixels a thread of the progressive instance at the frame's size works
// (ops/wave.py FRAME_LANES)
constexpr int kFrameLanes = 4;

// Blocks an SM each instance of frame_post_kernel is built for, by the
// registers ptxas gives it (65,536 an SM, allocated 8 a thread at a time,
// over 256 threads a block): the headless ones take 19 and the progressive
// frame at its size 32, eight blocks; the decimating one 39, six
template <int kJob>
constexpr int kFrameBlocks = kJob == kPostCells ? 6 : 8;

// Reinhard-Jodie (ops/tonemap.py reinhard_jodie) of one pixel's channels v,
// in place
__device__ __forceinline__ void jodie(float v[3]) {
  const float lum = v[0] * K(0.2126) + v[1] * K(0.7152) + v[2] * K(0.0722);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float tv = v[c] / (1.0f + v[c]);
    v[c] = (v[c] / (1.0f + lum)) * (1.0f - tv) + tv * tv;
  }
}

// One channel's displayed byte: clamped, * 255 + 0.5, cast through int64
__device__ __forceinline__ uint8_t quantise(float v) {
  return static_cast<uint8_t>(static_cast<long long>(clamp(v, 0.0f, 1.0f) * 255.0f + K(0.5)));
}

// The displayed value of one pixel's channels v: tonemapped where `tone`,
// then quantised
__device__ __forceinline__ void shown(bool tone, float v[3], uint8_t q[3]) {
  if (tone) jodie(v);
#pragma unroll
  for (int c = 0; c < 3; ++c) q[c] = quantise(v[c]);
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// A 16-byte load of data read once
__device__ __forceinline__ float4 load16(const float4* p) { return __ldg(p); }

// Twelve floats from three 16-byte loads at p, in order (through the
// read-only path where `once`: data the kernel does not write)
__device__ __forceinline__ void load12(const float* p, float v[kFrameLanes][3], bool once) {
  const float4* q = reinterpret_cast<const float4*>(p);
  const float4 x = once ? load16(q) : q[0], y = once ? load16(q + 1) : q[1],
               z = once ? load16(q + 2) : q[2];
  const float f[12] = {x.x, x.y, x.z, x.w, y.x, y.y, y.z, y.w, z.x, z.y, z.z, z.w};
#pragma unroll
  for (int e = 0; e < 12; ++e) v[e / 3][e % 3] = f[e];
}

// Twelve floats as three 16-byte stores at p, in order
__device__ __forceinline__ void store12(float* p, const float v[kFrameLanes][3]) {
  float4* q = reinterpret_cast<float4*>(p);
  q[0] = make_float4(v[0][0], v[0][1], v[0][2], v[1][0]);
  q[1] = make_float4(v[1][1], v[1][2], v[2][0], v[2][1]);
  q[2] = make_float4(v[2][2], v[3][0], v[3][1], v[3][2]);
}

// Twelve bytes as three 32-bit stores at p (4-byte aligned), in order
__device__ __forceinline__ void store12(uint8_t* p, const uint8_t q[kFrameLanes][3]) {
  uint32_t w[3] = {0u, 0u, 0u};
#pragma unroll
  for (int e = 0; e < 12; ++e) w[e / 4] |= static_cast<uint32_t>(q[e / 3][e % 3]) << (8 * (e % 4));
  uint32_t* o = reinterpret_cast<uint32_t*>(p);
  o[0] = w[0];
  o[1] = w[1];
  o[2] = w[2];
}

// kPostUint8, kPostFloat: lane i of the headless frame, written at its pixel
template <bool kUint8>
__device__ __forceinline__ void image_lane(const Args& a, int i) {
  if (i >= a.i[I_PIXELS]) return;
  const float* src = col<const float>(a, F_SRC) + 3 * i;
  const int p = static_cast<int>(col<const long long>(a, F_LANES)[i]);
  const float inv = 1.0f / static_cast<float>(a.i[I_SPP]);
  float v[3] = {src[0] * inv, src[1] * inv, src[2] * inv};
  const bool tone = a.i[I_TONEMAP] != 0;
  if (kUint8) {
    uint8_t q[3];
    shown(tone, v, q);
    uint8_t* out = col<uint8_t>(a, F_OUT) + 3 * p;
    out[0] = q[0];
    out[1] = q[1];
    out[2] = q[2];
    return;
  }
  if (tone) jodie(v);
  float* out = col<float>(a, F_OUT) + 3 * p;
  out[0] = v[0];
  out[1] = v[1];
  out[2] = v[2];
}

// A progressive pixel p: the accumulation updated (zeroed by the preview
// sample), the value shown quantised
__device__ __forceinline__ void progressive_pixel(const Args& a, int p, long long sample,
                                                  float inv, uint8_t q[3]) {
  const float* rad = col<const float>(a, F_SRC) + 3 * p;
  float* acc = col<float>(a, F_ACCUM) + 3 * p;
  float v[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    if (sample == 0) {
      acc[c] = 0.0f;
      v[c] = rad[c];
    } else {
      const float sum = acc[c] + rad[c];
      acc[c] = sum;
      v[c] = sum * inv;
    }
  }
  shown(true, v, q);
}

// kPostPixels: thread g's pixels of the progressive frame shown at its size
__device__ __forceinline__ void progressive_lanes(const Args& a, int g, long long sample) {
  const int n = static_cast<int>(a.i[I_PIXELS]);
  const int i0 = g * kFrameLanes;
  if (i0 >= n) return;
  const int m = min(kFrameLanes, n - i0);
  const float inv = 1.0f / static_cast<float>(sample);
  const float* rad = col<const float>(a, F_SRC);
  float* acc = col<float>(a, F_ACCUM);
  uint8_t* out = col<uint8_t>(a, F_OUT);
  if (m < kFrameLanes || !aligned16(rad) || !aligned16(acc) ||
      (reinterpret_cast<uintptr_t>(out) & 3) != 0) {
    for (int j = 0; j < m; ++j) {
      uint8_t q[3];
      progressive_pixel(a, i0 + j, sample, inv, q);
#pragma unroll
      for (int c = 0; c < 3; ++c) out[3 * (i0 + j) + c] = q[c];
    }
    return;
  }
  float v[kFrameLanes][3];
  load12(rad + 3 * i0, v, true);
  if (sample == 0) {
    const float zero[kFrameLanes][3] = {};
    store12(acc + 3 * i0, zero);
  } else {
    float s[kFrameLanes][3];
    load12(acc + 3 * i0, s, false);
#pragma unroll
    for (int j = 0; j < kFrameLanes; ++j) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        s[j][c] = s[j][c] + v[j][c];
        v[j][c] = s[j][c] * inv;
      }
    }
    store12(acc + 3 * i0, s);
  }
  uint8_t q[kFrameLanes][3];
#pragma unroll
  for (int j = 0; j < kFrameLanes; ++j) shown(true, v[j], q[j]);
  store12(out + 3 * i0, q);
}

// kPostCells: thread i's display cell (its pixels' integer mean), or a
// pixel no cell shows (only accumulated): the columns right of the cells,
// then the rows below
__device__ __forceinline__ void progressive_cells(const Args& a, int i, long long sample) {
  const int w = static_cast<int>(a.i[I_WIDTH]), h = static_cast<int>(a.i[I_HEIGHT]);
  const int dh = static_cast<int>(a.i[I_DISP_H]), dw = static_cast<int>(a.i[I_DISP_W]);
  const int fy = h / dh, fx = w / dw;
  const float inv = 1.0f / static_cast<float>(sample);
  uint8_t q[3];
  if (i < dh * dw) {
    const int cy = i / dw, cx = i - cy * dw;
    int s[3] = {0, 0, 0};
    for (int yy = 0; yy < fy; ++yy) {
      const int row = (cy * fy + yy) * w + cx * fx;
      for (int xx = 0; xx < fx; ++xx) {
        progressive_pixel(a, row + xx, sample, inv, q);
        s[0] += q[0];
        s[1] += q[1];
        s[2] += q[2];
      }
    }
    uint8_t* out = col<uint8_t>(a, F_OUT) + 3 * i;
    const int cell = fy * fx;
    out[0] = static_cast<uint8_t>(s[0] / cell);
    out[1] = static_cast<uint8_t>(s[1] / cell);
    out[2] = static_cast<uint8_t>(s[2] / cell);
    return;
  }
  const int j = i - dh * dw, rows = dh * fy, cols = dw * fx, right = rows * (w - cols);
  const int p = j < right ? (j / (w - cols)) * w + cols + j % (w - cols) : rows * w + (j - right);
  progressive_pixel(a, p, sample, inv, q);
}

// The frame's tail (see the note above), instance kJob; I_N threads: the
// frame's lanes (kPostUint8, kPostFloat), its pixels over kFrameLanes
// (kPostPixels), or its display cells and then the pixels no cell shows
// (kPostCells)
template <int kJob>
__global__ void __launch_bounds__(kThreads, kFrameBlocks<kJob>)
    frame_post_kernel(const __grid_constant__ Args a) {
  const int g = blockIdx.x * kThreads + threadIdx.x;
  if (kJob == kPostUint8 || kJob == kPostFloat) {
    image_lane<kJob == kPostUint8>(a, g);
    return;
  }
  __shared__ long long sample;  // read once a block
  if (threadIdx.x == 0) sample = *col<const long long>(a, F_SAMPLE);
  __syncthreads();
  if (kJob == kPostPixels) {
    progressive_lanes(a, g, sample);
  } else if (g < a.i[I_N]) {
    progressive_cells(a, g, sample);
  }
}

// An empty kernel, on no path: the floor one launch sets under any kernel's
// time (chip_smoke.py times it as it times frame_post_kernel)
__global__ void empty_kernel() {}

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

// wave_sum_kernel's launch: its instance by I_SUM_MODE and whether Q_RAD is
// given (the scatter writes no radiance)
extern "C" int wave_sum_launch(int device, const void* const* ptrs, const long long* ints,
                               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Args args;
  const unsigned int blocks = fill(args, ptrs, ints);
  if (blocks == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool rad = args.p[Q_RAD] != nullptr;
  switch (static_cast<int>(args.i[I_SUM_MODE])) {
    case kSumScatter:
      wave_sum_kernel<kSumScatter, false><<<blocks, kThreads, 0, s>>>(args);
      break;
    case kSumAdd:
      if (rad) {
        wave_sum_kernel<kSumAdd, true><<<blocks, kThreads, 0, s>>>(args);
      } else {
        wave_sum_kernel<kSumAdd, false><<<blocks, kThreads, 0, s>>>(args);
      }
      break;
    default:
      if (rad) {
        wave_sum_kernel<kSumLanes, true><<<blocks, kThreads, 0, s>>>(args);
      } else {
        wave_sum_kernel<kSumLanes, false><<<blocks, kThreads, 0, s>>>(args);
      }
  }
  return static_cast<int>(cudaGetLastError());
}

// frame_post_kernel's launch: its instance by I_FRAME_MODE, I_UINT8 and
// whether the display is the frame's own size
extern "C" int frame_post_launch(int device, const void* const* ptrs, const long long* ints,
                                 void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Args args;
  const unsigned int blocks = fill(args, ptrs, ints);
  if (blocks == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (args.i[I_FRAME_MODE] == kFrameImage) {
    if (args.i[I_UINT8]) {
      frame_post_kernel<kPostUint8><<<blocks, kThreads, 0, s>>>(args);
    } else {
      frame_post_kernel<kPostFloat><<<blocks, kThreads, 0, s>>>(args);
    }
  } else if (args.i[I_DISP_H] == args.i[I_HEIGHT] && args.i[I_DISP_W] == args.i[I_WIDTH]) {
    frame_post_kernel<kPostPixels><<<blocks, kThreads, 0, s>>>(args);
  } else {
    frame_post_kernel<kPostCells><<<blocks, kThreads, 0, s>>>(args);
  }
  return static_cast<int>(cudaGetLastError());
}

// empty_kernel's launch: `blocks` blocks of kThreads threads
extern "C" int empty_launch(int device, long long blocks, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (blocks > 0) {
    empty_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>();
  }
  return static_cast<int>(cudaGetLastError());
}
