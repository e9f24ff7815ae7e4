// The wave's own kernels for Hopper (sm_90a): its primary rays and initial
// state, and the test and commit of one alpha resample pass.
//
// Replaces two pieces of what XLA makes of the JAX package's jit'd wave
// (vulkan_raytracer_tpu/render/renderer.py:52-88, render/integrator.py), each
// an XLA fusion and not a Pallas kernel:
//   primary_rays_kernel <- generate_primary_rays (integrator.py:403-442) and the
//                          initial state of render_sample (:936-960): the lane's
//                          pixel and sample, the TEA seed, the jitter, the camera
//                          ray, and the constant fields of the state
//   alpha_commit_kernel <- _alpha_test (:130-162) and the rest of the resample
//                          while_loop's body after its traversal (:195-214): the
//                          candidate's alpha (MASK cutoff, BLEND draw, the base
//                          texture's alpha), the commit of an accepted hit, the
//                          lower bound past a rejected one, the lanes still pending
// The plain PyTorch versions are primary_rays_reference and
// alpha_commit_reference in ops/wave.py: the port's generate_primary_rays, its
// state build, _alpha_test and the loop body's commit, regrouped.
//
// Design.  One thread per lane, 256 lanes a block, no shared memory.
// primary_rays_kernel reads the wave from the device: the sample numbers
// (int64, one per sample of the wave), the pixel lanes (int64, one per
// pixel) and the camera (float32: the inverse view, then the inverse
// projection, row-major), so a captured program reads whatever the renderer
// wrote there before its launch; lane i is pixel lanes[i % n] at sample
// samples[i / n] (samples-major).  alpha_commit_kernel reads the pass's
// candidates and writes the loop's next state over the loop's own buffers,
// only where a value changes, and adds the lanes still pending into the
// loop's 0-d int64 count with integer atomics (exact in any order), which
// the loop's condition reads.
//
// What bounds them.  Bytes.  primary_rays_kernel writes 78 bytes a lane (86
// with the repacked wave's slot) and reads 8 a pixel: ~14 us at 3.35 TB/s
// for the 524,288 lanes of a cfg1 wave.  alpha_commit_kernel reads a
// pending flag a lane and, on the pending lanes, the candidate and the
// alpha tables' rows; a few bytes a lane on most passes.
//
// Numerics: those of csrc/lane_math.cuh.  x / c for a Python number c is
// x * (1 / c) on the card (aten's division by a CPU scalar), so (px + jx) /
// float(width) is (px + jx) * (1 / width) here; t * (1.0 + 4e-7) takes the
// double folded before aten casts it.  Seeds are uint32; the int64 columns
// hold them masked.
//
// Launches go on the caller's stream; nothing here synchronises or
// allocates.  Each launcher returns cudaGetLastError().

#include "lane_math.cuh"

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
  // alpha_commit_kernel: the resample loop's state, read and written in place
  A_TLO, A_PENDING, A_T, A_TRI, A_U, A_V, A_SEED, A_COUNT,
  // the pass's candidates
  C_T, C_TRI, C_U, C_V,
  // the scene's tables
  AL_MODE, AL_VALUE, AL_CUTOFF, T_TRIMAT, T_UV, M_TEXIDX, TEX_TEXELS, TEX_OFF, TEX_H, TEX_W,
  kSlots
};

// Counts and flags; ops/wave.py INTS lists the same names in the same order.
enum Int { I_N, I_PIXELS, I_WIDTH, I_HEIGHT, I_PIXEL_ORDER, I_TEXTURES, I_PROTO_TRIS, kInts };

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

// _alpha_test and the commit of one resample pass, over the loop's state
__global__ void __launch_bounds__(kThreads) alpha_commit_kernel(const __grid_constant__ Args a) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  unsigned int still = 0;
  if (i < a.i[I_N] && col<const uint8_t>(a, A_PENDING)[i]) {
    const int tri = col<const int>(a, C_TRI)[i];
    bool rejected = false;
    if (tri >= 0) {  // a candidate: test it (hit.rahit:26-53)
      long long ti = tri, inst;
      if (a.i[I_PROTO_TRIS] > 0) decode_id(ti, a.i[I_PROTO_TRIS], ti, inst);
      const int mode = col<const int>(a, AL_MODE)[ti];
      float alpha = col<const float>(a, AL_VALUE)[ti];
      const float u = col<const float>(a, C_U)[i], v = col<const float>(a, C_V)[i];
      if (a.i[I_TEXTURES]) {  // times the base colour texture's alpha
        const int tex = col<const int>(a, M_TEXIDX)[col<const int>(a, T_TRIMAT)[ti] * 6LL];
        if (tex >= 0) {
          float uvx, uvy;
          uv_at(col<const float>(a, T_UV), ti, 1.0f - u - v, u, v, uvx, uvy);
          const Tex atlas = {col<const int>(a, TEX_TEXELS), col<const int>(a, TEX_OFF),
                             col<const int>(a, TEX_H), col<const int>(a, TEX_W)};
          alpha = alpha * sample_bilinear(atlas, tex, uvx, uvy).w;
        }
      }
      if (mode == 1) {  // MASK: below the cutoff
        rejected = alpha < col<const float>(a, AL_CUTOFF)[ti];
      } else if (mode == 2) {  // BLEND: with probability 1 - alpha, one draw
        long long* seeds = col<long long>(a, A_SEED);
        uint32_t s = static_cast<uint32_t>(seeds[i]);
        rejected = rnd(s) < 1.0f - alpha;
        seeds[i] = static_cast<long long>(s);
      }
      const float t = col<const float>(a, C_T)[i];
      if (rejected) {  // past the candidate (ignoreIntersectionEXT)
        col<float>(a, A_TLO)[i] = (isfinite(t) ? t : 0.0f) * K(1.0 + 4e-7) + K(1e-30);
      } else {  // the accepted hit
        col<float>(a, A_T)[i] = t;
        col<int>(a, A_TRI)[i] = tri;
        col<float>(a, A_U)[i] = u;
        col<float>(a, A_V)[i] = v;
      }
    }
    if (!rejected) col<uint8_t>(a, A_PENDING)[i] = 0;
    still = rejected;
  }
  still = __reduce_add_sync(0xFFFFFFFFu, still);
  if ((threadIdx.x & 31) == 0 && still)
    atomicAdd(col<unsigned long long>(a, A_COUNT), static_cast<unsigned long long>(still));
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
