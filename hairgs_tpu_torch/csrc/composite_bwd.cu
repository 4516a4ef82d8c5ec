// Back-to-front gradient of the per-tile compositor, with the dual cotangent.
//
// Replaces the Pallas TPU kernel `_bwd_kernel`
// (hairgs_tpu/render/pallas_composite.py:272-453, launched by
// `_composite_bwd`, :600-702). Plain PyTorch version:
// hairgs_tpu_torch/render/composite_pairs.py::composite_pairs_bwd_plain.
//
// Design. One block of 256 threads per 16x16 tile, one thread per pixel. The
// block walks its tile's page back to front, staging each chunk's geometry
// and feature columns in shared memory. For a chunk, each thread first runs
// the forward again from the chunk's start transmittance (`tstarts`) to find
// its last live pair and the transmittance after it, then walks the chunk
// back to front, recovering the transmittance before each pair by dividing
// by (1 - alpha) (alpha <= 0.99, so the divisor is >= 0.01). A running
// suffix carry per pixel starts at T_final * g_T and gains w * (f . g) after
// each pair; with STATS a second carry does the same for the photometric
// cotangent alone, which yields the viewspace gradients of the aux rows.
// The 0.99 alpha clamp is ignored in the gradient, as the reference does.
//
// Feature plane: float or __nv_bfloat16 (`composite_bwd_bf16`). A bf16
// feature is widened to fp32 when it is staged; every sum stays fp32, and
// d_feat is written in the plane's dtype: each slot's fp32 block sum is
// rounded once, to nearest-even (__float2bfloat16_rn), as JAX rounds when it
// stores to the bf16 plane (pallas_composite.py:432-434). Rounding partial
// sums instead would compound the error.
//
// Each pair's 8 geometry gradients and C feature gradients are summed over
// the 256 pixels inside the block: a warp-shuffle tree per warp (skipped
// when no lane of the warp touched the pair), the 8 warp partials parked in
// shared memory, then one pass that adds them and writes the pair's own
// slot. No atomics, and the sums are deterministic. Masked tail slots of the
// chunk are written as zeros.
//
// Bound: every (pair, pixel) of a tile's list costs about 16 fp32
// operations in the alpha gates, and one that passes them about 100 more
// with STATS (the gradients, both carries and the pixel sums), against
// 4 * 6 + 4 * C (f32) or 2 * C (bf16) bytes read and 4 * 8 + 4 * C or 2 * C
// written per pair and the per-pixel
// cotangents, so at bench width the work is bound by operations
// (chip_smoke.py computes the bound). The kernel spends more than that: the
// warp-shuffle tree costs 5 steps per value and warp where the sum needs 1.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TILE = 16;
constexpr int PIX = TILE * TILE;
constexpr int WARPS = PIX / 32;
constexpr float T_EPS = 1e-4f;
constexpr float ALPHA_MAX = 0.99f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename TF> __device__ __forceinline__ TF from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <int C, bool STATS, typename TF>
__global__ void __launch_bounds__(PIX)
composite_bwd_kernel(const float* __restrict__ geo, const TF* __restrict__ feat,
                     const int* __restrict__ starts, const int* __restrict__ counts,
                     const float* __restrict__ tstarts,
                     const float* __restrict__ trans_final,
                     const float* __restrict__ g_out,
                     const float* __restrict__ g_photo,
                     const float* __restrict__ g_trans, float* __restrict__ d_geo,
                     TF* __restrict__ d_feat, long long p_pad, int grid_w,
                     int chunk, int max_chunks, float alpha_min) {
  constexpr int NV = 8 + C;  // reduced values per pair
  extern __shared__ float smem[];
  float* s_geo = smem;                // 6 rows x chunk
  float* s_feat = smem + 6 * chunk;   // C rows x chunk
  float* s_red = smem + (6 + C) * chunk;  // chunk x WARPS x NV partials

  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int lane = p & 31;
  const int warp = p >> 5;
  const float px = static_cast<float>((t % grid_w) * TILE + (p % TILE));
  const float py = static_cast<float>((t / grid_w) * TILE + (p / TILE));
  const int start = starts[t];
  const int count = counts[t];
  const int nchunks = (count + chunk - 1) / chunk;
  const long long pix_idx = static_cast<long long>(t) * PIX + p;

  float go[C], gp[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    go[c] = g_out[pix_idx * C + c];
    gp[c] = STATS ? g_photo[pix_idx * C + c] : 0.0f;
  }
  float carry = trans_final[pix_idx] * g_trans[pix_idx];
  float carry2 = 0.0f;

  for (int j = nchunks - 1; j >= 0; --j) {
    const long long base = start + static_cast<long long>(j) * chunk;
    const int n = min(chunk, count - j * chunk);
    __syncthreads();  // previous chunk's shared reads and writes are done
    for (int i = p; i < n; i += PIX) {
#pragma unroll
      for (int r = 0; r < 6; ++r) s_geo[r * chunk + i] = geo[r * p_pad + base + i];
#pragma unroll
      for (int c = 0; c < C; ++c)
        s_feat[c * chunk + i] = to_f32(feat[c * p_pad + base + i]);
    }
    __syncthreads();

    // forward again: the last live pair and the transmittance after it
    float t_cur = tstarts[(static_cast<long long>(t) * max_chunks + j) * PIX + p];
    int last = -1;
    for (int k = 0; k < n; ++k) {
      const float dx = s_geo[k] - px;
      const float dy = s_geo[chunk + k] - py;
      const float power = -0.5f * (s_geo[2 * chunk + k] * dx * dx +
                                   s_geo[4 * chunk + k] * dy * dy) -
                          s_geo[3 * chunk + k] * dx * dy;
      if (!(power <= 0.0f)) continue;
      const float alpha = fminf(ALPHA_MAX, s_geo[5 * chunk + k] * expf(power));
      if (!(alpha >= alpha_min)) continue;
      const float t_next = t_cur * (1.0f - alpha);
      if (t_next < T_EPS) break;
      t_cur = t_next;
      last = k;
    }

    // back to front over every slot of the chunk (block-uniform loop)
    for (int k = n - 1; k >= 0; --k) {
      float v[NV];
#pragma unroll
      for (int i = 0; i < NV; ++i) v[i] = 0.0f;
      bool use = false;
      if (k <= last) {
        const float dx = s_geo[k] - px;
        const float dy = s_geo[chunk + k] - py;
        const float a = s_geo[2 * chunk + k];
        const float b = s_geo[3 * chunk + k];
        const float cc = s_geo[4 * chunk + k];
        const float opa = s_geo[5 * chunk + k];
        const float power = -0.5f * (a * dx * dx + cc * dy * dy) - b * dx * dy;
        if (power <= 0.0f) {
          const float G = expf(power);
          const float alpha = fminf(ALPHA_MAX, opa * G);
          if (alpha >= alpha_min) {
            use = true;
            const float one_minus = 1.0f - alpha;
            const float t_excl = t_cur / one_minus;
            const float w = alpha * t_excl;
            float fdotg = 0.0f, fdotg2 = 0.0f;
#pragma unroll
            for (int c = 0; c < C; ++c) {
              const float f = s_feat[c * chunk + k];
              fdotg += go[c] * f;
              if (STATS) fdotg2 += gp[c] * f;
            }
            const float dalpha = t_excl * fdotg - carry / one_minus;
            const float dpower = opa * G * dalpha;
            v[0] = dpower * (-(a * dx + b * dy));
            v[1] = dpower * (-(cc * dy + b * dx));
            v[2] = dpower * (-0.5f * dx * dx);
            v[3] = dpower * (-dx * dy);
            v[4] = dpower * (-0.5f * dy * dy);
            v[5] = G * dalpha;
            carry += w * fdotg;
            if (STATS) {
              const float dpower2 = opa * G * (t_excl * fdotg2 - carry2 / one_minus);
              v[6] = dpower2 * (-(a * dx + b * dy));
              v[7] = dpower2 * (-(cc * dy + b * dx));
              carry2 += w * fdotg2;
            }
#pragma unroll
            for (int c = 0; c < C; ++c) v[8 + c] = go[c] * w;
            t_cur = t_excl;
          }
        }
      }
      float* red = s_red + (static_cast<long long>(k) * WARPS + warp) * NV;
      if (__any_sync(0xffffffffu, use)) {
#pragma unroll
        for (int i = 0; i < NV; ++i) {
          float x = v[i];
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            x += __shfl_xor_sync(0xffffffffu, x, off);
          if (lane == 0) red[i] = x;
        }
      } else if (lane == 0) {
#pragma unroll
        for (int i = 0; i < NV; ++i) red[i] = 0.0f;
      }
    }
    __syncthreads();

    // add the warp partials and write every slot of the chunk (tail: zeros)
    for (int idx = p; idx < chunk * NV; idx += PIX) {
      const int k = idx / NV;
      const int i = idx % NV;
      if (base + k >= p_pad) continue;
      float s = 0.0f;
      if (k < n) {
#pragma unroll
        for (int w = 0; w < WARPS; ++w) s += s_red[(k * WARPS + w) * NV + i];
      }
      if (i < 8)
        d_geo[i * p_pad + base + k] = s;
      else
        d_feat[(i - 8) * p_pad + base + k] = from_f32<TF>(s);
    }
  }
}

template <int C, bool STATS, typename TF>
cudaError_t launch(const float* geo, const TF* feat, const int* starts,
                   const int* counts, const float* tstarts, const float* trans,
                   const float* g_out, const float* g_photo, const float* g_trans,
                   float* d_geo, TF* d_feat, int num_tiles, long long p_pad,
                   int grid_w, int chunk, int max_chunks, float alpha_min,
                   cudaStream_t stream) {
  const size_t smem =
      (static_cast<size_t>(6 + C) * chunk + static_cast<size_t>(chunk) * WARPS * (8 + C)) *
      sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        composite_bwd_kernel<C, STATS, TF>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  composite_bwd_kernel<C, STATS, TF><<<num_tiles, PIX, smem, stream>>>(
      geo, feat, starts, counts, tstarts, trans, g_out, g_photo, g_trans, d_geo,
      d_feat, p_pad, grid_w, chunk, max_chunks, alpha_min);
  return cudaGetLastError();
}

template <typename TF>
int dispatch(const float* geo, const TF* feat, const int* starts,
             const int* counts, const float* tstarts, const float* trans,
             const float* g_out, const float* g_photo, const float* g_trans,
             float* d_geo, TF* d_feat, int num_tiles, int p_pad, int grid_w,
             int chunk, int max_chunks, int num_channels, int c_pad,
             int with_stats, float alpha_min, void* stream) {
  if (num_tiles == 0) return 0;
  if (num_channels > c_pad) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define COMPOSITE_BWD_CASE(C)                                                  \
  case C:                                                                      \
    return static_cast<int>(                                                   \
        with_stats                                                             \
            ? launch<C, true, TF>(geo, feat, starts, counts, tstarts, trans,   \
                                  g_out, g_photo, g_trans, d_geo, d_feat,      \
                                  num_tiles, p_pad, grid_w, chunk, max_chunks, \
                                  alpha_min, s)                                \
            : launch<C, false, TF>(geo, feat, starts, counts, tstarts, trans,  \
                                   g_out, g_photo, g_trans, d_geo, d_feat,     \
                                   num_tiles, p_pad, grid_w, chunk,            \
                                   max_chunks, alpha_min, s));
  switch (num_channels) {
    COMPOSITE_BWD_CASE(1)
    COMPOSITE_BWD_CASE(2)
    COMPOSITE_BWD_CASE(3)
    COMPOSITE_BWD_CASE(4)
    COMPOSITE_BWD_CASE(5)
    COMPOSITE_BWD_CASE(6)
    COMPOSITE_BWD_CASE(7)
    COMPOSITE_BWD_CASE(8)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef COMPOSITE_BWD_CASE
}

}  // namespace

// Inputs as the forward's, plus tstarts (num_tiles * max_chunks, 256), the
// final transmittance (num_tiles, 256), g_out (the total-loss cotangent) and
// g_photo (the photometric one), both (num_tiles, 256, num_channels), and
// g_trans (num_tiles, 256), all f32. counts must already be clamped to the
// chunks the forward ran. d_geo (8, p_pad) f32 and d_feat (c_pad, p_pad), in
// the feature dtype (f32 for composite_bwd, bf16 for composite_bwd_bf16),
// are zero-filled by the caller; each tile writes its own slots. Returns the
// launch's CUDA error.
extern "C" int composite_bwd(const float* geo, const float* feat,
                             const int* starts, const int* counts,
                             const float* tstarts, const float* trans,
                             const float* g_out, const float* g_photo,
                             const float* g_trans, float* d_geo, float* d_feat,
                             int num_tiles, int p_pad, int grid_w, int chunk,
                             int max_chunks, int num_channels, int c_pad,
                             int with_stats, float alpha_min, void* stream) {
  return dispatch(geo, feat, starts, counts, tstarts, trans, g_out, g_photo,
                  g_trans, d_geo, d_feat, num_tiles, p_pad, grid_w, chunk,
                  max_chunks, num_channels, c_pad, with_stats, alpha_min,
                  stream);
}

extern "C" int composite_bwd_bf16(const float* geo, const __nv_bfloat16* feat,
                                  const int* starts, const int* counts,
                                  const float* tstarts, const float* trans,
                                  const float* g_out, const float* g_photo,
                                  const float* g_trans, float* d_geo,
                                  __nv_bfloat16* d_feat, int num_tiles,
                                  int p_pad, int grid_w, int chunk,
                                  int max_chunks, int num_channels, int c_pad,
                                  int with_stats, float alpha_min,
                                  void* stream) {
  return dispatch(geo, feat, starts, counts, tstarts, trans, g_out, g_photo,
                  g_trans, d_geo, d_feat, num_tiles, p_pad, grid_w, chunk,
                  max_chunks, num_channels, c_pad, with_stats, alpha_min,
                  stream);
}
