// Per-tile front-to-back compositing over the chunk-aligned paged pair table.
//
// Replaces the Pallas TPU kernel `_fwd_kernel`
// (hairgs_tpu/render/pallas_composite.py:153-269, launched by
// `_forward_pallas`, :520-584). Plain PyTorch version:
// hairgs_tpu_torch/render/composite_pairs.py::composite_pairs_fwd_plain.
//
// Design. One block of 256 threads per 16x16 tile, one thread per pixel. The
// block walks its tile's page chunk by chunk; each chunk's geometry (x, y,
// conic, opacity) and feature columns are staged in shared memory once and
// read by all 256 pixels, so device memory sees each pair slot once. Each
// thread keeps its pixel's transmittance T and colour sums in registers.
//
// Chunk semantics of the reference: inside a chunk a pair is live while the
// running product over ALL pairs of the chunk stays >= T_EPS; the thread
// drops out for the rest of the chunk at the first pair that would take it
// below, and T becomes the product over the live pairs only, so the latch
// starts again at the next chunk. The transmittance at the start of every
// chunk j < nchunks is written to `tstarts` for the backward.
//
// Feature plane: float or __nv_bfloat16 (`composite_fwd_bf16`, the
// counterpart of RasterConfig.feat_bf16). A bf16 feature is widened to fp32
// when it is staged in shared memory, so shared memory and every sum stay
// fp32; the gates, alpha and T touch no feature, so T and tstarts of a bf16
// plane equal those of the f32 plane bit for bit.
//
// Arithmetic: fp32, products taken in slot order, T multiplied by (1-alpha)
// step by step. The reference forms the same product as
// exp(cumsum(log1p(-alpha))); the two differ in rounding only. The library
// is built with --fmad=false so every product rounds as in the plain
// version, which therefore takes the alpha-gate and latch decisions
// identically (a contracted build decides some of them otherwise).
//
// Bound: every (pair, pixel) of a tile's list costs about 16 fp32
// operations in the alpha gates, and one that passes them about 19 more,
// against 4 * 6 + 4 * C (f32) or 2 * C (bf16) bytes read per pair and
// 4 * (C + 1) bytes written per pixel, so at bench width the work is bound by operations (chip_smoke.py
// computes the bound from each view's own counts).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TILE = 16;
constexpr int PIX = TILE * TILE;
constexpr float T_EPS = 1e-4f;
constexpr float ALPHA_MAX = 0.99f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <int C, typename TF>
__global__ void __launch_bounds__(PIX)
composite_fwd_kernel(const float* __restrict__ geo, const TF* __restrict__ feat,
                     const int* __restrict__ starts, const int* __restrict__ counts,
                     float* __restrict__ out, float* __restrict__ trans_out,
                     float* __restrict__ tstarts, long long p_pad, int grid_w,
                     int chunk, int max_chunks, float alpha_min) {
  extern __shared__ float smem[];
  float* s_geo = smem;               // 6 rows x chunk: x, y, a, b, c, opacity
  float* s_feat = smem + 6 * chunk;  // C rows x chunk

  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const float px = static_cast<float>((t % grid_w) * TILE + (p % TILE));
  const float py = static_cast<float>((t / grid_w) * TILE + (p / TILE));
  const int start = starts[t];
  const int count = counts[t];
  const int nchunks = (count + chunk - 1) / chunk;

  float T = 1.0f;
  float acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = 0.0f;
  bool done = false;

  for (int j = 0; j < nchunks; ++j) {
    tstarts[(static_cast<long long>(t) * max_chunks + j) * PIX + p] = T;
    if (done) continue;  // block-uniform: every pixel saturated
    const long long base = start + static_cast<long long>(j) * chunk;
    const int n = min(chunk, count - j * chunk);
    __syncthreads();  // the previous chunk's readers are done
    for (int i = p; i < n; i += PIX) {
#pragma unroll
      for (int r = 0; r < 6; ++r) s_geo[r * chunk + i] = geo[r * p_pad + base + i];
#pragma unroll
      for (int c = 0; c < C; ++c)
        s_feat[c * chunk + i] = to_f32(feat[c * p_pad + base + i]);
    }
    __syncthreads();

    float t_run = T;
    for (int k = 0; k < n; ++k) {
      const float dx = s_geo[k] - px;
      const float dy = s_geo[chunk + k] - py;
      const float a = s_geo[2 * chunk + k];
      const float b = s_geo[3 * chunk + k];
      const float cc = s_geo[4 * chunk + k];
      const float power = -0.5f * (a * dx * dx + cc * dy * dy) - b * dx * dy;
      if (!(power <= 0.0f)) continue;
      const float alpha = fminf(ALPHA_MAX, s_geo[5 * chunk + k] * expf(power));
      if (!(alpha >= alpha_min)) continue;
      const float t_next = t_run * (1.0f - alpha);
      if (t_next < T_EPS) break;  // latched for the rest of this chunk
      const float w = alpha * t_run;
#pragma unroll
      for (int c = 0; c < C; ++c) acc[c] = acc[c] + w * s_feat[c * chunk + k];
      t_run = t_next;
    }
    T = t_run;
    done = __syncthreads_and(T < T_EPS);
  }

  const long long o = static_cast<long long>(t) * PIX + p;
#pragma unroll
  for (int c = 0; c < C; ++c) out[o * C + c] = acc[c];
  trans_out[o] = T;
}

template <int C, typename TF>
cudaError_t launch(const float* geo, const TF* feat, const int* starts,
                   const int* counts, float* out, float* trans, float* tstarts,
                   int num_tiles, long long p_pad, int grid_w, int chunk,
                   int max_chunks, float alpha_min, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(6 + C) * chunk * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        composite_fwd_kernel<C, TF>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  composite_fwd_kernel<C, TF><<<num_tiles, PIX, smem, stream>>>(
      geo, feat, starts, counts, out, trans, tstarts, p_pad, grid_w, chunk,
      max_chunks, alpha_min);
  return cudaGetLastError();
}

template <typename TF>
int dispatch(const float* geo, const TF* feat, const int* starts,
             const int* counts, float* out, float* trans, float* tstarts,
             int num_tiles, int p_pad, int grid_w, int chunk, int max_chunks,
             int num_channels, int c_pad, float alpha_min, void* stream) {
  if (num_tiles == 0) return 0;
  if (num_channels > c_pad) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define COMPOSITE_FWD_CASE(C)                                                  \
  case C:                                                                      \
    return static_cast<int>(launch<C, TF>(geo, feat, starts, counts, out,      \
                                          trans, tstarts, num_tiles, p_pad,    \
                                          grid_w, chunk, max_chunks,           \
                                          alpha_min, s));
  switch (num_channels) {
    COMPOSITE_FWD_CASE(1)
    COMPOSITE_FWD_CASE(2)
    COMPOSITE_FWD_CASE(3)
    COMPOSITE_FWD_CASE(4)
    COMPOSITE_FWD_CASE(5)
    COMPOSITE_FWD_CASE(6)
    COMPOSITE_FWD_CASE(7)
    COMPOSITE_FWD_CASE(8)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef COMPOSITE_FWD_CASE
}

}  // namespace

// geo (8, p_pad) row-major f32 and feat (c_pad, p_pad) row-major, f32
// (composite_fwd) or bf16 (composite_fwd_bf16); starts, counts
// (num_tiles,) int32. out (num_tiles, 256, num_channels), trans
// (num_tiles, 256), tstarts (num_tiles * max_chunks, 256), all f32, the
// latter zero-filled by the caller. Returns the CUDA error of the launch
// (0 = ok).
extern "C" int composite_fwd(const float* geo, const float* feat,
                             const int* starts, const int* counts, float* out,
                             float* trans, float* tstarts, int num_tiles,
                             int p_pad, int grid_w, int chunk, int max_chunks,
                             int num_channels, int c_pad, float alpha_min,
                             void* stream) {
  return dispatch(geo, feat, starts, counts, out, trans, tstarts, num_tiles,
                  p_pad, grid_w, chunk, max_chunks, num_channels, c_pad,
                  alpha_min, stream);
}

extern "C" int composite_fwd_bf16(const float* geo, const __nv_bfloat16* feat,
                                  const int* starts, const int* counts,
                                  float* out, float* trans, float* tstarts,
                                  int num_tiles, int p_pad, int grid_w,
                                  int chunk, int max_chunks, int num_channels,
                                  int c_pad, float alpha_min, void* stream) {
  return dispatch(geo, feat, starts, counts, out, trans, tstarts, num_tiles,
                  p_pad, grid_w, chunk, max_chunks, num_channels, c_pad,
                  alpha_min, stream);
}
