// Per-tile front-to-back compositing over the chunk-aligned paged pair table.
//
// Replaces the Pallas TPU kernel `_fwd_kernel`
// (hairgs_tpu/render/pallas_composite.py:153-269, launched by
// `_forward_pallas`, :520-584). Plain PyTorch version:
// hairgs_tpu_torch/render/composite_pairs.py::composite_pairs_fwd_plain.
//
// Design. One block of 256 threads per 16x16 tile, one thread per pixel,
// warp w on the 16x2 strip of rows 2w and 2w+1. The block walks its tile's
// page chunk by chunk. Each chunk is staged in shared memory as an array of
// structures with a per-pair warp mask (composite_common.cuh). Each warp walks
// only the slots whose alpha >= alpha_min ellipse can reach its strip, in
// slot order (a ballot over 32 slots at a time): a skipped slot is one
// where every lane of the warp fails the gate, so every pixel's sums are
// those of a walk over all slots. Each thread keeps its pixel's
// transmittance T and colour sums in registers.
//
// Chunk semantics of the reference: inside a chunk a pair is live while the
// running product over ALL pairs of the chunk stays >= T_EPS; the thread
// drops out for the rest of the chunk at the first pair that would take it
// below (the latch), and T becomes the product over the live pairs only, so
// the latch starts again at the next chunk. For the backward the forward
// writes, for every chunk j < nchunks, the transmittance at its start
// (`tstarts`) and, for every chunk it runs, each pixel's latch slot
// (`latch`, int16, -1 for none): the backward starts each chunk from there
// and from the T after it (tstarts[j+1], or the final T) instead of running
// the chunk forward again. Chunks after the block-uniform early exit (every
// pixel below T_EPS) are not run; their latch rows keep the caller's -1.
//
// Feature plane: float or __nv_bfloat16 (`composite_fwd_bf16`, the
// counterpart of RasterConfig.feat_bf16). A bf16 feature is widened to fp32
// when it is staged, so every sum stays fp32; the gates, alpha and T touch
// no feature, so T, tstarts and latch of a bf16 plane equal those of the
// f32 plane bit for bit.
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
// 4 * (C + 1) bytes written per pixel, so at bench width the work is bound
// by operations (chip_smoke.py computes the bound from each view's own
// counts). Most pair-pixels fail the gates; the warp masks keep a warp
// from evaluating pairs whose ellipse misses its strip.

#include "composite_common.cuh"

namespace {

using namespace composite;

// at most 64 registers a thread: 4 resident blocks (32 warps) per SM
constexpr int MIN_BLOCKS = 4;

template <int C, typename TF>
__global__ void __launch_bounds__(PIX, MIN_BLOCKS)
composite_fwd_kernel(const float* __restrict__ geo, const TF* __restrict__ feat,
                     const int* __restrict__ starts, const int* __restrict__ counts,
                     float* __restrict__ out, float* __restrict__ trans_out,
                     float* __restrict__ tstarts, short* __restrict__ latch,
                     long long p_pad, int grid_w, int chunk, int max_chunks,
                     float alpha_min) {
  extern __shared__ float4 smem4[];
  const Staging st(reinterpret_cast<unsigned char*>(smem4), chunk);

  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int lane = p & 31;
  const int warp = p >> 5;
  const float tx0 = static_cast<float>((t % grid_w) * TILE);
  const float ty0 = static_cast<float>((t / grid_w) * TILE);
  const float px = tx0 + static_cast<float>(p % TILE);
  const float py = ty0 + static_cast<float>(p / TILE);
  const int start = starts[t];
  const int count = counts[t];
  const int nchunks = (count + chunk - 1) / chunk;

  float T = 1.0f;
  float acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = 0.0f;
  bool done = false;

  for (int j = 0; j < nchunks; ++j) {
    const long long row = (static_cast<long long>(t) * max_chunks + j) * PIX + p;
    tstarts[row] = T;
    if (done) continue;  // block-uniform: every pixel saturated
    const long long base = start + static_cast<long long>(j) * chunk;
    const int n = min(chunk, count - j * chunk);
    __syncthreads();  // the previous chunk's readers are done
    stage<C>(st, geo, feat, p_pad, base, n, tx0, ty0, alpha_min);
    __syncthreads();

    float t_run = T;
    bool live = true;
    int lat = -1;
    for (int k0 = 0; k0 < n; k0 += 32) {
      if (!__any_sync(FULL, live)) break;
      unsigned bits = warp_slots(st.mask, k0, n, lane, warp);
      while (bits) {
        const int k = k0 + __ffs(bits) - 1;
        bits &= bits - 1;
        if (!live) continue;
        const float4 g0 = st.geo[2 * k];
        const float4 g1 = st.geo[2 * k + 1];
        const float dx = g0.x - px;
        const float dy = g0.y - py;
        const float power = -0.5f * (g0.z * dx * dx + g1.x * dy * dy) - g0.w * dx * dy;
        if (!(power <= 0.0f)) continue;
        const float alpha = fminf(ALPHA_MAX, g1.y * expf(power));
        if (!(alpha >= alpha_min)) continue;
        const float t_next = t_run * (1.0f - alpha);
        if (t_next < T_EPS) {  // latched for the rest of this chunk
          live = false;
          lat = k;
          continue;
        }
        const float w = alpha * t_run;
        const float4 f0 = st.feat[2 * k];
        const float4 f1 = st.feat[2 * k + 1];
        const float f[8] = {f0.x, f0.y, f0.z, f0.w, f1.x, f1.y, f1.z, f1.w};
#pragma unroll
        for (int c = 0; c < C; ++c) acc[c] = acc[c] + w * f[c];
        t_run = t_next;
      }
    }
    latch[row] = static_cast<short>(lat);
    T = t_run;
    done = __syncthreads_and(T < T_EPS);
  }

  const long long o = static_cast<long long>(t) * PIX + p;
#pragma unroll
  for (int c = 0; c < C; ++c) out[o * C + c] = acc[c];
  trans_out[o] = T;
}

template <int C, typename TF>
cudaError_t prepare(int chunk, size_t* smem) {
  *smem = Staging::bytes(chunk);
  if (*smem > 48 * 1024)
    return cudaFuncSetAttribute(composite_fwd_kernel<C, TF>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(*smem));
  return cudaSuccess;
}

template <int C, typename TF>
cudaError_t launch(const float* geo, const TF* feat, const int* starts,
                   const int* counts, float* out, float* trans, float* tstarts,
                   short* latch, int num_tiles, long long p_pad, int grid_w,
                   int chunk, int max_chunks, float alpha_min, cudaStream_t stream) {
  size_t smem;
  cudaError_t e = prepare<C, TF>(chunk, &smem);
  if (e != cudaSuccess) return e;
  composite_fwd_kernel<C, TF><<<num_tiles, PIX, smem, stream>>>(
      geo, feat, starts, counts, out, trans, tstarts, latch, p_pad, grid_w, chunk,
      max_chunks, alpha_min);
  return cudaGetLastError();
}

template <int C, typename TF>
cudaError_t occupancy(int chunk, int* blocks) {
  size_t smem;
  cudaError_t e = prepare<C, TF>(chunk, &smem);
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, composite_fwd_kernel<C, TF>, PIX, smem);
}

#define COMPOSITE_FWD_SWITCH(CALL)  \
  switch (num_channels) {           \
    case 1: return CALL(1);         \
    case 2: return CALL(2);         \
    case 3: return CALL(3);         \
    case 4: return CALL(4);         \
    case 5: return CALL(5);         \
    case 6: return CALL(6);         \
    case 7: return CALL(7);         \
    case 8: return CALL(8);         \
    default: return static_cast<int>(cudaErrorInvalidValue); \
  }

template <typename TF>
int dispatch(const float* geo, const TF* feat, const int* starts,
             const int* counts, float* out, float* trans, float* tstarts,
             short* latch, int num_tiles, int p_pad, int grid_w, int chunk,
             int max_chunks, int num_channels, int c_pad, float alpha_min,
             void* stream) {
  if (num_tiles == 0) return 0;
  if (num_channels > c_pad || chunk < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define LAUNCH(C)                                                                \
  static_cast<int>(launch<C, TF>(geo, feat, starts, counts, out, trans, tstarts, \
                                 latch, num_tiles, p_pad, grid_w, chunk,         \
                                 max_chunks, alpha_min, s))
  COMPOSITE_FWD_SWITCH(LAUNCH)
#undef LAUNCH
}

}  // namespace

// geo (8, p_pad) row-major f32 and feat (c_pad, p_pad) row-major, f32
// (composite_fwd) or bf16 (composite_fwd_bf16); starts, counts
// (num_tiles,) int32. out (num_tiles, 256, num_channels), trans
// (num_tiles, 256), tstarts (num_tiles * max_chunks, 256), all f32, the
// latter zero-filled by the caller; latch (num_tiles * max_chunks, 256)
// int16, filled with -1 by the caller. Returns the CUDA error of the launch
// (0 = ok).
extern "C" int composite_fwd(const float* geo, const float* feat,
                             const int* starts, const int* counts, float* out,
                             float* trans, float* tstarts, short* latch,
                             int num_tiles, int p_pad, int grid_w, int chunk,
                             int max_chunks, int num_channels, int c_pad,
                             float alpha_min, void* stream) {
  return dispatch(geo, feat, starts, counts, out, trans, tstarts, latch, num_tiles,
                  p_pad, grid_w, chunk, max_chunks, num_channels, c_pad,
                  alpha_min, stream);
}

extern "C" int composite_fwd_bf16(const float* geo, const __nv_bfloat16* feat,
                                  const int* starts, const int* counts,
                                  float* out, float* trans, float* tstarts,
                                  short* latch, int num_tiles, int p_pad,
                                  int grid_w, int chunk, int max_chunks,
                                  int num_channels, int c_pad, float alpha_min,
                                  void* stream) {
  return dispatch(geo, feat, starts, counts, out, trans, tstarts, latch, num_tiles,
                  p_pad, grid_w, chunk, max_chunks, num_channels, c_pad,
                  alpha_min, stream);
}

// Resident blocks per SM of the kernel at this channel count, feature dtype
// (bf16 != 0) and chunk, from cudaOccupancyMaxActiveBlocksPerMultiprocessor.
extern "C" int composite_fwd_blocks_per_sm(int num_channels, int bf16, int chunk,
                                           int* blocks) {
#define OCC(C) static_cast<int>(bf16 ? occupancy<C, __nv_bfloat16>(chunk, blocks) \
                                     : occupancy<C, float>(chunk, blocks))
  COMPOSITE_FWD_SWITCH(OCC)
#undef OCC
}
