// Back-to-front gradient of the per-tile compositor, with the dual cotangent.
//
// Replaces the Pallas TPU kernel `_bwd_kernel`
// (hairgs_tpu/render/pallas_composite.py:272-453, launched by
// `_composite_bwd`, :600-702). Plain PyTorch version:
// hairgs_tpu_torch/render/composite_pairs.py::composite_pairs_bwd_plain.
//
// Design. One block of 256 threads per 16x16 tile, one thread per pixel,
// warp w on the 16x2 strip of rows 2w and 2w+1. The block walks its tile's
// page back to front, staging each chunk as the forward does
// (composite_common.cuh: an array of structures and a warp mask per
// pair). Each pixel starts chunk j
// from what the forward recorded: the transmittance after the chunk
// (tstarts[j+1], or the final T after the last chunk) and its latch slot
// (`latch`, -1 for none); pairs at or after the latch slot are not live.
// It then walks back, recovering the transmittance before each pair by
// dividing by (1 - alpha) (alpha <= 0.99, so the divisor is >= 0.01). A
// running suffix carry per pixel starts at T_final * g_T and gains
// w * (f . g) after each pair; with STATS a second carry does the same for
// the photometric cotangent alone, which yields the viewspace gradients of
// the aux rows. The 0.99 alpha clamp is ignored in the gradient, as the
// reference does.
//
// Each warp walks only the slots of its mask (32 at a time, back to front).
// Each pair's 8 geometry and C feature gradients (padded to 16 values) are
// summed over the warp by a transposed butterfly: at xor offset 16 each
// lane keeps 8 values and sends 8, at 8 it keeps 4, then 2, 1, and a last
// step adds the one value: 16 shuffles per (slot, warp) instead of 5 per
// value. The offsets run 16, 8, 4, 2, 1 and fp32 addition commutes, so
// each value goes through the addition tree of a per-value xor tree, which
// the plain version's `_block_sum` repeats. The warp partials of 32 slots
// are parked in shared memory (two buffers, so one barrier per 32 slots);
// then one pass adds, for each slot, the partials of the warps of its mask
// in warp order (a warp outside the mask holds a zero partial) and writes
// the pair's own slot. No atomics, and the sums are deterministic. Slots
// past a tile's count stay the caller's zeros.
//
// Feature plane: float or __nv_bfloat16 (`composite_bwd_bf16`). A bf16
// feature is widened to fp32 when it is staged; every sum stays fp32, and
// d_feat is written in the plane's dtype: each slot's fp32 block sum is
// rounded once, to nearest-even (__float2bfloat16_rn), as JAX rounds when it
// stores to the bf16 plane (pallas_composite.py:432-434).
//
// Bound: every (pair, pixel) of a tile's list costs about 16 fp32
// operations in the alpha gates, and one that passes them about 100 more
// with STATS (the gradients, both carries and the pixel sums), against
// 4 * 6 + 4 * C (f32) or 2 * C (bf16) bytes read and 4 * 8 + 4 * C or 2 * C
// written per pair and the per-pixel cotangents, so at bench width the work
// is bound by operations (chip_smoke.py computes the bound). No pair is
// evaluated twice (the forward's latch plane replaces a forward rerun), and
// the warp masks keep a warp from pairs whose ellipse misses its strip.

#include "composite_common.cuh"

namespace {

using namespace composite;

// at most 64 registers a thread: 4 resident blocks (32 warps) per SM
constexpr int MIN_BLOCKS = 4;

constexpr int NV = 16;              // reduced values per pair: 8 geometry, C <= 8 features
constexpr int GROUP = 32;           // slots per partial buffer
constexpr int RED_STRIDE = GROUP + 1;  // padded: conflict-free writes and reads
constexpr int RED_FLOATS = WARPS * NV * RED_STRIDE;

template <typename TF> __device__ __forceinline__ TF from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

size_t smem_bytes(int chunk) {
  return Staging::bytes(chunk) + 2 * sizeof(float) * RED_FLOATS;
}

// Sum over the 32 lanes of 16 values at once. Afterwards lane L holds the
// sum of value (L >> 1) & 15.
__device__ __forceinline__ float warp_sum16(const float (&v)[NV], int lane) {
  float x8[8], x4[4], x2[2];
  const bool u16 = lane & 16, u8 = lane & 8, u4 = lane & 4, u2 = lane & 2;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float keep = u16 ? v[i + 8] : v[i];
    const float send = u16 ? v[i] : v[i + 8];
    x8[i] = keep + __shfl_xor_sync(FULL, send, 16);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float keep = u8 ? x8[i + 4] : x8[i];
    const float send = u8 ? x8[i] : x8[i + 4];
    x4[i] = keep + __shfl_xor_sync(FULL, send, 8);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float keep = u4 ? x4[i + 2] : x4[i];
    const float send = u4 ? x4[i] : x4[i + 2];
    x2[i] = keep + __shfl_xor_sync(FULL, send, 4);
  }
  const float keep = u2 ? x2[1] : x2[0];
  const float send = u2 ? x2[0] : x2[1];
  const float x1 = keep + __shfl_xor_sync(FULL, send, 2);
  return x1 + __shfl_xor_sync(FULL, x1, 1);
}

template <int C, bool STATS, typename TF>
__global__ void __launch_bounds__(PIX, MIN_BLOCKS)
composite_bwd_kernel(const float* __restrict__ geo, const TF* __restrict__ feat,
                     const int* __restrict__ starts, const int* __restrict__ counts,
                     const float* __restrict__ tstarts,
                     const short* __restrict__ latch,
                     const float* __restrict__ trans_final,
                     const float* __restrict__ g_out,
                     const float* __restrict__ g_photo,
                     const float* __restrict__ g_trans, float* __restrict__ d_geo,
                     TF* __restrict__ d_feat, long long p_pad, int grid_w,
                     int chunk, int max_chunks, float alpha_min) {
  constexpr int NVAL = 8 + C;  // values written per pair
  extern __shared__ float4 smem4[];
  const Staging st(reinterpret_cast<unsigned char*>(smem4), chunk);
  float* s_red = reinterpret_cast<float*>(
      reinterpret_cast<unsigned char*>(smem4) + Staging::bytes(chunk));

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
  const long long pix_idx = static_cast<long long>(t) * PIX + p;

  float go[C], gp[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    go[c] = g_out[pix_idx * C + c];
    gp[c] = STATS ? g_photo[pix_idx * C + c] : 0.0f;
  }
  float carry = trans_final[pix_idx] * g_trans[pix_idx];
  float carry2 = 0.0f;

  int group = 0;  // partial buffers used so far (alternate between the two)
  for (int j = nchunks - 1; j >= 0; --j) {
    const long long base = start + static_cast<long long>(j) * chunk;
    const int n = min(chunk, count - j * chunk);
    __syncthreads();  // the previous chunk's readers are done
    stage<C>(st, geo, feat, p_pad, base, n, tx0, ty0, alpha_min);
    __syncthreads();

    const long long row = (static_cast<long long>(t) * max_chunks + j) * PIX + p;
    float t_cur = j + 1 < nchunks ? tstarts[row + PIX] : trans_final[pix_idx];
    const int lat = latch[row];
    const int limit = lat < 0 ? n : lat;

    for (int k0 = (n - 1) / GROUP * GROUP; k0 >= 0; k0 -= GROUP, ++group) {
      float* red = s_red + (group & 1) * RED_FLOATS;
      unsigned bits = warp_slots(st.mask, k0, n, lane, warp);
      while (bits) {
        const int kk = 31 - __clz(bits);
        bits &= ~(1u << kk);
        const int k = k0 + kk;
        float v[NV];
#pragma unroll
        for (int i = 0; i < NV; ++i) v[i] = 0.0f;
        bool use = false;
        if (k < limit) {
          const float4 g0 = st.geo[2 * k];
          const float4 g1 = st.geo[2 * k + 1];
          const float a = g0.z, bq = g0.w, cc = g1.x, opa = g1.y;
          const float dx = g0.x - px;
          const float dy = g0.y - py;
          const float power = -0.5f * (a * dx * dx + cc * dy * dy) - bq * dx * dy;
          if (power <= 0.0f) {
            const float G = expf(power);
            const float alpha = fminf(ALPHA_MAX, opa * G);
            if (alpha >= alpha_min) {
              use = true;
              const float4 f0 = st.feat[2 * k];
              const float4 f1 = st.feat[2 * k + 1];
              const float f[8] = {f0.x, f0.y, f0.z, f0.w, f1.x, f1.y, f1.z, f1.w};
              const float one_minus = 1.0f - alpha;
              const float t_excl = t_cur / one_minus;
              const float w = alpha * t_excl;
              float fdotg = 0.0f, fdotg2 = 0.0f;
#pragma unroll
              for (int c = 0; c < C; ++c) {
                fdotg += go[c] * f[c];
                if (STATS) fdotg2 += gp[c] * f[c];
              }
              const float dalpha = t_excl * fdotg - carry / one_minus;
              const float dpower = opa * G * dalpha;
              v[0] = dpower * (-(a * dx + bq * dy));
              v[1] = dpower * (-(cc * dy + bq * dx));
              v[2] = dpower * (-0.5f * dx * dx);
              v[3] = dpower * (-dx * dy);
              v[4] = dpower * (-0.5f * dy * dy);
              v[5] = G * dalpha;
              carry += w * fdotg;
              if (STATS) {
                const float dpower2 = opa * G * (t_excl * fdotg2 - carry2 / one_minus);
                v[6] = dpower2 * (-(a * dx + bq * dy));
                v[7] = dpower2 * (-(cc * dy + bq * dx));
                carry2 += w * fdotg2;
              }
#pragma unroll
              for (int c = 0; c < C; ++c) v[8 + c] = go[c] * w;
              t_cur = t_excl;
            }
          }
        }
        const float s = __any_sync(FULL, use) ? warp_sum16(v, lane) : 0.0f;
        if (!(lane & 1)) red[(warp * NV + (lane >> 1)) * RED_STRIDE + kk] = s;
      }
      __syncthreads();  // this group's partials are parked

      // add the partials of the warps of each slot's mask, in warp order
      for (int idx = p; idx < NVAL * GROUP; idx += PIX) {
        const int i = idx / GROUP;
        const int kk = idx % GROUP;
        const int k = k0 + kk;
        if (k >= n) continue;
        const unsigned m = st.mask[k];
        float s = 0.0f;
#pragma unroll
        for (int w = 0; w < WARPS; ++w)
          if ((m >> w) & 1u) s += red[(w * NV + i) * RED_STRIDE + kk];
        if (i < 8)
          d_geo[i * p_pad + base + k] = s;
        else
          d_feat[(i - 8) * p_pad + base + k] = from_f32<TF>(s);
      }
    }
  }
}

template <int C, bool STATS, typename TF>
cudaError_t prepare(int chunk, size_t* smem) {
  *smem = smem_bytes(chunk);
  if (*smem > 48 * 1024)
    return cudaFuncSetAttribute(composite_bwd_kernel<C, STATS, TF>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(*smem));
  return cudaSuccess;
}

template <int C, bool STATS, typename TF>
cudaError_t launch(const float* geo, const TF* feat, const int* starts,
                   const int* counts, const float* tstarts, const short* latch,
                   const float* trans, const float* g_out, const float* g_photo,
                   const float* g_trans, float* d_geo, TF* d_feat, int num_tiles,
                   long long p_pad, int grid_w, int chunk, int max_chunks,
                   float alpha_min, cudaStream_t stream) {
  size_t smem;
  cudaError_t e = prepare<C, STATS, TF>(chunk, &smem);
  if (e != cudaSuccess) return e;
  composite_bwd_kernel<C, STATS, TF><<<num_tiles, PIX, smem, stream>>>(
      geo, feat, starts, counts, tstarts, latch, trans, g_out, g_photo, g_trans,
      d_geo, d_feat, p_pad, grid_w, chunk, max_chunks, alpha_min);
  return cudaGetLastError();
}

template <int C, bool STATS, typename TF>
cudaError_t occupancy(int chunk, int* blocks) {
  size_t smem;
  cudaError_t e = prepare<C, STATS, TF>(chunk, &smem);
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, composite_bwd_kernel<C, STATS, TF>, PIX, smem);
}

#define COMPOSITE_BWD_SWITCH(CALL)  \
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
             const int* counts, const float* tstarts, const short* latch,
             const float* trans, const float* g_out, const float* g_photo,
             const float* g_trans, float* d_geo, TF* d_feat, int num_tiles,
             int p_pad, int grid_w, int chunk, int max_chunks, int num_channels,
             int c_pad, int with_stats, float alpha_min, void* stream) {
  if (num_tiles == 0) return 0;
  if (num_channels > c_pad || chunk < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define LAUNCH(C)                                                               \
  static_cast<int>(                                                             \
      with_stats ? launch<C, true, TF>(geo, feat, starts, counts, tstarts,      \
                                       latch, trans, g_out, g_photo, g_trans,   \
                                       d_geo, d_feat, num_tiles, p_pad, grid_w, \
                                       chunk, max_chunks, alpha_min, s)         \
                 : launch<C, false, TF>(geo, feat, starts, counts, tstarts,     \
                                        latch, trans, g_out, g_photo, g_trans,  \
                                        d_geo, d_feat, num_tiles, p_pad,        \
                                        grid_w, chunk, max_chunks, alpha_min, s))
  COMPOSITE_BWD_SWITCH(LAUNCH)
#undef LAUNCH
}

}  // namespace

// Inputs as the forward's, plus its tstarts (num_tiles * max_chunks, 256)
// f32 and latch (same shape, int16), the final transmittance
// (num_tiles, 256), g_out (the total-loss cotangent) and g_photo (the
// photometric one), both (num_tiles, 256, num_channels), and g_trans
// (num_tiles, 256), all f32. counts must already be clamped to the chunks
// the forward ran. d_geo (8, p_pad) f32 and d_feat (c_pad, p_pad), in the
// feature dtype (f32 for composite_bwd, bf16 for composite_bwd_bf16), are
// zero-filled by the caller; each tile writes its own slots.
// Returns the launch's CUDA error.
extern "C" int composite_bwd(const float* geo, const float* feat,
                             const int* starts, const int* counts,
                             const float* tstarts, const short* latch,
                             const float* trans, const float* g_out,
                             const float* g_photo, const float* g_trans,
                             float* d_geo, float* d_feat, int num_tiles,
                             int p_pad, int grid_w, int chunk, int max_chunks,
                             int num_channels, int c_pad, int with_stats,
                             float alpha_min, void* stream) {
  return dispatch(geo, feat, starts, counts, tstarts, latch, trans, g_out, g_photo,
                  g_trans, d_geo, d_feat, num_tiles, p_pad, grid_w, chunk,
                  max_chunks, num_channels, c_pad, with_stats, alpha_min, stream);
}

extern "C" int composite_bwd_bf16(const float* geo, const __nv_bfloat16* feat,
                                  const int* starts, const int* counts,
                                  const float* tstarts, const short* latch,
                                  const float* trans, const float* g_out,
                                  const float* g_photo, const float* g_trans,
                                  float* d_geo, __nv_bfloat16* d_feat,
                                  int num_tiles, int p_pad, int grid_w,
                                  int chunk, int max_chunks, int num_channels,
                                  int c_pad, int with_stats, float alpha_min,
                                  void* stream) {
  return dispatch(geo, feat, starts, counts, tstarts, latch, trans, g_out, g_photo,
                  g_trans, d_geo, d_feat, num_tiles, p_pad, grid_w, chunk,
                  max_chunks, num_channels, c_pad, with_stats, alpha_min, stream);
}

// Resident blocks per SM of the kernel at this channel count, feature dtype
// (bf16 != 0), stats flag and chunk, from
// cudaOccupancyMaxActiveBlocksPerMultiprocessor.
extern "C" int composite_bwd_blocks_per_sm(int num_channels, int bf16, int with_stats,
                                           int chunk, int* blocks) {
#define OCC(C)                                                                  \
  static_cast<int>(                                                             \
      bf16 ? (with_stats ? occupancy<C, true, __nv_bfloat16>(chunk, blocks)     \
                         : occupancy<C, false, __nv_bfloat16>(chunk, blocks))   \
           : (with_stats ? occupancy<C, true, float>(chunk, blocks)             \
                         : occupancy<C, false, float>(chunk, blocks)))
  COMPOSITE_BWD_SWITCH(OCC)
#undef OCC
}
