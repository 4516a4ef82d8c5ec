// Shared by composite_fwd.cu and composite_bwd.cu: the chunk staging, the
// per-warp cull predicate and the small device helpers of both passes.
//
// Staging. Each thread copies one slot of a chunk from the SoA planes
// (geometry rows 0-5, C feature rows; neighbouring threads on neighbouring
// slots) into shared memory as an array of structures, geometry
// {x, y, a, b} {c, opacity, 0, 0} and features {f0..f3} {f4..f7} (widened
// to fp32), so a warp reads one pair with four 16-byte broadcast loads, and
// computes the pair's warp mask. (Copying the next chunk while the block
// computes the current one, double-buffered, did not pay at bench width:
// the other resident blocks already hide the copy.)
//
// Warp mask. A warp covers a 16x2 strip of its tile (pixels 32w..32w+31,
// rows 2w and 2w+1). Bit w of a pair's mask is set when the alpha >=
// alpha_min ellipse of the pair can reach that strip; a warp then walks
// only the slots whose bit it holds, in slot order. The test is
// conservative and exact: a cleared bit means every pixel of the strip
// fails the kernels' fp32 gate (power <= 0, min(0.99, opacity * expf(power))
// >= alpha_min), so skipping the pair changes no sum. It is computed in
// double:
//   alpha >= alpha_min needs opacity * exp(power) >= alpha_min, i.e.
//   Q = a dx^2 + 2 b dx dy + c dy^2 <= 2 ln(opacity / alpha_min);
// the bound is widened for the fp32 evaluation of the kernels (each term of
// the quadratic form rounds: an error of at most 8 * 2^-24 of
// S = a dx^2 + c dy^2 + 2 |b dx dy| over the tile) and for expf (2 ulp)
// and the opacity product, and the ellipse's extents are
// |dy| <= sqrt(R a / det), |dx| <= sqrt(R c / det). A pair with opacity
// below alpha_min (or NaN) reaches no warp; a pair whose position or conic
// is not finite, or whose conic is not positive definite to 1e-12 of a c,
// reaches every warp. hairgs_tpu_torch/render/composite_pairs.py::
// warp_reach_plain is the same predicate in PyTorch.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace composite {

constexpr int TILE = 16;
constexpr int PIX = TILE * TILE;
constexpr int WARPS = PIX / 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr float T_EPS = 1e-4f;
constexpr float ALPHA_MAX = 0.99f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__host__ __device__ constexpr size_t align16(size_t b) { return (b + 15) / 16 * 16; }

// Shared memory of a staged chunk: AoS geometry and features (32 B each per
// slot) and the warp masks.
struct Staging {
  __host__ __device__ static size_t bytes(int chunk) {
    return static_cast<size_t>(chunk) * 64 + align16(chunk);
  }
  float4* geo;          // 2 per slot
  float4* feat;         // 2 per slot
  unsigned char* mask;  // 1 per slot

  __device__ Staging(unsigned char* smem, int chunk) {
    geo = reinterpret_cast<float4*>(smem);
    feat = geo + 2 * chunk;
    mask = reinterpret_cast<unsigned char*>(feat + 2 * chunk);
  }
};

// Bit w set: the pair's alpha >= alpha_min ellipse may reach pixel rows 2w
// and 2w+1 of the tile whose first pixel is (tx0, ty0). See the note above.
__device__ __forceinline__ unsigned char warp_reach(float x, float y, float a, float b,
                                                    float c, float opa, float tx0,
                                                    float ty0, float alpha_min) {
  if (!(opa >= alpha_min) || !(alpha_min <= ALPHA_MAX)) return 0;
  if (!(isfinite(x) && isfinite(y) && isfinite(a) && isfinite(b) && isfinite(c)))
    return 0xff;
  const double A = a, B = b, Cq = c;
  const double det = A * Cq - B * B;
  if (!(A > 0.0 && Cq > 0.0 && det > 1e-12 * A * Cq)) return 0xff;
  const double q = log(static_cast<double>(opa) / static_cast<double>(alpha_min));
  const double dx0 = static_cast<double>(x) - tx0;
  const double dy0 = static_cast<double>(y) - ty0;
  const double Dx = fmax(fabs(dx0), fabs(dx0 - (TILE - 1)));
  const double Dy = fmax(fabs(dy0), fabs(dy0 - (TILE - 1)));
  const double S = A * Dx * Dx + Cq * Dy * Dy + 2.0 * fabs(B) * Dx * Dy;
  const double R = (2.0 * q + 1e-5) * (1.0 + 1e-6) + 0x1p-17 * S;
  const double ex = sqrt(R * Cq / det) * (1.0 + 1e-3) + 1e-3;
  const double ey = sqrt(R * A / det) * (1.0 + 1e-3) + 1e-3;
  if (ceil(fmax(dx0 - ex, 0.0)) > floor(fmin(dx0 + ex, TILE - 1.0))) return 0;
  const double lo = ceil(fmax(dy0 - ey, 0.0));
  const double hi = floor(fmin(dy0 + ey, TILE - 1.0));
  if (lo > hi) return 0;
  const int w_lo = static_cast<int>(lo) >> 1;
  const int w_hi = static_cast<int>(hi) >> 1;
  return static_cast<unsigned char>(((1u << (w_hi + 1)) - 1u) & ~((1u << w_lo) - 1u));
}

// slots [base, base + n) of the planes -> AoS geometry and features, and
// every slot's warp mask (every thread of the block takes part)
template <int C, typename TF>
__device__ void stage(const Staging& st, const float* __restrict__ geo_g,
                      const TF* __restrict__ feat_g, long long p_pad, long long base,
                      int n, float tx0, float ty0, float alpha_min) {
  for (int i = threadIdx.x; i < n; i += PIX) {
    const float* g = geo_g + base + i;
    const float x = g[0], y = g[p_pad], a = g[2 * p_pad];
    const float b = g[3 * p_pad], c = g[4 * p_pad], o = g[5 * p_pad];
    st.geo[2 * i] = make_float4(x, y, a, b);
    st.geo[2 * i + 1] = make_float4(c, o, 0.0f, 0.0f);
    float f[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) f[k] = k < C ? to_f32(feat_g[k * p_pad + base + i]) : 0.0f;
    st.feat[2 * i] = make_float4(f[0], f[1], f[2], f[3]);
    st.feat[2 * i + 1] = make_float4(f[4], f[5], f[6], f[7]);
    st.mask[i] = warp_reach(x, y, a, b, c, o, tx0, ty0, alpha_min);
  }
}

// the bits of this warp among the 32 slots [k0, k0 + 32) of a chunk of n
__device__ __forceinline__ unsigned warp_slots(const unsigned char* mask, int k0, int n,
                                               int lane, int warp) {
  const unsigned m = k0 + lane < n ? mask[k0 + lane] : 0u;
  return __ballot_sync(FULL, (m >> warp) & 1u);
}

}  // namespace composite
