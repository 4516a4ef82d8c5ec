// Precision probe of the card: A.B in full fp32 and on TF32 tensor cores,
// expf and log1pf, in one launch.
//
// Replaces the Pallas TPU kernel `main.<locals>.kernel`
// (scripts/mosaic_precision_probe.py:41-50, called at :56), which asked
// whether the TPU's kernel compiler honoured Precision.HIGHEST and how its
// exp / log1p rounded. Its Hopper counterpart asks the same of this card:
// does an fp32 product stay fp32, what does TF32 (the meaning of DEFAULT
// precision for an fp32 product here, and of allow_tf32=True) cost, and do
// the kernels' expf / log1pf round like torch.exp / torch.log1p, on which
// the compositor gates rest. Plain PyTorch version and entry point:
// hairgs_tpu_torch/probes/precision_probe.py.
//
// Design. One launch of blocks of 128 threads; each block takes one role by
// its index:
//   - fp32: one thread per output element, the K products summed in order
//     (the library is built with --fmad=false, so each product rounds);
//   - TF32: one warp per 16x8 output tile, `mma.sync.aligned.m16n8k8` with
//     tf32 operands from `cvt.rna.tf32.f32` (round to nearest, ties away
//     from zero, 10 mantissa bits) and an fp32 accumulator;
//   - elementwise: one thread per element, expf(x) and log1pf(-al).
// Operands are read straight from device memory: at the probe's sizes
// (0.48 MB in and out) the launch itself is the cost, so the kernel is
// launch-bound and nothing is staged.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__global__ void __launch_bounds__(THREADS)
probe_kernel(const float* __restrict__ A, const float* __restrict__ B,
             const float* __restrict__ x, const float* __restrict__ al,
             float* __restrict__ out_fp32, float* __restrict__ out_tf32,
             float* __restrict__ out_exp, float* __restrict__ out_log1p, int M,
             int N, int K, int n_elem, int fp32_blocks, int tf32_blocks) {
  const int tid = threadIdx.x;
  int blk = blockIdx.x;
  if (blk < fp32_blocks) {
    const int idx = blk * THREADS + tid;
    if (idx >= M * N) return;
    const int i = idx / N;
    const int j = idx % N;
    float acc = 0.0f;
    for (int k = 0; k < K; ++k) acc = acc + A[i * K + k] * B[k * N + j];
    out_fp32[idx] = acc;
    return;
  }
  blk -= fp32_blocks;
  if (blk < tf32_blocks) {
    // warp-uniform role: every lane of a warp takes the same tile
    const int tile = blk * WARPS + tid / 32;
    const int tiles_n = N / 8;
    if (tile >= (M / 16) * tiles_n) return;
    const int lane = tid & 31;
    const int g = lane >> 2;  // groupID
    const int q = lane & 3;   // threadID_in_group
    const int r0 = (tile / tiles_n) * 16 + g;
    const int r1 = r0 + 8;
    const int n0 = (tile % tiles_n) * 8;
    float c0 = 0.0f, c1 = 0.0f, c2 = 0.0f, c3 = 0.0f;
    for (int k0 = 0; k0 < K; k0 += 8) {
      // A (row-major 16x8): a0 (g, q), a1 (g+8, q), a2 (g, q+4), a3 (g+8, q+4)
      const uint32_t a0 = to_tf32(A[r0 * K + k0 + q]);
      const uint32_t a1 = to_tf32(A[r1 * K + k0 + q]);
      const uint32_t a2 = to_tf32(A[r0 * K + k0 + q + 4]);
      const uint32_t a3 = to_tf32(A[r1 * K + k0 + q + 4]);
      // B (col-major 8x8): b0 (k = q, n = g), b1 (k = q+4, n = g)
      const uint32_t b0 = to_tf32(B[(k0 + q) * N + n0 + g]);
      const uint32_t b1 = to_tf32(B[(k0 + q + 4) * N + n0 + g]);
      asm volatile(
          "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
          : "+f"(c0), "+f"(c1), "+f"(c2), "+f"(c3)
          : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
    }
    // C (16x8): c0, c1 at (g, 2q), (g, 2q+1); c2, c3 at (g+8, 2q), (g+8, 2q+1)
    const int col = n0 + 2 * q;
    out_tf32[r0 * N + col] = c0;
    out_tf32[r0 * N + col + 1] = c1;
    out_tf32[r1 * N + col] = c2;
    out_tf32[r1 * N + col + 1] = c3;
    return;
  }
  blk -= tf32_blocks;
  const int idx = blk * THREADS + tid;
  if (idx >= n_elem) return;
  out_exp[idx] = expf(x[idx]);
  out_log1p[idx] = log1pf(-al[idx]);
}

}  // namespace

// A (M, K) and B (K, N) row-major f32, M % 16 == 0, N % 8 == 0, K % 8 == 0;
// x and al (n_elem,) f32. Writes out_fp32 and out_tf32 (M, N) = A.B in fp32
// and on TF32 tensor cores, out_exp = expf(x), out_log1p = log1pf(-al).
// Returns the CUDA error of the launch (0 = ok).
extern "C" int precision_probe(const float* A, const float* B, const float* x,
                               const float* al, float* out_fp32,
                               float* out_tf32, float* out_exp,
                               float* out_log1p, int M, int N, int K,
                               int n_elem, void* stream) {
  if (M % 16 || N % 8 || K % 8 || M <= 0 || N <= 0 || K <= 0 || n_elem < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int fp32_blocks = (M * N + THREADS - 1) / THREADS;
  const int tf32_blocks = ((M / 16) * (N / 8) + WARPS - 1) / WARPS;
  const int elem_blocks = (n_elem + THREADS - 1) / THREADS;
  probe_kernel<<<fp32_blocks + tf32_blocks + elem_blocks, THREADS, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      A, B, x, al, out_fp32, out_tf32, out_exp, out_log1p, M, N, K, n_elem,
      fp32_blocks, tf32_blocks);
  return static_cast<int>(cudaGetLastError());
}
