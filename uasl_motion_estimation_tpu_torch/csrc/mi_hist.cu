// Batched joint-histogram mutual information of quantised patch pairs.
//
// Replaces the Pallas TPU kernel uasl_motion_estimation_tpu/ops/pallas/mi.py
// (_mi_kernel, launched by mi_quantized_pairs, wrapped by
// mutual_information_pallas), which is the TPU branch of
// ops/similarity.py::mutual_information_batched. It computes what that kernel
// computes, not its TPU layout: the 128-lane pixel padding, the 32-sublane
// histogram packing and the bf16 one-hot matmul exist only for Mosaic.
//
//   pair b scores qa[b / rep] against qb[b] (P ids each, int32):
//   c[i][j] = #{p : qa[p] == i, qb[p] == j, both ids in [0, bins)}
//   pj = c / n_valid, pa = rowsum(c) / n_valid, pb = colsum(c) / n_valid
//   out[b] = sum over pj > 0, pa pb > 0 of pj * log2(pj / (pa pb))   (bits)
//
// ``rep`` lets the MI stereo matcher score each left patch against its D
// disparity candidates without writing the left ids out D times.
//
// Design: one warp per pair. Each warp owns a bins x bins int32 histogram
// (<= 4 KB) and 2 x bins marginal counts in shared memory; lanes stride over
// the pixels and add to all three with shared-memory atomicAdd, so every
// count is an exact integer. With pj = c/n, pa = ca/n, pb = cb/n the sum
// over the cells with c > 0 is, exactly,
//
//   sum pj log2(pj / (pa pb)) = (sum c log2 c - sum ca log2 ca
//                                - sum cb log2 cb + (sum c) log2 n) / n
//
// (pj > 0 implies pa pb > 0, so both sides range over the same cells). The
// kernel sums the right-hand side: one log2 per cell and per marginal, no
// division in the loop. Each lane keeps a partial sum; warp shuffles reduce
// them. Only this final sum rounds (~1e-6 absolute at P = 121 against the
// left-hand formula of the plain version, whose terms round separately).
//
// What bounds it on an H100: bytes. At the matcher's shape (one 13-step
// chunk: 13 x 500 x 128 pairs of 121 px) it reads 403 MB of qb ids (qa is
// 128x smaller), >= 0.12 ms at 3.35 TB/s; it does ~1e8 shared atomics and
// <= 4e8 log2s, far below the card's rates. Storing the ids as uint8
// would cut the bytes 4x.
//
// Built with nvcc for sm_90a into a shared library with a plain C interface
// and bound with ctypes (ops/kernels/mi.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;  // warps (pairs) per block
constexpr int kMaxBins = 32;

__global__ void mi_hist_kernel(const int* __restrict__ qa,
                               const int* __restrict__ qb,
                               float* __restrict__ out, int64_t n_pairs,
                               int rep, int p, int bins, float n_valid) {
  __shared__ int hist_all[kWarps][kMaxBins * kMaxBins];
  __shared__ int marg_all[kWarps][2 * kMaxBins];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t b = (int64_t)blockIdx.x * kWarps + warp;
  if (b >= n_pairs) return;  // whole warps leave together
  int* hist = hist_all[warp];
  int* marg = marg_all[warp];
  const int nb2 = bins * bins;

  for (int e = lane; e < nb2; e += 32) hist[e] = 0;
  for (int e = lane; e < 2 * kMaxBins; e += 32) marg[e] = 0;
  __syncwarp();

  const int* ra = qa + (b / rep) * p;
  const int* rb = qb + b * p;
  for (int i = lane; i < p; i += 32) {
    const int a = __ldg(ra + i);
    const int c = __ldg(rb + i);
    // the sentinel contract: an id outside [0, bins) drops the pixel
    if ((unsigned)a < (unsigned)bins && (unsigned)c < (unsigned)bins) {
      atomicAdd(hist + a * bins + c, 1);
      atomicAdd(marg + a, 1);
      atomicAdd(marg + kMaxBins + c, 1);
    }
  }
  __syncwarp();

  float acc = 0.0f;  // this lane's part of sum c log2 c - marginal terms
  for (int e = lane; e < nb2; e += 32) {
    const int c = hist[e];
    if (c > 0) acc += (float)c * log2f((float)c);
  }
  int total = 0;  // sum c: the pixels that were counted
  if (lane < bins) {
    const int ca = marg[lane];
    const int cb = marg[kMaxBins + lane];
    total = ca;
    if (ca > 0) acc -= (float)ca * log2f((float)ca);
    if (cb > 0) acc -= (float)cb * log2f((float)cb);
  }
  for (int off = 16; off > 0; off >>= 1) {
    acc += __shfl_down_sync(0xffffffffu, acc, off);
    total += __shfl_down_sync(0xffffffffu, total, off);
  }
  if (lane == 0) out[b] = (acc + (float)total * log2f(n_valid)) / n_valid;
}

}  // namespace

// qa (n_pairs / rep, p) int32, qb (n_pairs, p) int32, out (n_pairs,) f32; all
// contiguous on the current device. 1 <= bins <= 32, n_valid > 0, rep >= 1.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int mi_hist_pairs(const int* qa, const int* qb, float* out,
                             int64_t n_pairs, int rep, int p, int bins,
                             int n_valid, cudaStream_t stream) {
  if (n_pairs <= 0) return 0;
  if (bins < 1 || bins > kMaxBins || rep < 1 || p < 1 || n_valid < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const int64_t blocks = (n_pairs + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  mi_hist_kernel<<<(unsigned)blocks, kWarps * 32, 0, stream>>>(
      qa, qb, out, n_pairs, rep, p, bins, (float)n_valid);
  return (int)cudaGetLastError();
}
