// Batched joint-histogram mutual information of quantised patches (kernel K2).
//
// Replaces the Pallas TPU kernel uasl_motion_estimation_tpu/ops/pallas/mi.py
// (_mi_kernel, launched by mi_quantized_pairs, wrapped by
// mutual_information_pallas), which is the TPU branch of
// ops/similarity.py::mutual_information_batched. It computes what that kernel
// computes, not its TPU layout: the 128-lane pixel padding, the 32-sublane
// histogram packing and the bf16 one-hot matmul exist only for Mosaic, which
// has no shared-memory atomics.
//
// For a pair of id patches (a, b) of P pixels:
//   c[i][j] = #{p : a[p] == i, b[p] == j, both ids in [0, bins)}
//   pj = c / n, pa = rowsum(c) / n, pb = colsum(c) / n      (n = n_valid)
//   MI = sum over pj > 0 of pj * log2(pj / (pa pb))         (bits)
//
// Two entry points share one counting scheme:
//
// * mi_hist_pairs: pair q scores qa[q / rep] against qb[q] (int32 ids; an id
//   outside [0, bins) drops its pixel). The scale LM calls it with rep 1.
// * mi_hist_strip: the MI matcher. Feature f has a left patch qa[f] (k x k
//   uint8 ids) and a right strip strip[f] (k x (D + k - 1) uint8 ids); its
//   candidate d in [0, D) is the strip window at columns [D-1-d, D-1-d+k),
//   so candidate d sits at x - d (the orientation of ops/stereo.py). out[f][d]
//   is the MI of the left patch and window d. Ids must lie in [0, bins): a
//   feature with any other id gets NaN scores.
//
// Sparse, exact counting. With pj = c/n, pa = ca/n, pb = cb/n,
//
//   n * MI = sum_cells c log2 c - sum_i ca log2 ca - sum_j cb log2 cb
//            + (sum c) log2 n
//          = sum over counted pixels p of log2(n c(p) / (ca(p) cb(p)))
//
// where c(p), ca(p), cb(p) are the counts of p's own cell and bins: a cell
// holding c pixels appears c times in the pixel sum. So a warp never clears
// or scans the bins x bins histogram. Its lanes add their pixels' cells with
// shared-memory atomics (exact integers), __syncwarp, read back the count of
// each of their own pixels' cells and sum the log2 terms, then zero exactly
// the cells they touched (a cell zeroed twice is harmless). The earlier
// design cleared and scanned all 400 cells per pair to count 121 pixels.
// The per-pixel log2 is the SFU's __log2f (<= 2 ulp); c log2 c of a marginal
// comes from a table filled in double. chip_smoke.py holds the result to
// the plain version within 1e-5, on the matcher's own ids among others.
//
// Strip mode, one block per feature: the block copies the feature's left ids
// (P bytes) and strip (k (D + k - 1) bytes) into shared memory once. The
// left marginal's part of the sum is the same for every candidate, so it is
// summed once. The right marginal needs no per-pixel count either: the
// block counts the ids of each strip column once, and each warp takes a
// contiguous range of candidates, so lane j < bins slides the count of id j
// from one window to the next (one column in, one out). Per candidate and
// pixel that leaves one strip read, one atomic, one read-back and one
// zeroing write in shared memory. At the matcher's shape (13 steps x 500
// features, D 128, k 11) device memory sees 0.79 MB of left ids, 9.87 MB of
// strip ids and 3.33 MB of scores, against the 403 MB of per-candidate
// int32 ids the pair mode would read.
//
// What bounds it on an H100. Bytes: 14 MB, ~4 us at 3.35 TB/s. Shared
// memory: 100.7 M pixel-candidates x 4 accesses = 12.6 M warp-wide accesses
// at one per SM per clock, ~0.05 ms at 132 SMs and 1.98 GHz before bank
// conflicts (the random cells of uniform ids cost ~3.5-way conflicts; a
// natural image's cells cluster and cost less). So it is bound by shared-
// memory operations, not bytes. Tensor cores do not pay here: a one-hot
// product per candidate spends 20 x 20 x 121 MACs on 121 counts and still
// needs a log2 per cell; the TPU kernel used one only because a TPU has no
// shared-memory atomics. Atomics that return the old count (so that a pixel's
// rank telescopes to c log2 c with no read-back) measured slower on the
// matcher's ids: returning same-address atomics serialise, and a natural
// image's pixels share cells.
//
// Pair mode: each warp loops over pairs (grid-stride), keeps its lanes'
// pixels' ids in registers, zeroes its histogram once at the start and then
// only the cells it touched.
//
// Built with nvcc for sm_90a into a shared library with a plain C interface
// and bound with ctypes (ops/kernels/mi.py).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;  // warps per block
constexpr int kThreads = kWarps * 32;
constexpr int kMaxBins = 32;
constexpr int kMaxBlocksPerSm = 2048 / kThreads;
constexpr size_t kMaxSmem = 227 * 1024;  // per block, H100

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// kPix: pixels per lane, P <= 32 * kPix; each lane keeps its pixels' ids.
template <int kPix>
__global__ void __launch_bounds__(kThreads)
mi_pairs_kernel(const int* __restrict__ qa, const int* __restrict__ qb,
                float* __restrict__ out, int64_t n_pairs, int rep, int p,
                int bins, float n_valid) {
  __shared__ int hist_all[kWarps][kMaxBins * kMaxBins];
  __shared__ int marg_all[kWarps][2 * kMaxBins];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  int* hist = hist_all[warp];
  int* marga = marg_all[warp];
  int* margb = marga + kMaxBins;
  for (int e = lane; e < bins * bins; e += 32) hist[e] = 0;
  for (int e = lane; e < 2 * kMaxBins; e += 32) marga[e] = 0;
  __syncwarp();
  const float log2n = log2f(n_valid);
  const int64_t stride = (int64_t)gridDim.x * kWarps;

  for (int64_t q = (int64_t)blockIdx.x * kWarps + warp; q < n_pairs; q += stride) {
    const int* ra = qa + (q / rep) * p;
    const int* rb = qb + q * p;
    int a[kPix], b[kPix];  // a = -1: no pixel, or one dropped
#pragma unroll
    for (int j = 0; j < kPix; ++j) {
      const int i = lane + 32 * j;
      a[j] = -1;
      b[j] = 0;
      if (i < p) {
        const int ai = __ldg(ra + i);
        const int bi = __ldg(rb + i);
        // the sentinel contract: an id outside [0, bins) drops the pixel
        if ((unsigned)ai < (unsigned)bins && (unsigned)bi < (unsigned)bins) {
          a[j] = ai;
          b[j] = bi;
          atomicAdd(hist + ai * bins + bi, 1);
          atomicAdd(marga + ai, 1);
          atomicAdd(margb + bi, 1);
        }
      }
    }
    __syncwarp();
    float acc = 0.0f;  // this lane's part of n * MI
#pragma unroll
    for (int j = 0; j < kPix; ++j) {
      if (a[j] >= 0) {
        acc += __log2f((float)hist[a[j] * bins + b[j]]) - __log2f((float)marga[a[j]])
               - __log2f((float)margb[b[j]]) + log2n;
      }
    }
    __syncwarp();
#pragma unroll
    for (int j = 0; j < kPix; ++j) {
      if (a[j] >= 0) {
        hist[a[j] * bins + b[j]] = 0;
        marga[a[j]] = 0;
        margb[b[j]] = 0;
      }
    }
    acc = warp_sum(acc);
    if (lane == 0) out[q] = acc / n_valid;
    __syncwarp();
  }
}

// Shared memory of one strip-mode block, in bytes.
size_t strip_smem_bytes(int k, int n_disp, int bins) {
  const int s = n_disp + k - 1;
  const size_t words = (size_t)kWarps * bins * bins + bins + (size_t)s * bins
                       + (size_t)k * k + 1 + n_disp;
  return 4 * words + (size_t)k * k + (size_t)k * s;
}

// kPix: pixels per lane, P <= 32 * kPix.
template <int kPix>
__global__ void __launch_bounds__(kThreads)
mi_strip_kernel(const uint8_t* __restrict__ qa, const uint8_t* __restrict__ strip,
                float* __restrict__ out, int k, int n_disp, int bins) {
  extern __shared__ int smem[];
  const int p = k * k;
  const int s = n_disp + k - 1;
  const int ks = k * s;
  const int nb2 = bins * bins;
  int* hist_all = smem;                      // kWarps x bins x bins
  int* marga = hist_all + kWarps * nb2;      // bins: the left marginal
  int* col = marga + bins;                   // s x bins: ids per strip column
  float* xlog = (float*)(col + s * bins);    // p + 1: c log2 c
  float* out_s = xlog + p + 1;               // n_disp
  uint8_t* qa_s = (uint8_t*)(out_s + n_disp);  // p
  uint8_t* strip_s = qa_s + p;               // k x s
  const int n_counts = kWarps * nb2 + bins + s * bins;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int64_t f = blockIdx.x;

  // the feature's ids into shared memory once; all counts to zero
  const uint8_t* ga = qa + f * p;
  const uint8_t* gs = strip + f * ks;
  int bad = 0;
#pragma unroll 4
  for (int i = tid; i < p; i += kThreads) {
    const uint8_t v = __ldg(ga + i);
    qa_s[i] = v;
    bad |= v >= bins;
  }
#pragma unroll 8
  for (int i = tid; i < ks; i += kThreads) {
    const uint8_t v = __ldg(gs + i);
    strip_s[i] = v;
    bad |= v >= bins;
  }
  for (int i = tid; i < n_counts; i += kThreads) smem[i] = 0;
  for (int c = tid; c <= p; c += kThreads) {  // in double: each entry rounds once
    xlog[c] = c > 1 ? (float)(c * log2((double)c)) : 0.0f;
  }
  if (__syncthreads_or(bad)) {
    for (int d = tid; d < n_disp; d += kThreads) out[f * n_disp + d] = __int_as_float(0x7fc00000);
    return;
  }
  for (int i = tid; i < p; i += kThreads) atomicAdd(marga + qa_s[i], 1);
  for (int i = tid; i < ks; i += kThreads) atomicAdd(col + (i % s) * bins + strip_s[i], 1);
  __syncthreads();

  // n * MI = sum_p log2 c(p) - sum_j cb log2 cb + const, where the left
  // marginal's part, const = n log2 n - sum_i ca log2 ca, is the same for
  // every candidate
  const float n = (float)p;
  float cterm = lane < bins ? -xlog[marga[lane]] : 0.0f;
  cterm = warp_sum(cterm) + xlog[p];

  // this lane's pixels: left id and offset in the strip
  int a_id[kPix], off[kPix];
#pragma unroll
  for (int j = 0; j < kPix; ++j) {
    const int px = lane + 32 * j;
    a_id[j] = -1;
    off[j] = 0;
    if (px < p) {
      a_id[j] = qa_s[px];
      off[j] = (px / k) * s + px % k;
    }
  }

  // This warp's candidates are one contiguous range, so lane j < bins keeps
  // the right marginal cb = (pixels of id j in the window) and slides it:
  // from d - 1 to d the window gains column c0 = D-1-d and loses c0 + k.
  int* hist = hist_all + warp * nb2;
  const int d_lo = warp * n_disp / kWarps;
  const int d_hi = (warp + 1) * n_disp / kWarps;
  int cb = 0;
  if (lane < bins && d_lo < d_hi) {
    for (int x = 0; x < k; ++x) cb += col[(n_disp - 1 - d_lo + x) * bins + lane];
  }
  for (int d = d_lo; d < d_hi; ++d) {
    const int c0 = n_disp - 1 - d;
    if (d > d_lo && lane < bins) cb += col[c0 * bins + lane] - col[(c0 + k) * bins + lane];
    int cell[kPix];
#pragma unroll
    for (int j = 0; j < kPix; ++j) {
      if (a_id[j] >= 0) {
        cell[j] = a_id[j] * bins + strip_s[off[j] + c0];
        atomicAdd(hist + cell[j], 1);
      }
    }
    __syncwarp();
    float acc = lane < bins ? -xlog[cb] : 0.0f;
#pragma unroll
    for (int j = 0; j < kPix; ++j) {
      if (a_id[j] >= 0) acc += __log2f((float)hist[cell[j]]);
    }
    __syncwarp();
#pragma unroll
    for (int j = 0; j < kPix; ++j) {
      if (a_id[j] >= 0) hist[cell[j]] = 0;
    }
    acc = warp_sum(acc);
    if (lane == 0) out_s[d] = (acc + cterm) / n;
    __syncwarp();
  }
  __syncthreads();
  for (int d = tid; d < n_disp; d += kThreads) out[f * n_disp + d] = out_s[d];
}

int device_sms() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return 0;
  return sms;
}

}  // namespace

// qa (n_pairs / rep, p) int32, qb (n_pairs, p) int32, out (n_pairs,) f32; all
// contiguous on the current device. 1 <= bins <= 32, 1 <= p <= 512,
// n_valid > 0, rep >= 1.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int mi_hist_pairs(const int* qa, const int* qb, float* out,
                             int64_t n_pairs, int rep, int p, int bins,
                             int n_valid, cudaStream_t stream) {
  if (n_pairs <= 0) return 0;
  if (bins < 1 || bins > kMaxBins || rep < 1 || p < 1 || p > 512 || n_valid < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const int sms = device_sms();
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  const int64_t needed = (n_pairs + kWarps - 1) / kWarps;
  const int64_t cap = (int64_t)sms * kMaxBlocksPerSm;
  const unsigned blocks = (unsigned)(needed < cap ? needed : cap);
  const float nv = (float)n_valid;
  if (p <= 128) {
    mi_pairs_kernel<4><<<blocks, kThreads, 0, stream>>>(qa, qb, out, n_pairs, rep, p, bins, nv);
  } else if (p <= 256) {
    mi_pairs_kernel<8><<<blocks, kThreads, 0, stream>>>(qa, qb, out, n_pairs, rep, p, bins, nv);
  } else {
    mi_pairs_kernel<16><<<blocks, kThreads, 0, stream>>>(qa, qb, out, n_pairs, rep, p, bins, nv);
  }
  return (int)cudaGetLastError();
}

// qa (n_feat, k * k) uint8, strip (n_feat, k, n_disp + k - 1) uint8, out
// (n_feat, n_disp) f32; all contiguous on the current device. 1 <= bins <= 32,
// k * k <= 256. Returns cudaGetLastError() after the launch (0 on success).
extern "C" int mi_hist_strip(const uint8_t* qa, const uint8_t* strip, float* out,
                             int64_t n_feat, int k, int n_disp, int bins,
                             cudaStream_t stream) {
  if (n_feat <= 0) return 0;
  if (bins < 1 || bins > kMaxBins || k < 1 || k * k > 256 || n_disp < 1 ||
      n_feat > 0x7fffffff) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = strip_smem_bytes(k, n_disp, bins);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)n_feat;
  if (k * k <= 128) {
    if (smem > 48 * 1024) {
      cudaFuncSetAttribute(mi_strip_kernel<4>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
    }
    mi_strip_kernel<4><<<blocks, kThreads, smem, stream>>>(qa, strip, out, k, n_disp, bins);
  } else {
    if (smem > 48 * 1024) {
      cudaFuncSetAttribute(mi_strip_kernel<8>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
    }
    mi_strip_kernel<8><<<blocks, kThreads, smem, stream>>>(qa, strip, out, k, n_disp, bins);
  }
  return (int)cudaGetLastError();
}
