// Batched integer-anchored tile gather with edge-replicated reads (kernel K1).
//
// Replaces the Pallas TPU kernel uasl_motion_estimation_tpu/ops/pallas/gather.py
// (_gather_kernel, launched by _gather_aligned, wrapped by gather_rects), which
// is the TPU branch of ops/image.py::extract_tiles. It computes what that
// kernel computes, not its TPU layout: the (8, 128)-aligned DMA rectangles and
// the one-hot shift that undoes them exist only for Mosaic's tiling.
//
//   out[b, n, i, j] = img[b, clamp(ay + i, 0, H-1), clamp(ax + j, 0, W-1)]
//   with (ax, ay) = anchors[b, n] clamped to [-tile_w, W-1] x [-tile_h, H-1]
//
// Bound: bytes. It is a copy: the distinct image pixels that the tiles cover
// are read, the anchors are read, the tiles are written, and nothing is
// computed. At the main path's shapes (13 x 500 tiles, 3-40 MB written) one
// launch is worth a few to a few tens of microseconds of memory traffic, so
// the design keeps many loads in flight from the first cycle and spends few
// instructions on each output element:
// - Flat over the contiguous output (batch * n * tile_h * tile_w floats). Each
//   thread owns kV = 4 consecutive outputs, issues their four image loads
//   before it stores them as one 16-byte vector. A scalar head (up to the
//   first 16-byte boundary of the output) and tail (the last < 4 outputs)
//   take the rest. At 32 registers 2,048 threads are resident per SM, with
//   32 KB of loads in flight, against the ~18 KB per SM that hiding HBM's
//   latency takes.
// - The split of an output index into (tile, row, column) is made once per
//   thread and step; the next outputs step along the row, wrap into the next
//   row and, past the tile's last row, into the next tile, whose anchor is
//   read then. The main path's tile shapes are template arguments, so the
//   divisions by the tile's area and width are multiply-shifts; any other
//   shape runs the generic instantiation, which divides by multiply and shift
//   too (FastDiv). The batch index is tile / n, the same way.
// - The grid is sized to the card: as many 256-thread blocks as are resident
//   on all SMs at once (the occupancy API), or fewer when there is less work,
//   each walking the output with a grid-stride loop.
// - Timed on an H100 and not kept, since none was faster cold: 8 or 16
//   outputs per thread (fewer threads: slower), two to eight groups per
//   thread with all their loads issued before any store, and a warp-strided
//   layout whose every load instruction reads 32 consecutive outputs' pixels
//   (both no faster). Cold, the time is HBM traffic and a fixed few
//   microseconds of launch and two dependent misses (anchor, then pixel).
// - Not used: TMA and cp.async.bulk need a row pitch that is a multiple of 16
//   bytes (the path's widths 1241, 621 and 311 are not) and fill reads out of
//   bounds with zeros, not edge values; tensor cores have nothing to do in a
//   copy.
//
// Built with nvcc for sm_90a into a shared library with a plain C interface
// and bound with ctypes (ops/kernels/gather.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kV = 4;  // consecutive outputs per thread and step: one 16-byte store

// x / d for 0 <= x < 2^31 and 1 <= d < 2^31, by one multiply and a shift
// (Granlund and Montgomery, in the form of cutlass::FastDivmod).
struct FastDiv {
  unsigned d = 1, mul = 0, shr = 0;
  FastDiv() = default;
  explicit FastDiv(unsigned divisor) : d(divisor) {
    if (d > 1) {
      const unsigned log2_ceil = 32 - __builtin_clz(d - 1);
      mul = (unsigned)(((1ull << (31 + log2_ceil)) + d - 1) / d);
      shr = log2_ceil - 1;
    }
  }
  __device__ __forceinline__ int operator()(int x) const {
    return d == 1 ? x : (int)(__umulhi((unsigned)x, mul) >> shr);
  }
};

struct Args {
  const float* img;
  const int* anchors;  // (tiles, 2) [x, y]
  float* out;
  int h, w, tile_h, tile_w;
  FastDiv div_n, div_w, div_area;  // by n, tile_w and tile_h * tile_w
  int head;    // scalar outputs before the output's first 16-byte boundary
  int groups;  // runs of kV outputs from there on
  int total;   // outputs
};

// x / C when the divisor is a template argument, else by the FastDiv.
template <int C>
__device__ __forceinline__ int divide(int x, const FastDiv& f) {
  return C ? (int)((unsigned)x / (unsigned)C) : f(x);
}

// Where tile `tile` reads: its image and its clamped anchor. Clamping the
// anchor first, as extract_tiles does, keeps ay + i and ax + j from
// overflowing.
template <int TH, int TW>
__device__ __forceinline__ void locate(const Args& a, int tile, const float*& src,
                                       int& ax, int& ay) {
  const int th = TH ? TH : a.tile_h, tw = TW ? TW : a.tile_w;
  ax = min(max(__ldg(a.anchors + 2 * tile), -tw), a.w - 1);
  ay = min(max(__ldg(a.anchors + 2 * tile + 1), -th), a.h - 1);
  src = a.img + (int64_t)a.div_n(tile) * a.h * a.w;
}

__device__ __forceinline__ float pick(const Args& a, const float* src, int ax, int ay,
                                      int i, int j) {
  const int y = min(max(ay + i, 0), a.h - 1);
  const int x = min(max(ax + j, 0), a.w - 1);
  return __ldg(src + y * a.w + x);
}

template <int TH, int TW>
__device__ __forceinline__ float one_output(const Args& a, int e) {
  const int tw = TW ? TW : a.tile_w;
  const int tile = divide<TH * TW>(e, a.div_area);
  const int rem = e - tile * (TH ? TH : a.tile_h) * tw;
  const int i = divide<TW>(rem, a.div_w);
  const float* src;
  int ax, ay;
  locate<TH, TW>(a, tile, src, ax, ay);
  return pick(a, src, ax, ay, i, rem - i * tw);
}

template <int TH, int TW>
__global__ void __launch_bounds__(kThreads) gather_tiles_kernel(const Args a) {
  const int th = TH ? TH : a.tile_h, tw = TW ? TW : a.tile_w;
  for (int g = blockIdx.x * kThreads + threadIdx.x; g < a.groups;
       g += gridDim.x * kThreads) {
    const int e = a.head + g * kV;
    int tile = divide<TH * TW>(e, a.div_area);
    const int rem = e - tile * th * tw;
    int i = divide<TW>(rem, a.div_w);
    int j = rem - i * tw;
    const float* src;
    int ax, ay;
    locate<TH, TW>(a, tile, src, ax, ay);
    float v[kV];
#pragma unroll
    for (int k = 0; k < kV; ++k) {
      v[k] = pick(a, src, ax, ay, i, j);
      if (k + 1 < kV && ++j == tw) {  // never steps past the group's last output
        j = 0;
        if (++i == th) {
          i = 0;
          locate<TH, TW>(a, ++tile, src, ax, ay);
        }
      }
    }
    *reinterpret_cast<float4*>(a.out + e) = make_float4(v[0], v[1], v[2], v[3]);
  }
  // head and tail: fewer than 2 kV scalar outputs, by block 0
  const int tail = a.head + a.groups * kV;
  if (blockIdx.x == 0 && threadIdx.x < a.head + (a.total - tail)) {
    const int t = threadIdx.x;
    const int e = t < a.head ? t : tail + (t - a.head);
    a.out[e] = one_output<TH, TW>(a, e);
  }
}

template <int TH, int TW>
int launch(const Args& a, cudaStream_t stream) {
  static int resident = 0;  // blocks per SM, the same on every H100
  cudaError_t err;
  if (resident == 0) {
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, gather_tiles_kernel<TH, TW>,
                                                        kThreads, 0);
    if (err != cudaSuccess) return (int)err;
    resident = blocks > 0 ? blocks : 1;
  }
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  const long long want = ((long long)a.groups + kThreads - 1) / kThreads;
  const long long most = (long long)sms * resident;
  const int blocks = (int)(want < 1 ? 1 : (want < most ? want : most));
  gather_tiles_kernel<TH, TW><<<blocks, kThreads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// img (batch, h, w) f32, anchors (batch, n, 2) int32 [x, y],
// out (batch, n, tile_h, tile_w) f32; all contiguous on the current device.
// The output and each image must hold fewer than 2^31 elements.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int gather_tiles_f32(const float* img, const int* anchors,
                                float* out, int batch, int h, int w, int n,
                                int tile_h, int tile_w, cudaStream_t stream) {
  if (batch <= 0 || n <= 0) return 0;
  const long long total = (long long)batch * n * tile_h * tile_w;
  if (tile_h <= 0 || tile_w <= 0 || h <= 0 || w <= 0 || total >= (1LL << 31) ||
      (long long)h * w >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.img = img;
  a.anchors = anchors;
  a.out = out;
  a.h = h;
  a.w = w;
  a.tile_h = tile_h;
  a.tile_w = tile_w;
  a.div_n = FastDiv((unsigned)n);
  a.div_w = FastDiv((unsigned)tile_w);
  a.div_area = FastDiv((unsigned)(tile_h * tile_w));
  a.total = (int)total;
  const int to_boundary = (int)((16 - ((uintptr_t)out & 15)) & 15) / 4;
  a.head = to_boundary < a.total ? to_boundary : a.total;
  a.groups = (a.total - a.head) / kV;
#define GATHER_SHAPE(TH, TW) \
  if (tile_h == TH && tile_w == TW) return launch<TH, TW>(a, stream);
  // the main path's shapes: ZNCC strips, template, refine tile and template,
  // KLT template and tile
  GATHER_SHAPE(11, 138)
  GATHER_SHAPE(11, 34)
  GATHER_SHAPE(11, 11)
  GATHER_SHAPE(14, 18)
  GATHER_SHAPE(12, 12)
  GATHER_SHAPE(14, 14)
  GATHER_SHAPE(22, 22)
#undef GATHER_SHAPE
  return launch<0, 0>(a, stream);
}
