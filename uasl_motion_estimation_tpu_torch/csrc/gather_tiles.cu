// Batched integer-anchored tile gather with edge-replicated reads.
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
// The op is pure data movement, bound by bytes: one 4-byte read and one
// 4-byte write per output element, no arithmetic to speak of. One block
// copies one tile; consecutive threads take consecutive columns of a tile
// row, so the reads of a row and the writes of the whole tile coalesce, and
// the anchor is read once per block. Tile rows of neighbouring features
// overlap in the image, so most reads hit L2.
//
// Built with nvcc for sm_90a into a shared library with a plain C interface
// and bound with ctypes (ops/kernels/gather.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void gather_tiles_kernel(const float* __restrict__ img,
                                    const int* __restrict__ anchors,
                                    float* __restrict__ out, int h, int w,
                                    int n, int tile_h, int tile_w) {
  const int64_t tile = (int64_t)blockIdx.y * n + blockIdx.x;
  // clamp the anchor first, as extract_tiles does: ay + i cannot overflow
  const int ax = min(max(anchors[2 * tile], -tile_w), w - 1);
  const int ay = min(max(anchors[2 * tile + 1], -tile_h), h - 1);
  const float* src = img + (int64_t)blockIdx.y * h * w;
  float* dst = out + tile * tile_h * tile_w;
  const int count = tile_h * tile_w;
  for (int e = threadIdx.x; e < count; e += blockDim.x) {
    const int i = e / tile_w;
    const int j = e - i * tile_w;
    const int y = min(max(ay + i, 0), h - 1);
    const int x = min(max(ax + j, 0), w - 1);
    dst[e] = __ldg(src + (int64_t)y * w + x);
  }
}

}  // namespace

// img (batch, h, w) f32, anchors (batch, n, 2) int32 [x, y],
// out (batch, n, tile_h, tile_w) f32; all contiguous on the current device.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int gather_tiles_f32(const float* img, const int* anchors,
                                float* out, int batch, int h, int w, int n,
                                int tile_h, int tile_w, cudaStream_t stream) {
  if (batch <= 0 || n <= 0) return 0;
  const int count = tile_h * tile_w;
  const int threads = count >= 256 ? 256 : ((count + 31) / 32) * 32;
  dim3 grid((unsigned)n, (unsigned)batch);
  gather_tiles_kernel<<<grid, threads, 0, stream>>>(img, anchors, out, h, w, n,
                                                    tile_h, tile_w);
  return (int)cudaGetLastError();
}
