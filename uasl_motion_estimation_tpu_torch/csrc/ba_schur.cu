// Windowed bundle adjustment's per-iteration algebra in two kernels (K3):
// kernel A builds each window's gauged, damped reduced camera system, its
// right-hand side and the robust cost; kernel B back-substitutes the points,
// clamps their depths and prices the new state.
//
// Replaces no TPU kernel: the JAX package's solvers/ba.py is plain jnp, and
// so is the port's plain chain (solvers/ba.py _normal_blocks -> _reduce_plain
// -> _step_plain), which writes every observation's Jacobians, weights, Wc
// and Wc V^-1 to device memory: ~0.9 GB an LM iteration at 907 windows of 10
// frames x 256 points, in ~530 launches.
//
// Bound, per LM iteration, for B windows of W frames, M points and R
// residuals (cell kitti-ba-windows: 907 x 10 x 256 x 4):
// - bytes: the observations, mask, points and cameras in (~45 MB), S
//   (B (6W)^2 floats, 13 MB) and its right-hand side out: ~60 MB, ~18 us at
//   3.35 TB/s;
// - FP32 FMAs: the Jacobians, and per point Wc V^-1 Wc^T summed into a
//   6W x 6W block: ~2.5 G FMAs, ~0.08 ms at the H100's ~33 T FP32 FMA/s.
// The arithmetic bounds it, at ~0.1 ms an iteration.
//
// Design:
// - One 256-thread block per window; nothing indexed by observation leaves
//   the block. Kernel A walks the window's points in tiles of P = 256 / W.
//   One thread per (frame, point) pair computes the residual, the analytic
//   Jacobians (so3_exp's derivative in the branch it takes) and the Huber
//   weight, keeps its share of U and bc in registers across the tiles, and
//   writes the pair's 6x3 Wc block and its V and bp terms to shared memory.
//   One thread per point sums V and bp over the frames, damps V and inverts
//   it (the identity for a point seen fewer than twice). The pair threads
//   then form Wc V^-1 and their share of Wc V^-1 bp, and the block adds the
//   tile's Wc V^-1 Wc^T into S, held whole in shared memory ((6W)^2 floats),
//   as a GEMM of depth 3P in which each thread owns fixed 3x3 tiles of S's
//   upper triangle (S is symmetric). There are no atomics.
// - Every sum runs in an order that W and M alone fix, so a window's outputs
//   do not depend on the batch around it, and repeated runs agree bit for
//   bit.
// - Stereo's fourth residual row (v of the right image) equals the second,
//   so it is one Jacobian row counted twice.
// - Kernel B: one thread per point recomputes the point's Jacobians (cheaper
//   than storing them), back-substitutes with the V^-1 and bp that A stored
//   per point, clamps the depth in the first camera and prices the new
//   state. A and B price a state with one function, in one order, so a step
//   that changes nothing costs exactly what it did before.
// - A window already done writes the identity system (A) or its state
//   unchanged (B) and returns: the LM's done latch discards it.
// - The shared memory of A is (W * 19 + (6W)^2 + 36 W P + 9 W P + 12 P + 256)
//   floats: 62 KB at W = 10, 197 KB at W = 32, the most this file takes
//   (kMaxFrames). The port's callers run W = 3 to 10.
//
// Built with nvcc for sm_90a into a shared library with a plain C interface
// and bound with ctypes (ops/kernels/ba_schur.py).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxFrames = 32;
constexpr int kCamRec = 19;  // cam (6), R (9, row-major), so3 coefficients A, B, dA, dB
constexpr int kPart = 33;    // a pair thread's sums: U (21, upper triangle), bc (6), Wc V^-1 bp (6)
constexpr int kMaxDevices = 64;

struct Window {
  const float* cam;      // (batch, W, 6) [angle-axis, translation], world -> camera
  const float* pts;      // (batch, M, 3)
  const float* obs;      // (batch, W, M, R)
  const uint8_t* mask;   // (batch, W, M)
  const uint8_t* done;   // (batch) or null: none done
  const uint8_t* valid;  // (batch, M): seen at least twice
  int W, M;
  float fu, fv, cu, cv, baseline, delta;
};

struct ReduceArgs {
  Window q;
  const float* lam;  // (batch)
  float* S;          // (batch, 6W, 6W)
  float* rhs;        // (batch, 6W)
  float* cost;       // (batch)
  float* aux;        // (batch, M, 12): V^-1 (9), bp (3); or null
  int n_fixed;
  float v_eps;
};

struct StepArgs {
  Window q;
  const float* dcam;  // (batch, W, 6)
  const float* aux;   // (batch, M, 12), as kernel A wrote it
  float* cam_new;     // (batch, W, 6)
  float* pts_new;     // (batch, M, 3)
  float* cost;        // (batch)
  uint8_t* finite;    // (batch)
  int clamp;
  float zmin, zmax;
};

// so3_exp (ops/lie.py) of the camera's rotation vector and the coefficients
// of its derivative (solvers/ba.py _drot_point), in the branch they take.
__device__ void camera_record(const float* cam6, float* rec) {
  const float vx = cam6[0], vy = cam6[1], vz = cam6[2];
  const float theta2 = vx * vx + vy * vy + vz * vz;
  const bool small = theta2 < 1e-8f;
  const float t = sqrtf(small ? 1.f : theta2);
  const float s = sinf(t), c = cosf(t);
  const float A = small ? 1.f - theta2 / 6.f : s / t;
  const float B = small ? 0.5f - theta2 / 24.f : (1.f - c) / (t * t);
  const float K[9] = {0.f, -vz, vy, vz, 0.f, -vx, -vy, vx, 0.f};
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float kk = K[3 * i] * K[j] + K[3 * i + 1] * K[3 + j] + K[3 * i + 2] * K[6 + j];
      rec[6 + 3 * i + j] = ((i == j) ? 1.f : 0.f) + A * K[3 * i + j] + B * kk;
    }
#pragma unroll
  for (int i = 0; i < 6; ++i) rec[i] = cam6[i];
  rec[15] = A;
  rec[16] = B;
  rec[17] = small ? -1.f / 6.f : (t * c - s) / (2.f * (t * t * t));
  rec[18] = small ? -1.f / 24.f : (t * s - 2.f * (1.f - c)) / (2.f * (t * t * t * t));
}

__device__ __forceinline__ void camera_point(const float* rec, float px, float py, float pz,
                                             float& x, float& y, float& z) {
  const float* R = rec + 6;
  x = R[0] * px + R[1] * py + R[2] * pz + rec[3];
  y = R[3] * px + R[4] * py + R[5] * pz + rec[4];
  z = R[6] * px + R[7] * py + R[8] * pz + rec[5];
}

__device__ __forceinline__ float clamp_z(float z) { return fabsf(z) < 1e-9f ? 1e-9f : z; }

// obs - prediction: [ul, v, ur, v] (stereo, R = 4) or [u, v] (mono), with z
// already clamped away from 0 (solvers/ba.py _predict).
template <int R>
__device__ __forceinline__ void residuals(const Window& q, float x, float y, float z,
                                          const float* o, float* r) {
  const float v = q.fv * y / z + q.cv;
  r[0] = o[0] - (q.fu * x / z + q.cu);
  r[1] = o[1] - v;
  if constexpr (R == 4) {
    r[2] = o[2] - (q.fu * (x - q.baseline) / z + q.cu);
    r[3] = o[3] - v;
  }
}

template <int R>
__device__ __forceinline__ float squared_norm(const float* r) {
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < R; ++k) s += r[k] * r[k];
  return s;
}

// Huber's rho of a residual's squared norm (solvers/ba.py _robust_cost).
__device__ __forceinline__ float huber_rho(float sq, float delta) {
  const float nrm = sqrtf(sq + 1e-12f);
  return nrm <= delta ? sq : 2.f * delta * nrm - delta * delta;
}

// The robust cost of one point over the window's frames, in frame order;
// adds the point's observations to count.
template <int R>
__device__ float point_cost(const Window& q, const float* cams, int b, int m, float px, float py,
                            float pz, float& count) {
  float c = 0.f;
  for (int w = 0; w < q.W; ++w) {
    float x, y, z;
    camera_point(cams + w * kCamRec, px, py, pz, x, y, z);
    const size_t o = ((size_t)b * q.W + w) * q.M + m;
    float r[R];
    residuals<R>(q, x, y, clamp_z(z), q.obs + o * R, r);
    const float mk = q.mask[o] ? 1.f : 0.f;
    c += huber_rho(squared_norm<R>(r), q.delta) * mk;
    count += mk;
  }
  return c;
}

// Sum over the block in a fixed tree order; every thread gets the total.
__device__ float block_sum(float v, float* red) {
  red[threadIdx.x] = v;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) red[threadIdx.x] += red[threadIdx.x + s];
    __syncthreads();
  }
  const float total = red[0];
  __syncthreads();
  return total;
}

// One observation's residual, its distinct Jacobian rows of the prediction
// with respect to the camera (rotation, translation) and to the point, the
// residual summed over the rows that share a Jacobian row, and its Huber
// IRLS weight times the mask (solvers/ba.py _residuals_jacobians and
// _huber_weights). Stereo has 3 distinct rows, the second counted twice.
template <int R>
struct Obs {
  static constexpr int K = R == 4 ? 3 : 2;
  float jc[K][6], jp[K][3], rs[K];
  float wt;
  __device__ static float mult(int k) { return (R == 4 && k == 1) ? 2.f : 1.f; }
};

template <int R>
__device__ __forceinline__ void observe(const Window& q, const float* rec, float px, float py,
                                        float pz, const float* o, bool seen, Obs<R>& J) {
  float x, y, zr;
  camera_point(rec, px, py, pz, x, y, zr);
  const bool clamped = fabsf(zr) < 1e-9f;
  const float z = clamped ? 1e-9f : zr;
  const float dz = clamped ? 0.f : 1.f;
  float r[R];
  residuals<R>(q, x, y, z, o, r);
  const float nrm = sqrtf(squared_norm<R>(r) + 1e-12f);
  J.wt = (nrm <= q.delta ? 1.f : q.delta / nrm) * (seen ? 1.f : 0.f);
  J.rs[0] = r[0];
  if constexpr (R == 4) {
    J.rs[1] = r[1] + r[3];
    J.rs[2] = r[2];
  } else {
    J.rs[1] = r[1];
  }

  // d prediction / d camera point, row by row: [a 0 c0], [0 e c1], [a 0 c2]
  const float a = q.fu / z, e = q.fv / z, zz = z * z;
  float c[3];
  c[0] = -q.fu * x / zz * dz;
  c[1] = -q.fv * y / zz * dz;
  c[2] = -q.fu * (x - q.baseline) / zz * dz;

  // D = d(so3_exp(v) p)/dv (solvers/ba.py _drot_point)
  const float vx = rec[0], vy = rec[1], vz = rec[2];
  const float A = rec[15], B = rec[16], dA2 = 2.f * rec[17], dB2 = 2.f * rec[18];
  const float kp[3] = {vy * pz - vz * py, vz * px - vx * pz, vx * py - vy * px};
  const float kkp[3] = {vy * kp[2] - vz * kp[1], vz * kp[0] - vx * kp[2], vx * kp[1] - vy * kp[0]};
  const float vp = vx * px + vy * py + vz * pz;
  const float v[3] = {vx, vy, vz}, p[3] = {px, py, pz};
  const float sk[9] = {0.f, -pz, py, pz, 0.f, -px, -py, px, 0.f};
  float D[9];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      D[3 * i + j] = dA2 * kp[i] * v[j] - A * sk[3 * i + j] + dB2 * kkp[i] * v[j]
                     + B * (((i == j) ? vp : 0.f) + v[i] * p[j] - 2.f * p[i] * v[j]);

  const float* Rm = rec + 6;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    J.jc[0][j] = a * D[j] + c[0] * D[6 + j];
    J.jc[1][j] = e * D[3 + j] + c[1] * D[6 + j];
    J.jp[0][j] = a * Rm[j] + c[0] * Rm[6 + j];
    J.jp[1][j] = e * Rm[3 + j] + c[1] * Rm[6 + j];
    if constexpr (R == 4) {
      J.jc[2][j] = a * D[j] + c[2] * D[6 + j];
      J.jp[2][j] = a * Rm[j] + c[2] * Rm[6 + j];
    }
  }
  J.jc[0][3] = a;   J.jc[0][4] = 0.f; J.jc[0][5] = c[0];
  J.jc[1][3] = 0.f; J.jc[1][4] = e;   J.jc[1][5] = c[1];
  if constexpr (R == 4) {
    J.jc[2][3] = a; J.jc[2][4] = 0.f; J.jc[2][5] = c[2];
  }
}

// Index of (i, j) in a symmetric n x n matrix's upper triangle, row-major.
__device__ __forceinline__ int upper(int i, int j, int n) {
  if (i > j) {
    const int s = i;
    i = j;
    j = s;
  }
  return i * n - i * (i - 1) / 2 + (j - i);
}

// The k-th 3x3 tile (I, J), I <= J, of an n x n grid of tiles, row-major.
__device__ void upper_tile(int k, int n, int& I, int& J) {
  const float b = 2.f * n + 1.f;
  int i = (int)((b - sqrtf(fmaxf(b * b - 8.f * k, 0.f))) * 0.5f);
  i = i < 0 ? 0 : (i > n - 1 ? n - 1 : i);
  while (i > 0 && upper(i, i, n) > k) --i;
  while (i + 1 < n && upper(i + 1, i + 1, n) <= k) ++i;
  I = i;
  J = i + (k - upper(i, i, n));
}

size_t reduce_floats(int W) {
  const size_t n = 6 * (size_t)W, P = kThreads / W;
  return W * (size_t)kCamRec + n * n + 6 * P * n + 9 * (size_t)W * P + 12 * P + kThreads;
}

template <int R>
__global__ void __launch_bounds__(kThreads) ba_reduce_kernel(ReduceArgs a) {
  extern __shared__ float sm[];
  const Window& q = a.q;
  const int b = blockIdx.x, t = threadIdx.x, W = q.W, M = q.M, n = 6 * W;
  const int P = kThreads / W, depth = 3 * P;
  float* cams = sm;              // W x kCamRec
  float* S = cams + W * kCamRec;  // n x n, the upper 3x3 tiles of sum Wc V^-1 Wc^T
  float* wc = S + n * n;          // depth x n: the tile's Wc, row 3 ml + k, column 6 w + i
  float* wv = wc + depth * n;     // depth x n: the tile's Wc V^-1
  float* vpart = wv + depth * n;  // W P x 9: each pair's V (upper triangle) and bp
  float* vi = vpart + 9 * W * P;  // P x 12: each point's V^-1 and bp
  float* red = vi + 12 * P;       // kThreads
  float* Sout = a.S + (size_t)b * n * n;

  if (q.done && q.done[b]) {
    for (int i = t; i < n * n; i += kThreads) Sout[i] = (i / n == i % n) ? 1.f : 0.f;
    for (int i = t; i < n; i += kThreads) a.rhs[(size_t)b * n + i] = 0.f;
    if (t == 0) a.cost[b] = 0.f;
    return;
  }
  for (int w = t; w < W; w += kThreads)
    camera_record(q.cam + ((size_t)b * W + w) * 6, cams + w * kCamRec);
  for (int i = t; i < n * n; i += kThreads) S[i] = 0.f;
  __syncthreads();

  // the cost at this state, by kernel B's function in kernel B's order
  float count = 0.f, cost = 0.f;
  for (int m = t; m < M; m += kThreads) {
    const float* p = q.pts + ((size_t)b * M + m) * 3;
    cost += point_cost<R>(q, cams, b, m, p[0], p[1], p[2], count);
  }
  cost = block_sum(cost, red);
  count = block_sum(count, red);

  const bool pair = t < W * P;
  const int w = pair ? t / P : 0, ml = t - w * P;
  const float* rec = cams + w * kCamRec;
  const float lam = a.lam[b];
  float U[21], bc[6], wvbp[6];
#pragma unroll
  for (int i = 0; i < 21; ++i) U[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 6; ++i) bc[i] = wvbp[i] = 0.f;
  const int n3 = 2 * W, tiles3 = n3 * (n3 + 1) / 2;

  for (int m0 = 0; m0 < M; m0 += P) {
    // 1. each pair: its Jacobians; U and bc in registers; Wc, V and bp out
    float wcr[18], vb[9];
#pragma unroll
    for (int i = 0; i < 18; ++i) wcr[i] = 0.f;
#pragma unroll
    for (int i = 0; i < 9; ++i) vb[i] = 0.f;
    const int m = m0 + ml;
    if (pair && m < M) {
      const float* p = q.pts + ((size_t)b * M + m) * 3;
      const size_t o = ((size_t)b * W + w) * M + m;
      Obs<R> J;
      observe<R>(q, rec, p[0], p[1], p[2], q.obs + o * R, q.mask[o] != 0, J);
#pragma unroll
      for (int k = 0; k < Obs<R>::K; ++k) {
        const float wk = J.wt * Obs<R>::mult(k), wr = J.wt * J.rs[k];
        float ac[6], ap[3];
#pragma unroll
        for (int i = 0; i < 6; ++i) ac[i] = wk * J.jc[k][i];
#pragma unroll
        for (int i = 0; i < 3; ++i) ap[i] = wk * J.jp[k][i];
#pragma unroll
        for (int i = 0; i < 6; ++i) {
#pragma unroll
          for (int j = i; j < 6; ++j) U[upper(i, j, 6)] += ac[i] * J.jc[k][j];
#pragma unroll
          for (int j = 0; j < 3; ++j) wcr[3 * i + j] += ac[i] * J.jp[k][j];
          bc[i] += J.jc[k][i] * wr;
        }
#pragma unroll
        for (int i = 0; i < 3; ++i) {
#pragma unroll
          for (int j = i; j < 3; ++j) vb[upper(i, j, 3)] += ap[i] * J.jp[k][j];
          vb[6 + i] += J.jp[k][i] * wr;
        }
      }
    }
    if (pair) {
#pragma unroll
      for (int k = 0; k < 3; ++k)
#pragma unroll
        for (int i = 0; i < 6; ++i) wc[(3 * ml + k) * n + 6 * w + i] = wcr[3 * i + k];
#pragma unroll
      for (int i = 0; i < 9; ++i) vpart[9 * t + i] = vb[i];
    }
    __syncthreads();

    // 2. each point: V and bp over the frames, V damped and inverted
    if (t < P) {
      float V[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f}, bp[3] = {0.f, 0.f, 0.f};
      for (int f = 0; f < W; ++f) {
        const float* s = vpart + 9 * (f * P + t);
#pragma unroll
        for (int i = 0; i < 6; ++i) V[i] += s[i];
#pragma unroll
        for (int i = 0; i < 3; ++i) bp[i] += s[6 + i];
      }
      float inv[9] = {1.f, 0.f, 0.f, 0.f, 1.f, 0.f, 0.f, 0.f, 1.f};
      const int mm = m0 + t;
      if (mm < M && q.valid[(size_t)b * M + mm]) {
        // V + lam diag(max(diag V, 1e-6)) + v_eps I (solvers/ba.py _reduce_plain)
        const int d[3] = {0, 3, 5};
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          const float vii = V[d[i]];
          V[d[i]] = vii + lam * (vii < 1e-6f ? 1e-6f : vii) + a.v_eps;
        }
        const float c00 = V[3] * V[5] - V[4] * V[4], c01 = V[2] * V[4] - V[1] * V[5];
        const float c02 = V[1] * V[4] - V[2] * V[3], c11 = V[0] * V[5] - V[2] * V[2];
        const float c12 = V[1] * V[2] - V[0] * V[4], c22 = V[0] * V[3] - V[1] * V[1];
        const float det = V[0] * c00 + V[1] * c01 + V[2] * c02;
        const float cof[9] = {c00, c01, c02, c01, c11, c12, c02, c12, c22};
#pragma unroll
        for (int i = 0; i < 9; ++i) inv[i] = cof[i] / det;
      }
      float* out = vi + 12 * t;
#pragma unroll
      for (int i = 0; i < 9; ++i) out[i] = inv[i];
#pragma unroll
      for (int i = 0; i < 3; ++i) out[9 + i] = bp[i];
      if (a.aux && mm < M) {
        float* g = a.aux + ((size_t)b * M + mm) * 12;
#pragma unroll
        for (int i = 0; i < 12; ++i) g[i] = out[i];
      }
    }
    __syncthreads();

    // 3. each pair: Wc V^-1, and its share of Wc V^-1 bp
    if (pair) {
      const float* iv = vi + 12 * ml;
#pragma unroll
      for (int i = 0; i < 6; ++i)
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          const float x = wcr[3 * i] * iv[k] + wcr[3 * i + 1] * iv[3 + k] + wcr[3 * i + 2] * iv[6 + k];
          wv[(3 * ml + k) * n + 6 * w + i] = x;
          wvbp[i] += x * iv[9 + k];
        }
    }
    __syncthreads();

    // 4. S += (Wc V^-1) Wc^T over the tile, 3x3 tiles of the upper triangle
    for (int k = t; k < tiles3; k += kThreads) {
      int I, J;
      upper_tile(k, n3, I, J);
      const float* pa = wv + 3 * I;
      const float* pb = wc + 3 * J;
      float acc[9];
#pragma unroll
      for (int i = 0; i < 9; ++i) acc[i] = 0.f;
      for (int d = 0; d < depth; ++d) {
        const float a0 = pa[d * n], a1 = pa[d * n + 1], a2 = pa[d * n + 2];
        const float b0 = pb[d * n], b1 = pb[d * n + 1], b2 = pb[d * n + 2];
        acc[0] += a0 * b0; acc[1] += a0 * b1; acc[2] += a0 * b2;
        acc[3] += a1 * b0; acc[4] += a1 * b1; acc[5] += a1 * b2;
        acc[6] += a2 * b0; acc[7] += a2 * b1; acc[8] += a2 * b2;
      }
      float* s = S + 3 * I * n + 3 * J;
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int j = 0; j < 3; ++j) s[i * n + j] += acc[3 * i + j];
    }
    __syncthreads();
  }

  // U, bc and Wc V^-1 bp of each frame: the pairs' sums over the points
  float* part = wc;  // W P x kPart, over the tiles (kPart <= 36)
  if (pair) {
#pragma unroll
    for (int i = 0; i < 21; ++i) part[kPart * t + i] = U[i];
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      part[kPart * t + 21 + i] = bc[i];
      part[kPart * t + 27 + i] = wvbp[i];
    }
  }
  __syncthreads();
  float* tot = vpart;  // W x kPart (P >= 4)
  for (int i = t; i < W * kPart; i += kThreads) {
    const int f = i / kPart, k = i - f * kPart;
    float s = 0.f;
    for (int j = 0; j < P; ++j) s += part[kPart * (f * P + j) + k];
    tot[i] = s;
  }
  __syncthreads();

  // S = blockdiag(U damped) - sum Wc V^-1 Wc^T, the first n_fixed frames
  // pinned (solvers/ba.py _gauge), and its right-hand side
  for (int i = t; i < n * n; i += kThreads) {
    const int row = i / n, col = i - row * n, fr = row / 6, fc = col / 6;
    float val;
    if (fr < a.n_fixed || fc < a.n_fixed) {
      val = row == col ? 1.f : 0.f;
    } else {
      const float acc = (row / 3 <= col / 3) ? S[row * n + col] : S[col * n + row];
      if (fr == fc) {
        const int r6 = row - 6 * fr, c6 = col - 6 * fc;
        float u = tot[fr * kPart + upper(r6, c6, 6)];
        if (r6 == c6) u = u + lam * (u < 1e-6f ? 1e-6f : u);
        val = u - acc;
      } else {
        val = -acc;
      }
    }
    Sout[i] = val;
  }
  for (int i = t; i < n; i += kThreads) {
    const int f = i / 6, k = i - 6 * f;
    a.rhs[(size_t)b * n + i] =
        f < a.n_fixed ? 0.f : tot[f * kPart + 21 + k] - tot[f * kPart + 27 + k];
  }
  if (t == 0) a.cost[b] = cost / fmaxf(count, 1.f);
}

template <int R>
__global__ void __launch_bounds__(kThreads) ba_step_kernel(StepArgs a) {
  __shared__ float cold[kMaxFrames * kCamRec], cnew[kMaxFrames * kCamRec];
  __shared__ float dc[kMaxFrames * 6], red[kThreads];
  const Window& q = a.q;
  const int b = blockIdx.x, t = threadIdx.x, W = q.W, M = q.M;

  if (q.done && q.done[b]) {
    for (int i = t; i < W * 6; i += kThreads)
      a.cam_new[(size_t)b * W * 6 + i] = q.cam[(size_t)b * W * 6 + i];
    for (int i = t; i < M * 3; i += kThreads)
      a.pts_new[(size_t)b * M * 3 + i] = q.pts[(size_t)b * M * 3 + i];
    if (t == 0) {
      a.cost[b] = 0.f;
      a.finite[b] = 1;
    }
    return;
  }
  bool fin = true;
  for (int w = t; w < W; w += kThreads) {
    const float* c = q.cam + ((size_t)b * W + w) * 6;
    const float* d = a.dcam + ((size_t)b * W + w) * 6;
    float cn[6];
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      dc[6 * w + i] = d[i];
      cn[i] = c[i] + d[i];
      fin = fin && isfinite(d[i]);
      a.cam_new[((size_t)b * W + w) * 6 + i] = cn[i];
    }
    camera_record(c, cold + w * kCamRec);
    camera_record(cn, cnew + w * kCamRec);
  }
  __syncthreads();

  const float* R0 = cnew + 6;  // the first camera after the step
  const float* t0 = cnew + 3;
  float count = 0.f, cost = 0.f;
  for (int m = t; m < M; m += kThreads) {
    const float* p = q.pts + ((size_t)b * M + m) * 3;
    const float px = p[0], py = p[1], pz = p[2];
    // sum over frames of Wc^T dcam
    float g[3] = {0.f, 0.f, 0.f};
    for (int w = 0; w < W; ++w) {
      const size_t o = ((size_t)b * W + w) * M + m;
      Obs<R> J;
      observe<R>(q, cold + w * kCamRec, px, py, pz, q.obs + o * R, q.mask[o] != 0, J);
      const float* d = dc + 6 * w;
#pragma unroll
      for (int k = 0; k < Obs<R>::K; ++k) {
        float s = 0.f;
#pragma unroll
        for (int i = 0; i < 6; ++i) s += J.jc[k][i] * d[i];
        s *= J.wt * Obs<R>::mult(k);
#pragma unroll
        for (int j = 0; j < 3; ++j) g[j] += s * J.jp[k][j];
      }
    }
    // dpts = V^-1 (bp - sum Wc^T dcam), zero for a point seen fewer than twice
    const float* x = a.aux + ((size_t)b * M + m) * 12;
    const float h[3] = {x[9] - g[0], x[10] - g[1], x[11] - g[2]};
    const float keep = q.valid[(size_t)b * M + m] ? 1.f : 0.f;
    float dp[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      dp[i] = (x[3 * i] * h[0] + x[3 * i + 1] * h[1] + x[3 * i + 2] * h[2]) * keep;
      fin = fin && isfinite(dp[i]);
    }
    float nx = px + dp[0], ny = py + dp[1], nz = pz + dp[2];
    if (a.clamp) {  // the depth in the first camera into [zmin, zmax] (_clamp_depth)
      const float cx = R0[0] * nx + R0[1] * ny + R0[2] * nz + t0[0];
      const float cy = R0[3] * nx + R0[4] * ny + R0[5] * nz + t0[1];
      float cz = R0[6] * nx + R0[7] * ny + R0[8] * nz + t0[2];
      cz = cz < a.zmin ? a.zmin : (cz > a.zmax ? a.zmax : cz);
      const float ex = cx - t0[0], ey = cy - t0[1], ez = cz - t0[2];
      nx = ex * R0[0] + ey * R0[3] + ez * R0[6];
      ny = ex * R0[1] + ey * R0[4] + ez * R0[7];
      nz = ex * R0[2] + ey * R0[5] + ez * R0[8];
    }
    float* pn = a.pts_new + ((size_t)b * M + m) * 3;
    pn[0] = nx;
    pn[1] = ny;
    pn[2] = nz;
    cost += point_cost<R>(q, cnew, b, m, nx, ny, nz, count);
  }
  cost = block_sum(cost, red);
  count = block_sum(count, red);
  fin = __syncthreads_and(fin);
  if (t == 0) {
    a.cost[b] = cost / fmaxf(count, 1.f);
    a.finite[b] = fin ? 1 : 0;
  }
}

int current_device(int* dev) {
  const cudaError_t err = cudaGetDevice(dev);
  if (err != cudaSuccess) return (int)err;
  return *dev < 0 || *dev >= kMaxDevices ? (int)cudaErrorInvalidDevice : 0;
}

template <int R>
int launch_reduce(const ReduceArgs& a, int batch, cudaStream_t stream) {
  static size_t allowed[kMaxDevices] = {};  // dynamic shared memory granted, per device
  const size_t bytes = reduce_floats(a.q.W) * sizeof(float);
  int dev = 0;
  if (const int err = current_device(&dev)) return err;
  if (bytes > allowed[dev]) {
    const cudaError_t err = cudaFuncSetAttribute(
        ba_reduce_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
    allowed[dev] = bytes;
  }
  ba_reduce_kernel<R><<<batch, kThreads, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int R>
int launch_step(const StepArgs& a, int batch, cudaStream_t stream) {
  ba_step_kernel<R><<<batch, kThreads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

bool bad_shape(int batch, int W, int M, int R) {
  return batch < 0 || W < 1 || W > kMaxFrames || M < 0 || (R != 2 && R != 4);
}

Window make_window(const float* cam, const float* pts, const float* obs, const uint8_t* mask,
              const uint8_t* done, const uint8_t* valid, int W, int M, float fu, float fv,
              float cu, float cv, float baseline, float delta) {
  Window q;
  q.cam = cam;
  q.pts = pts;
  q.obs = obs;
  q.mask = mask;
  q.done = done;
  q.valid = valid;
  q.W = W;
  q.M = M;
  q.fu = fu;
  q.fv = fv;
  q.cu = cu;
  q.cv = cv;
  q.baseline = baseline;
  q.delta = delta;
  return q;
}

}  // namespace

// Kernel A. Inputs: cam (batch, W, 6), pts (batch, M, 3), obs (batch, W, M,
// R) f32; mask (batch, W, M), valid (batch, M) and done (batch, or null) as
// bytes 0/1; lam (batch) f32. Outputs: S (batch, 6W, 6W), rhs (batch, 6W),
// cost (batch) and, unless null, aux (batch, M, 12). All contiguous on the
// current device; 1 <= W <= 32, R 2 (mono) or 4 (stereo). Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int ba_reduce_f32(const float* cam, const float* pts, const float* obs,
                             const uint8_t* mask, const uint8_t* done, const uint8_t* valid,
                             const float* lam, float* S, float* rhs, float* cost, float* aux,
                             int batch, int W, int M, int R, int n_fixed, float fu, float fv,
                             float cu, float cv, float baseline, float delta, float v_eps,
                             cudaStream_t stream) {
  if (bad_shape(batch, W, M, R)) return (int)cudaErrorInvalidValue;
  if (batch == 0) return 0;
  ReduceArgs a;
  a.q = make_window(cam, pts, obs, mask, done, valid, W, M, fu, fv, cu, cv, baseline, delta);
  a.lam = lam;
  a.S = S;
  a.rhs = rhs;
  a.cost = cost;
  a.aux = aux;
  a.n_fixed = n_fixed;
  a.v_eps = v_eps;
  return R == 4 ? launch_reduce<4>(a, batch, stream) : launch_reduce<2>(a, batch, stream);
}

// Kernel B. Inputs as kernel A's, with dcam (batch, W, 6) and aux (batch, M,
// 12) as A wrote it; clamp != 0 clamps the depth in the first camera to
// [zmin, zmax]. Outputs: cam_new (batch, W, 6), pts_new (batch, M, 3), cost
// (batch) f32 and finite (batch) bytes 0/1.
extern "C" int ba_step_f32(const float* cam, const float* pts, const float* obs,
                           const uint8_t* mask, const uint8_t* done, const uint8_t* valid,
                           const float* dcam, const float* aux, float* cam_new, float* pts_new,
                           float* cost, uint8_t* finite, int batch, int W, int M, int R,
                           int clamp, float fu, float fv, float cu, float cv, float baseline,
                           float delta, float zmin, float zmax, cudaStream_t stream) {
  if (bad_shape(batch, W, M, R)) return (int)cudaErrorInvalidValue;
  if (batch == 0) return 0;
  StepArgs a;
  a.q = make_window(cam, pts, obs, mask, done, valid, W, M, fu, fv, cu, cv, baseline, delta);
  a.dcam = dcam;
  a.aux = aux;
  a.cam_new = cam_new;
  a.pts_new = pts_new;
  a.cost = cost;
  a.finite = finite;
  a.clamp = clamp;
  a.zmin = zmin;
  a.zmax = zmax;
  return R == 4 ? launch_step<4>(a, batch, stream) : launch_step<2>(a, batch, stream);
}
