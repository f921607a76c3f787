// Mixed-feature ARD Matern-5/2 kernel and its gradient, for Hopper (sm_90a).
//
// Replaces the fused ARD distance + Matern-5/2 that the JAX package once had
// as a Pallas kernel (ops/matern_pallas.py, added in 0b57930, removed in
// d3abbcb) and that the JAX package's models/kernels.py:85 matern52_ard
// computes on the TPU as one XLA fusion. Eager PyTorch has no such fusion: the
// plain a[:,None,:] - b[None,:,:] writes an [N, M, D] tensor to device memory
// (84 MB per restart at 1024 x 1024 x 20). These kernels compute the distance
// in registers and write only the [B, N, M] output (forward) or the
// [B, 1 + Dc + Ds] parameter gradients (backward).
//
// Bound on the H100: bytes. The forward reads O((N + M) * D) inputs and writes
// B*N*M floats; it does ~3*D flops per output, far below the ~20 flops per
// byte where float32 (67 TFLOP/s) would take over from HBM (3.35 TB/s).
// This first version is one thread per output (forward) or a few outputs per
// thread (backward), with a loop over D; inputs are re-read through L1/L2.
// Tiling x1/x2 into shared memory is left for a later change.
//
// Numerics follow the JAX package's models/kernels.py: exact differences at every
// Dc (the plain version switches to the ||a||^2 - 2ab + ||b||^2 expansion
// above 64 dims; the kernel does not), r = sqrt(max(r^2, 1e-20)), and
// k = amp^2 (1 + sqrt5 r + 5/3 r^2) exp(-sqrt5 r). The backward uses
// dk/d(r^2) = -(5/6) amp^2 (1 + sqrt5 r) exp(-sqrt5 r), finite at r = 0.
//
// Plain C interface, bound from Python with ctypes (vizier_tpu_torch/ops/
// native.py). Each entry point launches on the caller's stream, allocates
// nothing and returns cudaGetLastError() right after its launches.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kSqrt5 = 2.2360679774997896f;
constexpr int kThreads = 256;
constexpr int kItems = 8;  // (n, m) pairs per thread in the parameter backward

struct Inputs {
  const float* x1;     // [N, Dc] or [B, N, Dc]
  const int32_t* z1;   // [N, Ds]
  const float* x2;     // [M, Dc] or [B, M, Dc]
  const int32_t* z2;   // [M, Ds]
  const float* amp;    // [B]
  const float* inv_c;  // [B, Dc], zero on masked dims
  const float* inv_s;  // [B, Ds] squared inverse length scales, zero on masked dims
  int64_t x1_bstride;  // elements between batch members of x1; 0 when shared
  int64_t x2_bstride;
  int B, N, M, Dc, Ds;
};

__device__ __forceinline__ float sq_distance(const Inputs& in, int b, int n, int m) {
  const float* a = in.x1 + b * in.x1_bstride + (int64_t)n * in.Dc;
  const float* c = in.x2 + b * in.x2_bstride + (int64_t)m * in.Dc;
  const float* inv = in.inv_c + (int64_t)b * in.Dc;
  float sq = 0.f;
  for (int d = 0; d < in.Dc; ++d) {
    const float t = (__ldg(a + d) - __ldg(c + d)) * __ldg(inv + d);
    sq = fmaf(t, t, sq);
  }
  const int32_t* za = in.z1 + (int64_t)n * in.Ds;
  const int32_t* zc = in.z2 + (int64_t)m * in.Ds;
  const float* inv_s = in.inv_s + (int64_t)b * in.Ds;
  for (int s = 0; s < in.Ds; ++s) {
    if (__ldg(za + s) != __ldg(zc + s)) sq += __ldg(inv_s + s);
  }
  return sq;
}

__global__ void matern52_fwd_kernel(Inputs in, float* __restrict__ out) {
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  const int n = blockIdx.y * blockDim.y + threadIdx.y;
  const int b = blockIdx.z;
  if (n >= in.N || m >= in.M) return;
  const float sq = sq_distance(in, b, n, m);
  const float r = sqrtf(fmaxf(sq, 1e-20f));
  const float a = __ldg(in.amp + b);
  const float k = (1.f + kSqrt5 * r + (5.f / 3.f) * sq) * expf(-kSqrt5 * r);
  out[((int64_t)b * in.N + n) * in.M + m] = a * a * k;
}

// Sum of v over the block, in a fixed order; the result is valid in thread 0.
__device__ float block_sum(float v, float* scratch) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();  // scratch may still be read by a previous call
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  float total = 0.f;
  if (threadIdx.x == 0) {
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) total += scratch[w];
  }
  return total;
}

// Per-block partial sums of the parameter gradients, [B, G, 1 + Dc + Ds],
// in the order (amplitude, inv_c[0..Dc), inv_s[0..Ds)). Each block covers
// kItems * kThreads consecutive (n, m) pairs of one batch member. When w is
// not null it also stores dL/d(r^2) per pair for the feature gradient.
__global__ void matern52_bwd_params_kernel(Inputs in, const float* __restrict__ gk,
                                           float* __restrict__ partials,
                                           float* __restrict__ w_out) {
  __shared__ float scratch[kThreads / 32];
  const int b = blockIdx.y;
  const int64_t total = (int64_t)in.N * in.M;
  const float amp = __ldg(in.amp + b);
  int rows[kItems], cols[kItems];
  float w[kItems];
  float g_amp = 0.f;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int64_t e = ((int64_t)blockIdx.x * kItems + i) * blockDim.x + threadIdx.x;
    rows[i] = 0;
    cols[i] = 0;
    w[i] = 0.f;
    if (e < total) {
      const int n = (int)(e / in.M), m = (int)(e % in.M);
      rows[i] = n;
      cols[i] = m;
      const float sq = sq_distance(in, b, n, m);
      const float r = sqrtf(fmaxf(sq, 1e-20f));
      const float ex = expf(-kSqrt5 * r);
      const float g = __ldg(gk + (int64_t)b * total + e);
      g_amp += g * 2.f * amp * (1.f + kSqrt5 * r + (5.f / 3.f) * sq) * ex;
      w[i] = g * amp * amp * (-5.f / 6.f) * (1.f + kSqrt5 * r) * ex;
      if (w_out != nullptr) w_out[(int64_t)b * total + e] = w[i];
    }
  }
  const int P = 1 + in.Dc + in.Ds;
  float* out = partials + ((int64_t)b * gridDim.x + blockIdx.x) * P;
  float s = block_sum(g_amp, scratch);
  if (threadIdx.x == 0) out[0] = s;
  const float* inv = in.inv_c + (int64_t)b * in.Dc;
  const float* x1 = in.x1 + b * in.x1_bstride;
  const float* x2 = in.x2 + b * in.x2_bstride;
  for (int d = 0; d < in.Dc; ++d) {
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const float diff = __ldg(x1 + (int64_t)rows[i] * in.Dc + d) -
                         __ldg(x2 + (int64_t)cols[i] * in.Dc + d);
      acc = fmaf(w[i], diff * diff, acc);
    }
    s = block_sum(acc, scratch);
    if (threadIdx.x == 0) out[1 + d] = 2.f * __ldg(inv + d) * s;
  }
  for (int t = 0; t < in.Ds; ++t) {
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const bool differ = __ldg(in.z1 + (int64_t)rows[i] * in.Ds + t) !=
                          __ldg(in.z2 + (int64_t)cols[i] * in.Ds + t);
      acc += differ ? w[i] : 0.f;
    }
    s = block_sum(acc, scratch);
    if (threadIdx.x == 0) out[1 + in.Dc + t] = s;
  }
}

// out[b, p] = sum over g of partials[b, g, p], in a fixed order.
__global__ void matern52_bwd_reduce_kernel(const float* __restrict__ partials, int G, int P,
                                           float* __restrict__ out) {
  __shared__ float scratch[kThreads / 32];
  const int p = blockIdx.x, b = blockIdx.y;
  float acc = 0.f;
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    acc += partials[((int64_t)b * G + g) * P + p];
  }
  const float s = block_sum(acc, scratch);
  if (threadIdx.x == 0) out[(int64_t)b * P + p] = s;
}

// Gradient with respect to one side's continuous features:
//   side 0: gx1[bx, n, d] = sum_{b, m} w[b, n, m] * 2 (x1 - x2)[d] * inv[b, d]^2
//   side 1: gx2[bx, m, d] = sum_{b, n} w[b, n, m] * 2 (x2 - x1)[d] * inv[b, d]^2
// where bx runs over the batch when that side is batched (then b = bx), and
// is a single slot summing over every b when the side is shared.
__global__ void matern52_bwd_features_kernel(Inputs in, const float* __restrict__ w, int side,
                                             float* __restrict__ gx) {
  const int self_count = side == 0 ? in.N : in.M;
  const int other_count = side == 0 ? in.M : in.N;
  const int64_t self_bstride = side == 0 ? in.x1_bstride : in.x2_bstride;
  const int64_t other_bstride = side == 0 ? in.x2_bstride : in.x1_bstride;
  const float* xs = side == 0 ? in.x1 : in.x2;
  const float* xo = side == 0 ? in.x2 : in.x1;
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t per_slot = (int64_t)self_count * in.Dc;
  const int slots = self_bstride != 0 ? in.B : 1;
  if (idx >= per_slot * slots) return;
  const int bx = (int)(idx / per_slot);
  const int j = (int)((idx % per_slot) / in.Dc);
  const int d = (int)(idx % in.Dc);
  const int b_lo = self_bstride != 0 ? bx : 0;
  const int b_hi = self_bstride != 0 ? bx + 1 : in.B;
  const int64_t total = (int64_t)in.N * in.M;
  float acc = 0.f;
  for (int b = b_lo; b < b_hi; ++b) {
    const float inv = __ldg(in.inv_c + (int64_t)b * in.Dc + d);
    const float xj = __ldg(xs + b * self_bstride + (int64_t)j * in.Dc + d);
    const float* other = xo + b * other_bstride + d;
    float part = 0.f;
    for (int o = 0; o < other_count; ++o) {
      const int64_t e = side == 0 ? (int64_t)j * in.M + o : (int64_t)o * in.M + j;
      part = fmaf(__ldg(w + (int64_t)b * total + e), xj - __ldg(other + (int64_t)o * in.Dc), part);
    }
    acc += 2.f * inv * inv * part;
  }
  gx[idx] = acc;
}

Inputs make_inputs(const float* x1, const int32_t* z1, const float* x2, const int32_t* z2,
                   const float* amp, const float* inv_c, const float* inv_s, int64_t x1_bstride,
                   int64_t x2_bstride, int B, int N, int M, int Dc, int Ds) {
  Inputs in;
  in.x1 = x1;
  in.z1 = z1;
  in.x2 = x2;
  in.z2 = z2;
  in.amp = amp;
  in.inv_c = inv_c;
  in.inv_s = inv_s;
  in.x1_bstride = x1_bstride;
  in.x2_bstride = x2_bstride;
  in.B = B;
  in.N = N;
  in.M = M;
  in.Dc = Dc;
  in.Ds = Ds;
  return in;
}

}  // namespace

extern "C" {

// Number of partial-sum blocks per batch member that the parameter backward
// uses for an N x M output; the caller sizes the partials buffer with it.
int matern52_bwd_num_blocks(int N, int M) {
  const int64_t per_block = (int64_t)kThreads * kItems;
  return (int)(((int64_t)N * M + per_block - 1) / per_block);
}

int matern52_ard_fwd(const float* x1, const int32_t* z1, const float* x2, const int32_t* z2,
                     const float* amp, const float* inv_c, const float* inv_s,
                     int64_t x1_bstride, int64_t x2_bstride, int B, int N, int M, int Dc, int Ds,
                     float* out, void* stream) {
  const Inputs in = make_inputs(x1, z1, x2, z2, amp, inv_c, inv_s, x1_bstride, x2_bstride, B, N,
                                M, Dc, Ds);
  const dim3 block(32, 8);
  const dim3 grid((M + 31) / 32, (N + 7) / 8, B);
  matern52_fwd_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(in, out);
  return (int)cudaGetLastError();
}

// grads: [B, 1 + Dc + Ds]; partials: [B, G, 1 + Dc + Ds] scratch with
// G = matern52_bwd_num_blocks(N, M). w: [B, N, M] scratch, needed (not null)
// only when gx1 or gx2 is requested; gx1: [N, Dc] or [B, N, Dc] as x1 is
// shared or batched (null to skip), gx2 likewise.
int matern52_ard_bwd(const float* gk, const float* x1, const int32_t* z1, const float* x2,
                     const int32_t* z2, const float* amp, const float* inv_c, const float* inv_s,
                     int64_t x1_bstride, int64_t x2_bstride, int B, int N, int M, int Dc, int Ds,
                     float* grads, float* partials, float* w, float* gx1, float* gx2,
                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Inputs in = make_inputs(x1, z1, x2, z2, amp, inv_c, inv_s, x1_bstride, x2_bstride, B, N,
                                M, Dc, Ds);
  const int G = matern52_bwd_num_blocks(N, M);
  const int P = 1 + Dc + Ds;
  if (G > 0) {
    matern52_bwd_params_kernel<<<dim3(G, B), kThreads, 0, s>>>(in, gk, partials, w);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  matern52_bwd_reduce_kernel<<<dim3(P, B), kThreads, 0, s>>>(partials, G, P, grads);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  float* gx[2] = {gx1, gx2};
  for (int side = 0; side < 2; ++side) {
    if (gx[side] == nullptr || Dc == 0) continue;
    const int64_t stride = side == 0 ? x1_bstride : x2_bstride;
    const int64_t count = (int64_t)(side == 0 ? N : M) * Dc * (stride != 0 ? B : 1);
    const int blocks = (int)((count + kThreads - 1) / kThreads);
    if (blocks == 0) continue;
    matern52_bwd_features_kernel<<<blocks, kThreads, 0, s>>>(in, w, side, gx[side]);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

}  // extern "C"
