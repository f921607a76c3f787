// Mixed-feature ARD Matern-5/2 kernel and its gradient, for Hopper (sm_90a).
//
// Replaces the fused ARD distance + Matern-5/2 that the JAX package once had
// as a Pallas kernel (ops/matern_pallas.py, added in 0b57930, removed in
// d3abbcb) and that the JAX package's models/kernels.py:85 matern52_ard
// computes on the TPU as one XLA fusion, together with the row mask and
// noise diagonal that its models/gp.py:189 _masked_gram puts around it.
//
// K1 (forward) writes the [B, N, M] kernel matrix; K2 (backward) writes the
// [B, 1 + Dc + Ds] parameter gradients, and for input warping the feature
// gradients.
//
// Bound on the H100: bytes. K1 reads O((N + M) * D) inputs and writes B*N*M
// floats; per distinct pair it does ~2*D + 15 operations, below the ~20
// operations per byte where float32 (67 TFLOP/s) would take over from HBM
// (3.35 TB/s). K2 reads the B*N*M incoming gradient and does ~5*D + 20
// operations per distinct pair, on the same side of the line at D = 20.
//
// Design:
// - One block owns one batch member's TN x TM output tile. It stages the x1
//   and x2 rows of the tile into shared memory with cp.async copies (every
//   copy in flight at once), d-major with padding: a feature slot's TN values
//   are contiguous, so a thread's micro-tile reads are 16-byte vector loads
//   without bank conflicts. K1 then scales the staged rows by the inverse
//   length scales: one multiply per row and dim, the reference's
//   a = x1 * inv, b = x2 * inv, diff = a - b, with the same rounding.
// - Feature slots are staged kSlots at a time: slot p < Dc is continuous dim
//   p, slot p >= Dc is categorical dim p - Dc (its int32 code). Differences
//   stay exact at every Dc (the plain version switches to the
//   ||a||^2 - 2ab + ||b||^2 expansion above 64 dims; the kernels do not).
// - Each thread keeps an RN x RM register micro-tile of outputs, computed in
//   kPasses passes of RN / kPasses rows (fewer live registers, and one
//   pass's stores drain while the next computes); per slot it reads its row
//   values and RM column values from shared memory once. The epilogue
//   applies amp^2 * Matern-5/2, the row masks and the diagonal, and stores
//   along M with float4 writes (scalar at a ragged edge).
// - Tile shapes: 64 x 64 outputs by 128 threads (8 x 4 each, two passes of
//   4 x 4) for the Gram and every shape with at least one such tile per SM;
//   16 x 16 by 256 threads, one output each, below that (the sweep's 50-query
//   cross kernel: more blocks in flight for a launch that is mostly latency).
//   chip_smoke.py times both at the main path's cross shapes, which sit on
//   either side of the line. The register budget holds the 64 x 64 kernels
//   to 80 registers, six blocks (24 warps) per SM, so the Gram's 5 x 136
//   upper tiles run in one wave; ptxas' report and chip_smoke.py's
//   occupancy line show it.
// - Symmetric Gram (x2 is x1, z2 is z1): only tiles on or above the diagonal
//   run. Each off-diagonal tile also writes its mirror, transposed through
//   shared memory so that store is coalesced too; the two triangles hold the
//   same floats bit for bit.
// - Masks and diagonal (the reference's _masked_gram): 0 where either row is
//   padded, K + diag[b] on the valid diagonal, 1 on the padded diagonal.
// - K2 stages its tile of the incoming gradient (plus the mirrored tile's,
//   transposed, in the symmetric Gram: each off-diagonal pair is weighted by
//   gk_ij + gk_ji), recomputes each pair's distance from the staged rows
//   (scaling in registers, the same products K1 forms), and sums each
//   parameter's gradient over the block: warp shuffles per parameter, then
//   one pass over the warps' sums in shared memory per kSlots parameters. A
//   second launch sums the per-block partials in a fixed order: no atomics,
//   so L-BFGS sees bit-identical gradients on every call.
//
// Numerics follow the JAX package's models/kernels.py: r = sqrt(max(r^2,
// 1e-20)), k = amp^2 (1 + sqrt5 r + 5/3 r^2) exp(-sqrt5 r). The backward uses
// dk/d(r^2) = -(5/6) amp^2 (1 + sqrt5 r) exp(-sqrt5 r), finite at r = 0, and
// d(r^2)/d inv_d = 2 inv_d (x1 - x2)_d^2 from the raw differences, so a
// masked dim (inv_d = 0) gets a zero gradient.
//
// Plain C interface, bound from Python with ctypes (vizier_tpu_torch/ops/
// native.py). Each entry point launches on the caller's stream, allocates
// nothing, does not synchronise (so it can be captured in a CUDA graph) and
// returns cudaGetLastError() right after its launches.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kSqrt5 = 2.2360679774997896f;
constexpr int kSlots = 32;  // feature slots staged per chunk
constexpr int kPad = 4;     // keeps staged rows 16-byte aligned
constexpr int kTX = 16;     // threads along M in every tile shape

// A block of kTX x TY threads; each thread owns RN rows x RM columns, which
// K1 computes and stores in kPasses passes of RN / kPasses rows (the stores
// of one pass drain while the next computes).
template <int TY_, int RN_, int RM_, int kPasses_ = 1>
struct Tile {
  static constexpr int TY = TY_, RN = RN_, RM = RM_, kPasses = kPasses_;
  static constexpr int kThreads = kTX * TY;
  static constexpr int TN = TY * RN, TM = kTX * RM;
  static constexpr int RNP = RN / kPasses, TNP = TN / kPasses;  // per pass
  static constexpr int SA = TN + kPad, SB = TM + kPad;  // staged row strides
  static constexpr int kStage = kSlots * (SA + SB);      // floats
  // Blocks per SM the register budget is held to (65536 registers).
  static constexpr int kMinBlocks = 6 * 128 / kThreads > 0 ? 6 * 128 / kThreads : 1;
  static_assert(RN % kPasses == 0, "whole rows per pass");
};
// 64 x 64 outputs, 128 threads of 8 x 4 in two passes of 4 x 4: the Gram and
// every shape that fills the card. Square, as the symmetric Gram needs.
using BigTile = Tile<8, 8, 4, 2>;
// 16 x 16 outputs, 256 threads of one output each: shapes with few big
// tiles, such as the acquisition sweep's 50-query cross kernel, where one
// launch's latency is most of the time and more blocks in flight shorten it.
using TinyTile = Tile<16, 1, 1>;

// Batched inputs belong to groups of `group` consecutive batch members (a
// study's restarts or ensemble members): member b reads group b / group's
// rows, categorical block and row masks, at that group's stride. A stride of
// 0 shares the input across the whole batch. group 1 with every stride but
// x's 0 is the original interface, and computes the same floats.
struct Inputs {
  const float* x1;       // [N, Dc] or [B / group, N, Dc]
  const int32_t* z1;     // [N, Ds] or [B / group, N, Ds]
  const float* x2;       // [M, Dc] or [B / group, M, Dc]
  const int32_t* z2;     // [M, Ds] or [B / group, M, Ds]
  const float* amp;      // [B]
  const float* inv_c;    // [B, Dc], zero on masked dims
  const float* inv_s;    // [B, Ds] squared inverse length scales, zero on masked dims
  const uint8_t* mask1;  // [N] or [B / group, N] row mask (bool), or null for all valid
  const uint8_t* mask2;  // [M] or [B / group, M]
  const float* diag;     // [B], or null: added on the valid diagonal, 1 on the padded one
  int64_t x1_bstride;    // elements between groups of x1; 0 when shared
  int64_t x2_bstride;
  int64_t z1_bstride;
  int64_t z2_bstride;
  int64_t m1_bstride;
  int64_t m2_bstride;
  int group;      // batch members per group (>= 1)
  int B, N, M, Dc, Ds;
  int symmetric;  // x2 is x1, z2 is z1 and mask2 is mask1 (N == M): upper tiles only
};

// The batch member's view of the inputs: its group's rows, codes and masks.
struct MemberRows {
  const float* x1;
  const int32_t* z1;
  const float* x2;
  const int32_t* z2;
  const uint8_t* mask1;
  const uint8_t* mask2;
};

__device__ __forceinline__ MemberRows member_rows(const Inputs& in, int b) {
  const int64_t g = b / in.group;
  return {in.x1 + g * in.x1_bstride,
          in.z1 + g * in.z1_bstride,
          in.x2 + g * in.x2_bstride,
          in.z2 + g * in.z2_bstride,
          in.mask1 != nullptr ? in.mask1 + g * in.m1_bstride : nullptr,
          in.mask2 != nullptr ? in.mask2 + g * in.m2_bstride : nullptr};
}

template <int R>
__device__ __forceinline__ void load_vec(float (&v)[R], const float* p) {
  if constexpr (R % 4 == 0) {
#pragma unroll
    for (int i = 0; i < R; i += 4) {
      const float4 t = *reinterpret_cast<const float4*>(p + i);
      v[i] = t.x;
      v[i + 1] = t.y;
      v[i + 2] = t.z;
      v[i + 3] = t.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < R; ++i) v[i] = p[i];
  }
}

// The tile (bi, bj) that block blockIdx.x of a batch member owns (the grid is
// [tiles per member, B]). Symmetric: the tiles on or above the diagonal, row
// by row; otherwise every tile, row by row.
template <class T>
__device__ __forceinline__ void tile_coords(const Inputs& in, int& bi, int& bj) {
  int rem = blockIdx.x;
  if (in.symmetric) {
    const int tiles = (in.N + T::TN - 1) / T::TN;
    int row = 0;
    while (rem >= tiles - row) {
      rem -= tiles - row;
      ++row;
    }
    bi = row;
    bj = row + rem;
  } else {
    const int tiles_m = (in.M + T::TM - 1) / T::TM;
    bi = rem / tiles_m;
    bj = rem - bi * tiles_m;
  }
}

// Asynchronous 4-byte copy from global to shared memory (Ampere and later);
// with valid false it writes zero and reads nothing.
__device__ __forceinline__ void cp_async4(float* dst, const void* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Starts copying feature slots [p0, p0 + width) of rows [r0, r0 + R) into
// s[slot * (R + kPad) + row]. Slot p < Dc is continuous dim p; slot p >= Dc
// is categorical dim p - Dc, copied as its int32 bits. Rows at or past
// `rows` are zero. Lane l of each warp copies slot l of one row
// (width <= kSlots = 32), so a warp reads a row's slots as one contiguous
// run. Nothing waits here: every copy of the block is in flight at once.
template <int R, int kThreads>
__device__ __forceinline__ void stage_rows(float* s, const float* x, const int32_t* z, int r0,
                                           int rows, int Dc, int Ds, int p0, int width,
                                           int tid) {
  static_assert(kSlots == 32, "one lane per slot");
  constexpr int kWarps = kThreads / 32;
  const int slot = tid & 31, p = p0 + slot;
  if (slot >= width) return;
  const bool cont = p < Dc;
  for (int r = tid >> 5; r < R; r += kWarps) {
    const bool valid = r0 + r < rows;
    const int64_t row = valid ? r0 + r : 0;  // a readable address, zero-filled
    const void* src = cont ? static_cast<const void*>(x + row * Dc + p)
                           : static_cast<const void*>(z + row * Ds + (p - Dc));
    cp_async4(s + slot * (R + kPad) + r, src, valid);
  }
}

// After this thread's copies have landed: multiplies the continuous values
// that it staged by scale[p] (K1's prescale, one multiply per row and dim).
template <int R, int kThreads>
__device__ __forceinline__ void scale_rows(float* s, int Dc, int p0, int width,
                                           const float* scale, int tid) {
  constexpr int kWarps = kThreads / 32;
  const int slot = tid & 31, p = p0 + slot;
  if (slot >= width || p >= Dc) return;
  const float sc = __ldg(scale + p);
  for (int r = tid >> 5; r < R; r += kWarps) s[slot * (R + kPad) + r] *= sc;
}

// Adds the squared scaled distances of the staged chunk to sq, for the R
// tile rows from a_row and the thread's RM columns. With `scale` null the
// staged values are already scaled (K1); otherwise each is scaled here by
// scale[p] (K2), the same product K1 forms while staging. Categorical slots
// follow every continuous one, so their mismatches add onto the finished
// continuous sum.
template <class T, int R>
__device__ __forceinline__ void accumulate_chunk(const float* sa, const float* sb, int a_row,
                                                 int tx, int p0, int width, int Dc,
                                                 const float* scale, const float* inv_s,
                                                 float (&sq)[R][T::RM]) {
  const int ncont = max(0, min(width, Dc - p0));
  for (int dd = 0; dd < ncont; ++dd) {
    float a[R], c[T::RM];
    load_vec<R>(a, sa + dd * T::SA + a_row);
    load_vec<T::RM>(c, sb + dd * T::SB + tx * T::RM);
    if (scale != nullptr) {
      const float iv = __ldg(scale + p0 + dd);
#pragma unroll
      for (int i = 0; i < R; ++i) a[i] *= iv;
#pragma unroll
      for (int j = 0; j < T::RM; ++j) c[j] *= iv;
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
#pragma unroll
      for (int j = 0; j < T::RM; ++j) {
        const float t = a[i] - c[j];
        sq[i][j] = fmaf(t, t, sq[i][j]);
      }
    }
  }
  for (int dd = ncont; dd < width; ++dd) {
    const float w = __ldg(inv_s + (p0 + dd - Dc));
    float a[R], c[T::RM];
    load_vec<R>(a, sa + dd * T::SA + a_row);
    load_vec<T::RM>(c, sb + dd * T::SB + tx * T::RM);
#pragma unroll
    for (int i = 0; i < R; ++i) {
#pragma unroll
      for (int j = 0; j < T::RM; ++j) {
        if (__float_as_int(a[i]) != __float_as_int(c[j])) sq[i][j] += w;
      }
    }
  }
}

// Squared scaled distances of R tile rows from a_row by the thread's RM
// columns, over every slot. Leaves the last chunk staged in sa/sb; with
// `staged` true and a single chunk, that chunk is already there.
template <class T, int R>
__device__ __forceinline__ void micro_tile_distances(const Inputs& in, int b, int n0, int m0,
                                                     int a_row, bool staged,
                                                     bool scale_in_registers, float* sa,
                                                     float* sb, float (&sq)[R][T::RM]) {
  const int tx = threadIdx.x, tid = threadIdx.y * kTX + tx;
  const MemberRows rows = member_rows(in, b);
  const float* inv = in.inv_c + (int64_t)b * in.Dc;
  const float* inv_s = in.inv_s + (int64_t)b * in.Ds;
  const float* stage_scale = scale_in_registers ? nullptr : inv;
#pragma unroll
  for (int i = 0; i < R; ++i) {
#pragma unroll
    for (int j = 0; j < T::RM; ++j) sq[i][j] = 0.f;
  }
  const int P = in.Dc + in.Ds;
  for (int p0 = 0; p0 < P; p0 += kSlots) {
    const int width = min(kSlots, P - p0);
    if (!staged || P > kSlots) {
      __syncthreads();  // the previous chunk may still be read
      stage_rows<T::TN, T::kThreads>(sa, rows.x1, rows.z1, n0, in.N, in.Dc, in.Ds, p0, width,
                                     tid);
      stage_rows<T::TM, T::kThreads>(sb, rows.x2, rows.z2, m0, in.M, in.Dc, in.Ds, p0, width,
                                     tid);
      cp_async_wait_all();
      if (stage_scale != nullptr) {
        scale_rows<T::TN, T::kThreads>(sa, in.Dc, p0, width, stage_scale, tid);
        scale_rows<T::TM, T::kThreads>(sb, in.Dc, p0, width, stage_scale, tid);
      }
      __syncthreads();
    }
    accumulate_chunk<T, R>(sa, sb, a_row, tx, p0, width, in.Dc,
                           scale_in_registers ? inv : nullptr, inv_s, sq);
  }
}

__device__ __forceinline__ bool row_valid(const uint8_t* mask, int row) {
  return mask == nullptr || __ldg(mask + row) != 0;
}

// Validity of R rows from n0 + a_row and the thread's RM columns: in range
// and unmasked in batch member b's masks.
template <class T, int R>
__device__ __forceinline__ void micro_tile_valid(const Inputs& in, int b, int n0, int m0,
                                                 int a_row, bool (&v1)[R], bool (&v2)[T::RM]) {
  const MemberRows rows = member_rows(in, b);
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = n0 + a_row + i;
    v1[i] = row < in.N && row_valid(rows.mask1, row);
  }
#pragma unroll
  for (int j = 0; j < T::RM; ++j) {
    const int col = m0 + threadIdx.x * T::RM + j;
    v2[j] = col < in.M && row_valid(rows.mask2, col);
  }
}

// Stores a thread's RM consecutive values of one output row, as one float4
// where the row is 16-byte aligned and whole, else one float at a time.
template <int RM>
__device__ __forceinline__ void store_row(float* row_ptr, int col, int cols, bool vec,
                                          const float* v) {
  if constexpr (RM == 4) {
    if (vec && col + 3 < cols) {
      *reinterpret_cast<float4*>(row_ptr + col) = make_float4(v[0], v[1], v[2], v[3]);
      return;
    }
  }
#pragma unroll
  for (int j = 0; j < RM; ++j) {
    if (col + j < cols) row_ptr[col + j] = v[j];
  }
}

template <class T>
__global__ void __launch_bounds__(T::kThreads, T::kMinBlocks)
    matern52_fwd_kernel(Inputs in, float* __restrict__ out) {
  constexpr int RNP = T::RNP, TNP = T::TNP, kTS = T::TM + 1;
  __shared__ __align__(16) float smem[T::kStage];
  __shared__ float mirror[TNP * kTS];  // one pass's rows, transposed on the way out
  float* sa = smem;
  float* sb = smem + kSlots * T::SA;
  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * kTX + tx;
  const int b = blockIdx.y;
  int bi, bj;
  tile_coords<T>(in, bi, bj);
  const int n0 = bi * T::TN, m0 = bj * T::TM;
  const bool mirrored = in.symmetric && bi != bj;
  const float amp = __ldg(in.amp + b);
  const float a2 = amp * amp;
  const float dval = in.diag != nullptr ? __ldg(in.diag + b) : 0.f;
  float* out_b = out + (int64_t)b * in.N * in.M;
  const bool vec = (in.M & 3) == 0;

  for (int pass = 0; pass < T::kPasses; ++pass) {
    const int a_row = pass * TNP + ty * RNP;
    float k[RNP][T::RM];
    micro_tile_distances<T, RNP>(in, b, n0, m0, a_row, pass > 0, false, sa, sb, k);
    bool v1[RNP], v2[T::RM];
    micro_tile_valid<T, RNP>(in, b, n0, m0, a_row, v1, v2);
#pragma unroll
    for (int i = 0; i < RNP; ++i) {
      const int row = n0 + a_row + i;
#pragma unroll
      for (int j = 0; j < T::RM; ++j) {
        const int col = m0 + tx * T::RM + j;
        const float s = k[i][j];
        const float r = sqrtf(fmaxf(s, 1e-20f));
        float v = a2 * ((1.f + kSqrt5 * r + (5.f / 3.f) * s) * expf(-kSqrt5 * r));
        const bool valid = v1[i] && v2[j];
        v = valid ? v : 0.f;
        if (in.diag != nullptr && row == col) v += valid ? dval : 1.f;
        k[i][j] = v;
      }
      if (row < in.N) store_row<T::RM>(out_b + (int64_t)row * in.M, m0 + tx * T::RM, in.M, vec, k[i]);
    }
    if (!mirrored) continue;

    // Mirror rows: out[m0 + c][n0 + pass * TNP + r] = k[r][c], transposed
    // through shared memory so that each thread again writes 4 consecutive
    // floats of a row.
    __syncthreads();  // the previous pass's mirror has been read
#pragma unroll
    for (int i = 0; i < RNP; ++i) {
#pragma unroll
      for (int j = 0; j < T::RM; ++j) mirror[(ty * RNP + i) * kTS + tx * T::RM + j] = k[i][j];
    }
    __syncthreads();
    static_assert(TNP % 4 == 0, "mirror rows are written 4 floats at a time");
    for (int q = tid; q < T::TM * (TNP / 4); q += T::kThreads) {
      const int c = q / (TNP / 4), r = (q % (TNP / 4)) * 4;
      const int row = m0 + c;
      if (row >= in.N) continue;
      const float v[4] = {mirror[r * kTS + c], mirror[(r + 1) * kTS + c],
                          mirror[(r + 2) * kTS + c], mirror[(r + 3) * kTS + c]};
      store_row<4>(out_b + (int64_t)row * in.M, n0 + pass * TNP + r, in.M, vec, v);
    }
  }
}

// Per-block partial sums of the parameter gradients, [B, G, 1 + Dc + Ds], in
// the order (amplitude, inv_c[0..Dc), inv_s[0..Ds)), G tiles per batch
// member. When w_out is not null (never in the symmetric mode) it also stores
// dL/d(r^2) per pair for the feature gradient.
//
// Each parameter's sum over the thread's pairs is reduced across the warp
// with shuffles as soon as it is formed (a fixed butterfly), and lane 0 keeps
// the warp's sum in shared memory, red[warp][slot]; after every kSlots slots
// one barrier lets thread p add up slot p over the warps, in order. So the
// per-parameter sums never sit in registers (which keeps the kernel at six
// blocks per SM) and the block synchronises once per kSlots parameters.
template <class T>
__global__ void __launch_bounds__(T::kThreads, T::kMinBlocks)
    matern52_bwd_params_kernel(Inputs in, const float* __restrict__ gk,
                               float* __restrict__ partials, float* __restrict__ w_out) {
  constexpr int kWarps = T::kThreads / 32;
  constexpr int kRed = kSlots + 1;
  constexpr int kTS = T::TM + 1;
  __shared__ __align__(16) float smem[T::kStage];
  __shared__ float gtile[T::TN * kTS];
  __shared__ float red[kWarps * kRed];
  float* sa = smem;
  float* sb = smem + kSlots * T::SA;
  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * kTX + tx;
  const int lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.y;
  int bi, bj;
  tile_coords<T>(in, bi, bj);
  const int n0 = bi * T::TN, m0 = bj * T::TM;
  const bool mirrored = in.symmetric && bi != bj;
  const float* gk_b = gk + (int64_t)b * in.N * in.M;

  // The incoming gradient of the tile, gk_ij, plus gk_ji in an off-diagonal
  // symmetric tile, into gtile[i * kTS + j]. Both reads are coalesced: the
  // direct one along j, the mirrored one along i (stride kTS in shared
  // memory, no bank conflicts). Each thread issues its loads in batches of
  // 8 before it stores them.
  {
    constexpr int kPer = T::TN * T::TM / T::kThreads, kBatch = kPer < 8 ? kPer : 8;
    static_assert(T::TN * T::TM % T::kThreads == 0 && kPer % kBatch == 0, "whole passes");
    for (int k0 = 0; k0 < kPer; k0 += kBatch) {
      float v[kBatch];
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const int idx = tid + (k0 + k) * T::kThreads, r = idx / T::TM, c = idx % T::TM;
        const int row = n0 + r, col = m0 + c;
        v[k] = (row < in.N && col < in.M) ? __ldg(gk_b + (int64_t)row * in.M + col) : 0.f;
      }
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const int idx = tid + (k0 + k) * T::kThreads;
        gtile[(idx / T::TM) * kTS + idx % T::TM] = v[k];
      }
    }
    if (mirrored) {
      __syncthreads();
      for (int k0 = 0; k0 < kPer; k0 += kBatch) {
        float v[kBatch];
#pragma unroll
        for (int k = 0; k < kBatch; ++k) {
          const int idx = tid + (k0 + k) * T::kThreads, c = idx / T::TN, r = idx % T::TN;
          const int row = m0 + c, col = n0 + r;
          v[k] = (row < in.M && col < in.N) ? __ldg(gk_b + (int64_t)row * in.M + col) : 0.f;
        }
#pragma unroll
        for (int k = 0; k < kBatch; ++k) {
          const int idx = tid + (k0 + k) * T::kThreads;
          gtile[(idx % T::TN) * kTS + idx / T::TN] += v[k];
        }
      }
    }
    __syncthreads();
  }

  const float amp = __ldg(in.amp + b);
  const bool vec = (in.M & 3) == 0;
  const int P = in.Dc + in.Ds;
  const int chunks = (P + kSlots - 1) / kSlots;
  float* out = partials + ((int64_t)b * gridDim.x + blockIdx.x) * (1 + P);
  const MemberRows rows = member_rows(in, b);
  const float* inv = in.inv_c + (int64_t)b * in.Dc;
  // Rows in kPasses passes, as in K1: fewer live registers. The per-block
  // sums add up over the passes in out, in a fixed order.
  for (int pass = 0; pass < T::kPasses; ++pass) {
    const int a_row = pass * T::TNP + ty * T::RNP;
    float w[T::RNP][T::RM];
    micro_tile_distances<T, T::RNP>(in, b, n0, m0, a_row, pass > 0, true, sa, sb, w);
    bool v1[T::RNP], v2[T::RM];
    micro_tile_valid<T, T::RNP>(in, b, n0, m0, a_row, v1, v2);
    float g_amp = 0.f;
#pragma unroll
    for (int i = 0; i < T::RNP; ++i) {
      const int row = n0 + a_row + i;
      const int col0 = m0 + tx * T::RM;
#pragma unroll
      for (int j = 0; j < T::RM; ++j) {
        float gij = gtile[(a_row + i) * kTS + tx * T::RM + j];
        gij = (v1[i] && v2[j]) ? gij : 0.f;
        const float s = w[i][j];
        const float r = sqrtf(fmaxf(s, 1e-20f));
        const float ex = expf(-kSqrt5 * r);
        g_amp += gij * 2.f * amp * (1.f + kSqrt5 * r + (5.f / 3.f) * s) * ex;
        w[i][j] = gij * amp * amp * (-5.f / 6.f) * (1.f + kSqrt5 * r) * ex;
      }
      if (w_out != nullptr && row < in.N) {
        store_row<T::RM>(w_out + ((int64_t)b * in.N + row) * in.M, col0, in.M, vec, w[i]);
      }
    }

    // Parameter gradients, kSlots feature slots per chunk.
    for (int chunk = 0; chunk < (chunks > 0 ? chunks : 1); ++chunk) {
      const int p0 = chunk * kSlots;
      const int width = min(kSlots, P - p0);
      __syncthreads();  // red (and the staged chunk) may still be read
      if (chunks > 1) {  // otherwise the one chunk is still staged
        stage_rows<T::TN, T::kThreads>(sa, rows.x1, rows.z1, n0, in.N, in.Dc, in.Ds, p0, width,
                                       tid);
        stage_rows<T::TM, T::kThreads>(sb, rows.x2, rows.z2, m0, in.M, in.Dc, in.Ds, p0, width,
                                       tid);
        cp_async_wait_all();
        __syncthreads();
      }
      const int ncont = max(0, min(width, in.Dc - p0));
      for (int slot = -1; slot < width; ++slot) {
        float acc = 0.f;
        if (slot < 0) {
          acc = chunk == 0 ? g_amp : 0.f;
        } else {
          float a[T::RNP], c[T::RM];
          load_vec<T::RNP>(a, sa + slot * T::SA + a_row);
          load_vec<T::RM>(c, sb + slot * T::SB + tx * T::RM);
          if (slot < ncont) {
#pragma unroll
            for (int i = 0; i < T::RNP; ++i) {
#pragma unroll
              for (int j = 0; j < T::RM; ++j) {
                const float t = a[i] - c[j];
                acc = fmaf(w[i][j], t * t, acc);
              }
            }
          } else {
#pragma unroll
            for (int i = 0; i < T::RNP; ++i) {
#pragma unroll
              for (int j = 0; j < T::RM; ++j) {
                if (__float_as_int(a[i]) != __float_as_int(c[j])) acc += w[i][j];
              }
            }
          }
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
        if (lane == 0) red[warp * kRed + slot + 1] = acc;
      }
      __syncthreads();
      if (tid <= width && (tid > 0 || chunk == 0)) {
        float total = 0.f;
#pragma unroll
        for (int k = 0; k < kWarps; ++k) total += red[k * kRed + tid];
        const int p = p0 + tid - 1;
        float* o = out + (tid == 0 ? 0 : 1 + p);
        if (pass > 0) total += *o;
        // d(r^2)/d inv_d = 2 inv_d (x1 - x2)_d^2, applied once to the sum.
        if (pass == T::kPasses - 1 && tid > 0 && p < in.Dc) total *= 2.f * __ldg(inv + p);
        *o = total;
      }
    }
  }
}

// Sum of v over the block, in a fixed order; the result is valid in thread 0.
__device__ float block_sum(float v, float* scratch) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  float total = 0.f;
  if (threadIdx.x == 0) {
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) total += scratch[w];
  }
  return total;
}

// out[b, p] = sum over g of partials[b, g, p], in a fixed order.
__global__ void matern52_bwd_reduce_kernel(const float* __restrict__ partials, int G, int P,
                                           float* __restrict__ out) {
  __shared__ float scratch[8];
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
// where bx runs over the groups when that side is batched (then b runs over
// group bx's members), and is a single slot summing over every b when the
// side is shared. w is zero on masked pairs. Serves the gradient of an
// acquisition with respect to its query points (side 0: LBFGSBOptimizer's
// restarts against the data rows) and input warping.
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
  const int slots = self_bstride != 0 ? in.B / in.group : 1;
  if (idx >= per_slot * slots) return;
  const int bx = (int)(idx / per_slot);
  const int j = (int)((idx % per_slot) / in.Dc);
  const int d = (int)(idx % in.Dc);
  const int b_lo = self_bstride != 0 ? bx * in.group : 0;
  const int b_hi = self_bstride != 0 ? b_lo + in.group : in.B;
  const int64_t total = (int64_t)in.N * in.M;
  float acc = 0.f;
  for (int b = b_lo; b < b_hi; ++b) {
    const int64_t g = b / in.group;
    const float inv = __ldg(in.inv_c + (int64_t)b * in.Dc + d);
    const float xj = __ldg(xs + g * self_bstride + (int64_t)j * in.Dc + d);
    const float* other = xo + g * other_bstride + d;
    float part = 0.f;
    for (int o = 0; o < other_count; ++o) {
      const int64_t e = side == 0 ? (int64_t)j * in.M + o : (int64_t)o * in.M + j;
      part = fmaf(__ldg(w + (int64_t)b * total + e), xj - __ldg(other + (int64_t)o * in.Dc), part);
    }
    acc += 2.f * inv * inv * part;
  }
  gx[idx] = acc;
}

enum class TileKind { kBig, kTiny };
constexpr int kTileKinds = 2;

// -1: the shape chooses the tile (choose_tile). Otherwise the TileKind that
// every non-symmetric launch takes: set by matern52_force_tile, which
// chip_smoke.py uses to check and time each tile at the main path's shapes.
int forced_tile = -1;

// Big tiles when they give the card at least one block per SM (132 SMs),
// and always for the symmetric Gram (which needs square tiles); tiny tiles
// below that. On the H100 big tiles were 2.5x faster at B=1, 1024 x 1024
// (256 big tiles) and 2.7x slower at B=1, 50 x 1024 (16).
TileKind choose_tile(int B, int N, int M, int symmetric) {
  if (symmetric) return TileKind::kBig;
  if (forced_tile >= 0) return static_cast<TileKind>(forced_tile);
  const int64_t big_tiles = (int64_t)B * ((N + BigTile::TN - 1) / BigTile::TN) *
                            ((M + BigTile::TM - 1) / BigTile::TM);
  return big_tiles >= 132 ? TileKind::kBig : TileKind::kTiny;
}

template <class T>
int64_t tiles_per_member(int N, int M, int symmetric) {
  const int64_t tn = (N + T::TN - 1) / T::TN, tm = (M + T::TM - 1) / T::TM;
  return symmetric ? tn * (tn + 1) / 2 : tn * tm;
}

// Calls f(Tile{}) with the tile shape chosen for these inputs.
template <class F>
auto with_tile(int B, int N, int M, int symmetric, F f) {
  switch (choose_tile(B, N, M, symmetric)) {
    case TileKind::kBig:
      return f(BigTile{});
    default:
      return f(TinyTile{});
  }
}

// Asks for the largest shared-memory carveout once per kernel, so that
// kMinBlocks blocks (26 KB of static shared memory each for K1, 35 KB for
// K2) fit on an SM.
template <class K>
void prefer_shared(K* kernel) {
  cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                       (int)cudaSharedmemCarveoutMaxShared);
}

template <class T>
void prefer_shared_once() {
  static const bool once = (prefer_shared(matern52_fwd_kernel<T>),
                            prefer_shared(matern52_bwd_params_kernel<T>), true);
  (void)once;
}

template <class T>
void launch_fwd(const Inputs& in, float* out, cudaStream_t s) {
  prefer_shared_once<T>();
  const dim3 grid((unsigned)tiles_per_member<T>(in.N, in.M, in.symmetric), in.B);
  matern52_fwd_kernel<T><<<grid, dim3(kTX, T::TY), 0, s>>>(in, out);
}

template <class T>
void launch_bwd_params(const Inputs& in, const float* gk, float* partials, float* w,
                       cudaStream_t s) {
  prefer_shared_once<T>();
  const dim3 grid((unsigned)tiles_per_member<T>(in.N, in.M, in.symmetric), in.B);
  matern52_bwd_params_kernel<T><<<grid, dim3(kTX, T::TY), 0, s>>>(in, gk, partials, w);
}

}  // namespace

extern "C" {

// Number of partial-sum blocks per batch member that the parameter backward
// uses; the caller sizes the partials buffer [B, G, 1 + Dc + Ds] with it.
int matern52_bwd_num_blocks(int B, int N, int M, int symmetric) {
  return (int)with_tile(B, N, M, symmetric,
                        [&](auto t) { return tiles_per_member<decltype(t)>(N, M, symmetric); });
}

// Makes every non-symmetric launch take tile `kind` (0 big, 1 tiny),
// or with -1 lets the shape choose again. For measurement: it changes which
// kernels run, never what they compute. Returns cudaErrorInvalidValue for
// another kind.
int matern52_force_tile(int kind) {
  if (kind < -1 || kind >= kTileKinds) return (int)cudaErrorInvalidValue;
  forced_tile = kind;
  return (int)cudaSuccess;
}

// Resident blocks per SM of K1 (kernel 0) or K2's parameter kernel
// (kernel 1) at the tile shape these inputs get, and that shape's outputs
// per block edge (tn, tm) and threads: the occupancy report.
int matern52_occupancy(int kernel, int B, int N, int M, int symmetric, int* tn, int* tm,
                       int* threads) {
  int blocks = 0;
  const cudaError_t err = with_tile(B, N, M, symmetric, [&](auto t) {
    using T = decltype(t);
    prefer_shared_once<T>();
    *tn = T::TN;
    *tm = T::TM;
    *threads = T::kThreads;
    return kernel == 0 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                             &blocks, matern52_fwd_kernel<T>, T::kThreads, 0)
                       : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                             &blocks, matern52_bwd_params_kernel<T>, T::kThreads, 0);
  });
  return err == cudaSuccess ? blocks : -(int)err;
}

// out: [B, N, M]. mask1 [N] / mask2 [M] (bool, null for all valid) zero the
// pairs with a padded row; diag [B] (null for none) is added on the valid
// diagonal and the padded diagonal is 1. Each batched input has one block
// per group of `group` members at its stride (0: shared). symmetric:
// x2 == x1, z2 == z1, mask2 == mask1, N == M, the same batching.
int matern52_ard_fwd(const float* x1, const int32_t* z1, const float* x2, const int32_t* z2,
                     const float* amp, const float* inv_c, const float* inv_s,
                     const uint8_t* mask1, const uint8_t* mask2, const float* diag,
                     int64_t x1_bstride, int64_t x2_bstride, int64_t z1_bstride,
                     int64_t z2_bstride, int64_t m1_bstride, int64_t m2_bstride, int group, int B,
                     int N, int M, int Dc, int Ds, int symmetric, float* out, void* stream) {
  if (group < 1 || B % group != 0) return (int)cudaErrorInvalidValue;
  const Inputs in{x1, z1, x2, z2, amp, inv_c, inv_s, mask1, mask2, diag,
                  x1_bstride, x2_bstride, z1_bstride, z2_bstride, m1_bstride, m2_bstride,
                  group, B, N, M, Dc, Ds, symmetric};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  with_tile(B, N, M, symmetric, [&](auto t) { launch_fwd<decltype(t)>(in, out, s); });
  return (int)cudaGetLastError();
}

// grads: [B, 1 + Dc + Ds]; partials: [B, G, 1 + Dc + Ds] scratch with
// G = matern52_bwd_num_blocks(B, N, M, symmetric). w: [B, N, M] scratch,
// needed (not null) only when gx1 or gx2 is requested, and then symmetric
// must be 0; gx1: [N, Dc] or [B / group, N, Dc] as x1 is shared or batched
// (null to skip), gx2 likewise. Inputs, strides and masks as in the forward;
// the diagonal's own gradient is the caller's (a sum of gk's valid
// diagonal).
int matern52_ard_bwd(const float* gk, const float* x1, const int32_t* z1, const float* x2,
                     const int32_t* z2, const float* amp, const float* inv_c, const float* inv_s,
                     const uint8_t* mask1, const uint8_t* mask2, int64_t x1_bstride,
                     int64_t x2_bstride, int64_t z1_bstride, int64_t z2_bstride,
                     int64_t m1_bstride, int64_t m2_bstride, int group, int B, int N, int M,
                     int Dc, int Ds, int symmetric, float* grads, float* partials, float* w,
                     float* gx1, float* gx2, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (symmetric && w != nullptr) return (int)cudaErrorInvalidValue;
  if (group < 1 || B % group != 0) return (int)cudaErrorInvalidValue;
  const Inputs in{x1, z1, x2, z2, amp, inv_c, inv_s, mask1, mask2, nullptr,
                  x1_bstride, x2_bstride, z1_bstride, z2_bstride, m1_bstride, m2_bstride,
                  group, B, N, M, Dc, Ds, symmetric};
  const int G = matern52_bwd_num_blocks(B, N, M, symmetric);
  const int P = 1 + Dc + Ds;
  if (G > 0) {
    with_tile(B, N, M, symmetric,
              [&](auto t) { launch_bwd_params<decltype(t)>(in, gk, partials, w, s); });
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  matern52_bwd_reduce_kernel<<<dim3(P, B), 256, 0, s>>>(partials, G, P, grads);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  float* gx[2] = {gx1, gx2};
  for (int side = 0; side < 2; ++side) {
    if (gx[side] == nullptr || Dc == 0) continue;
    const int64_t stride = side == 0 ? x1_bstride : x2_bstride;
    const int64_t count = (int64_t)(side == 0 ? N : M) * Dc * (stride != 0 ? B / group : 1);
    const int blocks = (int)((count + 255) / 256);
    if (blocks == 0) continue;
    matern52_bwd_features_kernel<<<blocks, 256, 0, s>>>(in, w, side, gx[side]);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

}  // extern "C"
