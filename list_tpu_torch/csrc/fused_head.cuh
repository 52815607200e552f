// Device code shared by the two fused SDF-decoder head kernels,
// fused_stack_head.cu (K1) and fused_fc0_mlp.cu (K4).  Both stage a tile of
// 64 queries' fc_0 operand into shared memory as one zero-padded
// (64 x ktot) bf16 block whose columns match the rows of a zero-padded
// (ktot x 512) W1; head_from_staged then computes, per query,
//   fc0 = staged @ W1 + percep [+ coarse] + xyz . W1_xyz + b1
//   h1 = relu(fc0) -> bf16;  h2 = relu(h1 @ W2 + b2) -> bf16
//   h3 = relu(h2 @ W3 + b3) -> bf16;  out = h3 @ w4 + b4   (f32)
// with bf16 operands and f32 accumulation, writing no activation to device
// memory.
//
// One block of 8 warps per 64-query tile.  The (64 x 512) f32 fc0
// accumulator does not fit registers at once, so it is computed in two
// 256-column halves (64 f32 registers a thread), each folded through the
// epilogue into a bf16 h1 tile in shared memory; fc_1 and fc_2 read their A
// operand from shared memory and their B fragments (W1/W2/W3, L2-resident)
// straight from global memory.  Tensor cores via WMMA bf16 16x16x16 with
// f32 accumulation.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace fused_head {

using namespace nvcuda;

constexpr int TM = 64;   // queries per block
constexpr int NT = 256;  // threads per block
constexpr int NW = NT / 32;
constexpr int D1 = 512, D2 = 256, D3 = 256;
constexpr int LD1 = D1 + 8, LD2 = D2 + 8, LD3 = D3 + 8;  // padded smem rows
constexpr long long MAX_SMEM = 232448;

typedef __nv_bfloat16 bf16;
typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>
    FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>
    FragB;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

// Shared memory a block needs for a staged width of ktot columns: the
// staged tile (reused for h2), h1 (reused for h3), and a 16x16 f32 scratch
// tile per warp.
inline long long smem_bytes(int ktot) {
  const int lda = ktot + 8;
  return (long long)TM * (lda > LD2 ? lda : LD2) * 2 +
         (long long)TM * LD1 * 2 + (long long)NW * 256 * 4;
}

// One warp: a 16-row strip of A (shared memory, lda) times 128 columns of
// B (global, ldb) over depth K -> 8 accumulator tiles.
__device__ __forceinline__ void warp_gemm(FragC (&acc)[8], const bf16* a,
                                          int lda, const bf16* b, int ldb,
                                          int K) {
#pragma unroll
  for (int j = 0; j < 8; ++j) wmma::fill_fragment(acc[j], 0.f);
  for (int k = 0; k < K; k += 16) {
    FragA fa;
    wmma::load_matrix_sync(fa, a + k, lda);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      FragB fb;
      wmma::load_matrix_sync(fb, b + (size_t)k * ldb + j * 16, ldb);
      wmma::mma_sync(acc[j], fa, fb, acc[j]);
    }
  }
}

__device__ __forceinline__ void unpack8(const uint4& u, float* v) {
  const bf16* p = reinterpret_cast<const bf16*>(&u);
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = __bfloat162float(p[i]);
}

// The head over a staged tile: smem holds the (TM x ktot) bf16 operand of
// the block's queries row0 .. row0 + TM - 1 at row stride ktot + 8, staged
// and followed by __syncthreads() by the caller.  COARSE: 0 no coarse
// term, 1 bf16 (n, 512), 2 f32 (n, 512).
template <int COARSE>
__device__ __forceinline__ void head_from_staged(
    unsigned char* smem, int ktot, int row0, int n, const void* coarse,
    const bf16* __restrict__ percep, const float* __restrict__ qxyz,
    int qstride, const bf16* __restrict__ w1,
    const float* __restrict__ w1xyz, const float* __restrict__ b1,
    const bf16* __restrict__ w2, const float* __restrict__ b2,
    const bf16* __restrict__ w3, const float* __restrict__ b3,
    const bf16* __restrict__ w4, const float* __restrict__ b4,
    float* __restrict__ out) {
  const int lda = ktot + 8;
  const int reg0 = TM * (lda > LD2 ? lda : LD2);
  bf16* a_s = reinterpret_cast<bf16*>(smem);  // staged operand
  bf16* h2_s = a_s;                           // reuses the staged region
  bf16* h1_s = a_s + reg0;
  bf16* h3_s = h1_s;                          // reuses the h1 region
  float* scratch = reinterpret_cast<float*>(h1_s + TM * LD1);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rt = warp & 3;   // 16-row strip of the tile
  const int cg = warp >> 2;  // 128-column group
  float* scr = scratch + warp * 256;
  // epilogue: lane owns 8 consecutive columns of one row of a 16x16 tile
  const int er = lane >> 1, ec = (lane & 1) * 8;
  const int lrow = rt * 16 + er;
  const int grow = row0 + lrow;
  const bool valid = grow < n;
  float q0 = 0.f, q1 = 0.f, q2 = 0.f;
  if (valid) {
    q0 = qxyz[(size_t)grow * qstride];
    q1 = qxyz[(size_t)grow * qstride + 1];
    q2 = qxyz[(size_t)grow * qstride + 2];
  }
  FragC acc[8];
  float v[8];

  // ---- fc_0 + percep + coarse + xyz + b1, ReLU -> h1 (two halves) ----
  for (int half = 0; half < 2; ++half) {
    const int colbase = half * 256 + cg * 128;
    warp_gemm(acc, a_s + rt * 16 * lda, lda, w1 + colbase, D1, ktot);
    for (int j = 0; j < 8; ++j) {
      wmma::store_matrix_sync(scr, acc[j], 16, wmma::mem_row_major);
      __syncwarp();
      const int col = colbase + j * 16 + ec;
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = scr[er * 16 + ec + i];
      if (valid) {
        const size_t base = (size_t)grow * D1 + col;
        float t[8];
        unpack8(*reinterpret_cast<const uint4*>(percep + base), t);
#pragma unroll
        for (int i = 0; i < 8; ++i) v[i] += t[i];
        if (COARSE == 1) {
          unpack8(*reinterpret_cast<const uint4*>(
                      static_cast<const bf16*>(coarse) + base), t);
#pragma unroll
          for (int i = 0; i < 8; ++i) v[i] += t[i];
        } else if (COARSE == 2) {
          const float4* cf = reinterpret_cast<const float4*>(
              static_cast<const float*>(coarse) + base);
          const float4 c0 = cf[0], c1 = cf[1];
          v[0] += c0.x; v[1] += c0.y; v[2] += c0.z; v[3] += c0.w;
          v[4] += c1.x; v[5] += c1.y; v[6] += c1.z; v[7] += c1.w;
        }
#pragma unroll
        for (int i = 0; i < 8; ++i)
          v[i] += q0 * w1xyz[col + i] + q1 * w1xyz[D1 + col + i] +
                  q2 * w1xyz[2 * D1 + col + i] + b1[col + i];
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
        h1_s[lrow * LD1 + col + i] = __float2bfloat16(fmaxf(v[i], 0.f));
      __syncwarp();
    }
  }
  __syncthreads();

  // ---- fc_1: h2 = relu(h1 @ W2 + b2) -> bf16 ----
  warp_gemm(acc, h1_s + rt * 16 * LD1, LD1, w2 + cg * 128, D2, D1);
  for (int j = 0; j < 8; ++j) {
    wmma::store_matrix_sync(scr, acc[j], 16, wmma::mem_row_major);
    __syncwarp();
    const int col = cg * 128 + j * 16 + ec;
#pragma unroll
    for (int i = 0; i < 8; ++i)
      h2_s[lrow * LD2 + col + i] = __float2bfloat16(
          fmaxf(scr[er * 16 + ec + i] + b2[col + i], 0.f));
    __syncwarp();
  }
  __syncthreads();

  // ---- fc_2: h3 = relu(h2 @ W3 + b3) -> bf16 ----
  warp_gemm(acc, h2_s + rt * 16 * LD2, LD2, w3 + cg * 128, D3, D2);
  for (int j = 0; j < 8; ++j) {
    wmma::store_matrix_sync(scr, acc[j], 16, wmma::mem_row_major);
    __syncwarp();
    const int col = cg * 128 + j * 16 + ec;
#pragma unroll
    for (int i = 0; i < 8; ++i)
      h3_s[lrow * LD3 + col + i] = __float2bfloat16(
          fmaxf(scr[er * 16 + ec + i] + b3[col + i], 0.f));
    __syncwarp();
  }
  __syncthreads();

  // ---- fc_out: four threads per query row, f32 dot of 64 columns each ----
  {
    const int r = threadIdx.x >> 2, qd = threadIdx.x & 3;
    const bf16* hr = h3_s + r * LD3 + qd * (D3 / 4);
    const bf16* wr = w4 + qd * (D3 / 4);
    float s = 0.f;
#pragma unroll 8
    for (int c = 0; c < D3 / 4; ++c)
      s = fmaf(__bfloat162float(hr[c]), __bfloat162float(wr[c]), s);
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    const int row = row0 + r;
    if (qd == 0 && row < n) out[row] = s + b4[0];
  }
}

}  // namespace fused_head
