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
// Design: one block of 8 warps per 64-query tile, one block per SM.  The
// head is four passes of a (64 x 256) output: fc_0 in its two 256-column
// halves (W1[:, 0:256] and W1[:, 256:512], ktot rows each), fc_1 (W2,
// 512 x 256) and fc_2 (W3, 256 x 256).  The B operands of all four passes
// stream, in that order, through one ring of S slices of KS weight rows x
// 256 columns in shared memory (row stride 264: conflict-free ldmatrix).
// All 256 threads fill a slice with 16-byte cp.async.cg (a warp copies one
// 512-byte row per instruction), one commit group per slice; a slice is
// read after cp.async.wait_group(S - 2) and one __syncthreads(), which also
// frees the slot that the next fill overwrites, so S - 1 slices are in
// flight while one is multiplied, across the pass boundaries too.  So each
// weight byte crosses from L2 into the SM once per tile (1.25 MB a tile at
// ktot = 832), where the earlier head let each of four warps load its own
// W fragments from L2 (4x the traffic, no prefetch).
//
// Each warp computes a 32 x 64 block of a pass (warps 2 rows x 4 columns)
// with mma.sync.m16n8k16 bf16 -> f32 from ldmatrix fragments: A from the
// staged tile (fc_0), h1 (fc_1) or h2 (fc_2) in shared memory, B from the
// ring (ldmatrix.trans).  The epilogues run on the accumulator registers:
// fc_0 adds percep, coarse, xyz . W1_xyz and b1 straight from the
// accumulator layout, and every ReLU output is recast to bf16 into shared
// memory for the next pass.
//
// Shared memory at ktot = 832 (K1): staged tile 64 x 840 bf16 (107,520 B,
// reused for h2) + h1 64 x 520 (66,560 B, reused for h3) + the ring,
// KS x S = 32 x 3 (50,688 B): 224,768 of the 232,448 B a block may have;
// at ktot = 800 (K4) 220,672 B.
//
// Measured on NVIDIA H100 80GB HBM3, 700.00 W (chip_smoke.py's kernel
// phase, CUDA-event medians): K1 at n = 2,097,152 17.41-18.01 ms a launch
// against 67.89-68.43 ms for the earlier head and 31.4-31.6 ms for the
// unfused bf16 matmul chain; K4 at n = 1,048,576 19.74-20.19 ms (earlier
// head 40.19-40.50, chain 20.04-20.28).  With KS and S changed below, K1
// by ring shape KS x S: 16x2 24.89, 16x4 20.67, 16x6 20.09, 32x2 18.79,
// 32x3 17.86 ms: depth pays up to about two slices in flight, and at equal
// bytes in flight 32-row slices beat 16-row ones (half the barriers).
// 32 x 3 is the deepest 32-row ring that fits.  What still bounds it: the
// weights still cross L2 -> SM once per
// 64 queries (about 41 GB a 128^3 grid, about 2.3 TB/s at 17.9 ms, the same
// rate the earlier head reached with 4x the bytes), the per-slice barrier,
// and the per-tile staging and percep/coarse loads, which nothing overlaps
// (one block per SM, no persistent grid); mma.sync issues at a fraction of
// wgmma's rate.  Halving the weight bytes per query needs 128-row tiles
// (wgmma, two consumer warpgroups) or TMA multicast across a cluster: the
// next step, with a persistent grid.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace fused_head {

constexpr int TM = 64;   // queries per block
constexpr int NT = 256;  // threads per block
constexpr int NW = NT / 32;
constexpr int D1 = 512, D2 = 256, D3 = 256;
constexpr int LD1 = D1 + 8, LD2 = D2 + 8, LD3 = D3 + 8;  // padded smem rows
constexpr int NC = 256;       // output columns of one pass
constexpr int LDR = NC + 8;   // ring row stride
constexpr int KS = 32;        // weight rows a ring slice
constexpr int S = 3;          // ring slices
constexpr long long MAX_SMEM = 232448;
static_assert(KS % 16 == 0 && KS % NW == 0 && D2 % KS == 0 && D3 % KS == 0,
              "a ring slice is a multiple of 16 rows, 8 warps and W2/W3");
static_assert(S >= 2, "the ring needs a slice in flight beside the one read");

typedef __nv_bfloat16 bf16;

// Shared memory a block needs for a staged width of ktot columns: the
// staged tile (reused for h2), h1 (reused for h3) and the weight ring.
inline long long smem_bytes(int ktot) {
  const int lda = ktot + 8;
  return (long long)TM * (lda > LD2 ? lda : LD2) * 2 +
         (long long)TM * LD1 * 2 + (long long)S * KS * LDR * 2;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zero-filled past src_bytes (0 or 16).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8x8 bf16 matrices from shared memory; lane l gives the address of
// row (l & 7) of matrix (l >> 3).
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += a (16x16, row) . b (16x8, col), bf16 operands, f32 sums.
__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The weight slices of one tile, in stream order: W1[:, 0:256] and
// W1[:, 256:512] (ktot rows each, n1 slices each, the last one short when
// KS does not divide ktot), W2 (512 rows), W3 (256 rows).
struct Stream {
  const bf16* w1;
  const bf16* w2;
  const bf16* w3;
  int ktot, n1, total;
};

// Fill ring slot j % S with slice j (nothing past the stream's end) and
// commit one group, empty or not, so that groups and slices stay in step.
__device__ __forceinline__ void issue_slice(bf16* ring, const Stream& st,
                                            int j) {
  if (j < st.total) {
    const bf16* src;
    int ld, r0, rows;
    if (j < 2 * st.n1) {
      const int h = j >= st.n1;
      src = st.w1 + h * NC;
      ld = D1;
      r0 = (j - h * st.n1) * KS;
      rows = st.ktot;
    } else if (j < 2 * st.n1 + D1 / KS) {
      src = st.w2;
      ld = D2;
      r0 = (j - 2 * st.n1) * KS;
      rows = D1;
    } else {
      src = st.w3;
      ld = D3;
      r0 = (j - 2 * st.n1 - D1 / KS) * KS;
      rows = D2;
    }
    bf16* dst = ring + (j % S) * KS * LDR;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
    for (int i = 0; i < KS / NW; ++i) {
      const int r = warp + i * NW;
      if (r0 + r < rows)
        cp_async16(dst + r * LDR + lane * 8,
                   src + (size_t)(r0 + r) * ld + lane * 8, 16);
    }
  }
  cp_async_commit();
}

// One pass: the block's (64 x K) A in shared memory (row stride lda) times
// the next ceil(K / KS) ring slices -> each warp's 32 x 64 accumulator
// block, acc[mi][nj] the m16n8 tile at rows wr*32 + mi*16, columns
// wc*64 + nj*8.  it counts the slices of the stream consumed so far.
__device__ __forceinline__ void ring_pass(float (&acc)[2][8][4],
                                          const bf16* a, int lda, int K,
                                          bf16* ring, const Stream& st,
                                          int& it) {
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nj = 0; nj < 8; ++nj)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][nj][e] = 0.f;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wr = warp >> 2, wc = warp & 3;
  // ldmatrix addresses: rows (lane & 15), column block (lane >> 4) * 8
  const bf16* a_lane = a + (wr * 32 + (lane & 15)) * lda + (lane >> 4) * 8;
  const int b_lane = (lane & 15) * LDR + wc * 64 + (lane >> 4) * 8;
  for (int k0 = 0; k0 < K; k0 += KS, ++it) {
    cp_async_wait<S - 2>();  // this thread's copies of slice it are in
    __syncthreads();         // everyone's are, and slot it - 1 is free
    issue_slice(ring, st, it + S - 1);
    const bf16* b = ring + (it % S) * KS * LDR + b_lane;
    const int kn = K - k0;
#pragma unroll
    for (int kk = 0; kk < KS; kk += 16) {
      if (kk < kn) {
        uint32_t fa[2][4], fb[4][4];
        ldsm_x4(fa[0], a_lane + k0 + kk);
        ldsm_x4(fa[1], a_lane + 16 * lda + k0 + kk);
#pragma unroll
        for (int q = 0; q < 4; ++q) ldsm_x4_t(fb[q], b + kk * LDR + q * 16);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            mma_bf16(acc[mi][2 * q], fa[mi], fb[q][0], fb[q][1]);
            mma_bf16(acc[mi][2 * q + 1], fa[mi], fb[q][2], fb[q][3]);
          }
      }
    }
  }
}

// relu(acc + bias) -> bf16 into dst (row stride ld) at the accumulator
// layout's rows and columns col0 + wc*64 + nj*8 + 2*tig.
__device__ __forceinline__ void relu_store(const float (&acc)[2][8][4],
                                           const float* __restrict__ bias,
                                           bf16* dst, int ld) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wr = warp >> 2, wc = warp & 3, g = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int nj = 0; nj < 8; ++nj) {
    const int col = wc * 64 + nj * 8 + tig * 2;
    const float2 bb = *reinterpret_cast<const float2*>(bias + col);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float* c = &acc[i >> 1][nj][(i & 1) * 2];
      *reinterpret_cast<__nv_bfloat162*>(dst + (wr * 32 + i * 8 + g) * ld +
                                         col) =
          __floats2bfloat162_rn(fmaxf(c[0] + bb.x, 0.f),
                                fmaxf(c[1] + bb.y, 0.f));
    }
  }
}

// The head over a staged tile: smem holds the (TM x ktot) bf16 operand of
// the block's queries row0 .. row0 + TM - 1 at row stride ktot + 8, written
// by the caller with plain stores or with cp.async groups committed before
// the call; the head's first barrier publishes both.  COARSE: 0 no coarse
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
  bf16* ring = h1_s + TM * LD1;

  Stream st{w1, w2, w3, ktot, (ktot + KS - 1) / KS, 0};
  st.total = 2 * st.n1 + (D1 + D2) / KS;
#pragma unroll
  for (int j = 0; j < S - 1; ++j) issue_slice(ring, st, j);
  int it = 0;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wr = warp >> 2, wc = warp & 3, g = lane >> 2, tig = lane & 3;
  // the thread's four accumulator rows: wr*32 + i*8 + g
  float q[4][3];
  bool valid[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int grow = row0 + wr * 32 + i * 8 + g;
    valid[i] = grow < n;
#pragma unroll
    for (int d = 0; d < 3; ++d)
      q[i][d] = valid[i] ? qxyz[(size_t)grow * qstride + d] : 0.f;
  }
  float acc[2][8][4];

  // ---- fc_0 + percep + coarse + xyz + b1, ReLU -> h1 (two halves) ----
  for (int half = 0; half < 2; ++half) {
    ring_pass(acc, a_s, lda, ktot, ring, st, it);
#pragma unroll
    for (int nj = 0; nj < 8; ++nj) {
      const int col = half * NC + wc * 64 + nj * 8 + tig * 2;
      const float2 bb = *reinterpret_cast<const float2*>(b1 + col);
      const float2 x0 = *reinterpret_cast<const float2*>(w1xyz + col);
      const float2 x1 = *reinterpret_cast<const float2*>(w1xyz + D1 + col);
      const float2 x2 =
          *reinterpret_cast<const float2*>(w1xyz + 2 * D1 + col);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int lrow = wr * 32 + i * 8 + g;
        float v0 = acc[i >> 1][nj][(i & 1) * 2];
        float v1 = acc[i >> 1][nj][(i & 1) * 2 + 1];
        if (valid[i]) {
          const size_t base = (size_t)(row0 + lrow) * D1 + col;
          const float2 p = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(percep + base));
          v0 += p.x;
          v1 += p.y;
          if (COARSE == 1) {
            const float2 c = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(
                    static_cast<const bf16*>(coarse) + base));
            v0 += c.x;
            v1 += c.y;
          } else if (COARSE == 2) {
            const float2 c = *reinterpret_cast<const float2*>(
                static_cast<const float*>(coarse) + base);
            v0 += c.x;
            v1 += c.y;
          }
          v0 += q[i][0] * x0.x + q[i][1] * x1.x + q[i][2] * x2.x + bb.x;
          v1 += q[i][0] * x0.y + q[i][1] * x1.y + q[i][2] * x2.y + bb.y;
        }
        *reinterpret_cast<__nv_bfloat162*>(h1_s + lrow * LD1 + col) =
            __floats2bfloat162_rn(fmaxf(v0, 0.f), fmaxf(v1, 0.f));
      }
    }
  }
  // (the next pass's first barrier publishes each epilogue's stores)

  // ---- fc_1: h2 = relu(h1 @ W2 + b2) -> bf16 ----
  ring_pass(acc, h1_s, LD1, D1, ring, st, it);
  relu_store(acc, b2, h2_s, LD2);

  // ---- fc_2: h3 = relu(h2 @ W3 + b3) -> bf16 ----
  ring_pass(acc, h2_s, LD2, D2, ring, st, it);
  relu_store(acc, b3, h3_s, LD3);
  __syncthreads();

  // ---- fc_out: four threads per query row, f32 dot of 64 columns each ----
  {
    const int r = threadIdx.x >> 2, qd = threadIdx.x & 3;
    const bf16* hr = h3_s + r * LD3 + qd * (D3 / 4);
    const bf16* wr4 = w4 + qd * (D3 / 4);
    float s = 0.f;
#pragma unroll 8
    for (int c = 0; c < D3 / 4; ++c)
      s = fmaf(__bfloat162float(hr[c]), __bfloat162float(wr4[c]), s);
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    const int row = row0 + r;
    if (qd == 0 && row < n) out[row] = s + b4[0];
  }
}

}  // namespace fused_head
