// K4: fused SDF-decoder head over the per-scale t-major tap stacks (the
// dense-grid decode's --use_pallas 1 head).
//
// Replaces the TPU kernel fused_fc0_mlp of list_tpu/ops/pallas/fused_fc0.py
// (body _kernel): per tile of queries,
//   fc0 = percep + sum_s sum_t stack_s[t] @ W1_s[t] + xyz . W1_xyz + b1
//   h1 = relu(fc0) -> bf16;  h2 = relu(h1 @ W2 + b2) -> bf16
//   h3 = relu(h2 @ W3 + b3) -> bf16;  out = h3 @ w4 + b4   (f32)
// where stack_s is the (7, n, C_s) bf16 einsum output of scale s (the seven
// displacement taps, t-major), W1_s its (7 * C_s, 512) fc_0 rows in
// (disp, channel) order, and percep already carries the coarse-projected
// term.  bf16 operands, f32 accumulation, no activation in device memory.
//
// Bound on an H100 at the production shape (n = 1,048,576 queries per
// launch, two launches per 128^3 mesh, channels (1, 16, 32, 64), so
// sum 7 * C_s = 791, d1 = 512, d2 = d3 = 256): 601,856 MACs a query,
// 1.262 TFLOP against 989 TFLOP/s of bf16 tensor cores (1.276 ms), and
// about 2,622 B a query of input (about 0.82 ms at 3.35 TB/s): bound by
// tensor-core operations.
//
// Design: one block of 8 warps per 64-query tile stages each scale's
// seven taps as one zero-padded (64 x roundup16(7 * C_s)) bf16 block of
// columns (t, c), i.e. widths 16, 112, 224 and 448 at column offsets 0, 16,
// 128 and 352 -- an 800-column tile -- so the 28 per-tap partial products
// of the TPU kernel become one tensor-core product against the wrapper's
// concatenated, zero-padded W1 rows.  For C_s = 1 the TPU kernel uses seven
// f32 broadcast FMAs; a bf16 x bf16 product is exact in f32, so the tensor
// cores compute the same terms, only summed in another order.
//
// Staging: the host picks one path per scale, and the kernel divides no
// index (shifts and masks only).
//  - ROWS (C_s % 8 == 0 with C_s / 8 a power of two, 16-byte aligned base:
//    C = 16, 32, 64, 784 of the 791 columns): tap t of a row is C_s
//    contiguous bf16, so thread i of the flat (t, row, 16-byte chunk) index
//    issues one 16-byte cp.async.cg, zero-filled past n; a warp copies 512
//    contiguous bytes an instruction at C = 64.  All of them are one commit
//    group, issued before the head's first weight slices, so the head's
//    first cp.async.wait_group(S - 2) and barrier cover it and the copies
//    run under the ring's first fills (as in K1).
//  - TAPS (C_s = 1, n % 8 == 0, aligned base): tap t of the tile is 64
//    contiguous bf16 at src + t * n + row0; 56 threads load 16 bytes each
//    and write their 8 rows down column t, 64 others zero columns 7..15 (the
//    W1 rows there are zero, but NaN x 0 is NaN).
//  - SCALAR (anything else: odd channels, an unaligned base, n % 8 != 0 at
//    C = 1): thread (row, g) loads channels g, g + 4, ... of each tap 2
//    bytes at a time, 32 rows a warp in flight.
// The plain stores of TAPS and SCALAR are published by the head's first
// barrier too, so no barrier stands between the staging and the head.
//
// The head over the staged tile is fused_head.cuh's, shared with K1:
// mma.sync from shared memory, the weights streamed once per tile through a
// cp.async ring (its header gives the ring and the budget).  Shared memory
// at the production shape: 220,672 B, one block per SM.
//
// Measured on NVIDIA H100 80GB HBM3, 700.00 W (tools/torch_k4_probe.py:
// CUDA-event medians at chip_smoke.py's production inputs, this source
// against the earlier one-bf16-at-a-time staging in the same process, in
// turns): 8.11-8.14 ms a launch against 19.31-19.47 ms, outputs
// bit-identical.  Built without the head, the staging alone takes
// 0.568-0.571 ms (earlier: 11.89-11.96); built without the staging, the
// head alone 7.26-7.38 ms.  So the head now sets K4's time, as it sets
// K1's (fused_head.cuh says what bounds it).  The staging still adds
// about 0.8 ms a launch: one block per SM and no persistent grid, so a
// tile's stacks (100 KB from device memory) are fetched while nothing
// else of that SM is in flight but the ring's first two slices.
#include "fused_head.cuh"

using namespace fused_head;

namespace {

constexpr int MAX_SCALES = 8;
constexpr int TM_SHIFT = 6;  // log2(TM)
static_assert(1 << TM_SHIFT == TM && TM == 64 && NT == 4 * TM,
              "TAPS stages 8 chunks a tap, SCALAR 4 channel groups");
constexpr int TAPS_CHUNKS = 7 * TM / 8;  // 16-byte chunks of a C = 1 tile

// a scale's staging path, chosen on the host
enum Path { SCALAR = 0, ROWS = 1, TAPS = 2 };

struct Stacks {
  const bf16* ptr[MAX_SCALES];  // (7, n, C_s) t-major
  int c[MAX_SCALES];            // channels C_s
  int kpad[MAX_SCALES];         // 7 * C_s rounded up to 16
  int off[MAX_SCALES];          // first column of scale s in the tile
  int path[MAX_SCALES];         // Path
  int shift[MAX_SCALES];        // ROWS: log2(C_s / 8)
  int count;
};

__global__ void __launch_bounds__(NT, 1)
fused_fc0_mlp_kernel(Stacks st, int ktot, int n,
                     const bf16* __restrict__ percep,
                     const float* __restrict__ qxyz, int qstride,
                     const bf16* __restrict__ w1,
                     const float* __restrict__ w1xyz,
                     const float* __restrict__ b1,
                     const bf16* __restrict__ w2,
                     const float* __restrict__ b2,
                     const bf16* __restrict__ w3,
                     const float* __restrict__ b3,
                     const bf16* __restrict__ w4,
                     const float* __restrict__ b4,
                     float* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int lda = ktot + 8;
  bf16* a_s = reinterpret_cast<bf16*>(smem);
  const int row0 = blockIdx.x * TM;
  const int tid = threadIdx.x;
  const bf16 zero = __float2bfloat16(0.f);

  // ROWS: 16-byte cp.async of each (t, row, chunk), one commit group
  for (int s = 0; s < st.count; ++s) {
    if (st.path[s] != ROWS) continue;
    const int C = st.c[s], sh = st.shift[s], off = st.off[s];
    const bf16* src = st.ptr[s] + (size_t)row0 * C;
    const int total = (7 * TM) << sh;
    for (int i = tid; i < total; i += NT) {
      const int ch = i & ((1 << sh) - 1), r = (i >> sh) & (TM - 1);
      const int t = i >> (sh + TM_SHIFT);
      const bool in = row0 + r < n;
      cp_async16(a_s + r * lda + off + t * C + ch * 8,
                 in ? src + ((size_t)t * n + r) * C + ch * 8 : st.ptr[s],
                 in ? 16 : 0);
    }
    if (st.kpad[s] > 7 * C && tid < TM)  // 7 * C % 16 == 8: a zero chunk
      cp_async16(a_s + tid * lda + off + 7 * C, st.ptr[s], 0);
  }
  cp_async_commit();

  // TAPS: 16-byte loads of a C = 1 tap's 8 rows, written down column t
  for (int s = 0; s < st.count; ++s) {
    if (st.path[s] != TAPS) continue;
    bf16* dst = a_s + st.off[s];
    if (tid < TAPS_CHUNKS) {
      const int t = tid >> 3, r0 = (tid & 7) * 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (row0 + r0 < n)
        v = __ldg(reinterpret_cast<const uint4*>(st.ptr[s] + (size_t)t * n +
                                                 row0 + r0));
      const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
      for (int k = 0; k < 8; ++k) dst[(r0 + k) * lda + t] = e[k];
    } else if (tid < TAPS_CHUNKS + TM) {
      const int r = tid - TAPS_CHUNKS;
      dst[r * lda + 7] = zero;
      *reinterpret_cast<uint4*>(dst + r * lda + 8) =
          make_uint4(0u, 0u, 0u, 0u);
    }
  }

  // SCALAR: thread (r, g) stages row r's channels g, g + 4, ... of each tap
  {
    const int r = tid & (TM - 1), g = tid >> TM_SHIFT;
    const bool in = row0 + r < n;
    for (int s = 0; s < st.count; ++s) {
      if (st.path[s] != SCALAR) continue;
      const int C = st.c[s];
      const bf16* src = st.ptr[s] + (in ? (size_t)(row0 + r) * C : 0);
      bf16* dst = a_s + r * lda + st.off[s];
      for (int t = 0; t < 7; ++t) {
        const bf16* p = src + (size_t)t * n * C;
#pragma unroll 4
        for (int ch = g; ch < C; ch += NT / TM)
          dst[t * C + ch] = in ? p[ch] : zero;
      }
      for (int col = 7 * C + g; col < st.kpad[s]; col += NT / TM)
        dst[col] = zero;
    }
  }

  // head_from_staged's first wait and barrier publish the staged tile
  head_from_staged<0>(smem, ktot, row0, n, nullptr, percep, qxyz, qstride,
                      w1, w1xyz, b1, w2, b2, w3, b3, w4, b4, out);
}

}  // namespace

// stack_ptrs/channels: nscales bf16 (7, n, C_s) t-major tap stacks.
// w1cat: bf16 (ktot, 512), scale s's (7 * C_s) W1 rows in (disp, channel)
// order at the scale's padded offset, zero rows in the padding.  percep:
// bf16 (n, 512) with the coarse term folded in.  staging: out, each
// scale's staging path (0 SCALAR, 1 ROWS, 2 TAPS).  Returns 0, a
// cudaError_t code, or -1 for arguments the kernel does not take.
extern "C" int fused_fc0_mlp_bf16(
    const void* const* stack_ptrs, const int* channels, int nscales, int n,
    const void* percep, const void* qxyz, int qstride, const void* w1cat,
    int ktot, const void* w1xyz, const void* b1, const void* w2,
    const void* b2, const void* w3, const void* b3, const void* w4,
    const void* b4, void* out, int* staging, void* stream) {
  if (nscales < 1 || nscales > MAX_SCALES || n < 1 || qstride < 3)
    return -1;
  Stacks S;
  int off = 0;
  for (int s = 0; s < nscales; ++s) {
    const int C = channels[s];
    if (C < 1) return -1;
    S.ptr[s] = static_cast<const bf16*>(stack_ptrs[s]);
    S.c[s] = C;
    S.kpad[s] = (7 * C + 15) / 16 * 16;
    S.off[s] = off;
    off += S.kpad[s];
    const bool aligned = reinterpret_cast<uintptr_t>(stack_ptrs[s]) % 16 == 0;
    const int c8 = C / 8;
    S.shift[s] = 0;
    if (aligned && C % 8 == 0 && (c8 & (c8 - 1)) == 0) {
      S.path[s] = ROWS;
      while ((1 << S.shift[s]) < c8) ++S.shift[s];
    } else if (aligned && C == 1 && n % 8 == 0) {
      S.path[s] = TAPS;
    } else {
      S.path[s] = SCALAR;
    }
    staging[s] = S.path[s];
  }
  S.count = nscales;
  if (off != ktot) return -1;
  const long long smem = smem_bytes(ktot);
  if (smem > MAX_SMEM) return -1;
  cudaError_t e = cudaFuncSetAttribute(
      fused_fc0_mlp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int grid = (n + TM - 1) / TM;
  fused_fc0_mlp_kernel<<<grid, NT, (size_t)smem,
                         static_cast<cudaStream_t>(stream)>>>(
      S, ktot, n, static_cast<const bf16*>(percep),
      static_cast<const float*>(qxyz), qstride,
      static_cast<const bf16*>(w1cat), static_cast<const float*>(w1xyz),
      static_cast<const float*>(b1),
      static_cast<const bf16*>(w2), static_cast<const float*>(b2),
      static_cast<const bf16*>(w3), static_cast<const float*>(b3),
      static_cast<const bf16*>(w4), static_cast<const float*>(b4),
      static_cast<float*>(out));
  return (int)cudaGetLastError();
}
