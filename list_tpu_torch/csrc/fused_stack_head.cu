// K1: fused SDF-decoder head over the structured dense-grid stack parts.
//
// Replaces the TPU kernel fused_stack_head of
// list_tpu/ops/pallas/fused_fc0.py (body _stack_kernel): per tile of
// queries,
//   fc0 = sum_i part_i @ W1_i + percep + coarse + xyz . W1_xyz + b1
//   h1 = relu(fc0) -> bf16;  h2 = relu(h1 @ W2 + b2) -> bf16
//   h3 = relu(h2 @ W3 + b3) -> bf16;  out = h3 @ w4 + b4   (f32)
// with bf16 operands and f32 accumulation, without the (n, sum K_i) concat
// and without writing any activation to device memory.
//
// Bound on an H100 at the production shape (n = 2,097,152 queries, nine
// parts with sum K_i = 791, d1 = 512, d2 = d3 = 256): 601,856 MACs a query,
// 2.52 TFLOP against 989 TFLOP/s of bf16 tensor cores (about 2.55 ms), and
// about 3,666 B a query of input (about 2.3 ms at 3.35 TB/s): bound by
// tensor-core operations.
//
// Design: one block of 8 warps per 64-query tile.  The nine parts are
// staged once into shared memory as one zero-padded
// (64 x sum roundup16(K_i)) bf16 tile, so the kernel never needs the concat
// in device memory; the matching W1 rows are concatenated and zero-padded
// by the wrapper.  Parts whose rows are 16-byte aligned (K % 8 == 0 and a
// 16-byte aligned base: 160, 32, 32, 320, 64, 64, 672 of the 791 columns)
// are staged with 16-byte cp.async.cg, zero-filled past K and past the last
// query; the others (K = 85, 17) with 2-byte loads, a warp's eight rows in
// flight at once.  No index is divided.  The head over the staged tile
// (fc_0, fc_1, fc_2 with mma.sync from shared memory, the weights streamed
// once per tile through a cp.async ring) is fused_head.cuh's, shared with
// K4; its header gives the ring and the shared-memory budget.  Shared
// memory at the production shape: 224,768 B, one block per SM.
#include "fused_head.cuh"

using namespace fused_head;

namespace {

constexpr int MAX_PARTS = 16;

struct Parts {
  const bf16* ptr[MAX_PARTS];
  int k[MAX_PARTS];     // columns of part p
  int kpad[MAX_PARTS];  // k rounded up to 16
  int off[MAX_PARTS];   // first column of part p in the staged tile
  int vec[MAX_PARTS];   // 1: rows 16-byte aligned (K % 8 == 0, base too)
  int count;
};

// COARSE: 0 no coarse term, 1 bf16 (n, 512), 2 f32 (n, 512)
template <int COARSE>
__global__ void __launch_bounds__(NT, 1)
fused_stack_head_kernel(Parts parts, int ktot, int n,
                        const void* __restrict__ coarse,
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
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // a warp stages rows warp + j * NW (j < TM / NW), its lanes the columns
  for (int p = 0; p < parts.count; ++p) {
    if (!parts.vec[p]) continue;
    const int K = parts.k[p], kc = K / 8, off = parts.off[p];
    const bf16* src = parts.ptr[p];
    for (int c = lane; c < parts.kpad[p] / 8; c += 32)
#pragma unroll
      for (int j = 0; j < TM / NW; ++j) {
        const int r = warp + j * NW, row = row0 + r;
        const bool in = row < n && c < kc;
        cp_async16(a_s + r * lda + off + c * 8,
                   in ? src + (size_t)row * K + c * 8 : src, in ? 16 : 0);
      }
  }
  cp_async_commit();
  const bf16 zero = __float2bfloat16(0.f);
  for (int p = 0; p < parts.count; ++p) {
    if (parts.vec[p]) continue;
    const int K = parts.k[p], off = parts.off[p];
    const bf16* src = parts.ptr[p];
    for (int c = lane; c < parts.kpad[p]; c += 32) {
      bf16 v[TM / NW];
#pragma unroll
      for (int j = 0; j < TM / NW; ++j) {
        const int row = row0 + warp + j * NW;
        v[j] = (row < n && c < K) ? src[(size_t)row * K + c] : zero;
      }
#pragma unroll
      for (int j = 0; j < TM / NW; ++j)
        a_s[(warp + j * NW) * lda + off + c] = v[j];
    }
  }
  // head_from_staged's first barrier publishes the staged tile
  head_from_staged<COARSE>(smem, ktot, row0, n, coarse, percep, qxyz,
                           qstride, w1, w1xyz, b1, w2, b2, w3, b3, w4, b4,
                           out);
}

template <int COARSE>
int launch(const Parts& P, int ktot, int n, const void* coarse,
           const void* percep, const void* qxyz, int qstride, const void* w1,
           const void* w1xyz, const void* b1, const void* w2, const void* b2,
           const void* w3, const void* b3, const void* w4, const void* b4,
           void* out, size_t smem, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      fused_stack_head_kernel<COARSE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int grid = (n + TM - 1) / TM;
  fused_stack_head_kernel<COARSE><<<grid, NT, smem, stream>>>(
      P, ktot, n, coarse, static_cast<const bf16*>(percep),
      static_cast<const float*>(qxyz), qstride, static_cast<const bf16*>(w1),
      static_cast<const float*>(w1xyz), static_cast<const float*>(b1),
      static_cast<const bf16*>(w2), static_cast<const float*>(b2),
      static_cast<const bf16*>(w3), static_cast<const float*>(b3),
      static_cast<const bf16*>(w4), static_cast<const float*>(b4),
      static_cast<float*>(out));
  return (int)cudaGetLastError();
}

}  // namespace

// part_ptrs/part_k: nparts bf16 (n, K_p) row-major parts.  w1cat: bf16
// (ktot, 512), part p's W1 rows at the part's padded offset, zero rows in
// the padding.  coarse_mode: 0 none, 1 bf16, 2 f32.  Returns 0, a
// cudaError_t code, or -1 for arguments the kernel does not take.
extern "C" int fused_stack_head_bf16(
    const void* const* part_ptrs, const int* part_k, int nparts, int n,
    const void* coarse, int coarse_mode, const void* percep, const void* qxyz,
    int qstride, const void* w1cat, int ktot, const void* w1xyz,
    const void* b1, const void* w2, const void* b2, const void* w3,
    const void* b3, const void* w4, const void* b4, void* out,
    void* stream) {
  if (nparts < 1 || nparts > MAX_PARTS || n < 1 || qstride < 3) return -1;
  Parts P;
  int off = 0;
  for (int p = 0; p < nparts; ++p) {
    if (part_k[p] < 1) return -1;
    P.ptr[p] = static_cast<const bf16*>(part_ptrs[p]);
    P.k[p] = part_k[p];
    P.kpad[p] = (part_k[p] + 15) / 16 * 16;
    P.off[p] = off;
    P.vec[p] = part_k[p] % 8 == 0 &&
               reinterpret_cast<uintptr_t>(part_ptrs[p]) % 16 == 0;
    off += P.kpad[p];
  }
  P.count = nparts;
  if (off != ktot) return -1;
  const long long smem = smem_bytes(ktot);
  if (smem > MAX_SMEM) return -1;
  auto s = static_cast<cudaStream_t>(stream);
  switch (coarse_mode) {
    case 0:
      return launch<0>(P, ktot, n, nullptr, percep, qxyz, qstride, w1cat,
                       w1xyz, b1, w2, b2, w3, b3, w4, b4, out, (size_t)smem,
                       s);
    case 1:
      return launch<1>(P, ktot, n, coarse, percep, qxyz, qstride, w1cat,
                       w1xyz, b1, w2, b2, w3, b3, w4, b4, out, (size_t)smem,
                       s);
    case 2:
      return launch<2>(P, ktot, n, coarse, percep, qxyz, qstride, w1cat,
                       w1xyz, b1, w2, b2, w3, b3, w4, b4, out, (size_t)smem,
                       s);
    default:
      return -1;
  }
}
