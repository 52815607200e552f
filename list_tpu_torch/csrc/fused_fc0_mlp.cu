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
// 1.262 TFLOP against 989 TFLOP/s of bf16 tensor cores (about 1.28 ms), and
// about 2,622 B a query of input (about 0.82 ms at 3.35 TB/s): bound by
// tensor-core operations.
//
// Design (the same scheme as K1): one block of 8 warps per 64-query tile
// stages each scale's seven taps as one zero-padded
// (64 x roundup16(7 * C_s)) bf16 block of columns (t, c), i.e. widths
// 16, 112, 224 and 448 -- an 800-column tile -- so the 28 per-tap partial
// products of the TPU kernel become one tensor-core product against the
// wrapper's concatenated, zero-padded W1 rows.  For C_s = 1 the TPU kernel
// uses seven f32 broadcast FMAs; a bf16 x bf16 product is exact in f32, so
// the tensor cores compute the same terms, only summed in another order.
// The head over the staged tile is fused_head.cuh's, shared with K1: mma.sync
// from shared memory, the weights streamed once per tile through a cp.async
// ring (its header gives the ring and the budget).  This kernel's staging
// is still one bf16 at a time.  Shared memory at the production shape:
// 220,672 B, one block per SM.
#include "fused_head.cuh"

using namespace fused_head;

namespace {

constexpr int MAX_SCALES = 8;

struct Stacks {
  const bf16* ptr[MAX_SCALES];  // (7, n, C_s) t-major
  int c[MAX_SCALES];            // channels C_s
  int kpad[MAX_SCALES];         // 7 * C_s rounded up to 16
  int off[MAX_SCALES];          // first column of scale s in the tile
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
  const bf16 zero = __float2bfloat16(0.f);
  for (int s = 0; s < st.count; ++s) {
    const int C = st.c[s], K = 7 * C, kp = st.kpad[s], off = st.off[s];
    const bf16* src = st.ptr[s];
    for (int i = threadIdx.x; i < TM * kp; i += NT) {
      const int r = i / kp, col = i - r * kp;
      const int row = row0 + r;
      bf16 v = zero;
      if (row < n && col < K) {
        const int t = col / C, ch = col - t * C;
        v = src[((size_t)t * n + row) * C + ch];
      }
      a_s[r * lda + off + col] = v;
    }
  }
  __syncthreads();
  head_from_staged<0>(smem, ktot, row0, n, nullptr, percep, qxyz, qstride,
                      w1, w1xyz, b1, w2, b2, w3, b3, w4, b4, out);
}

}  // namespace

// stack_ptrs/channels: nscales bf16 (7, n, C_s) t-major tap stacks.
// w1cat: bf16 (ktot, 512), scale s's (7 * C_s) W1 rows in (disp, channel)
// order at the scale's padded offset, zero rows in the padding.  percep:
// bf16 (n, 512) with the coarse term folded in.  Returns 0, a cudaError_t
// code, or -1 for arguments the kernel does not take.
extern "C" int fused_fc0_mlp_bf16(
    const void* const* stack_ptrs, const int* channels, int nscales, int n,
    const void* percep, const void* qxyz, int qstride, const void* w1cat,
    int ktot, const void* w1xyz, const void* b1, const void* w2,
    const void* b2, const void* w3, const void* b3, const void* w4,
    const void* b4, void* out, void* stream) {
  if (nscales < 1 || nscales > MAX_SCALES || n < 1 || qstride < 3)
    return -1;
  Stacks S;
  int off = 0;
  for (int s = 0; s < nscales; ++s) {
    if (channels[s] < 1) return -1;
    S.ptr[s] = static_cast<const bf16*>(stack_ptrs[s]);
    S.c[s] = channels[s];
    S.kpad[s] = (7 * channels[s] + 15) / 16 * 16;
    S.off[s] = off;
    off += S.kpad[s];
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
