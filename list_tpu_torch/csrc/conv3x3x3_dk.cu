// Weight gradient (dk) of the SAME zero-padded 3x3x3 cross-correlation,
// channel-major f32:
//
//   dk[o, i, dz, dy, dx] = sum_{b, z, y, x} g[b, o, z, y, x]
//                                         * x[b, i, z+dz-1, y+dy-1, x+dx-1]
//
// Replaces the TPU kernel _dk_kernel of list_tpu/ops/pallas/stencil3d.py
// (launched by _conv_dk_impl), which walks a sequential (B, D) grid and
// accumulates a (3, 9*Ci, Co) buffer resident in VMEM across grid steps.
//
// Bound on an H100 at batch 8 on a 128^3 volume: every output is a sum over
// 16.8M voxels.  1 -> 1 and 1 -> 16 are bound by memory bytes (0.13 and
// 1.14 GB of input); 16 -> 16 is bound by f32 operations outside the tensor
// cores (232 GFLOP, about 3.5 ms at 67 TFLOP/s).  Plain f32 FMAs, no TF32,
// so the result matches the f32 reference.
//
// Design.  Blocks run in no order on Hopper, so the TPU's carried sum
// becomes a deterministic two-pass reduction with no float atomics:
//
// Pass 1 (dk_partial_kernel): block k walks a fixed range of output rows
// (b, z, y).  For each row it stages in shared memory the nine zero-padded
// input rows (z-1..z+1, y-1..y+1) of every input channel and the row of g
// (stored voxel-major, [x][o], so one float4 broadcast load gives four
// output channels).  Thread (group, segment) owns the 3 x CO outputs of one
// (i, dz, dy) group -- the three dx taps for every output channel -- and
// slides a three-value register window along its segment of the row: one
// shared-memory load of x and CO/4 broadcast loads of g feed 3*CO FMAs.
// Row stride in shared memory is odd, so the 32 groups of a warp hit 32
// different banks.  At 16 -> 16 a block is 144 threads (one segment); at
// Ci = 1 the nine groups split the row into 16 segments, and the segments'
// sums are added in a fixed order in shared memory.  The block writes its
// Co*Ci*27 partial sums to a scratch row.
//
// Pass 2 (dk_reduce_kernel): 8 warps per 32 outputs sum the scratch rows
// in a fixed order (coalesced across outputs), then add the 8 warp sums in
// a fixed order.  Two runs on the same input give bit-identical dk.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxSmem = 227 * 1024;
constexpr int kThreadsTarget = 144;

struct Plan {
  int groups;    // 9 * Ci
  int nseg;      // row segments per group
  int rs;        // shared-memory row stride (odd, >= W + 2)
  int gs_off;    // float offset of the g tile (multiple of 4)
  size_t smem;   // dynamic shared memory bytes
};

Plan make_plan(int Ci, int co_pad, int W) {
  Plan p;
  p.groups = 9 * Ci;
  p.nseg = kThreadsTarget / p.groups;
  if (p.nseg < 1) p.nseg = 1;
  if (p.nseg > W) p.nseg = W;
  p.rs = (W + 2) | 1;
  p.gs_off = ((p.groups * p.rs + 3) / 4) * 4;
  const size_t tiles = (size_t)p.gs_off + (size_t)W * co_pad;
  const size_t red = (size_t)p.groups * p.nseg * 3 * co_pad;
  p.smem = (tiles > red ? tiles : red) * sizeof(float);
  return p;
}

// at most kThreadsTarget threads: nseg = kThreadsTarget / (9 * Ci) >= 1
template <int CO>
__global__ void __launch_bounds__(kThreadsTarget)
dk_partial_kernel(const float* __restrict__ x, const float* __restrict__ g,
                  float* __restrict__ partial, int Ci, int Co, int D, int H,
                  int W, int rows, int rows_per_block, int nseg, int rs,
                  int gs_off) {
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);  // [9*Ci][rs]
  float* gs = xs + gs_off;                      // [W][CO]
  const int G = 9 * Ci;
  const int nthreads = G * nseg;
  const int tid = threadIdx.x;
  const int grp = tid % G;  // (dz * 3 + dy) * Ci + i
  const int seg = tid / G;
  const int seg_len = (W + nseg - 1) / nseg;
  const int x_begin = seg * seg_len;
  const int x_end = min(W, x_begin + seg_len);
  const size_t plane = (size_t)H * W;
  const size_t vol = plane * D;

  // padded output channels of the g tile stay zero
  if (CO != Co)
    for (int idx = tid; idx < W * CO; idx += nthreads) gs[idx] = 0.f;

  float acc[3][CO];
#pragma unroll
  for (int d = 0; d < 3; ++d)
#pragma unroll
    for (int o = 0; o < CO; ++o) acc[d][o] = 0.f;

  const int r0 = blockIdx.x * rows_per_block;
  const int r1 = min(rows, r0 + rows_per_block);
  for (int r = r0; r < r1; ++r) {
    const int y = r % H;
    const int bz = r / H;
    const int z = bz % D;
    const int b = bz / D;
    __syncthreads();  // the previous row's reads are done
    for (int idx = tid; idx < G * (W + 2); idx += nthreads) {
      const int row = idx / (W + 2);
      const int c = idx - row * (W + 2);
      const int i = row % Ci;
      const int t9 = row / Ci;
      const int zz = z + t9 / 3 - 1;
      const int yy = y + t9 % 3 - 1;
      const int xx = c - 1;
      float v = 0.f;
      if (zz >= 0 && zz < D && yy >= 0 && yy < H && xx >= 0 && xx < W)
        v = __ldg(x + ((size_t)b * Ci + i) * vol + (size_t)zz * plane +
                  (size_t)yy * W + xx);
      xs[row * rs + c] = v;
    }
    for (int idx = tid; idx < Co * W; idx += nthreads) {
      const int o = idx / W;
      const int xx = idx - o * W;
      gs[xx * CO + o] = __ldg(g + ((size_t)b * Co + o) * vol +
                              (size_t)z * plane + (size_t)y * W + xx);
    }
    __syncthreads();
    if (x_begin < x_end) {
      const float* xr = xs + grp * rs + x_begin;
      float a0 = xr[0];
      float a1 = xr[1];
      for (int xx = x_begin; xx < x_end; ++xx) {
        const float a2 = xr[xx - x_begin + 2];
        const float* gp = gs + xx * CO;
        if constexpr (CO % 4 == 0) {
#pragma unroll
          for (int o = 0; o < CO; o += 4) {
            const float4 q = *reinterpret_cast<const float4*>(gp + o);
            acc[0][o] = fmaf(a0, q.x, acc[0][o]);
            acc[0][o + 1] = fmaf(a0, q.y, acc[0][o + 1]);
            acc[0][o + 2] = fmaf(a0, q.z, acc[0][o + 2]);
            acc[0][o + 3] = fmaf(a0, q.w, acc[0][o + 3]);
            acc[1][o] = fmaf(a1, q.x, acc[1][o]);
            acc[1][o + 1] = fmaf(a1, q.y, acc[1][o + 1]);
            acc[1][o + 2] = fmaf(a1, q.z, acc[1][o + 2]);
            acc[1][o + 3] = fmaf(a1, q.w, acc[1][o + 3]);
            acc[2][o] = fmaf(a2, q.x, acc[2][o]);
            acc[2][o + 1] = fmaf(a2, q.y, acc[2][o + 1]);
            acc[2][o + 2] = fmaf(a2, q.z, acc[2][o + 2]);
            acc[2][o + 3] = fmaf(a2, q.w, acc[2][o + 3]);
          }
        } else {
#pragma unroll
          for (int o = 0; o < CO; ++o) {
            const float q = gp[o];
            acc[0][o] = fmaf(a0, q, acc[0][o]);
            acc[1][o] = fmaf(a1, q, acc[1][o]);
            acc[2][o] = fmaf(a2, q, acc[2][o]);
          }
        }
        a0 = a1;
        a1 = a2;
      }
    }
  }

  // add the segments' sums in a fixed order; write this block's partials
  __syncthreads();
  float* red = xs;  // [nseg][G][3 * CO]
  {
    float* mine = red + ((size_t)seg * G + grp) * 3 * CO;
#pragma unroll
    for (int d = 0; d < 3; ++d)
#pragma unroll
      for (int o = 0; o < CO; ++o) mine[d * CO + o] = acc[d][o];
  }
  __syncthreads();
  const int nout = Co * Ci * 27;
  float* out = partial + (size_t)blockIdx.x * nout;
  for (int j = tid; j < G * 3 * Co; j += nthreads) {
    const int o = j % Co;
    const int t = j / Co;
    const int d = t % 3;
    const int gi = t / 3;
    float s = 0.f;
    for (int s2 = 0; s2 < nseg; ++s2)
      s += red[((size_t)s2 * G + gi) * 3 * CO + d * CO + o];
    const int i = gi % Ci;
    const int t9 = gi / Ci;  // dz * 3 + dy
    out[(o * Ci + i) * 27 + t9 * 3 + d] = s;
  }
}

// partial [nblk][nout] -> dk [nout]; block = 32 outputs x 8 warps
__global__ void __launch_bounds__(256)
dk_reduce_kernel(const float* __restrict__ partial, float* __restrict__ dk,
                 int nblk, int nout) {
  __shared__ float sums[8][32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int j = blockIdx.x * 32 + lane;
  float s = 0.f;
  if (j < nout)
    for (int k = warp; k < nblk; k += 8) s += partial[(size_t)k * nout + j];
  sums[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && j < nout) {
    float t = sums[0][lane];
#pragma unroll
    for (int w = 1; w < 8; ++w) t += sums[w][lane];
    dk[j] = t;
  }
}

template <int CO>
int launch(const float* x, const float* g, float* dk, float* partial,
           int nblk, int B, int Ci, int Co, int D, int H, int W,
           cudaStream_t stream) {
  const Plan p = make_plan(Ci, CO, W);
  if (p.smem > (size_t)kMaxSmem) return -1;
  if (p.smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        dk_partial_kernel<CO>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)p.smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int rows = B * D * H;
  const int rows_per_block = (rows + nblk - 1) / nblk;
  dk_partial_kernel<CO><<<nblk, p.groups * p.nseg, p.smem, stream>>>(
      x, g, partial, Ci, Co, D, H, W, rows, rows_per_block, p.nseg, p.rs,
      p.gs_off);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int nout = Co * Ci * 27;
  dk_reduce_kernel<<<(nout + 31) / 32, 256, 0, stream>>>(partial, dk, nblk,
                                                         nout);
  return (int)cudaGetLastError();
}

}  // namespace

// x (B, Ci, D, H, W), g (B, Co, D, H, W), dk (Co, Ci, 3, 3, 3), all f32
// contiguous; partial: nblk * Co * Ci * 27 floats of scratch.  Returns 0 on
// success, a cudaError_t code from a launch, or -1 for arguments the kernel
// does not take.
extern "C" int conv3x3x3_dk_f32(const void* x, const void* g, void* dk,
                                void* partial, int nblk, int B, int Ci,
                                int Co, int D, int H, int W, void* stream) {
  if (B < 1 || Ci < 1 || Ci > 16 || Co < 1 || Co > 16 || D < 1 || H < 1 ||
      W < 1 || nblk < 1 || (long long)B * D * H > 0x7fffffffLL)
    return -1;
  const int co_pad = Co == 1 ? 1 : ((Co + 3) / 4) * 4;
  auto s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* gf = static_cast<const float*>(g);
  float* dkf = static_cast<float*>(dk);
  float* pf = static_cast<float*>(partial);
  switch (co_pad) {
    case 1: return launch<1>(xf, gf, dkf, pf, nblk, B, Ci, Co, D, H, W, s);
    case 4: return launch<4>(xf, gf, dkf, pf, nblk, B, Ci, Co, D, H, W, s);
    case 8: return launch<8>(xf, gf, dkf, pf, nblk, B, Ci, Co, D, H, W, s);
    case 12: return launch<12>(xf, gf, dkf, pf, nblk, B, Ci, Co, D, H, W, s);
    default: return launch<16>(xf, gf, dkf, pf, nblk, B, Ci, Co, D, H, W, s);
  }
}
