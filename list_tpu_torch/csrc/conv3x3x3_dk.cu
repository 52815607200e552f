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
// becomes a deterministic two-pass reduction with no float atomics.
//
// Pass 1 (dk_partial_kernel): block (k, c) owns up to kCiBlock input
// channels (c) and a fixed range of rows (k), ordered so that a block walks
// one column (b, kTileH output rows, 128-wide x tile) down z.  Each z step
// stages in shared memory one new zero-padded input plane of the column
// (kTileH + 2 rows of every owned channel, with the x halo) and the
// column's kTileH rows of g (stored voxel-major, [x][o], so one float4
// gives four output channels), with 4-byte cp.async: zero fill for the halo
// and the padding, so the FMA loop has no bounds checks, and a thread
// copies the columns of one staged row, so no element index is divided.
// Every input value comes from L2 (kTileH + 2) / kTileH times, not nine.
// The planes sit in a ring: the three x planes a step reads and the next
// step's, staged while the FMAs run on this one, behind one barrier a
// step.
//
// Thread (o group, i, dz) owns the 3 x 3 (dy, dx) taps of one input
// channel and plane offset for four output channels (36 sums).  Per voxel
// it loads one x value from each of its three rows (a three-value window
// slides along each) and one float4 of g, and issues 36 FMAs.  The
// shared-memory pipe, not the FMAs, set the pace of the first design (a
// thread owned the three dx taps of one (i, dz, dy) for all 16 output
// channels: four float4 broadcasts of g, which take a pipe cycle per
// 8-lane phase even at one address, and one x load per 48 FMAs); now 7
// pipe cycles go with 36 FMAs.  The 8 lanes of a phase share the o group
// (one g address), and the x rows they read sit on 8 banks (odd row
// stride, slot stride 1 mod 32).  The x rows' odd stride puts them off
// 16-byte alignment, hence 4-byte copies; the g rows' stride puts the
// 8 x 4 (x, o) elements a warp stages on 32 banks.  Two 288-thread blocks
// fit on an SM at 16 -> 16 (18 warps).  At the end the segments' sums are
// added in a fixed order in shared memory and the block writes its partial
// sums to its scratch row.
//
// Pass 2 (dk_reduce_kernel): 8 warps per 32 outputs sum the scratch rows
// in a fixed order (coalesced across outputs), then add the 8 warp sums in
// a fixed order.  Two runs on the same input give bit-identical dk.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 288;           // 9 warps
constexpr int kCiBlock = 8;             // input channels a block
constexpr int kTileW = 128;             // output columns a tile
constexpr int kTileH = 2;               // output rows a step
constexpr int kAhead = 1;               // steps staged ahead
constexpr int kXSlots = kAhead + 3;     // x planes z-1, z, z+1 and those ahead
constexpr int kGSlots = kAhead + 1;
constexpr int kXRows = kTileH + 2;      // x rows of a plane a channel
constexpr int kRowStride = kTileW + 3;  // odd, >= kTileW + 2
constexpr int kMinBlocks = 2;           // blocks an SM at 16 -> 16
constexpr int kSmemPerSm = 233472;      // shared memory of an SM (228 KB)
constexpr int kSmemReserved = 1024;     // reserved per block

static_assert(kThreads % 32 == 0 && kThreads >= 3 * kCiBlock * 4,
              "a segment of (o group, i, dz) threads at 16 output channels");
static_assert(kThreads >= kXRows * kCiBlock, "a thread a staged row");
static_assert(kRowStride % 2 == 1 && kRowStride >= kTileW + 2, "");
static_assert(kTileW % 8 == 0, "g is staged in 8-column chunks");

template <int CO>
struct Tile {
  // g tile row stride: a multiple of 4 (float4 loads) that puts 8 columns
  // x 4 channels on 32 banks
  static constexpr int kGStride = CO % 8 == 0 ? CO + 4 : CO;
  static constexpr int kGRow = kTileW * kGStride;
  static constexpr int kGSlot = kTileH * kGRow;
  static constexpr int kOGroup = CO >= 4 ? 4 : 1;  // channels a staging chunk
  static constexpr int kNO = CO % 4 == 0 ? 4 : 1;  // output channels a thread
  static constexpr int kChunkLanes = 8 * kOGroup;  // 8 columns x kOGroup
  static_assert(CO % kOGroup == 0 && kThreads % kChunkLanes == 0, "");
  static_assert(CO == 1 || kGStride % 4 == 0, "");

  static size_t smem_bytes(int cin) {
    const size_t tiles = (size_t)kGSlots * kGSlot +
                         (size_t)kXSlots * (kXRows * cin * kRowStride + 32);
    const size_t red = (size_t)kThreads * 9 * kNO;
    return (tiles > red ? tiles : red) * sizeof(float);
  }
};

// kMinBlocks blocks an SM at the widest shape (16 -> 16: 8 channels a
// block)
static_assert(kMinBlocks * ((kGSlots * Tile<16>::kGSlot +
                             kXSlots * (kXRows * kCiBlock * kRowStride + 32)) *
                                4 +
                            kSmemReserved) <= kSmemPerSm, "");

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// rows r = ((b * nty + ty) * ntw + tw) * D + z; grid (blocks, Ci chunks)
template <int CO>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
dk_partial_kernel(const float* __restrict__ x, const float* __restrict__ g,
                  float* __restrict__ partial, int Ci, int Co, int D, int H,
                  int W, int nty, int ntw, int rows, int rows_per_block) {
  using T = Tile<CO>;
  extern __shared__ float4 smem4[];
  // g: [kGSlots][kTileH][kTileW][kGStride]; x: [kXSlots][cin][kXRows]
  // [kRowStride], slots xslot apart
  float* gs = reinterpret_cast<float*>(smem4);
  float* xs = gs + kGSlots * T::kGSlot;
  const int c0 = blockIdx.y * kCiBlock;
  const int cin = min(kCiBlock, Ci - c0);
  const int rows_x = kXRows * cin;  // x rows of a plane: i * kXRows + ry
  // slot stride = 1 (mod 32): the three slots a warp reads sit on other
  // banks
  const int xslot =
      rows_x * kRowStride + ((33 - rows_x * kRowStride % 32) & 31);
  const int P = 3 * cin;  // (i, dz) pairs: p = dz * cin + i
  constexpr int kOQ = CO / T::kNO;  // output-channel groups
  const int PN = P * kOQ;  // threads a segment
  const int nseg = kThreads / PN;
  const int tid = threadIdx.x;
  const int seg = tid / PN;  // nseg: an idle thread
  const int t = tid - seg * PN;  // oq * P + p
  const int oq = t / P;
  const int p = t - oq * P;
  const int dz = p / cin;
  const int xrow = (p - dz * cin) * kXRows * kRowStride;
  const size_t plane = (size_t)H * W;
  const size_t vol = plane * D;
  // x staging: thread (srow, sc0) copies columns sc0, sc0 + tpr, ... of
  // x row srow of every staged plane
  const int tpr = kThreads / rows_x;
  const int srow = tid / tpr;
  const int sc0 = tid - srow * tpr;
  const int sip = srow / kXRows;
  const int sry = srow - sip * kXRows;
  // g staging: chunk lanes (xi, oi), chunks of 8 columns x kOGroup channels
  const int sub = tid % T::kChunkLanes;
  const int xi = sub & 7;
  const int oi = sub >> 3;
  const int q0 = tid / T::kChunkLanes;
  constexpr int kQStep = kThreads / T::kChunkLanes;
  constexpr int kOGroups = kTileH * CO / T::kOGroup;  // (row, o group)

  constexpr int kNO = T::kNO;
  float acc[3][3][kNO];  // [dy][dx][o]
#pragma unroll
  for (int dy = 0; dy < 3; ++dy)
#pragma unroll
    for (int d = 0; d < 3; ++d)
#pragma unroll
      for (int o = 0; o < kNO; ++o) acc[dy][d][o] = 0.f;

  const int r0 = blockIdx.x * rows_per_block;
  const int r1 = min(rows, r0 + rows_per_block);
  for (int r = r0; r < r1;) {
    // the column (b, row tile, x tile) of row r and its z run [z0, z0 + n)
    const int z0 = r % D;
    const int col = r / D;
    const int n = min(r1 - r, D - z0);
    r += n;
    const int bt = col / ntw;
    const int xw0 = (col - bt * ntw) * kTileW;
    const int b = bt / nty;
    const int y0 = (bt - b * nty) * kTileH;
    const int txn = min(kTileW, W - xw0);
    const int ncols = txn + 2;
    // this thread's staged x row: its source row, and the columns whose
    // source lies inside the volume ([clo, chi])
    const int yy = y0 + sry - 1;
    const bool yok = srow < rows_x && yy >= 0 && yy < H;
    const float* xrow_src = x + ((size_t)b * Ci + c0 + sip) * vol +
                            (size_t)(yok ? yy : 0) * W + xw0 - 1;
    const int clo = xw0 == 0 ? 1 : 0;
    const int chi = min(txn + 1, W - xw0);
    // g staging: chunk (og, xo) of kOGroups x nxo, carried counters
    const int nxo = (txn + 7) / 8;
    const int go0 = q0 / nxo;
    const int gx0 = q0 - go0 * nxo;
    const int gdo = kQStep / nxo;
    const int gdx = kQStep - gdo * nxo;
    const float* gsrc = g + (size_t)b * Co * vol + (size_t)y0 * W + xw0;
    // this thread's segment of the tile
    const int seg_len = (txn + nseg - 1) / nseg;
    const int x_begin = min(txn, seg * seg_len);
    const int len = min(txn, x_begin + seg_len) - x_begin;

    auto stage_x = [&](int zz, int slot) {
      const bool ok = yok && zz >= 0 && zz < D;
      const float* src = xrow_src + (size_t)(ok ? zz : 0) * plane;
      float* dst = xs + slot * xslot + srow * kRowStride;
      if (srow < rows_x)
        for (int c = sc0; c < ncols; c += tpr) {
          const bool in = ok && c >= clo && c <= chi;
          cp_async4(dst + c, in ? src + c : x, in);
        }
    };
    auto stage_g = [&](int zz, int slot) {
      float* dst = gs + slot * T::kGSlot;
      const float* src = gsrc + (size_t)zz * plane;
      int og = go0, xo = gx0;
      while (og < kOGroups) {
        const int xx = xo * 8 + xi;
        const int ro = og * T::kOGroup + oi;  // row * CO + o
        const int ty = ro / CO;
        const int o = ro - ty * CO;
        const bool ok = o < Co && y0 + ty < H;
        if (xx < txn)
          cp_async4(dst + ty * T::kGRow + xx * T::kGStride + o,
                    ok ? src + (size_t)o * vol + (size_t)ty * W + xx : g,
                    ok);
        xo += gdx;
        og += gdo;
        if (xo >= nxo) {
          xo -= nxo;
          ++og;
        }
      }
    };
    auto stage = [&](int k) {  // step k's x plane z0 + k + 1 and g plane
      if (k < n) {
        stage_x(z0 + k + 1, (k + 2) % kXSlots);
        stage_g(z0 + k, k % kGSlots);
      }
      cp_async_commit();  // one group a step, empty past the run
    };

    __syncthreads();  // the previous run's reads are done
    stage_x(z0 - 1, 0);
    stage_x(z0, 1);
#pragma unroll
    for (int k = 0; k < kAhead; ++k) stage(k);
    for (int k = 0; k < n; ++k) {
      cp_async_wait<kAhead - 1>();  // step k's group has landed
      __syncthreads();              // ... for every thread; step k-1 is done
      stage(k + kAhead);            // into the slots step k-1 read
      if (len > 0) {
#pragma unroll
        for (int ty = 0; ty < kTileH; ++ty) {
          const float* xr = xs + ((k + dz) % kXSlots) * xslot + xrow +
                            ty * kRowStride + x_begin;
          const float* gp = gs + (k % kGSlots) * T::kGSlot + ty * T::kGRow +
                            x_begin * T::kGStride + oq * kNO;
          float a[3][3];  // [dy][dx]: x at columns xx .. xx + 2
#pragma unroll
          for (int dy = 0; dy < 3; ++dy) {
            a[dy][0] = xr[dy * kRowStride];
            a[dy][1] = xr[dy * kRowStride + 1];
          }
#pragma unroll 2
          for (int xx = 0; xx < len; ++xx) {
#pragma unroll
            for (int dy = 0; dy < 3; ++dy)
              a[dy][2] = xr[dy * kRowStride + xx + 2];
            float q[kNO];
            if constexpr (kNO == 4) {
              const float4 q4 =
                  *reinterpret_cast<const float4*>(gp + xx * T::kGStride);
              q[0] = q4.x;
              q[1] = q4.y;
              q[2] = q4.z;
              q[3] = q4.w;
            } else {
              q[0] = gp[xx * T::kGStride];
            }
#pragma unroll
            for (int dy = 0; dy < 3; ++dy)
#pragma unroll
              for (int d = 0; d < 3; ++d)
#pragma unroll
                for (int o = 0; o < kNO; ++o)
                  acc[dy][d][o] = fmaf(a[dy][d], q[o], acc[dy][d][o]);
#pragma unroll
            for (int dy = 0; dy < 3; ++dy) {
              a[dy][0] = a[dy][1];
              a[dy][1] = a[dy][2];
            }
          }
        }
      }
    }
  }

  // add the segments' sums in a fixed order; write this block's partials
  cp_async_wait<0>();
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem4);  // [nseg][PN][9 * kNO]
  if (seg < nseg) {
    float* mine = red + ((size_t)seg * PN + t) * 9 * kNO;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy)
#pragma unroll
      for (int d = 0; d < 3; ++d)
#pragma unroll
        for (int o = 0; o < kNO; ++o)
          mine[(dy * 3 + d) * kNO + o] = acc[dy][d][o];
  }
  __syncthreads();
  float* out = partial + (size_t)blockIdx.x * Co * Ci * 27;
  for (int j = tid; j < Co * cin * 27; j += kThreads) {
    const int o = j / (cin * 27);
    const int r = j - o * cin * 27;
    const int i = r / 27;
    const int tap = r - i * 27;  // (dz * 3 + dy) * 3 + dx
    const int tz = tap / 9;
    const int oo = o / kNO;
    const float* v = red + ((size_t)(oo * P + tz * cin + i)) * 9 * kNO +
                     (tap - tz * 9) * kNO + (o - oo * kNO);
    float s = 0.f;
    for (int s2 = 0; s2 < nseg; ++s2) s += v[(size_t)s2 * PN * 9 * kNO];
    out[(o * Ci + c0 + i) * 27 + tap] = s;
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
  const size_t smem = Tile<CO>::smem_bytes(Ci < kCiBlock ? Ci : kCiBlock);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        dk_partial_kernel<CO>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int ntw = (W + kTileW - 1) / kTileW;
  const int nty = (H + kTileH - 1) / kTileH;
  const int rows = B * nty * ntw * D;
  const int rows_per_block = (rows + nblk - 1) / nblk;
  const dim3 grid(nblk, (Ci + kCiBlock - 1) / kCiBlock);
  dk_partial_kernel<CO><<<grid, kThreads, smem, stream>>>(
      x, g, partial, Ci, Co, D, H, W, nty, ntw, rows, rows_per_block);
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
      W < 1 || nblk < 1 ||
      (long long)B * D * ((H + kTileH - 1) / kTileH) *
              ((W + kTileW - 1) / kTileW) > 0x7fffffffLL)
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
