// SAME zero-padded 3x3x3 cross-correlation, no bias, channel-major f32.
//
// Replaces the TPU kernel conv3x3x3_cmajor (forward) of
// list_tpu/ops/pallas/stencil3d.py (_fwd_kernel, launched by
// _conv_fwd_impl), which builds a (9*Ci, H, W) tap stack in VMEM and
// contracts it on the MXU.
//
// Bound on an H100: at 16 -> 16 channels on a 128^3 volume the convolution
// is 29.0 GFLOP of f32 FMAs against 128 MB of input and output, so it is
// bound by f32 operations outside the tensor cores (about 0.43 ms at
// 67 TFLOP/s); at 1 -> 1 and 1 -> 16 it is bound by memory bytes.
//
// Design.  A 256-thread block owns an output tile: one (b, z), TY rows
// (8, 16 or 32 as CO is 16/12, 8 or 4/1) and a 128-wide run of W.  It
// stages the zero-padded input tile with its halo -- the three planes
// z-1..z+1, TY + 2 rows, 130 columns -- for kCiChunk input channels at a
// time with 4-byte cp.async (zero fill for the halo and the padding, so the
// FMA loop has no bounds checks; a few threads copy the columns of one
// staged row, so no element index is divided), double-buffered over
// channel chunks: the next chunk lands while the FMAs run on this one,
// behind one barrier a chunk.  Warp w owns VY = TY / 8 rows.  A lane reads
// six-value windows of an input row as one float4 and one float2 (lanes on
// consecutive 16 bytes) and computes 4-voxel runs x output channels: at
// CO = 16 each half-warp takes 8 channels and a lane two runs 64 columns
// apart (64 sums), else a lane one run and all CO (64 sums at CO = 8, 4;
// 48 at 12; 16 at 1).  So every broadcast float4 of weights (kept in
// shared memory as [ci][tap][CO], at most 48 KB; the 8 lanes of a
// shared-memory phase read one address) feeds 32 FMAs at CO = 16 and 16
// below; at CO <= 4 a plane's nine taps of weights sit in registers.  The
// old kernel fed 4 FMAs a weight load and re-read every input 27 times
// from L1.  Outputs are stored as float4 along W where a row is 16-byte
// aligned.  Plain f32 FMAs, no TF32.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kTileW = 128;    // a row of a warp
constexpr int kRowStride = kTileW + 4;  // >= kTileW + 2, 16-byte rows
constexpr int kWeightSmem = 48 * 1024;  // the weights' room, bytes

static_assert(kRowStride % 4 == 0 && kRowStride >= kTileW + 2, "");

template <int CO>
struct Tile {
  static constexpr int kVY = CO >= 12 ? 1 : (CO == 8 ? 2 : 4);  // rows a warp
  static constexpr int kTY = kWarps * kVY;                   // rows a tile
  static constexpr int kRows = kTY + 2;                      // with the halo
  static constexpr int kCiChunk = CO >= 12 ? 2 : 1;  // channels a stage
  static constexpr int kPlane = kRows * kRowStride;  // floats of one plane
  static constexpr int kChunk = kCiChunk * 3 * kPlane;
  static constexpr int kStagedRows = kCiChunk * 3 * kRows;  // rows a chunk
  static constexpr int kRowThreads = kThreads / kStagedRows;  // threads a row
  static constexpr bool kWeightsInRegs = CO <= 4;
  // at CO = 16 the two half-warps take 8 output channels each and a lane
  // two runs of 4 voxels, 64 columns apart; else a lane one run, all CO
  static constexpr int kOParts = CO == 16 ? 2 : 1;
  static constexpr int kNO = CO / kOParts;  // output channels a thread
  static constexpr int kLanesW = 32 / kOParts;  // lanes along a row
  static constexpr int kRuns = kTileW / (4 * kLanesW);  // 4-voxel runs
  static_assert(kRuns * 4 * kLanesW == kTileW, "");
  static_assert(CO == 1 || kNO % 4 == 0, "");
  static_assert(kVY * kRuns * 4 * kNO <= 64, "sums a thread");
  static_assert(kRowThreads >= 1, "");

  // the weights and one chunk buffer, two where there are two chunks
  static size_t smem_bytes(int Ci) {
    const size_t w = ((size_t)Ci * 27 * CO + 3) / 4 * 4;
    return (w + (Ci > kCiChunk ? 2 : 1) * (size_t)kChunk) * sizeof(float);
  }
};

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

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// block = ((b * D + z) * nty + ty) * ntw + tw
template <int CO>
__global__ void __launch_bounds__(kThreads, 2)
conv3x3x3_kernel(const float* __restrict__ x, const float* __restrict__ w,
                 float* __restrict__ y, int Ci, int Co, int D, int H, int W,
                 int nty, int ntw) {
  using T = Tile<CO>;
  extern __shared__ float4 smem4[];
  float* ws = reinterpret_cast<float*>(smem4);  // [Ci][27][CO]
  const int nw = Ci * 27 * CO;
  float* xs = ws + (nw + 3) / 4 * 4;  // [2][kCiChunk][3][kRows][kRowStride]
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  int blk = blockIdx.x;
  const int tw = blk % ntw;
  blk /= ntw;
  const int ty = blk % nty;
  blk /= nty;
  const int z = blk % D;
  const int b = blk / D;
  const int x0 = tw * kTileW;
  const int y0 = ty * T::kTY;
  const int txn = min(kTileW, W - x0);
  const size_t plane = (size_t)H * W;
  const size_t vol = plane * D;

  // staging: thread (srow, sc0) copies columns sc0, sc0 + kRowThreads, ...
  // of staged row srow = (ci' * 3 + dz) * kRows + ry of every chunk; the
  // columns whose source lies inside the volume are [clo, chi]
  const int ncols = txn + 2;
  const int srow = tid / T::kRowThreads;
  const int sc0 = tid - srow * T::kRowThreads;
  const int scz = srow / T::kRows;  // ci' * 3 + dz
  const int sci = scz / 3;
  const int zz = z + scz - sci * 3 - 1;
  const int yy = y0 + srow - scz * T::kRows - 1;
  const bool rok = srow < T::kStagedRows && zz >= 0 && zz < D && yy >= 0 &&
                   yy < H;
  const float* xrow_src = x + ((size_t)b * Ci + sci) * vol +
                          (rok ? (size_t)zz * plane + (size_t)yy * W : 0) +
                          x0 - 1;
  const int clo = x0 == 0 ? 1 : 0;
  const int chi = min(txn + 1, W - x0);
  auto stage = [&](int c0, float* dst) {
    const bool ok = rok && c0 + sci < Ci;
    const float* src = xrow_src + (size_t)c0 * vol;
    dst += srow * kRowStride;
    if (srow < T::kStagedRows)
      for (int c = sc0; c < ncols; c += T::kRowThreads) {
        const bool in = ok && c >= clo && c <= chi;
        cp_async4(dst + c, in ? src + c : x, in);
      }
  };

  // the weights, torch layout (Co, Ci, 3, 3, 3) -> [ci][tap][CO], padded
  // channels zero; they join the first chunk's group
  for (int i = tid; i < nw; i += kThreads) {
    const int o = i % CO;
    const int ct = i / CO;  // ci * 27 + tap
    cp_async4(ws + i, o < Co ? w + (size_t)o * Ci * 27 + ct : w, o < Co);
  }

  // lane (oh, vl): output channels oh * kNO.., voxels 4 vl + kRunW r + j
  constexpr int kNO = T::kNO;
  constexpr int kRunW = 4 * T::kLanesW;
  const int vl = lane % T::kLanesW;
  const int oh = lane / T::kLanesW;
  float acc[T::kVY][T::kRuns][4][kNO];
#pragma unroll
  for (int v = 0; v < T::kVY; ++v)
#pragma unroll
    for (int r = 0; r < T::kRuns; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int o = 0; o < kNO; ++o) acc[v][r][j][o] = 0.f;

  const int nchunk = (Ci + T::kCiChunk - 1) / T::kCiChunk;
  stage(0, xs);
  cp_async_commit();
  for (int k = 0; k < nchunk; ++k) {
    cp_async_wait_all();  // chunk k has landed
    __syncthreads();      // ... for every thread; chunk k-1 is done
    if (k + 1 < nchunk) {
      stage((k + 1) * T::kCiChunk, xs + ((k + 1) & 1) * T::kChunk);
      cp_async_commit();
    }
    const float* buf = xs + (k & 1) * T::kChunk;
    const int cic = min(T::kCiChunk, Ci - k * T::kCiChunk);
    for (int cc = 0; cc < cic; ++cc) {
      const float* wc = ws + (k * T::kCiChunk + cc) * 27 * CO + oh * kNO;
#pragma unroll
      for (int dz = 0; dz < 3; ++dz) {
        const float* rows = buf + (cc * 3 + dz) * T::kPlane +
                            warp * T::kVY * kRowStride + 4 * vl;
        const float* wz = wc + dz * 9 * CO;
        float wr[T::kWeightsInRegs ? 9 * CO : 1];
        if constexpr (T::kWeightsInRegs) {
#pragma unroll
          for (int t = 0; t < 9 * CO; ++t) wr[t] = wz[t];
        }
#pragma unroll
        for (int r = 0; r < T::kVY + 2; ++r) {
          // columns 4 vl + kRunW ru + 0..5: the run's voxels and halo
          float v[T::kRuns][6];
#pragma unroll
          for (int ru = 0; ru < T::kRuns; ++ru) {
            const float* src = rows + r * kRowStride + ru * kRunW;
            const float4 p = *reinterpret_cast<const float4*>(src);
            const float2 q = *reinterpret_cast<const float2*>(src + 4);
            v[ru][0] = p.x;
            v[ru][1] = p.y;
            v[ru][2] = p.z;
            v[ru][3] = p.w;
            v[ru][4] = q.x;
            v[ru][5] = q.y;
          }
#pragma unroll
          for (int dy = 0; dy < 3; ++dy) {
            const int vy = r - dy;
            if (vy < 0 || vy >= T::kVY) continue;
#pragma unroll
            for (int dx = 0; dx < 3; ++dx) {
              const int t = dy * 3 + dx;
              if constexpr (T::kWeightsInRegs) {
#pragma unroll
                for (int o = 0; o < CO; ++o)
#pragma unroll
                  for (int j = 0; j < 4; ++j)
                    acc[vy][0][j][o] = fmaf(v[0][j + dx], wr[t * CO + o],
                                            acc[vy][0][j][o]);
              } else {
#pragma unroll
                for (int o = 0; o < kNO; o += 4) {
                  const float4 k4 =
                      *reinterpret_cast<const float4*>(wz + t * CO + o);
#pragma unroll
                  for (int ru = 0; ru < T::kRuns; ++ru)
#pragma unroll
                    for (int j = 0; j < 4; ++j) {
                      const float xv = v[ru][j + dx];
                      acc[vy][ru][j][o] = fmaf(xv, k4.x, acc[vy][ru][j][o]);
                      acc[vy][ru][j][o + 1] =
                          fmaf(xv, k4.y, acc[vy][ru][j][o + 1]);
                      acc[vy][ru][j][o + 2] =
                          fmaf(xv, k4.z, acc[vy][ru][j][o + 2]);
                      acc[vy][ru][j][o + 3] =
                          fmaf(xv, k4.w, acc[vy][ru][j][o + 3]);
                    }
                }
              }
            }
          }
        }
      }
    }
  }

  // store: float4 along W where the row is 16-byte aligned
#pragma unroll
  for (int ru = 0; ru < T::kRuns; ++ru) {
    const int xl = 4 * vl + ru * kRunW;
    if (xl >= txn) break;
    const bool vec = (W & 3) == 0 && xl + 4 <= txn;
#pragma unroll
    for (int vy = 0; vy < T::kVY; ++vy) {
      const int yy = y0 + warp * T::kVY + vy;
      if (yy >= H) break;
      float* yo = y + ((size_t)b * Co + oh * kNO) * vol + (size_t)z * plane +
                  (size_t)yy * W + x0 + xl;
#pragma unroll
      for (int o = 0; o < kNO; ++o) {
        if (oh * kNO + o >= Co) break;
        float* p = yo + (size_t)o * vol;
        if (vec) {
          *reinterpret_cast<float4*>(p) =
              make_float4(acc[vy][ru][0][o], acc[vy][ru][1][o],
                          acc[vy][ru][2][o], acc[vy][ru][3][o]);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (xl + j < txn) p[j] = acc[vy][ru][j][o];
        }
      }
    }
  }
}

template <int CO>
int launch(const float* x, const float* w, float* y, int B, int Ci, int Co,
           int D, int H, int W, cudaStream_t stream) {
  using T = Tile<CO>;
  const size_t smem = T::smem_bytes(Ci);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        conv3x3x3_kernel<CO>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int ntw = (W + kTileW - 1) / kTileW;
  const int nty = (H + T::kTY - 1) / T::kTY;
  const long long blocks = (long long)B * D * nty * ntw;
  if (blocks > 0x7fffffffLL) return -1;
  conv3x3x3_kernel<CO><<<(unsigned)blocks, kThreads, smem, stream>>>(
      x, w, y, Ci, Co, D, H, W, nty, ntw);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns 0 on success, a cudaError_t code from the launch, or -1 for
// arguments the kernel does not take: Co <= 16, Ci * 27 * Co (Co padded to
// 1 or a multiple of 4) weights in 48 KB, and at most 2^31 - 1 tiles.
extern "C" int conv3x3x3_f32(const void* x, const void* w, void* y, int B,
                             int Ci, int Co, int D, int H, int W,
                             void* stream) {
  if (B < 1 || Ci < 1 || Co < 1 || Co > 16 || D < 1 || H < 1 || W < 1)
    return -1;
  const int co_pad = Co == 1 ? 1 : ((Co + 3) / 4) * 4;
  if ((size_t)Ci * 27 * co_pad * sizeof(float) > kWeightSmem) return -1;
  auto s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(w);
  float* yf = static_cast<float*>(y);
  switch (co_pad) {
    case 1: return launch<1>(xf, wf, yf, B, Ci, Co, D, H, W, s);
    case 4: return launch<4>(xf, wf, yf, B, Ci, Co, D, H, W, s);
    case 8: return launch<8>(xf, wf, yf, B, Ci, Co, D, H, W, s);
    case 12: return launch<12>(xf, wf, yf, B, Ci, Co, D, H, W, s);
    default: return launch<16>(xf, wf, yf, B, Ci, Co, D, H, W, s);
  }
}
