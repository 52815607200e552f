// The dense decode's perceptual sample: the projected perceptual map
// (ms^2, C) (ms = 137), bf16 or f32, sampled at each query's pixel, one
// row of C channels a query in the map's type.  Per query (x, y, z) = (p0, p1, p2): (u, v, d) =
// (p0, p1, p2, 1) through the (4, 3) camera, the perspective divide by
// d + 1e-8, the pixel clamped to [0, ms - 1], its four corners (the +1
// corners clamped to ms - 1) and the bilinear of their rows.  LIST's and
// DISN's dense decodes (ops/dense_grid.py) call it once a slab.
//
// Replaces no TPU kernel: the JAX package leaves this sample to XLA
// (list_tpu/ops/dense_grid.py:640-689).  It replaces the port's plain
// PyTorch passes (ops/cuda/percep.py percep_sample_plain): three f32
// coordinate passes, a 4n index, the gather of the (4n, C) corner rows
// into device memory (8.6 GB at 128^3 and C = 512) and nine bf16 passes
// over (n, C), each rounded to bf16.
//
// Bound on an H100: memory bytes, a few operations a byte.  The only
// traffic the sample must make is its (n, C) output, 2.147 GB in bf16 at
// n = 128^3 and C = 512, and the map read once, 19.2 MB: 0.647 ms at
// 3.35 TB/s.
//
// Design.  The map fits in the 50 MB L2, so the corner rows are read from
// cache, never gathered into device memory: map loads take the read-only
// path (L1) with an L2 evict-last policy, and the output leaves with
// evict-first streaming stores (st.global.cs), so the 2 GB stream does not
// push the map out of L2.  A warp owns 32 consecutive queries: each lane
// computes one query's pixel (the plain version's f32 operations in its
// order, each rounded on its own: __fmul_rn, __fadd_rn, __fdiv_rn, so no
// FMA contraction, and the same four corners for every finite input),
// then the warp walks the 32 queries, the corners and weights shuffled
// from their lane, each lane loading 16-byte vectors of the four corner
// rows (8 bf16 or 4 f32 channels), neighbouring lanes on neighbouring 16
// bytes, and storing 16 bytes of the output row.  Queries run along z, so
// a warp's and a block's queries fall on neighbouring pixels and their
// repeated corner rows hit L1.  The bilinear is f32 on the corners; a
// bf16 map's output is rounded to bf16 once, at the store, an f32 map's
// stored as computed.  Rows must be whole 16-byte vectors, 16-byte
// aligned (C % 8 == 0 for bf16, C % 4 == 0 for f32): every map of the
// port is (the wrapper raises otherwise).  The coordinates are any three
// (S, A, B) f32 tensors given with their strides (LIST's materialised
// 2 z, 2 y, 2 x; DISN's stride-0 expanded views), read with no copy; the
// camera is read from the device, so nothing waits for the card.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxMap = 256;  // the corners travel packed, 8 bits each

// The queries' three coordinate tensors, each (S, A, B) with its strides.
struct Queries {
  const float* p[3];
  long long stride[3][3];
  long long A, B;
};

// The f32 pixel (xpix, ypix) of query i, as percep_sample_plain computes
// it: u = ((p0 t00 + p1 t10) + p2 t20) + t30 (v, d the same with columns 1
// and 2), then u / (d + 1e-8) clamped to [0, ms - 1].  fmaxf/fminf keep a
// NaN in range, so no index leaves the map.
__device__ __forceinline__ void pixel(const Queries& q,
                                      const float* __restrict__ t,
                                      long long i, int ms, float& xpix,
                                      float& ypix) {
  const long long b = i % q.B;
  const long long r = i / q.B;
  const long long a = r % q.A;
  const long long s = r / q.A;
  float p[3];
#pragma unroll
  for (int k = 0; k < 3; ++k)
    p[k] = __ldg(q.p[k] + s * q.stride[k][0] + a * q.stride[k][1] +
                 b * q.stride[k][2]);
  float uvd[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float acc = __fmul_rn(p[0], __ldg(t + c));
    acc = __fadd_rn(acc, __fmul_rn(p[1], __ldg(t + 3 + c)));
    acc = __fadd_rn(acc, __fmul_rn(p[2], __ldg(t + 6 + c)));
    uvd[c] = __fadd_rn(acc, __ldg(t + 9 + c));
  }
  const float den = __fadd_rn(uvd[2], 1e-8f);
  const float hi = (float)(ms - 1);
  xpix = fminf(fmaxf(__fdiv_rn(uvd[0], den), 0.f), hi);
  ypix = fminf(fmaxf(__fdiv_rn(uvd[1], den), 0.f), hi);
}

__device__ __forceinline__ uint64_t evict_last_policy() {
  uint64_t policy;
  asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n"
      : "=l"(policy));
  return policy;
}

// 16 bytes of the map through the read-only path, kept in L2.
__device__ __forceinline__ uint4 load_map(const uint4* p, uint64_t policy) {
  uint4 r;
  asm("ld.global.nc.L2::cache_hint.v4.u32 {%0, %1, %2, %3}, [%4], %5;\n"
      : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
      : "l"(p), "l"(policy));
  return r;
}

__device__ __forceinline__ float lo(unsigned w) {
  return __uint_as_float(w << 16);
}

__device__ __forceinline__ float hi(unsigned w) {
  return __uint_as_float(w & 0xffff0000u);
}

// ((1 - wy) ((1 - wx) c00 + wx c01) + wy ((1 - wx) c10 + wx c11)) in f32
__device__ __forceinline__ float bilerp(float c00, float c01, float c10,
                                        float c11, float wx, float ax,
                                        float wy, float ay) {
  const float top = fmaf(c01, wx, c00 * ax);
  const float bot = fmaf(c11, wx, c10 * ax);
  return fmaf(bot, wy, top * ay);
}

// 16 bytes of each corner row -> 16 bytes of their bilinear, word by word:
// a word holds two bf16 channels (rounded once) or one f32 channel.
template <typename T>
__device__ __forceinline__ unsigned bilerp_word(unsigned c00, unsigned c01,
                                                unsigned c10, unsigned c11,
                                                float wx, float ax, float wy,
                                                float ay);

template <>
__device__ __forceinline__ unsigned bilerp_word<__nv_bfloat16>(
    unsigned c00, unsigned c01, unsigned c10, unsigned c11, float wx,
    float ax, float wy, float ay) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(
      bilerp(lo(c00), lo(c01), lo(c10), lo(c11), wx, ax, wy, ay),
      bilerp(hi(c00), hi(c01), hi(c10), hi(c11), wx, ax, wy, ay));
  return *reinterpret_cast<const unsigned*>(&h);
}

template <>
__device__ __forceinline__ unsigned bilerp_word<float>(
    unsigned c00, unsigned c01, unsigned c10, unsigned c11, float wx,
    float ax, float wy, float ay) {
  return __float_as_uint(bilerp(__uint_as_float(c00), __uint_as_float(c01),
                                __uint_as_float(c10), __uint_as_float(c11),
                                wx, ax, wy, ay));
}

// V 16-byte vectors a row (C sizeof(T) / 16)
template <typename T>
__global__ void __launch_bounds__(kThreads)
    percep_sample_kernel(const T* __restrict__ map,
                         const float* __restrict__ t, Queries q,
                         T* __restrict__ out, long long n, int V, int ms) {
  const int lane = threadIdx.x & 31;
  const long long base =
      ((long long)blockIdx.x * kWarps + (threadIdx.x >> 5)) * 32;
  if (base >= n) return;  // the whole warp leaves together
  // this lane's query: corners x0 | x1 << 8 | y0 << 16 | y1 << 24, weights
  unsigned corners = 0;
  float wx = 0.f, wy = 0.f;
  if (base + lane < n) {
    float xpix, ypix;
    pixel(q, t, base + lane, ms, xpix, ypix);
    const int x0 = (int)floorf(xpix);
    const int y0 = (int)floorf(ypix);
    const int x1 = min(x0 + 1, ms - 1);
    const int y1 = min(y0 + 1, ms - 1);
    wx = __fsub_rn(xpix, (float)x0);
    wy = __fsub_rn(ypix, (float)y0);
    corners = (unsigned)x0 | (unsigned)x1 << 8 | (unsigned)y0 << 16 |
              (unsigned)y1 << 24;
  }
  const int count = (int)min(32LL, n - base);
  const uint64_t policy = evict_last_policy();
  const uint4* m = reinterpret_cast<const uint4*>(map);
  uint4* o = reinterpret_cast<uint4*>(out);
  for (int j = 0; j < count; ++j) {
    const unsigned cj = __shfl_sync(kFull, corners, j);
    const float bx = __shfl_sync(kFull, wx, j);
    const float by = __shfl_sync(kFull, wy, j);
    const float ax = 1.f - bx;
    const float ay = 1.f - by;
    const int x0 = cj & 255, x1 = (cj >> 8) & 255;
    const int y0 = (cj >> 16) & 255, y1 = cj >> 24;
    const uint4* m00 = m + (size_t)(y0 * ms + x0) * V;
    const uint4* m01 = m + (size_t)(y0 * ms + x1) * V;
    const uint4* m10 = m + (size_t)(y1 * ms + x0) * V;
    const uint4* m11 = m + (size_t)(y1 * ms + x1) * V;
    uint4* d = o + (size_t)(base + j) * V;
#pragma unroll 2
    for (int v = lane; v < V; v += 32) {
      const uint4 a = load_map(m00 + v, policy);
      const uint4 b = load_map(m01 + v, policy);
      const uint4 c = load_map(m10 + v, policy);
      const uint4 e = load_map(m11 + v, policy);
      uint4 r;
      r.x = bilerp_word<T>(a.x, b.x, c.x, e.x, bx, ax, by, ay);
      r.y = bilerp_word<T>(a.y, b.y, c.y, e.y, bx, ax, by, ay);
      r.z = bilerp_word<T>(a.z, b.z, c.z, e.z, bx, ax, by, ay);
      r.w = bilerp_word<T>(a.w, b.w, c.w, e.w, bx, ax, by, ay);
      __stcs(d + v, r);
    }
  }
}

}  // namespace

// map (ms^2, C) bf16 (f32 == 0) or f32 (f32 == 1), contiguous; t (4, 3)
// f32 on the card, contiguous; p0, p1, p2 (S, A, B) f32 with strides
// s<k><axis> (elements), n = S A B; out (n, C) in the map's type,
// contiguous.  A row must be whole 16-byte vectors and map and out 16-byte
// aligned.  Returns 0 or an error code.
extern "C" int percep_sample(
    const void* map, const void* t, const void* p0, const void* p1,
    const void* p2, void* out, long long n, int C, int ms, long long A,
    long long B, long long s00, long long s01, long long s02, long long s10,
    long long s11, long long s12, long long s20, long long s21,
    long long s22, int f32, void* stream) {
  const int row_bytes = C * (f32 ? 4 : 2);
  if (n <= 0 || C <= 0 || A <= 0 || B <= 0 || ms < 2 || ms > kMaxMap ||
      row_bytes % 16 || (reinterpret_cast<uintptr_t>(map) |
                         reinterpret_cast<uintptr_t>(out)) % 16)
    return -1;
  const long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return -1;
  Queries q;
  q.p[0] = static_cast<const float*>(p0);
  q.p[1] = static_cast<const float*>(p1);
  q.p[2] = static_cast<const float*>(p2);
  const long long s[3][3] = {{s00, s01, s02}, {s10, s11, s12},
                             {s20, s21, s22}};
  for (int k = 0; k < 3; ++k)
    for (int a = 0; a < 3; ++a) q.stride[k][a] = s[k][a];
  q.A = A;
  q.B = B;
  auto st = static_cast<cudaStream_t>(stream);
  const auto* tt = static_cast<const float*>(t);
  const int V = row_bytes / 16;
  if (f32)
    percep_sample_kernel<float><<<(unsigned)blocks, kThreads, 0, st>>>(
        static_cast<const float*>(map), tt, q, static_cast<float*>(out), n,
        V, ms);
  else
    percep_sample_kernel<__nv_bfloat16>
        <<<(unsigned)blocks, kThreads, 0, st>>>(
            static_cast<const __nv_bfloat16*>(map), tt, q,
            static_cast<__nv_bfloat16*>(out), n, V, ms);
  return (int)cudaGetLastError();
}
