// The dense decode's voxel work: separable trilinear resampling of
// channels-last bf16 volumes at the regular query grid, with taps.  Each
// output row is one query (x, y, z) of the grid (x in [x0, x0 + nx), y < ny,
// z < nz, row ((x - x0) ny + y) nz + z); each segment of a row, C channels at
// a column offset of an output tensor, is the sum of its groups; a group
// is the border-clamped linear resample along x, by its own x plan, of the
// sum of its members; a member is one volume (r_x, r_y, r_z, >= C) resampled
// along y and z by its own plans.  A plan is a static per-axis table
// (i0, i1, w) of the output index (ops/dense_grid.py's _axis_plan), one for
// each shift -, 0, + of a source resolution.  ops/dense_grid.py launches it
// for each kept group (seven segments, one a tap, each one member: the
// structured parts [A5 | Ax- | Ax+] or a t-major (7, n, C) stack) and once
// for the coarse term (one segment, three groups a projected scale: the
// center with taps 0-4 as its members, x+ with tap 6, x- with tap 5).
//
// Replaces no TPU kernel: the JAX package leaves this work to XLA
// (list_tpu/ops/dense_grid.py:563-605).  It replaces the port's plain
// PyTorch passes (ops/cuda/voxel.py): index_select gathers and bf16 lerps
// along z and y into five tap variants of each group, their concatenation,
// an f32 banded x-lerp product and a cast back; for the coarse term the
// z/y fold of the projected taps into (r, R, R, 512) volumes, their
// concatenation and an f32 product of 128 x 72 x 8.4M, cast to bf16.
//
// Bound on an H100: memory bytes, a few operations a byte.  At a 128^3 slab
// the only traffic is the rows K1 reads, 2,097,152 x 791 bf16 (3.318 GB) and
// 2,097,152 x 512 (2.147 GB), and the volumes read once (71.3 + 16.8 + 4.2 MB
// and 33.0 MB of projected coarse taps): 5.59 GB, 1.67 ms at 3.35 TB/s.
//
// Design.  Writes are 98% of the bytes.  A thread owns VEC channels (4,
// 8 bytes of bf16, where every row, offset and pointer allows; else 1) of
// one (y, z) and walks kXRun consecutive x rows; a warp's lanes store
// neighbouring channels of 4 neighbouring z (whole 32-byte sectors), with
// evict-first stores (st.global.cs), so the volumes stay in L2.  Along x
// the thread keeps in registers each group's two source planes i0, i1,
// each the f32 sum of its members' y/z bilinears: the coarse term's
// (r, R, R, 512) fold never exists in device memory, and a plane is
// computed once a walk and reused by every x row whose lerp reads it (8
// and 16 rows at 16^3 and 8^3).  The rows' x plans (keyed i0 | i1 << 16,
// with w and 1 - w) and each member's corner offsets and weights at the
// block's positions are tables in shared memory, built once a block, so a
// row whose planes stay is one broadcast load, a compare and two FMAs a
// channel a group.  A segment's groups add in registers in a fixed order
// (no atomics) and each output element is rounded to bf16 once, at its
// store.  Blocks walk x slowest, so the volumes' x band in flight stays
// in L2 (the 128^3 x 17 group, 71 MB, does not fit the 50 MB L2; a band of
// it does).  A zero weight reads its first corner twice, an L1 hit, so a
// bilinear's four loads issue together.
//
// Measured (chip_smoke.py's voxel phase; PERF.md section 6): the walk is
// bound by the latency of its dependent steps and by 128 registers a
// thread, not by bytes.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kXRun = 64;   // x rows a thread walks
constexpr int kLanes = 8;   // lanes of a position: 4-channel vectors
constexpr int kMaxMembers = 48;
constexpr int kMaxGroups = 24;
constexpr int kMaxSegs = 8;
constexpr int kMaxSmem = 96 * 1024;

}  // namespace

// The layouts below are ops/cuda/voxel.py's ctypes structures.
struct VtMember {
  const void* in;    // bf16 volume, channels contiguous, < 2^31 elements
  int sx, sy, sz;    // element strides of its x, y and z axes
  int yplan, zplan;  // rows of the plan table for y and z
};
struct VtGroup {
  int xplan;   // row of the plan table for x
  int m0, m1;  // its members [m0, m1)
  int seg;     // the segment it adds into (a segment's groups adjacent)
};
struct VtSeg {
  void* out;              // bf16 or f32 rows
  long long stride, off;  // row stride and column offset, in elements
};
struct VtLaunch {
  VtMember m[kMaxMembers];
  VtGroup g[kMaxGroups];
  VtSeg s[kMaxSegs];
  const int* plans;  // (n_plans, R, 2) int32: i0 | i1 << 16, bits of w
  int R, n_plans, ng, nm, C;
  int x0, nx, ny, nz;
};

namespace {

// the block's tiling of (x run, (y, z) position, channel vector)
struct Tiling {
  int NV;       // channel vectors a row segment (C / VEC)
  int TV;       // lanes a position
  int TP;       // consecutive (y, z) positions a block (kThreads / TV)
  int nchunks;  // channel chunks of TV vectors (ceil(NV / TV))
  long long npos, ntiles;
  int smem;     // bytes of the block's plan tables
};

struct PlanAt {
  int i0, i1;
  float w;
};

__device__ __forceinline__ PlanAt unpack(int2 e) {
  return {e.x & 0xffff, (int)((unsigned)e.x >> 16), __int_as_float(e.y)};
}

__device__ __forceinline__ int2 plan_at(const VtLaunch& p, int plan, int i) {
  return __ldg(reinterpret_cast<const int2*>(p.plans) + plan * p.R + i);
}

__device__ __forceinline__ float lo(unsigned w) {
  return __uint_as_float(w << 16);
}

__device__ __forceinline__ float hi(unsigned w) {
  return __uint_as_float(w & 0xffff0000u);
}

template <int VEC>
__device__ __forceinline__ void load(const __nv_bfloat16* p, float (&f)[VEC]);

template <>
__device__ __forceinline__ void load<4>(const __nv_bfloat16* p,
                                        float (&f)[4]) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  f[0] = lo(u.x);
  f[1] = hi(u.x);
  f[2] = lo(u.y);
  f[3] = hi(u.y);
}

template <>
__device__ __forceinline__ void load<1>(const __nv_bfloat16* p,
                                        float (&f)[1]) {
  f[0] = __uint_as_float(
      (unsigned)__ldg(reinterpret_cast<const unsigned short*>(p)) << 16);
}

template <int VEC>
__device__ __forceinline__ void lerp(float (&t)[VEC], const float (&u)[VEC],
                                     float w) {
  const float a = 1.f - w;
#pragma unroll
  for (int k = 0; k < VEC; ++k) t[k] = fmaf(w, u[k], a * t[k]);
}

// The block's tables in shared memory: for each member and each of the
// block's positions its four y/z corner offsets (a zero weight's second
// corner is its first: the lerp then leaves the first exact) and (wy,
// wz); for each group and each row of the block's x run its x plan entry.
struct Tables {
  int4* off;    // [nm][TP]
  float2* w;    // [nm][TP]
  int4* xplan;  // [ng][kXRun]: (key, w, 1 - w, 0)
};

__device__ __forceinline__ Tables tables(void* smem, const VtLaunch& p,
                                         int TP) {
  Tables tb;
  tb.off = static_cast<int4*>(smem);
  tb.xplan = tb.off + p.nm * TP;
  tb.w = reinterpret_cast<float2*>(tb.xplan + p.ng * kXRun);
  return tb;
}

template <int VEC>
struct Vec {
  float v[VEC];
};

// source plane j of members [m0, m1) at the thread's position q, channels
// [c, c + VEC): the sum of their y/z bilinears, in member order
template <int VEC>
__device__ __forceinline__ Vec<VEC> plane(const VtLaunch& p, const Tables& tb, int TP, int m0, int m1,
               int j, int q, int c) {
  Vec<VEC> f;
#pragma unroll
  for (int k = 0; k < VEC; ++k) f.v[k] = 0.f;
  for (int mi = m0; mi < m1; ++mi) {
    const VtMember& m = p.m[mi];
    const int4 o = tb.off[mi * TP + q];
    const float2 w = tb.w[mi * TP + q];
    const __nv_bfloat16* base =
        static_cast<const __nv_bfloat16*>(m.in) + (j * m.sx + c);
    float c00[VEC], c01[VEC], c10[VEC], c11[VEC];
    load<VEC>(base + o.x, c00);
    load<VEC>(base + o.y, c01);
    load<VEC>(base + o.z, c10);
    load<VEC>(base + o.w, c11);
    lerp<VEC>(c00, c01, w.y);
    lerp<VEC>(c10, c11, w.y);
    lerp<VEC>(c00, c10, w.x);
#pragma unroll
    for (int k = 0; k < VEC; ++k) f.v[k] += c00[k];
  }
  return f;
}

template <int VEC, typename OutT>
__device__ __forceinline__ void store(OutT* p, const float (&a)[VEC]);

template <>
__device__ __forceinline__ void store<4, __nv_bfloat16>(__nv_bfloat16* p,
                                                        const float (&a)[4]) {
  const __nv_bfloat162 h0 = __floats2bfloat162_rn(a[0], a[1]);
  const __nv_bfloat162 h1 = __floats2bfloat162_rn(a[2], a[3]);
  uint2 u;
  u.x = *reinterpret_cast<const unsigned*>(&h0);
  u.y = *reinterpret_cast<const unsigned*>(&h1);
  __stcs(reinterpret_cast<uint2*>(p), u);
}

template <>
__device__ __forceinline__ void store<1, __nv_bfloat16>(__nv_bfloat16* p,
                                                        const float (&a)[1]) {
  *p = __float2bfloat16_rn(a[0]);
}

template <>
__device__ __forceinline__ void store<4, float>(float* p,
                                                const float (&a)[4]) {
  __stcs(reinterpret_cast<float4*>(p), make_float4(a[0], a[1], a[2], a[3]));
}

template <>
__device__ __forceinline__ void store<1, float>(float* p,
                                                const float (&a)[1]) {
  *p = a[0];
}

// one group's contribution at a row: the x lerp (entry e: key i0 | i1 <<
// 16 of its source planes, w, 1 - w) of its planes fa (i0) and fb (i1),
// kept while the key stays; a key that changes takes each plane from the
// other slot or computes it (a zero weight's i1 is i0: fb = fa)
template <int VEC>
__device__ __forceinline__ void step(const VtLaunch& p, const Tables& tb,
                                     int TP, const VtGroup& g, int4 e, int q,
                                     int c, int& key, float (&fa)[VEC],
                                     float (&fb)[VEC], float (&acc)[VEC]) {
  if (e.x != key) {
    const int ja = key & 0xffff, jb = (int)((unsigned)key >> 16);
    const int i0 = e.x & 0xffff, i1 = (int)((unsigned)e.x >> 16);
    if (i0 == jb) {
#pragma unroll
      for (int k = 0; k < VEC; ++k) fa[k] = fb[k];
    } else if (i0 != ja) {
      const Vec<VEC> f = plane<VEC>(p, tb, TP, g.m0, g.m1, i0, q, c);
#pragma unroll
      for (int k = 0; k < VEC; ++k) fa[k] = f.v[k];
    }
    if (i1 == i0) {
#pragma unroll
      for (int k = 0; k < VEC; ++k) fb[k] = fa[k];
    } else if (i1 != jb) {
      const Vec<VEC> f = plane<VEC>(p, tb, TP, g.m0, g.m1, i1, q, c);
#pragma unroll
      for (int k = 0; k < VEC; ++k) fb[k] = f.v[k];
    }
    key = e.x;
  }
  const float w = __int_as_float(e.y), a = __int_as_float(e.z);
#pragma unroll
  for (int k = 0; k < VEC; ++k) acc[k] = fmaf(w, fb[k], fmaf(a, fa[k], acc[k]));
}

// after group gi: its segment's sum stored and cleared, if gi is the
// segment's last group
template <int VEC, typename OutT>
__device__ __forceinline__ void close(const VtLaunch& p, int gi,
                                      long long row, int c,
                                      float (&acc)[VEC]) {
  const int seg = p.g[gi].seg;
  if (gi + 1 < p.ng && p.g[gi + 1].seg == seg) return;
  const VtSeg& s = p.s[seg];
  store<VEC, OutT>(static_cast<OutT*>(s.out) + (row * s.stride + s.off + c),
                   acc);
#pragma unroll
  for (int k = 0; k < VEC; ++k) acc[k] = 0.f;
}

// NC: the groups whose two source planes a thread keeps in registers (6
// for the coarse term, 7 for a kept group's taps); later groups compute
// both planes at every row.  Single channels fit 80 registers, three
// blocks an SM; vectors take 128, two blocks (fewer spill).
template <int VEC, typename OutT, int NC>
__global__ void __launch_bounds__(kThreads, VEC == 1 ? 3 : 2)
    voxel_taps_kernel(const __grid_constant__ VtLaunch p, const Tiling t) {
  extern __shared__ int4 smem[];
  long long b = blockIdx.x;
  const int chunk = (int)(b % t.nchunks);
  b /= t.nchunks;
  const long long tile = b % t.ntiles;
  const int xr = (int)(b / t.ntiles);
  const long long pos0 = tile * t.TP;
  const int xb = p.x0 + xr * kXRun;
  const int xe = min(xb + kXRun, p.x0 + p.nx);

  // the block's tables (positions past the grid take its last one)
  const Tables tb = tables(smem, p, t.TP);
  for (int e = threadIdx.x; e < p.nm * t.TP; e += kThreads) {
    const int mi = e / t.TP;
    const long long pos = min(pos0 + e % t.TP, t.npos - 1);
    const int y = (int)(pos / p.nz), z = (int)(pos % p.nz);
    const VtMember& m = p.m[mi];
    const PlanAt py = unpack(plan_at(p, m.yplan, y));
    const PlanAt pz = unpack(plan_at(p, m.zplan, z));
    const int y0 = py.i0 * m.sy, y1 = (py.w != 0.f ? py.i1 : py.i0) * m.sy;
    const int z0 = pz.i0 * m.sz, z1 = (pz.w != 0.f ? pz.i1 : pz.i0) * m.sz;
    tb.off[e] = make_int4(y0 + z0, y0 + z1, y1 + z0, y1 + z1);
    tb.w[e] = make_float2(py.w, pz.w);
  }
  for (int e = threadIdx.x; e < p.ng * kXRun; e += kThreads) {
    const int x = min(xb + e % kXRun, xe - 1);
    const PlanAt px = unpack(plan_at(p, p.g[e / kXRun].xplan, x));
    const int i1 = px.w != 0.f ? px.i1 : px.i0;
    tb.xplan[e] = make_int4(px.i0 | i1 << 16, __float_as_int(px.w),
                            __float_as_int(1.f - px.w), 0);
  }
  __syncthreads();

  const int q = threadIdx.x / t.TV;
  const int v = chunk * t.TV + (int)(threadIdx.x % t.TV);
  if (q >= t.TP || v >= t.NV || pos0 + q >= t.npos) return;
  const long long pos = pos0 + q;
  const int c = v * VEC;

  // the first NC groups' planes and their keys (-1: none yet)
  int key[NC];
  float fa[NC][VEC], fb[NC][VEC];
#pragma unroll
  for (int g = 0; g < NC; ++g) key[g] = -1;
  float acc[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) acc[k] = 0.f;

  for (int x = xb; x < xe; ++x) {
    const long long row = (long long)(x - p.x0) * t.npos + pos;
    int4 e[NC];
#pragma unroll
    for (int g = 0; g < NC; ++g)
      if (g < p.ng) e[g] = tb.xplan[g * kXRun + (x - xb)];
#pragma unroll
    for (int g = 0; g < NC; ++g) {
      if (g < p.ng) {
        step<VEC>(p, tb, t.TP, p.g[g], e[g], q, c, key[g], fa[g], fb[g],
                  acc);
        close<VEC, OutT>(p, g, row, c, acc);
      }
    }
    // groups past the cache: both planes computed at every row
    for (int g = NC; g < p.ng; ++g) {
      int k1 = -1;
      float f0[VEC], f1[VEC];
      step<VEC>(p, tb, t.TP, p.g[g], tb.xplan[g * kXRun + (x - xb)], q, c,
                k1, f0, f1, acc);
      close<VEC, OutT>(p, g, row, c, acc);
    }
  }
}

template <int VEC, typename OutT>
int run(const VtLaunch& p, const Tiling& t, long long blocks,
        cudaStream_t st) {
  auto kernel = p.ng <= 6 ? voxel_taps_kernel<VEC, OutT, 6>
                          : voxel_taps_kernel<VEC, OutT, 7>;
  if (t.smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, t.smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<(unsigned)blocks, kThreads, t.smem, st>>>(p, t);
  return (int)cudaGetLastError();
}

bool aligned(const void* ptr, long long off_bytes, int nbytes) {
  return (reinterpret_cast<uintptr_t>(ptr) + (uintptr_t)off_bytes) %
             (uintptr_t)nbytes == 0;
}

}  // namespace

// One launch over *launch (its members, groups and segments as above);
// out_f32: the segments are f32 (1) or bf16 (0).  Members read bf16 with
// contiguous channels; every plan row indexes a member's own axes.  *vec
// (when not null) gets the channels a thread took: 4 where C, every stride
// and offset are multiples of 4 and every pointer is aligned to 4 elements,
// else 1.  Returns 0 or an error code (-1: operands the kernel does not
// take).
extern "C" int voxel_taps(const VtLaunch* launch, int out_f32, int* vec,
                          void* stream) {
  const VtLaunch& p = *launch;
  if (p.ng < 1 || p.ng > kMaxGroups || p.nm < 1 || p.nm > kMaxMembers ||
      p.C < 1 || p.R < 1 || p.R > 0xffff || p.nx < 1 || p.ny < 1 ||
      p.nz < 1 || p.x0 < 0 || p.x0 + p.nx > p.R || p.ny > p.R ||
      p.nz > p.R || p.n_plans < 1 || p.plans == nullptr)
    return -1;
  for (int gi = 0; gi < p.ng; ++gi) {
    const VtGroup& g = p.g[gi];
    if (g.m0 < 0 || g.m1 <= g.m0 || g.m1 > p.nm || g.seg < 0 ||
        g.seg >= kMaxSegs || g.xplan < 0 || g.xplan >= p.n_plans ||
        p.s[g.seg].out == nullptr)
      return -1;
    // a segment's groups are adjacent: it is stored once
    for (int gj = 0; gj + 1 < gi; ++gj)
      if (p.g[gj].seg == g.seg && p.g[gj + 1].seg != g.seg) return -1;
  }
  for (int mi = 0; mi < p.nm; ++mi) {
    const VtMember& m = p.m[mi];
    if (m.in == nullptr || m.yplan < 0 || m.yplan >= p.n_plans ||
        m.zplan < 0 || m.zplan >= p.n_plans)
      return -1;
  }
  const int elem = out_f32 ? 4 : 2;
  // 4 channels a thread where every row, stride, offset and pointer is a
  // whole number of 4-channel vectors
  bool vec4 = p.C % 4 == 0;
  for (int mi = 0; mi < p.nm; ++mi) {
    const VtMember& m = p.m[mi];
    vec4 = vec4 && aligned(m.in, 0, 8) && m.sx % 4 == 0 && m.sy % 4 == 0 &&
           m.sz % 4 == 0;
  }
  for (int gi = 0; gi < p.ng; ++gi) {
    const VtSeg& s = p.s[p.g[gi].seg];
    vec4 = vec4 && aligned(s.out, s.off * elem, 4 * elem) &&
           s.stride % 4 == 0;
  }
  const int VEC = vec4 ? 4 : 1;
  if (vec != nullptr) *vec = VEC;
  // lanes of a position: kLanes 4-channel vectors (64 bytes of a bf16
  // row), so a warp holds 4 neighbouring z and reads their shared corners
  // once; single channels a row's whole segment (up to 32)
  const int lanes = vec4 ? kLanes : 32;
  Tiling t;
  t.NV = p.C / VEC;
  t.TV = t.NV < lanes ? t.NV : lanes;
  t.TP = kThreads / t.TV;
  t.nchunks = (t.NV + t.TV - 1) / t.TV;
  t.npos = (long long)p.ny * p.nz;
  t.ntiles = (t.npos + t.TP - 1) / t.TP;
  const long long smem = (long long)p.nm * t.TP * (16 + 8) +
                         (long long)p.ng * kXRun * 16;
  if (smem > kMaxSmem) return -1;
  t.smem = (int)smem;
  const long long xruns = (p.nx + kXRun - 1) / kXRun;
  const long long blocks = xruns * t.ntiles * t.nchunks;
  if (blocks > 0x7fffffffLL) return -1;
  auto st = static_cast<cudaStream_t>(stream);
  if (out_f32)
    return vec4 ? run<4, float>(p, t, blocks, st)
                : run<1, float>(p, t, blocks, st);
  return vec4 ? run<4, __nv_bfloat16>(p, t, blocks, st)
              : run<1, __nv_bfloat16>(p, t, blocks, st);
}
