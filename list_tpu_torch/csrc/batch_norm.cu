// BatchNorm of a channel-major f32 tensor (B, C, spatial...) with few
// channels and a large extent M = B * D * H * W per channel: the training
// forward (batch statistics, normalize), its backward, and the eval
// forward (running statistics).
//
// Replaces no TPU kernel: the JAX package's BatchNorm is flax's, left to
// XLA.  It replaces cuDNN's SPATIAL-mode kernels (bn_fw_tr_1C11,
// bn_bw_1C11, bn_fw_inf_1C11) on the voxel encoder's volumes of 1, 1, 16
// and 32 channels at 128^3 and 64^3, which parallelise over channels and
// so leave most of the 132 SMs idle at one to 32 channels.
//
// Bound on an H100: memory bytes, a few operations a byte.  The training
// forward reads x twice (statistics, then normalize) and writes y once;
// the backward reads x and dy twice (the sums, then dx) and writes dx
// once.  At batch 8 the voxel encoder's 16-channel 128^3 input is 1.07 GB,
// so 3.2 GB a forward (0.96 ms at 3.35 TB/s) and 5.4 GB a backward
// (1.6 ms).
//
// Design.  Each channel's extent is split over the whole card: block
// (j, c) owns the range [j * chunk, min((j + 1) * chunk, M)) of channel
// c's elements in the order i = b * S + s (S the spatial size), which is
// a few runs of consecutive addresses, one for each b the range crosses.
// The wrapper picks chunk (a multiple of 4 * kThreads) so that C * k
// blocks fill every SM a couple of times.  Where S is a multiple of 4 and
// every base address is 16-byte aligned, threads read and write float4s,
// neighbouring threads on neighbouring 16 bytes, four loads in flight a
// thread; else one float each.
//
//   statistics (bn_stats_f32): bn_stats_partial (per block a Welford
//     partial: count, mean, M2; per thread over float4 groups, merged by
//     Chan's formula through the warps and the block in a fixed order) ->
//     bn_stats_combine (one block a channel: the partials merged in
//     float64 in a fixed order -> mean, biased variance, rstd).
//   normalize (bn_apply_f32): bn_apply (y = (x - mean) * rstd * w + b),
//     after the statistics in a training forward (where the wrapper takes
//     the forward from these kernels rather than from cuDNN: one
//     channel), with the running statistics in eval.
//   backward: bn_grad_partial (per block sum dy and sum dy * (x - mean))
//     -> bn_grad_combine (float64, fixed order: dbias, dweight, and the
//     three coefficients of dx) -> bn_grad_input
//     (dx = w * rstd * (dy - sum dy / M - xhat * sum dy * xhat / M)).
//
// No atomics: two runs on the same input are bit-identical.  Plain f32
// arithmetic in the passes over the data, float64 in the combines.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;  // float4 loads in flight a thread
constexpr unsigned kFull = 0xffffffffu;

// Calls f(offset, n) for each run [offset, offset + n) of the flat tensor
// that holds channel c's elements [lo, hi) in the order i = b * S + s.
template <class F>
__device__ __forceinline__ void walk(long long lo, long long hi, long long S,
                                     int C, int c, F f) {
  while (lo < hi) {
    const long long b = lo / S;
    const long long s = lo - b * S;
    const long long n = min(hi - lo, S - s);
    f((b * C + c) * S + s, n);
    lo += n;
  }
}

// Chan's merge of (nb, mb, qb) into (n, m, q): counts, means, centred sums
// of squares.  An empty side leaves the other unchanged.
__device__ __forceinline__ void merge(float& n, float& m, float& q, float nb,
                                      float mb, float qb) {
  if (nb == 0.f) return;
  const float nt = n + nb;
  const float d = mb - m;
  const float r = __fdividef(nb, nt);
  m = fmaf(d, r, m);
  q = q + qb + d * d * n * r;
  n = nt;
}

__device__ __forceinline__ void merge4(float& n, float& m, float& q,
                                       float4 v) {
  const float g = ((v.x + v.y) + (v.z + v.w)) * 0.25f;
  const float a = v.x - g, b = v.y - g, c = v.z - g, d = v.w - g;
  merge(n, m, q, 4.f, g, fmaf(a, a, fmaf(b, b, fmaf(c, c, d * d))));
}

__device__ __forceinline__ float4 load4(const float* p, long long v) {
  return reinterpret_cast<const float4*>(p)[v];
}

__device__ __forceinline__ void store4(float* p, long long v, float4 x) {
  reinterpret_cast<float4*>(p)[v] = x;
}

// Block (j, c): the Welford partial of its range -> part[(c * k + j) * 2]
// (mean, M2); its count follows from (j, chunk, M).  Counts are held as
// floats: a block's are at most chunk, which the wrapper keeps exact.
__global__ void __launch_bounds__(kThreads)
bn_stats_partial(const float* __restrict__ x, float* __restrict__ part,
                 int C, long long S, long long M, long long chunk, int vec) {
  const int j = blockIdx.x, c = blockIdx.y, t = threadIdx.x;
  const int k = gridDim.x;
  const long long lo = j * chunk, hi = min(lo + chunk, M);
  float n = 0.f, m = 0.f, q = 0.f;
  walk(lo, hi, S, C, c, [&](long long off, long long len) {
    const float* p = x + off;
    if (vec) {
      const long long nv = len / 4;
      long long v = t;
      for (; v + (kUnroll - 1) * kThreads < nv; v += kUnroll * kThreads) {
        float4 r[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) r[u] = load4(p, v + u * kThreads);
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) merge4(n, m, q, r[u]);
      }
      for (; v < nv; v += kThreads) merge4(n, m, q, load4(p, v));
    } else {
      for (long long i = t; i < len; i += kThreads)
        merge(n, m, q, 1.f, p[i], 0.f);
    }
  });
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float nb = __shfl_down_sync(kFull, n, o);
    const float mb = __shfl_down_sync(kFull, m, o);
    const float qb = __shfl_down_sync(kFull, q, o);
    merge(n, m, q, nb, mb, qb);
  }
  __shared__ float sn[kWarps], sm[kWarps], sq[kWarps];
  if ((t & 31) == 0) {
    sn[t >> 5] = n;
    sm[t >> 5] = m;
    sq[t >> 5] = q;
  }
  __syncthreads();
  if (t == 0) {
    for (int w = 1; w < kWarps; ++w) merge(n, m, q, sn[w], sm[w], sq[w]);
    float* o = part + ((long long)c * k + j) * 2;
    o[0] = m;
    o[1] = q;
  }
}

__device__ __forceinline__ void merge_d(double& n, double& m, double& q,
                                        double nb, double mb, double qb) {
  if (nb == 0.0) return;
  const double nt = n + nb;
  const double d = mb - m;
  const double r = nb / nt;
  m += d * r;
  q += qb + d * d * n * r;
  n = nt;
}

// One block a channel: the k partials merged in float64, thread t taking
// j = t, t + kThreads, ..., then a tree over the threads in a fixed order.
__global__ void __launch_bounds__(kThreads)
bn_stats_combine(const float* __restrict__ part, int k, long long M,
                 long long chunk, float eps, float* __restrict__ mean,
                 float* __restrict__ var, float* __restrict__ rstd) {
  const int c = blockIdx.x, t = threadIdx.x;
  double n = 0.0, m = 0.0, q = 0.0;
  for (int j = t; j < k; j += kThreads) {
    const float* p = part + ((long long)c * k + j) * 2;
    merge_d(n, m, q, (double)min(chunk, M - j * chunk), p[0], p[1]);
  }
  __shared__ double sn[kThreads], sm[kThreads], sq[kThreads];
  sn[t] = n;
  sm[t] = m;
  sq[t] = q;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (t < s) {
      merge_d(n, m, q, sn[t + s], sm[t + s], sq[t + s]);
      sn[t] = n;
      sm[t] = m;
      sq[t] = q;
    }
    __syncthreads();
  }
  if (t == 0) {
    const double v = q / (double)M;
    mean[c] = (float)m;
    var[c] = (float)v;
    rstd[c] = (float)(1.0 / sqrt(v + (double)eps));
  }
}

// y = (x - mean) * (w * rstd) + b.  In eval (stat = var) rstd comes from
// the running variance; else stat is the batch's rstd.
__global__ void __launch_bounds__(kThreads)
bn_apply(const float* __restrict__ x, float* __restrict__ y,
         const float* __restrict__ mean, const float* __restrict__ stat,
         const float* __restrict__ w, const float* __restrict__ b, int C,
         long long S, long long M, long long chunk, int vec, int eval,
         float eps) {
  const int j = blockIdx.x, c = blockIdx.y, t = threadIdx.x;
  const float mu = mean[c];
  const float r = eval ? (float)(1.0 / sqrt((double)stat[c] + (double)eps))
                       : stat[c];
  const float sc = w[c] * r, sh = b[c];
  const long long lo = j * chunk, hi = min(lo + chunk, M);
  walk(lo, hi, S, C, c, [&](long long off, long long len) {
    const float* p = x + off;
    float* o = y + off;
    if (vec) {
      const long long nv = len / 4;
      long long v = t;
      for (; v + (kUnroll - 1) * kThreads < nv; v += kUnroll * kThreads) {
        float4 r4[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) r4[u] = load4(p, v + u * kThreads);
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const float4 a = r4[u];
          store4(o, v + u * kThreads,
                 make_float4(fmaf(a.x - mu, sc, sh), fmaf(a.y - mu, sc, sh),
                             fmaf(a.z - mu, sc, sh), fmaf(a.w - mu, sc, sh)));
        }
      }
      for (; v < nv; v += kThreads) {
        const float4 a = load4(p, v);
        store4(o, v,
               make_float4(fmaf(a.x - mu, sc, sh), fmaf(a.y - mu, sc, sh),
                           fmaf(a.z - mu, sc, sh), fmaf(a.w - mu, sc, sh)));
      }
    } else {
      for (long long i = t; i < len; i += kThreads)
        o[i] = fmaf(p[i] - mu, sc, sh);
    }
  });
}

__device__ __forceinline__ void grad4(float& sg, float& sgx, float4 g,
                                      float4 a, float mu) {
  sg += (g.x + g.y) + (g.z + g.w);
  sgx = fmaf(g.x, a.x - mu, sgx);
  sgx = fmaf(g.y, a.y - mu, sgx);
  sgx = fmaf(g.z, a.z - mu, sgx);
  sgx = fmaf(g.w, a.w - mu, sgx);
}

// Block (j, c): sum dy and sum dy * (x - mean) over its range ->
// part[(c * k + j) * 2].
__global__ void __launch_bounds__(kThreads)
bn_grad_partial(const float* __restrict__ x, const float* __restrict__ dy,
                const float* __restrict__ mean, float* __restrict__ part,
                int C, long long S, long long M, long long chunk, int vec) {
  const int j = blockIdx.x, c = blockIdx.y, t = threadIdx.x;
  const int k = gridDim.x;
  const float mu = mean[c];
  const long long lo = j * chunk, hi = min(lo + chunk, M);
  float sg = 0.f, sgx = 0.f;
  walk(lo, hi, S, C, c, [&](long long off, long long len) {
    const float* p = x + off;
    const float* g = dy + off;
    if (vec) {
      const long long nv = len / 4;
      long long v = t;
      for (; v + (kUnroll - 1) * kThreads < nv; v += kUnroll * kThreads) {
        float4 a[kUnroll], d[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          a[u] = load4(p, v + u * kThreads);
          d[u] = load4(g, v + u * kThreads);
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) grad4(sg, sgx, d[u], a[u], mu);
      }
      for (; v < nv; v += kThreads) grad4(sg, sgx, load4(g, v), load4(p, v), mu);
    } else {
      for (long long i = t; i < len; i += kThreads) {
        sg += g[i];
        sgx = fmaf(g[i], p[i] - mu, sgx);
      }
    }
  });
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    sg += __shfl_down_sync(kFull, sg, o);
    sgx += __shfl_down_sync(kFull, sgx, o);
  }
  __shared__ float s0[kWarps], s1[kWarps];
  if ((t & 31) == 0) {
    s0[t >> 5] = sg;
    s1[t >> 5] = sgx;
  }
  __syncthreads();
  if (t == 0) {
    for (int w = 1; w < kWarps; ++w) {
      sg += s0[w];
      sgx += s1[w];
    }
    float* o = part + ((long long)c * k + j) * 2;
    o[0] = sg;
    o[1] = sgx;
  }
}

// One block a channel: the k partials summed in float64 in a fixed order
// -> dbias = sum dy, dweight = rstd * sum dy * (x - mean), and
// coef[c] = (a, c1, c0) with dx = a * dy + c1 * (x - mean) + c0.
__global__ void __launch_bounds__(kThreads)
bn_grad_combine(const float* __restrict__ part, int k, long long M,
                const float* __restrict__ w, const float* __restrict__ rstd,
                float* __restrict__ dw, float* __restrict__ db,
                float* __restrict__ coef) {
  const int c = blockIdx.x, t = threadIdx.x;
  double sg = 0.0, sgx = 0.0;
  for (int j = t; j < k; j += kThreads) {
    const float* p = part + ((long long)c * k + j) * 2;
    sg += p[0];
    sgx += p[1];
  }
  __shared__ double s0[kThreads], s1[kThreads];
  s0[t] = sg;
  s1[t] = sgx;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (t < s) {
      s0[t] += s0[t + s];
      s1[t] += s1[t + s];
    }
    __syncthreads();
  }
  if (t == 0) {
    const double r = rstd[c];
    const double gw = s1[0] * r;  // sum dy * xhat
    const double a = (double)w[c] * r;
    db[c] = (float)s0[0];
    dw[c] = (float)gw;
    coef[3 * c] = (float)a;
    coef[3 * c + 1] = (float)(-a * r * gw / (double)M);
    coef[3 * c + 2] = (float)(-a * s0[0] / (double)M);
  }
}

__global__ void __launch_bounds__(kThreads)
bn_grad_input(const float* __restrict__ x, const float* __restrict__ dy,
              const float* __restrict__ mean, const float* __restrict__ coef,
              float* __restrict__ dx, int C, long long S, long long M,
              long long chunk, int vec) {
  const int j = blockIdx.x, c = blockIdx.y, t = threadIdx.x;
  const float mu = mean[c];
  const float a = coef[3 * c], c1 = coef[3 * c + 1], c0 = coef[3 * c + 2];
  const long long lo = j * chunk, hi = min(lo + chunk, M);
  walk(lo, hi, S, C, c, [&](long long off, long long len) {
    const float* p = x + off;
    const float* g = dy + off;
    float* o = dx + off;
    if (vec) {
      const long long nv = len / 4;
      for (long long v = t; v < nv; v += kThreads) {
        const float4 xa = load4(p, v), ga = load4(g, v);
        store4(o, v, make_float4(fmaf(a, ga.x, fmaf(c1, xa.x - mu, c0)),
                                 fmaf(a, ga.y, fmaf(c1, xa.y - mu, c0)),
                                 fmaf(a, ga.z, fmaf(c1, xa.z - mu, c0)),
                                 fmaf(a, ga.w, fmaf(c1, xa.w - mu, c0))));
      }
    } else {
      for (long long i = t; i < len; i += kThreads)
        o[i] = fmaf(a, g[i], fmaf(c1, p[i] - mu, c0));
    }
  });
}

bool geometry_ok(int C, long long S, long long M, int k, long long chunk) {
  return C >= 1 && C <= 65535 && S >= 1 && M >= 1 && M % S == 0 && k >= 1 &&
         chunk >= 1 && chunk <= (1LL << 24) &&
         (long long)(k - 1) * chunk < M && (long long)k * chunk >= M;
}

}  // namespace

// Each entry returns 0 on success, a cudaError_t code from a launch, or -1
// for arguments the kernels do not take: 1 <= C <= 65535, M a multiple of S,
// k = ceil(M / chunk) blocks a channel of at most 2^24 elements each, and
// vec (float4 access) only where S and chunk are multiples of 4.  The
// scratch `part` holds C * k * 2 floats, `coef` C * 3.

// The batch statistics of x: mean, biased variance and rstd a channel.
extern "C" int bn_stats_f32(const void* x, void* mean, void* var, void* rstd,
                            void* part, int C, long long S, long long M,
                            int k, long long chunk, int vec, float eps,
                            void* stream) {
  if (!geometry_ok(C, S, M, k, chunk) || (vec && (S % 4 || chunk % 4)))
    return -1;
  auto st = static_cast<cudaStream_t>(stream);
  bn_stats_partial<<<dim3(k, C), kThreads, 0, st>>>(
      static_cast<const float*>(x), static_cast<float*>(part), C, S, M, chunk,
      vec);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  bn_stats_combine<<<C, kThreads, 0, st>>>(
      static_cast<const float*>(part), k, M, chunk, eps,
      static_cast<float*>(mean), static_cast<float*>(var),
      static_cast<float*>(rstd));
  return (int)cudaGetLastError();
}

// y = (x - mean) * w * rstd + b; with eval, stat is the running variance
// and rstd comes from it, else stat is rstd.
extern "C" int bn_apply_f32(const void* x, void* y, const void* mean,
                            const void* stat, const void* w, const void* b,
                            int C, long long S, long long M, int k,
                            long long chunk, int vec, int eval, float eps,
                            void* stream) {
  if (!geometry_ok(C, S, M, k, chunk) || (vec && (S % 4 || chunk % 4)))
    return -1;
  bn_apply<<<dim3(k, C), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(y),
      static_cast<const float*>(mean), static_cast<const float*>(stat),
      static_cast<const float*>(w), static_cast<const float*>(b), C, S, M,
      chunk, vec, eval, eps);
  return (int)cudaGetLastError();
}

// dx may be null (the input needs no gradient): then only dweight and
// dbias are computed.
extern "C" int bn_backward_f32(const void* x, const void* dy, const void* w,
                               const void* mean, const void* rstd, void* dx,
                               void* dw, void* db, void* part, void* coef,
                               int C, long long S, long long M, int k,
                               long long chunk, int vec, void* stream) {
  if (!geometry_ok(C, S, M, k, chunk) || (vec && (S % 4 || chunk % 4)))
    return -1;
  auto st = static_cast<cudaStream_t>(stream);
  const dim3 grid(k, C);
  bn_grad_partial<<<grid, kThreads, 0, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(dy),
      static_cast<const float*>(mean), static_cast<float*>(part), C, S, M,
      chunk, vec);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  bn_grad_combine<<<C, kThreads, 0, st>>>(
      static_cast<const float*>(part), k, M, static_cast<const float*>(w),
      static_cast<const float*>(rstd), static_cast<float*>(dw),
      static_cast<float*>(db), static_cast<float*>(coef));
  e = cudaGetLastError();
  if (e != cudaSuccess || dx == nullptr) return (int)e;
  bn_grad_input<<<grid, kThreads, 0, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(dy),
      static_cast<const float*>(mean), static_cast<const float*>(coef),
      static_cast<float*>(dx), C, S, M, chunk, vec);
  return (int)cudaGetLastError();
}
