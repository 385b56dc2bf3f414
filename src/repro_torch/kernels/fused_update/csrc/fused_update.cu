// Fused server-update kernels for Hopper (sm_90a): the CUDA counterparts of
// the three forward Pallas kernels in src/repro/kernels/fused_update/kernel.py.
//
// All three are streaming passes over flat fp32 buffers of shape
// (rows, 128), rows a multiple of 8, so every buffer holds a multiple of
// 1024 floats and is read and written as float4 (16 bytes a thread,
// neighbouring threads on neighbouring addresses).  They do a handful of
// flops per 4-byte element, far below the card's ~20 flops/byte fp32
// balance point, so each is bound by device-memory bytes: the design goal
// is one read of every input and one write of every output, nothing more.
//
//   aggregate_pass   G = sum_k w_k g_k over a (cohort, rows, 128) stack, and
//                    ssq = ||G||^2.  One thread per float4 of a row tile,
//                    looping over the cohort; ssq as per-block partials
//                    (double) reduced by a second single-block kernel in a
//                    fixed order.  The Pallas kernel carries ssq across its
//                    grid steps, which only works because a TPU grid runs in
//                    order; here blocks run in any order, so there are no
//                    atomics and ssq is bitwise equal from run to run.
//   accumulate_pass  out = acc + w * g (the scan cohort's streaming term);
//                    out may alias acc.
//   update_pass      clip scale + sgd/sgdm/adam/yogi + writes p, m, v: one
//                    template instance per optimizer.  [scale, lr, bc1, bc2]
//                    and the client weights are read from device pointers,
//                    so the host never waits for the device to learn them.
//
// Plain C interface (loaded with ctypes): every entry point launches on the
// given stream, allocates nothing, does not synchronise, and returns
// cudaGetLastError() so a refused launch is reported at once.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float4 fma4(float w, float4 x, float4 acc) {
  acc.x += w * x.x;
  acc.y += w * x.y;
  acc.z += w * x.z;
  acc.w += w * x.w;
  return acc;
}

__global__ void __launch_bounds__(kThreads)
aggregate_kernel(const float4* __restrict__ g, const float* __restrict__ w,
                 float4* __restrict__ G, double* __restrict__ partials,
                 int64_t n4, int cohort) {
  double local = 0.0;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += stride) {
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int k = 0; k < cohort; ++k) {
      acc = fma4(w[k], __ldcs(g + (int64_t)k * n4 + i), acc);
    }
    G[i] = acc;
    local += (double)acc.x * acc.x + (double)acc.y * acc.y +
             (double)acc.z * acc.z + (double)acc.w * acc.w;
  }
  // fixed-order block reduction: warp shuffles, then one value per warp
  for (int off = 16; off > 0; off >>= 1)
    local += __shfl_down_sync(0xffffffffu, local, off);
  __shared__ double warp_sums[kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = local;
  __syncthreads();
  if (warp == 0) {
    local = lane < kThreads / 32 ? warp_sums[lane] : 0.0;
    for (int off = 16; off > 0; off >>= 1)
      local += __shfl_down_sync(0xffffffffu, local, off);
    if (lane == 0) partials[blockIdx.x] = local;
  }
}

__global__ void __launch_bounds__(1024)
reduce_partials_kernel(const double* __restrict__ partials, int n,
                       float* __restrict__ ssq) {
  __shared__ double buf[1024];
  double s = 0.0;
  for (int i = threadIdx.x; i < n; i += blockDim.x) s += partials[i];
  buf[threadIdx.x] = s;
  __syncthreads();
  for (int half = blockDim.x / 2; half > 0; half >>= 1) {
    if (threadIdx.x < half) buf[threadIdx.x] += buf[threadIdx.x + half];
    __syncthreads();
  }
  if (threadIdx.x == 0) ssq[0] = (float)buf[0];
}

__global__ void __launch_bounds__(kThreads)
accumulate_kernel(const float4* acc, const float4* __restrict__ g,
                  const float* __restrict__ w, float4* out, int64_t n4) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n4) return;
  out[i] = fma4(w[0], __ldcs(g + i), acc[i]);
}

enum Opt { kSgd = 0, kSgdm = 1, kAdam = 2, kYogi = 3 };

struct Hyper {
  float momentum, b1, one_minus_b1, b2, one_minus_b2, eps;
};

// One element of the optimizer step; the arithmetic follows the JAX
// kernel's _update_kernel term for term.
template <int OPT>
__device__ __forceinline__ void step1(float G, float p, float m, float v,
                                      float scale, float lr, float bc1,
                                      float bc2, const Hyper& h, float& np,
                                      float& nm, float& nv) {
  const float g = G * scale;
  if (OPT == kSgd) {
    np = p - lr * g;
  } else if (OPT == kSgdm) {
    nm = h.momentum * m + g;
    np = p - lr * nm;
  } else {
    nm = h.b1 * m + h.one_minus_b1 * g;
    if (OPT == kAdam) {
      nv = h.b2 * v + h.one_minus_b2 * g * g;
    } else {
      // g*g rounded on its own (no FMA contraction), as the plain version
      // and the JAX kernel round it: sign() is discontinuous, and a fused
      // v - g*g flips it wherever v and g*g agree to the last bit.
      const float d = v - __fmul_rn(g, g);
      const float sgn = (float)((d > 0.f) - (d < 0.f));
      nv = v - h.one_minus_b2 * sgn * g * g;
    }
    np = p - lr * (nm * bc1) / (sqrtf(nv * bc2) + h.eps);
  }
}

template <int OPT>
__global__ void __launch_bounds__(kThreads)
update_kernel(const float4* __restrict__ G, const float4* __restrict__ p,
              const float4* __restrict__ m, const float4* __restrict__ v,
              const float* __restrict__ scal, float4* __restrict__ np,
              float4* __restrict__ nm, float4* __restrict__ nv, int64_t n4,
              Hyper h) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n4) return;
  const float scale = scal[0], lr = scal[1], bc1 = scal[2], bc2 = scal[3];
  const float4 g4 = __ldcs(G + i), p4 = __ldcs(p + i);
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  const float4 m4 = OPT == kSgd ? zero : __ldcs(m + i);
  const float4 v4 = (OPT == kAdam || OPT == kYogi) ? __ldcs(v + i) : zero;
  float4 op, om, ov;
  step1<OPT>(g4.x, p4.x, m4.x, v4.x, scale, lr, bc1, bc2, h, op.x, om.x, ov.x);
  step1<OPT>(g4.y, p4.y, m4.y, v4.y, scale, lr, bc1, bc2, h, op.y, om.y, ov.y);
  step1<OPT>(g4.z, p4.z, m4.z, v4.z, scale, lr, bc1, bc2, h, op.z, om.z, ov.z);
  step1<OPT>(g4.w, p4.w, m4.w, v4.w, scale, lr, bc1, bc2, h, op.w, om.w, ov.w);
  np[i] = op;
  if (OPT != kSgd) nm[i] = om;
  if (OPT == kAdam || OPT == kYogi) nv[i] = ov;
}

inline unsigned blocks_for(int64_t n4) {
  return (unsigned)((n4 + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

// g: (cohort, n) fp32; w: (cohort,) normalized weights; G: (n,);
// partials: (nblocks,) fp64 scratch; ssq: (1,) fp32.  n % 4 == 0.
int fu_aggregate(const float* g, const float* w, float* G, double* partials,
                 float* ssq, int64_t n, int cohort, int nblocks,
                 void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  aggregate_kernel<<<nblocks, kThreads, 0, s>>>(
      (const float4*)g, w, (float4*)G, partials, n / 4, cohort);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  reduce_partials_kernel<<<1, 1024, 0, s>>>(partials, nblocks, ssq);
  return (int)cudaGetLastError();
}

// out = acc + w[0] * g over n floats; out may alias acc.
int fu_accumulate(const float* acc, const float* g, const float* w,
                  float* out, int64_t n, void* stream) {
  const int64_t n4 = n / 4;
  accumulate_kernel<<<blocks_for(n4), kThreads, 0, (cudaStream_t)stream>>>(
      (const float4*)acc, (const float4*)g, w, (float4*)out, n4);
  return (int)cudaGetLastError();
}

// opt: 0 sgd, 1 sgdm, 2 adam, 3 yogi.  scal: [scale, lr, bc1, bc2] on the
// device.  m/v/nm/nv may be null where the optimizer has no such slot.
int fu_update(int opt, const float* G, const float* p, const float* m,
              const float* v, const float* scal, float* np, float* nm,
              float* nv, int64_t n, float momentum, float b1, float one_minus_b1,
              float b2, float one_minus_b2, float eps, void* stream) {
  const int64_t n4 = n / 4;
  const Hyper h{momentum, b1, one_minus_b1, b2, one_minus_b2, eps};
  const unsigned nb = blocks_for(n4);
  cudaStream_t s = (cudaStream_t)stream;
  const float4 *G4 = (const float4*)G, *p4 = (const float4*)p,
               *m4 = (const float4*)m, *v4 = (const float4*)v;
  float4 *np4 = (float4*)np, *nm4 = (float4*)nm, *nv4 = (float4*)nv;
  switch (opt) {
    case kSgd:
      update_kernel<kSgd><<<nb, kThreads, 0, s>>>(G4, p4, m4, v4, scal, np4,
                                                  nm4, nv4, n4, h);
      break;
    case kSgdm:
      update_kernel<kSgdm><<<nb, kThreads, 0, s>>>(G4, p4, m4, v4, scal, np4,
                                                   nm4, nv4, n4, h);
      break;
    case kAdam:
      update_kernel<kAdam><<<nb, kThreads, 0, s>>>(G4, p4, m4, v4, scal, np4,
                                                   nm4, nv4, n4, h);
      break;
    case kYogi:
      update_kernel<kYogi><<<nb, kThreads, 0, s>>>(G4, p4, m4, v4, scal, np4,
                                                   nm4, nv4, n4, h);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
