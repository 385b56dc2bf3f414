// Fused server-update kernels for Hopper (sm_90a): the CUDA counterparts of
// the six Pallas kernels in src/repro/kernels/fused_update/kernel.py, the
// three forward passes and their three backward passes.
//
// All six are streaming passes over flat fp32 buffers of shape
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
//   accumulate_pass_bwd  dg = w * d_out and dw = <g, d_out>.
//   aggregate_pass_bwd   dGt = dG + 2 dssq G; dg_k = w_k dGt (the whole
//                        (cohort, rows, 128) stack) and dw_k = <g_k, dGt>.
//   update_pass_bwd      replays the optimizer from (G, m, v, scalars) and
//                        writes dG, dm, dv and the four scalar cotangents
//                        [dscale, dlr, dbc1, dbc2].
//
// The backward sums (dw, dscal) are what the Pallas kernels carry across
// their grid steps; here, as for ssq, each block writes fp64 partials over
// a fixed grid (at most 1024 blocks, grid-stride) and one block per sum
// adds them in a fixed order: no atomics, bitwise equal from launch to
// launch.  The backward kernels round every product and sum on its own
// (__fmul_rn, __fadd_rn, ...), as the plain PyTorch version does, so the
// terms of each sum are the plain version's bit for bit and the sums agree
// to fp64 rounding; nvcc would otherwise contract a*b+c into one FMA, and a
// one-ulp change in each term of a cancelling dot product over 361 M
// elements moves it by more than 1e-6 relative.  The same discipline keeps
// yogi's sign(v - g*g) from flipping (the forward rounds g*g on its own too).
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

// One block per row of a (rows, n) array of fp64 partials: out[row] is the
// row's sum, added in a fixed order.
__global__ void __launch_bounds__(1024)
reduce_partials_kernel(const double* __restrict__ partials, int n,
                       float* __restrict__ ssq) {
  __shared__ double buf[1024];
  partials += (int64_t)blockIdx.x * n;
  ssq += blockIdx.x;
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

// out = acc + w g, one float4 of each input a thread.  g is read once and
// out written once: streaming hints (__ldcs, __stcs) keep them from
// displacing anything in L2.  Each element is read and written by the same
// thread, loads before its store, so out may alias acc (no __restrict__ on
// either).  tools/accumulate_forms.py times the forms in turns at full
// width (H100 SXM, 700 W): the streaming store takes the in-place form
// from 1.421 to 1.399 ms and the out-of-place form from 1.404 to 1.399 ms
// (the byte bound is 1.296 ms); a grid-stride loop over 4-16 blocks an SM
// with four float4 of each input in flight a thread takes 1.451-1.470 ms.
__global__ void __launch_bounds__(kThreads)
accumulate_kernel(const float4* acc, const float4* __restrict__ g,
                  const float* __restrict__ w, float4* out, int64_t n4) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n4) return;
  const float4 a = acc[i];
  __stcs(out + i, fma4(w[0], __ldcs(g + i), a));
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

// One float4 of each buffer a thread.  The new p, m and v are written
// once and not read again in the launch: streaming stores (__stcs), as
// accumulate_pass takes them.  tools/update_forms.py times the forms in
// turns at full width (NVIDIA H100 80GB HBM3, 700.00 W; bitwise equal
// outputs): the streaming stores take sgd from 1.4331 to 1.3976 ms, under
// torch.add(p, G, alpha=-lr) at 1.4021 ms (the byte bound is 1.2961 ms),
// sgdm from 2.4093 to 2.3517, adam from 3.3943 to 3.3450
// (torch._fused_adam_: 3.8112) and yogi from 3.3945 to 3.3078 ms; a plain
// load of p instead of __ldcs (1.4043 ms alone, 1.3986 with the stores)
// and the four scalars read through __ldg or once a block into shared
// memory (1.3973 / 1.3976 ms) gain nothing beside them.
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
  __stcs(np + i, op);
  if (OPT != kSgd) __stcs(nm + i, om);
  if (OPT == kAdam || OPT == kYogi) __stcs(nv + i, ov);
}

// ---------------------------------------------------------------------------
// Backward passes
// ---------------------------------------------------------------------------
constexpr int kAggChunk = 8;   // clients per aggregate_bwd launch

// <a, b> of one float4: fp32 products, each rounded on its own, in fp64.
__device__ __forceinline__ double dot4(float4 a, float4 b) {
  return (double)__fmul_rn(a.x, b.x) + (double)__fmul_rn(a.y, b.y) +
         (double)__fmul_rn(a.z, b.z) + (double)__fmul_rn(a.w, b.w);
}

__device__ __forceinline__ float4 scale4(float w, float4 x) {
  return make_float4(__fmul_rn(w, x.x), __fmul_rn(w, x.y),
                     __fmul_rn(w, x.z), __fmul_rn(w, x.w));
}

// Fixed-order block reduction of NV per-thread sums: warp shuffles, then one
// value per warp; partials[j * gridDim.x + blockIdx.x] = block sum j, j < nv.
template <int NV>
__device__ __forceinline__ void block_partials(const double (&local)[NV],
                                               double* __restrict__ partials,
                                               int nv) {
  __shared__ double warp_sums[NV][kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    double x = local[j];
    for (int off = 16; off > 0; off >>= 1)
      x += __shfl_down_sync(0xffffffffu, x, off);
    if (lane == 0) warp_sums[j][warp] = x;
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      double x = lane < kThreads / 32 ? warp_sums[j][lane] : 0.0;
      for (int off = 16; off > 0; off >>= 1)
        x += __shfl_down_sync(0xffffffffu, x, off);
      if (lane == 0 && j < nv)
        partials[(int64_t)j * gridDim.x + blockIdx.x] = x;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
accumulate_bwd_kernel(const float4* __restrict__ g,
                      const float4* __restrict__ dout,
                      const float* __restrict__ w, float4* __restrict__ dg,
                      double* __restrict__ partials, int64_t n4) {
  const float wk = w[0];
  double local[1] = {0.0};
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += stride) {
    const float4 d = __ldcs(dout + i);
    dg[i] = scale4(wk, d);
    local[0] += dot4(__ldcs(g + i), d);
  }
  block_partials<1>(local, partials, 1);
}

// Clients k0 .. k0+kc-1 (kc <= kAggChunk) of the stack; partials points at
// row k0 of the (cohort, gridDim.x) partials.
__global__ void __launch_bounds__(kThreads)
aggregate_bwd_kernel(const float4* __restrict__ g, const float* __restrict__ w,
                     const float* __restrict__ dssq,
                     const float4* __restrict__ G,
                     const float4* __restrict__ dG, float4* __restrict__ dg,
                     double* __restrict__ partials, int64_t n4, int k0,
                     int kc) {
  const float c = 2.0f * dssq[0];
  float wk[kAggChunk];
  double local[kAggChunk];
#pragma unroll
  for (int j = 0; j < kAggChunk; ++j) {
    wk[j] = j < kc ? w[k0 + j] : 0.f;
    local[j] = 0.0;
  }
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += stride) {
    const float4 Gi = __ldcs(G + i), dGi = __ldcs(dG + i);
    const float4 t = make_float4(__fadd_rn(dGi.x, __fmul_rn(c, Gi.x)),
                                 __fadd_rn(dGi.y, __fmul_rn(c, Gi.y)),
                                 __fadd_rn(dGi.z, __fmul_rn(c, Gi.z)),
                                 __fadd_rn(dGi.w, __fmul_rn(c, Gi.w)));
#pragma unroll
    for (int j = 0; j < kAggChunk; ++j) {
      if (j < kc) {
        const int64_t off = (int64_t)(k0 + j) * n4 + i;
        dg[off] = scale4(wk[j], t);
        local[j] += dot4(__ldcs(g + off), t);
      }
    }
  }
  block_partials<kAggChunk>(local, partials, kc);
}

// One element of the optimizer's backward, term for term the plain
// version's update_bwd_ref (every operation rounded on its own).  Adds
// [dscale, dlr, dbc1, dbc2]'s terms to acc.
template <int OPT>
__device__ __forceinline__ void bwd1(float G, float m, float v, float dpn,
                                     float dmn_ct, float dvn_ct, float s,
                                     float lr, float bc1, float bc2,
                                     const Hyper& h, float& dG, float& dm,
                                     float& dv, double (&acc)[4]) {
  const float g = __fmul_rn(G, s);
  float dg, dlr, dbc1 = 0.f, dbc2 = 0.f;
  if (OPT == kSgd) {
    dg = __fmul_rn(-lr, dpn);
    dlr = -__fmul_rn(g, dpn);
  } else if (OPT == kSgdm) {
    const float m_new = __fadd_rn(__fmul_rn(h.momentum, m), g);
    const float dmn = __fsub_rn(dmn_ct, __fmul_rn(lr, dpn));
    dlr = -__fmul_rn(m_new, dpn);
    dg = dmn;
    dm = __fmul_rn(h.momentum, dmn);
  } else {
    const float m_new = __fadd_rn(__fmul_rn(h.b1, m),
                                  __fmul_rn(h.one_minus_b1, g));
    float v_new, sgn = 0.f;
    if (OPT == kAdam) {
      v_new = __fadd_rn(__fmul_rn(h.b2, v),
                        __fmul_rn(__fmul_rn(h.one_minus_b2, g), g));
    } else {
      const float d = __fsub_rn(v, __fmul_rn(g, g));
      sgn = (float)((d > 0.f) - (d < 0.f));
      v_new = __fsub_rn(
          v, __fmul_rn(__fmul_rn(__fmul_rn(h.one_minus_b2, sgn), g), g));
    }
    const float rs = __fsqrt_rn(__fmul_rn(v_new, bc2));
    const float denom = __fadd_rn(rs, h.eps);
    const float step = __fdiv_rn(__fmul_rn(m_new, bc1), denom);
    const float dstep = __fmul_rn(-lr, dpn);
    dlr = -__fmul_rn(step, dpn);
    const float dmn =
        __fadd_rn(dmn_ct, __fmul_rn(dstep, __fdiv_rn(bc1, denom)));
    dbc1 = __fdiv_rn(__fmul_rn(dstep, m_new), denom);
    const float ddenom = __fdiv_rn(__fmul_rn(-dstep, step), denom);
    // d sqrt is infinite at 0: the zero-padded tail (G = m = v = 0) must
    // give back exact zeros, not 0 * inf
    const float inv2rs = rs > 0.f ? __fdiv_rn(0.5f, fmaxf(rs, 1e-30f)) : 0.f;
    const float dvn =
        __fadd_rn(dvn_ct, __fmul_rn(__fmul_rn(ddenom, bc2), inv2rs));
    dbc2 = __fmul_rn(__fmul_rn(ddenom, v_new), inv2rs);
    dm = __fmul_rn(h.b1, dmn);
    const float two_omb2 = 2.0f * h.one_minus_b2;   // exact
    if (OPT == kAdam) {
      dv = __fmul_rn(h.b2, dvn);
      dg = __fadd_rn(__fmul_rn(h.one_minus_b1, dmn),
                     __fmul_rn(__fmul_rn(two_omb2, g), dvn));
    } else {
      dv = dvn;
      dg = __fsub_rn(__fmul_rn(h.one_minus_b1, dmn),
                     __fmul_rn(__fmul_rn(__fmul_rn(two_omb2, sgn), g), dvn));
    }
  }
  dG = __fmul_rn(s, dg);
  acc[0] += (double)__fmul_rn(G, dg);
  acc[1] += (double)dlr;
  acc[2] += (double)dbc1;
  acc[3] += (double)dbc2;
}

template <int OPT>
__global__ void __launch_bounds__(kThreads)
update_bwd_kernel(const float4* __restrict__ G, const float4* __restrict__ m,
                  const float4* __restrict__ v, const float* __restrict__ scal,
                  const float4* __restrict__ dpn,
                  const float4* __restrict__ dmn_ct,
                  const float4* __restrict__ dvn_ct, float4* __restrict__ dG,
                  float4* __restrict__ dm, float4* __restrict__ dv,
                  double* __restrict__ partials, int64_t n4, Hyper h) {
  const float s = scal[0], lr = scal[1], bc1 = scal[2], bc2 = scal[3];
  constexpr bool kM = OPT != kSgd, kV = OPT == kAdam || OPT == kYogi;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  double acc[4] = {0.0, 0.0, 0.0, 0.0};
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += stride) {
    const float4 G4 = __ldcs(G + i), p4 = __ldcs(dpn + i);
    const float4 m4 = kM ? __ldcs(m + i) : zero;
    const float4 mc4 = kM ? __ldcs(dmn_ct + i) : zero;
    const float4 v4 = kV ? __ldcs(v + i) : zero;
    const float4 vc4 = kV ? __ldcs(dvn_ct + i) : zero;
    float4 oG, om, ov;
    bwd1<OPT>(G4.x, m4.x, v4.x, p4.x, mc4.x, vc4.x, s, lr, bc1, bc2, h, oG.x,
              om.x, ov.x, acc);
    bwd1<OPT>(G4.y, m4.y, v4.y, p4.y, mc4.y, vc4.y, s, lr, bc1, bc2, h, oG.y,
              om.y, ov.y, acc);
    bwd1<OPT>(G4.z, m4.z, v4.z, p4.z, mc4.z, vc4.z, s, lr, bc1, bc2, h, oG.z,
              om.z, ov.z, acc);
    bwd1<OPT>(G4.w, m4.w, v4.w, p4.w, mc4.w, vc4.w, s, lr, bc1, bc2, h, oG.w,
              om.w, ov.w, acc);
    dG[i] = oG;
    if (kM) dm[i] = om;
    if (kV) dv[i] = ov;
  }
  block_partials<4>(acc, partials, 4);
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

// g, dout, dg: n floats; w: (1,); partials: (nblocks,) fp64 scratch;
// dw: (1,).
int fu_accumulate_bwd(const float* g, const float* w, const float* dout,
                      float* dg, double* partials, float* dw, int64_t n,
                      int nblocks, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  accumulate_bwd_kernel<<<nblocks, kThreads, 0, s>>>(
      (const float4*)g, (const float4*)dout, w, (float4*)dg, partials, n / 4);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  reduce_partials_kernel<<<1, 1024, 0, s>>>(partials, nblocks, dw);
  return (int)cudaGetLastError();
}

// g, dg: (cohort, n); w: (cohort,); dssq: (1,); G, dG: (n,);
// partials: (cohort, nblocks) fp64 scratch; dw: (cohort,).
int fu_aggregate_bwd(const float* g, const float* w, const float* dssq,
                     const float* G, const float* dG, float* dg,
                     double* partials, float* dw, int64_t n, int cohort,
                     int nblocks, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  for (int k0 = 0; k0 < cohort; k0 += kAggChunk) {
    const int kc = cohort - k0 < kAggChunk ? cohort - k0 : kAggChunk;
    aggregate_bwd_kernel<<<nblocks, kThreads, 0, s>>>(
        (const float4*)g, w, dssq, (const float4*)G, (const float4*)dG,
        (float4*)dg, partials + (int64_t)k0 * nblocks, n / 4, k0, kc);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  reduce_partials_kernel<<<cohort, 1024, 0, s>>>(partials, nblocks, dw);
  return (int)cudaGetLastError();
}

// opt as fu_update.  scal: [scale, lr, bc1, bc2] on the device; d*_ct are
// the cotangents of (p', m', v'); m/v/dmn/dvn/dm/dv may be null where the
// optimizer has no such slot.  partials: (4, nblocks) fp64 scratch;
// dscal: (4,) = [dscale, dlr, dbc1, dbc2].
int fu_update_bwd(int opt, const float* G, const float* m, const float* v,
                  const float* scal, const float* dpn, const float* dmn,
                  const float* dvn, float* dG, float* dm, float* dv,
                  double* partials, float* dscal, int64_t n, float momentum,
                  float b1, float one_minus_b1, float b2, float one_minus_b2,
                  float eps, int nblocks, void* stream) {
  const int64_t n4 = n / 4;
  const Hyper h{momentum, b1, one_minus_b1, b2, one_minus_b2, eps};
  cudaStream_t s = (cudaStream_t)stream;
  const float4 *G4 = (const float4*)G, *m4 = (const float4*)m,
               *v4 = (const float4*)v, *p4 = (const float4*)dpn,
               *mc4 = (const float4*)dmn, *vc4 = (const float4*)dvn;
  float4 *dG4 = (float4*)dG, *dm4 = (float4*)dm, *dv4 = (float4*)dv;
  switch (opt) {
    case kSgd:
      update_bwd_kernel<kSgd><<<nblocks, kThreads, 0, s>>>(
          G4, m4, v4, scal, p4, mc4, vc4, dG4, dm4, dv4, partials, n4, h);
      break;
    case kSgdm:
      update_bwd_kernel<kSgdm><<<nblocks, kThreads, 0, s>>>(
          G4, m4, v4, scal, p4, mc4, vc4, dG4, dm4, dv4, partials, n4, h);
      break;
    case kAdam:
      update_bwd_kernel<kAdam><<<nblocks, kThreads, 0, s>>>(
          G4, m4, v4, scal, p4, mc4, vc4, dG4, dm4, dv4, partials, n4, h);
      break;
    case kYogi:
      update_bwd_kernel<kYogi><<<nblocks, kThreads, 0, s>>>(
          G4, m4, v4, scal, p4, mc4, vc4, dG4, dm4, dv4, partials, n4, h);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  reduce_partials_kernel<<<4, 1024, 0, s>>>(partials, nblocks, dscal);
  return (int)cudaGetLastError();
}

}  // extern "C"
