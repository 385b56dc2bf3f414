// Forms of update_pass (the fused optimizer step over flat fp32 buffers) for
// tools/update_forms.py, which times them against one another on the card.
// The port's kernel is update_kernel in
// src/repro_torch/kernels/fused_update/csrc/fused_update.cu; these copies
// differ from it only in how they load and store, never in the arithmetic,
// so every form's output is bitwise the port's.
//
// One float4 of every buffer a thread, 256 threads a block; the form is
// chosen by three switches:
//
//   stcs    the outputs through streaming stores (__stcs) instead of
//           plain ones;
//   plain_p p through a plain load instead of __ldcs (G, m and v keep
//           __ldcs);
//   scal    how [scale, lr, bc1, bc2] are read: 0 four loads a thread
//           ahead of the buffers' loads, 1 the same through __ldg, 2 once
//           a block into shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

enum Opt { kSgd = 0, kSgdm = 1, kAdam = 2, kYogi = 3 };

struct Hyper {
  float momentum, b1, one_minus_b1, b2, one_minus_b2, eps;
};

// fused_update.cu's step1, term for term.
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
      const float d = v - __fmul_rn(g, g);
      const float sgn = (float)((d > 0.f) - (d < 0.f));
      nv = v - h.one_minus_b2 * sgn * g * g;
    }
    np = p - lr * (nm * bc1) / (sqrtf(nv * bc2) + h.eps);
  }
}

template <bool STCS>
__device__ __forceinline__ void put(float4* dst, float4 x) {
  if (STCS) __stcs(dst, x); else *dst = x;
}

template <int OPT, bool STCS, bool PLAIN_P, int SCAL>
__global__ void __launch_bounds__(kThreads)
update_form(const float4* __restrict__ G, const float4* __restrict__ p,
            const float4* __restrict__ m, const float4* __restrict__ v,
            const float* __restrict__ scal, float4* __restrict__ np,
            float4* __restrict__ nm, float4* __restrict__ nv, int64_t n4,
            Hyper h) {
  __shared__ float sc[4];
  if (SCAL == 2) {
    if (threadIdx.x < 4) sc[threadIdx.x] = scal[threadIdx.x];
    __syncthreads();
  }
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n4) return;
  float scale, lr, bc1, bc2;
  if (SCAL == 0) {
    scale = scal[0], lr = scal[1], bc1 = scal[2], bc2 = scal[3];
  } else if (SCAL == 1) {
    scale = __ldg(scal), lr = __ldg(scal + 1), bc1 = __ldg(scal + 2),
    bc2 = __ldg(scal + 3);
  } else {
    scale = sc[0], lr = sc[1], bc1 = sc[2], bc2 = sc[3];
  }
  const float4 g4 = __ldcs(G + i), p4 = PLAIN_P ? p[i] : __ldcs(p + i);
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  const float4 m4 = OPT == kSgd ? zero : __ldcs(m + i);
  const float4 v4 = (OPT == kAdam || OPT == kYogi) ? __ldcs(v + i) : zero;
  float4 op, om, ov;
  step1<OPT>(g4.x, p4.x, m4.x, v4.x, scale, lr, bc1, bc2, h, op.x, om.x, ov.x);
  step1<OPT>(g4.y, p4.y, m4.y, v4.y, scale, lr, bc1, bc2, h, op.y, om.y, ov.y);
  step1<OPT>(g4.z, p4.z, m4.z, v4.z, scale, lr, bc1, bc2, h, op.z, om.z, ov.z);
  step1<OPT>(g4.w, p4.w, m4.w, v4.w, scale, lr, bc1, bc2, h, op.w, om.w, ov.w);
  put<STCS>(np + i, op);
  if (OPT != kSgd) put<STCS>(nm + i, om);
  if (OPT == kAdam || OPT == kYogi) put<STCS>(nv + i, ov);
}

template <int OPT>
cudaError_t launch(int form, const float* G, const float* p, const float* m,
                   const float* v, const float* scal, float* np, float* nm,
                   float* nv, int64_t n4, const Hyper& h, cudaStream_t s) {
  const unsigned nb = (unsigned)((n4 + kThreads - 1) / kThreads);
  const float4 *G4 = (const float4*)G, *p4 = (const float4*)p,
               *m4 = (const float4*)m, *v4 = (const float4*)v;
  float4 *np4 = (float4*)np, *nm4 = (float4*)nm, *nv4 = (float4*)nv;
#define UF_FORM(ST, PP, SC)                                                  \
  update_form<OPT, ST, PP, SC><<<nb, kThreads, 0, s>>>(G4, p4, m4, v4, scal, \
                                                       np4, nm4, nv4, n4, h)
  switch (form) {
    case 0: UF_FORM(false, false, 0); break;   // fused_update.cu before
    case 1: UF_FORM(true, false, 0); break;    // + __stcs
    case 2: UF_FORM(false, true, 0); break;    // + plain p load
    case 3: UF_FORM(true, true, 0); break;     // + both
    case 4: UF_FORM(true, false, 1); break;    // __stcs, scalars by __ldg
    case 5: UF_FORM(true, false, 2); break;    // __stcs, scalars in shared
    default: return cudaErrorInvalidValue;
  }
#undef UF_FORM
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// opt: 0 sgd, 1 sgdm, 2 adam, 3 yogi; form as in launch(); the other
// arguments as
// fused_update.cu's fu_update takes them; n a multiple of 4.  Returns
// cudaGetLastError().
int uf_launch(int opt, int form, const float* G, const float* p,
              const float* m, const float* v, const float* scal, float* np,
              float* nm, float* nv, int64_t n, float momentum, float b1,
              float one_minus_b1, float b2, float one_minus_b2, float eps,
              void* stream) {
  const Hyper h{momentum, b1, one_minus_b1, b2, one_minus_b2, eps};
  cudaStream_t s = (cudaStream_t)stream;
  const int64_t n4 = n / 4;
  switch (opt) {
    case kSgd:
      return (int)launch<kSgd>(form, G, p, m, v, scal, np, nm, nv, n4, h, s);
    case kSgdm:
      return (int)launch<kSgdm>(form, G, p, m, v, scal, np, nm, nv, n4, h, s);
    case kAdam:
      return (int)launch<kAdam>(form, G, p, m, v, scal, np, nm, nv, n4, h, s);
    case kYogi:
      return (int)launch<kYogi>(form, G, p, m, v, scal, np, nm, nv, n4, h, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
