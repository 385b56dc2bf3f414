// Forms of accumulate_pass (out = acc + w g over flat fp32 buffers, out may
// alias acc) for tools/accumulate_forms.py, which times them against one
// another on the card.  The port's kernel is the one in
// src/repro_torch/kernels/fused_update/csrc/fused_update.cu; these copies
// differ from it only where their names say.
//
//   form 0  one float4 a thread, plain store          (fused_update.cu)
//   form 1  one float4 a thread, streaming store __stcs
//   form 2  grid-stride, U = 4 float4 of each input in flight a thread,
//           all loads of an iteration before its stores, __ldcs / __stcs,
//           blocks_per_sm x (the card's SM count) blocks
//
// Every form takes g through __ldcs and computes fma4 exactly as
// fused_update.cu does, so all outputs are bitwise equal.

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
one_float4(const float4* acc, const float4* __restrict__ g,
           const float* __restrict__ w, float4* out, int64_t n4) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n4) return;
  out[i] = fma4(w[0], __ldcs(g + i), acc[i]);
}

__global__ void __launch_bounds__(kThreads)
one_float4_stcs(const float4* acc, const float4* __restrict__ g,
                const float* __restrict__ w, float4* out, int64_t n4) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n4) return;
  const float4 a = acc[i];
  __stcs(out + i, fma4(w[0], __ldcs(g + i), a));
}

template <int U>
__global__ void __launch_bounds__(kThreads)
grid_stride(const float4* acc, const float4* __restrict__ g,
            const float* __restrict__ w, float4* out, int64_t n4) {
  const float wk = w[0];
  const int64_t step = (int64_t)gridDim.x * kThreads * U;
  for (int64_t base = (int64_t)blockIdx.x * kThreads * U + threadIdx.x;
       base < n4; base += step) {
    float4 a[U], x[U];
#pragma unroll
    for (int j = 0; j < U; ++j) {
      const int64_t i = base + (int64_t)j * kThreads;
      if (i < n4) {
        a[j] = acc[i];
        x[j] = __ldcs(g + i);
      }
    }
#pragma unroll
    for (int j = 0; j < U; ++j) {
      const int64_t i = base + (int64_t)j * kThreads;
      if (i < n4) __stcs(out + i, fma4(wk, x[j], a[j]));
    }
  }
}

}  // namespace

extern "C" {

// n a multiple of 4; returns cudaGetLastError().
int af_launch(int form, int blocks_per_sm, const float* acc, const float* g,
              const float* w, float* out, int64_t n, void* stream) {
  const int64_t n4 = n / 4;
  cudaStream_t s = (cudaStream_t)stream;
  const float4 *a4 = (const float4*)acc, *g4 = (const float4*)g;
  float4* o4 = (float4*)out;
  const unsigned one = (unsigned)((n4 + kThreads - 1) / kThreads);
  if (form == 0) {
    one_float4<<<one, kThreads, 0, s>>>(a4, g4, w, o4, n4);
  } else if (form == 1) {
    one_float4_stcs<<<one, kThreads, 0, s>>>(a4, g4, w, o4, n4);
  } else if (form == 2) {
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    grid_stride<4><<<blocks_per_sm * sms, kThreads, 0, s>>>(a4, g4, w, o4,
                                                            n4);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
