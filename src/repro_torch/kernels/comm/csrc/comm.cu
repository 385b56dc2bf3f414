// Communication-compression kernels for Hopper (sm_90a): the CUDA
// counterparts of the four Pallas kernels in
// src/repro/kernels/comm/kernel.py, the client's encode and the server's
// decode fused into the Eq. (14) accumulation, over flat fp32 buffers of
// shape (rows, 128), rows a multiple of 8.
//
//   quantize_i8_pass      q = clip(round(g * inv), -127, 127) as int8, and
//                         with error feedback err = g - q * scale in the
//                         same sweep.  One thread per float4 of g: reads
//                         16 bytes, writes a char4 (and a float4).
//   dequant_i8_fma_pass   out = acc + sw * q (sw = scale * w_k).  One
//                         thread per float4 of acc.
//   sign_pack_pass        bit r % 8 of packed row r / 8 is g[r] >= 0; with
//                         error feedback err = g - mu * mask * sign.  One
//                         thread per (packed row, group of 4 lanes): it
//                         reads the 8 float4 of its column of 8 rows (a
//                         warp reads 512 contiguous bytes of each row) and
//                         writes one uchar4.
//   sign_unpack_fma_pass  out = acc + muw * mask * (2 bit - 1), the same
//                         thread layout as the pack.
//
// Each is an elementwise sweep with no sum across elements, so there are
// no partials and no atomics, and each does a few operations per 4-byte
// element: all four are bound by device-memory bytes (at full width of
// smollm-360m, 0.45-0.97 ms over 3.35 TB/s).  The design goal is one read
// of every input and one write of every output.
//
// Rounding follows the plain PyTorch version (ref.py) exactly, so each
// kernel equals it bitwise:
//   * round half to even is rintf (roundf rounds half away from zero);
//   * every product and sum is rounded on its own (__fmul_rn, __fadd_rn,
//     __fsub_rn): nvcc would otherwise contract sw * q + acc into one FMA
//     and change the last bit;
//   * the sign is g >= 0.f, so -0.0 packs as +1 (signbit() would not);
//   * the pad mask is row * 128 + lane < n_valid in 64-bit indices, and a
//     masked element decodes to 0 (its residual is g - mu * 0).
// The accumulator of the two FMA kernels may alias their output: each
// element is read before it is written, by the same thread.
//
// Scalars (inv and scale, sw, mu, muw) are read from device pointers, so
// the host never waits for the device to learn them.  Plain C interface
// (loaded with ctypes): every entry point launches on the given stream,
// allocates nothing, does not synchronise, and returns cudaGetLastError()
// so a refused launch is reported at once.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLanes4 = 32;     // float4 per 128-lane row
constexpr int kPack = 8;        // rows of sign bits per packed row

inline unsigned blocks_for(int64_t n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

__device__ __forceinline__ float quant1(float g, float inv) {
  return fminf(fmaxf(rintf(__fmul_rn(g, inv)), -127.f), 127.f);
}

template <bool kErr>
__global__ void __launch_bounds__(kThreads)
quantize_i8_kernel(const float4* __restrict__ g,
                   const float* __restrict__ scal, char4* __restrict__ q,
                   float4* __restrict__ err, int64_t n4) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n4) return;
  const float inv = scal[0];
  const float4 x = g[i];
  const float4 r = make_float4(quant1(x.x, inv), quant1(x.y, inv),
                               quant1(x.z, inv), quant1(x.w, inv));
  q[i] = make_char4((signed char)r.x, (signed char)r.y, (signed char)r.z,
                    (signed char)r.w);
  if (kErr) {
    const float s = scal[1];
    err[i] = make_float4(__fsub_rn(x.x, __fmul_rn(r.x, s)),
                         __fsub_rn(x.y, __fmul_rn(r.y, s)),
                         __fsub_rn(x.z, __fmul_rn(r.z, s)),
                         __fsub_rn(x.w, __fmul_rn(r.w, s)));
  }
}

__global__ void __launch_bounds__(kThreads)
dequant_i8_fma_kernel(const float4* acc, const char4* __restrict__ q,
                      const float* __restrict__ sw, float4* out,
                      int64_t n4) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n4) return;
  const float s = sw[0];
  const float4 a = acc[i];
  const char4 c = q[i];
  out[i] = make_float4(__fadd_rn(a.x, __fmul_rn(s, (float)c.x)),
                       __fadd_rn(a.y, __fmul_rn(s, (float)c.y)),
                       __fadd_rn(a.z, __fmul_rn(s, (float)c.z)),
                       __fadd_rn(a.w, __fmul_rn(s, (float)c.w)));
}

// The decoded sign of one element: +1 / -1 from its bit, 0 in the pad.
__device__ __forceinline__ float sign_of(unsigned bit, int64_t idx,
                                         int64_t n_valid) {
  return idx < n_valid ? (bit ? 1.f : -1.f) : 0.f;
}

// i indexes (packed row, lane group): packed row i / 32, lanes 4 (i % 32)
// to 4 (i % 32) + 3.
template <bool kErr>
__global__ void __launch_bounds__(kThreads)
sign_pack_kernel(const float4* __restrict__ g, const float* __restrict__ mu,
                 int64_t n_valid, uchar4* __restrict__ bits,
                 float4* __restrict__ err, int64_t nb4) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= nb4) return;
  const int64_t prow = i / kLanes4;
  const int l4 = (int)(i % kLanes4);
  const float m = kErr ? mu[0] : 0.f;
  unsigned b0 = 0, b1 = 0, b2 = 0, b3 = 0;
#pragma unroll
  for (int r = 0; r < kPack; ++r) {
    const int64_t row = prow * kPack + r;
    const int64_t j = row * kLanes4 + l4;          // float4 index
    const float4 x = g[j];
    const unsigned s0 = x.x >= 0.f, s1 = x.y >= 0.f, s2 = x.z >= 0.f,
                   s3 = x.w >= 0.f;
    b0 |= s0 << r;
    b1 |= s1 << r;
    b2 |= s2 << r;
    b3 |= s3 << r;
    if (kErr) {
      const int64_t e = j * 4;                     // flat index of x.x
      err[j] = make_float4(
          __fsub_rn(x.x, __fmul_rn(m, sign_of(s0, e, n_valid))),
          __fsub_rn(x.y, __fmul_rn(m, sign_of(s1, e + 1, n_valid))),
          __fsub_rn(x.z, __fmul_rn(m, sign_of(s2, e + 2, n_valid))),
          __fsub_rn(x.w, __fmul_rn(m, sign_of(s3, e + 3, n_valid))));
    }
  }
  bits[i] = make_uchar4((unsigned char)b0, (unsigned char)b1,
                        (unsigned char)b2, (unsigned char)b3);
}

__global__ void __launch_bounds__(kThreads)
sign_unpack_fma_kernel(const float4* acc, const uchar4* __restrict__ bits,
                       const float* __restrict__ muw, int64_t n_valid,
                       float4* out, int64_t nb4) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= nb4) return;
  const int64_t prow = i / kLanes4;
  const int l4 = (int)(i % kLanes4);
  const float m = muw[0];
  const uchar4 b = bits[i];
#pragma unroll
  for (int r = 0; r < kPack; ++r) {
    const int64_t j = (prow * kPack + r) * kLanes4 + l4;
    const int64_t e = j * 4;
    const float4 a = acc[j];
    out[j] = make_float4(
        __fadd_rn(a.x, __fmul_rn(m, sign_of((b.x >> r) & 1u, e, n_valid))),
        __fadd_rn(a.y,
                  __fmul_rn(m, sign_of((b.y >> r) & 1u, e + 1, n_valid))),
        __fadd_rn(a.z,
                  __fmul_rn(m, sign_of((b.z >> r) & 1u, e + 2, n_valid))),
        __fadd_rn(a.w,
                  __fmul_rn(m, sign_of((b.w >> r) & 1u, e + 3, n_valid))));
  }
}

}  // namespace

extern "C" {

// g: (n,) fp32, n % 4 == 0; scal: [inv, scale] on the device; q: (n,) int8;
// err: (n,) fp32 or null (no residual).
int cm_quantize_i8(const float* g, const float* scal, int8_t* q, float* err,
                   int64_t n, void* stream) {
  const int64_t n4 = n / 4;
  cudaStream_t s = (cudaStream_t)stream;
  if (err != nullptr) {
    quantize_i8_kernel<true><<<blocks_for(n4), kThreads, 0, s>>>(
        (const float4*)g, scal, (char4*)q, (float4*)err, n4);
  } else {
    quantize_i8_kernel<false><<<blocks_for(n4), kThreads, 0, s>>>(
        (const float4*)g, scal, (char4*)q, nullptr, n4);
  }
  return (int)cudaGetLastError();
}

// out = acc + sw[0] * q over n elements; out may alias acc.
int cm_dequant_i8_fma(const float* acc, const int8_t* q, const float* sw,
                      float* out, int64_t n, void* stream) {
  const int64_t n4 = n / 4;
  dequant_i8_fma_kernel<<<blocks_for(n4), kThreads, 0,
                          (cudaStream_t)stream>>>(
      (const float4*)acc, (const char4*)q, sw, (float4*)out, n4);
  return (int)cudaGetLastError();
}

// g: (rows, 128) fp32, rows % 8 == 0; mu: (1,) on the device (read only
// with a residual); bits: (rows / 8, 128) uint8; err: (rows, 128) or null.
int cm_sign_pack(const float* g, const float* mu, int64_t n_valid,
                 uint8_t* bits, float* err, int64_t rows, void* stream) {
  const int64_t nb4 = rows / kPack * kLanes4;
  cudaStream_t s = (cudaStream_t)stream;
  if (err != nullptr) {
    sign_pack_kernel<true><<<blocks_for(nb4), kThreads, 0, s>>>(
        (const float4*)g, mu, n_valid, (uchar4*)bits, (float4*)err, nb4);
  } else {
    sign_pack_kernel<false><<<blocks_for(nb4), kThreads, 0, s>>>(
        (const float4*)g, mu, n_valid, (uchar4*)bits, nullptr, nb4);
  }
  return (int)cudaGetLastError();
}

// out = acc + muw[0] * mask * sign over (rows, 128); out may alias acc.
int cm_sign_unpack_fma(const float* acc, const uint8_t* bits,
                       const float* muw, int64_t n_valid, float* out,
                       int64_t rows, void* stream) {
  const int64_t nb4 = rows / kPack * kLanes4;
  sign_unpack_fma_kernel<<<blocks_for(nb4), kThreads, 0,
                           (cudaStream_t)stream>>>(
      (const float4*)acc, (const uchar4*)bits, muw, n_valid, (float4*)out,
      nb4);
  return (int)cudaGetLastError();
}

}  // extern "C"
