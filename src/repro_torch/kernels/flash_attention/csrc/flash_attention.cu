// Flash-attention forward for Hopper (sm_90a): the CUDA counterpart of the
// Pallas kernel flash_attention_fwd in
// src/repro/kernels/flash_attention/kernel.py, and of the online-softmax
// scheme of src/repro/models/attention.py::_fa_fwd_inner that the JAX
// prefill runs.  fp32 in, fp32 out, fp32 arithmetic throughout (the port
// keeps the reference's fp32 products; no TF32).
//
//   q (BH, Sq, D), k / v (BHkv, Skv, D), o (BH, Sq, D), all contiguous,
//   heads ordered (b, h); query head bh reads key/value head bh / group,
//   so the grouped key/value heads are never repeated in memory.
//
// One thread block per (64-row query tile, bh): it walks the 64-row key
// tiles in order, staging each in shared memory, and keeps the online
// softmax state in registers: the running max m, the running sum l and
// the accumulator acc of its query rows, as the Pallas kernel keeps them
// in VMEM scratch across its sequential kv grid axis.  256 threads as
// 16 x 16: thread (ty, tx) owns query rows 4ty..4ty+3, score columns
// 4tx..4tx+3 and output columns 4tx..4tx+3 (+64 for D = 128).  Q and K are
// staged transposed (d-major, rows padded to 68 floats) so that each step
// of the q.k product is two float4 loads and 16 FMAs; the probabilities go
// through shared memory, transposed the same way, for the p.v product.
// Row max and row sum reduce over the 16 lanes of a half-warp by shuffles.
//
// Masking follows the reference exactly: a masked score is -1e30, never
// -inf (exp(-inf - -inf) is NaN), so a row whose first tile is wholly
// masked accumulates exp(0) terms that the first valid tile multiplies
// by exp(-1e30 - m) = 0, as the reference's online softmax does.  Key
// tiles wholly above the causal diagonal or wholly outside the window
// are skipped: their p is 0 and their correction factor 1, so skipping
// them is exact.  Keys past Skv (the ragged tail) get p = 0 outright and
// rows past Sq are not stored.  The output is acc / max(l, 1e-30).
//
// What bounds it: at the serving prefill's shapes (B 8, 15 query and 5
// key/value heads, S 1024, D 64, causal) it does 2D multiply-adds per
// (query, key) pair for q.k and p.v and a few more for the softmax, 16.4
// GFLOP a layer against 52.4 MB of input and 31.5 MB of output: bound by
// operations (0.24 ms at fp32's 67 TFLOP/s).  This first version is
// plain SIMT fp32; shared-memory bandwidth (two float4 loads per 16
// FMAs) and 68 KB of shared memory a block (three blocks of 8 warps an SM
// at D = 64) limit it.  wgmma and TMA are for a later version.
//
// Plain C interface (loaded with ctypes): fa_forward launches on the given
// stream, allocates nothing, does not synchronise, and returns
// cudaGetLastError() so a refused launch is reported at once.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;            // query rows per block
constexpr int kBK = 64;            // key rows per tile
constexpr int kThreads = 256;
constexpr int kLd = 68;            // padded row of a transposed tile (float4 aligned)
constexpr float kNegInf = -1e30f;

template <int D>
constexpr int smem_floats() {
  return D * kLd      // Qt[d][r]
       + D * kLd      // Kt[d][c]
       + kBK * D      // Vs[c][d]
       + kBK * kLd;   // Pt[c][r]
}

// D = 64: three 68 KB blocks fit an SM, so at most 85 registers a thread;
// D = 128: one 120 KB block.
template <int D>
__global__ void __launch_bounds__(kThreads, D == 64 ? 3 : 1)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int Sq,
                 int Skv, int group, float scale, int causal, int window) {
  constexpr int H4 = D / 64;       // float4 column groups per thread
  extern __shared__ float4 smem4[];
  float* Qt = reinterpret_cast<float*>(smem4);
  float* Kt = Qt + D * kLd;
  float* Vs = Kt + D * kLd;
  float* Pt = Vs + kBK * D;

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kBQ;
  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const float* qb = q + (int64_t)bh * Sq * D;
  const float* kb = k + (int64_t)(bh / group) * Skv * D;
  const float* vb = v + (int64_t)(bh / group) * Skv * D;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, d = i % D;
    Qt[d * kLd + r] = q0 + r < Sq ? qb[(int64_t)(q0 + r) * D + d] : 0.f;
  }

  float m[4], l[4], acc[4][4 * H4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * H4; ++c) acc[i][c] = 0.f;
  }

  // Key tiles any row of this query tile can see.
  int kt_end = (Skv + kBK - 1) / kBK;
  if (causal) kt_end = min(kt_end, (q0 + kBQ - 1) / kBK + 1);
  int kt_begin = 0;
  if (window > 0) {
    const int lo = q0 - window + 1;          // smallest key row q0 keeps
    kt_begin = lo > 0 ? lo / kBK : 0;
  }

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();                 // the previous tile is consumed
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int c = i / D, d = i % D;
      const bool ok = k0 + c < Skv;
      const int64_t off = (int64_t)(k0 + c) * D + d;
      Kt[d * kLd + c] = ok ? kb[off] : 0.f;
      Vs[c * D + d] = ok ? vb[off] : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(&Qt[d * kLd + ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&Kt[d * kLd + tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qr = q0 + ty * 4 + i;
      float mx = m[i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kc = k0 + tx * 4 + j;
        const int rel = qr - kc;
        float x = s[i][j] * scale;
        if (causal && rel < 0) x = kNegInf;
        if (window > 0 && rel >= window) x = kNegInf;
        s[i][j] = x;
        if (kc < Skv) mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float corr = expf(m[i] - mx);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = k0 + tx * 4 + j < Skv ? expf(s[i][j] - mx) : 0.f;
        rs += p;
        Pt[(tx * 4 + j) * kLd + ty * 4 + i] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * corr + rs;
      m[i] = mx;
#pragma unroll
      for (int c = 0; c < 4 * H4; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      const float4 p4 = *reinterpret_cast<const float4*>(&Pt[c * kLd + ty * 4]);
      const float pv[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
      for (int h = 0; h < H4; ++h) {
        const float4 v4 =
            *reinterpret_cast<const float4*>(&Vs[c * D + h * 64 + tx * 4]);
        const float vv[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[i][h * 4 + j] = fmaf(pv[i], vv[j], acc[i][h * 4 + j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qr = q0 + ty * 4 + i;
    if (qr >= Sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
    float* orow = o + ((int64_t)bh * Sq + qr) * D;
#pragma unroll
    for (int h = 0; h < H4; ++h) {
      float4 r;
      r.x = acc[i][h * 4 + 0] / den;
      r.y = acc[i][h * 4 + 1] / den;
      r.z = acc[i][h * 4 + 2] / den;
      r.w = acc[i][h * 4 + 3] / den;
      *reinterpret_cast<float4*>(&orow[h * 64 + tx * 4]) = r;
    }
  }
}

template <int D>
cudaError_t launch(const float* q, const float* k, const float* v, float* o,
                   int BH, int Sq, int Skv, int group, float scale,
                   int causal, int window, cudaStream_t stream) {
  const int bytes = smem_floats<D>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + kBQ - 1) / kBQ, BH);
  flash_fwd_kernel<D><<<grid, kThreads, bytes, stream>>>(
      q, k, v, o, Sq, Skv, group, scale, causal, window);
  return cudaGetLastError();
}

}  // namespace

extern "C" int fa_forward(const float* q, const float* k, const float* v,
                          float* o, int BH, int Sq, int Skv, int D, int group,
                          float scale, int causal, int window,
                          cudaStream_t stream) {
  if (BH <= 0 || Sq <= 0 || Skv <= 0) return (int)cudaSuccess;
  switch (D) {
    case 64:
      return (int)launch<64>(q, k, v, o, BH, Sq, Skv, group, scale, causal,
                             window, stream);
    case 128:
      return (int)launch<128>(q, k, v, o, BH, Sq, Skv, group, scale, causal,
                              window, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
