// Mamba2 SSD chunked scan for Hopper (sm_90a): the CUDA counterpart of the
// Pallas kernel ssd_scan_fwd in src/repro/kernels/ssd_scan/kernel.py, and
// of src/repro/models/ssm.py::ssd_chunked that the JAX prefill runs.
// fp32 in, fp32 out, fp32 arithmetic throughout.
//
//   x (B, S, H, P), dt (B, S, H), A (H,), Bm / Cm (B, S, G, N) with G
//   dividing H, any strides but unit stride on the last axis; head h reads
//   group h / (H / G), so the groups are never repeated in memory.
//   y (B, S, H, P) and h_final (B, H, N, P) contiguous; the scan starts
//   from a zero state, as the prefill does.  P = 64, N <= 128, chunk
//   L <= 256.
//
// One thread block per (b, h) walks the chunks in order, as the Pallas
// grid walks its sequential chunk axis, with the state h (N x P, 32 KB at
// N = 128) in shared memory across the loop.  Per chunk of L positions:
//
//   1. acum = inclusive cumsum of a = dt * A, one thread, sequentially in
//      index order, each product and sum rounded on its own (a rounded
//      first, as JAX computes a before its cumsum);
//   2. for each 64-row tile of t: y_t = exp(acum_t) (C_t . h), then for
//      each 64-row tile of s <= t: the tile of C B^T, times
//      exp(acum_t - acum_s) where t >= s and 0 elsewhere, times x_s dt_s;
//   3. h <- exp(acum_L) h + sum_s (B_s exp(acum_L - acum_s)) (x_s dt_s)^T.
//
// Every decay is the exp of a difference, never a ratio of exps: with A
// down to -16 and dt near 0.7, acum reaches about -2800 within a chunk
// of 256, where exp(acum) is 0 in fp32 and a ratio would be 0/0.  Past S
// (the ragged last chunk) positions read as x = dt = B = C = 0, so a =
// -0 and exp(0) = 1 carries h unchanged to h_final, exactly as JAX's zero
// padding does.
//
// Thread layout: 256 threads as 16 x 16; (ty, tx) owns rows 4ty..4ty+3
// and columns 4tx..4tx+3 of each 64 x 64 tile (t x s for C B^T, t x p for
// y) and rows ty + 16i, columns 4tx..4tx+3 of the state update.  C and B
// tiles are staged transposed (n-major, rows padded to 68 floats), so an
// inner step is two float4 loads and 16 FMAs; the masked decay matrix
// goes back through shared memory, transposed, for its product with x dt.
//
// What bounds it: at the serving prefill of mamba2-780m (B 8, 48 heads,
// S 1024, P 64, N 128, chunk 256) a layer does 32.6 GFLOP against 0.22 GB
// of fp32 input and output (B and C read by group): bound by operations
// (0.49 ms at fp32's 67 TFLOP/s).  This first version is plain SIMT fp32
// with one 123 KB block of 8 warps per SM (384 blocks, three waves on 132
// SMs) and recomputes nothing; the tensor-core (wgmma) and split-P designs
// are for later.
//
// Plain C interface (loaded with ctypes): ssd_forward launches on the
// given stream, allocates nothing, does not synchronise, and returns
// cudaGetLastError() so a refused launch is reported at once.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kT = 64;             // positions per tile
constexpr int kP = 64;             // head dim
constexpr int kMaxN = 128;         // state dim
constexpr int kMaxL = 256;         // chunk length
constexpr int kThreads = 256;
constexpr int kLd = 68;            // padded row of a transposed tile

inline int smem_floats(int N) {
  const int nb = N > kT ? N : kT;
  return N * kP        // hS[n][p]
       + N * kLd       // Ct[n][t]
       + nb * kLd      // Bt[n][s], then Mt[s][t], then Bs[s][n]
       + kT * kP       // Xs[s][p] = x dt
       + 4 * kMaxL;    // acum, exp(acum), exp(acum_L - acum), dt
}

struct Args {
  const float *x, *dt, *A, *Bm, *Cm;
  float *y, *hT;
  int S, H, G, N, L;
  int64_t sxb, sxs, sxh, sdb, sds, sdh, sbb, sbs, sbg, scb, scs, scg;
};

__global__ void __launch_bounds__(kThreads) ssd_fwd_kernel(const Args a) {
  const int N = a.N, L = a.L, S = a.S;
  extern __shared__ float4 smem4[];
  float* hS = reinterpret_cast<float*>(smem4);
  float* Ct = hS + N * kP;
  float* Bt = Ct + N * kLd;
  float* Xs = Bt + (N > kT ? N : kT) * kLd;
  float* acum = Xs + kT * kP;
  float* ea = acum + kMaxL;
  float* dte = ea + kMaxL;
  float* dts = dte + kMaxL;

  const int bh = blockIdx.x;
  const int b = bh / a.H, h = bh % a.H, g = h / (a.H / a.G);
  const float Ah = a.A[h];
  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const float* xb = a.x + b * a.sxb + h * a.sxh;
  const float* dtb = a.dt + b * a.sdb + h * a.sdh;
  const float* Bb = a.Bm + b * a.sbb + g * a.sbg;
  const float* Cb = a.Cm + b * a.scb + g * a.scg;
  float* yb = a.y + ((int64_t)b * S * a.H + h) * kP;
  const int64_t sys = (int64_t)a.H * kP;

  for (int i = tid; i < N * kP; i += kThreads)
    hS[i] = 0.f;

  const int nT = (L + kT - 1) / kT;
  const int nchunks = (S + L - 1) / L;
  for (int c = 0; c < nchunks; ++c) {
    const int c0 = c * L;
    __syncthreads();                 // the previous chunk is consumed
    for (int t = tid; t < kMaxL; t += kThreads)
      dts[t] = (t < L && c0 + t < S) ? dtb[(int64_t)(c0 + t) * a.sds] : 0.f;
    __syncthreads();
    if (tid == 0) {
      float run = 0.f;
#pragma unroll 8
      for (int t = 0; t < L; ++t) {
        run = __fadd_rn(run, __fmul_rn(dts[t], Ah));
        acum[t] = run;
      }
    }
    __syncthreads();
    const float aL = acum[L - 1];
    for (int t = tid; t < nT * kT; t += kThreads) {
      ea[t] = t < L ? expf(acum[t]) : 0.f;
      dte[t] = t < L ? expf(aL - acum[t]) : 0.f;
    }

    for (int tt = 0; tt < nT; ++tt) {
      const int t0 = tt * kT;
      __syncthreads();               // ea / dte written; old C tile read
      for (int i = tid; i < kT * N; i += kThreads) {
        const int t = i / N, n = i % N, tl = t0 + t;
        Ct[n * kLd + t] =
            (tl < L && c0 + tl < S) ? Cb[(int64_t)(c0 + tl) * a.scs + n] : 0.f;
      }
      __syncthreads();

      // the carried state: exp(acum_t) (C_t . h)
      float yacc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) yacc[i][j] = 0.f;
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        const float4 cv = *reinterpret_cast<const float4*>(&Ct[n * kLd + ty * 4]);
        const float4 hv = *reinterpret_cast<const float4*>(&hS[n * kP + tx * 4]);
        const float cr[4] = {cv.x, cv.y, cv.z, cv.w};
        const float hr[4] = {hv.x, hv.y, hv.z, hv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) yacc[i][j] = fmaf(cr[i], hr[j], yacc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float e = ea[t0 + ty * 4 + i];
#pragma unroll
        for (int j = 0; j < 4; ++j) yacc[i][j] *= e;
      }

      // within the chunk: (C B^T o decay o [t >= s]) (x dt)
      for (int st = 0; st <= tt; ++st) {
        const int s0 = st * kT;
        __syncthreads();             // the previous M and x dt tiles read
        for (int i = tid; i < kT * N; i += kThreads) {
          const int s = i / N, n = i % N, sl = s0 + s;
          Bt[n * kLd + s] =
              (sl < L && c0 + sl < S) ? Bb[(int64_t)(c0 + sl) * a.sbs + n] : 0.f;
        }
        for (int i = tid; i < kT * kP; i += kThreads) {
          const int s = i / kP, p = i % kP, sl = s0 + s;
          Xs[i] = (sl < L && c0 + sl < S)
                      ? __fmul_rn(xb[(int64_t)(c0 + sl) * a.sxs + p], dts[sl])
                      : 0.f;
        }
        __syncthreads();
        float sc[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 4
        for (int n = 0; n < N; ++n) {
          const float4 cv = *reinterpret_cast<const float4*>(&Ct[n * kLd + ty * 4]);
          const float4 bv = *reinterpret_cast<const float4*>(&Bt[n * kLd + tx * 4]);
          const float cr[4] = {cv.x, cv.y, cv.z, cv.w};
          const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(cr[i], br[j], sc[i][j]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int tl = t0 + ty * 4 + i;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int sl = s0 + tx * 4 + j;
            sc[i][j] = (tl < L && tl >= sl)
                           ? sc[i][j] * expf(acum[tl] - acum[sl])
                           : 0.f;
          }
        }
        __syncthreads();             // the B tile is read: reuse it for M
        float* Mt = Bt;
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            Mt[(tx * 4 + j) * kLd + ty * 4 + i] = sc[i][j];
        __syncthreads();
#pragma unroll 4
        for (int s = 0; s < kT; ++s) {
          const float4 mv = *reinterpret_cast<const float4*>(&Mt[s * kLd + ty * 4]);
          const float4 xv = *reinterpret_cast<const float4*>(&Xs[s * kP + tx * 4]);
          const float mr[4] = {mv.x, mv.y, mv.z, mv.w};
          const float xr[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) yacc[i][j] = fmaf(mr[i], xr[j], yacc[i][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int tl = t0 + ty * 4 + i;
        if (tl < L && c0 + tl < S)
          *reinterpret_cast<float4*>(&yb[(int64_t)(c0 + tl) * sys + tx * 4]) =
              make_float4(yacc[i][0], yacc[i][1], yacc[i][2], yacc[i][3]);
      }
    }

    // the state update: h <- exp(acum_L) h + sum_s (B_s exp(acum_L - acum_s)) (x dt)_s^T
    float hacc[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) hacc[i][j] = 0.f;
    float* Bs = Bt;
    for (int st = 0; st < nT; ++st) {
      const int s0 = st * kT;
      __syncthreads();               // the previous tiles are read
      for (int i = tid; i < kT * N; i += kThreads) {
        const int s = i / N, n = i % N, sl = s0 + s;
        Bs[i] = (sl < L && c0 + sl < S)
                    ? __fmul_rn(Bb[(int64_t)(c0 + sl) * a.sbs + n], dte[sl])
                    : 0.f;
      }
      for (int i = tid; i < kT * kP; i += kThreads) {
        const int s = i / kP, p = i % kP, sl = s0 + s;
        Xs[i] = (sl < L && c0 + sl < S)
                    ? __fmul_rn(xb[(int64_t)(c0 + sl) * a.sxs + p], dts[sl])
                    : 0.f;
      }
      __syncthreads();
#pragma unroll 2
      for (int s = 0; s < kT; ++s) {
        const float4 xv = *reinterpret_cast<const float4*>(&Xs[s * kP + tx * 4]);
        const float xr[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int n = ty + 16 * i;
          if (n < N) {
            const float bv = Bs[s * N + n];
#pragma unroll
            for (int j = 0; j < 4; ++j) hacc[i][j] = fmaf(bv, xr[j], hacc[i][j]);
          }
        }
      }
    }
    const float eL = ea[L - 1];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int n = ty + 16 * i;
      if (n < N) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float* hp = &hS[n * kP + tx * 4 + j];
          *hp = __fadd_rn(__fmul_rn(eL, *hp), hacc[i][j]);
        }
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < N * kP; i += kThreads)
    a.hT[(int64_t)bh * N * kP + i] = hS[i];
}

}  // namespace

extern "C" int ssd_forward(const float* x, const float* dt, const float* A,
                           const float* Bm, const float* Cm, float* y,
                           float* hT, int Bsz, int S, int H, int G,
                           int N, int P, int L, int64_t sxb, int64_t sxs,
                           int64_t sxh, int64_t sdb, int64_t sds, int64_t sdh,
                           int64_t sbb, int64_t sbs, int64_t sbg, int64_t scb,
                           int64_t scs, int64_t scg, cudaStream_t stream) {
  if (P != kP || N < 1 || N > kMaxN || L < 1 || L > kMaxL || G < 1 ||
      H % G != 0)
    return (int)cudaErrorInvalidValue;
  if (Bsz <= 0 || S <= 0 || H <= 0) return (int)cudaSuccess;
  const Args args{x, dt, A, Bm, Cm, y, hT, S, H, G, N, L,
                  sxb, sxs, sxh, sdb, sds, sdh, sbb, sbs, sbg, scb, scs, scg};
  const int bytes = smem_floats(N) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  ssd_fwd_kernel<<<Bsz * H, kThreads, bytes, stream>>>(args);
  return (int)cudaGetLastError();
}
