// Mamba2 SSD chunked scan for Hopper (sm_90a): the CUDA counterpart of the
// Pallas kernel ssd_scan_fwd in src/repro/kernels/ssd_scan/kernel.py, and
// of src/repro/models/ssm.py::ssd_chunked that the JAX prefill runs.
// fp32 in, fp32 out, fp32 accuracy.
//
//   x (B, S, H, P), dt (B, S, H), A (H,), Bm / Cm (B, S, G, N) with G
//   dividing H, any strides but unit stride on the last axis; head h reads
//   group h / (H / G), so the groups are never repeated in memory.
//   y (B, S, H, P) and h_final (B, H, N, P) contiguous; the scan starts
//   from a zero state, as the prefill does.  P = 64 or 128, N <= 128,
//   chunk L <= 256.
//
// What bounds it.  At the serving prefill of mamba2-780m (B 8, 48 heads,
// one group, S 1024, P 64, N 128, chunk 256) one call needs 19.9 GFLOP
// (C B^T taken once for the group: 19.6 of matrix products, 0.3 of decays
// and masks) against 0.23 GB of fp32 input and output: 0.30 ms in fp32
// outside the tensor cores.  So the products run on the tensor cores as
// 3xTF32, as flash attention's do: each operand x is split into hi =
// tf32(x) and lo = tf32(x - hi), and a.b is taken as a_hi.b_hi plus
// (a_lo.b_hi + a_hi.b_lo), the dropped a_lo.b_lo and lo's own rounding
// each about 2^-22 relative per product.  Three TF32 products at 495
// TFLOP/s and the rest at fp32's 67 bound it at 0.123 ms.  The earlier
// SIMT version of this kernel (one block per (b, h) walking the chunks in
// order, C B^T per head) took 2.74 ms; this one takes 0.63 ms on an NVIDIA
// H100 80GB HBM3 at 700.00 W, where staging the operands through registers
// and shared memory, not the tensor cores, takes most of the time
// (tools/ssd_ablations.py; PERF.md has the figures).
//
// The design: SSD's own chunked algorithm (arXiv:2405.21060 section 6),
// in which every chunk is independent work but for one small state pass.
// Two launches on one stream; the wrapper hands them scratch for the
// states entering the chunks (B H nchunks x P x N fp32), the cumsums (B H
// nchunks x L) and C B^T (B G nchunks x L x L, in tiles):
//
//   1. ssd_states_cb_kernel, blocks of two kinds, the card running the
//      second kind in the first's tail:
//      state_block, one warpgroup per (b, h, 64 state columns), walking
//      the chunks in order.  Per chunk: acum = the inclusive cumsum of a =
//      dt A, one thread, sequentially in index order, each product and sum
//      rounded on its own (a rounded first, as JAX computes a before its
//      cumsum): any other order (a tree or shuffle scan) moves acum by an
//      ulp, which at the init's decay range (A down to -16, acum a few
//      thousand within a chunk) moves every near-diagonal decay by 2.4e-4,
//      24 times the tolerance.  Then the chunk's state S^T = (x dt)^T (B
//      exp(acum_L - acum)), (P x L) times (L x 64) on the tensor cores, and
//      h <- exp(acum_L) h + S in registers, in the reference's own order of
//      operations; the state entering each chunk goes to the scratch, the
//      last one to h_final.
//      cb_block, one warpgroup per (b, group, chunk, 64-row tile of t): C
//      B^T up to the diagonal, in 64 x 32 tiles.  The heads of a group
//      share B and C (all 48 heads at mamba2-780m's one group), so this
//      product, which is as large as all the others together when taken
//      per head, is taken once per group.  Each tile goes to the scratch
//      in the accumulator layout, each thread's 16 values contiguous.
//   2. ssd_out_kernel, one warpgroup per (b, h, chunk, 64-row tile), the
//      longest causal rows first, all of them independent: y = exp(acum_t)
//      (C_t . h_c) and, per 32-column tile of s <= t, (C B^T o exp(acum_t -
//      acum_s) o [t >= s]) (x dt), C B^T read back in the layout it was
//      written in.
//
// Every decay is the exp of a difference, never a ratio of exps: with A
// down to -16 and dt near 0.7, acum reaches about -2800 within a chunk
// of 256, where exp(acum) is 0 in fp32 and a ratio would be 0/0.  Past S
// (the ragged last chunk) positions read as x = dt = B = C = 0, so a =
// -0 and exp(0) = 1 carries h unchanged to h_final, exactly as JAX's zero
// padding does.
//
// On the tensor cores (wgmma m64nNk8, tf32 in, fp32 accumulate, by inline
// PTX, as in flash_attention.cu):
//   * tf32 wgmma takes both operands K-major.  C and B are K-major as they
//     lie in memory (n contiguous); x dt, B exp(acum_L - acum) and the
//     state are staged transposed.  Shared tiles are split once into hi
//     and lo tiles in the no-swizzle core-matrix layout (cm), which
//     wgmma reads without bank conflicts; C's high part goes to registers
//     (the A operand of two of its three products), its low part stays in
//     shared memory.
//   * The masked decay matrix goes from the C B^T accumulator layout
//     straight into the A operand of M (x dt), with no shared-memory round
//     trip: B's rows are stored permuted within each group of 8, so the
//     accumulator holds columns s and s + 4 where the A fragment wants them
//     (flash's trick for P); the output kernel reads each thread's 16
//     values back into the same registers.
//   * The tensor cores add with truncation, so each tile's product starts
//     from zero and is added to the running sum in fp32 (the state and
//     M (x dt) over tiles of 32 positions), and the long chains (C B^T and
//     C h over N) keep their small terms in an accumulator of their own.
//   * Each tile is loaded global to registers, all of a thread's loads
//     issued together, the next tile's while the current one is
//     multiplied, then split into shared memory; three blocks share an SM
//     (64-67 KB of shared memory and 168 registers a thread at N 128;
//     two blocks, without spills, run slower).
//   * No atomics: each output element has one writer.
// Where N is not a multiple of 64 the state dimension is padded with zeros
// in shared memory (N <= 64 runs as 64, N <= 128 as 128).
//
// The head dim P.  Every block works on 64 columns of P: the columns of
// the scan are independent (the state is N x P and column p of x feeds
// only column p of y and of h), so P = 128 (jamba's mamba layers) runs
// each state and output block twice over, at p0 = 0 and p0 = 64, the
// third dimension of the output grid, and C B^T, which does not depend
// on P, is still taken once per group.  A block's tiles, shared memory
// (35.0 KB for a state block, 64.0 KB for a C B^T block and 66.0 KB for
// an output block at N 128) and registers stay those of P = 64, so three
// blocks still share an SM; a 64 x 128 tile a block would double the
// accumulators (64 more registers a thread: two blocks an SM, or spills)
// and C's staging is the only work the second pass repeats.  P = 64 runs
// one pass, each block's operations in the order an unsplit kernel takes
// them, so tiling P changes none of its bits.  At one jamba layer (B 1,
// 128 heads, S 4096, chunk 256) a P = 128 call takes 1.83 ms on an
// NVIDIA H100 80GB HBM3 at 700.00 W against its 3xTF32 bound of 0.32 ms
// (tools/ssd_check.py); making it fast is work of its own.
//
// Plain C interface (loaded with ctypes): ssd_forward launches the two
// kernels on the given stream, allocates nothing, does not synchronise,
// and returns cudaGetLastError() after each launch so a refused launch is
// reported at once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kP = 64;             // head-dim columns of a block
constexpr int kMaxN = 128;         // state dim
constexpr int kMaxL = 256;         // chunk length
constexpr int kBT = 64;            // t rows of an output block (a warpgroup)
constexpr int kBS = 32;            // s columns of an output tile
constexpr int kBS1 = 32;           // s rows of a state tile
constexpr int kThreads = 128;         // one warpgroup

// T: the type of x, B, C and y (float, or __nv_bfloat16 converted to fp32
// as it is loaded and rounded from it as y is stored); dt, A, h_final and
// the scratch are fp32.
template <typename T>
struct ArgsT {
  const T* x;
  const float *dt, *A;
  const T *Bm, *Cm;
  T* y;
  float *hT, *states, *acum, *cb;
  int S, H, G, N, L, nc, nT, nS;
  int P, nP;                       // head dim, its 64-column tiles
  int units_g;                     // B G nchunks
  int vecB, vecC;                  // B / C rows loadable 4 at a time
  int64_t sxb, sxs, sxh, sdb, sds, sdh, sbb, sbs, sbg, scb, scs, scg;
};

// x rounded to TF32 (10 mantissa bits), to nearest with ties away from
// zero: cvt.rna.tf32.f32's rounding, done as integer ops on the
// sign-magnitude bits.  Finite inputs only.
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void split4(const float (&x)[4], float4& hi,
                                       float4& lo) {
  uint32_t h[4], l[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) split(x[q], h[q], l[q]);
  hi = make_float4(__uint_as_float(h[0]), __uint_as_float(h[1]),
                   __uint_as_float(h[2]), __uint_as_float(h[3]));
  lo = make_float4(__uint_as_float(l[0]), __uint_as_float(l[1]),
                   __uint_as_float(l[2]), __uint_as_float(l[3]));
}

// Float offset of element (row, k) in the no-swizzle K-major layout of
// wgmma: 8-row x 16-byte core matrices, 128 contiguous bytes each, the
// core matrices of one 8-row group adjacent along k, the groups kdim / 4
// core matrices apart.
__device__ __forceinline__ int cm(int row, int k, int kdim) {
  return ((row >> 3) * (kdim >> 2) + (k >> 2)) * 32 + (row & 7) * 4 + (k & 3);
}

// wgmma's shared-memory matrix descriptor for a tile in that layout, at
// k-step kk (8 columns of k, two core matrices): leading byte offset 128
// (between the two), stride byte offset kdim * 32 (between 8-row groups).
__device__ __forceinline__ uint64_t desc(const float* tile, int kk, int kdim) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(tile + kk * 64);
  const uint32_t lbo = 128, sbo = (uint32_t)kdim * 32;
  return (uint64_t)((a & 0x3ffff) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3fff) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3fff) << 32);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
template <int R, int C>
__device__ __forceinline__ void fence_regs(float (&d)[R][C]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < C; ++j) asm volatile("" : "+f"(d[i][j])::"memory");
}
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// wgmma.m64nNk8, tf32 in, fp32 accumulate.  d: the warpgroup's
// accumulator, N / 8 groups of four a thread (rows g, g + 8 of the warp's
// 16; columns 2t, 2t + 1 of each group of 8).  SS takes A and B by
// descriptor, RS takes A from registers (rows g, g + 8; columns t, t + 4).
// scale_d = 0 starts the accumulator from zero.
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[4][4], uint64_t adesc,
                                             uint64_t bdesc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15},"
      " %16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "l"(adesc), "l"(bdesc), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n32(float (&d)[4][4],
                                             const uint32_t (&a)[4],
                                             uint64_t bdesc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15},"
      " {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(bdesc),
        "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss_n64(float (&d)[8][4], uint64_t adesc,
                                             uint64_t bdesc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31},"
      " %32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(adesc), "l"(bdesc), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n64(float (&d)[8][4],
                                             const uint32_t (&a)[4],
                                             uint64_t bdesc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31},"
      " {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(bdesc),
        "r"(scale_d));
}

template <int R>
__device__ __forceinline__ void zero(float (&d)[R][4]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) d[i][j] = 0.f;
}

// One value, or four neighbours (16 bytes of fp32, 8 of bf16), from
// global memory through the read-only path, as fp32.
__device__ __forceinline__ float ldg1(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ldg1(const __nv_bfloat16* p) {
  return __uint_as_float(
      (uint32_t)__ldg(reinterpret_cast<const unsigned short*>(p)) << 16);
}
__device__ __forceinline__ void ldg4(const float* p, float (&v)[4]) {
  const float4 q = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
}
__device__ __forceinline__ void ldg4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 q = __ldg(reinterpret_cast<const uint2*>(p));
  v[0] = __uint_as_float(q.x << 16), v[1] = __uint_as_float(q.x & 0xffff0000u);
  v[2] = __uint_as_float(q.y << 16), v[3] = __uint_as_float(q.y & 0xffff0000u);
}
// Two neighbouring outputs, rounded to nearest even at bf16.
__device__ __forceinline__ void st2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void st2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// Staging a tile: every thread first issues all its global loads (into
// registers), then splits and stores them, so a tile costs one round trip
// to L2 or memory, not one per load.

// Rows [r0, r0 + ROWS) of a (rows, n) array with unit stride along n,
// columns [n0, n0 + COLS), for hi / lo tiles (rows, k = column; kdim
// COLS).  Rows at or past nrows and columns at or past ncols read as zero;
// PERM stores row r at r's place in the C B^T permutation (within each
// group of 8, row r < 4 at 2r, row r >= 4 at 2(r - 4) + 1).  8 neighbouring
// threads store the 8 rows of one core matrix, 4 such groups take 64
// contiguous bytes of 8 rows: conflict-free stores, whole 32-byte sectors.
template <int ROWS, int COLS, bool PERM, int NT>
struct RowTile {
  static constexpr int C4 = COLS / 4, IT = ROWS * C4 / NT;
  static_assert(ROWS * C4 % NT == 0, "whole iterations");
  float v[IT][4];

  __device__ __forceinline__ static void at(int i, int& r, int& c) {
    r = (i / (8 * C4)) * 8 + (i & 7);
    c = ((i >> 3) % C4) * 4;
  }
  template <typename S>
  __device__ __forceinline__ void load(const S* src, int64_t stride,
                                       int r0, int nrows, int n0, int ncols,
                                       bool vec) {
#pragma unroll
    for (int it = 0; it < IT; ++it) {
      int r, c;
      at(threadIdx.x + it * NT, r, c);
      const int rg = r0 + r, n = n0 + c;
      v[it][0] = v[it][1] = v[it][2] = v[it][3] = 0.f;
      if (rg < nrows) {
        const S* p = src + (int64_t)rg * stride + n;
        if (vec) {
          if (n < ncols) ldg4(p, v[it]);
        } else {
#pragma unroll
          for (int q = 0; q < 4; ++q)
            if (n + q < ncols) v[it][q] = ldg1(p + q);
        }
      }
    }
  }
  __device__ __forceinline__ void store(float* hi, float* lo) const {
#pragma unroll
    for (int it = 0; it < IT; ++it) {
      int r, c;
      at(threadIdx.x + it * NT, r, c);
      float4 h, l;
      split4(v[it], h, l);
      const int rr = PERM ? (r & ~7) | ((r & 3) << 1) | ((r >> 2) & 1) : r;
      const int off = cm(rr, c, COLS);
      *reinterpret_cast<float4*>(hi + off) = h;
      *reinterpret_cast<float4*>(lo + off) = l;
    }
  }
};

// Positions [s0, s0 + BS) of a (positions, columns) array with unit stride
// along the columns, transposed for hi / lo tiles (rows = columns
// [0, COLS), k = position; kdim BS), each value times mult[position],
// rounded (x dt, B exp(acum_L - acum)).  Positions at or past npos and
// columns at or past ncols read as zero.  Neighbouring threads take
// neighbouring columns: coalesced loads, conflict-free float4 stores.
template <int COLS, int BS, int NT>
struct PosTile {
  static constexpr int IT = COLS * (BS / 4) / NT;
  static_assert(COLS * (BS / 4) % NT == 0, "whole iterations");
  float v[IT][4];

  template <typename S>
  __device__ __forceinline__ void load(const S* src, int64_t stride,
                                       int s0, int npos, int ncols) {
#pragma unroll
    for (int it = 0; it < IT; ++it) {
      const int i = threadIdx.x + it * NT;
      const int col = i % COLS, s4 = (i / COLS) * 4;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int s = s0 + s4 + q;
        v[it][q] = (s < npos && col < ncols)
                       ? ldg1(src + (int64_t)s * stride + col)
                       : 0.f;
      }
    }
  }
  __device__ __forceinline__ void store(float* hi, float* lo, int s0,
                                        const float* mult) {
#pragma unroll
    for (int it = 0; it < IT; ++it) {
      const int i = threadIdx.x + it * NT;
      const int col = i % COLS, s4 = (i / COLS) * 4;
      float x[4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        x[q] = __fmul_rn(v[it][q], mult[s0 + s4 + q]);
      float4 h, l;
      split4(x, h, l);
      const int off = cm(col, s4, BS);
      *reinterpret_cast<float4*>(hi + off) = h;
      *reinterpret_cast<float4*>(lo + off) = l;
    }
  }
};

struct Unit {
  int unit, bh, b, h, g, c, c0, npos;   // npos: valid positions of the chunk
};

template <typename T>
__device__ __forceinline__ Unit unit_of(const ArgsT<T>& a, int unit) {
  Unit u;
  u.unit = unit;
  u.c = unit % a.nc;
  u.bh = unit / a.nc;
  u.b = u.bh / a.H;
  u.h = u.bh % a.H;
  u.g = u.h / (a.H / a.G);
  u.c0 = u.c * a.L;
  u.npos = min(a.L, a.S - u.c0);
  return u;
}

// ---------------------------------------------------------------------------
// 1. acum, the chunk states and the state passed across the chunks: one
// warpgroup per (b, h, 64 state columns) walks the chunks in order
// ---------------------------------------------------------------------------
template <typename T>
__device__ __forceinline__ void state_block(const ArgsT<T>& a, int blk,
                                            float* smem) {
  float* dts = smem;
  float* acum = dts + kMaxL;
  float* dte = acum + kMaxL;
  float* Xhi = dte + kMaxL;                  // x dt, transposed: (P, s)
  float* Xlo = Xhi + kP * kBS1;
  float* Bhi = Xlo + kP * kBS1;              // B exp(aL - acum), (n, s)
  float* Blo = Bhi + 64 * kBS1;

  const int halves = (a.N + 63) / 64;
  const int bh = blk / (a.nP * halves), rem = blk % (a.nP * halves);
  const int p0 = (rem / halves) * kP, n0 = (rem % halves) * 64;
  const int b = bh / a.H, h = bh % a.H, gi = h / (a.H / a.G);
  const int L = a.L, N = a.N, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const float Ah = a.A[h];

  // the state entering the chunk, transposed (rows p = 16 warp + g (+ 8),
  // columns n0 + 8j + 2t (+ 1)): the accumulator layout
  float hs[8][4];
  zero(hs);
  for (int c = 0; c < a.nc; ++c) {
    const int c0 = c * L, npos = min(L, a.S - c0);
    const int64_t unit = (int64_t)bh * a.nc + c;
    const T* xb = a.x + b * a.sxb + h * a.sxh + c0 * a.sxs + p0;
    const float* dtb = a.dt + b * a.sdb + h * a.sdh + c0 * a.sds;
    const T* Bb = a.Bm + b * a.sbb + gi * a.sbg + c0 * a.sbs + n0;
    // the chunk's first tiles, in flight during the cumsum
    PosTile<kP, kBS1, kThreads> xt;
    PosTile<64, kBS1, kThreads> bt;
    xt.load(xb, a.sxs, 0, npos, kP);
    bt.load(Bb, a.sbs, 0, npos, N - n0);
    __syncthreads();               // the previous chunk's tiles are read
    for (int s = tid; s < kMaxL; s += kThreads)
      dts[s] = s < npos ? dtb[(int64_t)s * a.sds] : 0.f;
    __syncthreads();
    if (tid == 0) {
      float run = 0.f;
#pragma unroll 8
      for (int s = 0; s < L; ++s) {
        run = __fadd_rn(run, __fmul_rn(dts[s], Ah));
        acum[s] = run;
      }
    }
    __syncthreads();
    const float aL = acum[L - 1];
    for (int s = tid; s < kMaxL; s += kThreads) {
      if (n0 == 0 && p0 == 0 && s < L) a.acum[unit * L + s] = acum[s];
      dte[s] = s < L ? expf(aL - acum[s]) : 0.f;
    }
    float* st = a.states + (unit * a.P + p0) * N;
    if (c > 0) {                   // chunk 0's zero state is implied
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int p = warp * 16 + g + 8 * (e >> 1);
          const int n = n0 + j * 8 + 2 * t + (e & 1);
          if (n < N) st[p * N + n] = hs[j][e];
        }
    }

    // the chunk's state S^T over s-tiles of 32, each tile's product
    // (x_lo.b_hi + x_hi.b_lo + x_hi.b_hi) from zero, added in fp32; the
    // next tile's loads in flight during the products
    float acc[8][4];
    zero(acc);
    for (int s0 = 0; s0 < L; s0 += kBS1) {
      __syncthreads();             // dte written; the previous tile read
      xt.store(Xhi, Xlo, s0, dts);
      bt.store(Bhi, Blo, s0, dte);
      fence_proxy_async();
      __syncthreads();
      if (s0 + kBS1 < L) {
        xt.load(xb, a.sxs, s0 + kBS1, npos, kP);
        bt.load(Bb, a.sbs, s0 + kBS1, npos, N - n0);
      }
      float part[8][4] = {};
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < kBS1 / 8; ++kk) {
        const uint64_t xh = desc(Xhi, kk, kBS1), xl = desc(Xlo, kk, kBS1);
        const uint64_t dh = desc(Bhi, kk, kBS1), dl = desc(Blo, kk, kBS1);
        wgmma_ss_n64(part, xl, dh, kk > 0);
        wgmma_ss_n64(part, xh, dl, 1);
        wgmma_ss_n64(part, xh, dh, 1);
      }
      wg_commit();
      wg_wait0();
      fence_regs(part);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] += part[j][e];
    }
    // h <- exp(acum_L) h + S, in the reference's order of operations
    const float eL = expf(aL);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        hs[j][e] = __fadd_rn(__fmul_rn(eL, hs[j][e]), acc[j][e]);
  }

  // h_final (N, P), columns [p0, p0 + 64)
  float* out = a.hT + (int64_t)bh * N * a.P + p0;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int p = warp * 16 + g + 8 * (e >> 1);
      const int n = n0 + j * 8 + 2 * t + (e & 1);
      if (n < N) out[n * a.P + p] = hs[j][e];
    }
}

// C's high part, staged in `work` (rows t, k = n), into registers as A
// fragments (rows r0, r0 + 8; columns t, t + 4 of each k-step).
template <int NP>
__device__ __forceinline__ void load_chi(const float* work,
                                         uint32_t (&chi)[NP / 8][4]) {
  const int lane = threadIdx.x & 31;
  const int r0 = (threadIdx.x >> 5) * 16 + (lane >> 2), t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < NP / 8; ++kk) {
    chi[kk][0] = __float_as_uint(work[cm(r0, kk * 8 + t, NP)]);
    chi[kk][1] = __float_as_uint(work[cm(r0 + 8, kk * 8 + t, NP)]);
    chi[kk][2] = __float_as_uint(work[cm(r0, kk * 8 + t + 4, NP)]);
    chi[kk][3] = __float_as_uint(work[cm(r0 + 8, kk * 8 + t + 4, NP)]);
  }
}

// C's rows [t0, t0 + 64) of a chunk, split: the low part to Clo (the SS
// operand), the high part through `work` into registers.  Ends with a
// barrier; `work` is free again once the caller syncs.
template <typename T, int NP>
__device__ __forceinline__ void stage_c(const ArgsT<T>& a, const T* Cb,
                                        int t0, int npos, float* work,
                                        float* Clo,
                                        uint32_t (&chi)[NP / 8][4]) {
  {
    RowTile<kBT, NP, false, kThreads> ct;
    ct.load(Cb, a.scs, t0, npos, 0, a.N, a.vecC);
    ct.store(work, Clo);
  }
  fence_proxy_async();
  __syncthreads();
  load_chi<NP>(work, chi);
}

// The scratch tile of C B^T for (b, g, chunk), 64-row tile tt, 32-column
// tile j: 2048 floats, each thread's 16 accumulator values contiguous.
template <typename T>
__device__ __forceinline__ float4* cb_tile(const ArgsT<T>& a, int64_t ug,
                                           int tt,
                                           int j) {
  return reinterpret_cast<float4*>(
      a.cb + ((ug * a.nT + tt) * a.nS + j) * (kBT * kBS));
}

// ---------------------------------------------------------------------------
// 2. C B^T, once per group: heads of one group share B and C, so the
// product is taken once per (b, g, chunk, 64-row tile) and every head's
// output block reads it, in the accumulator layout, from the scratch
// ---------------------------------------------------------------------------
template <typename T, int NP>
__device__ __forceinline__ void cb_block(const ArgsT<T>& a, int blk,
                                         float* smem) {
  constexpr int KN = NP / 8;                 // k-steps over the state dim
  float* Clo = smem;                         // C, (t, n)
  float* work = Clo + kBT * NP;              // C's hi, then B's hi and lo
  float* Bhi = work;                         // B (s permuted, n)
  float* Blo = work + kBS * NP;

  const int ug = blk % a.units_g;            // (b, g, chunk)
  const int tt = a.nT - 1 - blk / a.units_g, t0 = tt * kBT;  // longest first
  const int c = ug % a.nc, bg = ug / a.nc;
  const int b = bg / a.G, gi = bg % a.G;
  const int c0 = c * a.L, npos = min(a.L, a.S - c0);
  const int s_end = min(t0 + kBT, a.L);
  const T* Bb = a.Bm + b * a.sbb + gi * a.sbg + c0 * a.sbs;
  const T* Cb = a.Cm + b * a.scb + gi * a.scg + c0 * a.scs;

  uint32_t chi[KN][4];
  stage_c<T, NP>(a, Cb, t0, npos, work, Clo, chi);
  for (int s0 = 0, j = 0; s0 < s_end; s0 += kBS, ++j) {
    RowTile<kBS, NP, true, kThreads> bt;
    bt.load(Bb, a.sbs, s0, npos, 0, a.N, a.vecB);
    __syncthreads();               // C's hi / the previous B tile read
    bt.store(Bhi, Blo);
    fence_proxy_async();
    __syncthreads();
    // big += c_hi.b_hi, small += c_lo.b_hi + c_hi.b_lo
    float cb[4][4] = {}, cbs[4][4] = {};
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < KN; ++kk) {
      const uint64_t cl = desc(Clo, kk, NP);
      const uint64_t bh = desc(Bhi, kk, NP), bl = desc(Blo, kk, NP);
      wgmma_ss_n32(cbs, cl, bh, kk > 0);
      wgmma_rs_n32(cbs, chi[kk], bl, 1);
      wgmma_rs_n32(cb, chi[kk], bh, kk > 0);
    }
    wg_commit();
    wg_wait0();
    fence_regs(cb);
    fence_regs(cbs);
    float4* out = cb_tile(a, ug, tt, j) + threadIdx.x * 4;
#pragma unroll
    for (int q = 0; q < 4; ++q)
      out[q] = make_float4(cb[q][0] + cbs[q][0], cb[q][1] + cbs[q][1],
                           cb[q][2] + cbs[q][2], cb[q][3] + cbs[q][3]);
  }
}

// Kernels 1 and 2 in one launch: the state blocks first, then the C B^T
// blocks, which the card runs in the state blocks' tail.
template <typename T, int NP>
__global__ void __launch_bounds__(kThreads, 3)
ssd_states_cb_kernel(const ArgsT<T> a, int state_blocks) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  if ((int)blockIdx.x < state_blocks)
    state_block(a, blockIdx.x, smem);
  else
    cb_block<T, NP>(a, blockIdx.x - state_blocks, smem);
}

// ---------------------------------------------------------------------------
// 3. the outputs of one 64-row tile of a chunk, one head
// ---------------------------------------------------------------------------
template <typename T, int NP>
__global__ void __launch_bounds__(kThreads, 3)
ssd_out_kernel(const ArgsT<T> a) {
  constexpr int KN = NP / 8;                 // k-steps over the state dim
  extern __shared__ float4 smem4[];
  float* acum = reinterpret_cast<float*>(smem4);
  float* dts = acum + kMaxL;
  float* Clo = dts + kMaxL;                  // C, (t, n)
  float* work = Clo + kBT * NP;              // C's hi, the state's hi and
  float* Xhi = work;                         // lo, then x dt's, (P, s)
  float* Xlo = work + kP * kBS;

  const Unit u = unit_of(a, blockIdx.x);
  const int64_t ug = ((int64_t)u.b * a.G + u.g) * a.nc + u.c;
  const int L = a.L, tid = threadIdx.x;
  const int tt = gridDim.y - 1 - blockIdx.y, t0 = tt * kBT;
  const int s_end = min(t0 + kBT, L);
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = warp * 16 + g;              // the thread's rows r0, r0 + 8
  const int p0 = blockIdx.z * kP;            // the block's head-dim columns
  const T* xb = a.x + u.b * a.sxb + u.h * a.sxh + u.c0 * a.sxs + p0;
  const float* dtb = a.dt + u.b * a.sdb + u.h * a.sdh + u.c0 * a.sds;
  const T* Cb = a.Cm + u.b * a.scb + u.g * a.scg + u.c0 * a.scs;

  for (int s = tid; s < kMaxL; s += kThreads) {
    if (s < s_end) acum[s] = a.acum[(int64_t)u.unit * L + s];
    dts[s] = s < u.npos ? dtb[(int64_t)s * a.sds] : 0.f;
  }

  float yacc[8][4];
  zero(yacc);
  if (u.c > 0) {
    // the carried state: exp(acum_t) (C_t . h), h^T staged 64 state
    // columns at a time; big += c_hi.h_hi, small += c_lo.h_hi + c_hi.h_lo
    // C's tile and the state's first 64 columns in flight together, the
    // next 64 columns during the products
    const float* st = a.states + ((int64_t)u.unit * a.P + p0) * a.N;
    const bool vec_st = (a.N & 3) == 0;
    RowTile<kP, 64, false, kThreads> ht;
    uint32_t chi[KN][4];
    {
      RowTile<kBT, NP, false, kThreads> ct;
      ct.load(Cb, a.scs, t0, u.npos, 0, a.N, a.vecC);
      ht.load(st, a.N, 0, kP, 0, a.N, vec_st);
      ct.store(work, Clo);
    }
    fence_proxy_async();
    __syncthreads();
    load_chi<NP>(work, chi);
    float small[8][4];
    zero(small);
    float* hhi = work;
    float* hlo = work + kP * 64;
#pragma unroll
    for (int piece = 0; piece < NP / 64; ++piece) {
      __syncthreads();             // C's hi read / the previous piece used
      ht.store(hhi, hlo);
      fence_proxy_async();
      __syncthreads();
      if (piece + 1 < NP / 64)
        ht.load(st, a.N, 0, kP, (piece + 1) * 64, a.N, vec_st);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        const int kg = piece * 8 + kk;
        const uint64_t cl = desc(Clo, kg, NP);
        const uint64_t hh = desc(hhi, kk, 64), hl = desc(hlo, kk, 64);
        wgmma_ss_n64(small, cl, hh, 1);
        wgmma_rs_n64(small, chi[kg], hl, 1);
        wgmma_rs_n64(yacc, chi[kg], hh, 1);
      }
      wg_commit();
      wg_wait0();
    }
    fence_regs(yacc);
    fence_regs(small);
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int tl = t0 + r0 + 8 * hr;
      const float e = tl < L ? expf(acum[tl]) : 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int q = 0; q < 2; ++q)
          yacc[j][2 * hr + q] =
              (yacc[j][2 * hr + q] + small[j][2 * hr + q]) * e;
    }
  }

  // within the chunk, s-tiles of 32 up to the diagonal: C B^T's fragment
  // and the x dt tile, the next tile's loads in flight during the current
  // tile's work
  float4 f[4];
  PosTile<kP, kBS, kThreads> xt;
  auto load_tile = [&](int j) {
    const float4* frag = cb_tile(a, ug, tt, j) + tid * 4;
#pragma unroll
    for (int q = 0; q < 4; ++q) f[q] = __ldg(frag + q);
    xt.load(xb, a.sxs, j * kBS, u.npos, kP);
  };
  load_tile(0);
  for (int s0 = 0, j = 0; s0 < s_end; s0 += kBS, ++j) {
    __syncthreads();               // the previous tile (or the state) read
    xt.store(Xhi, Xlo, s0, dts);
    fence_proxy_async();
    __syncthreads();
    float cbv[4][4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      cbv[q][0] = f[q].x, cbv[q][1] = f[q].y, cbv[q][2] = f[q].z,
      cbv[q][3] = f[q].w;
    }
    if (s0 + kBS < s_end) load_tile(j + 1);

    // M = C B^T o exp(acum_t - acum_s) o [t >= s]: accumulator column
    // group q holds s = s0 + 8q + t and s0 + 8q + t + 4 (B's rows were
    // permuted), exactly the A fragment of k-step q of M (x dt)
    uint32_t mhi[4][4], mlo[4][4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float m[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int tl = t0 + r0 + 8 * (e >> 1);
        const int sl = s0 + 8 * q + t + 4 * (e & 1);
        m[e] = (tl >= sl && tl < L) ? cbv[q][e] * expf(acum[tl] - acum[sl])
                                    : 0.f;
      }
      const float pa[4] = {m[0], m[2], m[1], m[3]};
#pragma unroll
      for (int k = 0; k < 4; ++k) split(pa[k], mhi[q][k], mlo[q][k]);
    }
    // y += M (x dt), the tile's product from zero
    float part[8][4] = {};
    wg_fence();
#pragma unroll
    for (int q = 0; q < kBS / 8; ++q) {
      const uint64_t xh = desc(Xhi, q, kBS), xl = desc(Xlo, q, kBS);
      wgmma_rs_n64(part, mlo[q], xh, q > 0);
      wgmma_rs_n64(part, mhi[q], xl, 1);
      wgmma_rs_n64(part, mhi[q], xh, 1);
    }
    wg_commit();
    wg_wait0();
    fence_regs(part);
#pragma unroll
    for (int q = 0; q < 8; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) yacc[q][e] += part[q][e];
  }

  const int64_t sys = (int64_t)a.H * a.P;
  T* yb = a.y + ((int64_t)u.b * a.S + u.c0) * sys + (int64_t)u.h * a.P + p0;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int tl = t0 + r0 + 8 * hr;
    if (tl >= u.npos) continue;
    T* row = yb + tl * sys;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      st2(row + j * 8 + 2 * t, yacc[j][2 * hr], yacc[j][2 * hr + 1]);
  }
}

constexpr int kStateSmem = (3 * kMaxL + 2 * kP * kBS1 + 2 * 64 * kBS1) * 4;
template <int NP>
constexpr int work_floats() {
  // C's hi, B's hi and lo, the state's hi and lo (64 columns), x dt's
  return kBT * NP > 2 * kP * 64 ? kBT * NP : 2 * kP * 64;
}
template <int NP>
constexpr int cb_smem() {
  return (kBT * NP + work_floats<NP>()) * 4;
}
template <int NP>
constexpr int out_smem() {
  return (2 * kMaxL + kBT * NP + work_floats<NP>()) * 4;
}

template <typename T, int NP>
cudaError_t launch(const ArgsT<T>& a, int bh, cudaStream_t stream) {
  static_assert(work_floats<NP>() >= 2 * kBS * NP &&
                    work_floats<NP>() >= 2 * kP * kBS,
                "the work tile holds B's and x dt's hi and lo");
  constexpr int first_smem =
      kStateSmem > cb_smem<NP>() ? kStateSmem : cb_smem<NP>();
  cudaError_t err = cudaFuncSetAttribute(
      ssd_states_cb_kernel<T, NP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, first_smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(ssd_out_kernel<T, NP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             out_smem<NP>());
  if (err != cudaSuccess) return err;
  const int64_t units = (int64_t)bh * a.nc;
  const int64_t state_blocks = (int64_t)bh * a.nP * (NP / 64);
  const int64_t first = state_blocks + (int64_t)a.units_g * a.nT;
  if (units > 0x7fffffff || first > 0x7fffffff)
    return cudaErrorInvalidConfiguration;
  ssd_states_cb_kernel<T, NP>
      <<<(unsigned)first, kThreads, first_smem, stream>>>(a,
                                                          (int)state_blocks);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_out_kernel<T, NP><<<dim3((unsigned)units, a.nT, a.nP), kThreads,
                          out_smem<NP>(), stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
int forward(const T* x, const float* dt, const float* A, const T* Bm,
            const T* Cm, T* y, float* hT, float* states, float* acum,
            float* cb, int Bsz, int S, int H, int G, int N, int P, int L,
            int64_t sxb, int64_t sxs, int64_t sxh, int64_t sdb, int64_t sds,
            int64_t sdh, int64_t sbb, int64_t sbs, int64_t sbg, int64_t scb,
            int64_t scs, int64_t scg, cudaStream_t stream) {
  if ((P != kP && P != 2 * kP) || N < 1 || N > kMaxN || L < 1 ||
      L > kMaxL || G < 1 || H % G != 0)
    return (int)cudaErrorInvalidValue;
  if (Bsz <= 0 || S <= 0 || H <= 0) return (int)cudaSuccess;
  // B and C rows 4 values at a time: bases aligned to 4 values and
  // strides of whole fours, N % 4 == 0
  auto vec = [&](const T* p, int64_t s0, int64_t s1, int64_t s2) {
    return (int)((((uintptr_t)p & (4 * sizeof(T) - 1)) == 0) &&
                 s0 % 4 == 0 && s1 % 4 == 0 && s2 % 4 == 0 && N % 4 == 0);
  };
  const int nc = (S + L - 1) / L;
  const ArgsT<T> a{x, dt, A, Bm, Cm, y, hT, states, acum, cb, S, H, G, N, L,
                   nc, (L + kBT - 1) / kBT, (L + kBS - 1) / kBS, P, P / kP,
                   Bsz * G * nc,
                   vec(Bm, sbb, sbs, sbg), vec(Cm, scb, scs, scg),
                   sxb, sxs, sxh, sdb, sds, sdh, sbb, sbs, sbg, scb, scs,
                   scg};
  return (int)(N <= 64 ? launch<T, 64>(a, Bsz * H, stream)
                       : launch<T, 128>(a, Bsz * H, stream));
}

}  // namespace

// Scratch, fp32, nchunks = ceil(S / L): states (B H nchunks, P, N); acum
// (B H nchunks, L); cb (B G nchunks, ceil(L / 64), ceil(L / 32), 2048).
// ssd_forward takes fp32 x, B, C and y; ssd_forward_bf16 bf16 ones.
extern "C" int ssd_forward(const float* x, const float* dt, const float* A,
                           const float* Bm, const float* Cm, float* y,
                           float* hT, float* states, float* acum, float* cb,
                           int Bsz, int S, int H, int G, int N, int P, int L,
                           int64_t sxb, int64_t sxs, int64_t sxh, int64_t sdb,
                           int64_t sds, int64_t sdh, int64_t sbb, int64_t sbs,
                           int64_t sbg, int64_t scb, int64_t scs, int64_t scg,
                           cudaStream_t stream) {
  return forward<float>(x, dt, A, Bm, Cm, y, hT, states, acum, cb, Bsz, S, H,
                        G, N, P, L, sxb, sxs, sxh, sdb, sds, sdh, sbb, sbs,
                        sbg, scb, scs, scg, stream);
}

extern "C" int ssd_forward_bf16(
    const __nv_bfloat16* x, const float* dt, const float* A,
    const __nv_bfloat16* Bm, const __nv_bfloat16* Cm, __nv_bfloat16* y,
    float* hT, float* states, float* acum, float* cb, int Bsz, int S, int H,
    int G, int N, int P, int L, int64_t sxb, int64_t sxs, int64_t sxh,
    int64_t sdb, int64_t sds, int64_t sdh, int64_t sbb, int64_t sbs,
    int64_t sbg, int64_t scb, int64_t scs, int64_t scg, cudaStream_t stream) {
  return forward<__nv_bfloat16>(x, dt, A, Bm, Cm, y, hT, states, acum, cb,
                                Bsz, S, H, G, N, P, L, sxb, sxs, sxh, sdb,
                                sds, sdh, sbb, sbs, sbg, scb, scs, scg,
                                stream);
}

// The device kernels one ssd_forward call launches.
extern "C" int ssd_kernels_per_call() { return 2; }
