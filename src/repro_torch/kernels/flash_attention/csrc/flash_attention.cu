// Flash-attention forward for Hopper (sm_90a): the CUDA counterpart of the
// Pallas kernel flash_attention_fwd in
// src/repro/kernels/flash_attention/kernel.py, and of the online-softmax
// scheme of src/repro/models/attention.py::_fa_fwd_inner that the JAX
// prefill runs.  One kernel, instantiated for two input types: fp32 in,
// fp32 out, fp32 accuracy; or bf16 in, bf16 out, as JAX's kernel computes
// at bf16 (bf16 operands into fp32 products, the softmax in fp32, P
// rounded to bf16 before P.V, o written in bf16).
//
//   q (B, H, Sq, DK), k (B, Hkv, Skv, DK), v (B, Hkv, Skv, DV): strided
//   views, the head dim at unit stride, every other stride a multiple of 4
//   floats and every base 16-byte aligned; o (B, H, Sq, DV) through its own
//   strides (the model's (B, S, H, DV) storage).  Query head h reads
//   key/value head h / group, so the grouped key/value heads are never
//   repeated in memory.  Built forms (DK, DV): (64, 64) (smollm-360m,
//   minicpm-2b), (96, 96) (phi3-mini-3.8b), (128, 128) (phi3-medium-14b)
//   and (192, 128): MLA's prefill (deepseek-v2-lite-16b), whose keys carry
//   128 latent-expanded columns and a 64-column RoPE slice and whose values
//   only the 128.  The scale is 1 / sqrt(DK).
//
// What bounds it.  At the serving prefill (B 8, 15 query and 5 key/value
// heads, S 1024, D 64, causal) one call does 4D operations per (query,
// key) pair for q.k and p.v: 16.1 GFLOP of products against 83.9 MB of
// input and output.  In fp32 outside the tensor cores (67 TFLOP/s) that
// is 0.24 ms, and the earlier SIMT version of this kernel reached a third
// of it.  The tensor cores are the only way past that, and plain TF32 (10
// mantissa bits) would break the port's parity with the fp32 reference.
// So both products run as 3xTF32: each operand x is split into hi =
// tf32(x) and lo = tf32(x - hi) and a.b is taken as a_hi.b_hi plus
// (a_lo.b_hi + a_hi.b_lo), the small terms in an accumulator of their own.
// The dropped a_lo.b_lo term and lo's own rounding are each about 2^-22
// relative per product, far below the 1e-5 the kernel is held to.  Three
// TF32 products at 495 TFLOP/s and the softmax at 67 bound it at about
// 0.10 ms; bytes (0.025 ms) do not.
//
// The design, for this card:
//   * wgmma (m64nNk8, tf32 in, fp32 accumulate) by inline PTX: one
//     warpgroup (4 warps, 64 query rows) per query head.  mma.sync peaks
//     well below wgmma's rate on this card, and with it each warp reads
//     every K and V fragment from shared memory for its own 16 rows;
//     wgmma reads a shared operand once for 64 rows.
//   * tf32 wgmma takes B K-major from shared memory, and A K-major from
//     shared memory or from registers.  q.k: Q's high part from registers
//     (loaded once), its low part and K (keys, d) from shared memory; p.v:
//     P from registers, V stored transposed, (d, keys).  The shared tiles
//     live in the no-swizzle layout of 8-row x 16-byte core matrices
//     (cm_offset), which wgmma reads without bank conflicts; a
//     descriptor's leading offset steps along k (128 bytes), its stride
//     offset along rows (a row group).
//   * One block per (batch, key/value head, 64-row query tile, chunk of at
//     most 3 query heads at D 64, 2 at D 96 and 128, 1 at (192, 128)): the
//     query heads of a GQA group share the block, so each K/V tile reaches
//     shared memory once per group, not once per query head.
//   * At (192, 128) Q's high part would take 96 registers a thread beside
//     the 64 of the output accumulator and the 64 of a tile's p.v, more
//     than the 255 a thread may hold: there it stays in shared memory
//     beside the low part (217 KB in all), and all three q.k products read
//     A from shared memory (SS).  The p.v side works at DV throughout.
//   * K/V tiles stream through a two-stage ring of raw fp32 tiles filled
//     by cp.async.cg 16-byte copies (zero-filled past Skv), rows padded to
//     DK + 4 and DV + 4 floats.  The block splits each tile once into hi
//     and lo tiles (V transposed on the way), double-buffered: after the
//     one barrier a tile, tile t + 2 is copied and tile t + 1 split while
//     tile t is multiplied.  Q is split once, before the key loop.  One
//     loop over K's 16-byte row chunks issues V's chunk beside K's where
//     the column is inside DV (DV <= DK).  A K loop then a V loop, the
//     same copies in another order, ran phi3-medium-14b's prefill (B 8,
//     40/10 heads, S 1024, D 128) in 2.0425 ms against this loop's 1.9993
//     (4 runs each in turns, tools/flash_turns.py, H100 80GB HBM3 at
//     700 W); at D 64 and at (192, 128) the two were within the spread.
//   * The probabilities never leave registers.  The q.k accumulator holds
//     columns 2t, 2t+1 of rows g, g+8 of each 8-column group, the p.v A
//     operand columns t, t+4.  So K's rows are stored permuted within each
//     group of 8 (storage row 2r holds key r, storage row 2r+1 key r+4):
//     the accumulator then holds keys t and t+4, exactly the A fragment
//     p.v takes.  Row max and row sum reduce over the quad of lanes that
//     share a row (__shfl_xor_sync 1, 2).
//   * The tensor cores add into an fp32 accumulator with truncation: a
//     chain of products over the whole key axis drifts past the 1e-5
//     tolerance over a thousand keys.  Each tile's p.v is taken from zero and
//     added to the output accumulator in fp32, rounded to nearest.
//   * The grid's slow axis walks the query tiles in reverse, so the
//     longest causal rows go first and the tail of the grid is short.
//
// The bf16 form.  At bf16 a call of smollm-360m's prefill is 16.4 GFLOP
// of products on 41.9 MB: 0.0166 ms at the bf16 tensor cores' 989 TFLOP/s,
// with the softmax's 0.25 GFLOP at fp32's 67 TFLOP/s 0.0201 ms, against
// 0.0125 ms of bytes, so it is bound by operations.  Both
// products are one bf16 wgmma each (m64nNk16, fp32 accumulators), no
// split: Q's A fragments come straight from global memory into registers
// (rows g, g + 8; columns 2t, 2t + 1 and 2t + 8, 2t + 9 of each 16-column
// k-step, two bf16 a register), K is stored unpermuted, since the
// accumulator of q.k holds columns 2t, 2t + 1 of each 8-column group,
// which is the A fragment of p.v as it stands (groups 2kk and 2kk + 1 make
// k-step kk).  The core matrices hold 8 bf16 a row; the raw ring and the
// K / V^T tiles hold bf16.  The running sum l adds the fp32 exponentials;
// P.V takes them rounded to bf16 (JAX's p.astype(v.dtype)) and adds into
// the output accumulator directly: the truncating adds' drift over a
// thousand keys (about 2^-23 a key) is far below bf16's 2^-9.
//
// Masking follows the reference exactly: a masked score is -1e30, never
// -inf (exp(-inf - -inf) is NaN), so a row whose first tile is wholly
// masked accumulates exp(0) terms that the first valid tile multiplies
// by exp(-1e30 - m) = 0, as the reference's online softmax does.  Key
// tiles wholly above the causal diagonal or wholly outside the window
// are skipped: their p is 0 and their correction factor 1, so skipping
// them is exact.  Keys past Skv get p = 0 outright and rows past Sq are
// not stored.  The output is acc / max(l, 1e-30).  No atomics.
//
// Plain C interface (loaded with ctypes): fa_forward launches on the given
// stream, allocates nothing, does not synchronise, and returns
// cudaGetLastError() so a refused launch is reported at once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kBQ = 64;            // query rows per head per block
constexpr int kWarpsPerHead = 4;   // one warpgroup per query head
constexpr int kStages = 2;         // raw K/V ring
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// Key rows per tile, query heads per block, and where Q's high part lives
// (registers, or shared memory beside the low part), so that shared memory
// (split Q, the raw ring, two split K/V buffers) stays under 227 KB and a
// thread under 255 registers.
template <int DK, int DV> struct Cfg;
template <> struct Cfg<64, 64> {
  static constexpr int kBK = 32;
  static constexpr int kMaxHeads = 3;
  static constexpr bool kQhiInRegs = true;
};
template <> struct Cfg<96, 96> {
  static constexpr int kBK = 16;
  static constexpr int kMaxHeads = 2;
  static constexpr bool kQhiInRegs = true;
};
template <> struct Cfg<128, 128> {
  static constexpr int kBK = 16;
  static constexpr int kMaxHeads = 2;
  static constexpr bool kQhiInRegs = true;
};
template <> struct Cfg<192, 128> {
  static constexpr int kBK = 16;
  static constexpr int kMaxHeads = 1;
  static constexpr bool kQhiInRegs = false;
};

// The bf16 form: 64 key rows a tile (32 at (192, 128), whose q.k takes
// 48 registers of Q fragments), Q in registers.
template <int DK, int DV> struct CfgBf16 {
  static constexpr int kBK = DK > 128 ? 32 : 64;
  static constexpr int kMaxHeads = Cfg<DK, DV>::kMaxHeads;
};

template <typename T>
constexpr bool kIsBf16 = std::is_same<T, __nv_bfloat16>::value;
template <typename T, int DK, int DV>
using CfgOf = typename std::conditional<kIsBf16<T>, CfgBf16<DK, DV>,
                                        Cfg<DK, DV>>::type;

template <typename T, int DK, int DV>
constexpr int smem_bytes() {
  using C = CfgOf<T, DK, DV>;
  constexpr int BK = C::kBK;
  if constexpr (kIsBf16<T>) {
    return kStages * BK * (DK + 8 + DV + 8) * 2    // raw K, V ring
           + 2 * BK * (DK + DV) * 2;               // K, V^T, x2
  } else {
    return C::kMaxHeads * (C::kQhiInRegs ? 1 : 2) * kBQ * DK * 4  // Q lo (hi)
           + kStages * BK * (DK + 4 + DV + 4) * 4  // raw K, V ring
           + 2 * 2 * BK * (DK + DV) * 4;           // K hi/lo, V^T hi/lo, x2
  }
}

struct Strides {
  int64_t b, h, s;
};

// x rounded to TF32 (10 mantissa bits), to nearest with ties away from
// zero: cvt.rna.tf32.f32's rounding, done as integer ops on the
// sign-magnitude bits (add half of the 13 dropped bits, clear them), which
// issue faster than the conversion.  Finite inputs only.
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void split4(float4 x, float4& hi, float4& lo) {
  uint32_t h[4], l[4];
  split(x.x, h[0], l[0]);
  split(x.y, h[1], l[1]);
  split(x.z, h[2], l[2]);
  split(x.w, h[3], l[3]);
  hi = make_float4(__uint_as_float(h[0]), __uint_as_float(h[1]),
                   __uint_as_float(h[2]), __uint_as_float(h[3]));
  lo = make_float4(__uint_as_float(l[0]), __uint_as_float(l[1]),
                   __uint_as_float(l[2]), __uint_as_float(l[3]));
}

// Byte offset of element (row, k) in the no-swizzle K-major layout of
// wgmma: 8-row x 16-byte core matrices, 128 contiguous bytes each, the
// core matrices of one 8-row group adjacent along k, the groups kdim / 4
// core matrices apart.
__device__ __forceinline__ int cm_offset(int row, int k, int kdim) {
  return ((row >> 3) * (kdim >> 2) + (k >> 2)) * 128 + (row & 7) * 16 +
         (k & 3) * 4;
}

// The same layout at 8 bf16 a core-matrix row.
__device__ __forceinline__ int cm_offset16(int row, int k, int kdim) {
  return ((row >> 3) * (kdim >> 3) + (k >> 3)) * 128 + (row & 7) * 16 +
         (k & 7) * 2;
}

// Two floats as a bf16 pair, rounded to nearest even, the first in the
// low half (the lower column).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// wgmma's shared-memory matrix descriptor, no swizzle: start address,
// leading byte offset (between core matrices along k), stride byte offset
// (between 8-row groups), each in 16-byte units.
__device__ __forceinline__ uint64_t make_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
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
// descriptor, RS takes A from registers (the mma A fragment of the warp's
// 16 rows).  scale_d = 0 starts the accumulator from zero.
__device__ __forceinline__ void wgmma_ss_n16(float (&d)[2][4],
                                              uint64_t adesc, uint64_t bdesc,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7},"
      " %8, %9, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3])
      : "l"(adesc), "l"(bdesc), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss_n32(float (&d)[4][4],
                                              uint64_t adesc, uint64_t bdesc,
                                              int scale_d) {
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

__device__ __forceinline__ void wgmma_rs_n16(float (&d)[2][4],
                                              const uint32_t a[4],
                                              uint64_t bdesc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7},"
      " {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(bdesc),
        "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n32(float (&d)[4][4],
                                              const uint32_t a[4],
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

__device__ __forceinline__ void wgmma_rs_n64(float (&d)[8][4],
                                              const uint32_t a[4],
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

__device__ __forceinline__ void wgmma_rs_n96(float (&d)[12][4],
                                             const uint32_t a[4],
                                             uint64_t bdesc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47},"
      " {%48, %49, %50, %51}, %52, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(bdesc),
        "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n128(float (&d)[16][4],
                                              const uint32_t a[4],
                                              uint64_t bdesc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63},"
      " {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(bdesc),
        "r"(scale_d));
}

// wgmma.m64nNk16, bf16 in, fp32 accumulate, A from registers (four
// registers of two bf16: rows g, g + 8 of the warp's 16, columns 2t, 2t + 1
// then 2t + 8, 2t + 9), B by descriptor, K-major (imm-trans-b 0).
#define FA_D4(i) "+f"(d[i][0]), "+f"(d[i][1]), "+f"(d[i][2]), "+f"(d[i][3])
__device__ __forceinline__ void wgmma_bf16_n32(float (&d)[4][4],
                                               const uint32_t a[4],
                                               uint64_t bdesc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15},"
      " {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : FA_D4(0), FA_D4(1), FA_D4(2), FA_D4(3)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(bdesc),
        "r"(scale_d));
}

__device__ __forceinline__ void wgmma_bf16_n64(float (&d)[8][4],
                                               const uint32_t a[4],
                                               uint64_t bdesc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31},"
      " {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : FA_D4(0), FA_D4(1), FA_D4(2), FA_D4(3), FA_D4(4), FA_D4(5),
        FA_D4(6), FA_D4(7)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(bdesc),
        "r"(scale_d));
}

__device__ __forceinline__ void wgmma_bf16_n96(float (&d)[12][4],
                                               const uint32_t a[4],
                                               uint64_t bdesc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47},"
      " {%48, %49, %50, %51}, %52, p, 1, 1, 0;\n}\n"
      : FA_D4(0), FA_D4(1), FA_D4(2), FA_D4(3), FA_D4(4), FA_D4(5),
        FA_D4(6), FA_D4(7), FA_D4(8), FA_D4(9), FA_D4(10), FA_D4(11)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(bdesc),
        "r"(scale_d));
}

__device__ __forceinline__ void wgmma_bf16_n128(float (&d)[16][4],
                                                const uint32_t a[4],
                                                uint64_t bdesc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63},"
      " {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : FA_D4(0), FA_D4(1), FA_D4(2), FA_D4(3), FA_D4(4), FA_D4(5),
        FA_D4(6), FA_D4(7), FA_D4(8), FA_D4(9), FA_D4(10), FA_D4(11),
        FA_D4(12), FA_D4(13), FA_D4(14), FA_D4(15)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(bdesc),
        "r"(scale_d));
}
#undef FA_D4

// The bf16 shapes: q.k at N = the tile's keys, p.v at N = DV.
template <int N> struct WB;
template <> struct WB<32> {
  static __device__ __forceinline__ void rs(float (&d)[4][4],
                                            const uint32_t a[4], uint64_t b,
                                            int s) {
    wgmma_bf16_n32(d, a, b, s);
  }
};
template <> struct WB<64> {
  static __device__ __forceinline__ void rs(float (&d)[8][4],
                                            const uint32_t a[4], uint64_t b,
                                            int s) {
    wgmma_bf16_n64(d, a, b, s);
  }
};
template <> struct WB<96> {
  static __device__ __forceinline__ void rs(float (&d)[12][4],
                                            const uint32_t a[4], uint64_t b,
                                            int s) {
    wgmma_bf16_n96(d, a, b, s);
  }
};
template <> struct WB<128> {
  static __device__ __forceinline__ void rs(float (&d)[16][4],
                                            const uint32_t a[4], uint64_t b,
                                            int s) {
    wgmma_bf16_n128(d, a, b, s);
  }
};

// The wgmma shapes the kernel uses.  q.k: N = the tile's keys, SS for
// q_lo.k_hi and RS (q_hi from registers) for the other two products, or SS
// for all three where q_hi stays in shared memory; p.v: N = DV, RS (P from
// registers).
template <int N> struct WG;
template <> struct WG<16> {
  static __device__ __forceinline__ void ss(float (&d)[2][4], uint64_t a,
                                            uint64_t b, int s) {
    wgmma_ss_n16(d, a, b, s);
  }
  static __device__ __forceinline__ void rs(float (&d)[2][4],
                                            const uint32_t a[4], uint64_t b,
                                            int s) {
    wgmma_rs_n16(d, a, b, s);
  }
};
template <> struct WG<32> {
  static __device__ __forceinline__ void ss(float (&d)[4][4], uint64_t a,
                                            uint64_t b, int s) {
    wgmma_ss_n32(d, a, b, s);
  }
  static __device__ __forceinline__ void rs(float (&d)[4][4],
                                            const uint32_t a[4], uint64_t b,
                                            int s) {
    wgmma_rs_n32(d, a, b, s);
  }
};
template <> struct WG<64> {
  static __device__ __forceinline__ void rs(float (&d)[8][4],
                                            const uint32_t a[4], uint64_t b,
                                            int s) {
    wgmma_rs_n64(d, a, b, s);
  }
};
template <> struct WG<96> {
  static __device__ __forceinline__ void rs(float (&d)[12][4],
                                            const uint32_t a[4], uint64_t b,
                                            int s) {
    wgmma_rs_n96(d, a, b, s);
  }
};
template <> struct WG<128> {
  static __device__ __forceinline__ void rs(float (&d)[16][4],
                                            const uint32_t a[4], uint64_t b,
                                            int s) {
    wgmma_rs_n128(d, a, b, s);
  }
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d),
               "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N));
}

// One tile's online-softmax step for the two rows (row, row + 8) a thread
// holds a quarter of: s (accumulator fragments, keys key0 + 8j + {0, ES}:
// ES 4 where K's rows were permuted (fp32), 1 where not (bf16)) becomes
// p; m, l and the accumulator are rescaled.  kMask applies the
// causal and window masks and the Skv tail.  Scores are taken in base 2:
// x = s scale log2(e) and p = 2^(x - m), one ex2 each where expf would
// reduce its argument first; the same softmax, and -1e30 still masks.
template <int NT, int KD, bool kMask, int ES>
__device__ __forceinline__ void online_softmax(float (&s)[NT][4], float m[2],
                                               float l[2], float (&acc)[KD][4],
                                               int row, int key0, int Skv,
                                               float scale_log2, int causal,
                                               int window) {
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int qr = row + 8 * hr;
    float mx = m[hr];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float x = s[j][2 * hr + e] * scale_log2;
        if (kMask) {
          const int kc = key0 + j * 8 + ES * e;
          const int rel = qr - kc;
          if (causal && rel < 0) x = kNegInf;
          if (window > 0 && rel >= window) x = kNegInf;
          if (kc < Skv) mx = fmaxf(mx, x);
        } else {
          mx = fmaxf(mx, x);
        }
        s[j][2 * hr + e] = x;
      }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float corr = exp2f(m[hr] - mx);
    float rs = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool ok = !kMask || key0 + j * 8 + ES * e < Skv;
        const float p = ok ? exp2f(s[j][2 * hr + e] - mx) : 0.f;
        s[j][2 * hr + e] = p;
        rs += p;
      }
    rs += __shfl_xor_sync(0xffffffffu, rs, 1);
    rs += __shfl_xor_sync(0xffffffffu, rs, 2);
    l[hr] = l[hr] * corr + rs;
    m[hr] = mx;
#pragma unroll
    for (int n = 0; n < KD; ++n) {
      acc[n][2 * hr] *= corr;
      acc[n][2 * hr + 1] *= corr;
    }
  }
}

template <typename T, int DK, int DV>
__global__ void __launch_bounds__((CfgOf<T, DK, DV>::kMaxHeads *
                                   kWarpsPerHead * 32), 1)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 Strides sq, Strides sk, Strides sv, Strides so, int Hkv,
                 int Sq, int Skv, int group, int heads_per_block,
                 int chunks, float scale_log2, int causal, int window) {
  using C = CfgOf<T, DK, DV>;
  constexpr bool kB = kIsBf16<T>;
  constexpr int BK = C::kBK;
  constexpr int NT = BK / 8;         // score column groups of a tile
  constexpr int NV = DV / 8;         // output column groups
  constexpr int EL = 16 / sizeof(T);   // elements a 16-byte copy
  constexpr int CK = DK / EL;        // 16-byte chunks a K (and Q) row
  static_assert(DV <= DK, "the K/V loader walks K's row chunks");
  constexpr int RK = DK + EL;        // raw K row, elements
  constexpr int RV = DV + EL;        // raw V row, elements
  extern __shared__ float4 smem4[];
  // fp32: [head][lo (| hi)][64*DK] of Q; bf16: no Q in shared memory
  constexpr int QBYTES =
      kB ? 0 : C::kMaxHeads * (Cfg<DK, DV>::kQhiInRegs ? 1 : 2) * kBQ * DK * 4;
  float* Qsm = reinterpret_cast<float*>(smem4);
  // [stage][K | V][BK][RK | RV]
  T* raw = reinterpret_cast<T*>(reinterpret_cast<char*>(smem4) + QBYTES);
  // fp32: [buffer][K hi | K lo | V^T hi | V^T lo]; bf16: [buffer][K | V^T]
  T* split_kv = raw + kStages * BK * (RK + RV);
  constexpr int KV_BUF = (kB ? 1 : 2) * BK * (DK + DV);   // elements

  const int nthreads = blockDim.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;

  // blockIdx.x: (b, kv head, head chunk); blockIdx.y: query tile, longest
  // causal rows first.
  const int chunk = blockIdx.x % chunks;
  const int bk = blockIdx.x / chunks;
  const int hkv = bk % Hkv, b = bk / Hkv;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;
  const int hw = warp / kWarpsPerHead;                // warpgroup = head
  const int gi = chunk * heads_per_block + hw;        // head within group
  const bool active = gi < group;
  const int h = hkv * group + gi;
  const int r0 = q0 + (warp % kWarpsPerHead) * 16;    // the warp's rows

  const T* kb = k + b * sk.b + hkv * sk.h;
  const T* vb = v + b * sv.b + hkv * sv.h;

  // Key tiles any row of this query tile can see.
  int kt_end = (Skv + BK - 1) / BK;
  if (causal) kt_end = min(kt_end, (q0 + kBQ - 1) / BK + 1);
  int kt_begin = 0;
  if (window > 0) {
    const int lo = q0 - window + 1;          // smallest key row q0 keeps
    kt_begin = lo > 0 ? lo / BK : 0;
  }

  auto issue = [&](int kt, int stage) {
    T* dk = raw + stage * BK * (RK + RV);
    T* dv = dk + BK * RK;
    const int k0 = kt * BK;
    for (int i = tid; i < BK * CK; i += nthreads) {
      const int r = i / CK, c = (i % CK) * EL;
      const bool ok = k0 + r < Skv;
      const int64_t row = ok ? k0 + r : 0;
      cp_async16(dk + r * RK + c, kb + row * sk.s + c, ok);
      if (c < DV) cp_async16(dv + r * RV + c, vb + row * sv.s + c, ok);
    }
    cp_async_commit();
  };
  // Tile kt's raw stage and split buffer are (kt - kt_begin) % 2.
  auto split_tile = [&](int buf) {
    const T* rk = raw + buf * BK * (RK + RV);
    const T* rv = rk + BK * RK;
    if constexpr (kB) {
      char* Kt = reinterpret_cast<char*>(split_kv + buf * KV_BUF);
      char* Vt = Kt + BK * DK * 2;
      // K: 16-byte chunks of a row into its core-matrix row, unpermuted
      for (int i = tid; i < BK * CK; i += nthreads) {
        const int r = i % BK, c = (i / BK) * 8;
        *reinterpret_cast<uint4*>(Kt + cm_offset16(r, c, DK)) =
            *reinterpret_cast<const uint4*>(rk + r * RK + c);
      }
      // V^T (rows d, k = keys): d fastest; eight keys a thread.
      const uint16_t* rv16 = reinterpret_cast<const uint16_t*>(rv);
      for (int i = tid; i < DV * (BK / 8); i += nthreads) {
        const int d = i % DV, r = (i / DV) * 8;
        uint32_t w[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          w[e] = (uint32_t)rv16[(r + 2 * e) * RV + d] |
                 ((uint32_t)rv16[(r + 2 * e + 1) * RV + d] << 16);
        *reinterpret_cast<uint4*>(Vt + cm_offset16(d, r, BK)) =
            make_uint4(w[0], w[1], w[2], w[3]);
      }
    } else {
      float* Khi = reinterpret_cast<float*>(split_kv + buf * KV_BUF);
      float* Klo = Khi + BK * DK;
      float* Vhi = Klo + BK * DK;
      float* Vlo = Vhi + BK * DV;
      // K: row r (key) fastest, so 8 neighbouring threads store the 8 rows
      // of one core matrix; storage row permuted (C -> A fragment).
      for (int i = tid; i < BK * CK; i += nthreads) {
        const int r = i % BK, c = (i / BK) * 4;
        const int rr = (r & ~7) | ((r & 3) << 1) | ((r >> 2) & 1);
        float4 hi, lo;
        split4(*reinterpret_cast<const float4*>(rk + r * RK + c), hi, lo);
        const int off = cm_offset(rr, c, DK) / 4;
        *reinterpret_cast<float4*>(Khi + off) = hi;
        *reinterpret_cast<float4*>(Klo + off) = lo;
      }
      // V^T (rows d, k = keys): d fastest; four keys a thread.
      for (int i = tid; i < DV * (BK / 4); i += nthreads) {
        const int d = i % DV, r = (i / DV) * 4;
        const float4 x = make_float4(rv[r * RV + d], rv[(r + 1) * RV + d],
                                     rv[(r + 2) * RV + d],
                                     rv[(r + 3) * RV + d]);
        float4 hi, lo;
        split4(x, hi, lo);
        const int off = cm_offset(d, r, BK) / 4;
        *reinterpret_cast<float4*>(Vhi + off) = hi;
        *reinterpret_cast<float4*>(Vlo + off) = lo;
      }
    }
    fence_proxy_async();
  };

  if (kt_begin < kt_end) {
    issue(kt_begin, 0);
    if (kt_begin + 1 < kt_end) issue(kt_begin + 1, 1);
  }
  if constexpr (!kB) {
    // The low part of the block's query rows, in the core-matrix layout
    // (rows m, k = d); the high part stays in registers (below), or beside
    // the low part where C::kQhiInRegs is false.
    constexpr int QP = C::kQhiInRegs ? 1 : 2;
    for (int i = tid; i < heads_per_block * kBQ * CK; i += nthreads) {
      const int m = i % kBQ, c = ((i / kBQ) % CK) * 4, hq = i / (kBQ * CK);
      const int gq = chunk * heads_per_block + hq;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (gq < group && q0 + m < Sq)
        x = *reinterpret_cast<const float4*>(
            q + b * sq.b + (int64_t)(hkv * group + gq) * sq.h +
            (int64_t)(q0 + m) * sq.s + c);
      float4 hi, lo;
      split4(x, hi, lo);
      float* dst = Qsm + hq * QP * kBQ * DK + cm_offset(m, c, DK) / 4;
      *reinterpret_cast<float4*>(dst) = lo;
      if constexpr (!C::kQhiInRegs)
        *reinterpret_cast<float4*>(dst + kBQ * DK) = hi;
    }
    fence_proxy_async();
  }
  if (kt_begin < kt_end) {
    if (kt_begin + 1 < kt_end) cp_async_wait<1>(); else cp_async_wait<0>();
    __syncthreads();
    split_tile(0);
  }

  // The warp's query rows as wgmma A fragments, in registers for the whole
  // key loop: fp32, rounded to TF32 (rows g, g + 8; columns t, t + 4 of
  // each 8-column k-step), where they fit; bf16, as they are (rows g,
  // g + 8; columns 2t, 2t + 1 and 2t + 8, 2t + 9 of each 16-column k-step).
  constexpr int KK = kB ? DK / 16 : DK / 8;   // q.k k-steps
  constexpr bool kQRegs = kB || Cfg<DK, DV>::kQhiInRegs;
  uint32_t qa[kQRegs ? KK : 1][4];
  {
    const T* qb = q + b * sq.b + h * sq.h;
    const bool ok0 = active && r0 + g < Sq, ok1 = active && r0 + g + 8 < Sq;
    const T* q0p = qb + (int64_t)(r0 + g) * sq.s;
    const T* q1p = qb + (int64_t)(r0 + g + 8) * sq.s;
    if constexpr (kB) {
      auto pair = [&](bool ok, const T* p) {
        return ok ? *reinterpret_cast<const uint32_t*>(p) : 0u;
      };
#pragma unroll
      for (int kk = 0; kk < KK; ++kk) {
        qa[kk][0] = pair(ok0, q0p + kk * 16 + 2 * t);
        qa[kk][1] = pair(ok1, q1p + kk * 16 + 2 * t);
        qa[kk][2] = pair(ok0, q0p + kk * 16 + 2 * t + 8);
        qa[kk][3] = pair(ok1, q1p + kk * 16 + 2 * t + 8);
      }
    } else if constexpr (kQRegs) {
#pragma unroll
      for (int kk = 0; kk < KK; ++kk) {
        qa[kk][0] = tf32(ok0 ? q0p[kk * 8 + t] : 0.f);
        qa[kk][1] = tf32(ok1 ? q1p[kk * 8 + t] : 0.f);
        qa[kk][2] = tf32(ok0 ? q0p[kk * 8 + t + 4] : 0.f);
        qa[kk][3] = tf32(ok1 ? q1p[kk * 8 + t + 4] : 0.f);
      }
    }
  }
  constexpr int QP = kB ? 1 : (Cfg<DK, DV>::kQhiInRegs ? 1 : 2);
  const float* Qlo = Qsm + hw * QP * kBQ * DK;   // fp32 only
  const float* Qhi = Qlo + kBQ * DK;       // read only if Q's hi is shared

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[NV][4];
#pragma unroll
  for (int j = 0; j < NV; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[j][c] = 0.f;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int it = kt - kt_begin;
    // One barrier a tile.  After it: tile kt's split buffer is complete,
    // tile kt + 1 has landed, and every warpgroup is done with tile kt - 1,
    // so its split buffer and raw stage are free.
    cp_async_wait<0>();
    __syncthreads();
    if (kt + 2 < kt_end) issue(kt + 2, it % 2);
    if (kt + 1 < kt_end) split_tile((it + 1) % 2);
    if (!active) continue;
    const int k0 = kt * BK;
    const bool interior = (!causal || k0 + BK - 1 <= r0) &&
                          (window <= 0 || r0 + 15 - k0 < window) &&
                          k0 + BK <= Skv;
    float s[NT][4] = {};

    if constexpr (kB) {
      const T* Kt = split_kv + (it % 2) * KV_BUF;
      const T* Vt = Kt + BK * DK;
      // s = q.k^T: k-step kk covers d 16kk..16kk+15, two core matrices of
      // 128 bytes
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < KK; ++kk)
        WB<BK>::rs(s, qa[kk], make_desc(Kt + kk * 128, 128, DK * 16),
                   kk > 0);
      wg_commit();
      wg_wait0();
      fence_regs(s);
      if (interior)
        online_softmax<NT, NV, false, 1>(s, m, l, acc, r0 + g, k0 + 2 * t,
                                         Skv, scale_log2, causal, window);
      else
        online_softmax<NT, NV, true, 1>(s, m, l, acc, r0 + g, k0 + 2 * t,
                                        Skv, scale_log2, causal, window);
      // acc += p.v: accumulator groups 2j, 2j + 1 are the A fragment of
      // k-step j (keys 16j..16j+15), rounded to bf16
      uint32_t pa[NT / 2][4];
#pragma unroll
      for (int j = 0; j < NT / 2; ++j) {
        pa[j][0] = pack_bf16(s[2 * j][0], s[2 * j][1]);
        pa[j][1] = pack_bf16(s[2 * j][2], s[2 * j][3]);
        pa[j][2] = pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]);
        pa[j][3] = pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3]);
      }
      wg_fence();
#pragma unroll
      for (int j = 0; j < NT / 2; ++j)
        WB<DV>::rs(acc, pa[j], make_desc(Vt + j * 128, 128, BK * 16), 1);
      wg_commit();
      wg_wait0();
      fence_regs(acc);
    } else {
      const float* Khi = reinterpret_cast<const float*>(
          split_kv + (it % 2) * KV_BUF);
      const float* Klo = Khi + BK * DK;
      const float* Vhi = Klo + BK * DK;
      const float* Vlo = Vhi + BK * DV;

      // s = q.k^T on the warpgroup's 64 rows: big += q_hi.k_hi, small +=
      // q_lo.k_hi + q_hi.k_lo; k-step kk covers d 8kk..8kk+7, two core
      // matrices of 128 bytes.  q_hi comes from registers (RS) where it
      // fits: an SS product re-reads its A tile from shared memory for
      // every 8 columns of k, which at N = 32 asks more bytes a cycle than
      // shared memory gives.
      float sl[NT][4] = {};
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < KK; ++kk) {
        const uint64_t ql = make_desc(Qlo + kk * 64, 128, DK * 32);
        const uint64_t kh = make_desc(Khi + kk * 64, 128, DK * 32);
        const uint64_t kl = make_desc(Klo + kk * 64, 128, DK * 32);
        WG<BK>::ss(sl, ql, kh, kk > 0);
        if constexpr (kQRegs) {
          WG<BK>::rs(sl, qa[kk], kl, 1);
          WG<BK>::rs(s, qa[kk], kh, kk > 0);
        } else {
          const uint64_t qh = make_desc(Qhi + kk * 64, 128, DK * 32);
          WG<BK>::ss(sl, qh, kl, 1);
          WG<BK>::ss(s, qh, kh, kk > 0);
        }
      }
      wg_commit();
      wg_wait0();
      fence_regs(s);
      fence_regs(sl);
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[j][c] += sl[j][c];

      if (interior)
        online_softmax<NT, NV, false, 4>(s, m, l, acc, r0 + g, k0 + t, Skv,
                                         scale_log2, causal, window);
      else
        online_softmax<NT, NV, true, 4>(s, m, l, acc, r0 + g, k0 + t, Skv,
                                        scale_log2, causal, window);

      // acc += p.v: accumulator group j is the A fragment of k-step j
      // (rows g, g + 8; keys t, t + 4), split once; the tile's product from
      // zero.
      uint32_t phi[NT][4], plo[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float pa[4] = {s[j][0], s[j][2], s[j][1], s[j][3]};
#pragma unroll
        for (int c = 0; c < 4; ++c) split(pa[c], phi[j][c], plo[j][c]);
      }
      float part[NV][4] = {};
      wg_fence();
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const uint64_t vh = make_desc(Vhi + j * 64, 128, BK * 32);
        const uint64_t vl = make_desc(Vlo + j * 64, 128, BK * 32);
        WG<DV>::rs(part, plo[j], vh, j > 0);
        WG<DV>::rs(part, phi[j], vl, 1);
        WG<DV>::rs(part, phi[j], vh, 1);
      }
      wg_commit();
      wg_wait0();
      fence_regs(part);
#pragma unroll
      for (int n = 0; n < NV; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[n][c] += part[n][c];
    }
  }

  if (!active) return;
  T* ob = o + b * so.b + h * so.h;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int qr = r0 + g + 8 * hr;
    if (qr >= Sq) continue;
    const float den = fmaxf(l[hr], 1e-30f);
    T* orow = ob + (int64_t)qr * so.s;
#pragma unroll
    for (int n = 0; n < NV; ++n) {
      const float x0 = acc[n][2 * hr] / den, x1 = acc[n][2 * hr + 1] / den;
      if constexpr (kB)
        *reinterpret_cast<uint32_t*>(orow + n * 8 + 2 * t) =
            pack_bf16(x0, x1);
      else
        *reinterpret_cast<float2*>(orow + n * 8 + 2 * t) =
            make_float2(x0, x1);
    }
  }
}

template <typename T, int DK, int DV>
cudaError_t launch(const T* q, const T* k, const T* v, T* o, Strides sq,
                   Strides sk, Strides sv, Strides so, int B, int Hkv,
                   int Sq, int Skv, int group, float scale, int causal,
                   int window, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<T, DK, DV>();
  static_assert(bytes <= 232448, "over the 227 KB a block may use");
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, DK, DV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  constexpr int kMaxHeads = CfgOf<T, DK, DV>::kMaxHeads;
  const int chunks = (group + kMaxHeads - 1) / kMaxHeads;
  const int heads_per_block = (group + chunks - 1) / chunks;
  const int64_t gx = (int64_t)B * Hkv * chunks;
  const int64_t gy = (Sq + kBQ - 1) / kBQ;
  if (gx > 0x7fffffff || gy > 65535) return cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)gx, (unsigned)gy);
  flash_fwd_kernel<T, DK, DV><<<grid, heads_per_block * kWarpsPerHead * 32,
                                bytes, stream>>>(
      q, k, v, o, sq, sk, sv, so, Hkv, Sq, Skv, group, heads_per_block,
      chunks, scale * kLog2e, causal, window);
  return cudaGetLastError();
}

template <typename T>
int forward(const T* q, const T* k, const T* v, T* o, const int64_t* strides,
            int B, int Hkv, int Sq, int Skv, int Dk, int Dv, int group,
            float scale, int causal, int window, cudaStream_t stream) {
  if (B <= 0 || Hkv <= 0 || group <= 0 || Sq <= 0 || Skv <= 0)
    return (int)cudaSuccess;
  const Strides sq{strides[0], strides[1], strides[2]};
  const Strides sk{strides[3], strides[4], strides[5]};
  const Strides sv{strides[6], strides[7], strides[8]};
  const Strides so{strides[9], strides[10], strides[11]};
#define FA_FORM(DK, DV)                                                    \
  if (Dk == DK && Dv == DV)                                                \
    return (int)launch<T, DK, DV>(q, k, v, o, sq, sk, sv, so, B, Hkv, Sq,  \
                                  Skv, group, scale, causal, window,       \
                                  stream);
  FA_FORM(64, 64)
  FA_FORM(96, 96)
  FA_FORM(128, 128)
  FA_FORM(192, 128)
#undef FA_FORM
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int fa_forward(const float* q, const float* k, const float* v,
                          float* o, const int64_t* strides, int B, int Hkv,
                          int Sq, int Skv, int Dk, int Dv, int group,
                          float scale, int causal, int window,
                          cudaStream_t stream) {
  return forward<float>(q, k, v, o, strides, B, Hkv, Sq, Skv, Dk, Dv, group,
                        scale, causal, window, stream);
}

extern "C" int fa_forward_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                               const __nv_bfloat16* v, __nv_bfloat16* o,
                               const int64_t* strides, int B, int Hkv,
                               int Sq, int Skv, int Dk, int Dv, int group,
                               float scale, int causal, int window,
                               cudaStream_t stream) {
  return forward<__nv_bfloat16>(q, k, v, o, strides, B, Hkv, Sq, Skv, Dk, Dv,
                                group, scale, causal, window, stream);
}
