// Patch attention forward (K3-fwd) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel `_flash_attention_kernel_single_batch` of
// jax/experimental/pallas/ops/tpu/flash_attention.py, which the JAX
// package calls from splatformer_tpu/models/ptv3.py for its `enable_flash`
// configurations (patch 1024). Same contract, without the TPU's padding of
// the head width to 128: q, k, v (B*H, K, D) contiguous, all float32 or all
// bfloat16; s = (q . k) * scale in float32; the unnormalised probabilities
// cast to v's type before P V; the row sum l taken from the float32
// probabilities; float32 accumulation; o (B*H, K, D) in the input type and
// lse (B*H, K) = max + log(l) in float32, which the backward
// (attention_bwd.cu) recomputes P from. D is 16, 24 or 32 (the head widths
// of PTv3-base); K is a multiple of 64.
//
// What bounds it on this card: operations. Per (query, key) pair 2 D
// multiply-adds (q . k and p v) and one exponential, against 4 D elements
// read or written per token, so bytes never bind.
//
// float32 (serving): tensor cores, as split TF32 ("3xTF32") products on
// mma.sync m16n8k8 tf32 x tf32 -> f32. A TF32 operand keeps 10 of float32's
// 23 mantissa bits, and one TF32 product a product misses the float32
// limits by 30x and more; so every operand x is split into hi = tf32(x) and
// lo = tf32(x - hi), each rounded to nearest as cvt.rna.tf32.f32 rounds,
// and each product is a_lo b_hi + a_hi b_lo, then a_hi b_hi, into one
// float32 accumulator (the small terms first, as CUTLASS's 3xTF32 GEMMs;
// a_lo b_lo, ~2^-22 of the product, is dropped).
// tests/test_torch_attention_tf32.py emulates this order on the CPU. The
// CTA is the bfloat16 kernel's: 4 warps, 16 queries a warp, q split once
// into A fragments in registers. K and V arrive in 64-key tiles by
// cp.async into raw staging tiles; one pass of the whole CTA then splits
// each landed tile once into hi/lo tiles (every element is read by all 4
// warps, so a split at fragment-load time would cost 4x the conversions),
// and the next tile's copy runs into the freed staging tiles while the
// warps compute on the split ones: staging and split tiles are the two
// buffers. The reduction index is permuted inside each k8 step (A column t
// = key or d 2t, column t + 4 = 2t + 1): then an S accumulator (C fragment,
// columns 2t, 2t + 1 of row g) is P V's A fragment as (c0, c2, c1, c3)
// without shuffles, V's B fragment takes keys 2t and 2t + 1, and K's B
// fragment K[key][2t, 2t + 1] is adjacent. The split tiles interleave hi
// and lo so that a B fragment with both halves is one 16-byte load, with
// row strides of 16 (K) and 8 (V) mod 32 words, which spread a quarter
// warp's eight loads over all 32 banks (Split<D>). d = 24 is three k8
// steps and three n8 tiles, no padding.
//
// What binds it, per CTA and 64-key tile (64 queries): 24 D mma (6 D a
// warp; the bfloat16 kernel issues 4 D), 128 MUFU.EX2 (32 a warp), ~10
// other instructions a lane an element of P (max, FFMA, sum, and the
// split's two integer roundings and a subtraction) and ~6 an element of the
// K and V tiles for their split; every warp reads the split K and V tiles
// whole (16 D bytes a key, 4096 D bytes a CTA tile) and the split pass
// moves 2048 D more. At peak rates: the tensor pipe 24 D clocks (495
// TFLOP/s TF32, ~1 m16n8k8 a clock per SM), shared memory 48 D (128 bytes
// a clock), the SFU 256 (1.5x under the tensor pipe at D = 16), issue ~550
// a sub-partition at D = 16. k3_experiments.py times variants that issue a
// third of the mma or read half of the B fragments: each removes a large
// share of the time, so the tensor pipe under mma.sync and the shared-
// memory reads bind together, with issue close behind. The split itself
// costs little once its rounding is two integer operations. Next steps:
// 32 rows a warp (each B fragment feeds two m16 tiles: half the reads,
// more independent mma; ~60 more registers at D = 32), then wgmma (TF32
// at the full tensor rate; its 64-row tiles and shared-memory operands
// need another split layout).
//
// bfloat16 (training): tensor cores, mma.sync m16n8k16 bf16 x bf16 -> f32,
// the same CTA shape. Here the products are the tensor cores' own operation
// (989 TFLOP/s) and the exponentials on the SFU (16 a clock per SM) bind
// instead: at D <= 32 they take ~3x the tensor-core time. Each warp's q is
// loaded once into mma A fragments. K and V stream through shared memory
// in 64-key tiles, double-buffered with cp.async so the next tile loads
// while the current one computes; rows are padded to D rounded up to 16
// plus 8 elements, so ldmatrix reads them without bank conflicts, and at
// D = 24 the pad columns 24..31 are zero, which makes the reduction over
// d two exact k16 steps. Per tile: S = Q K^T (K through ldmatrix as the B
// operand), the row max by quad shuffles, one rescale of the accumulator
// and of the thread's partial row sums, P = ex2(s c - m)
// (one MUFU op each, c = scale log2 e), and P V with P packed to bf16 with
// round-to-nearest straight from the S accumulators: an m16n8k16 C fragment
// pair is an A fragment. V is the B operand through ldmatrix.trans. The
// design's job is to keep the SFU busy: the mma and the copies hide behind
// the exponentials, and the FP32 work per pair is a max, an FFMA, an add
// and half a pack. Not used: wgmma and TMA, which pay off for wide heads
// (at D <= 32 the SFU binds long before mma.sync's rate does).
//
// Nothing of size K x K is ever stored: the kernel keeps only lse.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// ---------------------------------------------------------------------------
// Shared by both kernels, then bfloat16. These helpers are repeated in
// attention_bwd.cu on purpose: a library is rebuilt when its own source's
// hash changes.

using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 64;  // queries per CTA = keys per staged tile

// the reduction width over d (D zero-padded to a multiple of 16) and the
// shared-memory row stride in elements: 48 or 80 bytes, so the 8 rows an
// ldmatrix phase reads fall in 8 distinct 16-byte bank groups
template <int D>
struct Rows {
  static constexpr int kPad = (D + 15) / 16 * 16;
  static constexpr int kStride = kPad + 8;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <bool kTrans>
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  if constexpr (kTrans) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
        "[%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(addr));
  } else {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(addr));
  }
}

template <bool kTrans>
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], uint32_t addr) {
  if constexpr (kTrans) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
        : "=r"(r[0]), "=r"(r[1])
        : "r"(addr));
  } else {
    asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
                 : "=r"(r[0]), "=r"(r[1])
                 : "r"(addr));
  }
}

// The 8x8 blocks of NKB row blocks x C column chunks of a row-major bf16
// tile in shared memory (row stride kStride), one register each:
// r[b][c] holds rows 8b..8b+7, columns 8c..8c+7. Without kTrans lane i
// gets (row i/4, columns 2(i%4), +1) of its block: an mma B fragment half
// for B = tile^T (k along the columns). With kTrans it gets (rows 2(i%4),
// +1, column i/4): a B fragment half for B = tile (k along the rows).
template <int NKB, int C, bool kTrans, int kStride>
__device__ __forceinline__ void load_blocks(uint32_t (&r)[NKB][C],
                                            const bf16* tile, int lane) {
  constexpr int M = NKB * C;
  static_assert(M % 2 == 0, "blocks are read two or four at a time");
#pragma unroll
  for (int i = 0; i < M / 4; ++i) {
    const int mi = 4 * i + (lane >> 3);
    uint32_t x[4];
    ldsm_x4<kTrans>(x, smem_addr(tile + (8 * (mi / C) + (lane & 7)) * kStride
                                 + 8 * (mi % C)));
#pragma unroll
    for (int e = 0; e < 4; ++e) r[(4 * i + e) / C][(4 * i + e) % C] = x[e];
  }
  if constexpr (M % 4 != 0) {
    const int mi = M - 2 + ((lane >> 3) & 1);
    uint32_t x[2];
    ldsm_x2<kTrans>(x, smem_addr(tile + (8 * (mi / C) + (lane & 7)) * kStride
                                 + 8 * (mi % C)));
    r[(M - 2) / C][(M - 2) % C] = x[0];
    r[(M - 1) / C][(M - 1) % C] = x[1];
  }
}

// d += a b: m16n8k16, bf16 x bf16 -> f32
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to nearest bf16 and packed, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// 2^x, one MUFU op (inputs below -126 give 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// A fragments (m16 x k16 per step, d zero-padded) of the 16 rows starting
// at `rows`: lane (g, t) = (lane / 4, lane % 4) holds rows g and g + 8 at
// columns 16s + 2t, +1 and 16s + 8 + 2t, +1
template <int D>
__device__ __forceinline__ void load_a_rows(
    uint32_t (&a)[Rows<D>::kPad / 16][4], const bf16* rows, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const bf16* r0 = rows + g * D;
  const bf16* r1 = r0 + 8 * D;
#pragma unroll
  for (int s = 0; s < Rows<D>::kPad / 16; ++s) {
    const int c0 = 16 * s + 2 * t, c1 = c0 + 8;
    a[s][0] = c0 < D ? *reinterpret_cast<const uint32_t*>(r0 + c0) : 0u;
    a[s][1] = c0 < D ? *reinterpret_cast<const uint32_t*>(r1 + c0) : 0u;
    a[s][2] = c1 < D ? *reinterpret_cast<const uint32_t*>(r0 + c1) : 0u;
    a[s][3] = c1 < D ? *reinterpret_cast<const uint32_t*>(r1 + c1) : 0u;
  }
}

// a tile of kTile contiguous rows of D elements into shared memory
template <int D>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src) {
  constexpr int C = D / 8;  // 16-byte chunks a row
  for (int i = threadIdx.x; i < kTile * C; i += kThreads) {
    cp_async16(dst + (i / C) * Rows<D>::kStride + (i % C) * 8, src + i * 8);
  }
}

// zero the pad columns [D, kPad) of `n` rows (D = 24 only)
template <int D>
__device__ __forceinline__ void zero_pad(bf16* rows, int n) {
  for (int c = D; c < Rows<D>::kPad; c += 8) {
    for (int r = threadIdx.x; r < n; r += kThreads) {
      *reinterpret_cast<uint4*>(rows + r * Rows<D>::kStride + c) =
          make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
attention_fwd_bf16_kernel(const bf16* __restrict__ q,
                          const bf16* __restrict__ k,
                          const bf16* __restrict__ v, bf16* __restrict__ o,
                          float* __restrict__ lse, int seq,
                          float scale_log2) {
  constexpr int S = Rows<D>::kStride;
  constexpr int KS = Rows<D>::kPad / 16;  // k16 steps over d
  constexpr int NT = D / 8;               // n8 tiles of o
  __shared__ __align__(16) bf16 s_k[2][kTile * S];
  __shared__ __align__(16) bf16 s_v[2][kTile * S];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const long long head = blockIdx.y;  // patch * H + head
  const int row0 = blockIdx.x * kTile + 16 * warp;
  const bf16* kh = k + head * seq * D;
  const bf16* vh = v + head * seq * D;

  zero_pad<D>(&s_k[0][0], 2 * kTile);
  zero_pad<D>(&s_v[0][0], 2 * kTile);
  stage_rows<D>(s_k[0], kh);
  stage_rows<D>(s_v[0], vh);
  cp_async_commit();

  uint32_t qa[KS][4];
  load_a_rows<D>(qa, q + (head * seq + row0) * D, lane);
  float c = scale_log2;
  if (c < 0.f) {  // s c = (-s)(-c) exactly: keep c >= 0 for the row max
#pragma unroll
    for (int s = 0; s < KS; ++s)
#pragma unroll
      for (int e = 0; e < 4; ++e) qa[s][e] ^= 0x80008000u;
    c = -c;
  }

  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  // rows g and g + 8: running max of s c, and this thread's share of the
  // running sum of ex2(s c - m) (its 16 columns of every tile)
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F};
  float l[2] = {0.f, 0.f};

  const int tiles = seq / kTile;
  for (int it = 0; it < tiles; ++it) {
    const int buf = it & 1;
    if (it + 1 < tiles) {
      const long long next = static_cast<long long>(it + 1) * kTile * D;
      stage_rows<D>(s_k[buf ^ 1], kh + next);
      stage_rows<D>(s_v[buf ^ 1], vh + next);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile `it` has landed for every thread

    // S = Q K^T over the tile's 64 keys: 8 n8 tiles
    float s[8][4];
    {
      uint32_t kb[8][Rows<D>::kPad / 8];
      load_blocks<8, Rows<D>::kPad / 8, false, S>(kb, s_k[buf], lane);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
        for (int ks = 0; ks < KS; ++ks)
          mma16816(s[j], qa[ks], kb[j][2 * ks], kb[j][2 * ks + 1]);
      }
    }

    // online softmax: one max update and one rescale a tile
    float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
    }
    float corr[2], neg_m[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r] * c);  // c >= 0: max(s) c
      corr[r] = ex2(m[r] - m_new);                 // 0 on the first tile
      m[r] = m_new;
      neg_m[r] = -m_new;
      l[r] *= corr[r];
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      acc[n][0] *= corr[0];
      acc[n][1] *= corr[0];
      acc[n][2] *= corr[1];
      acc[n][3] *= corr[1];
    }

    // P in f32 for l, rounded to bf16 as P V's A fragments: k16 step ks
    // covers n8 tiles 2 ks (a0, a1) and 2 ks + 1 (a2, a3)
    uint32_t pa[4][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float p0 = ex2(fmaf(s[j][0], c, neg_m[0]));
      const float p1 = ex2(fmaf(s[j][1], c, neg_m[0]));
      const float p2 = ex2(fmaf(s[j][2], c, neg_m[1]));
      const float p3 = ex2(fmaf(s[j][3], c, neg_m[1]));
      l[0] += p0 + p1;
      l[1] += p2 + p3;
      pa[j >> 1][2 * (j & 1)] = pack_bf16(p0, p1);
      pa[j >> 1][2 * (j & 1) + 1] = pack_bf16(p2, p3);
    }

    // O += P V
    {
      uint32_t vb[8][NT];
      load_blocks<8, NT, true, S>(vb, s_v[buf], lane);
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
#pragma unroll
        for (int n = 0; n < NT; ++n)
          mma16816(acc[n], pa[ks], vb[2 * ks][n], vb[2 * ks + 1][n]);
    }
    __syncthreads();  // every warp is done with `buf` before it refills
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  bf16* o0 = o + (head * seq + row0 + g) * D + 2 * t;
  bf16* o1 = o0 + 8 * D;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    *reinterpret_cast<uint32_t*>(o0 + 8 * n) =
        pack_bf16(acc[n][0] / l[0], acc[n][1] / l[0]);
    *reinterpret_cast<uint32_t*>(o1 + 8 * n) =
        pack_bf16(acc[n][2] / l[1], acc[n][3] / l[1]);
  }
  if (t == 0) {
    lse[head * seq + row0 + g] = m[0] * kLn2 + logf(l[0]);
    lse[head * seq + row0 + g + 8] = m[1] * kLn2 + logf(l[1]);
  }
}

// ---------------------------------------------------------------------------
// float32: tensor cores, split TF32 (3xTF32)

// x rounded to TF32 (10 mantissa bits) to nearest, ties away from zero: a
// float32 whose low 13 bits are 0. The rounding of cvt.rna.tf32.f32, in two
// integer operations: half the dropped bits' range is added to the
// magnitude (a carry moves into the exponent), then they are cleared. For
// finite x the two agree bit for bit; the PTX cvt compiles to five SASS
// instructions with its NaN handling, and this split runs for every
// element of P and of each K and V tile (k3_experiments.py, cvt_rna).
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo to ~2^-22 of x: hi = tf32(x), lo = tf32(x - hi), the
// difference being exact
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// d += a b: m16n8k8, tf32 x tf32 -> f32
__device__ __forceinline__ void mma1688(float (&d)[4], const uint32_t (&a)[4],
                                        uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b as three TF32 products, the small terms first: a_lo b_hi, a_hi
// b_lo, then a_hi b_hi (a_lo b_lo, ~2^-22 of the product, is dropped). b is
// a B fragment with its halves as the split tiles hold it: {b0 hi, b1 hi,
// b0 lo, b1 lo}.
__device__ __forceinline__ void mma_3xtf32(float (&d)[4],
                                           const uint32_t (&a_hi)[4],
                                           const uint32_t (&a_lo)[4],
                                           uint4 b) {
  mma1688(d, a_lo, b.x, b.y);
  mma1688(d, a_hi, b.z, b.w);
  mma1688(d, a_hi, b.x, b.y);
}

// The float32 kernel's shared memory, in 4-byte words: the raw K and V
// tiles that cp.async fills (kTile x D each), then the split tiles. K is
// held as [key][d pair p][hi(2p), hi(2p + 1), lo(2p), lo(2p + 1)] with a
// row stride of 16 mod 32 words, V as [key pair i][column c][hi(V[2i][c]),
// hi(V[2i + 1][c]), lo(V[2i][c]), lo(V[2i + 1][c])] with a row stride of 8
// mod 32, so a B fragment with both halves is one 16-byte load. A quarter
// warp's eight such loads (lanes g, g + 1 x t = 0..3) then lie 16 words
// apart across g and 4 across t (K), or 4 across g and 8 across t (V): 32
// distinct banks, no conflict.
template <int D>
struct Split {
  static constexpr int kKStride = (2 * D) % 32 == 16 ? 2 * D : 2 * D + 16;
  static constexpr int kVStride = 4 * D + 8;
  static constexpr int kRaw = kTile * D;
  static constexpr int kBytes =
      4 * (2 * kRaw + kTile * kKStride + kTile / 2 * kVStride);
  static_assert(D % 8 == 0 && kKStride % 32 == 16 && kVStride % 32 == 8,
                "bank-conflict-free strides");
  static_assert(kTile * D % (4 * kThreads) == 0, "whole passes of the CTA");
};

// one raw tile of kTile contiguous rows of D floats into shared memory
template <int D>
__device__ __forceinline__ void stage_raw(float* dst, const float* src) {
#pragma unroll
  for (int r = 0; r < kTile * D / (4 * kThreads); ++r) {
    const int i = 4 * (threadIdx.x + r * kThreads);
    cp_async16(dst + i, src + i);
  }
}

// the landed raw tiles split into the K and V layouts of Split<D>, each
// element once for all four warps
template <int D>
__device__ __forceinline__ void split_tile(float* kf, float* vf,
                                           const float* raw_k,
                                           const float* raw_v) {
#pragma unroll
  for (int r = 0; r < kTile * D / (2 * kThreads); ++r) {
    const int i = threadIdx.x + r * kThreads;  // (key, d pair)
    const float2 x = reinterpret_cast<const float2*>(raw_k)[i];
    uint4 w;
    split_tf32(x.x, w.x, w.z);
    split_tf32(x.y, w.y, w.w);
    *reinterpret_cast<uint4*>(kf + (i / (D / 2)) * Split<D>::kKStride
                              + 4 * (i % (D / 2))) = w;
  }
#pragma unroll
  for (int r = 0; r < kTile * D / (2 * kThreads); ++r) {
    const int i = threadIdx.x + r * kThreads;  // (key pair, column)
    const int pair = i / D, col = i % D;
    uint4 w;
    split_tf32(raw_v[2 * pair * D + col], w.x, w.z);
    split_tf32(raw_v[(2 * pair + 1) * D + col], w.y, w.w);
    *reinterpret_cast<uint4*>(vf + pair * Split<D>::kVStride + 4 * col) = w;
  }
}

// CTAs an SM the compiler keeps registers for (the second bound): 4 at
// D = 16 (121 registers a thread); 3 at D = 24 and 32, up to 168 registers.
// Unbounded, D = 32 takes 176 registers and 2 CTAs an SM, and D = 24 is
// scheduled in 132 for the same 3 CTAs an SM, both slower
// (k3_experiments.py, no_min_blocks).
template <int D>
__global__ void __launch_bounds__(kThreads, D == 16 ? 4 : 3)
attention_fwd_tf32x3_kernel(const float* __restrict__ q,
                            const float* __restrict__ k,
                            const float* __restrict__ v,
                            float* __restrict__ o, float* __restrict__ lse,
                            int seq, float scale_log2) {
  using L = Split<D>;
  constexpr int KS = D / 8;  // k8 steps over d in Q K^T = n8 tiles of o
  extern __shared__ __align__(16) float smem[];
  float* raw_k = smem;
  float* raw_v = raw_k + L::kRaw;
  float* kf = raw_v + L::kRaw;
  float* vf = kf + kTile * L::kKStride;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const long long head = blockIdx.y;  // patch * H + head
  const int row0 = blockIdx.x * kTile + 16 * warp;
  const float* kh = k + head * seq * D;
  const float* vh = v + head * seq * D;

  stage_raw<D>(raw_k, kh);
  stage_raw<D>(raw_v, vh);
  cp_async_commit();

  // q's A fragments, split once. With d permuted inside each k8 step
  // (column t = d 8s + 2t, column t + 4 = d 8s + 2t + 1) a lane's two
  // columns of a row are adjacent, and so are K's in the B fragment.
  float c = scale_log2;
  const float sgn = c < 0.f ? -1.f : 1.f;  // s c = (sgn s)(sgn c) exactly:
  c *= sgn;                                // keep c >= 0 for the row max
  uint32_t qh[KS][4], ql[KS][4];
  {
    const float* q0 = q + (head * seq + row0 + g) * D + 2 * t;
    const float* q1 = q0 + 8 * D;
#pragma unroll
    for (int s = 0; s < KS; ++s) {
      const float2 x0 = *reinterpret_cast<const float2*>(q0 + 8 * s);
      const float2 x1 = *reinterpret_cast<const float2*>(q1 + 8 * s);
      split_tf32(sgn * x0.x, qh[s][0], ql[s][0]);
      split_tf32(sgn * x1.x, qh[s][1], ql[s][1]);
      split_tf32(sgn * x0.y, qh[s][2], ql[s][2]);
      split_tf32(sgn * x1.y, qh[s][3], ql[s][3]);
    }
  }

  float acc[KS][4];
#pragma unroll
  for (int n = 0; n < KS; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  // rows g and g + 8: running max of s c, and this thread's share of the
  // running sum of ex2(s c - m) (its 16 columns of every tile)
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F};
  float l[2] = {0.f, 0.f};

  const int tiles = seq / kTile;
  for (int it = 0; it < tiles; ++it) {
    cp_async_wait<0>();
    __syncthreads();  // tile `it` has landed; every warp is done with kf, vf
    split_tile<D>(kf, vf, raw_k, raw_v);
    __syncthreads();  // kf, vf hold tile `it`; the raw tiles are free
    if (it + 1 < tiles) {  // the next tile lands while this one computes
      const long long next = static_cast<long long>(it + 1) * kTile * D;
      stage_raw<D>(raw_k, kh + next);
      stage_raw<D>(raw_v, vh + next);
      cp_async_commit();
    }

    // S = Q K^T over the tile's 64 keys: 8 n8 tiles; key 8j + g's B
    // fragment at k8 step ks is K[8j + g][8ks + 2t, +1]
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
      const float* kr = kf + (8 * j + g) * L::kKStride + 4 * t;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
        mma_3xtf32(s[j], qh[ks], ql[ks],
                   *reinterpret_cast<const uint4*>(kr + 16 * ks));
    }

    // online softmax: one max update and one rescale a tile
    float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
    }
    float corr[2], neg_m[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r] * c);  // c >= 0: max(s) c
      corr[r] = ex2(m[r] - m_new);                 // 0 on the first tile
      m[r] = m_new;
      neg_m[r] = -m_new;
      l[r] *= corr[r];
    }

    // P V, P in float32 (l sums it) split as an A operand: the k8 step
    // over keys 8j..8j + 7 takes S's n8 tile j. With those keys permuted
    // (column t = key 8j + 2t, column t + 4 = key 8j + 2t + 1) the C
    // fragment (c0, c1, c2, c3) is the A fragment (c0, c2, c1, c3), and
    // V's B fragment is V[8j + 2t, +1][8n + g]. The tile's P V gets its
    // own accumulator, added to the rescaled O by one FFMA an element, so
    // a chain of tensor-core additions (which do not round to nearest)
    // spans 3 D / 8 x 8 mma of one tile, not those of every tile of the
    // patch (k3_experiments.py, one_accumulator: o's error against the
    // plain version is ~4x larger without it).
    float pv[KS][4];
#pragma unroll
    for (int n = 0; n < KS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) pv[n][e] = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float p0 = ex2(fmaf(s[j][0], c, neg_m[0]));
      const float p1 = ex2(fmaf(s[j][1], c, neg_m[0]));
      const float p2 = ex2(fmaf(s[j][2], c, neg_m[1]));
      const float p3 = ex2(fmaf(s[j][3], c, neg_m[1]));
      l[0] += p0 + p1;
      l[1] += p2 + p3;
      uint32_t ph[4], pl[4];
      split_tf32(p0, ph[0], pl[0]);
      split_tf32(p2, ph[1], pl[1]);
      split_tf32(p1, ph[2], pl[2]);
      split_tf32(p3, ph[3], pl[3]);
      const float* vr = vf + (4 * j + t) * L::kVStride + 4 * g;
#pragma unroll
      for (int n = 0; n < KS; ++n)
        mma_3xtf32(pv[n], ph, pl,
                   *reinterpret_cast<const uint4*>(vr + 32 * n));
    }
#pragma unroll
    for (int n = 0; n < KS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[n][e] = fmaf(acc[n][e], corr[e >> 1], pv[n][e]);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  float* o0 = o + (head * seq + row0 + g) * D + 2 * t;
  float* o1 = o0 + 8 * D;
#pragma unroll
  for (int n = 0; n < KS; ++n) {
    *reinterpret_cast<float2*>(o0 + 8 * n) =
        make_float2(acc[n][0] / l[0], acc[n][1] / l[0]);
    *reinterpret_cast<float2*>(o1 + 8 * n) =
        make_float2(acc[n][2] / l[1], acc[n][3] / l[1]);
  }
  if (t == 0) {
    lse[head * seq + row0 + g] = m[0] * kLn2 + logf(l[0]);
    lse[head * seq + row0 + g + 8] = m[1] * kLn2 + logf(l[1]);
  }
}

template <int D>
int launch_tf32x3(const void* q, const void* k, const void* v, void* o,
                  void* lse, int batch_heads, int seq, float scale,
                  cudaStream_t stream) {
  constexpr int bytes = Split<D>::kBytes;  // 54 KB at D = 32
  const auto kernel = attention_fwd_tf32x3_kernel<D>;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(seq / kTile, batch_heads);
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o),
      static_cast<float*>(lse), seq, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* o,
                void* lse, int batch_heads, int seq, float scale,
                cudaStream_t stream) {
  const dim3 grid(seq / kTile, batch_heads);
  attention_fwd_bf16_kernel<D><<<grid, kThreads, 0, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o),
      static_cast<float*>(lse), seq, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point for ctypes. dtype 0 = float32 (split-TF32 kernel), 1 =
// bfloat16; every pointer 16-byte aligned (both kernels stage tiles with
// 16-byte cp.async). Launches on
// `stream` and does not synchronise; returns the launch's cudaError_t (0 =
// cudaSuccess), or cudaErrorInvalidValue for a shape or type the kernels do
// not take.
extern "C" int attention_fwd(const void* q, const void* k, const void* v,
                             void* o, void* lse, int batch_heads, int seq,
                             int head_dim, int dtype, float scale,
                             void* stream) {
  if (batch_heads <= 0 || seq <= 0) return 0;
  if (seq % kTile != 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    switch (head_dim) {
      case 16:
        return launch_tf32x3<16>(q, k, v, o, lse, batch_heads, seq, scale,
                                 s);
      case 24:
        return launch_tf32x3<24>(q, k, v, o, lse, batch_heads, seq, scale,
                                 s);
      case 32:
        return launch_tf32x3<32>(q, k, v, o, lse, batch_heads, seq, scale,
                                 s);
    }
  } else if (dtype == 1) {
    switch (head_dim) {
      case 16:
        return launch_bf16<16>(q, k, v, o, lse, batch_heads, seq, scale, s);
      case 24:
        return launch_bf16<24>(q, k, v, o, lse, batch_heads, seq, scale, s);
      case 32:
        return launch_bf16<32>(q, k, v, o, lse, batch_heads, seq, scale, s);
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
