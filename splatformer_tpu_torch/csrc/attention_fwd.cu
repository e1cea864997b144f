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
// read or written per token, so bytes never bind. In float32 the FP32 pipes
// bind (67 TFLOP/s). In bfloat16 the products are the tensor cores' own
// operation (989 TFLOP/s), and the exponentials on the SFU (16 a clock per
// SM) bind instead: at D <= 32 they take ~3x the tensor-core time.
//
// float32 (serving): SIMT, one CTA of 64 threads per (patch, head, 64-query
// block), one thread per query whose q row and output accumulator live in
// registers. The CTA walks the patch's keys in tiles of 64 staged in shared
// memory and every thread reads each key row as float4 broadcasts. The
// softmax is online over chunks of 16 keys (row max and rescale once a
// chunk); the exponentials are exp2f of logits pre-scaled by log2(e).
//
// bfloat16 (training): tensor cores, mma.sync m16n8k16 bf16 x bf16 -> f32.
// One CTA of 4 warps per (patch, head, 64-query block); each warp owns 16
// queries, whose q is loaded once into mma A fragments. K and V stream
// through shared memory in 64-key tiles, double-buffered with cp.async so
// the next tile loads while the current one computes; rows are padded to
// D rounded up to 16 plus 8 elements, so ldmatrix reads them without bank
// conflicts, and at D = 24 the pad columns 24..31 are zero, which makes
// the reduction over d two exact k16 steps. Per tile: S = Q K^T (K through
// ldmatrix as the B operand), the row max by quad shuffles, one rescale of
// the accumulator and of the thread's partial row sums, P = ex2(s c - m)
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
// float32: SIMT

constexpr int kBlock = 64;  // queries per CTA = threads = keys per tile
constexpr int kChunk = 16;  // keys per online-softmax step

template <int D>
__global__ void __launch_bounds__(kBlock)
attention_fwd_f32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ o,
                         float* __restrict__ lse, int seq, float scale_log2) {
  static_assert(D % 4 == 0, "rows are read as float4");
  __shared__ __align__(16) float s_k[kBlock][D];
  __shared__ __align__(16) float s_v[kBlock][D];

  const long long head = blockIdx.y;  // patch * H + head
  const int row = blockIdx.x * kBlock + threadIdx.x;
  const float* kh = k + head * seq * D;
  const float* vh = v + head * seq * D;
  const long long qrow = (head * seq + row) * D;

  float qr[D], acc[D];
#pragma unroll
  for (int c = 0; c < D; ++c) {
    qr[c] = q[qrow + c];
    acc[c] = 0.f;
  }
  float m = -CUDART_INF_F;  // running max of the log2-scaled logits
  float l = 0.f;            // running sum of exp2(s - m)

  for (int t0 = 0; t0 < seq; t0 += kBlock) {
    __syncthreads();  // the previous tile is consumed by every thread
    for (int i = threadIdx.x; i < kBlock * D; i += kBlock) {
      s_k[i / D][i % D] = kh[static_cast<long long>(t0) * D + i];
      s_v[i / D][i % D] = vh[static_cast<long long>(t0) * D + i];
    }
    __syncthreads();
#pragma unroll 1
    for (int j0 = 0; j0 < kBlock; j0 += kChunk) {
      float s[kChunk];
      float m_next = m;
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        const float4* kr = reinterpret_cast<const float4*>(s_k[j0 + jj]);
        float dot = 0.f;
#pragma unroll
        for (int c4 = 0; c4 < D / 4; ++c4) {
          const float4 kk = kr[c4];
          dot = fmaf(qr[4 * c4], kk.x, dot);
          dot = fmaf(qr[4 * c4 + 1], kk.y, dot);
          dot = fmaf(qr[4 * c4 + 2], kk.z, dot);
          dot = fmaf(qr[4 * c4 + 3], kk.w, dot);
        }
        s[jj] = dot * scale_log2;
        m_next = fmaxf(m_next, s[jj]);
      }
      const float corr = exp2f(m - m_next);  // 0 on the first chunk
      l *= corr;
#pragma unroll
      for (int c = 0; c < D; ++c) acc[c] *= corr;
      m = m_next;
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        const float p = exp2f(s[jj] - m);
        l += p;
        const float4* vr = reinterpret_cast<const float4*>(s_v[j0 + jj]);
#pragma unroll
        for (int c4 = 0; c4 < D / 4; ++c4) {
          const float4 vv = vr[c4];
          acc[4 * c4] = fmaf(p, vv.x, acc[4 * c4]);
          acc[4 * c4 + 1] = fmaf(p, vv.y, acc[4 * c4 + 1]);
          acc[4 * c4 + 2] = fmaf(p, vv.z, acc[4 * c4 + 2]);
          acc[4 * c4 + 3] = fmaf(p, vv.w, acc[4 * c4 + 3]);
        }
      }
    }
  }

  const float inv_l = 1.f / l;
#pragma unroll
  for (int c = 0; c < D; ++c) o[qrow + c] = acc[c] * inv_l;
  lse[head * seq + row] = m * kLn2 + logf(l);
}

// ---------------------------------------------------------------------------
// bfloat16: tensor cores. These helpers are repeated in attention_bwd.cu on
// purpose: a library is rebuilt when its own source's hash changes.

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

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* o,
               void* lse, int batch_heads, int seq, float scale,
               cudaStream_t stream) {
  const dim3 grid(seq / kBlock, batch_heads);
  attention_fwd_f32_kernel<D><<<grid, kBlock, 0, stream>>>(
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

static_assert(kBlock == kTile, "both types take patches of whole tiles");

}  // namespace

// Plain C entry point for ctypes. dtype 0 = float32 (SIMT kernel), 1 =
// bfloat16 (tensor-core kernel; every pointer 16-byte aligned). Launches on
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
        return launch_f32<16>(q, k, v, o, lse, batch_heads, seq, scale, s);
      case 24:
        return launch_f32<24>(q, k, v, o, lse, batch_heads, seq, scale, s);
      case 32:
        return launch_f32<32>(q, k, v, o, lse, batch_heads, seq, scale, s);
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
