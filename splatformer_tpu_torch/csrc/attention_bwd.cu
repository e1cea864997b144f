// Patch attention backward (K3-bwd) for Hopper, sm_90a: a dQ pass, then a
// dK/dV pass.
//
// Replaces the Pallas TPU kernels `_flash_attention_dq_kernel` and
// `_flash_attention_dkv_kernel` of
// jax/experimental/pallas/ops/tpu/flash_attention.py (the backward of the
// flash attention the JAX package calls from splatformer_tpu/models/ptv3.py
// for `enable_flash`). Inputs: q, k, v, o, do (B*H, K, D) contiguous, all
// float32 or all bfloat16, every pointer 16-byte aligned, and the forward's
// lse (B*H, K) float32 (attention_fwd.cu). Per (query i, key j):
//   P  = exp(s - lse_i),  s = (q_i . k_j) * scale        (float32)
//   dV_j += P.astype(do) do_i          dP = do_i . v_j
//   dS = (dP - D_i) P * scale,         D_i = sum_c o_ic do_ic
//   dK_j += dS.astype(do) q_i          dQ_i += dS.astype(k) k_j
// with float32 accumulation and outputs in the inputs' type, as the JAX
// kernels compute them. The dQ pass also writes D (B*H, K) float32, which
// the dK/dV pass reads; the JAX package computes D outside its kernels.
//
// What bounds it on this card: operations, as the forward's. The least work
// is five K x K x D products (s, dP, dV, dK, dQ: 2.5 times the forward's
// FLOPs) and one exponential per pair, against 8 D elements read or written
// per token. Both types run the products on the tensor cores: bfloat16
// directly, where the SFU's exponentials bind; float32 as split TF32, three
// TF32 products a product (below).
//
// Both types keep the JAX kernel's split into two passes, with no atomics:
// every output row is owned by one warp, so the result is deterministic.
// The price is recomputing s and P in both passes: 2 exponentials a pair,
// so the bfloat16 kernels' SFU floor is twice the one-pass bound. The
// alternatives cost more: one pass with float32 atomics on dQ is
// nondeterministic, and per-key-block dQ partials reduced afterwards move
// ~30 GB a PTv3-base train step (~9 ms at 3.35 TB/s, more than the second
// exponential's ~3 ms).
//
// float32 (tensor cores, split TF32 on mma.sync m16n8k8 tf32 x tf32 -> f32,
// attention_fwd.cu's scheme): every operand x is split into hi = tf32(x)
// and lo = tf32(x - hi), each rounded as cvt.rna rounds but in two integer
// operations, and each product is a_lo b_hi + a_hi b_lo, then a_hi b_hi
// (a_lo b_lo, ~2^-22 of the product, is dropped; one TF32 product a
// product misses the float32 limit, tests/test_torch_attention_bwd_tf32.py).
// A CTA holds 8 warps of 16 rows (128 queries in the dQ pass, 128 keys in
// the dK/dV pass), those rows' operands split once into A fragments in
// registers, and walks the patch in 64-row tiles of the other side, copied
// by cp.async into raw staging tiles. One pass of the whole CTA then
// splits each landed tile into hi/lo tiles laid out as B fragments, one
// conflict-free 16-byte load a fragment with both halves (Split<D>), each
// element split once for every layout and warp, and the next tile's copy
// runs into the freed staging tiles. P and dS stay float32 and reach their
// product's A fragment without shuffles: with the reduction index permuted
// inside each k8 step (column t = 2t, column t + 4 = 2t + 1), an m16n8 C
// fragment (c0, c1, c2, c3) is the A fragment (c0, c2, c1, c3).
//   dQ pass, per 128-query block, over key tiles, 8 keys at a time: S = Q
//     K^T, dP = dO V^T (K and V split with k along d), P = ex2(s c - lse
//     log2 e), dS = (dP - D) P scale, dQ += dS K (K split again with k
//     along keys): 3 products and 3 split layouts a tile.
//   dK/dV pass, per 128-key block, over query tiles, 8 queries at a time:
//     S^T = K Q^T, dP^T = V dO^T, P^T with each column's lse and D from
//     shared memory, dV += P^T dO, dK += dS^T Q: 4 products, Q and dO each
//     split in both layouts, 4 layouts a tile.
// dQ, dK and dV each sum a tile in an accumulator of their own that one
// FADD adds to the running sum: the tensor cores' float32 additions
// truncate, and a chain of them then spans one tile's mma, not the
// patch's (k3_experiments.py, one_accumulator). d = 24 is three k8 steps
// and three n8 tiles, no padding. Shared memory is dynamic: the dQ pass
// 41, 49 and 73 KB a CTA at d = 16, 24, 32, the dK/dV pass 51, 63 and 91
// KB; registers, not shared memory, set the CTAs an SM (chip_smoke.py's
// build phase reports them; no launch-bounds minimum caps them).
// What binds it (k3_experiments.py --pass bwd): neither pipe alone. A
// third of the mma (one_product) takes less than a third of the time off,
// the split pass (split_once) a tenth, half the B-fragment reads
// (half_b_reads) nothing: the warps mostly wait on dependency chains
// (three mma a product into one accumulator, then the exponential, dS and
// the split of P and dS before the next product). So the loop over a
// tile's 8-row steps is unrolled whole, which hands the scheduler 8
// steps' independent chains (unroll_2 is slower), and 8 warps share a
// split tile, which halves the split pass's share of 4 (four_warps).
//
// bfloat16 (tensor cores, mma.sync m16n8k16 bf16 x bf16 -> f32): 4 warps a
// CTA, 16 rows a warp, 64-row tiles double-buffered in shared memory with
// cp.async, rows padded as in attention_fwd.cu (zero columns 24..31 at
// D = 24), and every left-hand operand taken from registers:
//   dQ pass, per 64-query block, over key tiles (K, V), 16 keys at a time:
//     S = Q K^T, dP = dO V^T (K and V through ldmatrix as B = tile^T),
//     P = ex2(s c - lse log2 e), dS = (dP - D) P scale packed to bf16 as
//     an A fragment, dQ += dS K (K through ldmatrix.trans).
//   dK/dV pass, per 64-key block, over query tiles (Q, dO, lse, D), 16
//     queries at a time: S^T = K Q^T, dP^T = V dO^T, P^T with each
//     column's lse from shared memory, dV += P^T(bf16) dO, dK +=
//     dS^T(bf16) Q (Q and dO through ldmatrix.trans).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr float kLog2e = 1.4426950408889634f;

// ---------------------------------------------------------------------------
// Shared by both types, then bfloat16. These helpers repeat
// attention_fwd.cu's on purpose: a library is rebuilt when its own
// source's hash changes.

using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 64;  // rows per CTA = rows per staged tile

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

__device__ __forceinline__ float2 unpack_bf16(uint32_t x) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x));
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
attention_bwd_dq_bf16_kernel(const bf16* __restrict__ q,
                             const bf16* __restrict__ k,
                             const bf16* __restrict__ v,
                             const bf16* __restrict__ o,
                             const float* __restrict__ lse,
                             const bf16* __restrict__ dout,
                             float* __restrict__ di, bf16* __restrict__ dq,
                             int seq, float scale) {
  constexpr int S = Rows<D>::kStride;
  constexpr int KS = Rows<D>::kPad / 16;  // k16 steps over d
  constexpr int CP = Rows<D>::kPad / 8;   // 8-column chunks over padded d
  constexpr int NT = D / 8;               // n8 tiles of dq
  __shared__ __align__(16) bf16 s_k[2][kTile * S];
  __shared__ __align__(16) bf16 s_v[2][kTile * S];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const long long head = blockIdx.y;  // patch * H + head
  const int row0 = blockIdx.x * kTile + 16 * warp;
  const bf16* kh = k + head * seq * D;
  const bf16* vh = v + head * seq * D;
  const float c = scale * kLog2e;

  zero_pad<D>(&s_k[0][0], 2 * kTile);
  zero_pad<D>(&s_v[0][0], 2 * kTile);
  stage_rows<D>(s_k[0], kh);
  stage_rows<D>(s_v[0], vh);
  cp_async_commit();

  const long long rows = (head * seq + row0) * D;
  uint32_t qa[KS][4], da[KS][4];
  load_a_rows<D>(qa, q + rows, lane);
  load_a_rows<D>(da, dout + rows, lane);
  // D_i = sum_c o_ic do_ic of rows g, g + 8: this lane's columns (those of
  // its dO fragments), then the quad's
  float d_i[2] = {0.f, 0.f};
  {
    const bf16* o0 = o + rows + g * D;
#pragma unroll
    for (int s = 0; s < KS; ++s)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 16 * s + 2 * t + 8 * (e >> 1);
        if (col < D) {
          const float2 ov = unpack_bf16(*reinterpret_cast<const uint32_t*>(
              o0 + 8 * D * (e & 1) + col));
          const float2 dv = unpack_bf16(da[s][e]);
          d_i[e & 1] = fmaf(ov.x, dv.x, d_i[e & 1]);
          d_i[e & 1] = fmaf(ov.y, dv.y, d_i[e & 1]);
        }
      }
  }
  float neg_lse2[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    d_i[r] += __shfl_xor_sync(0xffffffffu, d_i[r], 1);
    d_i[r] += __shfl_xor_sync(0xffffffffu, d_i[r], 2);
    neg_lse2[r] = -lse[head * seq + row0 + g + 8 * r] * kLog2e;
  }
  if (t == 0) {
    di[head * seq + row0 + g] = d_i[0];
    di[head * seq + row0 + g + 8] = d_i[1];
  }

  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

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

#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {  // 16 keys at a time
      const bf16* k16 = s_k[buf] + 16 * kk * S;
      float sc[2][4], dp[2][4];
      {
        uint32_t kb[2][CP], vb[2][CP];
        load_blocks<2, CP, false, S>(kb, k16, lane);
        load_blocks<2, CP, false, S>(vb, s_v[buf] + 16 * kk * S, lane);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[h][e] = dp[h][e] = 0.f;
#pragma unroll
          for (int ks = 0; ks < KS; ++ks) {
            mma16816(sc[h], qa[ks], kb[h][2 * ks], kb[h][2 * ks + 1]);
            mma16816(dp[h], da[ks], vb[h][2 * ks], vb[h][2 * ks + 1]);
          }
        }
      }
      // dS rounded to bf16: the A fragment of this k16 step
      uint32_t dsa[4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = ex2(fmaf(sc[h][e], c, neg_lse2[e >> 1]));
          ds[e] = (dp[h][e] - d_i[e >> 1]) * p * scale;
        }
        dsa[2 * h] = pack_bf16(ds[0], ds[1]);
        dsa[2 * h + 1] = pack_bf16(ds[2], ds[3]);
      }
      uint32_t kt[2][NT];
      load_blocks<2, NT, true, S>(kt, k16, lane);
#pragma unroll
      for (int n = 0; n < NT; ++n) mma16816(acc[n], dsa, kt[0][n], kt[1][n]);
    }
    __syncthreads();  // every warp is done with `buf` before it refills
  }

  bf16* q0 = dq + rows + g * D + 2 * t;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    *reinterpret_cast<uint32_t*>(q0 + 8 * n) = pack_bf16(acc[n][0], acc[n][1]);
    *reinterpret_cast<uint32_t*>(q0 + 8 * D + 8 * n) =
        pack_bf16(acc[n][2], acc[n][3]);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
attention_bwd_dkv_bf16_kernel(const bf16* __restrict__ q,
                              const bf16* __restrict__ k,
                              const bf16* __restrict__ v,
                              const float* __restrict__ lse,
                              const bf16* __restrict__ dout,
                              const float* __restrict__ di,
                              bf16* __restrict__ dk, bf16* __restrict__ dv,
                              int seq, float scale) {
  constexpr int S = Rows<D>::kStride;
  constexpr int KS = Rows<D>::kPad / 16;  // k16 steps over d
  constexpr int CP = Rows<D>::kPad / 8;   // 8-column chunks over padded d
  constexpr int NT = D / 8;               // n8 tiles of dk, dv
  __shared__ __align__(16) bf16 s_q[2][kTile * S];
  __shared__ __align__(16) bf16 s_do[2][kTile * S];
  __shared__ __align__(16) float s_lse[2][kTile];
  __shared__ __align__(16) float s_di[2][kTile];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const long long head = blockIdx.y;  // patch * H + head
  const int col0 = blockIdx.x * kTile + 16 * warp;  // this warp's keys
  const bf16* qh = q + head * seq * D;
  const bf16* doh = dout + head * seq * D;
  const float* lseh = lse + head * seq;
  const float* dih = di + head * seq;
  const float c = scale * kLog2e;

  // one query tile: q and do rows, lse and D (16 chunks of 16 bytes each)
  auto stage_tile = [&](int b, int tile) {
    const long long r = static_cast<long long>(tile) * kTile;
    stage_rows<D>(s_q[b], qh + r * D);
    stage_rows<D>(s_do[b], doh + r * D);
    if (threadIdx.x < 16) {
      cp_async16(&s_lse[b][4 * threadIdx.x], lseh + r + 4 * threadIdx.x);
    } else if (threadIdx.x < 32) {
      cp_async16(&s_di[b][4 * (threadIdx.x - 16)],
                 dih + r + 4 * (threadIdx.x - 16));
    }
    cp_async_commit();
  };

  zero_pad<D>(&s_q[0][0], 2 * kTile);
  zero_pad<D>(&s_do[0][0], 2 * kTile);
  stage_tile(0, 0);

  const long long rows = (head * seq + col0) * D;
  uint32_t ka[KS][4], va[KS][4];
  load_a_rows<D>(ka, k + rows, lane);
  load_a_rows<D>(va, v + rows, lane);

  float dka[NT][4], dva[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;

  const int tiles = seq / kTile;
  for (int it = 0; it < tiles; ++it) {
    const int buf = it & 1;
    if (it + 1 < tiles) {
      stage_tile(buf ^ 1, it + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile `it` has landed for every thread

#pragma unroll
    for (int qq = 0; qq < 4; ++qq) {  // 16 queries at a time
      const bf16* q16 = s_q[buf] + 16 * qq * S;
      const bf16* do16 = s_do[buf] + 16 * qq * S;
      float st[2][4], dpt[2][4];
      {
        uint32_t qb[2][CP], db[2][CP];
        load_blocks<2, CP, false, S>(qb, q16, lane);
        load_blocks<2, CP, false, S>(db, do16, lane);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll
          for (int e = 0; e < 4; ++e) st[h][e] = dpt[h][e] = 0.f;
#pragma unroll
          for (int ks = 0; ks < KS; ++ks) {
            mma16816(st[h], ka[ks], qb[h][2 * ks], qb[h][2 * ks + 1]);
            mma16816(dpt[h], va[ks], db[h][2 * ks], db[h][2 * ks + 1]);
          }
        }
      }
      // rows are keys g, g + 8; this lane's columns are queries
      // 16 qq + 8 h + 2t, +1. P^T and dS^T rounded to bf16: the A
      // fragments of this k16 step
      uint32_t pa[4], dsa[4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int qc = 16 * qq + 8 * h + 2 * t;
        const float2 ls = *reinterpret_cast<const float2*>(&s_lse[buf][qc]);
        const float2 dd = *reinterpret_cast<const float2*>(&s_di[buf][qc]);
        const float nl[2] = {-ls.x * kLog2e, -ls.y * kLog2e};
        const float dc[2] = {dd.x, dd.y};
        float p[4], ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p[e] = ex2(fmaf(st[h][e], c, nl[e & 1]));
          ds[e] = (dpt[h][e] - dc[e & 1]) * p[e] * scale;
        }
        pa[2 * h] = pack_bf16(p[0], p[1]);
        pa[2 * h + 1] = pack_bf16(p[2], p[3]);
        dsa[2 * h] = pack_bf16(ds[0], ds[1]);
        dsa[2 * h + 1] = pack_bf16(ds[2], ds[3]);
      }
      uint32_t dt[2][NT], qt[2][NT];
      load_blocks<2, NT, true, S>(dt, do16, lane);
      load_blocks<2, NT, true, S>(qt, q16, lane);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        mma16816(dva[n], pa, dt[0][n], dt[1][n]);
        mma16816(dka[n], dsa, qt[0][n], qt[1][n]);
      }
    }
    __syncthreads();  // every warp is done with `buf` before it refills
  }

  bf16* k0 = dk + rows + g * D + 2 * t;
  bf16* v0 = dv + rows + g * D + 2 * t;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    *reinterpret_cast<uint32_t*>(k0 + 8 * n) = pack_bf16(dka[n][0], dka[n][1]);
    *reinterpret_cast<uint32_t*>(k0 + 8 * D + 8 * n) =
        pack_bf16(dka[n][2], dka[n][3]);
    *reinterpret_cast<uint32_t*>(v0 + 8 * n) = pack_bf16(dva[n][0], dva[n][1]);
    *reinterpret_cast<uint32_t*>(v0 + 8 * D + 8 * n) =
        pack_bf16(dva[n][2], dva[n][3]);
  }
}

// ---------------------------------------------------------------------------
// float32: tensor cores, split TF32 (3xTF32). The split helpers repeat
// attention_fwd.cu's, as the bfloat16 ones do.

// x rounded to TF32 (10 mantissa bits) to nearest, ties away from zero, as
// cvt.rna.tf32.f32 rounds finite x, in two integer operations: half the
// dropped bits' range is added to the magnitude, then they are cleared
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

// the A fragment pair of an m16n8 C fragment c (rows g, g + 8; columns 2t,
// 2t + 1) as the k8 step over those 8 columns, permuted (column t = 2t,
// column t + 4 = 2t + 1): (c0, c2, c1, c3), each split
__device__ __forceinline__ void split_c_as_a(const float (&c)[4],
                                             uint32_t (&hi)[4],
                                             uint32_t (&lo)[4]) {
  split_tf32(c[0], hi[0], lo[0]);
  split_tf32(c[2], hi[1], lo[1]);
  split_tf32(c[1], hi[2], lo[2]);
  split_tf32(c[3], hi[3], lo[3]);
}

// The float32 kernels' CTA: kF32Warps warps of 16 rows each (queries in
// the dQ pass, keys in the dK/dV pass), so that kF32Rows rows share each
// split tile: the split pass costs the same per tile for any number of
// rows, and more rows a CTA make it a smaller share of the work
// (k3_experiments.py, four_warps).
constexpr int kF32Warps = 8;
constexpr int kF32Threads = 32 * kF32Warps;
constexpr int kF32Rows = 16 * kF32Warps;

// Shared memory of the float32 kernels, in 4-byte words. A 64-row tile X
// (rows are keys or queries) is held in up to two split layouts:
//   K layout, B = X^T (k along d): [row][d pair p][hi(X[r][2p]),
//     hi(X[r][2p + 1]), lo(X[r][2p]), lo(X[r][2p + 1])], row stride 16
//     mod 32 words;
//   V layout, B = X (k along the rows): [row pair i][column c][hi(X[2i][c]),
//     hi(X[2i + 1][c]), lo(X[2i][c]), lo(X[2i + 1][c])], stride 8 mod 32;
// so a B fragment with both halves is one 16-byte load, and a quarter
// warp's eight such loads hit 32 distinct banks (attention_fwd.cu: Split).
// The dQ pass holds raw K and V (cp.async staging), K in both layouts and
// V in the K layout; the dK/dV pass raw Q and dO, both in both layouts,
// and lse and D of the tile's queries raw and as read.
template <int D>
struct Split {
  static constexpr int kKStride = (2 * D) % 32 == 16 ? 2 * D : 2 * D + 16;
  static constexpr int kVStride = 4 * D + 8;
  static constexpr int kRaw = kTile * D;
  static constexpr int kK = kTile * kKStride;
  static constexpr int kV = kTile / 2 * kVStride;
  static constexpr int kDqBytes = 4 * (2 * kRaw + 2 * kK + kV);
  static constexpr int kDkvBytes = 4 * (2 * kRaw + 2 * kK + 2 * kV + 4 * kTile);
  static_assert(D % 8 == 0 && kKStride % 32 == 16 && kVStride % 32 == 8,
                "bank-conflict-free strides");
  static_assert(kF32Threads >= 2 * kTile, "a thread a query's lse or D");
};

// one raw tile of kTile contiguous rows of D floats into shared memory
template <int D>
__device__ __forceinline__ void stage_raw(float* dst, const float* src) {
#pragma unroll
  for (int i = 4 * threadIdx.x; i < kTile * D; i += 4 * kF32Threads) {
    cp_async16(dst + i, src + i);
  }
}

// A raw tile split into the K layout and, with kBoth, the V layout: the
// CTA's threads take its 2x2 blocks (rows 2i, 2i + 1, columns 2p, 2p + 1),
// each element split once for both layouts and all the CTA's warps.
template <int D, bool kBoth>
__device__ __forceinline__ void split_tile(float* kl, float* vl,
                                           const float* raw) {
  using L = Split<D>;
#pragma unroll
  for (int b = threadIdx.x; b < 16 * D; b += kF32Threads) {
    const int i = b / (D / 2), p = b % (D / 2);
    const float2 x0 = *reinterpret_cast<const float2*>(raw + 2 * i * D + 2 * p);
    const float2 x1 =
        *reinterpret_cast<const float2*>(raw + (2 * i + 1) * D + 2 * p);
    uint32_t h[4], l[4];  // X[2i][2p], X[2i][2p + 1], X[2i + 1][2p], ...
    split_tf32(x0.x, h[0], l[0]);
    split_tf32(x0.y, h[1], l[1]);
    split_tf32(x1.x, h[2], l[2]);
    split_tf32(x1.y, h[3], l[3]);
    *reinterpret_cast<uint4*>(kl + 2 * i * L::kKStride + 4 * p) =
        make_uint4(h[0], h[1], l[0], l[1]);
    *reinterpret_cast<uint4*>(kl + (2 * i + 1) * L::kKStride + 4 * p) =
        make_uint4(h[2], h[3], l[2], l[3]);
    if constexpr (kBoth) {
      *reinterpret_cast<uint4*>(vl + i * L::kVStride + 8 * p) =
          make_uint4(h[0], h[2], l[0], l[2]);
      *reinterpret_cast<uint4*>(vl + i * L::kVStride + 8 * p + 4) =
          make_uint4(h[1], h[3], l[1], l[3]);
    }
  }
}

// A fragments of the 16 rows starting at `rows` (row stride D), split, with
// d permuted inside each k8 step (column t = d 8s + 2t, column t + 4 = d
// 8s + 2t + 1), so a lane's two columns of a row are adjacent in memory
template <int D>
__device__ __forceinline__ void load_split_a(uint32_t (&hi)[D / 8][4],
                                             uint32_t (&lo)[D / 8][4],
                                             const float* rows, int lane) {
  const float* r0 = rows + (lane >> 2) * D + 2 * (lane & 3);
  const float* r1 = r0 + 8 * D;
#pragma unroll
  for (int s = 0; s < D / 8; ++s) {
    const float2 x0 = *reinterpret_cast<const float2*>(r0 + 8 * s);
    const float2 x1 = *reinterpret_cast<const float2*>(r1 + 8 * s);
    split_tf32(x0.x, hi[s][0], lo[s][0]);
    split_tf32(x1.x, hi[s][1], lo[s][1]);
    split_tf32(x0.y, hi[s][2], lo[s][2]);
    split_tf32(x1.y, hi[s][3], lo[s][3]);
  }
}

// The dQ pass, one CTA per (patch head, kF32Rows queries), 16 queries a
// warp, over the patch's 64-key tiles. A warp past the patch's end (in its
// last CTA when K is an odd multiple of 64) takes part in the copies, the
// splits and the barriers, and computes nothing.
template <int D>
__global__ void __launch_bounds__(kF32Threads)
attention_bwd_dq_tf32x3_kernel(const float* __restrict__ q,
                               const float* __restrict__ k,
                               const float* __restrict__ v,
                               const float* __restrict__ o,
                               const float* __restrict__ lse,
                               const float* __restrict__ dout,
                               float* __restrict__ di,
                               float* __restrict__ dq, int seq, float scale) {
  using L = Split<D>;
  constexpr int KS = D / 8;  // k8 steps over d = n8 tiles of dq
  extern __shared__ __align__(16) float smem[];
  float* raw_k = smem;
  float* raw_v = raw_k + L::kRaw;
  float* kk = raw_v + L::kRaw;  // K, K layout (S = Q K^T)
  float* vk = kk + L::kK;       // V, K layout (dP = dO V^T)
  float* kv = vk + L::kK;       // K, V layout (dQ += dS K)

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const long long head = blockIdx.y;  // patch * H + head
  const bool active = blockIdx.x * kF32Rows + 16 * warp < seq;
  const int row0 = active ? blockIdx.x * kF32Rows + 16 * warp : seq - 16;
  const float* kh = k + head * seq * D;
  const float* vh = v + head * seq * D;

  stage_raw<D>(raw_k, kh);
  stage_raw<D>(raw_v, vh);
  cp_async_commit();

  const long long rows = (head * seq + row0) * D;
  uint32_t qh[KS][4], ql[KS][4], dh[KS][4], dl[KS][4];
  load_split_a<D>(qh, ql, q + rows, lane);
  load_split_a<D>(dh, dl, dout + rows, lane);
  // D_i = sum_c o_ic do_ic of rows g, g + 8: this lane's columns (those of
  // its dO fragments), then the quad's
  float d_i[2] = {0.f, 0.f};
  {
    const long long c0 = rows + g * D + 2 * t;
#pragma unroll
    for (int s = 0; s < KS; ++s)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const long long at = c0 + 8 * D * r + 8 * s;
        const float2 ov = *reinterpret_cast<const float2*>(o + at);
        const float2 dv = *reinterpret_cast<const float2*>(dout + at);
        d_i[r] = fmaf(ov.x, dv.x, d_i[r]);
        d_i[r] = fmaf(ov.y, dv.y, d_i[r]);
      }
  }
  float neg_lse2[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    d_i[r] += __shfl_xor_sync(0xffffffffu, d_i[r], 1);
    d_i[r] += __shfl_xor_sync(0xffffffffu, d_i[r], 2);
    neg_lse2[r] = -lse[head * seq + row0 + g + 8 * r] * kLog2e;
  }
  if (active && t == 0) {
    di[head * seq + row0 + g] = d_i[0];
    di[head * seq + row0 + g + 8] = d_i[1];
  }
  const float c = scale * kLog2e;

  float acc[KS][4];
#pragma unroll
  for (int n = 0; n < KS; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  const int tiles = seq / kTile;
  for (int it = 0; it < tiles; ++it) {
    cp_async_wait<0>();
    __syncthreads();  // tile `it` has landed; every warp is done with kk..
    split_tile<D, true>(kk, kv, raw_k);
    split_tile<D, false>(vk, nullptr, raw_v);
    __syncthreads();  // the split tiles hold tile `it`; the raw tiles are free
    if (it + 1 < tiles) {  // the next tile lands while this one computes
      const long long next = static_cast<long long>(it + 1) * kTile * D;
      stage_raw<D>(raw_k, kh + next);
      stage_raw<D>(raw_v, vh + next);
      cp_async_commit();
    }
    if (!active) continue;

    // the tile's dQ in an accumulator of its own, added to dq by one FADD
    // an element: a chain of tensor-core additions (which truncate) spans
    // the 8 x 3 mma of one tile, not those of every tile of the patch
    float dqt[KS][4];
#pragma unroll
    for (int n = 0; n < KS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dqt[n][e] = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {  // keys 8j..8j + 7 of the tile
      // S = Q K^T and dP = dO V^T: key 8j + g's B fragment at k8 step ks
      // is X[8j + g][8ks + 2t, +1]
      float s[4] = {0.f, 0.f, 0.f, 0.f}, dp[4] = {0.f, 0.f, 0.f, 0.f};
      const float* kr = kk + (8 * j + g) * L::kKStride + 4 * t;
      const float* vr = vk + (8 * j + g) * L::kKStride + 4 * t;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        mma_3xtf32(s, qh[ks], ql[ks],
                   *reinterpret_cast<const uint4*>(kr + 16 * ks));
        mma_3xtf32(dp, dh[ks], dl[ks],
                   *reinterpret_cast<const uint4*>(vr + 16 * ks));
      }
      // rows are queries g, g + 8, columns keys 8j + 2t, +1
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = ex2(fmaf(s[e], c, neg_lse2[e >> 1]));
        ds[e] = (dp[e] - d_i[e >> 1]) * p * scale;
      }
      uint32_t ah[4], al[4];
      split_c_as_a(ds, ah, al);
      // dQ += dS K: the k8 step over keys 8j..8j + 7 (permuted as dS's
      // columns), K's B fragment K[8j + 2t, +1][8n + g]
      const float* kvr = kv + (4 * j + t) * L::kVStride + 4 * g;
#pragma unroll
      for (int n = 0; n < KS; ++n)
        mma_3xtf32(dqt[n], ah, al,
                   *reinterpret_cast<const uint4*>(kvr + 32 * n));
    }
#pragma unroll
    for (int n = 0; n < KS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] += dqt[n][e];
  }

  if (!active) return;
  float* q0 = dq + rows + g * D + 2 * t;
#pragma unroll
  for (int n = 0; n < KS; ++n) {
    *reinterpret_cast<float2*>(q0 + 8 * n) = make_float2(acc[n][0], acc[n][1]);
    *reinterpret_cast<float2*>(q0 + 8 * D + 8 * n) =
        make_float2(acc[n][2], acc[n][3]);
  }
}

// The dK/dV pass, one CTA per (patch head, kF32Rows keys), 16 keys a
// warp, over the patch's 64-query tiles; warps past the patch's end as in
// the dQ pass.
template <int D>
__global__ void __launch_bounds__(kF32Threads)
attention_bwd_dkv_tf32x3_kernel(const float* __restrict__ q,
                                const float* __restrict__ k,
                                const float* __restrict__ v,
                                const float* __restrict__ lse,
                                const float* __restrict__ dout,
                                const float* __restrict__ di,
                                float* __restrict__ dk,
                                float* __restrict__ dv, int seq,
                                float scale) {
  using L = Split<D>;
  constexpr int KS = D / 8;  // k8 steps over d = n8 tiles of dk, dv
  extern __shared__ __align__(16) float smem[];
  float* raw_q = smem;
  float* raw_do = raw_q + L::kRaw;
  float* qk = raw_do + L::kRaw;  // Q, K layout (S^T = K Q^T)
  float* dok = qk + L::kK;       // dO, K layout (dP^T = V dO^T)
  float* qv = dok + L::kK;       // Q, V layout (dK += dS^T Q)
  float* dov = qv + L::kV;       // dO, V layout (dV += P^T dO)
  float* raw_lse = dov + L::kV;
  float* raw_di = raw_lse + kTile;
  float* s_nl = raw_di + kTile;  // -lse log2 e of the tile's queries
  float* s_di = s_nl + kTile;    // D of the tile's queries

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const long long head = blockIdx.y;  // patch * H + head
  const bool active = blockIdx.x * kF32Rows + 16 * warp < seq;
  const int col0 =  // this warp's keys
      active ? blockIdx.x * kF32Rows + 16 * warp : seq - 16;
  const float* qh = q + head * seq * D;
  const float* doh = dout + head * seq * D;
  const float* lseh = lse + head * seq;
  const float* dih = di + head * seq;

  // one query tile: q and do rows, lse and D (16 chunks of 16 bytes each)
  auto stage_tile = [&](int tile) {
    const long long r = static_cast<long long>(tile) * kTile;
    stage_raw<D>(raw_q, qh + r * D);
    stage_raw<D>(raw_do, doh + r * D);
    if (threadIdx.x < 16) {
      cp_async16(raw_lse + 4 * threadIdx.x, lseh + r + 4 * threadIdx.x);
    } else if (threadIdx.x < 32) {
      cp_async16(raw_di + 4 * (threadIdx.x - 16),
                 dih + r + 4 * (threadIdx.x - 16));
    }
    cp_async_commit();
  };
  stage_tile(0);

  const long long rows = (head * seq + col0) * D;
  uint32_t kh[KS][4], kl[KS][4], vh[KS][4], vl[KS][4];
  load_split_a<D>(kh, kl, k + rows, lane);
  load_split_a<D>(vh, vl, v + rows, lane);
  const float c = scale * kLog2e;

  float dka[KS][4], dva[KS][4];
#pragma unroll
  for (int n = 0; n < KS; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;

  const int tiles = seq / kTile;
  for (int it = 0; it < tiles; ++it) {
    cp_async_wait<0>();
    __syncthreads();  // tile `it` has landed; every warp is done with qk..
    split_tile<D, true>(qk, qv, raw_q);
    split_tile<D, true>(dok, dov, raw_do);
    if (threadIdx.x < kTile) {
      s_nl[threadIdx.x] = -raw_lse[threadIdx.x] * kLog2e;
    } else if (threadIdx.x < 2 * kTile) {
      s_di[threadIdx.x - kTile] = raw_di[threadIdx.x - kTile];
    }
    __syncthreads();  // the split tiles hold tile `it`; the raw tiles are free
    if (it + 1 < tiles) stage_tile(it + 1);  // lands while this one computes
    if (!active) continue;

    // the tile's dK and dV in accumulators of their own (the dQ pass's
    // reason), each added to its sum by one FADD an element
    float dkt[KS][4], dvt[KS][4];
#pragma unroll
    for (int n = 0; n < KS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dkt[n][e] = dvt[n][e] = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {  // queries 8j..8j + 7 of the tile
      // S^T = K Q^T and dP^T = V dO^T: query 8j + g's B fragment at k8
      // step ks is X[8j + g][8ks + 2t, +1]
      float st[4] = {0.f, 0.f, 0.f, 0.f}, dpt[4] = {0.f, 0.f, 0.f, 0.f};
      const float* qr = qk + (8 * j + g) * L::kKStride + 4 * t;
      const float* dr = dok + (8 * j + g) * L::kKStride + 4 * t;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        mma_3xtf32(st, kh[ks], kl[ks],
                   *reinterpret_cast<const uint4*>(qr + 16 * ks));
        mma_3xtf32(dpt, vh[ks], vl[ks],
                   *reinterpret_cast<const uint4*>(dr + 16 * ks));
      }
      // rows are keys g, g + 8, columns queries 8j + 2t, +1
      const float2 nl = *reinterpret_cast<const float2*>(s_nl + 8 * j + 2 * t);
      const float2 dd = *reinterpret_cast<const float2*>(s_di + 8 * j + 2 * t);
      float p[4], ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = ex2(fmaf(st[e], c, (e & 1) ? nl.y : nl.x));
        ds[e] = (dpt[e] - ((e & 1) ? dd.y : dd.x)) * p[e] * scale;
      }
      // dV += P^T dO and dK += dS^T Q: the k8 step over queries 8j..8j + 7
      // (permuted as the columns), B fragments X[8j + 2t, +1][8n + g]
      const int vrow = (4 * j + t) * L::kVStride + 4 * g;
      uint32_t ah[4], al[4];
      split_c_as_a(p, ah, al);
#pragma unroll
      for (int n = 0; n < KS; ++n)
        mma_3xtf32(dvt[n], ah, al,
                   *reinterpret_cast<const uint4*>(dov + vrow + 32 * n));
      split_c_as_a(ds, ah, al);
#pragma unroll
      for (int n = 0; n < KS; ++n)
        mma_3xtf32(dkt[n], ah, al,
                   *reinterpret_cast<const uint4*>(qv + vrow + 32 * n));
    }
#pragma unroll
    for (int n = 0; n < KS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        dka[n][e] += dkt[n][e];
        dva[n][e] += dvt[n][e];
      }
  }

  if (!active) return;
  float* k0 = dk + rows + g * D + 2 * t;
  float* v0 = dv + rows + g * D + 2 * t;
#pragma unroll
  for (int n = 0; n < KS; ++n) {
    *reinterpret_cast<float2*>(k0 + 8 * n) = make_float2(dka[n][0], dka[n][1]);
    *reinterpret_cast<float2*>(k0 + 8 * D + 8 * n) =
        make_float2(dka[n][2], dka[n][3]);
    *reinterpret_cast<float2*>(v0 + 8 * n) = make_float2(dva[n][0], dva[n][1]);
    *reinterpret_cast<float2*>(v0 + 8 * D + 8 * n) =
        make_float2(dva[n][2], dva[n][3]);
  }
}

template <int D>
int launch_tf32x3(const void* q, const void* k, const void* v, const void* o,
                  const void* lse, const void* dout, void* di, void* dq,
                  void* dk, void* dv, int batch_heads, int seq, float scale,
                  cudaStream_t stream) {
  constexpr int dq_bytes = Split<D>::kDqBytes;
  constexpr int dkv_bytes = Split<D>::kDkvBytes;
  const auto dq_kernel = attention_bwd_dq_tf32x3_kernel<D>;
  const auto dkv_kernel = attention_bwd_dkv_tf32x3_kernel<D>;
  cudaError_t err = cudaSuccess;
  if (dq_bytes > 48 * 1024) {
    err = cudaFuncSetAttribute(
        dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, dq_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (dkv_bytes > 48 * 1024) {
    err = cudaFuncSetAttribute(
        dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, dkv_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((seq + kF32Rows - 1) / kF32Rows, batch_heads);
  dq_kernel<<<grid, kF32Threads, dq_bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(o),
      static_cast<const float*>(lse), static_cast<const float*>(dout),
      static_cast<float*>(di), static_cast<float*>(dq), seq, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // same stream: the dK/dV pass reads the D the dQ pass wrote
  dkv_kernel<<<grid, kF32Threads, dkv_bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(lse),
      static_cast<const float*>(dout), static_cast<const float*>(di),
      static_cast<float*>(dk), static_cast<float*>(dv), seq, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, const void* o,
                const void* lse, const void* dout, void* di, void* dq,
                void* dk, void* dv, int batch_heads, int seq, float scale,
                cudaStream_t stream) {
  const dim3 grid(seq / kTile, batch_heads);
  attention_bwd_dq_bf16_kernel<D><<<grid, kThreads, 0, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(o),
      static_cast<const float*>(lse), static_cast<const bf16*>(dout),
      static_cast<float*>(di), static_cast<bf16*>(dq), seq, scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // same stream: the dK/dV pass reads the D the dQ pass wrote
  attention_bwd_dkv_bf16_kernel<D><<<grid, kThreads, 0, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const float*>(lse),
      static_cast<const bf16*>(dout), static_cast<const float*>(di),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), seq, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point for ctypes. dtype 0 = float32 (split-TF32 kernels), 1
// = bfloat16; every pointer 16-byte aligned (both types stage tiles with
// 16-byte cp.async); `di` is (B*H, K) float32 scratch. Launches both
// passes on `stream` and does not synchronise; returns the first failed
// launch's cudaError_t (0 = cudaSuccess), or cudaErrorInvalidValue for a
// shape or type the kernels do not take.
extern "C" int attention_bwd(const void* q, const void* k, const void* v,
                             const void* o, const void* lse,
                             const void* dout, void* di, void* dq, void* dk,
                             void* dv, int batch_heads, int seq, int head_dim,
                             int dtype, float scale, void* stream) {
  if (batch_heads <= 0 || seq <= 0) return 0;
  if (seq % kTile != 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    switch (head_dim) {
      case 16:
        return launch_tf32x3<16>(q, k, v, o, lse, dout, di, dq, dk, dv,
                                  batch_heads, seq, scale, s);
      case 24:
        return launch_tf32x3<24>(q, k, v, o, lse, dout, di, dq, dk, dv,
                                  batch_heads, seq, scale, s);
      case 32:
        return launch_tf32x3<32>(q, k, v, o, lse, dout, di, dq, dk, dv,
                                  batch_heads, seq, scale, s);
    }
  } else if (dtype == 1) {
    switch (head_dim) {
      case 16:
        return launch_bf16<16>(q, k, v, o, lse, dout, di, dq, dk, dv,
                               batch_heads, seq, scale, s);
      case 24:
        return launch_bf16<24>(q, k, v, o, lse, dout, di, dq, dk, dv,
                               batch_heads, seq, scale, s);
      case 32:
        return launch_bf16<32>(q, k, v, o, lse, dout, di, dq, dk, dv,
                               batch_heads, seq, scale, s);
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
