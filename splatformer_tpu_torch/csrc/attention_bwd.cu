// Patch attention backward (K3-bwd) for Hopper, sm_90a: a dQ pass, then a
// dK/dV pass.
//
// Replaces the Pallas TPU kernels `_flash_attention_dq_kernel` and
// `_flash_attention_dkv_kernel` of
// jax/experimental/pallas/ops/tpu/flash_attention.py (the backward of the
// flash attention the JAX package calls from splatformer_tpu/models/ptv3.py
// for `enable_flash`). Inputs: q, k, v, o, do (B*H, K, D) contiguous, all
// float32 or all bfloat16, and the forward's lse (B*H, K) float32
// (attention_fwd.cu). Per (query i, key j):
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
// per token. In float32 the FP32 pipes bind; in bfloat16 the products run
// on the tensor cores and the SFU's exponentials bind.
//
// Both types keep the JAX kernel's split into two passes, with no atomics:
// every output row is owned by one thread (float32) or one warp (bfloat16),
// so the result is deterministic. The price is recomputing s and P in both
// passes: 2 exponentials a pair, so the bfloat16 kernels' SFU floor is
// twice the one-pass bound. The alternatives cost more: one pass with
// float32 atomics on dQ is nondeterministic, and per-key-block dQ partials
// reduced afterwards move ~30 GB a PTv3-base train step (~9 ms at 3.35
// TB/s, more than the second exponential's ~3 ms).
//
// float32 (SIMT, FP32 FMA): the dQ pass runs one CTA of 64 threads per
// (patch, head, 64-query block), one thread per query holding q, do and
// the dQ accumulator in registers, over key tiles of 64 staged in shared
// memory; the dK/dV pass one CTA per (patch, head, 64-key block), one
// thread per key holding k, v and the dK, dV accumulators, over query
// tiles (q, do, lse, D) staged the same way.
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
// float32: SIMT

constexpr int kBlock = 64;  // rows per CTA = threads = rows per staged tile

template <int D>
__device__ __forceinline__ float dot_row(const float (&a)[D],
                                         const float* row) {
  const float4* r = reinterpret_cast<const float4*>(row);
  float acc = 0.f;
#pragma unroll
  for (int c4 = 0; c4 < D / 4; ++c4) {
    const float4 x = r[c4];
    acc = fmaf(a[4 * c4], x.x, acc);
    acc = fmaf(a[4 * c4 + 1], x.y, acc);
    acc = fmaf(a[4 * c4 + 2], x.z, acc);
    acc = fmaf(a[4 * c4 + 3], x.w, acc);
  }
  return acc;
}

template <int D>
__device__ __forceinline__ void axpy_row(float (&acc)[D], float a,
                                         const float* row) {
  const float4* r = reinterpret_cast<const float4*>(row);
#pragma unroll
  for (int c4 = 0; c4 < D / 4; ++c4) {
    const float4 x = r[c4];
    acc[4 * c4] = fmaf(a, x.x, acc[4 * c4]);
    acc[4 * c4 + 1] = fmaf(a, x.y, acc[4 * c4 + 1]);
    acc[4 * c4 + 2] = fmaf(a, x.z, acc[4 * c4 + 2]);
    acc[4 * c4 + 3] = fmaf(a, x.w, acc[4 * c4 + 3]);
  }
}

// a tile of kBlock rows of D elements, from (B*H, K, D) into shared memory
template <int D>
__device__ __forceinline__ void stage(float (&dst)[kBlock][D],
                                      const float* src) {
  for (int i = threadIdx.x; i < kBlock * D; i += kBlock) {
    dst[i / D][i % D] = src[i];
  }
}

template <int D>
__global__ void __launch_bounds__(kBlock)
attention_bwd_dq_f32_kernel(const float* __restrict__ q,
                            const float* __restrict__ k,
                            const float* __restrict__ v,
                            const float* __restrict__ o,
                            const float* __restrict__ lse,
                            const float* __restrict__ dout,
                            float* __restrict__ di, float* __restrict__ dq,
                            int seq, float scale) {
  static_assert(D % 4 == 0, "rows are read as float4");
  __shared__ __align__(16) float s_k[kBlock][D];
  __shared__ __align__(16) float s_v[kBlock][D];

  const long long head = blockIdx.y;  // patch * H + head
  const int row = blockIdx.x * kBlock + threadIdx.x;
  const long long base = head * seq * D;
  const long long qrow = base + static_cast<long long>(row) * D;
  const float scale_log2 = scale * kLog2e;

  float qr[D], dor[D], acc[D];
  float d_i = 0.f;
#pragma unroll
  for (int c = 0; c < D; ++c) {
    qr[c] = q[qrow + c];
    dor[c] = dout[qrow + c];
    d_i = fmaf(o[qrow + c], dor[c], d_i);
    acc[c] = 0.f;
  }
  di[head * seq + row] = d_i;
  const float lse2 = lse[head * seq + row] * kLog2e;

  for (int t0 = 0; t0 < seq; t0 += kBlock) {
    __syncthreads();  // the previous tile is consumed by every thread
    stage<D>(s_k, k + base + static_cast<long long>(t0) * D);
    stage<D>(s_v, v + base + static_cast<long long>(t0) * D);
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < kBlock; ++j) {
      const float p = exp2f(dot_row<D>(qr, s_k[j]) * scale_log2 - lse2);
      const float dp = dot_row<D>(dor, s_v[j]);
      const float ds = (dp - d_i) * p * scale;
      axpy_row<D>(acc, ds, s_k[j]);
    }
  }
#pragma unroll
  for (int c = 0; c < D; ++c) dq[qrow + c] = acc[c];
}

template <int D>
__global__ void __launch_bounds__(kBlock)
attention_bwd_dkv_f32_kernel(const float* __restrict__ q,
                             const float* __restrict__ k,
                             const float* __restrict__ v,
                             const float* __restrict__ lse,
                             const float* __restrict__ dout,
                             const float* __restrict__ di,
                             float* __restrict__ dk, float* __restrict__ dv,
                             int seq, float scale) {
  static_assert(D % 4 == 0, "rows are read as float4");
  __shared__ __align__(16) float s_q[kBlock][D];
  __shared__ __align__(16) float s_do[kBlock][D];
  __shared__ float s_lse2[kBlock];
  __shared__ float s_di[kBlock];

  const long long head = blockIdx.y;  // patch * H + head
  const int col = blockIdx.x * kBlock + threadIdx.x;
  const long long base = head * seq * D;
  const long long krow = base + static_cast<long long>(col) * D;
  const float scale_log2 = scale * kLog2e;

  float kr[D], vr[D], dk_acc[D], dv_acc[D];
#pragma unroll
  for (int c = 0; c < D; ++c) {
    kr[c] = k[krow + c];
    vr[c] = v[krow + c];
    dk_acc[c] = 0.f;
    dv_acc[c] = 0.f;
  }

  for (int t0 = 0; t0 < seq; t0 += kBlock) {
    __syncthreads();  // the previous tile is consumed by every thread
    stage<D>(s_q, q + base + static_cast<long long>(t0) * D);
    stage<D>(s_do, dout + base + static_cast<long long>(t0) * D);
    s_lse2[threadIdx.x] = lse[head * seq + t0 + threadIdx.x] * kLog2e;
    s_di[threadIdx.x] = di[head * seq + t0 + threadIdx.x];
    __syncthreads();
#pragma unroll 4
    for (int i = 0; i < kBlock; ++i) {
      const float p = exp2f(dot_row<D>(kr, s_q[i]) * scale_log2 - s_lse2[i]);
      axpy_row<D>(dv_acc, p, s_do[i]);
      const float dp = dot_row<D>(vr, s_do[i]);
      const float ds = (dp - s_di[i]) * p * scale;
      axpy_row<D>(dk_acc, ds, s_q[i]);
    }
  }
#pragma unroll
  for (int c = 0; c < D; ++c) {
    dk[krow + c] = dk_acc[c];
    dv[krow + c] = dv_acc[c];
  }
}

// ---------------------------------------------------------------------------
// bfloat16: tensor cores. These helpers repeat attention_fwd.cu's on
// purpose: a library is rebuilt when its own source's hash changes.

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

template <int D>
int launch_f32(const void* q, const void* k, const void* v, const void* o,
               const void* lse, const void* dout, void* di, void* dq,
               void* dk, void* dv, int batch_heads, int seq, float scale,
               cudaStream_t stream) {
  const dim3 grid(seq / kBlock, batch_heads);
  attention_bwd_dq_f32_kernel<D><<<grid, kBlock, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(o),
      static_cast<const float*>(lse), static_cast<const float*>(dout),
      static_cast<float*>(di), static_cast<float*>(dq), seq, scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // same stream: the dK/dV pass reads the D the dQ pass wrote
  attention_bwd_dkv_f32_kernel<D><<<grid, kBlock, 0, stream>>>(
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

static_assert(kBlock == kTile, "both types take patches of whole tiles");

}  // namespace

// Plain C entry point for ctypes. dtype 0 = float32 (SIMT kernels), 1 =
// bfloat16 (tensor-core kernels; every pointer 16-byte aligned); `di` is
// (B*H, K) float32 scratch. Launches both passes on `stream` and does not
// synchronise; returns the first failed launch's cudaError_t (0 =
// cudaSuccess), or cudaErrorInvalidValue for a shape or type the kernels do
// not take.
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
        return launch_f32<16>(q, k, v, o, lse, dout, di, dq, dk, dv,
                              batch_heads, seq, scale, s);
      case 24:
        return launch_f32<24>(q, k, v, o, lse, dout, di, dq, dk, dv,
                              batch_heads, seq, scale, s);
      case 32:
        return launch_f32<32>(q, k, v, o, lse, dout, di, dq, dk, dv,
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
