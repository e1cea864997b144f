// Patch attention forward (K3-fwd) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel `_flash_attention_kernel_single_batch` of
// jax/experimental/pallas/ops/tpu/flash_attention.py, which the JAX
// package calls from splatformer_tpu/models/ptv3.py for its `enable_flash`
// configurations (patch 1024). Same contract, without the TPU's padding of
// the head width to 128: q, k, v (B*H, K, D) contiguous, all float32 or all
// bfloat16; s = (q . k) * scale in float32; the unnormalised probabilities
// cast to v's type before P V; float32 accumulation; o (B*H, K, D) in the
// input type and lse (B*H, K) = max + log(sum exp) in float32, which the
// backward (attention_bwd.cu) recomputes P from. D is 16, 24 or 32 (the head
// widths of PTv3-base); K is a multiple of 64.
//
// What bounds it on this card: operations. Per (query, key) pair 2 D
// multiply-adds (q . k and p v) and one exponential, against 4 D elements
// read or written per token: at K = 1024 and D = 16 that is ~64 FLOP a byte
// in float32 and far more in bf16, so bytes never bind. In float32 the FP32
// pipes bind (67 TFLOP/s); in bf16 the card's least time would be the
// tensor cores', and the exponentials on the SFU (16 a clock per SM) bind
// first at D = 16. Design (SIMT, FP32 FMA, no tensor cores yet): one CTA of
// 64 threads per (patch, head, 64-query block), one thread per query, whose
// q row and output accumulator live in registers. The CTA walks the patch's
// keys in tiles of 64, staged once into shared memory as float32 (one
// coalesced pass per tile), and every thread reads each key row as float4
// broadcasts. The softmax is online over chunks of 16 keys: the row max is
// updated once a chunk and the accumulator rescaled once a chunk, and the
// exponentials are exp2f of logits pre-scaled by log2(e) (one SFU op each).
// Nothing of size K x K is ever stored: the (B, H, K, K) probabilities that
// the plain path keeps for the backward are what made patch-1024 training
// overflow the card, and the kernel keeps only lse.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kBlock = 64;  // queries per CTA = threads = keys per tile
constexpr int kChunk = 16;  // keys per online-softmax step
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
// x rounded to T and back: the JAX kernel's p.astype(v.dtype)
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

template <typename T, int D>
__global__ void __launch_bounds__(kBlock)
attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, int seq, float scale_log2) {
  static_assert(D % 4 == 0, "rows are read as float4");
  __shared__ __align__(16) float s_k[kBlock][D];
  __shared__ __align__(16) float s_v[kBlock][D];

  const long long head = blockIdx.y;  // patch * H + head
  const int row = blockIdx.x * kBlock + threadIdx.x;
  const T* kh = k + head * seq * D;
  const T* vh = v + head * seq * D;
  const long long qrow = (head * seq + row) * D;

  float qr[D], acc[D];
#pragma unroll
  for (int c = 0; c < D; ++c) {
    qr[c] = to_f32(q[qrow + c]);
    acc[c] = 0.f;
  }
  float m = -CUDART_INF_F;  // running max of the log2-scaled logits
  float l = 0.f;            // running sum of exp2(s - m)

  for (int t0 = 0; t0 < seq; t0 += kBlock) {
    __syncthreads();  // the previous tile is consumed by every thread
    for (int i = threadIdx.x; i < kBlock * D; i += kBlock) {
      s_k[i / D][i % D] = to_f32(kh[static_cast<long long>(t0) * D + i]);
      s_v[i / D][i % D] = to_f32(vh[static_cast<long long>(t0) * D + i]);
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
        const float pv = round_to<T>(p);
        const float4* vr = reinterpret_cast<const float4*>(s_v[j0 + jj]);
#pragma unroll
        for (int c4 = 0; c4 < D / 4; ++c4) {
          const float4 vv = vr[c4];
          acc[4 * c4] = fmaf(pv, vv.x, acc[4 * c4]);
          acc[4 * c4 + 1] = fmaf(pv, vv.y, acc[4 * c4 + 1]);
          acc[4 * c4 + 2] = fmaf(pv, vv.z, acc[4 * c4 + 2]);
          acc[4 * c4 + 3] = fmaf(pv, vv.w, acc[4 * c4 + 3]);
        }
      }
    }
  }

  const float inv_l = 1.f / l;
#pragma unroll
  for (int c = 0; c < D; ++c) o[qrow + c] = from_f32<T>(acc[c] * inv_l);
  lse[head * seq + row] = m * kLn2 + logf(l);
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int batch_heads, int seq, float scale, cudaStream_t stream) {
  const dim3 grid(seq / kBlock, batch_heads);
  attention_fwd_kernel<T, D><<<grid, kBlock, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      seq, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(int head_dim, const void* q, const void* k, const void* v,
             void* o, void* lse, int batch_heads, int seq, float scale,
             cudaStream_t stream) {
  switch (head_dim) {
    case 16:
      return launch<T, 16>(q, k, v, o, lse, batch_heads, seq, scale, stream);
    case 24:
      return launch<T, 24>(q, k, v, o, lse, batch_heads, seq, scale, stream);
    case 32:
      return launch<T, 32>(q, k, v, o, lse, batch_heads, seq, scale, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Plain C entry point for ctypes. dtype 0 = float32, 1 = bfloat16. Launches
// on `stream` and does not synchronise; returns the launch's cudaError_t
// (0 = cudaSuccess), or cudaErrorInvalidValue for a shape or type the
// kernel does not take.
extern "C" int attention_fwd(const void* q, const void* k, const void* v,
                             void* o, void* lse, int batch_heads, int seq,
                             int head_dim, int dtype, float scale,
                             void* stream) {
  if (batch_heads <= 0 || seq <= 0) return 0;
  if (seq % kBlock != 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch_d<float>(head_dim, q, k, v, o, lse, batch_heads, seq, scale,
                           s);
  }
  if (dtype == 1) {
    return launch_d<__nv_bfloat16>(head_dim, q, k, v, o, lse, batch_heads,
                                   seq, scale, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
