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
// per token. Design (SIMT, FP32 FMA): the JAX kernel's split, with no
// atomics, so the result is deterministic. The dQ pass runs one CTA of 64
// threads per (patch, head, 64-query block), one thread per query holding
// q, do and the dQ accumulator in registers, over key tiles of 64 staged in
// shared memory; the dK/dV pass one CTA per (patch, head, 64-key block),
// one thread per key holding k, v and the dK, dV accumulators, over query
// tiles (q, do, lse, D) staged the same way. Each pass recomputes s and P
// for itself (7 D multiply-adds and 2 exponentials per pair in all, where
// the least is 5 D and 1): the price of owning each output row in one
// thread instead of reducing across CTAs.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 64;  // rows per CTA = threads = rows per staged tile
constexpr float kLog2e = 1.4426950408889634f;

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
// x rounded to T and back: the JAX kernels' p.astype(do.dtype) and
// ds.astype(do.dtype)
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

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
template <typename T, int D>
__device__ __forceinline__ void stage(float (&dst)[kBlock][D], const T* src) {
  for (int i = threadIdx.x; i < kBlock * D; i += kBlock) {
    dst[i / D][i % D] = to_f32(src[i]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kBlock)
attention_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ o,
                        const float* __restrict__ lse,
                        const T* __restrict__ dout, float* __restrict__ di,
                        T* __restrict__ dq, int seq, float scale) {
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
    qr[c] = to_f32(q[qrow + c]);
    dor[c] = to_f32(dout[qrow + c]);
    d_i = fmaf(to_f32(o[qrow + c]), dor[c], d_i);
    acc[c] = 0.f;
  }
  di[head * seq + row] = d_i;
  const float lse2 = lse[head * seq + row] * kLog2e;

  for (int t0 = 0; t0 < seq; t0 += kBlock) {
    __syncthreads();  // the previous tile is consumed by every thread
    stage<T, D>(s_k, k + base + static_cast<long long>(t0) * D);
    stage<T, D>(s_v, v + base + static_cast<long long>(t0) * D);
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < kBlock; ++j) {
      const float p = exp2f(dot_row<D>(qr, s_k[j]) * scale_log2 - lse2);
      const float dp = dot_row<D>(dor, s_v[j]);
      const float ds = (dp - d_i) * p * scale;
      axpy_row<D>(acc, round_to<T>(ds), s_k[j]);
    }
  }
#pragma unroll
  for (int c = 0; c < D; ++c) dq[qrow + c] = from_f32<T>(acc[c]);
}

template <typename T, int D>
__global__ void __launch_bounds__(kBlock)
attention_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v,
                         const float* __restrict__ lse,
                         const T* __restrict__ dout,
                         const float* __restrict__ di, T* __restrict__ dk,
                         T* __restrict__ dv, int seq, float scale) {
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
    kr[c] = to_f32(k[krow + c]);
    vr[c] = to_f32(v[krow + c]);
    dk_acc[c] = 0.f;
    dv_acc[c] = 0.f;
  }

  for (int t0 = 0; t0 < seq; t0 += kBlock) {
    __syncthreads();  // the previous tile is consumed by every thread
    stage<T, D>(s_q, q + base + static_cast<long long>(t0) * D);
    stage<T, D>(s_do, dout + base + static_cast<long long>(t0) * D);
    s_lse2[threadIdx.x] = lse[head * seq + t0 + threadIdx.x] * kLog2e;
    s_di[threadIdx.x] = di[head * seq + t0 + threadIdx.x];
    __syncthreads();
#pragma unroll 4
    for (int i = 0; i < kBlock; ++i) {
      const float p = exp2f(dot_row<D>(kr, s_q[i]) * scale_log2 - s_lse2[i]);
      axpy_row<D>(dv_acc, round_to<T>(p), s_do[i]);
      const float dp = dot_row<D>(vr, s_do[i]);
      const float ds = (dp - s_di[i]) * p * scale;
      axpy_row<D>(dk_acc, round_to<T>(ds), s_q[i]);
    }
  }
#pragma unroll
  for (int c = 0; c < D; ++c) {
    dk[krow + c] = from_f32<T>(dk_acc[c]);
    dv[krow + c] = from_f32<T>(dv_acc[c]);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* lse, const void* dout, void* di, void* dq, void* dk,
           void* dv, int batch_heads, int seq, float scale,
           cudaStream_t stream) {
  const dim3 grid(seq / kBlock, batch_heads);
  attention_bwd_dq_kernel<T, D><<<grid, kBlock, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(o),
      static_cast<const float*>(lse), static_cast<const T*>(dout),
      static_cast<float*>(di), static_cast<T*>(dq), seq, scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // same stream: the dK/dV pass reads the D the dQ pass wrote
  attention_bwd_dkv_kernel<T, D><<<grid, kBlock, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(lse),
      static_cast<const T*>(dout), static_cast<const float*>(di),
      static_cast<T*>(dk), static_cast<T*>(dv), seq, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(int head_dim, const void* q, const void* k, const void* v,
             const void* o, const void* lse, const void* dout, void* di,
             void* dq, void* dk, void* dv, int batch_heads, int seq,
             float scale, cudaStream_t stream) {
  switch (head_dim) {
    case 16:
      return launch<T, 16>(q, k, v, o, lse, dout, di, dq, dk, dv,
                           batch_heads, seq, scale, stream);
    case 24:
      return launch<T, 24>(q, k, v, o, lse, dout, di, dq, dk, dv,
                           batch_heads, seq, scale, stream);
    case 32:
      return launch<T, 32>(q, k, v, o, lse, dout, di, dq, dk, dv,
                           batch_heads, seq, scale, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Plain C entry point for ctypes. dtype 0 = float32, 1 = bfloat16; `di` is
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
  if (seq % kBlock != 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch_d<float>(head_dim, q, k, v, o, lse, dout, di, dq, dk, dv,
                           batch_heads, seq, scale, s);
  }
  if (dtype == 1) {
    return launch_d<__nv_bfloat16>(head_dim, q, k, v, o, lse, dout, di, dq,
                                   dk, dv, batch_heads, seq, scale, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
