// Farthest-point sampling of one point cloud in one launch (F1), for
// Hopper, sm_90a.
//
// Replaces no TPU kernel: the JAX package runs FPS as a lax.scan that XLA
// compiles into one loop on the device (splatformer_tpu/ops/downsample.py).
// In PyTorch the same scan is a host loop of ~6 launches a pick (gather,
// subtract, square, sum, minimum, argmax): at 100,352 slots and ratio 0.35
// that is 35,123 picks and ~211k launches, ~2.3 s a request with the card
// idle most of it. Its function is the plain loop in ops/downsample.py
// (furthest_point_sampling_plain), which this kernel repeats bit for bit.
//
// What bounds it: the chain of m dependent global argmaxes. The operations
// (10 n m FP32, ~0.5 ms at 100k x 35k) and bytes (the cloud once) are far
// under the card's rates; each pick waits on the one before, so the time is
// m times the latency of one step (55.7 ms for 35,123 picks of 100,352
// slots, 1.58 us a step). A share of the operations' bound (the
// benchmark's fps_roofline.fps) therefore stays under 1%: that bound leaves
// the chain out. The design keeps every step on chip:
// one thread-block cluster of 16 CTAs (the non-portable size) x 1024
// threads holds the cloud, each thread P points (x, y, z and the running
// minimum distance) in registers for all m steps, P = ceil(N / 16384) a
// template (1-8). A step is
//   1. each thread: its points' squared distances to the last pick, the
//      running minimums, its own argmax (strict >, points in index order);
//   2. warp argmax: REDUX max of the key, then REDUX min of the index among
//      the lanes that hold it; lane 0 stores the warp's pair in shared
//      memory, __syncthreads;
//   3. warp 0: the CTA's argmax over the 32 pairs, with the winner's
//      coordinates from the CTA's copy of its points in shared memory;
//      lane q pushes it into CTA q's inbox over distributed shared memory
//      (one row a CTA, parity double-buffered by step);
//   4. one barrier.cluster arrive/wait (release/acquire);
//   5. every warp reduces its own CTA's inbox, a local read, to the same
//      winner and its coordinates;
//   6. thread 0 of CTA 0 writes the pick.
// Pushing (remote stores before the barrier) keeps remote latency off the
// path: pulling the candidates after the barrier (every warp loading 16
// remote slots) took 4.9 us a step at 100,352 points, pushing 1.58 (H100,
// 700 W). The cluster's size hardly matters then: at 65,536 points 16 CTAs
// (P = 4) take 1.40 us a step and 8 (P = 8) 1.55; at 100,352 points 13 and
// 16 CTAs (P = 8, 7) alike. Nor does the barrier: an mbarrier a parity
// that each CTA's push arrives on remotely, in place of barrier.cluster,
// took 1-2% less, so the simpler barrier stays.
// The argmax key is the running minimum's bit pattern as a signed int: the
// values are -inf (masked), >= +0, or NaN (the canonical 0x7fffffff from
// the card's arithmetic), so the int order is torch's order with NaN as the
// largest, and the smaller index wins ties, as torch's argmax does.
//
// Exactness. The plain loop computes d = (coord - c).square().sum(dim=1)
// and dist = minimum(dist, d) in float32. Here each product and sum is a
// round-to-nearest intrinsic (no FMA contraction, and the library is built
// with -fmad=false besides), summed in the association that PyTorch's CUDA
// sum over a row of 3 takes: its reduction splits the row over 2 lanes
// (block width = last_pow2(3)), lane 0 adding columns 0 and 2, then a
// shuffle adding lane 1's column 1: (dx^2 + dz^2) + dy^2 (ATen's
// Reduce.cuh, checked on the card against torch.sum over millions of random
// rows: chip_smoke.py's fps phase). minimum is min.NaN (NaN propagates, as
// torch.minimum). Masked points start at -inf, valid ones at 1e10; the
// first pick is the argmax of that start, the first valid index (index 0
// when none is valid), as the loop's argmax of the int8 mask gives it.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <climits>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxP = 8;           // points a thread: the largest template
constexpr int kCluster = 16;       // CTAs a cluster (non-portable above 8)

// One CTA's candidate of one step: its argmax and the point's coordinates.
struct alignas(16) Candidate {
  int key;
  int idx;
  float x;
  float y;
  float z;
  float pad[3];
};

__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// (x - cx)^2 + (z - cz)^2 + (y - cy)^2 in that association (header note)
__device__ __forceinline__ float squared_distance(float x, float y, float z,
                                                  float cx, float cy,
                                                  float cz) {
  const float dx = __fsub_rn(x, cx);
  const float dy = __fsub_rn(y, cy);
  const float dz = __fsub_rn(z, cz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dz, dz)),
                   __fmul_rn(dy, dy));
}

template <int P>
__global__ void __launch_bounds__(kThreads, 1)
fps_kernel(const float* __restrict__ coord, const uint8_t* __restrict__ mask,
           int n, int m, long long* __restrict__ picks) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int base = rank * (P * kThreads);  // this CTA's first point
  // point j of this thread is base + j * kThreads + tid; it exists if
  // j * kThreads < room
  const int room = n - base - tid;

  extern __shared__ float s_xyz[];  // this CTA's points: x, then y, then z
  float* s_x = s_xyz;
  float* s_y = s_x + P * kThreads;
  float* s_z = s_y + P * kThreads;
  __shared__ Candidate s_inbox[2][kCluster];  // [step parity][CTA]
  __shared__ int s_key[kWarps];
  __shared__ int s_idx[kWarps];

  float px[P], py[P], pz[P], pd[P];
  int best = INT_MIN;
  int best_j = 0;
#pragma unroll
  for (int j = 0; j < P; ++j) {
    const int i = base + j * kThreads + tid;
    const bool in = j * kThreads < room;
    px[j] = in ? coord[3 * i] : 0.0f;
    py[j] = in ? coord[3 * i + 1] : 0.0f;
    pz[j] = in ? coord[3 * i + 2] : 0.0f;
    pd[j] = (in && mask[i]) ? 1e10f : __int_as_float(0xff800000);  // -inf
    s_x[j * kThreads + tid] = px[j];
    s_y[j * kThreads + tid] = py[j];
    s_z[j * kThreads + tid] = pz[j];
    const int key = __float_as_int(pd[j]);
    if (key > best) {
      best = key;
      best_j = j;
    }
  }

  for (int s = 0;; ++s) {
    // 2. the warp's argmax
    const int idx = base + best_j * kThreads + tid;
    const int wkey = __reduce_max_sync(kFull, best);
    const int widx = __reduce_min_sync(kFull, best == wkey ? idx : INT_MAX);
    if (lane == 0) {
      s_key[warp] = wkey;
      s_idx[warp] = widx;
    }
    __syncthreads();  // also orders the s_xyz stores before their reads
    // 3. the CTA's argmax and its coordinates, pushed into this step's
    // inbox row of every CTA (lane q stores into CTA q)
    Candidate* inbox = s_inbox[s & 1];
    if (warp == 0) {
      const int k = s_key[lane];
      const int bkey = __reduce_max_sync(kFull, k);
      const int bidx = __reduce_min_sync(kFull,
                                         k == bkey ? s_idx[lane] : INT_MAX);
      if (lane < kCluster) {
        const int l = bidx - base;
        const int4 head = make_int4(bkey, bidx, __float_as_int(s_x[l]),
                                    __float_as_int(s_y[l]));
        Candidate* dst = cluster.map_shared_rank(&inbox[rank], lane);
        *reinterpret_cast<int4*>(dst) = head;
        dst->z = s_z[l];
      }
    }
    // 4. every CTA's candidate is in every inbox
    cluster.sync();
    // 5. the cluster's argmax from the local inbox, in every warp
    int ckey = INT_MIN;
    int cidx = INT_MAX;
    float cx = 0.0f, cy = 0.0f, cz = 0.0f;
    if (lane < kCluster) {
      const int4 head = *reinterpret_cast<const int4*>(&inbox[lane]);
      ckey = head.x;
      cidx = head.y;
      cx = __int_as_float(head.z);
      cy = __int_as_float(head.w);
      cz = inbox[lane].z;
    }
    const int gkey = __reduce_max_sync(kFull, ckey);
    const int gidx = __reduce_min_sync(kFull,
                                       ckey == gkey ? cidx : INT_MAX);
    const int src = __ffs(__ballot_sync(kFull, cidx == gidx)) - 1;
    cx = __shfl_sync(kFull, cx, src);
    cy = __shfl_sync(kFull, cy, src);
    cz = __shfl_sync(kFull, cz, src);
    // 6. the pick
    if (rank == 0 && tid == 0) picks[s] = gidx;
    if (s + 1 == m) break;
    // 1. the next step's distances, running minimums and own argmax. Pad
    // slots (index >= n) need no test: at 0 coordinates they stay at -inf
    // while the pick is finite, and once a NaN pick makes every distance
    // NaN, a live index below them wins the tie.
    best = INT_MIN;
    best_j = 0;
#pragma unroll
    for (int j = 0; j < P; ++j) {
      pd[j] = min_nan(pd[j],
                      squared_distance(px[j], py[j], pz[j], cx, cy, cz));
      const int key = __float_as_int(pd[j]);
      if (key > best) {
        best = key;
        best_j = j;
      }
    }
  }
  // Nothing remote follows the last cluster barrier: each CTA wrote the
  // others' inboxes before it, so a CTA may leave at once.
}

template <int P>
cudaError_t launch(const float* coord, const uint8_t* mask, int n, int m,
                   long long* picks, cudaStream_t stream) {
  const size_t smem = 3 * P * kThreads * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      fps_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      fps_kernel<P>, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, fps_kernel<P>, coord, mask, n, m, picks);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// m picks of the (n, 3) float32 cloud `coord` with the (n,) bool `mask`,
// into the (m,) int64 `picks`, by one cluster on `stream`. Returns a
// cudaError_t; cudaErrorInvalidValue for arguments out of range (n < 1,
// m < 1, n above 16 x 1024 x 8 = 131,072).
extern "C" int fps_launch(const float* coord, const uint8_t* mask, int n,
                          int m, long long* picks, void* stream) {
  constexpr int kOnePerThread = kCluster * kThreads;
  if (n < 1 || m < 1 || n > kOnePerThread * kMaxP)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const int per_thread = (n + kOnePerThread - 1) / kOnePerThread;
  cudaError_t err;
  switch (per_thread) {
    case 1: err = launch<1>(coord, mask, n, m, picks, s); break;
    case 2: err = launch<2>(coord, mask, n, m, picks, s); break;
    case 3: err = launch<3>(coord, mask, n, m, picks, s); break;
    case 4: err = launch<4>(coord, mask, n, m, picks, s); break;
    case 5: err = launch<5>(coord, mask, n, m, picks, s); break;
    case 6: err = launch<6>(coord, mask, n, m, picks, s); break;
    case 7: err = launch<7>(coord, mask, n, m, picks, s); break;
    default: err = launch<8>(coord, mask, n, m, picks, s); break;
  }
  return static_cast<int>(err);
}
