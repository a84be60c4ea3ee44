// Furthest point sampling for Hopper (sm_90a).
//
// Replaces the TPU kernel genpose_tpu/ops/fps_pallas.py::fps_pallas
// (_fps_kernel).  Semantics are those of its oracle,
// genpose_tpu/ops/pointcloud.py::farthest_point_sample_ref (upstream
// sampling_gpu.cu:93-208): index 0 is taken first; then npoint-1 rounds of
//     mind[i] = min(mind[i], (dx*dx + dy*dy) + dz*dz)   (mind starts at 1e10)
//     next    = argmax(mind), ties to the LOWEST index.
// With npoint > N every mind reaches 0 and the tie rule keeps picking 0,
// exactly as jnp.argmax does.  No point filter is applied.
//
// What bounds it on this card: not bytes (a 1024-point cloud is 12 KB) and
// not arithmetic (~10 flops per point per round), but latency.  The rounds
// are a sequential chain, each ending in a block-wide argmax whose result
// the next round needs: npoint-1 dependent block reductions per cloud.  So
// the design shortens the round, not the work.
//
// Design: one block per cloud, P points per thread in registers.  P = 8
// above 512 points; a cloud of up to 512 points runs on one warp with the
// smallest P of 1, 2, 4, 8, 16 that holds it.  So N=1024 runs on 4 warps,
// N=512 and N=256 on one: the fastest choices at the path shapes when the
// redesign was measured (PERF.md, section 6).  Thread t owns the contiguous
// run [t*P, t*P + P), so "lowest index among equal maxima" is
// "lowest slot, then lowest lane, then lowest warp".  A round:
//   1. each thread updates its P distances and takes its first maximum in
//      a tree of log2(P) levels (not a chain of P compares);
//   2. the warp argmax: mind >= 0, so its float bits order as unsigned;
//      __reduce_max_sync (redux.sync) finds the maximum, __ballot_sync +
//      __ffs the lowest lane holding it;
//   3. that lane stores (max, index) in shared memory, in a buffer
//      chosen by the round's parity; one __syncthreads; then EVERY warp
//      reduces the W partials itself, the same way, so no second barrier
//      and no broadcast are needed.  Parity double-buffering makes that
//      safe: a warp can write round j+2's partials into round j's buffer
//      only after passing round j+1's barrier, which every warp reaches
//      after its read of round j.
//   4. the winner's coordinates travel with it: each tree node carries its
//      point, the warp's winner stores it beside its maximum, and the last
//      step shuffles it to every lane, so the next round starts without a
//      dependent load (the cloud lives in registers only).
// A one-warp cloud needs no barrier at all: one __shfl_sync gives every
// lane the winner.  Padding points (indices >= N) hold mind = 0 and sit
// above every real index, so they lose every tie (npoint > N included).
//
// Bit-exactness: the distance is written with __fsub_rn/__fmul_rn/__fadd_rn,
// which are never contracted into FMAs, in the oracle's order.  The build
// also passes -fmad=false.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxPoints = 8192;

// the most threads an instantiation runs with: P=16 holds 64 floats of
// points per thread, so it keeps 128 registers by launching at most 512
template <int P>
constexpr int max_threads() { return P >= 16 ? 512 : kMaxThreads; }

__device__ __forceinline__ float sq_dist(float x, float y, float z,
                                         float cx, float cy, float cz) {
  const float dx = __fsub_rn(x, cx);
  const float dy = __fsub_rn(y, cy);
  const float dz = __fsub_rn(z, cz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

template <int P>
__global__ void __launch_bounds__(max_threads<P>())
fps_kernel(const float* __restrict__ xyz, int* __restrict__ out, int N, int npoint) {
  __shared__ unsigned s_val[2][32];  // per-warp maxima (float bits), by round parity
  __shared__ float4 s_win[2][32];    // their points: x, y, z and the index's bits

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;
  const unsigned full = 0xffffffffu;
  const float* pts = xyz + (size_t)blockIdx.x * N * 3;
  int* row = out + (size_t)blockIdx.x * npoint;

  const int i0 = tid * P;  // this thread's first point
  float px[P], py[P], pz[P], mind[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int i = i0 + p;
    if (i < N) {
      px[p] = pts[3 * i];
      py[p] = pts[3 * i + 1];
      pz[p] = pts[3 * i + 2];
      mind[p] = 1e10f;
    } else {  // padding: stays at 0 and loses every tie to a real point
      px[p] = py[p] = pz[p] = 0.f;
      mind[p] = 0.f;
    }
  }
  if (tid == 0) row[0] = 0;
  float cx = pts[0], cy = pts[1], cz = pts[2];

  for (int j = 1; j < npoint; ++j) {
    // the distances' bits, then a tree of (max, slot, point) down to [0]
    unsigned v[P];
    int slot[P];
    float wx[P], wy[P], wz[P];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      mind[p] = fminf(mind[p], sq_dist(px[p], py[p], pz[p], cx, cy, cz));
      v[p] = __float_as_uint(mind[p]);
      slot[p] = p;
      wx[p] = px[p];
      wy[p] = py[p];
      wz[p] = pz[p];
    }
    // the thread's first maximum in log2(P) levels: the right half wins
    // only when strictly larger, so the lower slot keeps a tie
#pragma unroll
    for (int s = 1; s < P; s *= 2) {
#pragma unroll
      for (int p = 0; p + s < P; p += 2 * s) {
        if (v[p + s] > v[p]) {
          v[p] = v[p + s];
          slot[p] = slot[p + s];
          wx[p] = wx[p + s];
          wy[p] = wy[p + s];
          wz[p] = wz[p + s];
        }
      }
    }
    const unsigned wmax = __reduce_max_sync(full, v[0]);
    const int wlane = __ffs(__ballot_sync(full, v[0] == wmax)) - 1;  // lowest lane
    int cur;
    if (n_warps > 1) {  // block-uniform
      const int par = j & 1;
      if (lane == wlane) {
        s_val[par][warp] = wmax;
        s_win[par][warp] = make_float4(wx[0], wy[0], wz[0], __int_as_float(i0 + slot[0]));
      }
      __syncthreads();
      // lanes past the last warp hold 0, which loses ties to lane 0
      const unsigned w = lane < n_warps ? s_val[par][lane] : 0u;
      const float4 c = s_win[par][lane < n_warps ? lane : 0];
      const unsigned bmax = __reduce_max_sync(full, w);
      const int src = __ffs(__ballot_sync(full, w == bmax)) - 1;
      cx = __shfl_sync(full, c.x, src);
      cy = __shfl_sync(full, c.y, src);
      cz = __shfl_sync(full, c.z, src);
      cur = __float_as_int(__shfl_sync(full, c.w, src));
    } else {
      cx = __shfl_sync(full, wx[0], wlane);
      cy = __shfl_sync(full, wy[0], wlane);
      cz = __shfl_sync(full, wz[0], wlane);
      cur = __shfl_sync(full, i0 + slot[0], wlane);
    }
    if (tid == 0) row[j] = cur;
  }
}

template <int P>
cudaError_t launch(const float* xyz, int* out, int B, int N, int npoint,
                   cudaStream_t stream) {
  const int threads = ((N + P - 1) / P + 31) / 32 * 32;
  if (threads > max_threads<P>()) return cudaErrorInvalidValue;
  fps_kernel<P><<<B, threads, 0, stream>>>(xyz, out, N, npoint);
  return cudaGetLastError();
}

}  // namespace

// xyz: [B, N, 3] float32 contiguous; out: [B, npoint] int32.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int gp_fps(const float* xyz, int* out, int B, int N, int npoint, void* stream) {
  if (B <= 0 || npoint <= 0) return 0;
  if (N <= 0 || N > kMaxPoints) return (int)cudaErrorInvalidValue;
  int P = 8;
  if (N <= 512) {  // one warp, no barrier: the smallest P that holds the cloud
    P = 16;
    while (P > 1 && (P / 2) * 32 >= N) P /= 2;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (P) {
    case 1: return (int)launch<1>(xyz, out, B, N, npoint, s);
    case 2: return (int)launch<2>(xyz, out, B, N, npoint, s);
    case 4: return (int)launch<4>(xyz, out, B, N, npoint, s);
    case 8: return (int)launch<8>(xyz, out, B, N, npoint, s);
    case 16: return (int)launch<16>(xyz, out, B, N, npoint, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
