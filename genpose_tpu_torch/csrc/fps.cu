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
// redesign was measured (PERF.md, section 6).  The round itself (contiguous
// ownership, one barrier per round with parity-double-buffered warp
// partials, the argmax by __reduce_max_sync + ballot on the distance bits,
// the winner's coordinates carried through the reduction, no barrier on one
// warp) is csrc/fps_round.cuh, which csrc/fps_bq_fused.cu shares.

#include <cuda_runtime.h>

#include "fps_round.cuh"

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxPoints = 8192;

// the most threads an instantiation runs with: P=16 holds 64 floats of
// points per thread, so it keeps 128 registers by launching at most 512
template <int P>
constexpr int max_threads() { return P >= 16 ? 512 : kMaxThreads; }

template <int P>
__global__ void __launch_bounds__(max_threads<P>())
fps_kernel(const float* __restrict__ xyz, int* __restrict__ out, int N, int npoint) {
  __shared__ fps_round::Partials sh;

  const int tid = threadIdx.x;
  const float* pts = xyz + (size_t)blockIdx.x * N * 3;
  int* row = out + (size_t)blockIdx.x * npoint;

  fps_round::Points<P> cloud;
  cloud.load(pts, N, tid);
  if (tid == 0) row[0] = 0;
  float cx = pts[0], cy = pts[1], cz = pts[2];

  for (int j = 1; j < npoint; ++j) {
    float d[P];
    cloud.update(cx, cy, cz, d);
    const int cur = cloud.argmax(j, tid & 31, tid >> 5, blockDim.x >> 5, sh, cx, cy, cz);
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
