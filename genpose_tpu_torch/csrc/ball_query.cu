// Ball query for Hopper (sm_90a), every radius of an MSG stage in one launch.
//
// Replaces the TPU kernel genpose_tpu/ops/ball_query_pallas.py::
// ball_query_pallas (_bq_kernel).  Semantics are those of its oracle,
// genpose_tpu/ops/pointcloud.py::ball_query_ref (upstream
// ball_query_gpu.cu:9-45), for each of R radii (1 <= R <= 4) at once: for
// each center, the first S_k point indices, in index order, with
// ((dx*dx + dy*dy) + dz*dz) < r2_k; a row with fewer hits is padded with its
// first hit; a row with no hit is all zeros (ball_query_pallas.py:76-79).
// Each radius writes its own [B, M, S_k] table.
//
// What bounds it on this card: instruction issue.  It reads each cloud and
// its centers once and writes B*M*sum(S_k) indices (~6 MB at stage 0,
// B=64), while a distance is 8 flops per (center, point) pair (3 sub, 3 mul,
// 2 add) and one compare per radius, and a
// center walks up to N points until every row is full: at stage 0 the small
// radius rarely fills, so most centers walk the whole cloud.  Both bounds
// are a few microseconds at the serving shapes; what costs is the work per
// pair, above all placing hits in index order, which a warp-per-center
// walk pays with a ballot, popcounts and a branch on nearly every chunk
// (hits are spread over the index range).
//
// Design: G lanes per center (G = 1 or 8), lane j of a group taking
// points j, j+G, j+2G, ...; each distance is computed once and compared
// with every r2_k.  With G = 1 a lane walks its center's points one by one
// (the same point in every lane: a shared-memory broadcast) and places a hit
// at its own count, with no vote at all.  With G > 1 a __ballot_sync masked
// to the group and __popc of the group's hits below a lane give that lane's
// slot, so hits land in index order.  A radius with no slots votes no hits;
// every 32 points the warp stops once all its rows are full.  A block of 128
// threads stages its cloud once, as float4 (x, y, z, 0) padded with NaN
// (never inside a ball), and serves 128/G centers of it.  G = 1 when the
// centers alone fill the card (B*M >= 32768: stage 0 at B=64, the
// training batch's stages), else 8 (stages 1 and 2 at B=64): the fastest
// of G = 1, 2, 4, 8 at the path shapes when the redesign was measured
// (PERF.md, section 6).  A row's first hit,
// which pads a short row, is read back from row[0].
//
// Bit-exactness: the distance is written with __fsub_rn/__fmul_rn/__fadd_rn
// (never contracted into FMAs) in the oracle's order, and r2 arrives already
// rounded to float32 from the double-precision square of the radius (the
// JAX package squares the radius as a Python float).  The build also passes
// -fmad=false.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxPoints = 4096;  // 64 KB of staged points
constexpr int kMaxRadii = 4;
constexpr long long kFillThreads = 32768;

struct Balls {
  int* out[kMaxRadii];   // radius k's table, [B, M, S[k]] int32
  float r2[kMaxRadii];   // squared radii, float32
  int S[kMaxRadii];      // nsample per radius
};

// R radii; G lanes per center, lane j of a group taking points j, j+G, ...
template <int R, int G>
__global__ void __launch_bounds__(kThreads)
ball_query_kernel(const float* __restrict__ xyz, const float* __restrict__ new_xyz,
                  int N, int M, Balls balls) {
  extern __shared__ float4 s_pts[];  // (x, y, z, 0); NaN past N, never inside a ball
  const int n_pad = (N + 31) & ~31;
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int j = lane & (G - 1);
  const int m = blockIdx.x * (kThreads / G) + threadIdx.x / G;
  const bool live = m < M;

  // the center is loaded before the staging, so the two overlap
  const size_t cm = (size_t)b * M + min(m, M - 1);
  const float cx = new_xyz[3 * cm], cy = new_xyz[3 * cm + 1], cz = new_xyz[3 * cm + 2];
  const float* pts = xyz + (size_t)b * N * 3;
  for (int i = threadIdx.x; i < n_pad; i += kThreads)
    s_pts[i] = i < N ? make_float4(pts[3 * i], pts[3 * i + 1], pts[3 * i + 2], 0.f)
                     : make_float4(CUDART_NAN_F, CUDART_NAN_F, CUDART_NAN_F, 0.f);
  __syncthreads();

  // this lane's group of G lanes in the warp's ballot, and the lanes below it
  const int g0 = lane & ~(G - 1);
  const unsigned group = (G == 32 ? 0xffffffffu : (1u << G) - 1u) << g0;
  const unsigned below = ((1u << j) - 1u) << g0;
  float r2[R];   // -inf for a radius without slots (and for a lane without a center)
  int cnt[R];    // hits so far; the same in every lane of the group
  int S[R];
  int* row[R];
#pragma unroll
  for (int k = 0; k < R; ++k) {
    S[k] = balls.S[k];
    r2[k] = live && S[k] > 0 ? balls.r2[k] : -CUDART_INF_F;
    cnt[k] = 0;
    row[k] = balls.out[k] + cm * S[k];
  }
  for (int base = 0; base < n_pad; base += 32) {
    bool open = false;
#pragma unroll
    for (int k = 0; k < R; ++k) open |= r2[k] > -CUDART_INF_F && cnt[k] < S[k];
    if (!__any_sync(0xffffffffu, open)) break;  // every row of the warp is full
#pragma unroll 8
    for (int t = 0; t < 32; t += G) {
      const int i = base + t + j;
      const float4 p = s_pts[i];
      const float dx = __fsub_rn(cx, p.x);
      const float dy = __fsub_rn(cy, p.y);
      const float dz = __fsub_rn(cz, p.z);
      const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                 __fmul_rn(dz, dz));
#pragma unroll
      for (int k = 0; k < R; ++k) {
        const bool hit = d2 < r2[k];
        if constexpr (G == 1) {
          if (hit && cnt[k] < S[k]) row[k][cnt[k]] = i;
          cnt[k] += hit;
        } else {  // the group's hits of this step, placed in index order
          const unsigned hits = __ballot_sync(0xffffffffu, hit) & group;
          const int slot = cnt[k] + __popc(hits & below);
          if (hit && slot < S[k]) row[k][slot] = i;
          cnt[k] += __popc(hits);
        }
      }
    }
  }
  __syncwarp();  // the group's stores of row[0] are visible to all its lanes
  if (!live) return;
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const int pad = cnt[k] > 0 ? row[k][0] : 0;  // the first hit
    for (int s = min(cnt[k], S[k]) + j; s < S[k]; s += G) row[k][s] = pad;
  }
}

template <int R, int G>
cudaError_t launch(const float* xyz, const float* new_xyz, int B, int N, int M,
                   const Balls& balls, cudaStream_t stream) {
  const dim3 grid((M + kThreads / G - 1) / (kThreads / G), B);
  const size_t smem = (size_t)((N + 31) & ~31) * sizeof(float4);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        ball_query_kernel<R, G>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  ball_query_kernel<R, G><<<grid, kThreads, smem, stream>>>(xyz, new_xyz, N, M, balls);
  return cudaGetLastError();
}

// one lane per center when the centers alone fill the card, else 8
template <int R>
cudaError_t launch_r(const float* xyz, const float* new_xyz, int B, int N, int M,
                     const Balls& balls, cudaStream_t stream) {
  if ((long long)B * M >= kFillThreads) return launch<R, 1>(xyz, new_xyz, B, N, M, balls, stream);
  return launch<R, 8>(xyz, new_xyz, B, N, M, balls, stream);
}

}  // namespace

// xyz: [B, N, 3], new_xyz: [B, M, 3] float32 contiguous; outs: R device
// pointers, outs[k] an [B, M, nsamples[k]] int32 table.  r2 and nsamples are
// host arrays of R values; r2 holds the squared radii, already rounded to
// float32.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int gp_ball_query(const float* xyz, const float* new_xyz, int B, int N, int M,
                             int R, const float* r2, const int* nsamples, void* const* outs,
                             void* stream) {
  if (N <= 0 || N > kMaxPoints || R <= 0 || R > kMaxRadii || B > 65535)
    return (int)cudaErrorInvalidValue;
  Balls balls{};
  bool any = false;
  for (int k = 0; k < R; ++k) {
    if (nsamples[k] < 0) return (int)cudaErrorInvalidValue;
    balls.out[k] = static_cast<int*>(outs[k]);
    balls.r2[k] = r2[k];
    balls.S[k] = nsamples[k];
    any |= nsamples[k] > 0;
  }
  if (B <= 0 || M <= 0 || !any) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (R) {
    case 1: return (int)launch_r<1>(xyz, new_xyz, B, N, M, balls, s);
    case 2: return (int)launch_r<2>(xyz, new_xyz, B, N, M, balls, s);
    case 3: return (int)launch_r<3>(xyz, new_xyz, B, N, M, balls, s);
    default: return (int)launch_r<4>(xyz, new_xyz, B, N, M, balls, s);
  }
}
