// Fused furthest point sampling + ball query for Hopper (sm_90a).
//
// Replaces the TPU kernel genpose_tpu/ops/fps_bq_fused.py::fps_bq_fused
// (_fused_kernel with _bq_row).  What it computes is FPS as in csrc/fps.cu,
// and for every radius r_k the ball-query row of each selected center, as
// in csrc/ball_query.cu, taken from the distance row that the FPS round
// already holds:
//     fps[j]        as csrc/fps.cu (index 0 first, argmax ties to the lowest
//                   index, npoint > N keeps picking 0);
//     bq_k[j, s]    the s-th point index, in index order, with
//                   ((dx*dx + dy*dy) + dz*dz) < r2_k to the center fps[j];
//                   a row with fewer than S_k hits is padded with its first
//                   hit, a row without hits is all zeros.
// The output is bit-identical to FPS -> gather centers -> ball query per
// radius (the Pallas kernel's contract, fps_bq_fused.py:28-33).
//
// What bounds it on this card: latency, as for FPS.  The npoint rounds are
// a sequential chain (each center is the argmax of distances to the
// previous ones), and the per-round compaction of the ball-query hits sits
// inside that chain.  Bytes (a 1024-point cloud is 12 KB, the index rows
// ~96 bytes per center and radius) and arithmetic (~10 flops per point per
// round, one compare per point and radius) are both far below what the card
// does in the time a round's barriers take.
//
// Design, on csrc/fps.cu's: one block per cloud, point i in thread i % T,
// slot i / T, so a thread's slots hold increasing indices and the index
// order of the whole cloud is (slot, warp, lane).  Round j computes the
// distance row of center j in registers.  Before the round's first barrier
// every warp stores, for each radius and slot, the __ballot_sync mask of
// its hits in shared memory, beside its FPS argmax partial.  After the
// barrier every warp loads the (at most 16) masks of a (radius, slot), one
// per lane, and a shuffle scan gives the hits of the warps before each one
// (an exclusive prefix): each thread writes its hit to that place, slot
// after slot, until S_k hits are placed.  The first hit, which pads a short
// row, is read off the same masks.  So the compaction adds no barrier: a
// round has the two of csrc/fps.cu (the second keeps the masks and the next
// center from being overwritten while read).  One launch covers every
// radius; the rows of all radii lie side by side in one [B, npoint, sum S_k]
// buffer.
//
// Bit-exactness: the distance is written with __fsub_rn/__fmul_rn/__fadd_rn,
// never contracted into FMAs, in the oracles' order; r2_k arrives already
// rounded to float32 from the double-precision square of the radius.  The
// build also passes -fmad=false.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kMaxThreads = 512;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kMaxPerThread = 16;  // N <= 8192
constexpr int kMaxRadii = 8;

struct Balls {
  float r2[kMaxRadii];  // squared radii, float32
  int S[kMaxRadii];     // nsample per radius
  int off[kMaxRadii];   // column of radius k's rows in the output row
  int R;                // number of radii
  int S_total;          // sum of S
};

__device__ __forceinline__ float sq_dist(float x, float y, float z,
                                         float cx, float cy, float cz) {
  const float dx = __fsub_rn(x, cx);
  const float dy = __fsub_rn(y, cy);
  const float dz = __fsub_rn(z, cz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// (v, i) beats (bv, bi) when larger, or equal and at a lower index.
__device__ __forceinline__ void take_better(float& bv, int& bi, float v, int i) {
  if (v > bv || (v == bv && i < bi)) {
    bv = v;
    bi = i;
  }
}

__device__ __forceinline__ void warp_argmax(float& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, v, off);
    const int oi = __shfl_down_sync(0xffffffffu, i, off);
    take_better(v, i, ov, oi);
  }
}

template <int P>
__global__ void __launch_bounds__(kMaxThreads)
fps_bq_fused_kernel(const float* __restrict__ xyz, int* __restrict__ fps_out,
                    int* __restrict__ bq_out, int N, int npoint, Balls balls) {
  extern __shared__ float s_xyz[];  // [N * 3]
  __shared__ float s_val[kMaxWarps];
  __shared__ int s_idx[kMaxWarps];
  __shared__ unsigned s_mask[kMaxRadii][P][kMaxWarps];
  __shared__ int s_cur;

  const int T = blockDim.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = T >> 5;
  const unsigned lanes_below = (1u << lane) - 1u;
  const float* pts = xyz + (size_t)blockIdx.x * N * 3;
  int* frow = fps_out + (size_t)blockIdx.x * npoint;
  int* brows = bq_out + (size_t)blockIdx.x * npoint * balls.S_total;

  for (int k = tid; k < 3 * N; k += T) s_xyz[k] = pts[k];

  float px[P], py[P], pz[P], mind[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int i = tid + p * T;
    if (i < N) {
      px[p] = pts[3 * i];
      py[p] = pts[3 * i + 1];
      pz[p] = pts[3 * i + 2];
      mind[p] = 1e10f;
    } else {
      px[p] = py[p] = pz[p] = 0.f;
      mind[p] = -CUDART_INF_F;  // padding never wins
    }
  }
  if (tid == 0) {
    s_cur = 0;
    frow[0] = 0;
  }
  __syncthreads();

  for (int j = 0; j < npoint; ++j) {
    const int cur = s_cur;
    const float cx = s_xyz[3 * cur], cy = s_xyz[3 * cur + 1], cz = s_xyz[3 * cur + 2];
    const bool more = j + 1 < npoint;  // a center is still to pick
    float d[P];
    float bv = -CUDART_INF_F;
    int bi = 0x7fffffff;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int i = tid + p * T;
      d[p] = sq_dist(px[p], py[p], pz[p], cx, cy, cz);
      if (more && i < N) {
        mind[p] = fminf(mind[p], d[p]);
        if (mind[p] > bv) {  // strict: the first (lowest) index keeps a tie
          bv = mind[p];
          bi = i;
        }
      }
    }
    // this round's hit masks, one per (radius, slot), and the argmax partials
    for (int k = 0; k < balls.R; ++k) {
      const float r2 = balls.r2[k];
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const unsigned mask = __ballot_sync(0xffffffffu, tid + p * T < N && d[p] < r2);
        if (lane == 0) s_mask[k][p][warp] = mask;
      }
    }
    if (more) {
      warp_argmax(bv, bi);
      if (lane == 0) {
        s_val[warp] = bv;
        s_idx[warp] = bi;
      }
    }
    __syncthreads();

    // ball-query rows of center j, one radius after the other
    int* brow = brows + (size_t)j * balls.S_total;
    for (int k = 0; k < balls.R; ++k) {
      const int S = balls.S[k];
      int* row = brow + balls.off[k];
      int cnt = 0;     // hits placed before this slot; the same in every thread
      int first = -1;  // index of the first hit
#pragma unroll
      for (int p = 0; p < P; ++p) {
        if (cnt < S) {  // block-uniform
          // lane w holds warp w's hits of this slot
          const unsigned m_w = lane < n_warps ? s_mask[k][p][lane] : 0u;
          const int c_w = __popc(m_w);
          int incl = c_w;  // inclusive prefix over warps 0..lane
#pragma unroll
          for (int off = 1; off < 32; off <<= 1) {
            const int v = __shfl_up_sync(0xffffffffu, incl, off);
            if (lane >= off) incl += v;
          }
          const int before = cnt + __shfl_sync(0xffffffffu, incl - c_w, warp);
          const unsigned any = __ballot_sync(0xffffffffu, m_w != 0u);
          if (first < 0 && any) {  // block-uniform
            const int w = __ffs(any) - 1;
            first = p * T + w * 32 + __ffs(__shfl_sync(0xffffffffu, m_w, w)) - 1;
          }
          cnt += __shfl_sync(0xffffffffu, incl, 31);
          const unsigned mine = __shfl_sync(0xffffffffu, m_w, warp);  // this warp's hits
          if (mine & (1u << lane)) {
            const int slot = before + __popc(mine & lanes_below);
            if (slot < S) row[slot] = tid + p * T;
          }
        }
      }
      const int pad = cnt > 0 ? first : 0;
      for (int s = min(cnt, S) + tid; s < S; s += T) row[s] = pad;
    }

    if (more && warp == 0) {  // FPS: center j+1
      bv = lane < n_warps ? s_val[lane] : -CUDART_INF_F;
      bi = lane < n_warps ? s_idx[lane] : 0x7fffffff;
      warp_argmax(bv, bi);
      if (lane == 0) {
        s_cur = bi;
        frow[j + 1] = bi;
      }
    }
    __syncthreads();
  }
}

template <int P>
cudaError_t launch(const float* xyz, int* fps_out, int* bq_out, int B, int N, int npoint,
                   const Balls& balls, int threads, cudaStream_t stream) {
  const size_t smem = (size_t)N * 3 * sizeof(float);
  if (smem > 32 * 1024) {  // with the static masks (up to 8 KB) past the default 48 KB
    const cudaError_t e = cudaFuncSetAttribute(
        fps_bq_fused_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  fps_bq_fused_kernel<P><<<B, threads, smem, stream>>>(xyz, fps_out, bq_out, N, npoint, balls);
  return cudaGetLastError();
}

}  // namespace

// xyz: [B, N, 3] float32 contiguous; fps_out: [B, npoint] int32;
// bq_out: [B, npoint, sum(nsamples)] int32, radius k's rows in the columns
// [off_k, off_k + nsamples[k]).  r2 and nsamples are host arrays of R
// values; r2 holds the squared radii, already rounded to float32.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int gp_fps_bq_fused(const float* xyz, int* fps_out, int* bq_out, int B, int N,
                               int npoint, int R, const float* r2, const int* nsamples,
                               void* stream) {
  if (B <= 0 || npoint <= 0) return 0;
  if (N <= 0 || N > kMaxThreads * kMaxPerThread || R <= 0 || R > kMaxRadii)
    return (int)cudaErrorInvalidValue;
  Balls balls{};
  balls.R = R;
  int off = 0;
  for (int k = 0; k < R; ++k) {
    if (nsamples[k] <= 0) return (int)cudaErrorInvalidValue;
    balls.r2[k] = r2[k];
    balls.S[k] = nsamples[k];
    balls.off[k] = off;
    off += nsamples[k];
  }
  balls.S_total = off;
  const int threads = N < kMaxThreads ? ((N + 31) / 32) * 32 : kMaxThreads;
  const int per = (N + threads - 1) / threads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (per <= 1) e = launch<1>(xyz, fps_out, bq_out, B, N, npoint, balls, threads, s);
  else if (per <= 2) e = launch<2>(xyz, fps_out, bq_out, B, N, npoint, balls, threads, s);
  else if (per <= 4) e = launch<4>(xyz, fps_out, bq_out, B, N, npoint, balls, threads, s);
  else if (per <= 8) e = launch<8>(xyz, fps_out, bq_out, B, N, npoint, balls, threads, s);
  else e = launch<16>(xyz, fps_out, bq_out, B, N, npoint, balls, threads, s);
  return (int)e;
}
