// One round of furthest point sampling on Hopper, shared by csrc/fps.cu and
// csrc/fps_bq_fused.cu.
//
// Semantics are those of genpose_tpu/ops/pointcloud.py::
// farthest_point_sample_ref (upstream sampling_gpu.cu:93-208): index 0 is
// taken first; then npoint-1 rounds of
//     mind[i] = min(mind[i], (dx*dx + dy*dy) + dz*dz)   (mind starts at 1e10)
//     next    = argmax(mind), ties to the LOWEST index.
// With npoint > N every mind reaches 0 and the tie rule keeps picking 0,
// exactly as jnp.argmax does.
//
// A round is a link of a sequential chain (its argmax is the next round's
// center), so it is designed for latency.  The producing threads of a block
// hold one cloud: thread t owns the P contiguous points [t*P, t*P + P) in
// registers, so "lowest index among equal maxima" is "lowest slot, then
// lowest lane, then lowest warp".  A round:
//   1. update(): each thread takes the distance d[p] of its points to the
//      current center and lowers mind[p] to it.  d is returned on its own:
//      the fused kernel's ball-query compare is d < r^2, never mind < r^2;
//   2. warp_argmax(): the thread's first maximum in a tree of log2(P)
//      levels; the warp's by __reduce_max_sync (redux.sync) on the float
//      bits (mind >= 0, so they order as unsigned), then __ballot_sync +
//      __ffs for the lowest lane holding it;
//   3. block_argmax(): with several warps, that lane stores (max, point) in
//      shared memory, in a buffer chosen by the round's parity; one barrier
//      over the producing threads (named barrier 1, so warps of another
//      role never take part); then EVERY warp reduces the W partials
//      itself, the same way, so no second barrier and no broadcast are
//      needed.  Parity double-buffering makes that safe: a warp can write
//      round j+2's partials into round j's buffer only after passing round
//      j+1's barrier, which every warp reaches after its read of round j;
//   4. the winner's coordinates travel with it: each tree node carries its
//      point, the warp's winner stores it beside its maximum, and the last
//      step shuffles it to every lane, so the next round starts without a
//      dependent load (the cloud lives in registers only).
// A one-warp cloud needs no barrier at all: one __shfl_sync gives every lane
// the winner.  argmax() is both parts; the fused kernel issues its ring
// stores between them, while the warp's reduction is in flight.  Padding
// points (indices >= N) hold mind = 0 and sit above every real index, so
// they lose every tie (npoint > N included).
//
// Bit-exactness: the distance is written with __fsub_rn/__fmul_rn/__fadd_rn,
// which are never contracted into FMAs, in the oracle's order.  The build
// also passes -fmad=false.

#pragma once

#include <cuda_runtime.h>

namespace fps_round {

__device__ __forceinline__ float sq_dist(float x, float y, float z,
                                         float cx, float cy, float cz) {
  const float dx = __fsub_rn(x, cx);
  const float dy = __fsub_rn(y, cy);
  const float dz = __fsub_rn(z, cz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// Named barrier 1 over the block's first n threads (a multiple of 32).
__device__ __forceinline__ void producer_sync(int n) {
  asm volatile("bar.sync 1, %0;" ::"r"(n) : "memory");
}

// The warp partials of a round, double-buffered by the round's parity.
struct Partials {
  unsigned val[2][32];  // per-warp maxima (float bits)
  float4 win[2][32];    // their points: x, y, z and the index's bits
};

// A warp's first maximum of mind: its bits, the lowest lane holding it, and
// that lane's point (index and coordinates; valid in that lane).
struct WarpMax {
  unsigned val;
  int lane;
  int index;
  float x, y, z;
};

// One thread's P contiguous points and their running minimum distances.
template <int P>
struct Points {
  float px[P], py[P], pz[P], mind[P];
  int i0;  // the first of the thread's points

  __device__ __forceinline__ void load(const float* __restrict__ pts, int N, int t) {
    i0 = t * P;
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
  }

  // d[p]: the distance of point p to the center; mind[p] lowered to it.
  __device__ __forceinline__ void update(float cx, float cy, float cz, float (&d)[P]) {
#pragma unroll
    for (int p = 0; p < P; ++p) {
      d[p] = sq_dist(px[p], py[p], pz[p], cx, cy, cz);
      mind[p] = fminf(mind[p], d[p]);
    }
  }

  // The warp's part of the argmax: the thread's first maximum in a tree of
  // log2(P) levels (the right half wins only when strictly larger, so the
  // lower slot keeps a tie), then the warp's by redux.sync and ballot.
  __device__ __forceinline__ WarpMax warp_argmax() const {
    const unsigned full = 0xffffffffu;
    unsigned v[P];
    int slot[P];
    float wx[P], wy[P], wz[P];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      v[p] = __float_as_uint(mind[p]);
      slot[p] = p;
      wx[p] = px[p];
      wy[p] = py[p];
      wz[p] = pz[p];
    }
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
    return WarpMax{wmax, wlane, i0 + slot[0], wx[0], wy[0], wz[0]};
  }

  // The block's part: the next center from the warps' maxima.  Returns its
  // index and sets (cx, cy, cz) to its point.  j is the round's number (its
  // parity picks the partials' buffer).
  __device__ __forceinline__ int block_argmax(const WarpMax& m, int j, int lane, int warp,
                                              int n_warps, Partials& sh, float& cx, float& cy,
                                              float& cz) const {
    const unsigned full = 0xffffffffu;
    if (n_warps > 1) {  // uniform over the producing threads
      const int par = j & 1;
      if (lane == m.lane) {
        sh.val[par][warp] = m.val;
        sh.win[par][warp] = make_float4(m.x, m.y, m.z, __int_as_float(m.index));
      }
      producer_sync(n_warps * 32);
      // lanes past the last warp hold 0, which loses ties to lane 0
      const unsigned w = lane < n_warps ? sh.val[par][lane] : 0u;
      const float4 c = sh.win[par][lane < n_warps ? lane : 0];
      const unsigned bmax = __reduce_max_sync(full, w);
      const int src = __ffs(__ballot_sync(full, w == bmax)) - 1;
      cx = __shfl_sync(full, c.x, src);
      cy = __shfl_sync(full, c.y, src);
      cz = __shfl_sync(full, c.z, src);
      return __float_as_int(__shfl_sync(full, c.w, src));
    }
    cx = __shfl_sync(full, m.x, m.lane);
    cy = __shfl_sync(full, m.y, m.lane);
    cz = __shfl_sync(full, m.z, m.lane);
    return __shfl_sync(full, m.index, m.lane);
  }

  // The next center, the first maximum of mind over the n_warps producing
  // warps (ties to the lowest index): both parts in one.
  __device__ __forceinline__ int argmax(int j, int lane, int warp, int n_warps, Partials& sh,
                                        float& cx, float& cy, float& cz) const {
    return block_argmax(warp_argmax(), j, lane, warp, n_warps, sh, cx, cy, cz);
  }
};

}  // namespace fps_round
