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
// previous ones).  Bytes (a 1024-point cloud is 12 KB, the index rows ~96
// bytes per center and radius) and arithmetic (~10 flops per point per
// round, one compare per point and radius) are both far below what the
// card does in the time a round's reduction takes.  So nothing but the FPS
// round may sit on the chain: the ball query, which no later center needs,
// runs beside it in other warps.
//
// Design: one block per cloud, two roles.
//   * Producer warps run csrc/fps.cu's round (csrc/fps_round.cuh): P
//     contiguous points per lane in registers, one barrier per round (named
//     barrier 1 over the producers only; none on one warp), the argmax by
//     redux.sync + ballot.  Round j computes the distance row d of center
//     j-1 and, besides lowering mind with it, stores it into a slot of a
//     ring in shared memory: P floats a lane, in vector stores.  A last pass
//     without FPS stores the row of the final center (with npoint = 1, only
//     that).  Comparing and packing bits in the round instead lengthened it
//     the most after the hand-off (PERF.md, section 6): a one-warp producer
//     issues every compare itself, in order.
//   * Consumer warps, Q of them, turn distance rows into index rows: warp q
//     takes the (row, radius) tasks q, q + Q, q + 2Q, ... of the npoint x R
//     in row-major order, so with Q = C*R (the path's shapes) each warp
//     keeps one radius and every C-th row.  Each lane takes a contiguous
//     span of the row, L = min(ceil(N/32) rounded up to 4, 32) points, in
//     128-bit loads, and compares them with r2_k itself (the ball-query
//     compare is on d, never on mind): its span's hit bits, in registers.  A warp exclusive scan of
//     the spans' popcounts (ballots of the counts' bits) gives each lane the
//     rank of its first hit, and each lane writes its hits at their ranks
//     below S_k.  The first hit (ballot + __ffs over the non-empty spans)
//     pads a short row; an empty ball gives zeros.  Short spans keep a
//     lane's serial part short where balls are dense (8 points a lane at
//     N = 256).  A consumer warp takes longer for a row than a producer
//     round (a latency-bound chain of loads, votes, popcounts and bit
//     scans), hence up to four per radius.  Beside a one-warp producer, no
//     consumer shares its SM sub-partition.  The ring's 16-byte chunks are
//     swizzled, so the producers' stores and the consumers' loads are free
//     of bank conflicts.
//   * The hand-off: per ring slot a `full` mbarrier (one arrival, producer
//     thread 0's, after the producers' barrier of the round that wrote the
//     row), on which consumers wait suspended.  The way back is a progress
//     word per consumer warp, the next row it will take, stored with release
//     semantics after its reads of a row; producers read the words with
//     acquire loads, one per lane, and only when they wrap the ring, once
//     per half ring (see wait_half_free).  An `empty` mbarrier per slot in
//     their place made the multi-warp round longer (PERF.md, section 6):
//     even a wait on a completed phase is slower than an acquire load, and
//     a check needed one per consumer warp of a radius.  Every wait spins
//     for at most 2^31 cycles (~1 s) and then traps, so a protocol fault is
//     a CUDA error, not a hang.
// The producers' shape is csrc/fps.cu's up to 4096 points (one warp with
// the smallest P up to 512, then P = 8 on up to 16 warps).  From 4097 to
// 8192 points it is P = 16 on up to 16 warps in a block of at most 20
// warps (so 4 or more consumers): at 20 warps a thread keeps 96 registers,
// and there each lane stores its distances before the argmax, so that d is
// dead before the reduction tree.  The producers' shape, the consumer
// warps and the ring's depth (16 slots, halved while the ring passes 128
// KB: 4 at 8192 points) follow from N and R alone.  One launch covers every
// radius; the rows of all radii lie side by side in one [B, npoint, sum
// S_k] buffer.
//
// Bit-exactness: the distance is csrc/fps_round.cuh's (__fsub_rn/__fmul_rn/
// __fadd_rn in the oracles' order); r2_k arrives already rounded to float32
// from the double-precision square of the radius.  The build also passes
// -fmad=false.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fps_round.cuh"

namespace {

constexpr int kMaxPoints = 8192;         // as csrc/fps.cu: P = 16 on 16 producer warps
constexpr int kMaxRadii = 8;
constexpr int kMaxDepth = 16;            // ring slots: 8 above 2048 points, 4 above 4096
constexpr int kRingBytes = 128 * 1024;
constexpr int kConsumersPerRadius = 4;
constexpr unsigned kSpinCycles = 1u << 31;  // a wait this long is a protocol fault

struct Balls {
  float r2[kMaxRadii];  // squared radii, float32
  int S[kMaxRadii];     // nsample per radius
  int off[kMaxRadii];   // column of radius k's rows in the output row
  int R;                // number of radii
  int S_total;          // sum of S
};

// The ring: `depth` slots (a power of two) of `row` floats each.
struct Ring {
  int row;        // floats of a slot: the producers' P * lanes, rounded up to 128
  int log_depth;  // log2 of the slots
};

// the most threads a launch takes, which sets the register cap (the warps
// share an SM's four sub-partitions: 16 warps leave a thread 128 registers,
// 20 leave 96, 24 leave 80): one producer warp, P = 8 on up to 16 warps
// beside at least 8 consumer warps, or P = 16 on up to 16 beside at least 4
template <int P, bool kOneWarp>
constexpr int max_threads() { return 32 * (kOneWarp ? 16 : P >= 16 ? 20 : 24); }

// ---- shared memory by 32-bit shared::cta addresses (see the kernel) --------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

// release: the caller's earlier shared-memory accesses are seen by a waiter
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// true once the phase of the given parity has completed; a warp that waits
// is suspended for up to a hardware time limit first
__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, unsigned parity) {
  unsigned done;
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
      "selp.u32 %0, 1, 0, p;\n\t}"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// acquire: wait until the phase of the given parity has completed; trap
// after kSpinCycles of waiting
__device__ __forceinline__ void mbar_wait(uint32_t bar, unsigned parity) {
  if (mbar_try_wait(bar, parity)) return;
  const unsigned t0 = clock();
  while (!mbar_try_wait(bar, parity)) {
    if (static_cast<unsigned>(clock()) - t0 > kSpinCycles) __trap();
  }
}

__device__ __forceinline__ float4 ld_shared_v4(uint32_t a) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(a));
  return v;
}

// The address of float f of a ring row: its 16-byte chunks are swizzled in
// groups of eight (chunk c sits at c ^ ((c >> 3) & 7)), so that a quarter
// warp's stores of P consecutive floats a lane and loads of L consecutive
// floats a lane each meet eight distinct bank groups.
__device__ __forceinline__ uint32_t ring_float(uint32_t row, int f) {
  const int c = f >> 2;
  return row + 16 * (c ^ ((c >> 3) & 7)) + 4 * (f & 3);
}

// ---- producers ----------------------------------------------------------------

// A lane's P distances into the row at shared address `row`, at float t*P.
template <int P>
__device__ __forceinline__ void store_distances(uint32_t row, const float (&d)[P], int t) {
  if constexpr (P == 1) {
    asm volatile("st.shared.f32 [%0], %1;" ::"r"(ring_float(row, t)), "f"(d[0]));
  } else if constexpr (P == 2) {
    asm volatile("st.shared.v2.f32 [%0], {%1, %2};" ::"r"(ring_float(row, 2 * t)), "f"(d[0]),
                 "f"(d[1]));
  } else {
#pragma unroll
    for (int q = 0; q < P; q += 4)
      asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};" ::"r"(ring_float(row, t * P + q)),
                   "f"(d[q]), "f"(d[q + 1]), "f"(d[q + 2]), "f"(d[q + 3]));
  }
}

// Before row r, the first of a half ring after the first lap: wait until
// every consumer warp is done with that half's rows of the lap before, i.e.
// the next row each will take (its word at `progress`, one per consumer
// warp, n_cons of them) lies past them.  Lane j reads warp j's word.
__device__ __forceinline__ void wait_half_free(uint32_t progress, int r, int n_cons,
                                               int log_depth) {
  const int depth = 1 << log_depth, half = depth >> 1;
  if (r < depth || (r & (half - 1)) != 0) return;
  const int last = r - depth + half - 1;  // the half's last row in the lap before
  const int lane = threadIdx.x & 31;
  const unsigned t0 = clock();
  while (true) {
    int next = last + 1;
    if (lane < n_cons)
      asm volatile("ld.acquire.cta.shared.b32 %0, [%1];" : "=r"(next) : "r"(progress + 4 * lane)
                   : "memory");
    if (__all_sync(0xffffffffu, next > last)) break;
    if (static_cast<unsigned>(clock()) - t0 > kSpinCycles) __trap();
  }
  __syncwarp();  // the acquire orders the whole warp's stores into the ring
}

// ring, full, progress: shared::cta addresses of the ring, its `full`
// barriers and the consumers' progress words
template <int P, bool kOneWarp>
__device__ __forceinline__ void produce(const float* __restrict__ pts, int* __restrict__ frow,
                                        uint32_t ring, uint32_t full, uint32_t progress,
                                        fps_round::Partials& sh, int N, int npoint, Ring rg,
                                        int n_prod, int n_cons) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int n_warps = kOneWarp ? 1 : n_prod >> 5;

  fps_round::Points<P> cloud;
  cloud.load(pts, N, tid);
  if (tid == 0) frow[0] = 0;
  float cx = pts[0], cy = pts[1], cz = pts[2];

  // at 16 points a lane on several warps, the row is stored before the
  // argmax, so that d is dead before the reduction tree (see the top)
  constexpr bool kStoreFirst = !kOneWarp && P >= 16;
  for (int r = 0; r < npoint; ++r) {
    // round r+1: the distance row of center r, then (r+1 < npoint) center r+1
    float d[P];
    cloud.update(cx, cy, cz, d);
    const int s = r & ((1 << rg.log_depth) - 1);  // the ring slot of row r
    const uint32_t slot = ring + 4 * s * rg.row;
    if (r + 1 < npoint) {
      if (kStoreFirst) {
        wait_half_free(progress, r, n_cons, rg.log_depth);
        store_distances<P>(slot, d, tid);
      }
      const fps_round::WarpMax m = cloud.warp_argmax();
      if (!kStoreFirst) {
        wait_half_free(progress, r, n_cons, rg.log_depth);
        store_distances<P>(slot, d, tid);
      }
      // with several warps, block_argmax's barrier orders the stores
      const int cur = cloud.block_argmax(m, r + 1, lane, tid >> 5, n_warps, sh, cx, cy, cz);
      if (tid == 0) frow[r + 1] = cur;
      if (kOneWarp) __syncwarp();
    } else {
      wait_half_free(progress, r, n_cons, rg.log_depth);
      store_distances<P>(slot, d, tid);
      if (kOneWarp) {
        __syncwarp();
      } else {
        fps_round::producer_sync(n_prod);
      }
    }
    // every producer's stores into the slot are ordered before this release
    if (tid == 0) mbar_arrive(full + 8 * s);
  }
}

// ---- consumers ----------------------------------------------------------------

// The hits among L floats of a distance row (shared address `row`) from
// float o on, a multiple of 4 (L a multiple of 4, at most 32): bit p is set
// when point o + p, below N, lies within the squared radius r2.  The
// ball-query compare is on the distance, never on mind.
__device__ __forceinline__ unsigned span_hits(uint32_t row, int o, int L, int N, float r2) {
  unsigned bits = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (4 * j >= L) break;
    const float4 v = ld_shared_v4(ring_float(row, o + 4 * j));
    bits |= ((v.x < r2 ? 1u : 0u) | (v.y < r2 ? 2u : 0u) | (v.z < r2 ? 4u : 0u) |
             (v.w < r2 ? 8u : 0u)) << (4 * j);
  }
  const int real = N - o;  // points of the span below N
  return real >= 32 ? bits : bits & ((1u << max(real, 0)) - 1u);
}

// One distance row -> the first S indices of its points within r2, in index
// order, padded with the first hit (zeros for an empty ball).  Lane l takes
// the L points from l*L on (L = min(ceil(N/32) rounded up to 4, 32)), 32*L
// points a pass.
__device__ __forceinline__ void compact_row(uint32_t row, int N, int L, float r2, int S,
                                            int* __restrict__ out, int lane) {
  const unsigned all = 0xffffffffu;
  const unsigned below = (1u << lane) - 1u;
  int cnt = 0;     // hits before this pass; the same in every lane
  int first = -1;  // the row's first hit
  for (int base = 0; base < N && cnt < S; base += 32 * L) {
    const int o = base + lane * L;  // this lane's first point
    unsigned bits = o < N ? span_hits(row, o, L, N, r2) : 0u;
    // exclusive prefix of n over the lanes from the ballots of its 6 bits
    const int n = __popc(bits);
    int before = 0, total = 0;
#pragma unroll
    for (int b = 0; b < 6; ++b) {
      const unsigned m = __ballot_sync(all, (n >> b) & 1);
      before += __popc(m & below) << b;
      total += __popc(m) << b;
    }
    if (first < 0) {
      const unsigned any = __ballot_sync(all, bits != 0u);
      if (any) {
        const int src = __ffs(any) - 1;
        first = base + src * L + __ffs(__shfl_sync(all, bits, src)) - 1;
      }
    }
    for (int rank = cnt + before; bits && rank < S; ++rank) {
      out[rank] = o + __ffs(bits) - 1;
      bits &= bits - 1u;
    }
    cnt += total;
  }
  const int pad = cnt > 0 ? first : 0;
  for (int q = min(cnt, S) + lane; q < S; q += 32) out[q] = pad;
}

// Consumer warp q of Q: the tasks q, q + Q, q + 2Q, ... (task t is row t / R
// and radius t % R) as the producers fill the rows; `progress` is its word.
__device__ __forceinline__ void consume(uint32_t ring, int* __restrict__ brows, uint32_t full,
                                       uint32_t progress, int N, int npoint, const Balls& balls,
                                       Ring rg, int q, int Q) {
  const int lane = threadIdx.x & 31;
  const int L = min(((N + 31) / 32 + 3) / 4 * 4, 32);
  const int R = balls.R;
  const int dr = Q / R, dk = Q % R;  // a step of Q tasks in rows and radii
  int r = q / R, k = q % R;          // the task's row and radius
  float r2 = 0.f;
  int S = 0, col = 0;
  // radius k's values, picked at constant indices: a parameter indexed at
  // run time compiles to a chain of predicated loads over the whole struct
  auto pick = [&] {
#pragma unroll
    for (int j = 0; j < kMaxRadii; ++j) {
      if (j == k) {
        r2 = balls.r2[j];
        S = balls.S[j];
        col = balls.off[j];
      }
    }
  };
  pick();
  while (r < npoint) {
    const int s = r & ((1 << rg.log_depth) - 1);
    mbar_wait(full + 8 * s, (r >> rg.log_depth) & 1);
    compact_row(ring + 4 * s * rg.row, N, L, r2, S, brows + (size_t)r * balls.S_total + col,
                lane);
    __syncwarp();  // the warp's reads of the slot are done
    r += dr;
    if (dk != 0) {  // the radius changes from task to task
      k += dk;
      if (k >= R) {
        k -= R;
        ++r;
      }
      pick();
    }
    if (lane == 0)  // release: those reads come before a producer's next write
      asm volatile("st.release.cta.shared.b32 [%0], %1;" ::"r"(progress), "r"(r) : "memory");
  }
}

// minBlocksPerSM = 1: without it ptxas spills to fit more blocks on an SM,
// which a kernel of one block per cloud does not need
template <int P, bool kOneWarp>
__global__ void __launch_bounds__(max_threads<P, kOneWarp>(), 1)
fps_bq_fused_kernel(const float* __restrict__ xyz, int* __restrict__ fps_out,
                    int* __restrict__ bq_out, int N, int npoint, Balls balls, Ring rg,
                    int n_prod, int Q) {
  extern __shared__ __align__(16) float smem[];  // [depth][rg.row] distance rows
  __shared__ uint64_t full_bars[kMaxDepth];
  __shared__ int next_rows[32];  // per consumer warp, the next row it will take
  __shared__ fps_round::Partials sh;

  // Through a shuffle, which ptxas cannot redo, the addresses stay in
  // registers; else it rebuilds them from %cgactaid at uses in the loops.
  const uint32_t ring = __shfl_sync(0xffffffffu, smem_addr(smem), 0);
  const uint32_t full = __shfl_sync(0xffffffffu, smem_addr(full_bars), 0);
  const uint32_t progress = __shfl_sync(0xffffffffu, smem_addr(next_rows), 0);
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < (1 << rg.log_depth); ++s) mbar_init(full + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int q = 0; q < 32; ++q) next_rows[q] = q / balls.R;  // warp q starts at task q
  }
  __syncthreads();  // the last block-wide barrier: the roles never meet again

  const float* pts = xyz + (size_t)blockIdx.x * N * 3;
  if (tid < n_prod) {
    produce<P, kOneWarp>(pts, fps_out + (size_t)blockIdx.x * npoint, ring, full, progress, sh,
                         N, npoint, rg, n_prod, Q);
  } else {
    // Warp w issues on SM sub-partition w % 4.  A one-warp producer keeps
    // its own: the warps there stay idle, as a consumer beside the producer
    // takes issue slots from the round (PERF.md, section 6).  Several
    // producer warps spread over all four, which beat packing them on fewer.
    const int w = tid >> 5;
    if (kOneWarp && w % 4 == 0) return;
    const int q = kOneWarp ? w - 1 - w / 4 : (tid - n_prod) >> 5;  // consumer warp q
    consume(ring, bq_out + (size_t)blockIdx.x * npoint * balls.S_total, full, progress + 4 * q,
            N, npoint, balls, rg, q, Q);
  }
}

template <int P, bool kOneWarp>
cudaError_t launch(const float* xyz, int* fps_out, int* bq_out, int B, int N, int npoint,
                   const Balls& balls, int n_prod, cudaStream_t stream) {
  // Q consumer warps, up to kConsumersPerRadius per radius within the block
  // (with one producer warp, every fourth warp is idle: see the kernel)
  constexpr int kMaxThreads = max_threads<P, kOneWarp>();
  const int room = (kMaxThreads - n_prod) / 32;
  const int Q = min(kConsumersPerRadius * balls.R, kOneWarp ? room * 3 / 4 : room);
  const int threads = n_prod + 32 * (Q + (kOneWarp ? (Q - 1) / 3 : 0));
  if (Q < 1 || threads > kMaxThreads) return cudaErrorInvalidValue;
  Ring rg;
  rg.row = (n_prod * P + 127) / 128 * 128;
  rg.log_depth = 4;  // 16 slots, halved while that passes kRingBytes
  while (rg.log_depth > 2 && ((size_t)rg.row * 4 << rg.log_depth) > kRingBytes) --rg.log_depth;
  const size_t smem = ((size_t)rg.row << rg.log_depth) * 4;
  if (smem > 32 * 1024) {  // past the default 48 KB with the static part
    const cudaError_t e = cudaFuncSetAttribute(fps_bq_fused_kernel<P, kOneWarp>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)smem);
    if (e != cudaSuccess) return e;
  }
  fps_bq_fused_kernel<P, kOneWarp><<<B, threads, smem, stream>>>(
      xyz, fps_out, bq_out, N, npoint, balls, rg, n_prod, Q);
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
  if (N <= 0 || N > kMaxPoints || R <= 0 || R > kMaxRadii) return (int)cudaErrorInvalidValue;
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
  // producers as csrc/fps.cu: one warp with the smallest P that holds the
  // cloud up to 512 points, P = 8 up to 4096, else P = 16 (see the top)
  const bool one = N <= 512;
  int P = N <= 4096 ? 8 : 16;
  if (one) {
    P = 16;
    while (P > 1 && (P / 2) * 32 >= N) P /= 2;
  }
  const int n_prod = ((N + P - 1) / P + 31) / 32 * 32;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (P) {
    case 1: e = launch<1, true>(xyz, fps_out, bq_out, B, N, npoint, balls, n_prod, s); break;
    case 2: e = launch<2, true>(xyz, fps_out, bq_out, B, N, npoint, balls, n_prod, s); break;
    case 4: e = launch<4, true>(xyz, fps_out, bq_out, B, N, npoint, balls, n_prod, s); break;
    case 8:
      e = one ? launch<8, true>(xyz, fps_out, bq_out, B, N, npoint, balls, n_prod, s)
              : launch<8, false>(xyz, fps_out, bq_out, B, N, npoint, balls, n_prod, s);
      break;
    case 16:
      e = one ? launch<16, true>(xyz, fps_out, bq_out, B, N, npoint, balls, n_prod, s)
              : launch<16, false>(xyz, fps_out, bq_out, B, N, npoint, balls, n_prod, s);
      break;
    default: e = cudaErrorInvalidValue;
  }
  return (int)e;
}
