// One grouped set-abstraction stage of the PointNet++ encoder in eval mode,
// one radius a launch, for Hopper (sm_90a): models/pointnet2.py::
// PointnetSAModuleMSG.forward over models/layers.py::SharedMLP, as the frozen
// Heun and energy programs (and every other no-grad, eval-mode pass) run it.
//
// Replaces no TPU kernel: the JAX package leaves the SharedMLP to XLA.  In
// PyTorch the same radius is a gather, a concatenation, then per layer a
// cuBLAS SGEMM, a BatchNorm pass and a ReLU, then the max-pool: each writes a
// [B, npoint, nsample, C] float32 tensor to device memory for the next to
// read.  Here only the pooled [B, npoint, C_out] result leaves the chip.
//
// What it computes, for each group (center) g of the stage and each of its
// NS neighbour rows r (point j = gidx[g, r] of the cloud):
//   x0 = [grouped_xyz[g, r] ; features[b, j]]                   [3 + C]
//   x_{l+1} = relu(bn_l(x_l W_l^T)),  l = 0, 1, 2               (no bias)
//   out[g, col0 + c] = max over r of x_3[c]
// with bn_l the eval-mode affine of the running statistics in the order of
// PyTorch's channels-last BatchNorm kernel, gamma (x - mean) times
// 1 / sqrt(var + eps) (correctly rounded), then + beta, each step rounded.
// Every product is an explicit __fmaf_rn summed in k order (the build passes
// -fmad=false): the same float32 operations as the plain chain in another
// order of summation.
//
// What bounds it on this card: float32 operations on the CUDA cores (the
// light stages 0-2 hold 1.0 G multiply-adds a cloud; TF32 and bf16 are
// excluded by the encoder's float32 contract), so the kernel is a SIMT SGEMM
// chain over rows that never leave shared memory.
//
// Two launches.  sa_stage_prep lays each layer's weight out transposed and
// zero-padded, W^T [Kp][Np] (Kp a multiple of the 8-deep K slice, Np of the
// column threads), and the eval-mode BatchNorm affine [4][Np] (mean,
// 1 / sqrt(var + eps), gamma, beta; zeros past N) in a scratch buffer, so
// that every K slice of the stage is one contiguous run.  sa_stage_kernel
// then runs the stage.  A block owns G whole groups, R = G x NS rows, and
// THREADS threads: R / 8 row threads by CT = THREADS / (R / 8) column
// threads, a warp being 4 row lanes by 8 column lanes (32-row warp tiles).
// A thread holds 8 consecutive rows by TN = Np / CT columns of a layer's
// output in registers; its columns are interleaved across the warp's 8
// column lanes (float4 blocks 32 apart, then a float2 and a float block) so
// that each weight load of the warp reads one contiguous run.  The layer
// input lives in shared memory transposed, [k][row]: a lane reads its 8 rows
// of one k as two broadcast float4.  Layer 0's input is gathered once,
// straight from grouped_xyz and the previous stage's features (lanes over
// rows, so each k's row of the transposed tile is written without bank
// conflicts), while the first weight slices land; layer outputs ping-pong
// between two buffers.  The weight slices of all three layers stream in one
// sequence through a ring of STAGES slots by TMA bulk copies, each slot with
// a "full" mbarrier (the copy's bytes) and an "empty" one (one arrival per
// warp once its products of the slice are issued); thread 0 refills a slot
// with the slice STAGES later as soon as every warp has released it, so
// warps never wait for one another inside a layer, only at its end (its
// output is the next layer's input).  Narrow K (3, 99, 259) and odd widths
// (196) are padded with zeros: zero weight rows add exact zeros, and padded
// output columns stay zero through the zero affine, so they feed the next
// layer nothing.  The last layer's epilogue takes the max over the thread's
// 8 rows, then over the row lanes of its group by shuffles, and writes the
// group's columns into this radius' slice of the stage's concatenated
// output.
//
// Deterministic: no atomics; each output has one summation order and the
// max is exact, so a call gives the same bits every time, eager or captured.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kKS = 8;       // K depth of one weight slice
constexpr int kPrepThreads = 256;

__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }
__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }

struct Params {
  const float* gxyz;    // [groups * NS, 3]  grouped_xyz of the radius
  const float* feat;    // [B, P, C]         the previous stage's features (C > 0)
  const int* gidx;      // [groups * NS]     neighbour indices within the cloud
  const float* scratch; // W_l^T padded and the BatchNorm affines (sa_stage_prep)
  float* out;           // [groups, ld_out]; this radius' columns start at col0
  int ld_out, col0, npoint, points;
};

// The compile-time shape of one instantiation: NS rows a group, G groups a
// block, C input features, widths N0, N1, N2, THREADS threads a block,
// PAD floats of padding on each row of the transposed tiles and STAGES
// slices in the ring.
template <int NS_, int G_, int C_, int N0_, int N1_, int N2_, int THREADS_, int PAD,
          int STAGES_>
struct Shape {
  static constexpr int NS = NS_, G = G_, C = C_, THREADS = THREADS_, STAGES = STAGES_;
  static constexpr int R = G * NS;             // rows a block
  static constexpr int RT = R / 8;             // row threads
  static constexpr int CT = THREADS / RT;      // column threads
  static constexpr int WR = RT / 4;            // warps along the rows
  static constexpr int S = R + PAD;            // row stride of the transposed tiles
  static constexpr int K0 = 3 + C;
  static constexpr int N0 = N0_, N1 = N1_, N2 = N2_;
  static constexpr int Kp0 = round_up(K0, kKS), Kp1 = round_up(N0, kKS),
                       Kp2 = round_up(N1, kKS);
  static constexpr int Np0 = round_up(N0, CT), Np1 = round_up(N1, CT), Np2 = round_up(N2, CT);
  static constexpr int NpMax = cmax(Np0, cmax(Np1, Np2));
  // global slice index of each layer's first slice
  static constexpr int Base1 = Kp0 / kKS, Base2 = Base1 + Kp1 / kKS, Slices = Base2 + Kp2 / kKS;
  // scratch: W_l^T, then the affines
  static constexpr int Wt1 = Kp0 * Np0, Wt2 = Wt1 + Kp1 * Np1, Aff0 = Wt2 + Kp2 * Np2,
                       Aff1 = Aff0 + 4 * Np0, Aff2 = Aff1 + 4 * Np1,
                       ScratchFloats = Aff2 + 4 * Np2;
  static constexpr int ARows = cmax(Kp0, Np1);  // the input, then layer 1's output
  static constexpr int BRows = Np0;             // layer 0's output
  static constexpr int Ring = kKS * NpMax;      // floats of one ring slot
  static constexpr int SmemFloats = (ARows + BRows) * S + STAGES * Ring;
  static constexpr int SmemBytes = SmemFloats * 4 + 2 * STAGES * 8;
  static_assert(R % 32 == 0 && (NS == 16 || NS == 32), "rows");
  static_assert(RT % 4 == 0 && THREADS % RT == 0 && CT % 8 == 0, "thread grid");
  static_assert(PAD % 4 == 0, "16-byte rows");
  static_assert(C % 8 == 0, "features in 8-channel chunks");
  static_assert(Kp1 <= Np0 && Kp2 <= Np1, "padded K within the previous output");
  static_assert(Slices >= STAGES, "ring");
  static_assert(SmemBytes <= 232448, "shared memory of one block");
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// TMA bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned)
// from global memory into this block's shared memory, counted on `bar`.
__device__ __forceinline__ void bulk_load(float* dst, const float* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Global slice g of the stage's three layers into ring slot g % STAGES:
// rows 8 s .. 8 s + 7 of the layer's W^T, contiguous in the scratch.
template <class Sh>
__device__ __forceinline__ void issue_slice(const Params& p, float* ring, uint64_t* full, int g) {
  const int l = g < Sh::Base1 ? 0 : (g < Sh::Base2 ? 1 : 2);
  const int s = g - (l == 0 ? 0 : (l == 1 ? Sh::Base1 : Sh::Base2));
  const int np = l == 0 ? Sh::Np0 : (l == 1 ? Sh::Np1 : Sh::Np2);
  const int wt = l == 0 ? 0 : (l == 1 ? Sh::Wt1 : Sh::Wt2);
  const unsigned bytes = kKS * np * sizeof(float);
  uint64_t* bar = full + g % Sh::STAGES;
  mbar_expect_tx(bar, bytes);
  bulk_load(ring + (g % Sh::STAGES) * Sh::Ring, p.scratch + wt + s * kKS * np, bytes, bar);
}

// Column of a thread's j-th output column within its warp's block of 8 TN
// columns (cb the block's first): float4 blocks 32 apart, then a float2
// block of 16, then a float block of 8, each over the 8 column lanes.
template <int TN>
__device__ __forceinline__ int col_of(int cb, int j, int lc) {
  constexpr int Q = TN / 4, H = (TN % 4) / 2;
  if (j < 4 * Q) return cb + 32 * (j / 4) + 4 * lc + (j % 4);
  if (H && j < 4 * Q + 2) return cb + 32 * Q + 2 * lc + (j - 4 * Q);
  return cb + 32 * Q + 16 * H + lc;
}

// One k of a slice: the thread's 8 rows of the transposed input (two
// broadcast float4) and its TN columns of the weight slice.
template <int TN, int NP, int S>
__device__ __forceinline__ void load_frag(float (&a)[8], float (&b)[TN], const float* in,
                                          const float* ws, int kk, int r0, int cb, int lc) {
  const float4 a0 = *reinterpret_cast<const float4*>(in + kk * S + r0);
  const float4 a1 = *reinterpret_cast<const float4*>(in + kk * S + r0 + 4);
  a[0] = a0.x; a[1] = a0.y; a[2] = a0.z; a[3] = a0.w;
  a[4] = a1.x; a[5] = a1.y; a[6] = a1.z; a[7] = a1.w;
  constexpr int Q = TN / 4, H = (TN % 4) / 2, F = TN % 2;
  const float* wr = ws + kk * NP + cb;
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const float4 v = *reinterpret_cast<const float4*>(wr + 32 * q + 4 * lc);
    b[4 * q] = v.x; b[4 * q + 1] = v.y; b[4 * q + 2] = v.z; b[4 * q + 3] = v.w;
  }
  if constexpr (H) {
    const float2 v = *reinterpret_cast<const float2*>(wr + 32 * Q + 2 * lc);
    b[4 * Q] = v.x; b[4 * Q + 1] = v.y;
  }
  if constexpr (F) b[TN - 1] = wr[32 * Q + 16 * H + lc];
}

// acc[i][j] += sum over the slice's 8 k of in[k][r0 + i] * ws[k][col j],
// k in order; the next k's fragments load while this k's products issue.
template <int TN, int NP, int S>
__device__ __forceinline__ void mma_slice(float (&acc)[8][TN], const float* in, const float* ws,
                                          int r0, int cb, int lc) {
  float a[2][8], b[2][TN];
  load_frag<TN, NP, S>(a[0], b[0], in, ws, 0, r0, cb, lc);
#pragma unroll
  for (int kk = 0; kk < kKS; ++kk) {
    if (kk + 1 < kKS)
      load_frag<TN, NP, S>(a[(kk + 1) & 1], b[(kk + 1) & 1], in, ws, kk + 1, r0, cb, lc);
#pragma unroll
    for (int j = 0; j < TN; ++j)
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[i][j] = __fmaf_rn(a[kk & 1][i], b[kk & 1][j], acc[i][j]);
  }
}

__device__ __forceinline__ float bn_relu(float x, float4 f) {  // f: mean, inv, gamma, beta
  return fmaxf(__fadd_rn(__fmul_rn(__fmul_rn(f.z, __fsub_rn(x, f.x)), f.y), f.w), 0.0f);
}

template <int NP>
__device__ __forceinline__ float4 affine(const float* aff, int c) {
  return make_float4(__ldg(aff + c), __ldg(aff + NP + c), __ldg(aff + 2 * NP + c),
                     __ldg(aff + 3 * NP + c));
}

// Per-thread coordinates of the block's thread grid.
struct Lane {
  int t, lr, lc, r0, wc;
};

struct Ring {
  float* slots;
  uint64_t* full;   // a slice has landed (TMA bytes)
  uint64_t* empty;  // every warp has read a slice
};

// Layer L (global slices Base .. Base + KP / 8 - 1): products from `in`
// (transposed, KP rows) and the ring.  As each slice is released, thread 0
// refills its slot with the slice STAGES later, once every warp has read
// it.  Hidden layers write relu(bn(.)) transposed into `out`; the last
// max-pools.
template <class Sh, int L, int Base, int KP, int N, int NP>
__device__ __forceinline__ void run_layer(const Params& p, const float* in, float* out,
                                          const Ring& ring, const Lane& ln) {
  constexpr int TN = NP / Sh::CT;
  constexpr int nslices = KP / kKS;
  const int cb = ln.wc * 8 * TN;
  float acc[8][TN];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;
  for (int s = 0; s < nslices; ++s) {
    const int g = Base + s, st = g % Sh::STAGES;
    mbar_wait(&ring.full[st], (g / Sh::STAGES) & 1);
    mma_slice<TN, NP, Sh::S>(acc, in + s * kKS * Sh::S, ring.slots + st * Sh::Ring, ln.r0, cb,
                             ln.lc);
    __syncwarp();
    if ((ln.t & 31) == 0) mbar_arrive(&ring.empty[st]);
    if (ln.t == 0 && g + Sh::STAGES < Sh::Slices) {
      mbar_wait(&ring.empty[st], (g / Sh::STAGES) & 1);
      issue_slice<Sh>(p, ring.slots, ring.full, g + Sh::STAGES);
    }
  }

  const float* aff = p.scratch + (L == 0 ? Sh::Aff0 : (L == 1 ? Sh::Aff1 : Sh::Aff2));
  if constexpr (L < 2) {  // hidden layer: relu(bn(.)) of the thread's rows, transposed
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = col_of<TN>(cb, j, ln.lc);
      const float4 f = affine<NP>(aff, c);
      float h[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) h[i] = bn_relu(acc[i][j], f);
      *reinterpret_cast<float4*>(out + c * Sh::S + ln.r0) = make_float4(h[0], h[1], h[2], h[3]);
      *reinterpret_cast<float4*>(out + c * Sh::S + ln.r0 + 4) =
          make_float4(h[4], h[5], h[6], h[7]);
    }
    __syncthreads();  // the next layer reads `out`
  } else {  // last layer: the max over the group's rows
    const int group = blockIdx.x * Sh::G + ln.r0 / Sh::NS;
    float* orow = p.out + static_cast<size_t>(group) * p.ld_out + p.col0;
    const bool writer = Sh::NS == 32 ? ln.lr == 0 : (ln.lr & 1) == 0;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = col_of<TN>(cb, j, ln.lc);
      const float4 f = affine<NP>(aff, c);
      float v = bn_relu(acc[0][j], f);
#pragma unroll
      for (int i = 1; i < 8; ++i) v = fmaxf(v, bn_relu(acc[i][j], f));
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
      if constexpr (Sh::NS == 32) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
      if (writer && c < N) orow[c] = v;
    }
  }
}

template <class Sh>
__global__ void __launch_bounds__(Sh::THREADS, 65536 / (128 * Sh::THREADS))
    sa_stage_kernel(Params p) {  // at most 128 registers a thread
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  constexpr int S = Sh::S, R = Sh::R, THREADS = Sh::THREADS;
  float* bufA = smem;                      // [ARows][S]: the input, then layer 1's output
  float* bufB = bufA + Sh::ARows * S;      // [BRows][S]: layer 0's output
  Ring ring;
  ring.slots = bufB + Sh::BRows * S;       // [STAGES][Ring]
  ring.full = reinterpret_cast<uint64_t*>(ring.slots + Sh::STAGES * Sh::Ring);
  ring.empty = ring.full + Sh::STAGES;
  Lane ln;
  ln.t = threadIdx.x;
  const int warp = ln.t >> 5, lane = ln.t & 31;
  ln.lr = lane & 3;
  ln.lc = lane >> 2;
  ln.r0 = 32 * (warp % Sh::WR) + 8 * ln.lr;
  ln.wc = warp / Sh::WR;
  const int row0 = blockIdx.x * R;

  if (ln.t == 0) {
    for (int s = 0; s < Sh::STAGES; ++s) {
      mbar_init(&ring.full[s], 1);
      mbar_init(&ring.empty[s], THREADS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int g = 0; g < Sh::STAGES; ++g) issue_slice<Sh>(p, ring.slots, ring.full, g);
  }

  // the input, transposed, while the first slices land: dxyz, then the
  // neighbours' features, then zeros
  for (int e = ln.t; e < 3 * R; e += THREADS) {
    const int d = e / R, r = e % R;
    bufA[d * S + r] = __ldg(p.gxyz + static_cast<size_t>(row0 + r) * 3 + d);
  }
  if constexpr (Sh::C > 0) {
    constexpr int chunks = Sh::C / 8;  // 8 channels = one 32-byte sector a row
    const int per_cloud = p.npoint * Sh::NS;
#pragma unroll 4
    for (int e = ln.t; e < chunks * R; e += THREADS) {
      const int r = e % R, q = e / R;
      const int row = row0 + r;
      const int b = row / per_cloud;
      const float* src = p.feat +
                         (static_cast<size_t>(b) * p.points + __ldg(p.gidx + row)) * Sh::C + 8 * q;
      const float4 v0 = __ldg(reinterpret_cast<const float4*>(src));
      const float4 v1 = __ldg(reinterpret_cast<const float4*>(src + 4));
      float* dst = bufA + (3 + 8 * q) * S + r;
      dst[0] = v0.x; dst[S] = v0.y; dst[2 * S] = v0.z; dst[3 * S] = v0.w;
      dst[4 * S] = v1.x; dst[5 * S] = v1.y; dst[6 * S] = v1.z; dst[7 * S] = v1.w;
    }
  }
  for (int e = ln.t; e < (Sh::Kp0 - Sh::K0) * R; e += THREADS)
    bufA[(Sh::K0 + e / R) * S + e % R] = 0.0f;
  __syncthreads();  // the input and the barriers' initialisation

  run_layer<Sh, 0, 0, Sh::Kp0, Sh::N0, Sh::Np0>(p, bufA, bufB, ring, ln);
  run_layer<Sh, 1, Sh::Base1, Sh::Kp1, Sh::N1, Sh::Np1>(p, bufB, bufA, ring, ln);
  run_layer<Sh, 2, Sh::Base2, Sh::Kp2, Sh::N2, Sh::Np2>(p, bufA, nullptr, ring, ln);
}

struct Weights {
  const float* w[3];    // dense_l.weight [N_l, K_l]
  const float* bn[12];  // per layer: running mean, running var, gamma, beta
  float eps;
};

// The scratch of an instantiation: W_l^T zero-padded to [Kp_l][Np_l], then
// per layer the affine [4][Np_l] of eval-mode BatchNorm, zeros past N_l (so
// a padded column stays zero through bn and relu).
template <class Sh>
__global__ void __launch_bounds__(kPrepThreads) sa_stage_prep(Weights w, float* scratch) {
  const int i = blockIdx.x * kPrepThreads + threadIdx.x;
  if (i >= Sh::ScratchFloats) return;
  float v = 0.0f;
  if (i < Sh::Aff0) {
    const int l = i < Sh::Wt1 ? 0 : (i < Sh::Wt2 ? 1 : 2);
    const int off = i - (l == 0 ? 0 : (l == 1 ? Sh::Wt1 : Sh::Wt2));
    const int np = l == 0 ? Sh::Np0 : (l == 1 ? Sh::Np1 : Sh::Np2);
    const int K = l == 0 ? Sh::K0 : (l == 1 ? Sh::N0 : Sh::N1);
    const int N = l == 0 ? Sh::N0 : (l == 1 ? Sh::N1 : Sh::N2);
    const int k = off / np, n = off % np;
    if (k < K && n < N) v = __ldg(w.w[l] + n * K + k);
  } else {
    const int l = i < Sh::Aff1 ? 0 : (i < Sh::Aff2 ? 1 : 2);
    const int off = i - (l == 0 ? Sh::Aff0 : (l == 1 ? Sh::Aff1 : Sh::Aff2));
    const int np = l == 0 ? Sh::Np0 : (l == 1 ? Sh::Np1 : Sh::Np2);
    const int N = l == 0 ? Sh::N0 : (l == 1 ? Sh::N1 : Sh::N2);
    const int q = off / np, c = off % np;
    if (c < N) {
      const float* const* bn = w.bn + 4 * l;
      v = q == 1 ? __frcp_rn(__fsqrt_rn(__fadd_rn(__ldg(bn[1] + c), w.eps))) : __ldg(bn[q] + c);
    }
  }
  scratch[i] = v;
}

template <class Sh>
int launch(const Weights& w, Params p, float* scratch, int groups, cudaStream_t stream) {
  if (groups % Sh::G != 0) return (int)cudaErrorInvalidValue;
  sa_stage_prep<Sh><<<(Sh::ScratchFloats + kPrepThreads - 1) / kPrepThreads, kPrepThreads, 0,
                      stream>>>(w, scratch);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  p.scratch = scratch;
  err = cudaFuncSetAttribute(sa_stage_kernel<Sh>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Sh::SmemBytes);
  if (err != cudaSuccess) return (int)err;
  sa_stage_kernel<Sh><<<groups / Sh::G, Sh::THREADS, Sh::SmemBytes, stream>>>(p);
  return (int)cudaGetLastError();
}

// The instantiations: the light stages 0-2, one radius each (also full's
// stages 0-2, dense's stage 1 and Pointnet2MSG's stages 0-2).
using S0R0 = Shape<16, 16, 0, 16, 16, 32, 256, 4, 4>;
using S0R1 = Shape<32, 8, 0, 32, 32, 64, 256, 4, 4>;
using S1R0 = Shape<16, 8, 96, 64, 64, 128, 256, 4, 4>;
using S1R1 = Shape<32, 4, 96, 64, 96, 128, 256, 4, 4>;
// Stage 2: 128 rows and 16 warps a block in 225 KB (unpadded rows, a
// three-slice ring), 4-7% faster than 64 rows and 8 warps.
using S2R0 = Shape<16, 8, 256, 128, 196, 256, 512, 0, 3>;
using S2R1 = Shape<32, 4, 256, 128, 196, 256, 512, 0, 3>;

template <class Sh>
bool is(int ns, int c, int n0, int n1, int n2) {
  return ns == Sh::NS && c == Sh::C && n0 == Sh::N0 && n1 == Sh::N1 && n2 == Sh::N2;
}

// f(Sh{}) for the instantiation Sh of the shape; -1 when there is none.
template <class F>
int dispatch(int ns, int c, int n0, int n1, int n2, F&& f) {
  if (is<S0R0>(ns, c, n0, n1, n2)) return f(S0R0{});
  if (is<S0R1>(ns, c, n0, n1, n2)) return f(S0R1{});
  if (is<S1R0>(ns, c, n0, n1, n2)) return f(S1R0{});
  if (is<S1R1>(ns, c, n0, n1, n2)) return f(S1R1{});
  if (is<S2R0>(ns, c, n0, n1, n2)) return f(S2R0{});
  if (is<S2R1>(ns, c, n0, n1, n2)) return f(S2R1{});
  return -1;
}

}  // namespace

// Floats of scratch one radius of this shape needs (see sa_stage_prep), or
// -1 for a shape without an instantiation.
extern "C" int gp_sa_stage_scratch(int ns, int c, int n0, int n1, int n2) {
  return dispatch(ns, c, n0, n1, n2, [](auto sh) { return decltype(sh)::ScratchFloats; });
}

// One radius of a grouped SA stage: grouped_xyz [groups * ns, 3], features
// [B, points, c] (null when c = 0), gidx [groups * ns] int32, w[3] the dense
// weights [n_l, k_l], bn[12] the running mean, running var, weight and bias
// of each layer, scratch of gp_sa_stage_scratch floats (16-byte aligned),
// out [groups, ld_out] written at columns col0 .. col0 + n2 - 1.  Launches
// the prep kernel, then the stage, on `stream`; returns
// cudaErrorInvalidValue for a shape without an instantiation, else the
// launches' CUDA status.
extern "C" int gp_sa_stage(const float* gxyz, const float* feat, const int* gidx,
                           const float* const* w, const float* const* bn, float eps,
                           float* scratch, float* out, int ld_out, int col0, int groups,
                           int npoint, int points, int ns, int c, int n0, int n1, int n2,
                           void* stream) {
  if (groups <= 0 || npoint <= 0 || (c > 0 && (feat == nullptr || points <= 0)))
    return (int)cudaErrorInvalidValue;
  Weights wts{{w[0], w[1], w[2]}, {}, eps};
  for (int i = 0; i < 12; ++i) wts.bn[i] = bn[i];
  Params p{gxyz, feat, gidx, nullptr, out, ld_out, col0, npoint, points};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int st = dispatch(ns, c, n0, n1, n2, [&](auto sh) {
    return launch<decltype(sh)>(wts, p, scratch, groups, s);
  });
  return st < 0 ? (int)cudaErrorInvalidValue : st;
}
