// One score evaluation of the float32 fused-tail score head, for Hopper
// (sm_90a): models/scorenet.py::PoseScoreNet.score_from over a FusedTails
// bank with a step-shared time t, as the PF-ODE, PC and RK45 samplers call
// it 2-6 times a step.
//
// Replaces no TPU kernel: the JAX package leaves the head to XLA, which
// fuses its elementwise work into the matmuls.  In PyTorch the same
// evaluation is ~30 launches (cuBLAS GEMMs of K = 9 and 256, broadcast adds,
// ReLUs, the banked einsum's permute copies, the division), each writing a
// [n, 768] or [n, 256] intermediate to device memory for the next to read.
// Here every intermediate stays on the chip.
//
// What it computes, per row m of x [n, D]:
//   h0 = relu(x W0^T + b0)                                  [256]
//   h1 = relu(h0 W1^T + b1)                                 [256]
//   g  = relu((fp[m] + trow, plus h1 PK summed in k order) + bias)   [T*H]
//   out[m, k*O + o] = (sum_h g[k*H + h] OK[k, h, o] + ob[k, o]) / (std + 1e-7)
// where trow = relu(t_dense(fourier(t))) TK is the t row, shared by every
// row.  The same float32 operations as the plain arithmetic, in another
// order of summation (each sum in one fixed order).
//
// What bounds it on this card: float32 operations on the CUDA cores.  At
// the evaluation shape (n = 12,800 = 256 clouds x 50 hypotheses, D = 9,
// T*H = 768, O = 3) a call is 3.4 G multiply-adds, 0.102 ms at 67 TFLOP/s,
// against 0.012 ms to read fp once from device memory.  TF32 and bf16 are
// excluded by the head's float32 contract, so the kernel is a SIMT SGEMM
// chain: every product is an explicit __fmaf_rn (the build passes
// -fmad=false, and a multiply and an add would be two instructions).
//
// Two launches.  score_head_prep computes the t row and lays W0 (padded to
// 16 inputs) and W1 out transposed, [k][n], in a scratch buffer, so that
// every K slice of the head is rows of one [k][n] matrix.  score_head_kernel
// then runs the head, one block an SM.  Consumer warps own 8 rows each, and
// lane l the 8 x 8 register tile of those rows and 8 columns of a
// 256-column chunk (columns 4 l + j % 4 + 128 (j / 4)); where the rows an
// SM gets are not a multiple of 8 (12,800 over 132 SMs: 96 or 97), one
// more, short warp owns the last 1-2, so every SM sub-partition runs three
// 8-row warps rather than one running four.  The block walks one pipeline
// of 16-deep K slices: layer 0 (one slice: A = x^T, B = W0^T), layer 2
// (A = h0^T, B = W1^T), then each 256-column chunk of the tails (B = PK).
// Activations live in shared memory transposed ([256][rows + 4]: a lane
// reads its rows' entries of one k as broadcast vectors), and each warp
// writes h0, then h1 over it, for its own rows only, so consumer warps
// never wait for one another.  A producer warp streams the B slices from L2
// into a four-stage ring with TMA bulk copies, each stage with a "full"
// mbarrier (the copy's bytes) and an "empty" one (one arrival per consumer
// warp, made as soon as its products of the slice are issued); the t row,
// the bias and out_kernel arrive once the same way.  A tail chunk's sums
// start from fp + trow (loaded at the chunk's start, one round trip; the
// next chunk's fp rows are prefetched into L2); its epilogue adds the bias,
// applies the ReLU and contracts the lane's 8 columns with out_kernel into
// per-row partial sums, which a reduce-scatter over the warp's lanes
// completes; a per-warp shared buffer carries a tail's sums across its
// chunks (H = 512).  Where n does not spread that way (small n), blocks of
// ceil(n / (8 SMs)) 8-row warps (4 to 14).
//
// Deterministic: no atomics; each output is summed in one fixed order, so
// an evaluation gives the same bits every time, eager or captured.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kWidth = 256;                 // pose MLP width: K of layer 2 and the tails
constexpr int kTDim = 128;                  // t embedding width
constexpr int kChunk = 256;                 // columns of one chunk: 32 lanes x 8
constexpr int kBK = 16;                     // K of one pipeline slice; layer 0's padded K
constexpr int kSlicesPerChunk = kWidth / kBK;
constexpr int kSliceFloats = kBK * kChunk;  // one stage of the ring: 16 KB
constexpr int kStages = 4;
constexpr int kMinWarps = 4;
constexpr int kMaxWarps = 14;               // consumer warps; + the producer = 480 threads
constexpr int kMaxPose = kBK;
constexpr int kMaxOut = 16;
constexpr int kSmallRows = 2;               // rows of the block's last, short warp
constexpr int kPrepThreads = 256;
constexpr int kTileRows = 16;               // W1 rows a prep block transposes
constexpr int kW0tFloats = kBK * kWidth;    // scratch: W0^T padded, W1^T, then the t row
constexpr int kW1tFloats = kWidth * kWidth;
constexpr int kMaxSmem = 232448;            // bytes of shared memory a block may use

struct Head {
  const float* x;      // [n, D]
  const float* w0t;    // [16, 256]  pose_dense_0.weight^T, rows D.. zero
  const float* b0;     // [256]
  const float* w1t;    // [256, 256] pose_dense_1.weight^T
  const float* b1;     // [256]
  const float* fp;     // [n, NT]  the pts_feat projection, one row per x row
  const float* trow;   // [NT]     the t row
  const float* pk;     // [256, NT] pose_kernel
  const float* bias;   // [NT]
  const float* ok;     // [T, H, O] out_kernel
  const float* ob;     // [T, O]    out_bias
  const float* std_;   // [1]      sigma(t)
  float* out;          // [n, T*O]
  int n, D, NT, H, O;
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

__device__ __forceinline__ void prefetch_l2(const float* p) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
}

__device__ __forceinline__ float relu(float v) { return fmaxf(v, 0.0f); }

// The lane's column j of a 256-column chunk.
__device__ __forceinline__ int lane_col(int lane, int j) { return 4 * lane + (j & 3) + 128 * (j >> 2); }

// One k of a slice: the warp's kRows rows of the transposed activations
// (broadcast loads) and the lane's 8 columns of the B slice (two float4).
template <int kRows>
__device__ __forceinline__ void load_frag(float (&av)[kRows], float (&bv)[8], const float* a,
                                          int ldh, const float* b, int lane, int kk) {
  if constexpr (kRows == 8) {
    const float4 a0 = *reinterpret_cast<const float4*>(a + kk * ldh);
    const float4 a1 = *reinterpret_cast<const float4*>(a + kk * ldh + 4);
    const float v[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
    for (int i = 0; i < kRows; ++i) av[i] = v[i];
  } else {
    const float2 a0 = *reinterpret_cast<const float2*>(a + kk * ldh);
    const float v[2] = {a0.x, a0.y};
#pragma unroll
    for (int i = 0; i < kRows; ++i) av[i] = v[i];
  }
  const float4 b0 = *reinterpret_cast<const float4*>(b + kk * kChunk + 4 * lane);
  const float4 b1 = *reinterpret_cast<const float4*>(b + kk * kChunk + 128 + 4 * lane);
  bv[0] = b0.x; bv[1] = b0.y; bv[2] = b0.z; bv[3] = b0.w;
  bv[4] = b1.x; bv[5] = b1.y; bv[6] = b1.z; bv[7] = b1.w;
}

// acc[i][j] += sum over the slice's kBK k of a[k][i] * b[k][j], k in
// order; the next k's fragments load while this k's products issue.
// Unrolled 8 deep, not 16: the smaller loop body ran 5% faster (fewer
// instruction fetch stalls).
template <int kRows>
__device__ __forceinline__ void mma_slice(float (&acc)[kRows][8], const float* a, int ldh,
                                          const float* b, int lane) {
  float av[2][kRows], bv[2][8];
  load_frag<kRows>(av[0], bv[0], a, ldh, b, lane, 0);
#pragma unroll 8
  for (int kk = 0; kk < kBK; ++kk) {
    if (kk + 1 < kBK)
      load_frag<kRows>(av[(kk + 1) & 1], bv[(kk + 1) & 1], a, ldh, b, lane, kk + 1);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        acc[i][j] = __fmaf_rn(av[kk & 1][i], bv[kk & 1][j], acc[i][j]);
  }
}

// h = relu(acc + bias) into the warp's own rows of the transposed
// activations, hT[column][m0 + i].
template <int kRows>
__device__ __forceinline__ void store_hidden(float (&acc)[kRows][8], const float* bias,
                                             float* hT, int ldh, int m0, int lane) {
  __syncwarp();  // every lane of the warp is done reading the layer's input
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = lane_col(lane, j);
    const float bj = __ldg(bias + c);
    float h[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) h[i] = relu(__fadd_rn(acc[i][j], bj));
    if constexpr (kRows == 8) {
      *reinterpret_cast<float4*>(hT + c * ldh + m0) = make_float4(h[0], h[1], h[2], h[3]);
      *reinterpret_cast<float4*>(hT + c * ldh + m0 + 4) = make_float4(h[4], h[5], h[6], h[7]);
    } else {
      *reinterpret_cast<float2*>(hT + c * ldh + m0) = make_float2(h[0], h[1]);
    }
  }
  __syncwarp();
}

// The tail chunk's contraction with out_kernel, added into the warp's
// per-row sums osw[row][slot0 + o] (the tail's first chunk stores).
// g: the lane's kRows rows x 8 columns; okc: out_kernel's rows of the
// chunk's columns, [256][O], in shared memory.  Each lane sums its 8 columns
// in order; the 32 lanes' sums are then added in a fixed tree, so every
// output has one summation order.  8 rows and O = 3 (kO = 3): a
// reduce-scatter, each of three levels (lane bits 4, 3, 2) halving the rows
// a lane holds, then a butterfly over bits 1 and 0, 27 shuffles in all;
// otherwise a butterfly per row and output.
template <int kRows, int kO>
__device__ __forceinline__ void contract(const float (&g)[kRows][8], const float* okc,
                                         float* osw, int slot0, bool first, int lane, int O) {
  if constexpr (kRows == 8 && kO == 3) {
    float v[24];
#pragma unroll
    for (int o = 0; o < 3; ++o) {
      float w[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) w[j] = okc[lane_col(lane, j) * 3 + o];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        float a = 0.0f;
#pragma unroll
        for (int j = 0; j < 8; ++j) a = __fmaf_rn(g[i][j], w[j], a);
        v[i * 3 + o] = a;
      }
    }
    const bool b4 = lane & 16, b3 = lane & 8, b2 = lane & 4;
    float u[12], t6[6], z[3];
#pragma unroll
    for (int k = 0; k < 12; ++k) {
      const float send = b4 ? v[k] : v[12 + k];
      u[k] = __fadd_rn(b4 ? v[12 + k] : v[k], __shfl_xor_sync(0xffffffffu, send, 16));
    }
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      const float send = b3 ? u[k] : u[6 + k];
      t6[k] = __fadd_rn(b3 ? u[6 + k] : u[k], __shfl_xor_sync(0xffffffffu, send, 8));
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float send = b2 ? t6[k] : t6[3 + k];
      z[k] = __fadd_rn(b2 ? t6[3 + k] : t6[k], __shfl_xor_sync(0xffffffffu, send, 4));
      z[k] = __fadd_rn(z[k], __shfl_xor_sync(0xffffffffu, z[k], 2));
      z[k] = __fadd_rn(z[k], __shfl_xor_sync(0xffffffffu, z[k], 1));
    }
    if ((lane & 3) == 0) {  // row 4 b4 + 2 b3 + b2
      float* slot = osw + (lane >> 2) * kMaxOut + slot0;
#pragma unroll
      for (int o = 0; o < 3; ++o) slot[o] = first ? z[o] : __fadd_rn(slot[o], z[o]);
    }
  } else {
    for (int o = 0; o < O; ++o) {
      float w[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) w[j] = okc[lane_col(lane, j) * O + o];
      float mine = 0.0f;
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        float v = 0.0f;
#pragma unroll
        for (int j = 0; j < 8; ++j) v = __fmaf_rn(g[i][j], w[j], v);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, off));
        if (lane == i) mine = v;
      }
      if (lane < kRows) {
        float* slot = osw + lane * kMaxOut + slot0 + o;
        *slot = first ? mine : __fadd_rn(*slot, mine);
      }
    }
  }
}

// Shared floats of the head kernel's layout but the barriers, for C consumer
// warps and BM rows a block: hT, xT, the ring, the per-warp sums, then the
// t row, the bias and out_kernel.
__host__ __device__ constexpr int head_floats(int C, int BM, int NT, int ok_floats) {
  return (kWidth + kBK) * (BM + 4) + kStages * kSliceFloats + C * 8 * kMaxOut + 2 * NT +
         ok_floats;
}

// Where a block's rows lie.  Block b owns rows [row0, row0 + rows): base +
// (b < rem) rows from b * base + min(b, rem).  Its first F consumer warps
// own 8 rows each; with `small`, one more warp owns the last rows - 8F
// (at most kSmallRows) of them.
struct Rows {
  int base, rem, F, small;
};

struct Smem {
  float *hT, *xT, *ring, *os, *trow, *bias, *ok;
  uint64_t *full, *empty, *consts;
  int ldh;
};

// One consumer warp's whole walk: rows [m0, m0 + kRows) of the block (those
// past `valid` are zeros and never stored), every slice in order.
template <int kRows, int kO>
__device__ __forceinline__ void consume(const Head& p, const Smem& sm, int row0, int m0,
                                        int valid, int warp, int lane, int nslices) {
  const int ldh = sm.ldh;
  float* osw = sm.os + warp * 8 * kMaxOut;
  // x^T of the warp's rows, inputs D..15 zero
  for (int q = lane; q < kBK * kRows; q += 32) {
    const int d = q / kRows, i = q % kRows;
    sm.xT[d * ldh + m0 + i] =
        d < p.D && m0 + i < valid ? p.x[static_cast<size_t>(row0 + m0 + i) * p.D + d] : 0.0f;
  }
  __syncwarp();

  float acc[kRows][8];
  for (int s = 0; s < nslices; ++s) {
    const int st = s % kStages;
    // s = 0: layer 0; then chunk 0 (layer 2) and the tail chunks, 16 slices each
    const int chunk = s == 0 ? -1 : (s - 1) / kSlicesPerChunk;
    const int ks = s == 0 ? 0 : (s - 1) % kSlicesPerChunk;
    const int col0 = (chunk - 1) * kChunk;
    if (ks == 0) {
      if (chunk <= 0) {
#pragma unroll
        for (int i = 0; i < kRows; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
      } else {  // a tail chunk's sums start from fp + trow (rows past n: trow)
        mbar_wait(sm.consts, 0);
        float tr[8];
        const float4 t0 = *reinterpret_cast<const float4*>(sm.trow + col0 + 4 * lane);
        const float4 t1 = *reinterpret_cast<const float4*>(sm.trow + col0 + 128 + 4 * lane);
        tr[0] = t0.x; tr[1] = t0.y; tr[2] = t0.z; tr[3] = t0.w;
        tr[4] = t1.x; tr[5] = t1.y; tr[6] = t1.z; tr[7] = t1.w;
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          float4 f0 = make_float4(0.0f, 0.0f, 0.0f, 0.0f), f1 = f0;
          if (m0 + i < valid) {
            const float* fr = p.fp + static_cast<size_t>(row0 + m0 + i) * p.NT + col0 + 4 * lane;
            f0 = __ldg(reinterpret_cast<const float4*>(fr));
            f1 = __ldg(reinterpret_cast<const float4*>(fr + 128));
          }
          acc[i][0] = __fadd_rn(f0.x, tr[0]); acc[i][1] = __fadd_rn(f0.y, tr[1]);
          acc[i][2] = __fadd_rn(f0.z, tr[2]); acc[i][3] = __fadd_rn(f0.w, tr[3]);
          acc[i][4] = __fadd_rn(f1.x, tr[4]); acc[i][5] = __fadd_rn(f1.y, tr[5]);
          acc[i][6] = __fadd_rn(f1.z, tr[6]); acc[i][7] = __fadd_rn(f1.w, tr[7]);
        }
      }
      if (chunk >= 0 && chunk * kChunk < p.NT) {  // the next chunk's fp rows, into L2
        for (int line = lane; line < kRows * 8; line += 32)
          if (m0 + line / 8 < valid)
            prefetch_l2(p.fp + static_cast<size_t>(row0 + m0 + line / 8) * p.NT +
                        chunk * kChunk + 32 * (line % 8));
      }
    }
    mbar_wait(&sm.full[st], (s / kStages) & 1);
    mma_slice<kRows>(acc, chunk < 0 ? sm.xT + m0 : sm.hT + ks * kBK * ldh + m0, ldh,
                     sm.ring + st * kSliceFloats, lane);
    __syncwarp();
    if (lane == 0) mbar_arrive(&sm.empty[st]);

    if (chunk < 0) {
      store_hidden<kRows>(acc, p.b0, sm.hT, ldh, m0, lane);  // h0
      continue;
    }
    if (ks != kSlicesPerChunk - 1) continue;
    if (chunk == 0) {
      store_hidden<kRows>(acc, p.b1, sm.hT, ldh, m0, lane);  // h1 over h0
      continue;
    }
    // a tail chunk: g = relu(acc + bias), in place, then out_kernel
    float bi[8];
    const float4 c0 = *reinterpret_cast<const float4*>(sm.bias + col0 + 4 * lane);
    const float4 c1 = *reinterpret_cast<const float4*>(sm.bias + col0 + 128 + 4 * lane);
    bi[0] = c0.x; bi[1] = c0.y; bi[2] = c0.z; bi[3] = c0.w;
    bi[4] = c1.x; bi[5] = c1.y; bi[6] = c1.z; bi[7] = c1.w;
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = relu(__fadd_rn(acc[i][j], bi[j]));
    const int tail = col0 / p.H;
    contract<kRows, kO>(acc, sm.ok + static_cast<size_t>(col0) * p.O, osw, tail * p.O,
                        col0 % p.H == 0, lane, p.O);
  }

  // (sum + out_bias) / (std + 1e-7), the warp's rows
  __syncwarp();
  const int OUT = (p.NT / p.H) * p.O;
  const float denom = __fadd_rn(__ldg(p.std_), 1e-7f);
  for (int q = lane; q < kRows * OUT; q += 32) {
    const int i = q / OUT, c = q % OUT;
    if (m0 + i < valid)
      p.out[static_cast<size_t>(row0 + m0 + i) * OUT + c] =
          __fdiv_rn(__fadd_rn(osw[i * kMaxOut + c], __ldg(p.ob + c)), denom);
  }
}

template <int kO>
__global__ void __launch_bounds__((kMaxWarps + 1) * 32, 1) score_head_kernel(Head p, Rows r) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int C = r.F + r.small;  // consumer warps; the producer is warp C
  const int BM = 8 * r.F;
  Smem sm;
  sm.ldh = BM + 4;  // = 4 (mod 8): 8 lanes' float4 stores hit 8 bank groups
  sm.hT = smem;                                  // [kWidth][ldh]
  sm.xT = sm.hT + kWidth * sm.ldh;               // [kBK][ldh]
  sm.ring = sm.xT + kBK * sm.ldh;                // [kStages][kSliceFloats]
  sm.os = sm.ring + kStages * kSliceFloats;      // [C][8][kMaxOut]
  sm.trow = sm.os + C * 8 * kMaxOut;             // [NT]
  sm.bias = sm.trow + p.NT;                      // [NT]
  sm.ok = sm.bias + p.NT;                        // [T * H * O]
  const int ok_floats = p.NT * p.O;
  sm.full = reinterpret_cast<uint64_t*>(smem + head_floats(C, BM, p.NT, ok_floats));
  sm.empty = sm.full + kStages;
  sm.consts = sm.empty + kStages;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.x;
  const int row0 = b * r.base + min(b, r.rem);
  const int valid = min(r.base + (b < r.rem ? 1 : 0), p.n - row0);
  const int nslices = 1 + (1 + p.NT / kChunk) * kSlicesPerChunk;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], C);
    }
    mbar_init(sm.consts, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();  // the block's last barrier: the producer warp leaves below

  if (warp == C) {  // the producer: slice s into stage s % kStages
    if (lane == 0) {
      for (int s = 0; s < nslices; ++s) {
        const int st = s % kStages;
        if (s == kStages) {  // the tails' constants, first needed at slice 17
          const unsigned nt_bytes = p.NT * sizeof(float);
          mbar_expect_tx(sm.consts, 2 * nt_bytes + ok_floats * sizeof(float));
          bulk_load(sm.trow, p.trow, nt_bytes, sm.consts);
          bulk_load(sm.bias, p.bias, nt_bytes, sm.consts);
          bulk_load(sm.ok, p.ok, ok_floats * sizeof(float), sm.consts);
        }
        if (s >= kStages) mbar_wait(&sm.empty[st], ((s / kStages) - 1) & 1);
        mbar_expect_tx(&sm.full[st], kSliceFloats * sizeof(float));
        float* dst = sm.ring + st * kSliceFloats;
        if (s == 0) {
          bulk_load(dst, p.w0t, kSliceFloats * sizeof(float), &sm.full[st]);
        } else if (s <= kSlicesPerChunk) {
          bulk_load(dst, p.w1t + (s - 1) * kSliceFloats, kSliceFloats * sizeof(float),
                    &sm.full[st]);
        } else {
          const int c = (s - 1) / kSlicesPerChunk - 1;
          const int k0 = ((s - 1) % kSlicesPerChunk) * kBK;
          for (int kk = 0; kk < kBK; ++kk)
            bulk_load(dst + kk * kChunk, p.pk + static_cast<size_t>(k0 + kk) * p.NT + c * kChunk,
                      kChunk * sizeof(float), &sm.full[st]);
        }
      }
    }
    return;
  }
  if (warp < r.F)
    consume<8, kO>(p, sm, row0, 8 * warp, valid, warp, lane, nslices);
  else
    consume<kSmallRows, kO>(p, sm, row0, BM, valid, warp, lane, nslices);
}

struct Prep {
  const float* t;      // [1]
  const float* fw;     // [64]       t_fourier.W
  const float* w_td;   // [128, 128] t_dense.weight
  const float* b_td;   // [128]
  const float* tk;     // [128, NT]  t_kernel
  const float* w0;     // [256, D]
  const float* w1;     // [256, 256]
  float* scratch;      // W0^T padded [16, 256], W1^T [256, 256], trow [NT]
  int NT, D;
};

// Blocks 0 .. ceil(NT / 32) - 1: the t row, trow[c] = sum_i
// relu(t_dense(fourier(t)))[i] * tk[i][c]: the Gaussian-Fourier features
// ((t W) 2) pi -> [sin, cos]; t_dense, one output a warp at a time (lanes
// over i, then a butterfly), and its ReLU, recomputed by each block (16 K
// multiply-adds); then the block's 32 columns, each summed by 8 warps over
// 16 i each, the 8 parts added in order.  Every weight load is issued
// before t is read, so the block waits on memory once.  The next 16
// blocks: W1^T, 16 of W1's rows a block through shared memory; the last:
// W0^T padded.
__global__ void __launch_bounds__(kPrepThreads) score_head_prep(Prep p) {
  __shared__ float four[kTDim];
  __shared__ float tf[kTDim];
  __shared__ float part[kPrepThreads / 32][32];
  __shared__ float tile[kTileRows][kWidth + 1];
  constexpr int kWarps = kPrepThreads / 32;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int trow_blocks = (p.NT + 31) / 32;
  if (static_cast<int>(blockIdx.x) >= trow_blocks) {
    float* w0t = p.scratch;
    float* w1t = w0t + kW0tFloats;
    const int b = blockIdx.x - trow_blocks;
    if (b < kWidth / kTileRows) {  // W1's rows 16 b.., read whole, written as columns
      for (int i = tid; i < kTileRows * kWidth; i += kPrepThreads)
        tile[i / kWidth][i % kWidth] = __ldg(p.w1 + b * kTileRows * kWidth + i);
      __syncthreads();
      for (int k = tid; k < kWidth; k += kPrepThreads) {
#pragma unroll
        for (int q = 0; q < kTileRows / 4; ++q)
          *reinterpret_cast<float4*>(w1t + k * kWidth + b * kTileRows + 4 * q) =
              make_float4(tile[4 * q][k], tile[4 * q + 1][k], tile[4 * q + 2][k],
                          tile[4 * q + 3][k]);
      }
    } else {  // W0^T, inputs D..15 zero
      for (int i = tid; i < kW0tFloats; i += kPrepThreads) {
        const int d = i / kWidth, n = i % kWidth;
        w0t[i] = d < p.D ? __ldg(p.w0 + n * p.D + d) : 0.0f;
      }
    }
    return;
  }
  // every weight the block reads, loaded before the features need them
  constexpr int kOuts = kTDim / kWarps, kPer = kTDim / kWarps;
  const int c = blockIdx.x * 32 + lane;
  float wtd[kOuts][kTDim / 32], btd[kOuts], wtk[kPer];
#pragma unroll
  for (int u = 0; u < kOuts; ++u) {
    const int o = warp + kWarps * u;
#pragma unroll
    for (int q = 0; q < kTDim / 32; ++q) wtd[u][q] = __ldg(p.w_td + o * kTDim + lane + 32 * q);
    btd[u] = __ldg(p.b_td + o);
  }
#pragma unroll
  for (int u = 0; u < kPer; ++u)
    wtk[u] = c < p.NT ? __ldg(p.tk + static_cast<size_t>(warp * kPer + u) * p.NT + c) : 0.0f;
  if (tid < kTDim) {
    const int half = kTDim / 2;
    const float xp = __fmul_rn(__fmul_rn(__fmul_rn(__ldg(p.t), __ldg(p.fw + tid % half)), 2.0f),
                               static_cast<float>(CUDART_PI));
    four[tid] = tid < half ? sinf(xp) : cosf(xp);
  }
  __syncthreads();
#pragma unroll
  for (int u = 0; u < kOuts; ++u) {
    float v = 0.0f;
#pragma unroll
    for (int q = 0; q < kTDim / 32; ++q) v = __fmaf_rn(four[lane + 32 * q], wtd[u][q], v);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, off));
    if (lane == 0) tf[warp + kWarps * u] = relu(__fadd_rn(v, btd[u]));
  }
  __syncthreads();
  float r = 0.0f;
#pragma unroll
  for (int u = 0; u < kPer; ++u) r = __fmaf_rn(tf[warp * kPer + u], wtk[u], r);
  part[warp][lane] = r;
  __syncthreads();
  if (warp == 0 && c < p.NT) {
    float sum = part[0][lane];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) sum = __fadd_rn(sum, part[w][lane]);
    p.scratch[kW0tFloats + kW1tFloats + c] = sum;
  }
}

}  // namespace

namespace {

// How n rows spread over the card: one block an SM, each with base or base
// + 1 rows, 8-row warps and one short warp for the last rows, when those
// are at most kSmallRows; otherwise 8-row warps only, ceil(n / (8 SMs))
// of them (kMinWarps to kMaxWarps) a block.  Gives the layout, and shape:
// consumer warps, rows a block, blocks, dynamic shared bytes; fails when
// the layout exceeds a block's shared memory.
int plan(int n, int num_sms, int NT, int O, Rows* r, int* shape) {
  if (n <= 0 || num_sms <= 0 || NT <= 0 || O <= 0) return (int)cudaErrorInvalidValue;
  const int base = n / num_sms, rem = n % num_sms;
  const int F = base / 8, extra = base % 8 + (rem > 0 ? 1 : 0);
  if (F >= kMinWarps && F + 1 <= kMaxWarps && extra > 0 && extra <= kSmallRows) {
    *r = Rows{base, rem, F, 1};
    shape[1] = base + (rem > 0 ? 1 : 0);
    shape[2] = num_sms;
  } else {
    const long long units = (n + 7LL) / 8;
    int warps = static_cast<int>((units + num_sms - 1) / num_sms);
    warps = warps < kMinWarps ? kMinWarps : (warps > kMaxWarps ? kMaxWarps : warps);
    *r = Rows{8 * warps, 0, warps, 0};
    shape[1] = 8 * warps;
    shape[2] = static_cast<int>((n + 8LL * warps - 1) / (8LL * warps));
  }
  shape[0] = r->F + r->small;
  shape[3] = static_cast<int>(sizeof(float)) * head_floats(shape[0], 8 * r->F, NT, NT * O) +
             static_cast<int>(sizeof(uint64_t)) * (2 * kStages + 1);
  return shape[3] <= kMaxSmem ? 0 : (int)cudaErrorInvalidValue;
}

}  // namespace

// The head kernel's shape for n rows on num_sms SMs, NT tail columns and O
// outputs a tail: consumer warps, rows a block, blocks, dynamic shared
// bytes (see plan).
extern "C" int gp_score_head_shape(int n, int num_sms, int NT, int O, int* shape) {
  Rows r;
  return plan(n, num_sms, NT, O, &r, shape);
}

// x [n, D], fp [n, T*H], out [n, T*O], scratch [16 * 256 + 256 * 256 + T*H];
// the weights as the wrapper (ops/score_head_cuda.py) passes them.  Launches
// the prep kernel, then the head, on `stream`; returns the launches' CUDA
// status.
extern "C" int gp_score_head(const float* x, const float* t, const float* std_,
                             const float* fourier_w, const float* td_w, const float* td_b,
                             const float* w0, const float* b0, const float* w1, const float* b1,
                             const float* fp, const float* tk, const float* pk, const float* bias,
                             const float* ok, const float* ob, float* scratch, float* out, int n,
                             int D, int T, int H, int O, int num_sms, void* stream) {
  if (n <= 0 || D <= 0 || D > kMaxPose || T <= 0 || O <= 0 || T * O > kMaxOut || H <= 0 ||
      H % kChunk != 0)
    return (int)cudaErrorInvalidValue;
  int shape[4];
  Rows r;
  const int NT = T * H;
  const int st = plan(n, num_sms, NT, O, &r, shape);
  if (st != 0) return st;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int prep_blocks = (NT + 31) / 32 + kWidth / kTileRows + 1;
  score_head_prep<<<prep_blocks, kPrepThreads, 0, s>>>(
      Prep{t, fourier_w, td_w, td_b, tk, w0, w1, scratch, NT, D});
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const float* w0t = scratch;
  const float* w1t = w0t + kW0tFloats;
  Head p{x, w0t, b0, w1t, b1, fp, w1t + kW1tFloats, pk, bias, ok, ob, std_, out, n, D, NT, H, O};
  auto kernel = O == 3 ? score_head_kernel<3> : score_head_kernel<0>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, shape[3]);
  if (err != cudaSuccess) return (int)err;
  kernel<<<shape[2], 32 * (shape[0] + 1), shape[3], s>>>(p, r);
  return (int)cudaGetLastError();
}
