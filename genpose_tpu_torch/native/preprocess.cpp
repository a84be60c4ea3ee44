// The port's host C helper: masked depth back-projection, point
// down/up-sampling and host furthest point sampling, the per-instance data
// work of the training loader (``data/nocs.py``) and of evaluation stage 1
// (``runners/evaluation_single.py``).  The reference runs it in its torch
// DataLoader workers (``datasets_genpose.py:203-360``) and its eval loop
// (``evaluation_single.py:105-260``).  Exposed with C linkage and called
// through ctypes (``native/__init__.py``), which releases the GIL for the
// call, so the thread loader's workers run it in parallel.
//
// The same five entry points, xorshift128+ stream seeded by splitmix64 and
// Lemire draw as the JAX package's copy (``genpose_tpu/native``): a seed
// gives the same samples bit for bit.  Built with -ffp-contract=off, so
// every product and sum rounds on its own (``gp_fps``'s squared distance
// then rounds as ``ops/pointcloud.py::farthest_point_sample_ref`` does).
//
// Plain versions, which the tests hold each entry point against:
// ``data/dataset_utils.py::backproject_and_sample_ref`` (back-projection
// and the stream), ``_native_sample`` (``gp_sample_points``) and
// ``ops/pointcloud.py::farthest_point_sample_ref`` (``gp_fps``).

#include <cstdint>
#include <cstring>
#include <cmath>
#include <algorithm>

extern "C" {

// xorshift128+ — fast, seedable, reproducible across platforms.
struct GpRng {
  uint64_t s0, s1;
};

static inline uint64_t gp_rng_next(GpRng* r) {
  uint64_t x = r->s0;
  const uint64_t y = r->s1;
  r->s0 = y;
  x ^= x << 23;
  r->s1 = x ^ y ^ (x >> 17) ^ (y >> 26);
  return r->s1 + y;
}

static inline void gp_rng_seed(GpRng* r, uint64_t seed) {
  // splitmix64 expansion so nearby seeds give unrelated streams.
  uint64_t z = (seed += 0x9e3779b97f4a7c15ULL);
  z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ULL;
  z = (z ^ (z >> 27)) * 0x94d049bb133111ebULL;
  r->s0 = z ^ (z >> 31);
  z = (seed += 0x9e3779b97f4a7c15ULL);
  z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ULL;
  z = (z ^ (z >> 27)) * 0x94d049bb133111ebULL;
  r->s1 = z ^ (z >> 31);
  if (r->s0 == 0 && r->s1 == 0) r->s1 = 1;
}

// uniform integer in [0, n) without modulo bias (Lemire).
static inline uint64_t gp_rng_below(GpRng* r, uint64_t n) {
  __uint128_t m = (__uint128_t)gp_rng_next(r) * (__uint128_t)n;
  return (uint64_t)(m >> 64);
}

// Back-project masked depth pixels to camera-frame XYZ.
//
// depth/mask/xmap/ymap are flat arrays of length n (a cropped ROI).  A pixel
// contributes when depth > 0 and mask > 0 (ref ``datasets_genpose.py:391``).
// out_xyz must hold 3*n floats; returns the number of valid points written.
// ``scale`` converts depth units (1/1000 for mm -> m).
int gp_depth_mask_to_pcl(const float* depth, const float* mask,
                         const float* xmap, const float* ymap, int64_t n,
                         float fx, float fy, float cx, float cy, float scale,
                         float* out_xyz) {
  int64_t k = 0;
  const float inv_fx = scale / fx, inv_fy = scale / fy;
  for (int64_t i = 0; i < n; ++i) {
    const float d = depth[i];
    if (d > 0.0f && mask[i] > 0.0f) {
      out_xyz[3 * k + 0] = (xmap[i] - cx) * d * inv_fx;
      out_xyz[3 * k + 1] = (ymap[i] - cy) * d * inv_fy;
      out_xyz[3 * k + 2] = d * scale;
      ++k;
    }
  }
  return (int)k;
}

// Random down/duplicate-sample n -> n_pts points, semantics of
// ``datasets_genpose.py:370-383``: if short, tile whole cloud then take the
// remainder prefix; if long, sample n_pts distinct indices uniformly
// (partial Fisher-Yates).  In-place safe only when out != pcl.
void gp_sample_points(const float* pcl, int64_t n, int64_t n_pts,
                      uint64_t seed, float* out, int32_t* scratch_idx) {
  if (n <= 0) {  // empty cloud: zero-fill (the tiling loop below would spin)
    std::memset(out, 0, sizeof(float) * 3 * n_pts);
    return;
  }
  if (n == n_pts) {
    std::memcpy(out, pcl, sizeof(float) * 3 * n);
    return;
  }
  if (n < n_pts) {
    int64_t k = 0;
    for (; k + n <= n_pts; k += n)
      std::memcpy(out + 3 * k, pcl, sizeof(float) * 3 * n);
    if (k < n_pts)
      std::memcpy(out + 3 * k, pcl, sizeof(float) * 3 * (n_pts - k));
    return;
  }
  GpRng rng;
  gp_rng_seed(&rng, seed);
  for (int64_t i = 0; i < n; ++i) scratch_idx[i] = (int32_t)i;
  for (int64_t i = 0; i < n_pts; ++i) {
    const int64_t j = i + (int64_t)gp_rng_below(&rng, (uint64_t)(n - i));
    std::swap(scratch_idx[i], scratch_idx[j]);
    const int32_t src = scratch_idx[i];
    out[3 * i + 0] = pcl[3 * src + 0];
    out[3 * i + 1] = pcl[3 * src + 1];
    out[3 * i + 2] = pcl[3 * src + 2];
  }
}

// Fused back-project + sample: the whole per-instance hot path in one pass.
// Returns the raw valid-point count (caller applies its <50 cutoff); writes
// exactly n_pts sampled points to out (undefined when the count is 0).
// buf must hold 3*n floats, scratch_idx n int32s.
int gp_backproject_sample(const float* depth, const float* mask,
                          const float* xmap, const float* ymap, int64_t n,
                          float fx, float fy, float cx, float cy, float scale,
                          int64_t n_pts, uint64_t seed, float* out,
                          float* buf, int32_t* scratch_idx) {
  const int valid = gp_depth_mask_to_pcl(depth, mask, xmap, ymap, n, fx, fy,
                                         cx, cy, scale, buf);
  if (valid <= 0) return valid;
  gp_sample_points(buf, valid, n_pts, seed, out, scratch_idx);
  return valid;
}

// Host furthest point sampling, the exact iteration of the reference CUDA
// kernel (``sampling_gpu.cu:93-208``): seed index 0, then m-1 rounds of
// min-distance update + argmax.  dist must hold n floats.
void gp_fps(const float* pts, int64_t n, int64_t m, int32_t* out_idx,
            float* dist) {
  if (n <= 0 || m <= 0) return;
  for (int64_t i = 0; i < n; ++i) dist[i] = 1e10f;
  int64_t cur = 0;
  out_idx[0] = 0;
  for (int64_t s = 1; s < m; ++s) {
    const float px = pts[3 * cur + 0], py = pts[3 * cur + 1],
                pz = pts[3 * cur + 2];
    float best = -1.0f;
    int64_t best_i = 0;
    for (int64_t i = 0; i < n; ++i) {
      const float dx = pts[3 * i + 0] - px;
      const float dy = pts[3 * i + 1] - py;
      const float dz = pts[3 * i + 2] - pz;
      const float d = dx * dx + dy * dy + dz * dz;
      if (d < dist[i]) dist[i] = d;
      if (dist[i] > best) {
        best = dist[i];
        best_i = i;
      }
    }
    cur = best_i;
    out_idx[s] = (int32_t)cur;
  }
}

// Batched FPS over B independent clouds laid out (B, n, 3) -> (B, m).
void gp_fps_batch(const float* pts, int64_t b, int64_t n, int64_t m,
                  int32_t* out_idx, float* dist) {
  for (int64_t i = 0; i < b; ++i)
    gp_fps(pts + i * 3 * n, n, m, out_idx + i * m, dist);
}

}  // extern "C"
