// Wald ray-triangle test and the 8-candidate tie rule, shared by the tile
// kernel (tile_traverse.cu, K1) and the pulse-ladder kernel
// (pulse_traverse.cu, K2).  Both kernels and their plain PyTorch versions
// (kernels/traverse.py, kernels/pulse.py) give identical faces because they
// all evaluate exactly this, in this operation order:
//
//   * the Wald test of traverse_pallas.py:86-97 and pulse_pallas.py:79-90:
//     |n.d| >= EPSILON, else the divisor is +-1; accept 0 <= u <= 1,
//     v >= 0, u + v <= 1, t >= -EPSILON and id >= 0;
//   * IEEE f32 division (__fdiv_rn), built with --fmad=false and without
//     fast math, so no multiply-add is contracted;
//   * tie rule: within a block of 8 candidates the min t_m (t_max for a
//     rejected candidate), then among candidates with t_m <= t_c the min
//     face id; across blocks a strict <, starting from t_max.
#pragma once

#include <stdint.h>

namespace lbt {

constexpr int CAND_BLOCK = 8;     // candidates per tie-rule block
constexpr float EPSILON = 1e-8f;
constexpr float BIG = 3.4e38f;
constexpr int INT_MISS = 1 << 30;

struct Ray {
  float ox, oy, oz, dx, dy, dz;
};

// t_m of one candidate: its hit distance when the Wald test accepts it,
// else t_max.  ``w`` holds the 12-float Wald row [n, n.v0, nu, du, nv, dv]
// (all zero for a padding candidate, whose id is negative).
__device__ __forceinline__ float wald_t_m(const Ray& r, const float* w,
                                          int32_t id, float t_max) {
  const float nd = r.dx * w[0] + r.dy * w[1] + r.dz * w[2];
  const float no = r.ox * w[0] + r.oy * w[1] + r.oz * w[2];
  const bool ok_det = fabsf(nd) >= EPSILON;
  const float div = ok_det ? nd : (nd < 0.0f ? -1.0f : 1.0f);
  const float t = __fdiv_rn(w[3] - no, div);
  const float u = (r.ox * w[4] + r.oy * w[5] + r.oz * w[6]) + w[7]
                  + t * (r.dx * w[4] + r.dy * w[5] + r.dz * w[6]);
  const float v = (r.ox * w[8] + r.oy * w[9] + r.oz * w[10]) + w[11]
                  + t * (r.dx * w[8] + r.dy * w[9] + r.dz * w[10]);
  const bool ok = ok_det && u >= 0.0f && u <= 1.0f && v >= 0.0f &&
                  u + v <= 1.0f && t >= -EPSILON && id >= 0;
  return ok ? t : t_max;
}

// One block of CAND_BLOCK candidates for one ray: (t_c, f_c), its min t_m
// and the min face id among t_m <= t_c.  ``load(m, w)`` writes candidate
// m's Wald row into w[12] and returns its face id (negative for padding).
template <class Load>
__device__ __forceinline__ void wald_block_min(const Ray& r, Load load,
                                               float t_max, float& t_c,
                                               int32_t& f_c) {
  float t_m[CAND_BLOCK];
  int32_t ids[CAND_BLOCK];
  t_c = 0.0f;
#pragma unroll
  for (int m = 0; m < CAND_BLOCK; ++m) {
    float w[12];
    ids[m] = load(m, w);
    t_m[m] = wald_t_m(r, w, ids[m], t_max);
    t_c = (m == 0 || t_m[m] < t_c) ? t_m[m] : t_c;
  }
  f_c = INT_MISS;
#pragma unroll
  for (int m = 0; m < CAND_BLOCK; ++m)
    if (t_m[m] <= t_c && ids[m] < f_c) f_c = ids[m];
}

// One block merged into (t_best, f_best) by the tie rule: strict <, so an
// earlier block wins a tie.
template <class Load>
__device__ __forceinline__ void wald_block(const Ray& r, Load load,
                                           float t_max, float& t_best,
                                           int32_t& f_best) {
  float t_c;
  int32_t f_c;
  wald_block_min(r, load, t_max, t_c, f_c);
  if (t_c < t_best) {
    t_best = t_c;
    f_best = f_c;
  }
}

}  // namespace lbt
