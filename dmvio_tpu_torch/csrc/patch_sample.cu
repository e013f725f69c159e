// K1: pattern sampling of (I, gx, gy) for every (target, point, pattern
// pixel) sample of the BA linearization and the activation GN.
//
// Replaces the Pallas kernel `_kernel` of dmvio_tpu/ops/patch_sample.py
// (launched by `pl.pallas_call` in `_gather_tpu`) TOGETHER WITH its
// consumer `sample3`: the TPU version copies one 16x16 level-0 patch per
// (target, point) pair into HBM (aligned 24-row slabs + rotates, because
// Mosaic cannot slice at dynamic offsets) and then samples it with one-hot
// contractions on the matrix unit. On Hopper neither detour pays: this
// kernel reads the <=4x4 stencil of each sample straight from the image
// (the whole [T, H, W] level-0 stack, 8 MiB at T=8 and 512x512, stays in
// the 50 MB L2), so the patch is never staged in memory.
//
// Semantics reproduced exactly (they decide which residuals are active):
//  * patch anchor = clip(floor(centre) - 7, 0, W - 16) per (t, n), with the
//    reference's saturating float->int32 cast (NaN -> 0, +-inf/huge ->
//    INT32_MAX/MIN) followed by wrapping int32 arithmetic;
//  * in-patch coordinates pu = u - x0, pv = v - y0; ok = both in
//    [1, 13.999]; pu, pv then clipped to the same [1, 13.999] (NaN stays
//    NaN), so ok == false lanes hold the finite samples of the clipped
//    position and the stencil (floor - 1 .. floor + 2) never leaves the
//    16x16 patch;
//  * a NaN coordinate yields NaN for i, gx and gy (the one-hot weights of
//    the reference carry the NaN into every output).
//
// Bound on the H100 at the operating point (T=8 targets, N=2048 points,
// K=8 pattern pixels): it reads ~1 MiB of coordinates and at most the
// 8 MiB of level-0 images, and writes ~1.6 MiB (3 x f32 + 1 bool per
// sample): 0.8-3.2 us at 3.35 TB/s, below the launch latency. The design is
// the simple right one: one thread per (t, n, k) sample, 12 texel loads
// through the read-only cache, no shared memory, no wgmma/TMA.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPatch = 16;
constexpr int kMargin = 7;

__device__ __forceinline__ int32_t sat_floor_i32(float x) {
  // XLA semantics: NaN -> 0, saturate at the int32 range.
  if (isnan(x)) return 0;
  float f = floorf(x);
  if (f >= 2147483648.0f) return 2147483647;
  if (f <= -2147483648.0f) return (-2147483647 - 1);
  return (int32_t)f;
}

__device__ __forceinline__ int32_t anchor(float c, int limit) {
  // floor(c) - 7 in wrapping int32 arithmetic, then clip to [0, limit].
  int32_t a = (int32_t)((uint32_t)sat_floor_i32(c) - (uint32_t)kMargin);
  return a < 0 ? 0 : (a > limit ? limit : a);
}

__device__ __forceinline__ float clip_keep_nan(float x, float lo, float hi) {
  // jnp.clip: NaN propagates (fminf/fmaxf would drop it).
  return x < lo ? lo : (x > hi ? hi : x);
}

__device__ __forceinline__ float lerp2(float w0, float a, float w1,
                                       float b) {
  // (1-d)*a + d*b without FMA contraction, matching the plain version's
  // rounding as closely as the summation order allows.
  return __fadd_rn(__fmul_rn(w0, a), __fmul_rn(w1, b));
}

__global__ void patch_sample3_kernel(
    const float* __restrict__ img, long long img_tstride,
    long long img_rstride, const float* __restrict__ u,
    const float* __restrict__ v, float* __restrict__ out_i,
    float* __restrict__ out_gx, float* __restrict__ out_gy,
    bool* __restrict__ out_ok, int T, int N, int K, int H, int W,
    int center) {
  long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long total = (long long)T * N * K;
  if (idx >= total) return;
  long long pair = idx / K;          // (t, n)
  int t = (int)(pair / N);

  float uc = __ldg(u + pair * K + center);
  float vc = __ldg(v + pair * K + center);
  int x0 = anchor(uc, W - kPatch);
  int y0 = anchor(vc, H - kPatch);

  float pu = __ldg(u + idx) - (float)x0;
  float pv = __ldg(v + idx) - (float)y0;
  bool ok = (pu >= 1.0f) && (pu <= 13.999f) && (pv >= 1.0f) &&
            (pv <= 13.999f);
  out_ok[idx] = ok;
  pu = clip_keep_nan(pu, 1.0f, 13.999f);
  pv = clip_keep_nan(pv, 1.0f, 13.999f);
  if (isnan(pu) || isnan(pv)) {
    float nan = __int_as_float(0x7fc00000);
    out_i[idx] = nan;
    out_gx[idx] = nan;
    out_gy[idx] = nan;
    return;
  }
  int c = (int)floorf(pu);           // in [1, 13]: taps c-1 .. c+2 in-patch
  int r = (int)floorf(pv);
  float dx = pu - floorf(pu);
  float dy = pv - floorf(pv);
  float ex = 1.0f - dx;
  float ey = 1.0f - dy;

  const float* base = img + (long long)t * img_tstride +
                      (long long)y0 * img_rstride + x0;
  // Patch texel (row rr, col cc), rr and cc in [0, 15].
  auto P = [&](int rr, int cc) -> float {
    return __ldg(base + (long long)rr * img_rstride + cc);
  };

  // Row pass (weights along y), then column pass (weights along x).
  float s0m = lerp2(ey, P(r, c - 1), dy, P(r + 1, c - 1));
  float s00 = lerp2(ey, P(r, c), dy, P(r + 1, c));
  float s01 = lerp2(ey, P(r, c + 1), dy, P(r + 1, c + 1));
  float s02 = lerp2(ey, P(r, c + 2), dy, P(r + 1, c + 2));
  float sp0 = lerp2(ey, P(r + 1, c), dy, P(r + 2, c));
  float sp1 = lerp2(ey, P(r + 1, c + 1), dy, P(r + 2, c + 1));
  float sm0 = lerp2(ey, P(r - 1, c), dy, P(r, c));
  float sm1 = lerp2(ey, P(r - 1, c + 1), dy, P(r, c + 1));

  float vi = lerp2(ex, s00, dx, s01);
  float vxp = lerp2(ex, s01, dx, s02);
  float vxm = lerp2(ex, s0m, dx, s00);
  float vyp = lerp2(ex, sp0, dx, sp1);
  float vym = lerp2(ex, sm0, dx, sm1);
  out_i[idx] = vi;
  out_gx[idx] = 0.5f * __fsub_rn(vxp, vxm);
  out_gy[idx] = 0.5f * __fsub_rn(vyp, vym);
}

}  // namespace

extern "C" int dmvio_patch_sample3(
    const float* img, long long img_tstride, long long img_rstride,
    const float* u, const float* v, float* out_i, float* out_gx,
    float* out_gy, bool* out_ok, int T, int N, int K, int H, int W,
    int center, void* stream) {
  long long total = (long long)T * N * K;
  if (total == 0) return 0;
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  patch_sample3_kernel<<<(unsigned)blocks, threads, 0,
                         (cudaStream_t)stream>>>(
      img, img_tstride, img_rstride, u, v, out_i, out_gx, out_gy, out_ok, T,
      N, K, H, W, center);
  return (int)cudaGetLastError();
}
