// Backward tile blend for Hopper (sm_90a): the vector-Jacobian product of
// the forward blend (blend_fwd.cu) with respect to the 16 feature rows of
// each live entry, with and without the one-surface background.
//
// Replaces the TPU kernel dqo_map_tpu/ops/blend_pallas.py::_bwd_kernel
// (launched by _blend_core_bwd), both variants. What it computes, per
// pixel p and live entry k of p's tile, in the forward's entry order:
//
//   - the colour cotangent d (rgb) reaches alpha through
//       dL/dalpha = (c_k . d) T_k tfac_k - suffix_k / (1 - alpha_k)
//                   - end_T (bg . d) / (1 - alpha_k),
//     where suffix_k, the colour after k dotted with d, is the saved total
//     (the forward's colour block less end_T bg) less the running prefix,
//     as the TPU kernel does it; with the background, the surface's term
//     S . d T_front joins the prefix where the pixel crosses it, and tfac
//     is tau behind the surface (0 where cut), 1 in front;
//   - from dL/dalpha to xy, conic and opacity through G = exp(power), the
//     0.99 clamp straight-through; rgb gets w d;
//   - only entries that contributed in the forward (test_T >= T_threshold)
//     get these terms, so a pixel's alpha terms stop once its T falls
//     below T_threshold;
//   - the depth and normal cotangents go to the pixel's hit entry, matched
//     by gaussian id (row 14, unique in a tile) wherever it sits, also past
//     the point where T fell below the threshold: plane branch to rows
//     10:13 and 15, splat branch to row 9, the branch the forward took.
//
// Shape: one CTA per tile, one thread per pixel (256 threads), entries
// staged through shared memory in batches of 32. For each entry the 14
// gradient rows are summed over the 256 pixels inside the CTA: a shuffle
// tree per warp (skipped when no lane of the warp has a term), then the
// eight warp sums from shared memory. Every entry slot belongs to one
// tile, so each CTA writes its entries' rows with no global atomics. The
// CTA leaves when every pixel has T < T_threshold and has passed its hit.
//
// What bounds it: per (pixel, entry) pair walked it does an exp and about
// 60 float operations, plus per entry and warp 70 shuffles; it moves 64
// bytes in and 56 out per live entry and 48 bytes in per pixel (68 with
// the background). chip_smoke.py works out both bounds from its run's
// data. The per-entry CTA reduction, not the arithmetic, is its real
// limit; no wgmma, TMA or warp specialisation yet.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;
constexpr int kPx = kTile * kTile;   // threads per CTA, one per pixel
constexpr int kBatch = 32;           // entries staged per round
constexpr int kNF = 16;              // feature rows
constexpr int kNG = 14;              // gradient rows written
constexpr int kWarps = kPx / 32;
constexpr int kNC = 8;               // colour-block channels
constexpr int kNA = 8;               // aux channels
constexpr int kNB = 8;               // background channels: S rgb, D, tau

// feature row of each written gradient row (13 scale_max, 14 id get none)
__constant__ int kRow[kNG] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 15};

struct Params {
  float opaque_threshold, depth_threshold, normal_threshold, T_threshold;
  float alpha_min, alpha_max;
  float bg0, bg1, bg2;
};

template <bool kBG>
__global__ void __launch_bounds__(kPx)
blend_bwd_kernel(const float* __restrict__ feats, long long L,
                 const long long* __restrict__ tile_offsets,
                 const long long* __restrict__ tile_counts, int tw,
                 const float* __restrict__ scal, Params prm,
                 const float* __restrict__ bgt,
                 const float* __restrict__ dcolor,
                 const float* __restrict__ color,
                 const float* __restrict__ aux, float* __restrict__ dfeats) {
  __shared__ float sf[kNF][kBatch];
  __shared__ float sg[kWarps][kNG][kBatch];

  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int lane = p & 31;
  const int warp = p >> 5;
  const float px = (float)((t % tw) * kTile + (p % kTile));
  const float py = (float)((t / tw) * kTile + (p / kTile));
  const float fx = scal[0], fy = scal[1], cx = scal[2], cy = scal[3];
  float rx = (px - cx) / fx;
  float ry = (py - cy) / fy;
  const float nrm = sqrtf(rx * rx + ry * ry + 1.0f);
  rx = rx / nrm;
  ry = ry / nrm;
  const float rz = 1.0f / nrm;
  const float thr = prm.T_threshold;

  const long long o = ((long long)t * kPx + p);
  const float* dc = dcolor + o * kNC;
  const float d0 = dc[0], d1 = dc[1], d2 = dc[2], d3 = dc[3];
  const float dn0 = dc[4], dn1 = dc[5], dn2 = dc[6];
  const float hid = aux[o * kNA + 0];
  const float end_T = aux[o * kNA + 4];
  const float* col = color + o * kNC;
  const float dot_total = (col[0] - end_T * prm.bg0) * d0 +
                          (col[1] - end_T * prm.bg1) * d1 +
                          (col[2] - end_T * prm.bg2) * d2;
  const float bgdot = d0 * prm.bg0 + d1 * prm.bg1 + d2 * prm.bg2;
  float bgD = 0.0f, tau = 1.0f, sdot = 0.0f, T_front = 1.0f;
  bool crossed = false;
  if (kBG) {
    const float* b = bgt + o * kNB;
    sdot = b[0] * d0 + b[1] * d1 + b[2] * d2;
    bgD = b[3];
    tau = b[4];
  }

  float T = 1.0f, prefix = 0.0f;
  bool pending = hid >= 0.0f;
  bool done = false;

  const long long beg = tile_offsets[t];
  const long long end = beg + tile_counts[t];
  for (long long b0 = beg; b0 < end; b0 += kBatch) {
    // also the barrier before the staging buffers are overwritten
    if (__syncthreads_count(done) == kPx) break;
    const int nb = (int)min((long long)kBatch, end - b0);
    for (int i = p; i < kNF * nb; i += kPx) {
      const int r = i / nb, e = i % nb;
      sf[r][e] = feats[r * L + b0 + e];
    }
    __syncthreads();
    for (int k = 0; k < nb; ++k) {
      float g[kNG];
#pragma unroll
      for (int r = 0; r < kNG; ++r) g[r] = 0.0f;
      bool any = false;
      if (!done) {
        if (pending && sf[14][k] == hid) {
          // the pixel's hit: depth and normal cotangents
          const float n0 = sf[10][k], n1 = sf[11][k], n2 = sf[12][k];
          const float ndm = sf[15][k];
          const float ndr = n0 * rx + n1 * ry + n2 * rz;
          const float hz = ndm / (ndr + 1e-8f) * rz;
          const bool plane_ok =
              (fabsf(hz - sf[9][k]) <= sf[13][k] * prm.depth_threshold) &&
              (fabsf(ndr) >= prm.normal_threshold);
          const float inv = 1.0f / (ndr + 1e-8f);
          const float dd_plane = plane_ok ? d3 : 0.0f;
          const float d_ndr = dd_plane * (-ndm * inv * inv) * rz;
          g[9] = d3 - dd_plane;
          g[10] = d_ndr * rx + dn0;
          g[11] = d_ndr * ry + dn1;
          g[12] = d_ndr * rz + dn2;
          g[13] = dd_plane * inv * rz;
          pending = false;
          any = true;
        }
        if (T >= thr) {
          const float dx = sf[0][k] - px;
          const float dy = sf[1][k] - py;
          const float ca = sf[2][k], cb = sf[3][k], cc = sf[4][k];
          const float op = sf[5][k];
          const float power =
              -0.5f * (ca * dx * dx + cc * dy * dy) - cb * dx * dy;
          const float G = expf(power);
          const float alpha_raw = fminf(op * G, prm.alpha_max);
          const bool skip = (power > 0.0f) || (alpha_raw < prm.alpha_min);
          const float alpha = skip ? 0.0f : alpha_raw;
          const float one_m = 1.0f - alpha;
          const float test_T = T * one_m;
          const bool contrib = (!skip) && (test_T >= thr);
          float w = contrib ? alpha * T : 0.0f;
          const float cd = sf[6][k] * d0 + sf[7][k] * d1 + sf[8][k] * d2;
          float tfac = 1.0f;
          if (kBG) {
            const bool behind = (op != 0.0f) && (sf[9][k] > bgD);
            if (behind) tfac = (test_T * tau < thr) ? 0.0f : tau;
            w = w * tfac;
            if (behind && !crossed) {
              prefix = prefix + sdot * T_front;
              crossed = true;
            }
            if (!behind) T_front = T_front * one_m;
          }
          prefix = prefix + w * cd;
          if (contrib) {
            const float suffix = dot_total - prefix;
            const float dL = cd * T * tfac - suffix / one_m -
                             end_T * bgdot / one_m;
            const float gl = op * dL * G;
            g[0] = gl * (-(ca * dx + cb * dy));
            g[1] = gl * (-(cc * dy + cb * dx));
            g[2] = gl * (-0.5f * dx * dx);
            g[3] = gl * (-dx * dy);
            g[4] = gl * (-0.5f * dy * dy);
            g[5] = G * dL;
            g[6] = w * d0;
            g[7] = w * d1;
            g[8] = w * d2;
            any = true;
          }
          T = test_T;
        }
        done = (T < thr) && !pending;
      }
      if (__any_sync(0xffffffffu, any)) {
#pragma unroll
        for (int r = 0; r < kNG; ++r) {
          float v = g[r];
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            v += __shfl_xor_sync(0xffffffffu, v, off);
          if (lane == 0) sg[warp][r][k] = v;
        }
      } else if (lane == 0) {
#pragma unroll
        for (int r = 0; r < kNG; ++r) sg[warp][r][k] = 0.0f;
      }
    }
    __syncthreads();
    for (int i = p; i < kNG * nb; i += kPx) {
      const int r = i / nb, e = i % nb;
      float s = 0.0f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s += sg[w][r][e];
      dfeats[kRow[r] * L + b0 + e] = s;
    }
  }
}

}  // namespace

// Launches on `stream`, the background variant where `bgt` is not null;
// `dfeats` must be zeroed by the caller. Returns the cudaError_t of the
// launch (0 = ok).
extern "C" int dqo_blend_bwd(const float* feats, long long L,
                             const long long* tile_offsets,
                             const long long* tile_counts, int n_tiles, int tw,
                             const float* scal,
                             float opaque_threshold, float depth_threshold,
                             float normal_threshold, float T_threshold,
                             float alpha_min, float alpha_max, float bg0,
                             float bg1, float bg2, const float* bgt,
                             const float* dcolor, const float* color,
                             const float* aux, float* dfeats, void* stream) {
  Params prm{opaque_threshold, depth_threshold, normal_threshold, T_threshold,
             alpha_min, alpha_max, bg0, bg1, bg2};
  if (bgt != nullptr) {
    blend_bwd_kernel<true><<<n_tiles, kPx, 0, (cudaStream_t)stream>>>(
        feats, L, tile_offsets, tile_counts, tw, scal, prm, bgt, dcolor,
        color, aux, dfeats);
  } else {
    blend_bwd_kernel<false><<<n_tiles, kPx, 0, (cudaStream_t)stream>>>(
        feats, L, tile_offsets, tile_counts, tw, scal, prm, bgt, dcolor,
        color, aux, dfeats);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* dqo_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
