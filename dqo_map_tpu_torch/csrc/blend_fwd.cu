// Forward tile blend for Hopper (sm_90a): front-to-back alpha blending of
// each 16x16 tile's depth-sorted Gaussian entries, with the hit-Gaussian
// depth model and, in its second variant, the one-surface background.
//
// Replaces the TPU kernel dqo_map_tpu/ops/blend_pallas.py::_fwd_kernel
// (launched by _fwd_call), both without and with its with_bg variant. It
// computes what that kernel computes, in the shape of the original CUDA
// rasterizer's renderCUDA rather than the TPU's lane layout:
//
//   - one CTA per tile, one thread per pixel (256 threads);
//   - the CTA walks its tile's live entries, the tile_counts[t] entries
//     from tile_offsets[t] on, in batches of 256 staged through shared
//     memory (16 feature rows each); the padding after them up to the next
//     aligned offset is never read, and its n_touched stays 0;
//   - a tile with no entries runs no batch and writes the init values
//     (colour = bg (+ the surface S), ids -1, end_T = T_final = 1,
//     weights 0): the TPU wrapper's empty-tile paste;
//   - each thread carries its pixel's transmittance in a register and uses
//     the plain multiplicative recurrence T *= (1 - alpha);
//   - a pixel is done once T < T_threshold and its hit is found (with the
//     background, also once it has passed the surface); the CTA leaves
//     when all 256 pixels are done (__syncthreads_count);
//   - n_touched of an entry is a block reduction (a ballot per warp, the
//     eight warp counts summed by one thread); every entry slot belongs to
//     exactly one tile, so no global atomics;
//   - the background variant (template flag kBG, operand bgt (T, 256, 8):
//     S rgb, D, tau) scales the entries behind the surface (z > D) by tau
//     and cuts them where test_T * tau < T_threshold; S lands once, scaled
//     by the transmittance over the entries in front, at the first entry
//     behind it, or at the flush with the final T. A pixel that has not
//     crossed walks on to its tile's end, so the flush sees the same T as
//     the TPU kernel, which always blends to the end.
//
// The walk stays in entry order, so the hit is the FIRST eligible entry
// and the colour id the EARLIEST maximum weight, as the reference requires.
// The float operations are those of the plain version in
// dqo_map_tpu_torch/ops/blend.py (blend_step), in the same order; the
// library is built with -fmad=false so that no multiply-add is contracted.
//
// What bounds it: per (pixel, live entry) pair visited it does an exp and
// about 25 float operations (about 35 with the background) on data already
// in shared memory, and it moves 68 bytes per live entry (16 feature rows
// in, n_touched out) plus 64 per pixel (the two 8-channel output blocks;
// 20 more with the background). Which of the two is the larger depends on
// the map; chip_smoke.py works out both from its run's data. The design
// does nothing yet about its real limit, the serial walk per pixel with
// one CTA per tile: no wgmma, TMA or warp specialisation.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;
constexpr int kPx = kTile * kTile;   // threads per CTA, one per pixel
constexpr int kBatch = 256;          // entries staged per round
constexpr int kNF = 16;              // feature rows
constexpr int kWarps = kPx / 32;
constexpr int kNC = 8;               // colour-block channels
constexpr int kNA = 8;               // aux channels
constexpr int kNB = 8;               // background channels: S rgb, D, tau

struct Params {
  float opaque_threshold, depth_threshold, normal_threshold, T_threshold;
  float alpha_min, alpha_max;
  float bg0, bg1, bg2;
};

template <bool kBG>
__global__ void __launch_bounds__(kPx)
blend_fwd_kernel(const float* __restrict__ feats, long long L,
                 const long long* __restrict__ tile_offsets,
                 const long long* __restrict__ tile_counts, int tw,
                 const float* __restrict__ scal, Params prm,
                 const float* __restrict__ bgt,
                 float* __restrict__ color, float* __restrict__ aux,
                 int* __restrict__ nt) {
  __shared__ float sf[kNF][kBatch];
  __shared__ int scnt[kWarps][kBatch];

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

  float T = 1.0f, c0 = 0.0f, c1 = 0.0f, c2 = 0.0f, wsum = 0.0f;
  float end_T = 1.0f, best_w = -1.0f, best_id = -1.0f;
  bool hit_found = false;
  float hit_id = -1.0f, hit_depth = 0.0f, hit_w = 0.0f;
  float hn0 = 0.0f, hn1 = 0.0f, hn2 = 0.0f;
  bool done = false;

  const long long o = ((long long)t * kPx + p);
  float S0 = 0.0f, S1 = 0.0f, S2 = 0.0f, bgD = 0.0f, tau = 1.0f;
  float T_front = 1.0f;
  bool crossed = false;
  if (kBG) {
    const float* b = bgt + o * kNB;
    S0 = b[0];
    S1 = b[1];
    S2 = b[2];
    bgD = b[3];
    tau = b[4];
  }

  const long long beg = tile_offsets[t];
  const long long end = beg + tile_counts[t];
  for (long long b0 = beg; b0 < end; b0 += kBatch) {
    // also the barrier before the staging buffers are overwritten
    if (__syncthreads_count(done) == kPx) break;
    const int nb = (int)min((long long)kBatch, end - b0);
    if (p < nb) {
#pragma unroll
      for (int r = 0; r < kNF; ++r) sf[r][p] = feats[r * L + b0 + p];
    }
    __syncthreads();
    for (int k = 0; k < nb; ++k) {
      bool touched = false;
      if (!done) {
        const float dx = sf[0][k] - px;
        const float dy = sf[1][k] - py;
        const float ca = sf[2][k], cb = sf[3][k], cc = sf[4][k];
        const float power = -0.5f * (ca * dx * dx + cc * dy * dy) - cb * dx * dy;
        const float G = expf(power);
        const float alpha_raw = fminf(sf[5][k] * G, prm.alpha_max);
        const bool skip = (power > 0.0f) || (alpha_raw < prm.alpha_min);
        const float alpha = skip ? 0.0f : alpha_raw;
        const float test_T = T * (1.0f - alpha);
        const bool contrib = (!skip) && (test_T >= prm.T_threshold);
        float w = contrib ? alpha * T : 0.0f;
        if (kBG) {
          const bool behind = (sf[5][k] != 0.0f) && (sf[9][k] > bgD);
          if (behind) w = (test_T * tau < prm.T_threshold) ? 0.0f : w * tau;
          if (behind && !crossed) {
            c0 = c0 + S0 * T_front;
            c1 = c1 + S1 * T_front;
            c2 = c2 + S2 * T_front;
            crossed = true;
          }
          if (!behind) T_front = T_front * (1.0f - alpha);
        }
        c0 = c0 + w * sf[6][k];
        c1 = c1 + w * sf[7][k];
        c2 = c2 + w * sf[8][k];
        wsum = wsum + w;
        const float gid = sf[14][k];
        if (w > best_w) {
          best_w = w;
          if (w > 0.0f) best_id = gid;
        }
        if (contrib) end_T = fminf(end_T, test_T);
        if (!hit_found && !skip && alpha_raw >= prm.opaque_threshold) {
          const float n0 = sf[10][k], n1 = sf[11][k], n2 = sf[12][k];
          const float z = sf[9][k];
          const float ndr = n0 * rx + n1 * ry + n2 * rz;
          const float hz = sf[15][k] / (ndr + 1e-8f) * rz;
          const bool plane_ok =
              (fabsf(hz - z) <= sf[13][k] * prm.depth_threshold) &&
              (fabsf(ndr) >= prm.normal_threshold);
          hit_depth = plane_ok ? hz : z;
          hit_w = alpha * T;
          hit_id = gid;
          hn0 = n0;
          hn1 = n1;
          hn2 = n2;
          hit_found = true;
        }
        T = test_T;
        done = (T < prm.T_threshold) && hit_found && (!kBG || crossed);
        touched = contrib && (test_T > 0.5f);
      }
      const unsigned m = __ballot_sync(0xffffffffu, touched);
      if (lane == 0) scnt[warp][k] = __popc(m);
    }
    __syncthreads();
    if (p < nb) {
      int s = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s += scnt[w][p];
      nt[b0 + p] = s;
    }
  }

  float* col = color + o * kNC;
  col[0] = c0 + end_T * prm.bg0;
  col[1] = c1 + end_T * prm.bg1;
  col[2] = c2 + end_T * prm.bg2;
  if (kBG && !crossed) {
    // the surface lies behind every entry of the tile
    col[0] = col[0] + S0 * T;
    col[1] = col[1] + S1 * T;
    col[2] = col[2] + S2 * T;
  }
  col[3] = hit_depth;
  col[4] = hn0;
  col[5] = hn1;
  col[6] = hn2;
  col[7] = 0.0f;
  float* ax = aux + o * kNA;
  ax[0] = hit_id;
  ax[1] = best_id;
  ax[2] = fmaxf(best_w, 0.0f);
  ax[3] = hit_w;
  ax[4] = end_T;
  ax[5] = wsum;
  ax[6] = T;
  ax[7] = hit_depth;
}

}  // namespace

// Launches on `stream`, the background variant where `bgt` is not null;
// returns the cudaError_t of the launch (0 = ok).
extern "C" int dqo_blend_fwd(const float* feats, long long L,
                             const long long* tile_offsets,
                             const long long* tile_counts, int n_tiles, int tw,
                             const float* scal,
                             float opaque_threshold, float depth_threshold,
                             float normal_threshold, float T_threshold,
                             float alpha_min, float alpha_max, float bg0,
                             float bg1, float bg2, const float* bgt,
                             float* color, float* aux, int* nt, void* stream) {
  Params prm{opaque_threshold, depth_threshold, normal_threshold, T_threshold,
             alpha_min, alpha_max, bg0, bg1, bg2};
  if (bgt != nullptr) {
    blend_fwd_kernel<true><<<n_tiles, kPx, 0, (cudaStream_t)stream>>>(
        feats, L, tile_offsets, tile_counts, tw, scal, prm, bgt, color, aux,
        nt);
  } else {
    blend_fwd_kernel<false><<<n_tiles, kPx, 0, (cudaStream_t)stream>>>(
        feats, L, tile_offsets, tile_counts, tw, scal, prm, bgt, color, aux,
        nt);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* dqo_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
