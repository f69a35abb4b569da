// Forward tile blend for Hopper (sm_90a): front-to-back alpha blending of
// each 16x16 tile's depth-sorted Gaussian entries, with the hit-Gaussian
// depth model and, in its second variant, the one-surface background.
//
// Replaces the TPU kernel dqo_map_tpu/ops/blend_pallas.py::_fwd_kernel
// (launched by _fwd_call), both without and with its with_bg variant. It
// computes what that kernel computes, in the shape of the original CUDA
// rasterizer's renderCUDA rather than the TPU's lane layout:
//
//   - one CTA per tile, each thread walking two of its 256 pixels;
//   - the CTA walks its tile's live entries, the tile_counts[t] entries
//     from tile_offsets[t] on; the padding after them up to the next
//     aligned offset is never read, and its n_touched stays 0;
//   - a tile with no entries walks nothing and writes the init values
//     (colour = bg (+ the surface S), ids -1, end_T = T_final = 1,
//     weights 0): the TPU wrapper's empty-tile paste;
//   - each thread carries its pixels' transmittances in registers and uses
//     the plain multiplicative recurrence T *= (1 - alpha);
//   - a pixel is done once T < T_threshold and its hit is found (with the
//     background, also once it has passed the surface);
//   - n_touched of an entry is the number of the tile's pixels it touches;
//     every entry slot belongs to exactly one tile, so no global atomics;
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
// The design:
//   - Launch order: CTA i blends tile tile_order[i], the binning's order
//     (most live entries first; tile i where it is null), so the crowded
//     tiles start first and the empty tiles, which only write their init
//     values, fill the tail.
//   - Output: each thread puts its pixels' 8 colour and 8 aux channels in
//     shared memory, and the CTA writes the tile's two 8 KB blocks as
//     float4s, a warp 512 contiguous bytes: written from each thread, a
//     warp's 4-byte stores 32 bytes apart would touch 32 sectors for 128
//     bytes, and the blocks are most of the bytes the call moves. Until
//     the walk ends, the slots it writes last hold what it reads once a
//     pixel (the surface colour, the unit ray) in place of registers.
//   - 128 threads, two pixels each, one column of the tile four rows apart,
//     a warp's 64 an 8 x 8 block: the two share the entry's loads, dx and
//     the terms of the power in dx alone, and give each thread two
//     independent chains. Entries are staged kBatch at a time,
//     feature-major rows to entry-major float4s in shared memory, by
//     cp.async into two buffers: batch i + 1 loads while batch i is
//     walked. One barrier per batch orders the buffers and is the CTA's
//     exit check (all 256 pixels done); a warp whose pixels are all done
//     walks no further batch, and its counts are 0.
//   - The walk of an entry is one basic block, so the compiler interleaves
//     the two pixels' chains: no branch at the hit (the pixel notes the
//     entry and its weight; the hit's depth and normal are worked out from
//     the still staged entry after the batch), and a pixel that is done
//     takes w = 0 and keeps its T, as the plain version does. Whether a
//     pixel is done is worked out from T and its flags where it is read.
//   - n_touched: per entry a ballot per 8 x 4 pixel block, which lane k
//     keeps for the batch's entry k; after the batch's barrier the first
//     kBatch threads sum the eight blocks' counts.
//   - Slower or no faster on the main path's inputs on one H100, so not
//     kept: one pixel a thread, or four; the alphas of two entries at
//     once; batches of 8 or 16; a register cap for 5 or 6 CTAs an SM; a
//     warp-wide path for entries every pixel skips; the exit vote every
//     1 to 8 entries; ballots stored per entry. The crowded tile is not
//     split over CTAs: alone it takes under a third of the call.
//
// What bounds it: the card's bound is the bytes (68 per live entry: 16
// feature rows in, n_touched out; 64 per pixel: the two 8-channel output
// blocks; 20 more with the background), and chip_smoke.py works out both
// bounds from its run. The kernel runs several times above it, on
// instruction issue: per (pixel, live entry) pair walked an exp and some
// 45 other float operations in the plain version's order, which
// -fmad=false keeps from fusing, and a dozen more instructions of loads,
// ballots and flags.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;
constexpr int kPx = kTile * kTile;   // pixels per tile
constexpr int kRows = 2;             // pixels per thread, in one column
constexpr int kThreads = kPx / kRows;
constexpr int kBlocks = kPx / 32;    // 8 x 4 pixel blocks, kRows per warp
constexpr int kBatch = 32;           // entries staged per round
constexpr int kNF = 16;              // feature rows
constexpr int kNC = 8;               // colour-block channels
constexpr int kNA = 8;               // aux channels
constexpr int kNB = 8;               // background channels: S rgb, D, tau
constexpr int kFeatBufs = 2;
static_assert(kBatch <= 32 && kBatch <= kThreads,
              "lane k keeps entry k's ballots; thread k sums them");

struct Params {
  float opaque_threshold, depth_threshold, normal_threshold, T_threshold;
  float alpha_min, alpha_max;
  float bg0, bg1, bg2;
};

struct Smem {
  float4 f[kFeatBufs][kBatch][4];        // entry features, entry-major
  unsigned touched[2][kBlocks][kBatch];  // per pixel block and entry: ballot
  // the tile's colour and aux blocks, pixel-major as in memory; until the
  // walk ends, the slots written only at its end hold what it reads once:
  // colour 0..2 the pixel's surface colour S, aux 4..6 its unit ray
  float col[kPx * kNC];
  float aux[kPx * kNA];
};

// A pixel's walk: its coordinates and background surface, and its state;
// the hit's channels go to their slots in shared memory once per batch.
template <bool kBG>
struct Pixel {
  float px, py, bgD, tau;
  float T, c0, c1, c2, wsum, end_T, best_w, best_id, T_front, hit_w;
  int hit_k;   // the batch's entry that is the pixel's hit, or -1
  bool hit_found, crossed;
};

// Done: T below T_threshold and the hit found (with the background, also
// the surface passed). Worked out where it is read, from the state, rather
// than kept as a flag of its own.
template <bool kBG>
__device__ __forceinline__ bool done(const Pixel<kBG>& q, const Params& prm) {
  return (q.T < prm.T_threshold) && q.hit_found && (!kBG || q.crossed);
}

__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ void cp_async4(void* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The pixel's place in the tile, its coordinates, unit ray and background
// surface, and its initial state; the hit's slots get their init values.
template <bool kBG>
__device__ __forceinline__ void init_pixel(Pixel<kBG>& q, int pix,
                                           long long t, int tw,
                                           const float* __restrict__ scal,
                                           const float* __restrict__ bgt,
                                           Smem& sm) {
  q.px = (float)((int)(t % tw) * kTile + pix % kTile);
  q.py = (float)((int)(t / tw) * kTile + pix / kTile);
  const float fx = scal[0], fy = scal[1], cx = scal[2], cy = scal[3];
  const float rx = (q.px - cx) / fx;
  const float ry = (q.py - cy) / fy;
  const float nrm = sqrtf(rx * rx + ry * ry + 1.0f);
  float* cs = &sm.col[pix * kNC];
  float* as = &sm.aux[pix * kNA];
  cs[3] = cs[4] = cs[5] = cs[6] = cs[7] = 0.0f;
  as[0] = -1.0f;
  as[3] = as[7] = 0.0f;
  as[4] = rx / nrm;
  as[5] = ry / nrm;
  as[6] = 1.0f / nrm;
  q.bgD = 0.0f;
  q.tau = 1.0f;
  if (kBG) {
    const float* b = bgt + (t * kPx + pix) * kNB;
    const float4 s = ldg4(b);
    cs[0] = s.x;
    cs[1] = s.y;
    cs[2] = s.z;
    q.bgD = s.w;
    q.tau = __ldg(b + 4);
  }
  q.T = 1.0f;
  q.c0 = q.c1 = q.c2 = q.wsum = 0.0f;
  q.end_T = 1.0f;
  q.best_w = -1.0f;
  q.best_id = -1.0f;
  q.T_front = 1.0f;
  q.hit_found = q.crossed = false;
  q.hit_k = -1;
  q.hit_w = 0.0f;
}

// What an entry gives a pixel before the walk's state enters.
struct Alpha {
  float alpha;
  bool skip, opaque, behind;
};

template <bool kBG>
__device__ __forceinline__ Alpha alpha_of(const Pixel<kBG>& q, float power,
                                          float op, float z,
                                          const Params& prm) {
  const float G = expf(power);
  const float alpha_raw = fminf(op * G, prm.alpha_max);
  Alpha a;
  a.skip = (power > 0.0f) || (alpha_raw < prm.alpha_min);
  a.alpha = a.skip ? 0.0f : alpha_raw;
  a.opaque = !a.skip && alpha_raw >= prm.opaque_threshold;
  a.behind = kBG && (op != 0.0f) && (z > q.bgD);
  return a;
}

// The entry's alphas at the thread's pixels, which share a column, so
// share dx and the terms of the power that depend on dx alone.
template <bool kBG>
__device__ __forceinline__ void alpha_col(const Pixel<kBG> (&q)[kRows],
                                          const float4* f, const Params& prm,
                                          Alpha (&a)[kRows]) {
  const float4 f0 = f[0];   // x, y, conic a, b
  const float4 f1 = f[1];   // conic c, opacity, r, g
  const float z = kBG ? f[2].y : 0.0f;
  const float dx = f0.x - q[0].px;
  const float ca = f0.z, cb = f0.w, cc = f1.x;
  const float xx = ca * dx * dx;
  const float bx = cb * dx;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const float dy = f0.y - q[i].py;
    const float power = -0.5f * (xx + cc * dy * dy) - bx * dy;
    a[i] = alpha_of(q[i], power, f1.y, z, prm);
  }
}

// One entry of the pixel's walk from its `alpha_of`, in the plain
// version's float operations and order. Returns whether it touches the
// pixel (contributes with test_T > 0.5). Without branches but at the hit:
// a pixel that is done gets w = 0 and keeps its T, as in the plain
// version; its best weight (>= 0 once it has walked an entry) stays, its
// T_front, read only at the crossing it has passed, may move, and it has
// its hit, so it finds none.
template <bool kBG>
__device__ __forceinline__ bool step(Pixel<kBG>& q, const Alpha& a,
                                     const float4* f, const Params& prm,
                                     Smem& sm, int pix, int k) {
  const bool active = !done(q, prm);
  const float one_m = 1.0f - a.alpha;
  const float test_T = q.T * one_m;
  const bool contrib = active && !a.skip && (test_T >= prm.T_threshold);
  float w = contrib ? a.alpha * q.T : 0.0f;
  if (kBG) {
    // the surface behind the entry scales it; S lands once, at the first
    // entry behind it
    if (a.behind) w = (test_T * q.tau < prm.T_threshold) ? 0.0f : w * q.tau;
    if (a.behind && !q.crossed) {
      const float* cs = &sm.col[pix * kNC];
      q.c0 = q.c0 + cs[0] * q.T_front;
      q.c1 = q.c1 + cs[1] * q.T_front;
      q.c2 = q.c2 + cs[2] * q.T_front;
      q.crossed = true;
    }
    q.T_front = a.behind ? q.T_front : q.T_front * one_m;
  }
  const float4 f1 = f[1];   // conic c, opacity, r, g
  const float4 f2 = f[2];   // b, depth, n0, n1
  const float4 f3 = f[3];   // n2, scale_max, id, ndm
  q.c0 = q.c0 + w * f1.z;
  q.c1 = q.c1 + w * f1.w;
  q.c2 = q.c2 + w * f2.x;
  q.wsum = q.wsum + w;
  const float gid = f3.z;
  const bool better = w > q.best_w;
  q.best_id = (better && w > 0.0f) ? gid : q.best_id;
  q.best_w = better ? w : q.best_w;
  q.end_T = contrib ? fminf(q.end_T, test_T) : q.end_T;
  const bool new_hit = !q.hit_found && a.opaque;
  q.hit_k = new_hit ? k : q.hit_k;
  q.hit_w = new_hit ? a.alpha * q.T : q.hit_w;
  q.hit_found = q.hit_found || new_hit;
  q.T = active ? test_T : q.T;
  return contrib && (test_T > 0.5f);
}

// The hit the pixel found in the batch just walked: its depth and normal
// from the entry's features, still staged, to shared memory.
template <bool kBG>
__device__ __forceinline__ void resolve_hit(Pixel<kBG>& q,
                                            const float4 (*F)[4],
                                            const Params& prm, Smem& sm,
                                            int pix) {
  if (q.hit_k < 0) return;
  const float4 f2 = F[q.hit_k][2];   // b, depth, n0, n1
  const float4 f3 = F[q.hit_k][3];   // n2, scale_max, id, ndm
  float* cs = &sm.col[pix * kNC];
  float* as = &sm.aux[pix * kNA];
  const float rx = as[4], ry = as[5], rz = as[6];
  const float n0 = f2.z, n1 = f2.w, n2 = f3.x;
  const float z = f2.y;
  const float ndr = n0 * rx + n1 * ry + n2 * rz;
  const float hz = f3.w / (ndr + 1e-8f) * rz;
  const bool plane_ok =
      (fabsf(hz - z) <= f3.y * prm.depth_threshold) &&
      (fabsf(ndr) >= prm.normal_threshold);
  const float hit_depth = plane_ok ? hz : z;
  cs[3] = hit_depth;
  cs[4] = n0;
  cs[5] = n1;
  cs[6] = n2;
  as[0] = f3.z;
  as[3] = q.hit_w;
  as[7] = hit_depth;
  q.hit_k = -1;
}

template <bool kBG>
__device__ __forceinline__ bool pixels_done(const Pixel<kBG> (&q)[kRows],
                                            const Params& prm) {
  bool d = true;
#pragma unroll
  for (int i = 0; i < kRows; ++i) d = d && done(q[i], prm);
  return d;
}

// Walks the thread's pixels through entries [0, nb) of a staged batch,
// unless the warp's pixels are all done: then they touch nothing more.
// Lane k keeps entry k's ballots of the touched pixels of the warp's
// kRows pixel blocks, and stores them to m[i kBatch + k] at the end.
template <bool kBG>
__device__ __forceinline__ void walk(Pixel<kBG> (&q)[kRows],
                                     const float4 (*F)[4], int nb,
                                     const Params& prm, Smem& sm, int pix0,
                                     unsigned* m) {
  const int lane = threadIdx.x & 31;
  unsigned r[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) r[i] = 0u;
  if (__all_sync(0xffffffffu, pixels_done(q, prm))) nb = 0;
  for (int k = 0; k < nb; ++k) {
    Alpha a[kRows];
    alpha_col(q, F[k], prm, a);
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const bool t =
          step<kBG>(q[i], a[i], F[k], prm, sm, pix0 + 4 * i * kTile, k);
      const unsigned v = __ballot_sync(0xffffffffu, t);
      if (lane == k) r[i] = v;
    }
  }
  if (lane < kBatch) {
#pragma unroll
    for (int i = 0; i < kRows; ++i) m[i * kBatch + lane] = r[i];
  }
#pragma unroll
  for (int i = 0; i < kRows; ++i)
    resolve_hit(q[i], F, prm, sm, pix0 + 4 * i * kTile);
}

// The pixel's channels that are not its hit's, to shared memory.
template <bool kBG>
__device__ __forceinline__ void flush(const Pixel<kBG>& q, int pix,
                                      const Params& prm, Smem& sm) {
  float* cs = &sm.col[pix * kNC];
  float* as = &sm.aux[pix * kNA];
  float c0 = q.c0 + q.end_T * prm.bg0;
  float c1 = q.c1 + q.end_T * prm.bg1;
  float c2 = q.c2 + q.end_T * prm.bg2;
  if (kBG && !q.crossed) {
    // the surface lies behind every entry of the tile
    c0 = c0 + cs[0] * q.T;
    c1 = c1 + cs[1] * q.T;
    c2 = c2 + cs[2] * q.T;
  }
  cs[0] = c0;
  cs[1] = c1;
  cs[2] = c2;
  as[1] = q.best_id;
  as[2] = fmaxf(q.best_w, 0.0f);
  as[4] = q.end_T;
  as[5] = q.wsum;
  as[6] = q.T;
}

template <bool kBG>
__global__ void __launch_bounds__(kThreads)
blend_fwd_kernel(const float* __restrict__ feats, long long L,
                 const long long* __restrict__ tile_offsets,
                 const long long* __restrict__ tile_counts,
                 const long long* __restrict__ tile_order, int n_tiles,
                 int tw,
                 const float* __restrict__ scal, Params prm,
                 const float* __restrict__ bgt,
                 float* __restrict__ color, float* __restrict__ aux,
                 int* __restrict__ nt) {
  __shared__ __align__(16) Smem sm;

  const long long t = tile_order ? tile_order[blockIdx.x] : blockIdx.x;
  if (t < 0 || t >= n_tiles) return;
  const int p = threadIdx.x;
  const int lane = p & 31;
  const int warp = p >> 5;
  // a warp's pixels are an 8 x 8 block of the tile, a thread's two pixels
  // one column of it four rows apart: the same lane of the block's upper
  // and lower 8 x 4 halves
  const int pix0 = ((warp >> 1) * 4 * kRows + (lane >> 3)) * kTile +
                   (warp & 1) * 8 + (lane & 7);
  Pixel<kBG> q[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
    init_pixel(q[i], pix0 + 4 * i * kTile, t, tw, scal, bgt, sm);

  // the tile's entries [beg, beg + n), kBatch a batch
  const long long beg = tile_offsets[t];
  const int n = (int)tile_counts[t];
  const int n_bat = (n + kBatch - 1) / kBatch;
  auto stage = [&](int i) {
    const int rel0 = i * kBatch;
    const int nb = min(kBatch, n - rel0);
    float(*dst)[4][4] = reinterpret_cast<float(*)[4][4]>(sm.f[i % kFeatBufs]);
    for (int x = p; x < kNF * kBatch; x += kThreads) {
      const int r = x / kBatch, e = x % kBatch;
      if (e < nb)
        cp_async4(&dst[e][r >> 2][r & 3], feats + r * L + beg + rel0 + e);
    }
    cp_async_commit();
  };

  if (n_bat > 0) {
    stage(0);
    cp_async_wait_all();
    __syncthreads();
  }
  for (int i = 0; i < n_bat; ++i) {
    const int rel0 = i * kBatch;
    const int nb = min(kBatch, n - rel0);
    if (i + 1 < n_bat) stage(i + 1);
    walk<kBG>(q, sm.f[i % kFeatBufs], nb, prm, sm, pix0,
              sm.touched[i & 1][kRows * warp]);
    cp_async_wait_all();
    // orders the buffers, and is the CTA's exit check
    const bool all_done =
        __syncthreads_count(pixels_done(q, prm)) == kThreads;
    if (p < nb) {
      int s = 0;
#pragma unroll
      for (int g = 0; g < kBlocks; ++g) s += __popc(sm.touched[i & 1][g][p]);
      nt[beg + rel0 + p] = s;
    }
    if (all_done) break;
  }

  // the pixels' other channels, then the tile's two blocks out as whole
  // lines
#pragma unroll
  for (int i = 0; i < kRows; ++i) flush(q[i], pix0 + 4 * i * kTile, prm, sm);
  __syncthreads();
  float4* gc = reinterpret_cast<float4*>(color + t * kPx * kNC);
  float4* ga = reinterpret_cast<float4*>(aux + t * kPx * kNA);
  const float4* sc = reinterpret_cast<const float4*>(sm.col);
  const float4* sa = reinterpret_cast<const float4*>(sm.aux);
#pragma unroll
  for (int x = p; x < kPx * kNC / 4; x += kThreads) gc[x] = sc[x];
#pragma unroll
  for (int x = p; x < kPx * kNA / 4; x += kThreads) ga[x] = sa[x];
}

template <bool kBG>
int launch(int n_tiles, cudaStream_t stream, const float* feats, long long L,
           const long long* tile_offsets, const long long* tile_counts,
           const long long* tile_order, int tw, const float* scal,
           Params prm, const float* bgt, float* color, float* aux, int* nt) {
  if (n_tiles <= 0) return 0;
  blend_fwd_kernel<kBG><<<n_tiles, kThreads, 0, stream>>>(
      feats, L, tile_offsets, tile_counts, tile_order, n_tiles, tw, scal, prm,
      bgt, color, aux, nt);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches on `stream` one CTA per tile, CTA i on tile tile_order[i] (on
// tile i where `tile_order` is null), the background variant where `bgt`
// is not null; `nt` must be zeroed by the caller. Returns the cudaError_t
// of the launch (0 = ok).
extern "C" int dqo_blend_fwd(const float* feats, long long L,
                             const long long* tile_offsets,
                             const long long* tile_counts,
                             const long long* tile_order, int n_tiles, int tw,
                             const float* scal,
                             float opaque_threshold, float depth_threshold,
                             float normal_threshold, float T_threshold,
                             float alpha_min, float alpha_max, float bg0,
                             float bg1, float bg2, const float* bgt,
                             float* color, float* aux, int* nt, void* stream) {
  Params prm{opaque_threshold, depth_threshold, normal_threshold, T_threshold,
             alpha_min, alpha_max, bg0, bg1, bg2};
  const cudaStream_t s = (cudaStream_t)stream;
  if (bgt != nullptr)
    return launch<true>(n_tiles, s, feats, L, tile_offsets, tile_counts,
                        tile_order, tw, scal, prm, bgt, color, aux, nt);
  return launch<false>(n_tiles, s, feats, L, tile_offsets, tile_counts,
                       tile_order, tw, scal, prm, bgt, color, aux, nt);
}

extern "C" const char* dqo_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
