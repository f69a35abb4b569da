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
// Each term is the plain version's (ops/blend.py::blend_bwd_ref) in its
// float operations and order (built with -fmad=false); only the order of
// the sums over a tile's pixels differs.
//
// The design:
//   - Grid: one CTA per tile, one thread per pixel, a warp's 32 an 8 x 4
//     block of the tile. The CTA walks the tile's live entries serially,
//     carrying each pixel's state in registers where the TPU kernel
//     carried it in scratch across its sequential grid steps (one per
//     align-sized entry block), and leaves once every pixel is done, since
//     the rows after that are 0. The tiles launch in the binning's
//     tile_order, most entries first, so the crowded tiles do not start
//     last. In the scenes measured so far no tile outgrows one align
//     block (chip_smoke.py's tile_entries), so the TPU's per-block grid
//     would split nothing.
//   - Entries are staged kBatch at a time, feature-major rows to
//     entry-major float4s in shared memory, by cp.async into a ring of
//     three buffers: batch i + 1 loads while batch i is walked.
//   - Phase A: each thread walks its pixel through the batch, the part of
//     each pair that does not depend on the walk's state (exp, alpha, the
//     colour dot) two entries at a time, and writes per (entry, pixel) gl
//     = op dL G, G dL and w (0 where the pair has no term) to shared
//     memory, and at its hit the five hit terms and the hit's index in
//     the tile. A per-thread bit mask of the entries it has a term for,
//     OR-reduced once per warp and batch, tells which (entry, warp's 8 x 4
//     pixels) groups hold anything.
//   - Phase B: the eight warps take the batch's entries in turn. For its
//     entry a warp's lanes walk the touched pixel groups, recompute dx
//     and dy from the pixel and the staged entry, and sum the 9 alpha rows
//     and the 5 hit rows in registers; one 16-row reduce-scatter across
//     the warp (16 shuffles in place of 14 five-level trees, 70) leaves
//     each row on two lanes, which write it. An entry no pixel has a term
//     for costs nothing, and its rows keep the caller's zeros.
//   - The term buffers are double-buffered, so one barrier per batch
//     orders phase A, phase B and the next batch's loads.
//   - kBatch = 8: 68 KB of shared memory and 80 registers a thread hold
//     three CTAs an SM; with 16 entries a batch the term buffers alone
//     take 96 KB, and only one or two fit.
//   - No tensor cores: the row sums are not a plain matrix product, since
//     dx = x_k - px depends on both the entry and the pixel; the moment
//     form that makes them one changes the float operations and would
//     need 3xTF32 to hold float32 accuracy, at about 10 columns.
//
// What bounds it: the card's bound is the bytes (64 in and 56 out per
// live entry, 48 in per pixel, 68 with the background; chip_smoke.py
// works out both bounds from its run), but the kernel runs several times
// above it, on instruction throughput: per (pixel, entry) pair walked an exp,
// two divisions and about 60 other float operations, some 100 machine
// instructions a warp wherever one of its lanes contributes, and phase A,
// which executes them, takes most of the time. The per-entry shuffle
// reductions of the earlier design (every warp reducing all 14 rows of
// every entry) were a smaller share than they looked. The most crowded
// tile's CTA alone takes a large part of the keyframe call's time
// (chip_smoke.py's crowded_tile_ms).

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;
constexpr int kPx = kTile * kTile;   // threads per CTA, one per pixel
constexpr int kBatch = 8;            // entries staged per round
constexpr int kNF = 16;              // feature rows
constexpr int kWarps = kPx / 32;     // also phase B's 32-pixel groups
constexpr int kNC = 8;               // colour-block channels
constexpr int kNA = 8;               // aux channels
constexpr int kNB = 8;               // background channels: S rgb, D, tau
constexpr int kUnroll = 2;           // entries whose alpha is computed at once
constexpr int kFeatBufs = 3;
constexpr int kMinBlocks = 3;        // CTAs an SM: 80 registers a thread
static_assert(kBatch >= 1 && kBatch <= 32, "the entry masks are 32 bits");

struct Params {
  float opaque_threshold, depth_threshold, normal_threshold, T_threshold;
  float alpha_min, alpha_max;
  float bg0, bg1, bg2;
};

struct Smem {
  float4 f[kFeatBufs][kBatch][4];   // entry features, entry-major
  float2 gg[2][kBatch][kPx];        // per (entry, pixel): gl, G dL
  float w[2][kBatch][kPx];          // per (entry, pixel): w
  unsigned mask[2][kWarps];         // per warp: bit k, entry k has a term
  float4 d[kPx];                    // the pixel's rgb cotangent
  float4 ray[kPx];                  // its unit ray and depth cotangent
  float4 dn[kPx];                   // its normal cotangent
  float hit[5][kPx];                // the pixel's hit terms
  int hit_at[kPx];                  // the hit's index in the tile, or -1
};

// A pixel's walk: what its steps read (the hit's ray and cotangents stay
// in shared memory, read once) and its state.
template <bool kBG>
struct Pixel {
  float px, py, d0, d1, d2;
  float hid, dot_total, eb;         // eb = end_T (bg . d)
  float sdot, bgD, tau;             // background: S . d, D, tau
  float T, prefix, T_front;
  int crossed, pending, done;       // flags, 0 or 1
};

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

// What an entry gives a pixel before the walk's state enters: the part of
// each (pixel, entry) pair that does not depend on the entries before it,
// so that the walk can compute it for several entries at once.
struct Alpha {
  float G, alpha, one_m, cd, op;
  bool skip, behind;
};

template <bool kBG>
__device__ __forceinline__ Alpha alpha_of(const Pixel<kBG>& q,
                                          const float4* f,
                                          const Params& prm) {
  const float4 f0 = f[0];   // x, y, conic a, b
  const float4 f1 = f[1];   // conic c, opacity, r, g
  const float4 f2 = f[2];   // b, depth, n0, n1
  const float dx = f0.x - q.px;
  const float dy = f0.y - q.py;
  const float ca = f0.z, cb = f0.w, cc = f1.x;
  Alpha a;
  a.op = f1.y;
  const float power = -0.5f * (ca * dx * dx + cc * dy * dy) - cb * dx * dy;
  a.G = expf(power);
  const float alpha_raw = fminf(a.op * a.G, prm.alpha_max);
  a.skip = (power > 0.0f) || (alpha_raw < prm.alpha_min);
  a.alpha = a.skip ? 0.0f : alpha_raw;
  a.one_m = 1.0f - a.alpha;
  a.cd = f1.z * q.d0 + f1.w * q.d1 + f2.x * q.d2;
  a.behind = kBG && (a.op != 0.0f) && (f2.y > q.bgD);
  return a;
}

// One entry of the pixel's walk, in the forward's float operations and
// order, from its `alpha_of`, and the entry's terms at this pixel: gl, gd,
// w of the alpha rows where it contributes, and the five hit terms h where
// it is the pixel's hit (`routed`). Returns whether it has a term here.
template <bool kBG>
__device__ __forceinline__ bool step(Pixel<kBG>& q, const Alpha& a,
                                     const float4* f, const Params& prm,
                                     const Smem& sm, int p, float& gl,
                                     float& gd, float& wo, float* h,
                                     bool& routed) {
  if (q.done) return false;
  bool any = false;
  if (q.pending) {
    const float4 f2 = f[2];   // b, depth, n0, n1
    const float4 f3 = f[3];   // n2, scale_max, id, ndm
    if (f3.z == q.hid) {
      // the pixel's hit: depth and normal cotangents
      const float4 ray = sm.ray[p], dn = sm.dn[p];
      const float rx = ray.x, ry = ray.y, rz = ray.z, d3 = ray.w;
      const float n0 = f2.z, n1 = f2.w, n2 = f3.x;
      const float ndm = f3.w;
      const float ndr = n0 * rx + n1 * ry + n2 * rz;
      const float hz = ndm / (ndr + 1e-8f) * rz;
      const bool plane_ok =
          (fabsf(hz - f2.y) <= f3.y * prm.depth_threshold) &&
          (fabsf(ndr) >= prm.normal_threshold);
      const float inv = 1.0f / (ndr + 1e-8f);
      const float dd_plane = plane_ok ? d3 : 0.0f;
      const float d_ndr = dd_plane * (-ndm * inv * inv) * rz;
      h[0] = d3 - dd_plane;
      h[1] = d_ndr * rx + dn.x;
      h[2] = d_ndr * ry + dn.y;
      h[3] = d_ndr * rz + dn.z;
      h[4] = dd_plane * inv * rz;
      routed = true;
      any = true;
      q.pending = 0;
    }
  }
  if (q.T >= prm.T_threshold) {
    const float test_T = q.T * a.one_m;
    const bool contrib = (!a.skip) && (test_T >= prm.T_threshold);
    float w = contrib ? a.alpha * q.T : 0.0f;
    float tfac = 1.0f;
    if (kBG) {
      if (a.behind) tfac = (test_T * q.tau < prm.T_threshold) ? 0.0f : q.tau;
      w = w * tfac;
      if (a.behind && !q.crossed) {
        q.prefix = q.prefix + q.sdot * q.T_front;
        q.crossed = 1;
      }
      if (!a.behind) q.T_front = q.T_front * a.one_m;
    }
    q.prefix = q.prefix + w * a.cd;
    if (contrib) {
      const float suffix = q.dot_total - q.prefix;
      const float dL = a.cd * q.T * tfac - suffix / a.one_m - q.eb / a.one_m;
      gl = a.op * dL * a.G;
      gd = a.G * dL;
      wo = w;
      any = true;
    }
    q.T = test_T;
  }
  q.done = (q.T < prm.T_threshold) && !q.pending;
  return any;
}

// Walks the pixel through entries [0, nb) of a staged batch, kUnroll at a
// time: first the state-free part of each, then the serial steps. Writes
// each (entry, pixel) pair's terms to term buffer `sb` and the hit's terms
// where it meets the pixel's hit, and returns the mask of the entries that
// have a term at this pixel.
template <bool kBG>
__device__ __forceinline__ unsigned walk(Pixel<kBG>& q,
                                         const float4 (*F)[4], int nb,
                                         const Params& prm, Smem& sm, int sb,
                                         int p, int rel0) {
  // a warp whose pixels are all done has no term: phase B skips its group
  if (__all_sync(0xffffffffu, q.done)) return 0;
  unsigned touched = 0;
  float2* gg = &sm.gg[sb][0][p];   // this pixel's terms, entry k at k kPx
  float* ww = &sm.w[sb][0][p];
  for (int k0 = 0; k0 < nb; k0 += kUnroll) {
    Alpha a[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      a[u] = alpha_of(q, F[min(k0 + u, nb - 1)], prm);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int k = k0 + u;
      if (k >= nb) break;
      float gl = 0.0f, gd = 0.0f, w = 0.0f, h[5];
      bool routed = false;
      const bool any =
          step<kBG>(q, a[u], F[k], prm, sm, p, gl, gd, w, h, routed);
      if (routed) {
#pragma unroll
        for (int r = 0; r < 5; ++r) sm.hit[r][p] = h[r];
        sm.hit_at[p] = rel0 + k;
      }
      gg[k * kPx] = make_float2(gl, gd);
      ww[k * kPx] = w;
      touched |= (unsigned)any << k;
    }
  }
  return touched;
}

// One step of warp_sum16: a lane keeps the upper half of v[0..2 kHalf)
// where its bit of 2 kHalf is set, the lower half elsewhere, and adds the
// partner's copy of the half it keeps.
template <int kHalf>
__device__ __forceinline__ void reduce_half(float (&v)[16], int lane) {
  const bool up = lane & (2 * kHalf);
#pragma unroll
  for (int i = 0; i < kHalf; ++i) {
    const float send = up ? v[i] : v[i + kHalf];
    const float keep = up ? v[i + kHalf] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, 2 * kHalf);
  }
}

// Sums each of v[0..15] over the warp's lanes; lanes 2r and 2r + 1 return
// the sum of v[r]: 8 + 4 + 2 + 1 + 1 shuffles.
__device__ __forceinline__ float warp_sum16(float (&v)[16], int lane) {
  reduce_half<8>(v, lane);
  reduce_half<4>(v, lane);
  reduce_half<2>(v, lane);
  reduce_half<1>(v, lane);
  return v[0] + __shfl_xor_sync(0xffffffffu, v[0], 1);
}

template <bool kBG>
__global__ void __launch_bounds__(kPx, kMinBlocks)
blend_bwd_kernel(const float* __restrict__ feats, long long L,
                 const long long* __restrict__ tile_offsets,
                 const long long* __restrict__ tile_counts,
                 const long long* __restrict__ tile_order, int n_tiles,
                 int tw,
                 const float* __restrict__ scal, Params prm,
                 const float* __restrict__ bgt,
                 const float* __restrict__ dcolor,
                 const float* __restrict__ color,
                 const float* __restrict__ aux, float* __restrict__ dfeats) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);

  const long long t = tile_order ? tile_order[blockIdx.x] : blockIdx.x;
  if (t < 0 || t >= n_tiles) return;
  const long long beg = tile_offsets[t];
  const long long n = tile_counts[t];
  if (n <= 0) return;

  const int p = threadIdx.x;
  const int lane = p & 31;
  const int warp = p >> 5;
  const int tx = (int)(t % tw), ty = (int)(t / tw);

  // a warp's pixels are an 8 x 4 block of the tile, so that a splat's
  // footprint meets fewer warps than it would as rows of 16 x 2
  const int pc = (warp & 1) * 8 + (lane & 7);
  const int pr = (warp >> 1) * 4 + (lane >> 3);
  Pixel<kBG> q;
  q.px = (float)(tx * kTile + pc);
  q.py = (float)(ty * kTile + pr);
  const float fx = scal[0], fy = scal[1], cx = scal[2], cy = scal[3];
  float rx = (q.px - cx) / fx;
  float ry = (q.py - cy) / fy;
  const float nrm = sqrtf(rx * rx + ry * ry + 1.0f);
  rx = rx / nrm;
  ry = ry / nrm;
  const float rz = 1.0f / nrm;
  const long long o = t * kPx + pr * kTile + pc;
  const float4 dA = ldg4(dcolor + o * kNC), dB = ldg4(dcolor + o * kNC + 4);
  q.d0 = dA.x; q.d1 = dA.y; q.d2 = dA.z;
  sm.ray[p] = make_float4(rx, ry, rz, dA.w);
  sm.dn[p] = make_float4(dB.x, dB.y, dB.z, 0.0f);
  q.hid = __ldg(aux + o * kNA + 0);
  const float end_T = __ldg(aux + o * kNA + 4);
  const float4 col = ldg4(color + o * kNC);
  q.dot_total = (col.x - end_T * prm.bg0) * q.d0 +
                (col.y - end_T * prm.bg1) * q.d1 +
                (col.z - end_T * prm.bg2) * q.d2;
  q.eb = end_T * (q.d0 * prm.bg0 + q.d1 * prm.bg1 + q.d2 * prm.bg2);
  q.sdot = 0.0f; q.bgD = 0.0f; q.tau = 1.0f;
  if (kBG) {
    const float4 b = ldg4(bgt + o * kNB);
    q.sdot = b.x * q.d0 + b.y * q.d1 + b.z * q.d2;
    q.bgD = b.w;
    q.tau = __ldg(bgt + o * kNB + 4);
  }
  q.T = 1.0f; q.prefix = 0.0f; q.T_front = 1.0f;
  q.crossed = 0;
  q.pending = q.hid >= 0.0f;
  q.done = 0;
  sm.hit_at[p] = -1;
  sm.d[p] = make_float4(q.d0, q.d1, q.d2, 0.0f);

  // phase B's pixels, those of thread lane + 32 g: column and row within
  // its group's block
  const float bpx = (float)(tx * kTile + (lane & 7));
  const float bpy = (float)(ty * kTile + (lane >> 3));

  // the tile's entries [beg, beg + n), kBatch a batch
  const int n_bat = (int)((n + kBatch - 1) / kBatch);
  auto stage = [&](int i) {
    const int rel0 = i * kBatch;
    const int nb = (int)min((long long)kBatch, n - rel0);
    float(*dst)[4][4] = reinterpret_cast<float(*)[4][4]>(sm.f[i % kFeatBufs]);
    for (int x = p; x < kNF * kBatch; x += kPx) {
      const int r = x / kBatch, e = x % kBatch;
      if (e < nb)
        cp_async4(&dst[e][r >> 2][r & 3], feats + r * L + beg + rel0 + e);
    }
    cp_async_commit();
  };

  stage(0);
  cp_async_wait_all();
  __syncthreads();
  for (int i = 0; i < n_bat; ++i) {
    const int rel0 = i * kBatch;
    const int nb = (int)min((long long)kBatch, n - rel0);
    const long long b0 = beg + rel0;
    if (i + 1 < n_bat) stage(i + 1);
    const float4(*F)[4] = sm.f[i % kFeatBufs];

    // phase A: each pixel's terms of the batch's entries
    const int sb = i & 1;
    unsigned touched = walk<kBG>(q, F, nb, prm, sm, sb, p, rel0);
    touched = __reduce_or_sync(0xffffffffu, touched);
    if (lane == 0) sm.mask[sb][warp] = touched;
    cp_async_wait_all();
    const bool all_done = __syncthreads_count(q.done) == kPx;

    // phase B: one warp sums each touched entry's rows over the tile
    unsigned m[kWarps];
    unsigned m_any = 0;
#pragma unroll
    for (int g = 0; g < kWarps; ++g) {
      m[g] = sm.mask[sb][g];
      m_any |= m[g];
    }
    for (int k = warp; k < nb; k += kWarps) {
      if (!((m_any >> k) & 1u)) continue;
      const float4 f0 = F[k][0];
      const float ca = f0.z, cb = f0.w, cc = F[k][1].x;
      const int rel = rel0 + k;
      float acc[16];
#pragma unroll
      for (int r = 0; r < 16; ++r) acc[r] = 0.0f;
#pragma unroll
      for (int g = 0; g < kWarps; ++g) {
        if (!((m[g] >> k) & 1u)) continue;
        const int pp = lane + 32 * g;
        const float2 v = sm.gg[sb][k][pp];
        const float w = sm.w[sb][k][pp];
        const float4 d = sm.d[pp];
        const float dx = f0.x - (bpx + (float)((g & 1) * 8));
        const float dy = f0.y - (bpy + (float)((g >> 1) * 4));
        const float gl = v.x;
        acc[0] += gl * (-(ca * dx + cb * dy));
        acc[1] += gl * (-(cc * dy + cb * dx));
        acc[2] += gl * (-0.5f * dx * dx);
        acc[3] += gl * (-dx * dy);
        acc[4] += gl * (-0.5f * dy * dy);
        acc[5] += v.y;
        acc[6] += w * d.x;
        acc[7] += w * d.y;
        acc[8] += w * d.z;
        if (sm.hit_at[pp] == rel) {
#pragma unroll
          for (int r = 0; r < 5; ++r) acc[9 + r] += sm.hit[r][pp];
        }
      }
      const float s = warp_sum16(acc, lane);
      // rows 0..12 are feature rows 0..12, row 13 is feature row 15
      const int r = lane >> 1;
      if (!(lane & 1) && r < 14) dfeats[(r < 13 ? r : 15) * L + b0 + k] = s;
    }
    if (all_done) break;
  }
}

template <bool kBG>
int launch(int n_tiles, cudaStream_t stream, const float* feats,
           long long L, const long long* tile_offsets,
           const long long* tile_counts, const long long* tile_order, int tw,
           const float* scal, Params prm,
           const float* bgt, const float* dcolor, const float* color,
           const float* aux, float* dfeats) {
  // above 48 KB of shared memory a CTA must be allowed, once per device
  static bool allowed[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 64 && !allowed[dev]) {
    err = cudaFuncSetAttribute(blend_bwd_kernel<kBG>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)sizeof(Smem));
    if (err != cudaSuccess) return (int)err;
    allowed[dev] = true;
  }
  if (n_tiles <= 0) return 0;
  blend_bwd_kernel<kBG><<<n_tiles, kPx, sizeof(Smem), stream>>>(
      feats, L, tile_offsets, tile_counts, tile_order, n_tiles, tw, scal, prm,
      bgt, dcolor, color, aux, dfeats);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches on `stream` one CTA per tile, CTA i on tile tile_order[i] (on
// tile i where `tile_order` is null), the background variant where `bgt`
// is not null; `dfeats` must be zeroed by the caller. Returns the
// cudaError_t of the launch (0 = ok).
extern "C" int dqo_blend_bwd(const float* feats, long long L,
                             const long long* tile_offsets,
                             const long long* tile_counts,
                             const long long* tile_order, int n_tiles, int tw,
                             const float* scal,
                             float opaque_threshold, float depth_threshold,
                             float normal_threshold, float T_threshold,
                             float alpha_min, float alpha_max, float bg0,
                             float bg1, float bg2, const float* bgt,
                             const float* dcolor, const float* color,
                             const float* aux, float* dfeats, void* stream) {
  Params prm{opaque_threshold, depth_threshold, normal_threshold, T_threshold,
             alpha_min, alpha_max, bg0, bg1, bg2};
  const cudaStream_t s = (cudaStream_t)stream;
  if (bgt != nullptr)
    return launch<true>(n_tiles, s, feats, L, tile_offsets, tile_counts,
                        tile_order, tw, scal, prm, bgt, dcolor, color, aux,
                        dfeats);
  return launch<false>(n_tiles, s, feats, L, tile_offsets, tile_counts,
                       tile_order, tw, scal, prm, bgt, dcolor, color, aux,
                       dfeats);
}

extern "C" const char* dqo_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
