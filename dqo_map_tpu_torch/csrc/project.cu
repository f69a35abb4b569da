// K4: the render's per-Gaussian chain for Hopper (sm_90a), forward and
// backward: the activations of the map's leaves, the SH colours, the EWA
// projection (ops/projection.py::preprocess) and the blend's (16, L) entry
// pack (ops/blend.py::gather_entry_feats), bound in ops/project_cuda.py.
//
// Replaces no TPU kernel: the JAX package leaves this chain to XLA
// (dqo_map_tpu/ops/projection.py::preprocess, dqo_map_tpu/utils/sh.py::
// eval_sh, dqo_map_tpu/ops/blend.py::gather_entry_feats), which fuses it.
// It was added because the port's plain version is ~420 small elementwise
// kernels a render and ~800 more in its autograd backward (an index_add_
// among them), about 90% of an optimize step's ~1,370 launches on one
// H100: the host's launches set the pace of every step, and of every
// capture and replay of the scans' CUDA graphs.
//
// Three kernels:
//   - project_fwd_kernel, one thread a Gaussian row: reads xyz, the scales,
//     the quaternion and the opacity (the stored leaves, activated here by
//     exp, normalise and sigmoid, or already activated), the SH (P, 16, 3)
//     evaluated at a degree or colours (P, 3), the subset's mask and the
//     camera; writes a (22, P) table: rows 0:16 the entry features in
//     blend.py's layout (xy, conic, opacity, rgb, depth, normal_c,
//     scale_max, id, ndm), 16 radius, 17:19 ext, 19:22 mean_c, and valid;
//   - project_pack_kernel, one thread an entry: the table's rows 0:16 at
//     the entry's Gaussian, opacity 0 on padding entries;
//   - project_bwd_kernel, one thread a Gaussian row: the sum of K2's
//     dfeats over the Gaussian's entries, found through the binning's
//     (R, P) cell -> entry table (a segment sum in cell order: no atomics,
//     no sort, deterministic), then the chain rule in registers back to
//     the leaves, the forward's intermediates recomputed.
//
// The geometry is the plain preprocess's float32 operations in its order
// (the library is built with -fmad=false, IEEE division and sqrt), so that
// the binning sees the same floats; the quaternion's norm adds its squares
// as the card's torch.linalg.norm does over a row of four. The colours add
// the SH terms in order and may differ from torch.sum's order by rounding.
// The backward is ops/projection.py::project_bwd_ref line for line; rows 13
// (scale_max) and 14 (id) of dfeats are taken as 0, as K2 writes them.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kNF = 16;      // entry feature rows
constexpr int kShRows = 16;  // SH coefficient rows a Gaussian stores

// sh.py's constants, double literals rounded to float as torch rounds a
// Python float scalar
__device__ __forceinline__ float C0() { return (float)0.28209479177387814; }
__device__ __forceinline__ float C1() { return (float)0.4886025119029199; }
__device__ __forceinline__ float C2(int i) {
  const double c[5] = {1.0925484305920792, -1.0925484305920792,
                       0.31539156525252005, -1.0925484305920792,
                       0.5462742152960396};
  return (float)c[i];
}
__device__ __forceinline__ float C3(int i) {
  const double c[7] = {-0.5900435899266435, 2.890611442640554,
                       -0.4570457994644658, 0.3731763325901154,
                       -0.4570457994644658, 1.445305721320277,
                       -0.5900435899266435};
  return (float)c[i];
}

// torch's NaN-propagating clamp, minimum and maximum
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}
__device__ __forceinline__ float clamp2(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}
__device__ __forceinline__ float tmin(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fminf(a, b));
}
__device__ __forceinline__ float tmax(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fmaxf(a, b));
}

struct Cam {
  float W[16];   // w2c, row-major
  float M[16];   // full_proj, row-major
  float fx, fy, cx, cy;
  float cp[3];   // camera centre (the SH view direction's origin)
};

__device__ __forceinline__ void load_cam(Cam& c, const float* w2c,
                                         const float* proj, const float* K,
                                         const float* cam_pos) {
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    c.W[i] = __ldg(w2c + i);
    c.M[i] = __ldg(proj + i);
  }
  c.fx = __ldg(K + 0);
  c.fy = __ldg(K + 4);
  c.cx = __ldg(K + 2);
  c.cy = __ldg(K + 5);
  if (cam_pos != nullptr) {
#pragma unroll
    for (int i = 0; i < 3; ++i) c.cp[i] = __ldg(cam_pos + i);
  }
}

struct Args {
  float limx, limy;         // 1.3 x the half-FoV tangents, float32
  float color_sigma, scale_modifier;
  int width, height;
  int activate;             // the leaves as stored: exp, normalise, sigmoid
  int sh_degree;            // colours from the SH at this degree; -1: rgb
};

// Everything the forward computes that the backward reads again.
struct Geo {
  float s[3];         // activated scales
  float q[4];         // normalised quaternion w, x, y, z
  float qraw[4], qn;  // the quaternion as given and its norm (activate)
  float R[3][3];      // R(q), R[i][j]
  float ss[3];        // (s * modifier)^2
  float tx, ty, tz;   // camera-frame centre
  float phx, phy, pw, ndcx, ndcy;
  float tzs, ux, uy, txl, tyl, invz, invz2;
  float T0[3], T1[3];
  float sxx, sxy, sxz, syy, syz, szz;
  float s0[3], s1[3];
  float a, b, c, det;
  bool det_ok, in_frustum;
  int m;              // the smallest scale's axis
  float nw[3], nc[3];
};

__device__ __forceinline__ float xform(const float* M, int r, float x,
                                       float y, float z) {
  return M[4 * r] * x + M[4 * r + 1] * y + M[4 * r + 2] * z + M[4 * r + 3];
}

__device__ void project_one(Geo& g, const Cam& cam, const Args& a,
                            const float* xyz, const float* scl,
                            const float* rot) {
  const float mx = xyz[0], my = xyz[1], mz = xyz[2];
  if (a.activate) {
#pragma unroll
    for (int k = 0; k < 3; ++k) g.s[k] = expf(scl[k]);
#pragma unroll
    for (int k = 0; k < 4; ++k) g.qraw[k] = rot[k];
    // torch.linalg.norm over a row of four on the card: four lanes, one
    // square each, folded at offset 2, then 1
    g.qn = sqrtf((g.qraw[0] * g.qraw[0] + g.qraw[2] * g.qraw[2])
                 + (g.qraw[1] * g.qraw[1] + g.qraw[3] * g.qraw[3]));
    const float d = g.qn + 1e-8f;
#pragma unroll
    for (int k = 0; k < 4; ++k) g.q[k] = g.qraw[k] / d;
  } else {
#pragma unroll
    for (int k = 0; k < 3; ++k) g.s[k] = scl[k];
#pragma unroll
    for (int k = 0; k < 4; ++k) g.q[k] = g.qraw[k] = rot[k];
    g.qn = 0.0f;
  }
  const float* W = cam.W;
  g.tx = xform(W, 0, mx, my, mz);
  g.ty = xform(W, 1, mx, my, mz);
  g.tz = xform(W, 2, mx, my, mz);
  g.phx = xform(cam.M, 0, mx, my, mz);
  g.phy = xform(cam.M, 1, mx, my, mz);
  const float pw4 = xform(cam.M, 3, mx, my, mz);
  g.pw = 1.0f / (pw4 + 1e-7f);
  g.ndcx = g.phx * g.pw;
  g.ndcy = g.phy * g.pw;
  g.in_frustum = (g.tz > 0.2f) && (fabsf(g.ndcx) <= 1.3f)
                 && (fabsf(g.ndcy) <= 1.3f);

  // R(q) of projection.py::_rot_cols
  const float w = g.q[0], x = g.q[1], y = g.q[2], z = g.q[3];
  g.R[0][0] = 1.0f - 2.0f * (y * y + z * z);
  g.R[0][1] = 2.0f * (x * y - w * z);
  g.R[0][2] = 2.0f * (x * z + w * y);
  g.R[1][0] = 2.0f * (x * y + w * z);
  g.R[1][1] = 1.0f - 2.0f * (x * x + z * z);
  g.R[1][2] = 2.0f * (y * z - w * x);
  g.R[2][0] = 2.0f * (x * z - w * y);
  g.R[2][1] = 2.0f * (y * z + w * x);
  g.R[2][2] = 1.0f - 2.0f * (x * x + y * y);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float sm = g.s[k] * a.scale_modifier;
    g.ss[k] = sm * sm;
  }
#define DQO_SIG(i, j)                                                      \
  (g.R[i][0] * g.ss[0] * g.R[j][0] + g.R[i][1] * g.ss[1] * g.R[j][1]       \
   + g.R[i][2] * g.ss[2] * g.R[j][2])
  g.sxx = DQO_SIG(0, 0);
  g.sxy = DQO_SIG(0, 1);
  g.sxz = DQO_SIG(0, 2);
  g.syy = DQO_SIG(1, 1);
  g.syz = DQO_SIG(1, 2);
  g.szz = DQO_SIG(2, 2);
#undef DQO_SIG

  // EWA with the view point clamped to 1.3x the FoV
  g.tzs = (g.tz == 0.0f) ? 1e-6f : g.tz;
  g.ux = g.tx / g.tzs;
  g.uy = g.ty / g.tzs;
  g.txl = clamp2(g.ux, -a.limx, a.limx) * g.tz;
  g.tyl = clamp2(g.uy, -a.limy, a.limy) * g.tz;
  g.invz = 1.0f / g.tzs;
  g.invz2 = g.invz * g.invz;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    g.T0[j] = cam.fx * g.invz * W[j] - cam.fx * g.txl * g.invz2 * W[8 + j];
    g.T1[j] = cam.fy * g.invz * W[4 + j] - cam.fy * g.tyl * g.invz2 * W[8 + j];
  }
  g.s0[0] = g.sxx * g.T0[0] + g.sxy * g.T0[1] + g.sxz * g.T0[2];
  g.s0[1] = g.sxy * g.T0[0] + g.syy * g.T0[1] + g.syz * g.T0[2];
  g.s0[2] = g.sxz * g.T0[0] + g.syz * g.T0[1] + g.szz * g.T0[2];
  g.a = g.T0[0] * g.s0[0] + g.T0[1] * g.s0[1] + g.T0[2] * g.s0[2] + 0.3f;
  g.b = g.T1[0] * g.s0[0] + g.T1[1] * g.s0[1] + g.T1[2] * g.s0[2];
  g.s1[0] = g.sxx * g.T1[0] + g.sxy * g.T1[1] + g.sxz * g.T1[2];
  g.s1[1] = g.sxy * g.T1[0] + g.syy * g.T1[1] + g.syz * g.T1[2];
  g.s1[2] = g.sxz * g.T1[0] + g.syz * g.T1[1] + g.szz * g.T1[2];
  g.c = g.T1[0] * g.s1[0] + g.T1[1] * g.s1[1] + g.T1[2] * g.s1[2] + 0.3f;
  g.det = g.a * g.c - g.b * g.b;
  g.det_ok = g.det != 0.0f;

  // the splat normal: the smallest scale's axis, ties to the lower axis
  const bool m0 = (g.s[0] <= g.s[1]) && (g.s[0] <= g.s[2]);
  const bool m1 = (!m0) && (g.s[1] <= g.s[2]);
  g.m = m0 ? 0 : (m1 ? 1 : 2);
#pragma unroll
  for (int i = 0; i < 3; ++i) g.nw[i] = g.R[i][g.m];
#pragma unroll
  for (int r = 0; r < 3; ++r)
    g.nc[r] = W[4 * r] * g.nw[0] + W[4 * r + 1] * g.nw[1]
              + W[4 * r + 2] * g.nw[2];
}

// sh.py::sh_basis, the signs folded in
__device__ __forceinline__ void sh_basis(int deg, float x, float y, float z,
                                         float* b) {
  b[0] = C0() * 1.0f;
  if (deg > 0) {
    b[1] = (-C1()) * y;
    b[2] = C1() * z;
    b[3] = (-C1()) * x;
    if (deg > 1) {
      const float xx = x * x, yy = y * y, zz = z * z;
      const float xy = x * y, yz = y * z, xz = x * z;
      b[4] = C2(0) * xy;
      b[5] = C2(1) * yz;
      b[6] = C2(2) * (2.0f * zz - xx - yy);
      b[7] = C2(3) * xz;
      b[8] = C2(4) * (xx - yy);
      if (deg > 2) {
        b[9] = C3(0) * y * (3.0f * xx - yy);
        b[10] = C3(1) * xy * z;
        b[11] = C3(2) * y * (4.0f * zz - xx - yy);
        b[12] = C3(3) * z * (2.0f * zz - 3.0f * xx - 3.0f * yy);
        b[13] = C3(4) * x * (4.0f * zz - xx - yy);
        b[14] = C3(5) * z * (xx - yy);
        b[15] = C3(6) * x * (xx - 3.0f * yy);
      }
    }
  }
}

// the unit view direction of rasterize.py::eval_colors: the card's
// torch.linalg.norm over a row of three adds elements 0 and 2, then 1
__device__ __forceinline__ void view_dir(const Cam& cam, const float* xyz,
                                         float* d, float* u, float& n) {
#pragma unroll
  for (int i = 0; i < 3; ++i) d[i] = xyz[i] - cam.cp[i];
  n = sqrtf((d[0] * d[0] + d[2] * d[2]) + d[1] * d[1]);
  const float dn = n + 1e-12f;
#pragma unroll
  for (int i = 0; i < 3; ++i) u[i] = d[i] / dn;
}

__global__ void __launch_bounds__(kThreads)
project_fwd_kernel(int P, const float* __restrict__ xyz,
                   const float* __restrict__ scl,
                   const float* __restrict__ rot,
                   const float* __restrict__ opac,
                   const float* __restrict__ col,
                   const unsigned char* __restrict__ mask,
                   const float* __restrict__ w2c,
                   const float* __restrict__ proj,
                   const float* __restrict__ K,
                   const float* __restrict__ cam_pos, Args a,
                   float* __restrict__ table,
                   unsigned char* __restrict__ valid_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= P) return;
  Cam cam;
  load_cam(cam, w2c, proj, K, cam_pos);
  float p[3], s[3], q[4];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    p[k] = xyz[3 * i + k];
    s[k] = scl[3 * i + k];
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) q[k] = rot[4 * i + k];
  Geo g;
  project_one(g, cam, a, p, s, q);

  const float dets = g.det_ok ? g.det : 1.0f;
  const float mid = 0.5f * (g.a + g.c);
  const float lambda1 = mid + sqrtf(clamp_min(mid * mid - g.det, 0.1f));
  const float radius = ceilf(a.color_sigma * sqrtf(lambda1));
  const float tau2 = (float)(2.0 * 5.5413);
  const float ex = tmin(sqrtf(tau2 * clamp_min(g.a, 0.0f)), radius);
  const float ey = tmin(sqrtf(tau2 * clamp_min(g.c, 0.0f)), radius);
  const bool ok = g.in_frustum && g.det_ok;
  const bool valid = ok && (mask == nullptr || mask[i] != 0);

  float rgb[3] = {0.0f, 0.0f, 0.0f};
  if (col != nullptr) {
    if (a.sh_degree >= 0) {
      float d[3], u[3], n;
      view_dir(cam, p, d, u, n);
      float b[kShRows];
      sh_basis(a.sh_degree, u[0], u[1], u[2], b);
      const int nk = (a.sh_degree + 1) * (a.sh_degree + 1);
      const float* sh = col + (size_t)i * kShRows * 3;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        float acc = b[0] * sh[c];
        for (int k = 1; k < nk; ++k) acc = acc + b[k] * sh[3 * k + c];
        rgb[c] = tmax(acc + 0.5f, 0.0f);
      }
    } else {
#pragma unroll
      for (int c = 0; c < 3; ++c) rgb[c] = col[3 * i + c];
    }
  }
  float op = 0.0f;
  if (opac != nullptr) {
    op = opac[i];
    if (a.activate) op = 1.0f / (1.0f + expf(-op));
  }
  const size_t n = (size_t)P;
  float* t = table + i;
  t[0 * n] = g.ndcx * (float)a.width * 0.5f + cam.cx;
  t[1 * n] = g.ndcy * (float)a.height * 0.5f + cam.cy;
  t[2 * n] = g.c / dets;
  t[3 * n] = -g.b / dets;
  t[4 * n] = g.a / dets;
  t[5 * n] = op;
  t[6 * n] = rgb[0];
  t[7 * n] = rgb[1];
  t[8 * n] = rgb[2];
  t[9 * n] = g.tz;
  t[10 * n] = g.nc[0];
  t[11 * n] = g.nc[1];
  t[12 * n] = g.nc[2];
  t[13 * n] = tmax(tmax(g.s[0], g.s[1]), g.s[2]) * a.scale_modifier;
  t[14 * n] = (float)i;
  t[15 * n] = g.tx * g.nc[0] + g.ty * g.nc[1] + g.tz * g.nc[2];
  t[16 * n] = valid ? radius : 0.0f;
  t[17 * n] = ok ? ex : 0.0f;
  t[18 * n] = ok ? ey : 0.0f;
  t[19 * n] = g.tx;
  t[20 * n] = g.ty;
  t[21 * n] = g.tz;
  valid_out[i] = valid ? 1 : 0;
}

__global__ void __launch_bounds__(kThreads)
project_pack_kernel(long long L, int P, const float* __restrict__ table,
                    const long long* __restrict__ point_list,
                    const unsigned char* __restrict__ entry_valid,
                    float* __restrict__ feats) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= L) return;
  const long long gi = point_list[e];
  const size_t n = (size_t)P;
#pragma unroll
  for (int r = 0; r < kNF; ++r) {
    float v = __ldg(table + r * n + gi);
    if (r == 5 && !entry_valid[e]) v = 0.0f;
    feats[r * L + e] = v;
  }
}

__global__ void __launch_bounds__(kThreads)
project_bwd_kernel(int P, int R, long long L, const float* __restrict__ dfeats,
                   const int* __restrict__ cell_entry,
                   const float* __restrict__ xyz,
                   const float* __restrict__ scl,
                   const float* __restrict__ rot,
                   const float* __restrict__ opac,
                   const float* __restrict__ col,
                   const float* __restrict__ w2c,
                   const float* __restrict__ proj,
                   const float* __restrict__ K,
                   const float* __restrict__ cam_pos, Args a,
                   float* __restrict__ d_xyz, float* __restrict__ d_scl,
                   float* __restrict__ d_rot, float* __restrict__ d_opac,
                   float* __restrict__ d_col) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= P) return;
  const int col_len = a.sh_degree >= 0 ? kShRows * 3 : 3;

  // the segment sum: the Gaussian's entries in cell order
  float gs[kNF];
#pragma unroll
  for (int r = 0; r < kNF; ++r) gs[r] = 0.0f;
  int hits = 0;
  for (int j = 0; j < R; ++j) {
    const int e = __ldg(cell_entry + (size_t)j * P + i);
    if (e < 0) continue;
    ++hits;
#pragma unroll
    for (int r = 0; r < kNF; ++r) {
      if (r == 13 || r == 14) continue;
      gs[r] += __ldg(dfeats + r * L + e);
    }
  }
  if (hits == 0) {
    // no entry of this row reached the blend: nothing to it
    if (d_xyz) for (int k = 0; k < 3; ++k) d_xyz[3 * i + k] = 0.0f;
    if (d_scl) for (int k = 0; k < 3; ++k) d_scl[3 * i + k] = 0.0f;
    if (d_rot) for (int k = 0; k < 4; ++k) d_rot[4 * i + k] = 0.0f;
    if (d_opac) d_opac[i] = 0.0f;
    if (d_col)
      for (int k = 0; k < col_len; ++k) d_col[(size_t)i * col_len + k] = 0.0f;
    return;
  }

  Cam cam;
  load_cam(cam, w2c, proj, K, cam_pos);
  float p[3], s[3], q[4];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    p[k] = xyz[3 * i + k];
    s[k] = scl[3 * i + k];
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) q[k] = rot[4 * i + k];
  Geo g;
  project_one(g, cam, a, p, s, q);
  const float* W = cam.W;
  const float* M = cam.M;

  // ndm = mean_c . normal_c, depth = tz, normal_c = W3 n_w
  float dtx = gs[15] * g.nc[0];
  float dty = gs[15] * g.nc[1];
  float dtz = gs[15] * g.nc[2] + gs[9];
  float dnc[3];
  dnc[0] = gs[10] + gs[15] * g.tx;
  dnc[1] = gs[11] + gs[15] * g.ty;
  dnc[2] = gs[12] + gs[15] * g.tz;
  float dR[3][3];
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int k = 0; k < 3; ++k) dR[r][k] = 0.0f;
#pragma unroll
  for (int r = 0; r < 3; ++r)
    dR[r][g.m] = W[r] * dnc[0] + W[4 + r] * dnc[1] + W[8 + r] * dnc[2];

  // xy = ndc * size * 0.5 + c, ndc = ph * pw, pw = 1 / (pw4 + 1e-7)
  const float dndcx = gs[0] * 0.5f * (float)a.width;
  const float dndcy = gs[1] * 0.5f * (float)a.height;
  const float dphx = dndcx * g.pw;
  const float dphy = dndcy * g.pw;
  const float dpw = dndcx * g.phx + dndcy * g.phy;
  const float dpw4 = -dpw * (g.pw * g.pw);

  // conic = (c, -b, a) / det where det != 0, else (c, -b, a)
  float da, db, dc;
  if (g.det_ok) {
    const float det2 = g.det * g.det;
    const float ddet = -(gs[2] * g.c + gs[3] * (-g.b) + gs[4] * g.a) / det2;
    da = gs[4] / g.det + ddet * g.c;
    dc = gs[2] / g.det + ddet * g.a;
    db = -gs[3] / g.det - 2.0f * g.b * ddet;
  } else {
    da = gs[4];
    dc = gs[2];
    db = -gs[3];
  }

  // a = T0' S T0 + 0.3, b = T1' S T0, c = T1' S T1 + 0.3
  float dT0[3], dT1[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    dT0[j] = 2.0f * da * g.s0[j] + db * g.s1[j];
    dT1[j] = db * g.s0[j] + 2.0f * dc * g.s1[j];
  }
  // dS over the six stored components (an off-diagonal one twice)
  float dS[3][3];
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int k = 0; k < 3; ++k)
      dS[r][k] = da * g.T0[r] * g.T0[k] + db * g.T1[r] * g.T0[k]
                 + dc * g.T1[r] * g.T1[k];

  // T0j = fx invz Wj - fx txl invz2 W2j; T1j likewise with fy, tyl
  float dinvz = 0.0f, dinvz2 = 0.0f, dtxl = 0.0f, dtyl = 0.0f;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    dinvz += cam.fx * dT0[j] * W[j] + cam.fy * dT1[j] * W[4 + j];
    dinvz2 += -cam.fx * g.txl * dT0[j] * W[8 + j]
              - cam.fy * g.tyl * dT1[j] * W[8 + j];
    dtxl += -cam.fx * g.invz2 * dT0[j] * W[8 + j];
    dtyl += -cam.fy * g.invz2 * dT1[j] * W[8 + j];
  }
  dinvz += 2.0f * g.invz * dinvz2;
  float dtzs = -dinvz * (g.invz * g.invz);
  // txl = clamp(tx / tzs) * tz: the clamp passes the gradient inside
  // [-lim, lim], bounds included
  dtz += dtxl * clamp2(g.ux, -a.limx, a.limx)
         + dtyl * clamp2(g.uy, -a.limy, a.limy);
  const float dux = (g.ux >= -a.limx && g.ux <= a.limx) ? dtxl * g.tz : 0.0f;
  const float duy = (g.uy >= -a.limy && g.uy <= a.limy) ? dtyl * g.tz : 0.0f;
  dtx += dux / g.tzs;
  dty += duy / g.tzs;
  dtzs += -dux * g.tx / (g.tzs * g.tzs) - duy * g.ty / (g.tzs * g.tzs);
  if (g.tz != 0.0f) dtz += dtzs;

  // S = R diag(ss) R': to R and to the scales
  float dss[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    dss[k] = 0.0f;
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int c = 0; c < 3; ++c) dss[k] += dS[r][c] * g.R[r][k] * g.R[c][k];
  }
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      float acc = 0.0f;
#pragma unroll
      for (int c = 0; c < 3; ++c) acc += (dS[r][c] + dS[c][r]) * g.R[c][k];
      dR[r][k] += acc * g.ss[k];
    }

  // the means: camera frame, clip space
  if (d_xyz) {
    float dp[3];
#pragma unroll
    for (int j = 0; j < 3; ++j)
      dp[j] = W[j] * dtx + W[4 + j] * dty + W[8 + j] * dtz + M[j] * dphx
              + M[4 + j] * dphy + M[12 + j] * dpw4;
    d_xyz[3 * i + 0] = dp[0];
    d_xyz[3 * i + 1] = dp[1];
    d_xyz[3 * i + 2] = dp[2];
  }

  // colours
  if (col != nullptr && a.sh_degree >= 0) {
    float d[3], u[3], n;
    view_dir(cam, p, d, u, n);
    float b[kShRows];
    sh_basis(a.sh_degree, u[0], u[1], u[2], b);
    const int nk = (a.sh_degree + 1) * (a.sh_degree + 1);
    const float* sh = col + (size_t)i * kShRows * 3;
    float dres[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      float acc = b[0] * sh[c];
      for (int k = 1; k < nk; ++k) acc = acc + b[k] * sh[3 * k + c];
      const float res = acc + 0.5f;
      // torch.maximum: half the gradient at the tie, none below
      dres[c] = res < 0.0f ? 0.0f : (res == 0.0f ? gs[6 + c] * 0.5f
                                                   : gs[6 + c]);
    }
    if (d_col) {
      float* o = d_col + (size_t)i * kShRows * 3;
      for (int k = 0; k < kShRows; ++k)
#pragma unroll
        for (int c = 0; c < 3; ++c)
          o[3 * k + c] = k < nk ? b[k] * dres[c] : 0.0f;
    }
    if (d_xyz && a.sh_degree > 0) {
      float gk[kShRows];
      for (int k = 1; k < nk; ++k)
        gk[k] = sh[3 * k] * dres[0] + sh[3 * k + 1] * dres[1]
                + sh[3 * k + 2] * dres[2];
      const float x = u[0], y = u[1], z = u[2];
      float du[3];
      du[0] = -C1() * gk[3];
      du[1] = -C1() * gk[1];
      du[2] = C1() * gk[2];
      if (a.sh_degree > 1) {
        const float xx = x * x, yy = y * y, zz = z * z;
        du[0] += C2(0) * y * gk[4] - 2.0f * C2(2) * x * gk[6]
                 + C2(3) * z * gk[7] + 2.0f * C2(4) * x * gk[8];
        du[1] += C2(0) * x * gk[4] + C2(1) * z * gk[5]
                 - 2.0f * C2(2) * y * gk[6] - 2.0f * C2(4) * y * gk[8];
        du[2] += C2(1) * y * gk[5] + 4.0f * C2(2) * z * gk[6]
                 + C2(3) * x * gk[7];
        if (a.sh_degree > 2) {
          du[0] += C3(0) * 6.0f * x * y * gk[9] + C3(1) * y * z * gk[10]
                   - C3(2) * 2.0f * x * y * gk[11]
                   - C3(3) * 6.0f * x * z * gk[12]
                   + C3(4) * (4.0f * zz - 3.0f * xx - yy) * gk[13]
                   + C3(5) * 2.0f * x * z * gk[14]
                   + C3(6) * 3.0f * (xx - yy) * gk[15];
          du[1] += C3(0) * 3.0f * (xx - yy) * gk[9] + C3(1) * x * z * gk[10]
                   + C3(2) * (4.0f * zz - xx - 3.0f * yy) * gk[11]
                   - C3(3) * 6.0f * y * z * gk[12]
                   - C3(4) * 2.0f * x * y * gk[13]
                   - C3(5) * 2.0f * y * z * gk[14]
                   - C3(6) * 6.0f * x * y * gk[15];
          du[2] += C3(1) * x * y * gk[10] + C3(2) * 8.0f * y * z * gk[11]
                   + C3(3) * (6.0f * zz - 3.0f * xx - 3.0f * yy) * gk[12]
                   + C3(4) * 8.0f * x * z * gk[13]
                   + C3(5) * (xx - yy) * gk[14];
        }
      }
      // u = d / (|d| + 1e-12)
      const float dn = n + 1e-12f;
      const float dot = du[0] * d[0] + du[1] * d[1] + du[2] * d[2];
      const float k2 = n > 0.0f ? -dot / (dn * dn) / n : 0.0f;
#pragma unroll
      for (int j = 0; j < 3; ++j) d_xyz[3 * i + j] += du[j] / dn + d[j] * k2;
    }
  } else if (d_col) {
#pragma unroll
    for (int c = 0; c < 3; ++c) d_col[3 * i + c] = gs[6 + c];
  }

  if (d_opac) {
    float dop = gs[5];
    if (a.activate) {
      const float sg = 1.0f / (1.0f + expf(-opac[i]));
      dop = dop * (1.0f - sg) * sg;
    }
    d_opac[i] = dop;
  }

  if (d_scl) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      // ss = (s * mod)^2; s = exp(raw) where activated
      const float sm = g.s[k] * a.scale_modifier;
      float ds = dss[k] * 2.0f * sm * a.scale_modifier;
      if (a.activate) ds = ds * g.s[k];
      d_scl[3 * i + k] = ds;
    }
  }

  if (d_rot) {
    const float w = g.q[0], x = g.q[1], y = g.q[2], z = g.q[3];
    float dq[4];
    dq[0] = 2.0f * (-z * dR[0][1] + y * dR[0][2] + z * dR[1][0]
                    - x * dR[1][2] - y * dR[2][0] + x * dR[2][1]);
    dq[1] = 2.0f * (y * dR[0][1] + z * dR[0][2] + y * dR[1][0]
                    - 2.0f * x * dR[1][1] - w * dR[1][2] + z * dR[2][0]
                    + w * dR[2][1] - 2.0f * x * dR[2][2]);
    dq[2] = 2.0f * (-2.0f * y * dR[0][0] + x * dR[0][1] + w * dR[0][2]
                    + x * dR[1][0] + z * dR[1][2] - w * dR[2][0]
                    + z * dR[2][1] - 2.0f * y * dR[2][2]);
    dq[3] = 2.0f * (-2.0f * z * dR[0][0] - w * dR[0][1] + x * dR[0][2]
                    + w * dR[1][0] - 2.0f * z * dR[1][1] + y * dR[1][2]
                    + x * dR[2][0] + y * dR[2][1]);
    if (a.activate) {
      // q = v / (|v| + 1e-8)
      const float dn = g.qn + 1e-8f;
      float dot = 0.0f;
#pragma unroll
      for (int k = 0; k < 4; ++k) dot += dq[k] * g.qraw[k];
      const float k2 = g.qn > 0.0f ? -dot / (dn * dn) / g.qn : 0.0f;
#pragma unroll
      for (int k = 0; k < 4; ++k) dq[k] = dq[k] / dn + g.qraw[k] * k2;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) d_rot[4 * i + k] = dq[k];
  }
}

inline int blocks_for(long long n) {
  return (int)((n + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" int dqo_project_fwd(int P, const float* xyz, const float* scl,
                               const float* rot, const float* opac,
                               const float* col, const unsigned char* mask,
                               const float* w2c, const float* proj,
                               const float* K, const float* cam_pos,
                               float limx, float limy, float color_sigma,
                               float scale_modifier, int width, int height,
                               int activate, int sh_degree, float* table,
                               unsigned char* valid, void* stream) {
  if (P <= 0) return 0;
  if (sh_degree > 3) return (int)cudaErrorInvalidValue;
  const Args a{limx, limy, color_sigma, scale_modifier, width, height,
               activate, sh_degree};
  project_fwd_kernel<<<blocks_for(P), kThreads, 0, (cudaStream_t)stream>>>(
      P, xyz, scl, rot, opac, col, mask, w2c, proj, K, cam_pos, a, table,
      valid);
  return (int)cudaGetLastError();
}

extern "C" int dqo_project_pack(long long L, int P, const float* table,
                                const long long* point_list,
                                const unsigned char* entry_valid,
                                float* feats, void* stream) {
  if (L <= 0) return 0;
  project_pack_kernel<<<blocks_for(L), kThreads, 0, (cudaStream_t)stream>>>(
      L, P, table, point_list, entry_valid, feats);
  return (int)cudaGetLastError();
}

extern "C" int dqo_project_bwd(int P, int R, long long L, const float* dfeats,
                               const int* cell_entry, const float* xyz,
                               const float* scl, const float* rot,
                               const float* opac, const float* col,
                               const float* w2c, const float* proj,
                               const float* K, const float* cam_pos,
                               float limx, float limy, float color_sigma,
                               float scale_modifier, int width, int height,
                               int activate, int sh_degree, float* d_xyz,
                               float* d_scl, float* d_rot, float* d_opac,
                               float* d_col, void* stream) {
  if (P <= 0) return 0;
  if (sh_degree > 3) return (int)cudaErrorInvalidValue;
  const Args a{limx, limy, color_sigma, scale_modifier, width, height,
               activate, sh_degree};
  project_bwd_kernel<<<blocks_for(P), kThreads, 0, (cudaStream_t)stream>>>(
      P, R, L, dfeats, cell_entry, xyz, scl, rot, opac, col, w2c, proj, K,
      cam_pos, a, d_xyz, d_scl, d_rot, d_opac, d_col);
  return (int)cudaGetLastError();
}

extern "C" const char* dqo_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
