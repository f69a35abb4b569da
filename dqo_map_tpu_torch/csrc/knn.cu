// K3: densification's exact k-nearest-neighbour search for Hopper (sm_90a),
// both class-restricted searches of ops/knn.py::knn2 in one pass over the
// candidates, with no distance matrix in device memory.
//
// Replaces no TPU kernel: the JAX package leaves this search to XLA
// (dqo_map_tpu/ops/knn.py::knn2, chunked matrix products and lax.top_k).
// It was added because the port's plain version of that search (knn2_ref:
// 24 x 3 chunks, each a 4096 x 65536 float32 distance matrix in device
// memory, two masked copies of it and two radix torch.topk passes) took
// 585-646 ms of every densified frame on one H100 at the benchmark's
// shapes (M = 98,304 queries, N = 136-160k candidates), more than half of
// the frame, while the search needs no memory traffic at all.
//
// What it computes, for each query row and each of the two masks: the k
// (1 <= k <= 8) candidates with the mask set nearest the query by squared
// distance, nearest first, ties to the lower candidate index; a slot that
// no candidate fills holds +inf and index 0 (the wrapper writes BIG there
// and recomputes every distance it returns from the winners' coordinates,
// as knn2_ref does).
//
// What bounds it: float32 operations. A (query, candidate) pair costs 3
// subtractions, a multiply and two fused multiply-adds (the direct
// difference, as exact as float32 allows; the expansion |q|^2 + |c|^2 -
// 2 q.c that the plain version uses cancels for near points) and one
// compare: 7 instructions, 13-16 G pairs a call at the benchmark's shapes.
// The design keeps everything else off that path:
//   - knn2_pack first sorts the candidates into three classes, in mask_a
//     alone, in mask_b alone, in both, as float4 (x, y, z, index), and
//     drops those in neither; the search walks each class with a test of
//     its own, so no mask is read per pair, and the compare is against the
//     k-th distance of the one list the class can enter, or the larger of
//     the two for a candidate in both: one compare a pair;
//   - one thread owns one query, its coordinates and both sorted top-k
//     lists (distance, index) in registers; insertion is unrolled over
//     static indices, so nothing spills to local memory (k is a template
//     parameter). The kGroup distances of a group are independent chains;
//     a second query a thread spilled at k = 8 and was slower;
//   - a block stages kTile candidates at a time in shared memory; every
//     thread reads the same candidate, a broadcast. It tests kGroup of them
//     at once against the lists as they stand (an insertion only lowers the
//     k-th distances, so a group that passes none holds no winner) and only
//     a group that passes takes the rare path, which walks them one by one:
//     one branch per kGroup pairs. Insertion is rare once the lists
//     are full (about k ln(n / k) times a list over n candidates);
//   - the lists rank by (distance, index), so the order in which the
//     candidates arrive does not matter: knn2_pack places them with
//     atomics;
//   - a block of kThreads queries walks every candidate: at the
//     benchmark's shapes 768 blocks fill the 132 SMs. Splitting the
//     candidate range over several blocks a query block, with a kernel
//     to merge their partial lists, was slower there (2-6 splits: 7.4-9.4
//     ms a call against 6.9 on one H100), so there is no split: with
//     fewer queries (under ~17k) the card is underfilled.
// The library is built with -fmad=false; the two multiply-adds of the
// distance are written out (__fmaf_rn), so the distance is the same
// whatever the flag.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 128;  // threads a block, a query each
constexpr int kTile = 512;     // candidates staged at a time
constexpr int kGroup = 4;      // candidates tested at once

// (v, id) ranks before (d, i): nearer, or as near with a lower index
__device__ __forceinline__ bool before(float v, int id, float d, int i) {
  return v < d || (v == d && id < i);
}

// Insert (v, id) into the list (d, ix) of length K, ascending by (distance,
// index), given that it ranks before the last entry.
template <int K>
__device__ __forceinline__ void insert(float (&d)[K], int (&ix)[K], float v,
                                       int id) {
#pragma unroll
  for (int j = K - 1; j > 0; --j) {
    const bool shift = before(v, id, d[j - 1], ix[j - 1]);
    const bool here = !shift && before(v, id, d[j], ix[j]);
    d[j] = shift ? d[j - 1] : (here ? v : d[j]);
    ix[j] = shift ? ix[j - 1] : (here ? id : ix[j]);
  }
  if (before(v, id, d[0], ix[0])) {
    d[0] = v;
    ix[0] = id;
  }
}

// The candidates by class into three regions of `packed` (3, N) float4
// (x, y, z, index): class 1 in mask_a alone, 2 in mask_b alone, 3 in
// both; those in neither are dropped. counts (3,) int, zeroed before, take
// the regions' lengths. The order within a region is the atomics' order:
// the search ranks by (distance, index), so it does not matter.
__global__ void knn2_pack(const float* __restrict__ c,
                          const unsigned char* __restrict__ mask_a,
                          const unsigned char* __restrict__ mask_b, int N,
                          float4* __restrict__ packed,
                          int* __restrict__ counts) {
  const int j = (int)(blockIdx.x * blockDim.x + threadIdx.x);
  const int cls = j < N ? (mask_a[j] ? 1 : 0) | (mask_b[j] ? 2 : 0) : 0;
  const int lane = (int)(threadIdx.x & 31);
#pragma unroll
  for (int k = 1; k <= 3; ++k) {
    const unsigned ballot = __ballot_sync(0xffffffffu, cls == k);
    if (ballot == 0) continue;
    const int leader = __ffs(ballot) - 1;
    int at = 0;
    if (lane == leader) at = atomicAdd(&counts[k - 1], __popc(ballot));
    at = __shfl_sync(0xffffffffu, at, leader);
    if (cls == k)
      packed[(size_t)(k - 1) * N + at + __popc(ballot & ((1u << lane) - 1))] =
          make_float4(c[3 * j], c[3 * j + 1], c[3 * j + 2], __int_as_float(j));
  }
}

template <int K>
struct Lists {
  float da[K], db[K];
  int ia[K], ib[K];
};

// Walk class C's region, its n candidates, kTile at a time.
template <int K, int C>
__device__ __forceinline__ void walk(Lists<K>& L, float qx, float qy,
                                     float qz,
                                     const float4* __restrict__ region,
                                     int n, float4* sc) {
  // the class's test: one compare a pair against the k-th distance of
  // the list, or the larger of the two lists', that it could enter
  float thr = C == 1 ? L.da[K - 1]
            : C == 2 ? L.db[K - 1]
                     : fmaxf(L.da[K - 1], L.db[K - 1]);
  for (int base = 0; base < n; base += kTile) {
    const int cnt = min(kTile, n - base);
    const int padded = (cnt + kGroup - 1) / kGroup * kGroup;
    __syncthreads();
    for (int t = (int)threadIdx.x; t < padded; t += kThreads)
      sc[t] = t < cnt ? region[base + t]  // padding: NaN, in no list
                      : make_float4(CUDART_NAN_F, CUDART_NAN_F, CUDART_NAN_F,
                                    __int_as_float(0x7fffffff));
    __syncthreads();
    for (int t = 0; t < padded; t += kGroup) {
      // the group's distances, then one test of all of them against the
      // lists as they stand: an insertion only lowers the k-th distances,
      // so a group that passes none holds no winner
      float d[kGroup];
      bool hit = false;
#pragma unroll
      for (int w = 0; w < kGroup; ++w) {
        const float4 v = sc[t + w];
        const float dx = qx - v.x;
        const float dy = qy - v.y;
        const float dz = qz - v.z;
        d[w] = __fmaf_rn(dz, dz, __fmaf_rn(dy, dy, dx * dx));
        hit |= d[w] <= thr;
      }
      if (!hit) continue;
      // rare: the group's candidates one by one, each against the lists
      // as the ones before it left them
#pragma unroll
      for (int w = 0; w < kGroup; ++w) {
        const int id = __float_as_int(sc[t + w].w);
        if ((C & 1) && before(d[w], id, L.da[K - 1], L.ia[K - 1]))
          insert<K>(L.da, L.ia, d[w], id);
        if ((C & 2) && before(d[w], id, L.db[K - 1], L.ib[K - 1]))
          insert<K>(L.db, L.ib, d[w], id);
      }
      thr = C == 1 ? L.da[K - 1]
          : C == 2 ? L.db[K - 1]
                   : fmaxf(L.da[K - 1], L.db[K - 1]);
    }
  }
}

// Block b searches for the kThreads queries from b * kThreads on and
// writes out_d / out_i (2, M, K), list-major.
template <int K>
__global__ void __launch_bounds__(kThreads)
knn2_kernel(const float* __restrict__ q, int M,
            const float4* __restrict__ packed, const int* __restrict__ counts,
            int N, float* __restrict__ out_d, long long* __restrict__ out_i) {
  __shared__ float4 sc[kTile];
  const int row = (int)(blockIdx.x * kThreads + threadIdx.x);
  const int r = min(row, M - 1);
  const float qx = q[3 * r], qy = q[3 * r + 1], qz = q[3 * r + 2];
  Lists<K> L;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    L.da[j] = L.db[j] = CUDART_INF_F;
    L.ia[j] = L.ib[j] = 0;
  }
  walk<K, 1>(L, qx, qy, qz, packed, counts[0], sc);
  walk<K, 2>(L, qx, qy, qz, packed + N, counts[1], sc);
  walk<K, 3>(L, qx, qy, qz, packed + 2 * (size_t)N, counts[2], sc);
  if (row >= M) return;
  const size_t at = (size_t)row * K;
  const size_t lst = (size_t)M * K;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    out_d[at + j] = L.da[j];
    out_i[at + j] = L.ia[j];
    out_d[lst + at + j] = L.db[j];
    out_i[lst + at + j] = L.ib[j];
  }
}

template <int K>
int launch(const float* q, int M, const float* c, const unsigned char* ma,
           const unsigned char* mb, int N, float4* packed, int* counts,
           float* out_d, long long* out_i, cudaStream_t st) {
  cudaError_t err = cudaMemsetAsync(counts, 0, 3 * sizeof(int), st);
  if (err != cudaSuccess) return (int)err;
  knn2_pack<<<(N + 255) / 256, 256, 0, st>>>(c, ma, mb, N, packed, counts);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  knn2_kernel<K><<<(M + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      q, M, packed, counts, N, out_d, out_i);
  return (int)cudaGetLastError();
}

}  // namespace

// queries (M, 3), candidates (N, 3) float32 and the masks (N,) bool, all
// contiguous on the current device; scratch packed (3, N, 4) float32 and
// counts (3,) int32; out_d (2, M, k) float32 and out_i (2, M, k) int64.
// Launches on `stream` and returns cudaGetLastError() after each launch.
extern "C" int dqo_knn2(const float* q, int M, const float* c,
                        const unsigned char* mask_a,
                        const unsigned char* mask_b, int N, int k,
                        float* packed, int* counts, float* out_d,
                        long long* out_i, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  float4* pk = reinterpret_cast<float4*>(packed);
  switch (k) {
#define DQO_KNN_CASE(K)                                                     \
  case K:                                                                   \
    return launch<K>(q, M, c, mask_a, mask_b, N, pk, counts, out_d, out_i,  \
                     st);
    DQO_KNN_CASE(1)
    DQO_KNN_CASE(2)
    DQO_KNN_CASE(3)
    DQO_KNN_CASE(4)
    DQO_KNN_CASE(5)
    DQO_KNN_CASE(6)
    DQO_KNN_CASE(7)
    DQO_KNN_CASE(8)
#undef DQO_KNN_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* dqo_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
