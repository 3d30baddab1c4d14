// score_hist: the engine build's per-chunk pass for Hopper (sm_90a): the
// score sketch and the chunk's two float64 sampling masses, in one launch.
//
// Replaces the TPU kernel src/repro/kernels/score_hist/score_hist.py
// (`score_hist`, body `_hist_kernel`), which resolved bin membership with
// one-hot masks on the MXU, and takes over the build's separate masses
// pass (`sampling.chunk_raw_masses`). Over records with A >= 0 (the -1
// "unscored" sentinel is ignored), with a = min(A, 1) and
// b = min(floor(a*B), B-1):
//   counts[b] = |{x in b}|,  sum_w[b] = sum sqrt(a),  sum_a[b] = sum a,
// and the chunk's float64 masses sum sqrt(a) and sum a, each term the
// float32 value and its correctly rounded float32 square root (IEEE
// `sqrtf`; no fast math). NaN scores are ignored by the sketch and the
// masses alike.
//
// Bound on this card: one read of 4*N bytes at 3.35 TB/s (a 2^22-record
// chunk is 16.8 MB, 5.0 us); the outputs (3*B floats, two doubles) are
// negligible. The launch takes 5-6x that on a Beta(0.01, 1) chunk
// (PERF.md gives its times and what holds it).
//
// Design.
// * One CTA of 1024 threads an SM, in clusters of kCluster CTAs; the grid
//   depends on n and the card alone. Each thread walks a grid-stride slice
//   of the scores (float4 loads after a scalar head up to the first
//   16-byte boundary) and keeps a run (bin, count, float64 sums) in
//   registers, adding it into the CTA's shared histogram only when the
//   bin changes. Proxy scores are skewed (most of a Beta(0.01, 1) corpus
//   lies in bin 0), and a run absorbs a hot bin without touching shared
//   memory.
// * The shared histogram is five uint32 arrays: counts, and both sums as
//   fixed point (value * 2^32) split into its low 16 bits and the rest. A
//   run's float64 sum is floored to fixed point by one round-down FMA and
//   added with two 32-bit atomics; a CTA takes fewer than 2^16 records, so
//   neither word overflows and no carry is needed. Integer addition is
//   associative, so the sketch is the same bits on every launch, at any
//   launch order or worker count. No 64-bit shared atomic is used (this
//   card has none: it would be a compare-and-swap loop).
// * The masses are the sums of each thread's runs in its own order, a
//   fixed shuffle tree in each warp, the warps in order in each CTA, the
//   CTAs in rank order in each cluster and the clusters in index order:
//   the same bits on every launch.
// * After a cluster barrier, CTA r of a cluster sums slice r of the bins
//   over the cluster's histograms in distributed shared memory (16-byte
//   loads, one rank a lane, then a reduce-scatter over the 8 lanes of a
//   quad of bins) and adds the non-empty bins into global 64-bit totals
//   with one atomic each, so global atomics come from clusters, not CTAs.
//   The last CTA of each slice to finish (a ticket) converts the slice's
//   totals to the three float32 vectors and zeroes them and its ticket for
//   the next launch; slice 0's also writes the masses. Nothing else is
//   launched: no memset, no second kernel.
// * Fixed point truncates each run below 2^-32: a bin's sum is low by
//   less than N * 2^-32 (1e-3 at N = 2^22), far inside float32's own
//   rounding of a bin sum.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kCluster = 8;
// Shared memory a bin takes: five uint32 words (the wrapper's MAX_BINS,
// in score_hist/ops.py, is the most bins whose padded_bins take at most
// 232448 - kReserved bytes).
constexpr int kBinBytes = 20;
constexpr int kReserved = 1024;          // the reductions' static shared
constexpr int kMaxDynamicSmem = 232448 - kReserved;
// Records a launch takes at most (the wrapper's MAX_RECORDS), and a
// cluster at most, so that a CTA takes fewer than 2^16 (a thread at most
// 4 * 15 of the float4 loop and 2 of the head and tail).
constexpr long long kMaxRecords = (1ll << 31) - 1;
constexpr long long kMaxPerCluster = 60ll * kThreads * kCluster;
constexpr int kMaxClusters =
    static_cast<int>((kMaxRecords + kMaxPerCluster - 1) / kMaxPerCluster);
// Scratch (uint64 words): a ticket a slice and the totals (counts, sum_w,
// sum_a), zero between launches, and two float64 masses a cluster, which
// a launch writes before it reads them.
constexpr int kMassesAt = kCluster;
constexpr int kTotalsAt = kMassesAt + 2 * kMaxClusters;

struct Reductions {
  double warp[kWarps][2];
  double cta[2];
  int last;
};
static_assert(sizeof(Reductions) <= kReserved, "static shared memory");

struct Hist {
  unsigned *cnt, *wlo, *whi, *alo, *ahi;
};

__device__ __forceinline__ Hist hist_at(unsigned* base, int num_bins) {
  return {base, base + num_bins, base + 2 * num_bins, base + 3 * num_bins,
          base + 4 * num_bins};
}

struct Run {
  int bin;
  unsigned count;
  double w, a;
};

// floor(x * 2^32) for 0 <= x < 2^16, added into a pair of words that
// take its low 16 bits (lo) and the rest (hi). A CTA takes fewer than 2^16
// records, so neither word's sum reaches 2^32: no carry, and no atomic
// whose old value is needed.
__device__ __forceinline__ void add_fixed(unsigned* lo, unsigned* hi, int b,
                                          double x) {
  const double t = __fma_rd(x, 4294967296.0, 4503599627370496.0);
  const unsigned l = static_cast<unsigned>(__double2loint(t));
  const unsigned h = static_cast<unsigned>(__double2hiint(t)) & 0xFFFFFu;
  atomicAdd(&lo[b], l & 0xFFFFu);
  atomicAdd(&hi[b], __funnelshift_l(l, h, 16));
}

__device__ __forceinline__ void flush(const Run& r, const Hist& h,
                                      double& mw, double& ma) {
  mw += r.w;
  ma += r.a;
  atomicAdd(&h.cnt[r.bin], r.count);
  add_fixed(h.wlo, h.whi, r.bin, r.w);
  add_fixed(h.alo, h.ahi, r.bin, r.a);
}

// The correctly rounded square root of a in [0, 1], kept off sqrtf's slow
// path: below 2^-100 (zeros and subnormals included) it takes the root of
// a * 2^100 and scales it by 2^-50, both exact.
__device__ __forceinline__ float sqrt_rn(float a) {
  const bool tiny = a < 0x1p-100f;
  float x = tiny ? a * 0x1p100f : a;
  x = a == 0.0f ? 1.0f : x;
  const float r = sqrtf(x);
  return a == 0.0f ? a : (tiny ? r * 0x1p-50f : r);
}

__device__ __forceinline__ void add(Run& r, float s, int num_bins, float fb,
                                    const Hist& h, double& mw, double& ma) {
  if (!(s >= 0.0f)) return;               // sentinel (and NaN) ignored
  const float a = fminf(s, 1.0f);
  // floor(a * B) as the reference rounds it: the float32 product, then
  // its integer part read off the bits of (product + 2^23) rounded down.
  const int b = min(__float_as_int(__fadd_rd(__fmul_rn(a, fb), 0x1p23f)) -
                        0x4B000000, num_bins - 1);
  const double dq = sqrt_rn(a), da = a;
  if (b != r.bin) {
    if (r.bin >= 0) flush(r, h, mw, ma);
    r.bin = b;
    r.count = 1;
    r.w = dq;
    r.a = da;
  } else {
    r.count += 1;
    r.w += dq;
    r.a += da;
  }
}

// One bin's (count, sum_w, sum_a), summed over CTAs in the merge.
struct Bin {
  unsigned c;
  unsigned long long w, a;
};

__device__ __forceinline__ Bin operator+(const Bin& x, const Bin& y) {
  return {x.c + y.c, x.w + y.w, x.a + y.a};
}

// x if p else y, field by field (a select of whole structs would go
// through local memory).
__device__ __forceinline__ Bin pick(bool p, const Bin& x, const Bin& y) {
  return {p ? x.c : y.c, p ? x.w : y.w, p ? x.a : y.a};
}

__device__ __forceinline__ Bin shfl_xor(const Bin& x, int mask) {
  return {__shfl_xor_sync(0xFFFFFFFFu, x.c, mask),
          __shfl_xor_sync(0xFFFFFFFFu, x.w, mask),
          __shfl_xor_sync(0xFFFFFFFFu, x.a, mask)};
}

__device__ __forceinline__ unsigned long long fixed(unsigned hi,
                                                    unsigned lo) {
  return (static_cast<unsigned long long>(hi) << 16) + lo;
}

// Bins padded to a multiple of 4 a cluster rank, so each CTA's slice of the
// merge is whole 16-byte quads.
__device__ __host__ __forceinline__ int padded_bins(int num_bins) {
  return (num_bins + 4 * kCluster - 1) / (4 * kCluster) * (4 * kCluster);
}

__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads, 1)
hist_chunk(const float* __restrict__ scores, long long n, int num_bins,
           unsigned long long* __restrict__ scratch, float* __restrict__ out,
           double* __restrict__ masses) {
  extern __shared__ unsigned smem[];
  __shared__ Reductions red;
  cg::cluster_group cluster = cg::this_cluster();
  const int bp = padded_bins(num_bins);
  const Hist h = hist_at(smem, bp);
  for (int i = threadIdx.x; i < 5 * bp / 4; i += kThreads)
    reinterpret_cast<uint4*>(smem)[i] = make_uint4(0, 0, 0, 0);
  __syncthreads();

  Run r{-1, 0, 0.0, 0.0};
  double mw = 0.0, ma = 0.0;
  const float fb = static_cast<float>(num_bins);
  const long long tid = static_cast<long long>(blockIdx.x) * kThreads +
                        threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long head = min(
      n, static_cast<long long>(
             (16 - (reinterpret_cast<uintptr_t>(scores) & 15)) & 15) / 4);
  if (tid < head) add(r, scores[tid], num_bins, fb, h, mw, ma);
  const float4* v = reinterpret_cast<const float4*>(scores + head);
  const long long n4 = (n - head) / 4;
  for (long long i = tid; i < n4; i += stride) {
    const float4 q = __ldcs(v + i);
    add(r, q.x, num_bins, fb, h, mw, ma);
    add(r, q.y, num_bins, fb, h, mw, ma);
    add(r, q.z, num_bins, fb, h, mw, ma);
    add(r, q.w, num_bins, fb, h, mw, ma);
  }
  for (long long i = head + 4 * n4 + tid; i < n; i += stride)
    add(r, scores[i], num_bins, fb, h, mw, ma);
  if (r.bin >= 0) flush(r, h, mw, ma);

  // The CTA's masses: a shuffle tree in each warp, then the warps in order.
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int o = 16; o > 0; o >>= 1) {
    mw += __shfl_down_sync(0xFFFFFFFFu, mw, o);
    ma += __shfl_down_sync(0xFFFFFFFFu, ma, o);
  }
  if (lane == 0) {
    red.warp[warp][0] = mw;
    red.warp[warp][1] = ma;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    double x = 0.0, y = 0.0;
    for (int w = 0; w < kWarps; ++w) {
      x += red.warp[w][0];
      y += red.warp[w][1];
    }
    red.cta[0] = x;
    red.cta[1] = y;
  }
  cluster.sync();   // every histogram and CTA mass of the cluster is done

  const int rank = static_cast<int>(cluster.block_rank());
  const int cid = blockIdx.x / kCluster;
  const int clusters = gridDim.x / kCluster;
  double* g_masses = reinterpret_cast<double*>(scratch + kMassesAt);
  unsigned long long* g_cnt = scratch + kTotalsAt;
  unsigned long long* g_w = g_cnt + bp;
  unsigned long long* g_a = g_w + bp;
  if (rank == 0 && threadIdx.x == 0) {
    double x = 0.0, y = 0.0;
    for (int q = 0; q < kCluster; ++q) {
      const double* m = cluster.map_shared_rank(red.cta, q);
      x += m[0];
      y += m[1];
    }
    g_masses[2 * cid] = x;
    g_masses[2 * cid + 1] = y;
  }
  // Slice `rank` of the bins over the cluster's histograms: each lane reads
  // one quad of bins from one rank (16-byte loads), then the kCluster lanes
  // of a quad sum it by a reduce-scatter (4 bins -> 2 -> 1, then the last
  // pair), so each bin's total ends in one even lane.
  static_assert(kCluster == 8, "the merge's reduce-scatter takes 8 ranks");
  const int per = bp / kCluster;
  const int first = rank * per;
  const int q = lane & (kCluster - 1);
  const Hist o = hist_at(cluster.map_shared_rank(smem, q), bp);
  for (int j0 = warp * 16; j0 < per; j0 += kWarps * 16) {
    const int j = j0 + (lane / kCluster) * 4;
    uint4 c = {}, wl = {}, wh = {}, al = {}, ah = {};
    if (j < per) {
      c = *reinterpret_cast<const uint4*>(o.cnt + first + j);
      wl = *reinterpret_cast<const uint4*>(o.wlo + first + j);
      wh = *reinterpret_cast<const uint4*>(o.whi + first + j);
      al = *reinterpret_cast<const uint4*>(o.alo + first + j);
      ah = *reinterpret_cast<const uint4*>(o.ahi + first + j);
    }
    const Bin b0 = {c.x, fixed(wh.x, wl.x), fixed(ah.x, al.x)};
    const Bin b1 = {c.y, fixed(wh.y, wl.y), fixed(ah.y, al.y)};
    const Bin b2 = {c.z, fixed(wh.z, wl.z), fixed(ah.z, al.z)};
    const Bin b3 = {c.w, fixed(wh.w, wl.w), fixed(ah.w, al.w)};
    const bool up4 = q & 4, up2 = q & 2;
    const Bin k0 = pick(up4, b2, b0) + shfl_xor(pick(up4, b0, b2), 4);
    const Bin k1 = pick(up4, b3, b1) + shfl_xor(pick(up4, b1, b3), 4);
    const Bin k = pick(up2, k1, k0) + shfl_xor(pick(up2, k0, k1), 2);
    const Bin all = k + shfl_xor(k, 1);
    const int b = first + j + (up4 ? 2 : 0) + (up2 ? 1 : 0);
    if (!(q & 1) && j < per && all.c) {
      atomicAdd(&g_cnt[b], static_cast<unsigned long long>(all.c));
      atomicAdd(&g_w[b], all.w);
      atomicAdd(&g_a[b], all.a);
    }
  }
  __threadfence();
  cluster.sync();   // no CTA leaves while its shared memory may be read

  if (threadIdx.x == 0)
    red.last = atomicAdd(&scratch[rank], 1ull) ==
               static_cast<unsigned long long>(clusters - 1);
  __syncthreads();
  if (!red.last) return;
  __threadfence();
  constexpr double kInvScale = 1.0 / 4294967296.0;
  for (int b = first + threadIdx.x; b < first + per; b += kThreads) {
    if (b < num_bins) {
      out[b] = static_cast<float>(__ldcg(&g_cnt[b]));
      out[num_bins + b] = static_cast<float>(
          static_cast<double>(__ldcg(&g_w[b])) * kInvScale);
      out[2 * num_bins + b] = static_cast<float>(
          static_cast<double>(__ldcg(&g_a[b])) * kInvScale);
    }
    g_cnt[b] = 0;
    g_w[b] = 0;
    g_a[b] = 0;
  }
  if (threadIdx.x == 0) scratch[rank] = 0;
  if (rank == 0 && warp == 0 && masses != nullptr) {
    // The clusters' masses in index order: 32 loaded at once, summed by
    // lane 0.
    double x = 0.0, y = 0.0;
    for (int c0 = 0; c0 < clusters; c0 += 32) {
      const int c = c0 + lane;
      const double cx = c < clusters ? __ldcg(&g_masses[2 * c]) : 0.0;
      const double cy = c < clusters ? __ldcg(&g_masses[2 * c + 1]) : 0.0;
      for (int k = 0; k < 32 && c0 + k < clusters; ++k) {
        x += __shfl_sync(0xFFFFFFFFu, cx, k);
        y += __shfl_sync(0xFFFFFFFFu, cy, k);
      }
    }
    if (lane == 0) {
      masses[0] = x;
      masses[1] = y;
    }
  }
}

}  // namespace

extern "C" {

// Once per device before any launch: lets the kernel take its shared
// memory (above the 48 KiB default).
int score_hist_init(void) {
  return static_cast<int>(cudaFuncSetAttribute(
      hist_chunk, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kMaxDynamicSmem));
}

// The most clusters the current device runs at once at `num_bins`, in
// *clusters.
int score_hist_max_clusters(int num_bins, int* clusters) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes =
      static_cast<size_t>(kBinBytes) * padded_bins(num_bins);
  return static_cast<int>(cudaOccupancyMaxActiveClusters(clusters, hist_chunk,
                                                         &cfg));
}

// Clusters a launch over 0 < n <= kMaxRecords records takes, given the
// device's `resident` clusters: one per kPerCluster records, at most
// `resident`, and at least enough that a cluster takes kMaxPerCluster.
int score_hist_clusters(long long n, int resident) {
  constexpr long long kPerCluster = 1ll << 16;
  const long long need = (n + kMaxPerCluster - 1) / kMaxPerCluster;
  const long long want = (n + kPerCluster - 1) / kPerCluster;
  const long long c = want < resident ? want : resident;
  return static_cast<int>(c > need ? c : need);
}

// The scratch a launch at `num_bins` needs, in uint64 words (zero before
// the first launch; each launch leaves its tickets and totals zero).
long long score_hist_scratch_words(int num_bins) {
  return kTotalsAt + 3ll * padded_bins(num_bins);
}

// scores: n > 0 float32 on the device. out: (3, num_bins) float32 =
// counts, sum_w, sum_a. masses: two float64 (sum sqrt(a), sum a) or null.
// Launches `clusters` clusters on `stream`; returns cudaGetLastError().
int score_hist_launch(const float* scores, long long n, int num_bins,
                      unsigned long long* scratch, float* out, double* masses,
                      int clusters, cudaStream_t stream) {
  hist_chunk<<<clusters * kCluster, kThreads,
               kBinBytes * padded_bins(num_bins), stream>>>(
      scores, n, num_bins, scratch, out, masses);
  return static_cast<int>(cudaGetLastError());
}

const char* score_hist_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
