// threshold_select: order-preserving stream compaction for Hopper (sm_90a).
//
// Replaces the TPU kernel
// src/repro/kernels/threshold_select/threshold_select.py
// (`threshold_select_blocks`, body `_select_kernel`) and the host stitching
// in its ops.py: that kernel compacted each block with one-hot MXU
// products and left the per-block lists for the host to stitch. Here the
// result is one ascending int64 array of {i : A[i] >= thr}, thr =
// max(tau, 0) in float32, so the -1 "unscored" sentinel is never selected.
//
// Bound on this card: 4*N bytes read plus 8*k bytes written (k selected)
// at 3.35 TB/s. The count pass reads the scores once more, so the kernel
// moves 8*N + 8*k bytes: at most twice its bound.
//
// Design: tiles of kTile records, one CTA each, thread t of iteration j
// reading record tile*kTile + j*kThreads + t (coalesced).
// * Pass 1 (`select_count`): each warp counts its 32 records with
//   __ballot_sync + __popc; a CTA writes its tile's count.
// * The wrapper takes an exclusive scan of the tile counts (a small
//   integer cumsum) and reads the total once, to size the output; the
//   reference syncs there too.
// * Pass 2 (`select_scatter`): per iteration, each warp's ballot gives its
//   lanes their rank (popc of the lanes below), the warps' counts are
//   scanned in shared memory, and every selected record writes its index
//   at tile offset + running count + warp offset + rank: ascending, with
//   no host stitching.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kIters = 8;
constexpr int kTile = kThreads * kIters;   // 2048 records a CTA

__global__ void select_count(const float* __restrict__ scores, long long n,
                             float thr, long long* __restrict__ counts) {
  __shared__ int warp_total[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long base = static_cast<long long>(blockIdx.x) * kTile;
  int mine = 0;
  for (int j = 0; j < kIters; ++j) {
    const long long i = base + j * kThreads + threadIdx.x;
    const bool sel = i < n && scores[i] >= thr;
    const unsigned mask = __ballot_sync(0xffffffffu, sel);
    mine += __popc(mask);
  }
  if (lane == 0) warp_total[warp] = mine;
  __syncthreads();
  if (threadIdx.x == 0) {
    long long t = 0;
    for (int w = 0; w < kWarps; ++w) t += warp_total[w];
    counts[blockIdx.x] = t;
  }
}

__global__ void select_scatter(const float* __restrict__ scores,
                               long long n, float thr,
                               const long long* __restrict__ offsets,
                               long long* __restrict__ out) {
  __shared__ int warp_count[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long base = static_cast<long long>(blockIdx.x) * kTile;
  long long running = offsets[blockIdx.x];
  const unsigned below = (1u << lane) - 1u;
  for (int j = 0; j < kIters; ++j) {
    const long long i = base + j * kThreads + threadIdx.x;
    const bool sel = i < n && scores[i] >= thr;
    const unsigned mask = __ballot_sync(0xffffffffu, sel);
    if (lane == 0) warp_count[warp] = __popc(mask);
    __syncthreads();
    int before = 0, total = 0;
    for (int w = 0; w < kWarps; ++w) {
      const int c = warp_count[w];
      before += (w < warp) ? c : 0;
      total += c;
    }
    if (sel) out[running + before + __popc(mask & below)] = i;
    running += total;
    __syncthreads();   // warp_count is rewritten next iteration
  }
}

}  // namespace

extern "C" {

// Records a CTA covers; the wrapper sizes `counts`/`offsets` by it.
int threshold_select_tile() { return kTile; }

// Pass 1: counts[t] = selected records in tile t (t < ceil(n / tile)).
int threshold_select_count(const float* scores, long long n, float thr,
                           long long* counts, cudaStream_t stream) {
  const long long tiles = (n + kTile - 1) / kTile;
  if (tiles > 0)
    select_count<<<static_cast<unsigned>(tiles), kThreads, 0, stream>>>(
        scores, n, thr, counts);
  return static_cast<int>(cudaGetLastError());
}

// Pass 2: offsets[t] = exclusive prefix of counts; out holds the total.
int threshold_select_scatter(const float* scores, long long n, float thr,
                             const long long* offsets, long long* out,
                             cudaStream_t stream) {
  const long long tiles = (n + kTile - 1) / kTile;
  if (tiles > 0)
    select_scatter<<<static_cast<unsigned>(tiles), kThreads, 0, stream>>>(
        scores, n, thr, offsets, out);
  return static_cast<int>(cudaGetLastError());
}

const char* threshold_select_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
