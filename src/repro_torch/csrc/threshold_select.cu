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
// at 3.35 TB/s: 0.0053 ms for a 2^22-record chunk of which RT's tau selects
// about 2^17.
//
// Design: one launch of a single-pass compaction with decoupled look-back
// (Merrill & Garland, "Single-pass Parallel Prefix Scan with Decoupled
// Look-back", 2016), so the scores are read once and nothing waits on the
// host inside a call.
// * Each CTA takes its tile of kTile records from an atomic ticket, so
//   tiles start in order and every tile a CTA looks back at is running.
//   Each warp takes 1024 consecutive records: eight coalesced 16-byte
//   loads a lane (scalar loads where the scores are not 16-byte aligned or
//   the tile is ragged), one ballot per record slot.
// * The ballots give each selected record its rank in its warp's segment;
//   a block scan of the 16 warps' counts places the segments, and the
//   ranks go to shared memory as tile offsets.
// * Warp 0 publishes the tile's count (AGGREGATE) in its status word,
//   then reads its predecessors' words 32 at a time, summing AGGREGATEs
//   back to the nearest INCLUSIVE prefix, and publishes its own INCLUSIVE
//   prefix; a status word holds its flag and value in one 64-bit store.
//   Waits back off (nanosleep, doubling to 1 us), so the polls do not
//   crowd the words' L2 slice. Tiles are large (16384 records): a
//   2^22-record chunk is 256 tiles, all resident at once, and a tile walks
//   back at most 8 windows. (A side-by-side variant that polled 256 words
//   at once ran slower.)
// * The CTA then writes its indices at prefix + rank, coalesced and
//   ascending; the last tile writes the total to a pinned host word, which
//   the wrapper reads after one wait (the call's only sync). The order of
//   tiles and of records in a tile is fixed, and the sums are integers:
//   launches repeat bitwise.
// * Nothing is cleared between launches: the ticket counters are set back
//   to 0 by the launch's last tile to take a ticket, and status words carry
//   the launch's epoch, so older words read as unpublished. A call is one
//   launch, with no memset in front of it.
// * Counting mode (`threshold_count`) runs the same tile count without
//   the look-back or the scatter and adds each tile's count to a total
//   the entry point zeroes on the stream.
//
// Times on NVIDIA H100 80GB HBM3, 700.00 W (chip_smoke.py --seed 0, a
// 2^22-record chunk, PERF.md §6): a call 0.0392 ms, host and read-back
// included, against torch.nonzero(s >= tau)'s 0.0499 ms and a 0.0053 ms
// bound; the launch alone 0.0163 ms of device time, threshold_count's
// 0.0106 ms. The two-pass kernel this design replaced took 0.1285 ms a
// call on the same card and limit (PERF.md §6).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kVecs = 8;                       // 16-byte loads a lane
constexpr int kSegment = 32 * 4 * kVecs;       // 1024 records a warp
constexpr int kTile = kWarps * kSegment;       // 16384 records a CTA
constexpr int kLook = 1;                       // status words a lane reads
constexpr unsigned kFull = 0xffffffffu;
// A tile's status word: the launch's epoch in bits 48-63, its flag in bits
// 46-47 (AGGREGATE or INCLUSIVE) and its count or prefix below. A word of
// another epoch reads as not yet published, so the words need no clearing
// between launches.
constexpr unsigned long long kAggregate = 1ull << 46;
constexpr unsigned long long kInclusive = 2ull << 46;
constexpr unsigned long long kValue = (1ull << 46) - 1;

// Selecting, the stream's workspace (int64 words): [0] ticket, [1] tiles
// that took one, [2 + t] tile t's status; the launch's last tile to take a
// ticket sets both counters back to 0. Counting, [1] is the total.
constexpr int kTicket = 0, kDone = 1, kTotal = 1, kStatus = 2;

__device__ __forceinline__ unsigned long long status_word(
    unsigned epoch, unsigned long long flag, long long value) {
  return static_cast<unsigned long long>(epoch) << 48 | flag
         | static_cast<unsigned long long>(value);
}

// 0 (not yet published), 1 (AGGREGATE) or 2 (INCLUSIVE).
__device__ __forceinline__ int status_flag(unsigned long long word,
                                           unsigned epoch) {
  return (word >> 48) == epoch ? static_cast<int>((word >> 46) & 3) : 0;
}

// The lane's four records of slot j of a warp segment starting at `seg`
// (records seg + 4 (32 j + lane) + e), as ballots: bit `lane` of sel[e]
// says whether record e of this lane's slot is selected.
__device__ __forceinline__ void slot_ballots(const float* __restrict__ s,
                                             long long seg, long long n,
                                             float thr, bool vec, int j,
                                             unsigned (&sel)[4]) {
  const int lane = threadIdx.x & 31;
  const long long i = seg + 4 * (32 * j + lane);
  float x[4];
  if (vec && seg + kSegment <= n) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(s + i));
    x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) x[e] = i + e < n ? __ldg(s + i + e) : -1.f;
  }
#pragma unroll
  for (int e = 0; e < 4; ++e)
    sel[e] = __ballot_sync(kFull, i + e < n && x[e] >= thr);
}

// Exclusive prefix of the warps' counts in warp order (lane 0's `v` per
// warp); `total` gets the block's sum. Uses `warp_sums` (kWarps ints).
__device__ __forceinline__ int warp_offset(int v, int* warp_sums,
                                           int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  int before = 0, sum = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int c = warp_sums[w];
    before += w < warp ? c : 0;
    sum += c;
  }
  *total = sum;
  return before;
}

__device__ __forceinline__ unsigned long long load_status(
    const unsigned long long* p) {
  return *reinterpret_cast<const volatile unsigned long long*>(p);
}

__device__ __forceinline__ void store_status(unsigned long long* p,
                                             unsigned long long word) {
  *reinterpret_cast<volatile unsigned long long*>(p) = word;
}

// Warp 0: publish tile t's count, look back to its exclusive prefix,
// publish the inclusive prefix; returns the exclusive prefix (every lane).
__device__ long long look_back(unsigned long long* status, long long t,
                               long long count, unsigned epoch) {
  const int lane = threadIdx.x & 31;
  if (t == 0) {
    if (lane == 0) store_status(status, status_word(epoch, kInclusive, count));
    return 0;
  }
  if (lane == 0)
    store_status(status + t, status_word(epoch, kAggregate, count));
  long long exclusive = 0;
  long long end = t - 1;        // distance d = lane * kLook + k reads end - d
  while (true) {
    unsigned long long w[kLook];
#pragma unroll
    for (int k = 0; k < kLook; ++k) {
      const long long idx = end - (lane * kLook + k);
      w[k] = idx >= 0 ? load_status(status + idx)
                      : status_word(epoch, kInclusive, 0);  // 0 before
    }
    unsigned nap = 32;
    while (true) {                               // until all are ready
      bool waiting = false;
#pragma unroll
      for (int k = 0; k < kLook; ++k) {
        if (status_flag(w[k], epoch) == 0) {
          w[k] = load_status(status + end - (lane * kLook + k));
          waiting |= status_flag(w[k], epoch) == 0;
        }
      }
      if (!__any_sync(kFull, waiting)) break;
      __nanosleep(nap);                          // back off, up to 1 us
      nap = min(2 * nap, 1024u);
    }
    int nearest = 32 * kLook;                    // nearest INCLUSIVE
#pragma unroll
    for (int k = kLook - 1; k >= 0; --k)
      if (status_flag(w[k], epoch) == 2) nearest = lane * kLook + k;
    nearest = __reduce_min_sync(kFull, nearest);
    long long v = 0;
#pragma unroll
    for (int k = 0; k < kLook; ++k)
      if (lane * kLook + k <= nearest)
        v += static_cast<long long>(w[k] & kValue);
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(kFull, v, d);
    exclusive += v;
    if (nearest < 32 * kLook) break;
    end -= 32 * kLook;
  }
  if (lane == 0)
    store_status(status + t, status_word(epoch, kInclusive, exclusive + count));
  return exclusive;
}

template <bool kCountOnly>
__global__ void __launch_bounds__(kThreads)
select_kernel(const float* __restrict__ scores, long long n, float thr,
              int vec, long long* __restrict__ out,
              long long* __restrict__ ws, long long* host_total,
              unsigned epoch) {
  __shared__ int warp_sums[kWarps];
  __shared__ long long tile_shared;
  __shared__ uint16_t ranks[kCountOnly ? 1 : kTile];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long tiles = (n + kTile - 1) / kTile;

  long long t = blockIdx.x;
  if (!kCountOnly) {
    if (threadIdx.x == 0) {
      tile_shared = static_cast<long long>(atomicAdd(
          reinterpret_cast<unsigned long long*>(ws + kTicket), 1ull));
      __threadfence();
      if (atomicAdd(reinterpret_cast<unsigned long long*>(ws + kDone), 1ull)
          == gridDim.x - 1ull) {
        ws[kTicket] = 0;                   // every tile has its ticket
        ws[kDone] = 0;
      }
    }
    __syncthreads();
    t = tile_shared;
  }
  const long long tile_base = t * kTile;
  const long long seg = tile_base + warp * kSegment;
  unsigned sel[kVecs][4];
  int in_warp = 0;
#pragma unroll
  for (int j = 0; j < kVecs; ++j) {
    slot_ballots(scores, seg, n, thr, vec != 0, j, sel[j]);
#pragma unroll
    for (int e = 0; e < 4; ++e) in_warp += __popc(sel[j][e]);
  }
  int count;
  int running = warp_offset(in_warp, warp_sums, &count);
  if (kCountOnly) {
    if (threadIdx.x == 0 && count)
      atomicAdd(reinterpret_cast<unsigned long long*>(ws + kTotal),
                static_cast<unsigned long long>(count));
    return;
  }
  // Ranks in record order: slot j, then lane, then the lane's record e.
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int j = 0; j < kVecs; ++j) {
    int r = running;
#pragma unroll
    for (int e = 0; e < 4; ++e) r += __popc(sel[j][e] & below);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if ((sel[j][e] >> lane) & 1u)
        ranks[r++] = static_cast<uint16_t>(warp * kSegment
                                           + 4 * (32 * j + lane) + e);
      running += __popc(sel[j][e]);
    }
  }
  if (warp == 0) {
    const long long prefix = look_back(
        reinterpret_cast<unsigned long long*>(ws + kStatus), t, count,
        epoch);
    if (lane == 0) {
      tile_shared = prefix;
      if (t == tiles - 1) *host_total = prefix + count;
    }
  }
  __syncthreads();
  const long long prefix = tile_shared;
  for (int i = threadIdx.x; i < count; i += kThreads)
    out[prefix + i] = tile_base + ranks[i];
}

}  // namespace

extern "C" {

// Records a tile covers; the wrapper sizes the workspace by it.
int threshold_select_tile() { return kTile; }

// Selecting (`count_only` 0): `out` (capacity n) gets the ascending indices
// of {i : scores[i] >= thr} and `host_total` (pinned host memory the card
// writes to) their count. `ws` is the stream's workspace, 2 + ceil(n /
// tile) int64 words or more, zero when first used; `epoch` (1 to 65535)
// differs from the one of every earlier launch on it since its words were
// last zero. Counting: ws[1] gets the count; `ws` is 2 words of any
// contents, zeroed here on the stream, and `out`, `host_total` and `epoch`
// are not used. One kernel launch (counting: a memset and a launch); with
// `wait`, the call returns once the stream has run it.
int threshold_select_launch(const float* scores, long long n, float thr,
                            long long* out, long long* ws, int count_only,
                            long long* host_total, unsigned epoch, int wait,
                            cudaStream_t stream) {
  const long long tiles = (n + kTile - 1) / kTile;
  cudaError_t err = cudaSuccess;
  if (count_only)
    err = cudaMemsetAsync(ws, 0, 2 * sizeof(long long), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (tiles > 0) {
    const int vec = reinterpret_cast<uintptr_t>(scores) % 16 == 0;
    const dim3 grid(static_cast<unsigned>(tiles));
    if (count_only)
      select_kernel<true><<<grid, kThreads, 0, stream>>>(
          scores, n, thr, vec, out, ws, nullptr, 0u);
    else
      select_kernel<false><<<grid, kThreads, 0, stream>>>(
          scores, n, thr, vec, out, ws, host_total, epoch);
  }
  err = cudaGetLastError();
  if (err == cudaSuccess && wait) err = cudaStreamSynchronize(stream);
  return static_cast<int>(err);
}

const char* threshold_select_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
