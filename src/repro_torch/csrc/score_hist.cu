// score_hist: one-pass proxy-score sketch for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/score_hist/score_hist.py
// (`score_hist`, body `_hist_kernel`), which resolved bin membership with
// one-hot masks on the MXU. Per bin b = min(floor(clip(A,0,1)*B), B-1),
// over records with A >= 0 (the -1 "unscored" sentinel is ignored):
//   counts[b] = |{x in b}|,  sum_w[b] = sum sqrt(A),  sum_a[b] = sum A.
//
// Bound on this card: one read of 4*N bytes at 3.35 TB/s (a 2^22-record
// chunk is 16.8 MB, about 5 us); the output (3*B floats) is negligible.
//
// Design.
// * Each CTA walks a grid-stride slice of the scores (float4 loads when
//   the pointer is 16-byte aligned) and keeps a private histogram in
//   dynamic shared memory: uint32 counts and both sums as unsigned 64-bit
//   fixed point (value * 2^32), 20 bytes a bin (80 KiB at B = 4096, so
//   the kernel opts in above 48 KiB). The CTA then adds its partial into
//   a global 64-bit buffer with integer atomics; a last small kernel
//   converts the totals to the reference's three float32 vectors.
// * Integer addition is associative, so the sketch is the same on every
//   run, at every launch geometry and at every engine worker count. The
//   engine's normalizers come from these sums; float atomics would make
//   them vary from run to run.
// * Proxy scores are skewed (most records of the paper's Beta(0.01, 1)
//   corpora fall in bin 0), which would serialize shared atomics on one
//   address. Each thread therefore keeps a run (bin, count, sums) in
//   registers and flushes it only when the bin changes.
// * Fixed point truncates each value below 2^-32: a sum of N values is
//   low by less than N * 2^-32 (1e-3 at N = 2^22), far inside float32's
//   own rounding of a bin sum.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
// Shared memory a bin takes: a uint32 count and two uint64 sums (the
// wrapper's MAX_BINS, in score_hist/ops.py, is 232448 / kBinBytes).
constexpr int kBinBytes = 20;
constexpr float kScale = 4294967296.0f;   // 2^32
constexpr double kInvScale = 1.0 / 4294967296.0;

struct Run {
  int bin = -1;
  unsigned int count = 0;
  unsigned long long w = 0, a = 0;
};

__device__ __forceinline__ void flush(Run& r, unsigned int* s_c,
                                      unsigned long long* s_w,
                                      unsigned long long* s_a) {
  if (r.bin >= 0) {
    atomicAdd(&s_c[r.bin], r.count);
    atomicAdd(&s_w[r.bin], r.w);
    atomicAdd(&s_a[r.bin], r.a);
  }
}

__device__ __forceinline__ void add(Run& r, float s, int num_bins,
                                    unsigned int* s_c,
                                    unsigned long long* s_w,
                                    unsigned long long* s_a) {
  if (!(s >= 0.0f)) return;                  // sentinel (and NaN) ignored
  const float a = fminf(s, 1.0f);
  const int b = min(static_cast<int>(__fmul_rn(a, static_cast<float>(
                        num_bins))), num_bins - 1);
  if (b != r.bin) {
    flush(r, s_c, s_w, s_a);
    r.bin = b;
    r.count = 0;
    r.w = 0;
    r.a = 0;
  }
  r.count += 1;
  r.w += static_cast<unsigned long long>(__fmul_rn(sqrtf(a), kScale));
  r.a += static_cast<unsigned long long>(__fmul_rn(a, kScale));
}

__global__ void hist_partial(const float* __restrict__ scores, long long n,
                             int num_bins, unsigned long long* g_c,
                             unsigned long long* g_w,
                             unsigned long long* g_a) {
  extern __shared__ unsigned long long smem[];
  unsigned long long* s_w = smem;
  unsigned long long* s_a = smem + num_bins;
  unsigned int* s_c = reinterpret_cast<unsigned int*>(smem + 2 * num_bins);
  for (int i = threadIdx.x; i < num_bins; i += blockDim.x) {
    s_w[i] = 0;
    s_a[i] = 0;
    s_c[i] = 0;
  }
  __syncthreads();

  Run r;
  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x +
                        threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  if ((reinterpret_cast<uintptr_t>(scores) & 15) == 0) {
    const long long n4 = n / 4;
    const float4* v = reinterpret_cast<const float4*>(scores);
    for (long long i = tid; i < n4; i += stride) {
      const float4 q = v[i];
      add(r, q.x, num_bins, s_c, s_w, s_a);
      add(r, q.y, num_bins, s_c, s_w, s_a);
      add(r, q.z, num_bins, s_c, s_w, s_a);
      add(r, q.w, num_bins, s_c, s_w, s_a);
    }
    for (long long i = 4 * n4 + tid; i < n; i += stride)
      add(r, scores[i], num_bins, s_c, s_w, s_a);
  } else {
    for (long long i = tid; i < n; i += stride)
      add(r, scores[i], num_bins, s_c, s_w, s_a);
  }
  flush(r, s_c, s_w, s_a);
  __syncthreads();

  for (int b = threadIdx.x; b < num_bins; b += blockDim.x) {
    if (s_c[b]) {
      atomicAdd(&g_c[b], static_cast<unsigned long long>(s_c[b]));
      atomicAdd(&g_w[b], s_w[b]);
      atomicAdd(&g_a[b], s_a[b]);
    }
  }
}

__global__ void hist_finish(const unsigned long long* g_c,
                            const unsigned long long* g_w,
                            const unsigned long long* g_a, int num_bins,
                            float* out) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b < num_bins) {
    out[b] = static_cast<float>(g_c[b]);
    out[num_bins + b] = static_cast<float>(static_cast<double>(g_w[b]) *
                                           kInvScale);
    out[2 * num_bins + b] = static_cast<float>(static_cast<double>(g_a[b]) *
                                               kInvScale);
  }
}

}  // namespace

extern "C" {

// scores: n float32 on the device. scratch: 3 * num_bins uint64 (zeroed
// here). out: (3, num_bins) float32 = counts, sum_w, sum_a. Launches on
// `stream` and returns cudaGetLastError().
int score_hist_launch(const float* scores, long long n, int num_bins,
                      unsigned long long* scratch, float* out, int grid,
                      cudaStream_t stream) {
  const int smem = kBinBytes * num_bins;
  cudaError_t err = cudaFuncSetAttribute(
      hist_partial, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaMemsetAsync(scratch, 0, 3ull * num_bins * sizeof(*scratch),
                        stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n > 0) {
    hist_partial<<<grid, kThreads, smem, stream>>>(
        scores, n, num_bins, scratch, scratch + num_bins,
        scratch + 2 * num_bins);
  }
  hist_finish<<<(num_bins + 255) / 256, 256, 0, stream>>>(
      scratch, scratch + num_bins, scratch + 2 * num_bins, num_bins, out);
  return static_cast<int>(cudaGetLastError());
}

const char* score_hist_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
