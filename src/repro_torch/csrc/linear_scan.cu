// linear_scan: the diagonal-decay linear recurrence of Mamba2 and RWKV6 for
// Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/linear_scan/linear_scan.py
// (`linear_scan`, body `_scan_kernel`). Same function, from a zero state:
//
//   S_t = diag(w_t) S_{t-1} + k_tᵀ v_t          (S is dk x dv, float32)
//   o_t = q_t S_t                                (Mamba2: no bonus u)
//   o_t = q_t S_{t-1} + (q_t · u · k_t) v_t      (RWKV6: bonus u)
//
// returning o and the final state in float32. w is clipped to
// [1e-6, 1], as the JAX models' path (`scan_ops.linear_scan_chunked`) clips
// it. There is no floor on the log decay: the kernel multiplies the state
// by w_t step by step and forms no decay ratio, so no value can overflow
// whatever the decay. The Pallas kernel factors the ratios as q·L and k/L
// inside a chunk and floors each step's log decay at -2.5 to keep L in
// range; at its wrapper's default chunk of 128 it is non-finite even at
// w = 0.3, and below the floor it is not the recurrence.
//
// Bound on this card: operations. A step does five float32 operations per
// state element (k·v, the decay's multiply-add, q·S's multiply-add), so at
// Zamba2's prefill shape (B=4, H=64, S=4096, dk=dv=64) the work is
// 5·B·H·S·dk·dv = 2.15e10 operations (0.32 ms at 67 TFLOP/s float32)
// against about 550 MB of inputs and outputs (0.16 ms at 3.35 TB/s): v
// and o in float32 dominate; q and k are Mamba2's B and C, shared by all
// heads, and w its scalar decay per head, which the wrapper passes as
// broadcast views (stride 0), so the kernel reads each of them from device
// memory once per block that needs it and never materializes (B,H,S,dk).
//
// What the design does about it: the state never leaves registers, each
// input element is read from device memory once per block, and all the
// arithmetic is float32 on the CUDA cores: a multiply and two fused
// multiply-adds per state element a step, the fewest the exact recurrence
// allows. The TPU's sequential chunk axis becomes a loop inside the block.
// The recurrence runs step by step, not in the chunked (matrix) form: that
// form would do more operations on the CUDA cores and needs the decay
// ratios this kernel avoids; moving the chunked form to the tensor cores
// is later work.
//
// Design:
// * One block of 4 warps per (batch, head), holding the whole 64 x 64
//   state (dk, dv <= 64; rows past dk and columns past dv stay zero and
//   are never written). A thread holds an 8 x 4 tile: lane bits 0-2 pick
//   its row group, bits 3-4 and the warp its 4 columns. Reusing each q, k
//   and w value across 4 columns and each v value across 8 rows keeps the
//   shared-memory reads at 6 a step for 96 floating-point instructions.
// * A loop over chunks of 16 steps, double-buffered: while the threads run
//   one chunk's steps out of shared memory, their loads of the next
//   chunk's q, k, w (clipped when stored) and v are in flight into
//   registers, and go to the other buffer after the steps. A step stores
//   each thread's share of q·S (its 8 rows, 4 columns) in shared memory;
//   after the chunk the block sums the 8 row groups of every output in a
//   fixed order and writes o, coalesced. Two __syncthreads a chunk; no
//   shuffle chain a step. The last chunk may be ragged: any S >= 1 runs,
//   where the Pallas kernel asserts S % chunk == 0.
// * Inputs are read through the strides the wrapper gives (element
//   strides of (batch, head, step, dim) for q, k, w, v and o); q and k are
//   bf16 or float32, each its own instantiation, and v, o and w float32
//   (Mamba2's v = dt·x is float32 in either model dtype). A w with dim
//   stride 0 (a scalar decay per head, Mamba2) is read once a step.
// * No atomics and a fixed order of every sum: the output is the same at
//   every launch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kDkMax = 64;                   // state rows a block holds
constexpr int kCols = 64;                    // state columns a block holds
constexpr int kRows = 8;                     // state rows a thread holds
constexpr int kColsT = 4;                    // state columns a thread holds
constexpr int kRowGroups = kDkMax / kRows;   // 8: lanes summing a column
constexpr int kThreads = kRowGroups * (kCols / kColsT);   // 128
constexpr int kSteps = 16;                   // steps staged at a time
constexpr unsigned kFull = 0xffffffffu;
constexpr float kWMin = 1e-6f;

// Element strides of a (batch, head, step, dim) tensor.
struct Strides4 {
  long long b, h, s, d;
};

struct Args {
  const void* q;           // q and k: TQK
  const void* k;
  const float* v;
  const float* w;
  const float* u;          // (heads, dk), or null
  float* o;
  float* state;            // (batch, heads, dk, dv), contiguous
  Strides4 sq, sk, sv, sw, so;
  int heads, seq, dk, dv;
};

// Element i of p as float32, through the read-only cache.
template <typename T>
__device__ __forceinline__ float load(const void* p, long long i) {
  if constexpr (sizeof(T) == 2)
    return __bfloat162float(__ldg(static_cast<const __nv_bfloat16*>(p) + i));
  else
    return __ldg(static_cast<const float*>(p) + i);
}

// Row of the state held in register row r (0..7) of a thread of row group
// g (0..7): the eight groups' float4 reads of one step's q, k or w fall on
// 128 contiguous bytes, one shared-memory wavefront.
__device__ __forceinline__ int state_row(int g, int r) {
  return (r / 4) * (4 * kRowGroups) + 4 * g + r % 4;
}

// A thread's share of one chunk's inputs, in registers between its load
// from device memory and its store to shared memory. Thread tid loads dim
// tid % 64 of q, k and w and column tid % 64 of v at steps tid / 64 + 2j.
constexpr int kPerQ = kSteps * kDkMax / kThreads;    // 8 of q, k and w
constexpr int kPerV = kSteps * kCols / kThreads;     // 8 of v
constexpr int kStepQ = kThreads / kDkMax, kStepV = kThreads / kCols;

template <bool kScalarW>
struct Stage {
  float q[kPerQ], k[kPerQ], w[kScalarW ? 1 : kPerQ], v[kPerV];
};

// Padding of a row of partial sums: row group g's float4 stores start 4g
// banks apart, so the eight groups of a quarter warp never collide.
constexpr int kPartPad = 4;

template <bool kScalarW>
struct Smem {
  float q[2][kSteps][kDkMax];
  float k[2][kSteps][kDkMax];
  float w[2][kSteps][kScalarW ? 1 : kDkMax];
  float v[2][kSteps][kCols];
  float part[kSteps][kRowGroups][kCols + kPartPad];   // a chunk's q·S sums
};

template <typename TQK, bool kScalarW>
__device__ __forceinline__ void load_chunk(const Args& a, long long qb,
                                           long long kb, long long vb,
                                           long long wb, int t0,
                                           Stage<kScalarW>& x) {
  // Pointers advance by whole steps, so each load costs one 64-bit add.
  const int tid = threadIdx.x, n = min(kSteps, a.seq - t0);
  const int si = tid % kDkMax, vj = tid % kCols, st = tid / kDkMax;
  const bool row_in = si < a.dk, col_in = vj < a.dv;
  const long long t = t0 + st;
  const TQK* qp = static_cast<const TQK*>(a.q) + qb + t * a.sq.s + si * a.sq.d;
  const TQK* kp = static_cast<const TQK*>(a.k) + kb + t * a.sk.s + si * a.sk.d;
  const float* wp = a.w + wb + t * a.sw.s + si * a.sw.d;
  const float* vp = a.v + vb + t * a.sv.s + vj * a.sv.d;
#pragma unroll
  for (int j = 0; j < kPerQ; ++j) {
    const bool in = st + j * kStepQ < n && row_in;
    x.q[j] = in ? load<TQK>(qp, 0) : 0.f;
    x.k[j] = in ? load<TQK>(kp, 0) : 0.f;
    if constexpr (!kScalarW) {
      x.w[j] = in ? load<float>(wp, 0) : 0.f;
      wp += kStepQ * a.sw.s;
    }
    qp += kStepQ * a.sq.s;
    kp += kStepQ * a.sk.s;
  }
  if constexpr (kScalarW)
    x.w[0] = tid < n ? load<float>(a.w, wb + (t0 + tid) * a.sw.s) : 0.f;
#pragma unroll
  for (int j = 0; j < kPerV; ++j) {
    x.v[j] = st + j * kStepV < n && col_in ? load<float>(vp, 0) : 0.f;
    vp += kStepV * a.sv.s;
  }
}

template <bool kScalarW>
__device__ __forceinline__ void store_chunk(Smem<kScalarW>& sm, int buf,
                                            const Stage<kScalarW>& x) {
  const int tid = threadIdx.x, si = tid % kDkMax, vj = tid % kCols;
#pragma unroll
  for (int j = 0; j < kPerQ; ++j) {
    const int t = tid / kDkMax + j * kStepQ;
    sm.q[buf][t][si] = x.q[j];
    sm.k[buf][t][si] = x.k[j];
    if constexpr (!kScalarW)
      sm.w[buf][t][si] = fminf(fmaxf(x.w[j], kWMin), 1.f);
  }
  if constexpr (kScalarW)
    if (tid < kSteps) sm.w[buf][tid][0] = fminf(fmaxf(x.w[0], kWMin), 1.f);
#pragma unroll
  for (int j = 0; j < kPerV; ++j)
    sm.v[buf][tid / kCols + j * kStepV][vj] = x.v[j];
}

template <typename TQK, bool kBonus, bool kScalarW>
__global__ void __launch_bounds__(kThreads) scan_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  Smem<kScalarW>& sm = *reinterpret_cast<Smem<kScalarW>*>(smem);

  const int bh = blockIdx.x;
  const int b = bh / a.heads, h = bh % a.heads;
  const int tid = threadIdx.x, lane = tid & 31;
  // A warp holds 16 columns: lane bits 0-2 pick the row group, bits 3-4
  // the thread's 4 columns within the warp's.
  const int g = lane & (kRowGroups - 1);
  const int c0 = (tid >> 5) * 16 + (lane >> 3) * kColsT;

  const long long qb = b * a.sq.b + h * a.sq.h, kb = b * a.sk.b + h * a.sk.h;
  const long long vb = b * a.sv.b + h * a.sv.h, wb = b * a.sw.b + h * a.sw.h;
  const long long ob = b * a.so.b + h * a.so.h;

  float u[kRows];
  float s[kRows][kColsT];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int i = state_row(g, r);
    u[r] = (kBonus && i < a.dk) ? a.u[h * a.dk + i] : 0.f;
#pragma unroll
    for (int j = 0; j < kColsT; ++j) s[r][j] = 0.f;
  }

  Stage<kScalarW> next;
  load_chunk<TQK>(a, qb, kb, vb, wb, 0, next);
  store_chunk(sm, 0, next);
  __syncthreads();
  const int chunks = (a.seq + kSteps - 1) / kSteps;
  for (int ci = 0; ci < chunks; ++ci) {
    const int buf = ci & 1, t0 = ci * kSteps;
    const int n = min(kSteps, a.seq - t0);
    const bool more = ci + 1 < chunks;
    // the next chunk's loads are in flight during this chunk's steps
    if (more) load_chunk<TQK>(a, qb, kb, vb, wb, t0 + kSteps, next);

    for (int t = 0; t < n; ++t) {
      const float4 v4 = *reinterpret_cast<const float4*>(&sm.v[buf][t][c0]);
      const float vv[kColsT] = {v4.x, v4.y, v4.z, v4.w};
      float acc[kColsT] = {0.f, 0.f, 0.f, 0.f};
      float bonus = 0.f;
#pragma unroll
      for (int m = 0; m < kRows / 4; ++m) {
        const int i0 = m * 4 * kRowGroups + 4 * g;
        const float4 q4 = *reinterpret_cast<const float4*>(&sm.q[buf][t][i0]);
        const float4 k4 = *reinterpret_cast<const float4*>(&sm.k[buf][t][i0]);
        const float qv[4] = {q4.x, q4.y, q4.z, q4.w};
        const float kv[4] = {k4.x, k4.y, k4.z, k4.w};
        float wv[4];
        if constexpr (kScalarW) {
          wv[0] = wv[1] = wv[2] = wv[3] = sm.w[buf][t][0];
        } else {
          const float4 w4 = *reinterpret_cast<const float4*>(&sm.w[buf][t][i0]);
          wv[0] = w4.x; wv[1] = w4.y; wv[2] = w4.z; wv[3] = w4.w;
        }
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const int r = 4 * m + x;
          if constexpr (kBonus) bonus = fmaf(qv[x] * u[r], kv[x], bonus);
#pragma unroll
          for (int j = 0; j < kColsT; ++j) {
            const float add = kv[x] * vv[j];
            if constexpr (kBonus) {
              acc[j] = fmaf(qv[x], s[r][j], acc[j]);     // reads S_{t-1}
              s[r][j] = fmaf(wv[x], s[r][j], add);
            } else {
              s[r][j] = fmaf(wv[x], s[r][j], add);
              acc[j] = fmaf(qv[x], s[r][j], acc[j]);     // reads S_t
            }
          }
        }
      }
      if constexpr (kBonus) {
#pragma unroll
        for (int j = 0; j < kColsT; ++j) acc[j] = fmaf(bonus, vv[j], acc[j]);
      }
      // this row group's share of o_t; the groups are summed per chunk
      *reinterpret_cast<float4*>(&sm.part[t][g][c0]) =
          make_float4(acc[0], acc[1], acc[2], acc[3]);
    }

    // The other buffer was last read in the previous chunk's steps, which
    // every thread finished before the previous __syncthreads.
    if (more) store_chunk(sm, buf ^ 1, next);
    __syncthreads();
    // o over the chunk: thread tid sums the eight row groups of column
    // tid % 64 at steps tid / 64 + 2i, in a fixed order.
    const int j = tid % kCols;
#pragma unroll
    for (int i = 0; i < kSteps / kStepV; ++i) {
      const int t = tid / kCols + i * kStepV;
      if (t < n && j < a.dv) {
        float o = 0.f;
#pragma unroll
        for (int gg = 0; gg < kRowGroups; ++gg) o += sm.part[t][gg][j];
        a.o[ob + (t0 + t) * a.so.s + j * a.so.d] = o;
      }
    }
    __syncthreads();   // the next chunk's steps overwrite the sums
  }

  float* out = a.state + (static_cast<long long>(bh) * a.dk) * a.dv;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int i = state_row(g, r);
#pragma unroll
    for (int jj = 0; jj < kColsT; ++jj)
      if (i < a.dk && c0 + jj < a.dv) out[i * a.dv + c0 + jj] = s[r][jj];
  }
}

using Kernel = void (*)(const Args);

template <typename TQK>
Kernel pick(bool bonus, bool scalar_w) {
  return bonus ? (scalar_w ? &scan_kernel<TQK, true, true>
                           : &scan_kernel<TQK, true, false>)
               : (scalar_w ? &scan_kernel<TQK, false, true>
                           : &scan_kernel<TQK, false, false>);
}

}  // namespace

extern "C" {

// o, state = linear_scan(q, k, v, w, u): q, k, w (batch, heads, seq, dk),
// v and o (batch, heads, seq, dv) at the element strides in `strides`
// (q, k, v, w, o; each batch, head, step, dim: 20 values); state
// (batch, heads, dk, dv) float32 contiguous; u (heads, dk) float32
// contiguous, or null for Mamba2's post-update read. q and k are bf16 if
// `qk_bf16`, else float32; v, o and w are float32. dk and dv are at most
// 64; the wrapper checks shapes and types.
int linear_scan_launch(const void* q, const void* k, const float* v,
                       const float* w, const float* u, float* o,
                       float* state, int batch, int heads, int seq, int dk,
                       int dv, int qk_bf16, const long long* strides,
                       cudaStream_t stream) {
  if (dk < 1 || dk > kDkMax || dv < 1 || dv > kCols || seq < 1 || batch < 1 ||
      heads < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.q = q; a.k = k; a.v = v; a.w = w; a.u = u; a.o = o; a.state = state;
  Strides4* dst[5] = {&a.sq, &a.sk, &a.sv, &a.sw, &a.so};
  for (int i = 0; i < 5; ++i)
    *dst[i] = Strides4{strides[4 * i], strides[4 * i + 1],
                       strides[4 * i + 2], strides[4 * i + 3]};
  a.heads = heads; a.seq = seq; a.dk = dk; a.dv = dv;
  const long long blocks = static_cast<long long>(batch) * heads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const bool bonus = u != nullptr, scalar_w = a.sw.d == 0 || dk == 1;
  const Kernel kernel = qk_bf16 ? pick<__nv_bfloat16>(bonus, scalar_w)
                                : pick<float>(bonus, scalar_w);
  const int smem = scalar_w ? sizeof(Smem<true>) : sizeof(Smem<false>);
  const cudaError_t set = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (set != cudaSuccess) return static_cast<int>(set);
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

const char* linear_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
