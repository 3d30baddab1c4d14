// flash_attention: causal or non-causal GQA attention for Hopper (sm_90a).
//
// Replaces the TPU kernel
// src/repro/kernels/flash_attention/flash_attention.py (`flash_attention`,
// body `_flash_kernel`). Same function: o = softmax(q·kᵀ/√dh)·v per query
// head, query head h reading KV head h / (H/KV), the mask q_pos >= k_pos
// when causal, an online softmax with float32 (m, l, acc) state, and
// 1/max(l, 1e-30) at the end; o is written in q's dtype. Layout is the model
// stack's: q and o (B,S,H,dh), k and v (B,S,KV,dh), all contiguous.
//
// Bound on this card: operations. At the smollm-360m prefill shape
// (B=4, S=4096, H=15, dh=64, causal) the two products take
// 2·2·B·H·(S²/2)·dh = 1.29e11 bf16 operations (0.130 ms at 989 TFLOP/s)
// against 83.9 MB of q, k, v and o (0.025 ms at 3.35 TB/s). At the scoring
// shape (B=256, S=128) the same count is 8.1e9 operations against 168 MB:
// there the bytes bound it.
//
// What the design does about it: both products run on the tensor cores,
// tiles above the diagonal cost nothing, and the S x S scores never leave
// registers, so the kernel moves only q, k, v and o through device memory
// (each K/V tile once per query tile, mostly from L2). It does not yet
// overlap a CTA's loads with its products or use wgmma; it runs about ten
// times its operations bound at the prefill shape (PERF.md).
//
// Design (a simple, correct first version; wgmma/TMA is later work):
// * One CTA per (query tile of 64 rows, head, batch). The TPU's sequential
//   K-block grid axis becomes a loop inside the CTA over K/V tiles, up to
//   the diagonal when causal: tiles strictly above it are never loaded, as
//   `pl.when(diag_ok)` skips them. Query tiles are issued last-first, so
//   the longest causal rows start first.
// * bf16: four warps, each owning 16 query rows. q·kᵀ and p·v run on the
//   tensor cores as mma.sync m16n8k16 (bf16 in, float32 accumulate); the
//   score accumulators are re-packed in registers as the A operand of p·v
//   (p rounded to bf16 there, as flash-attention kernels do), so the S×S
//   scores never leave registers. K is staged row-major and V transposed
//   in shared memory, rows padded by 8 elements so the fragment loads are
//   free of bank conflicts. (m, l, acc) stay in registers.
// * float32: CUDA cores only (no TF32), so the float32 path is exact to
//   float32 rounding. Four threads share a query row, each holding every
//   fourth dimension of q and acc; a row's dot products are summed with
//   two warp shuffles.
// * The ragged last tile is masked (keys past S score -1e30 and read zeros;
//   rows past S are not written), so any S >= 1 runs, where the Pallas
//   kernel asserts S % block == 0.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;                 // query rows a CTA
constexpr int kBK = 64;                 // keys a tile (bf16)
constexpr int kBK32 = 32;               // keys a tile (float32)
constexpr int kThreads16 = 128;         // bf16: 4 warps x 16 rows
constexpr int kThreads32 = 256;         // float32: 64 rows x 4 threads
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void mma_bf16(float (&c)[4],
                                         const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats as a bf16 pair, `lo` in the low half (the lower column).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t load_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Keys this query tile reads: up to the diagonal when causal.
__device__ __forceinline__ int key_tiles(int qt, int seq, int causal,
                                         int bk) {
  const int last = causal ? min(seq - 1, (qt + 1) * kBQ - 1) : seq - 1;
  return last / bk + 1;
}

template <int DH>
__global__ void __launch_bounds__(kThreads16)
flash_bf16(const __nv_bfloat16* __restrict__ q,
           const __nv_bfloat16* __restrict__ k,
           const __nv_bfloat16* __restrict__ v,
           __nv_bfloat16* __restrict__ o, int seq, int heads, int kv_heads,
           int causal, float scale_log2) {
  constexpr int kStrideK = DH + 8;      // K tile row, in elements
  constexpr int kStrideV = kBK + 8;     // transposed V tile row
  constexpr int kChunks = DH / 8;       // 16-byte chunks a row
  __shared__ __align__(16) __nv_bfloat16 ks[kBK * kStrideK];
  __shared__ __align__(16) __nv_bfloat16 vt[DH * kStrideV];

  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const long long batch_off = static_cast<long long>(blockIdx.z) * seq;
  const int kvh = h / (heads / kv_heads);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const long long q_stride = static_cast<long long>(heads) * DH;
  const long long kv_stride = static_cast<long long>(kv_heads) * DH;
  const __nv_bfloat16* qb = q + batch_off * q_stride + h * DH;
  const __nv_bfloat16* kb = k + batch_off * kv_stride + kvh * DH;
  const __nv_bfloat16* vb = v + batch_off * kv_stride + kvh * DH;
  __nv_bfloat16* ob = o + batch_off * q_stride + h * DH;

  // This thread's two rows (the mma fragments' groupID and groupID + 8).
  const int r0 = qt * kBQ + warp * 16 + g, r1 = r0 + 8;
  uint32_t qf[DH / 16][4];
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    const int c = kk * 16 + t4 * 2;
    qf[kk][0] = r0 < seq ? load_pair(qb + r0 * q_stride + c) : 0u;
    qf[kk][1] = r1 < seq ? load_pair(qb + r1 * q_stride + c) : 0u;
    qf[kk][2] = r0 < seq ? load_pair(qb + r0 * q_stride + c + 8) : 0u;
    qf[kk][3] = r1 < seq ? load_pair(qb + r1 * q_stride + c + 8) : 0u;
  }

  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
  float acc[DH / 8][4];
#pragma unroll
  for (int dn = 0; dn < DH / 8; ++dn)
    acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;

  const int n_tiles = key_tiles(qt, seq, causal, kBK);
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();                    // the last tile's reads are done
    for (int i = threadIdx.x; i < kBK * kChunks; i += kThreads16) {
      const int r = i / kChunks, c = (i % kChunks) * 8;
      uint4 kx = make_uint4(0u, 0u, 0u, 0u), vx = kx;
      if (k0 + r < seq) {
        kx = *reinterpret_cast<const uint4*>(kb + (k0 + r) * kv_stride + c);
        vx = *reinterpret_cast<const uint4*>(vb + (k0 + r) * kv_stride + c);
      }
      *reinterpret_cast<uint4*>(&ks[r * kStrideK + c]) = kx;
      const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vx);
#pragma unroll
      for (int j = 0; j < 8; ++j) vt[(c + j) * kStrideV + r] = ve[j];
    }
    __syncthreads();

    // s = q·kᵀ for this warp's 16 rows and the tile's 64 keys.
    float s[kBK / 8][4];
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
#pragma unroll
      for (int n = 0; n < kBK / 8; ++n) {
        const __nv_bfloat16* kr = &ks[(n * 8 + g) * kStrideK + kk * 16 + t4 * 2];
        mma_bf16(s[n], qf[kk], load_pair(kr), load_pair(kr + 8));
      }
    }

    // Online softmax in log2 units; masked keys score -1e30.
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + n * 8 + t4 * 2 + (e & 1);
        const int row = e < 2 ? r0 : r1;
        const bool masked = key >= seq || (causal && key > row);
        s[n][e] = masked ? kNegInf : s[n][e] * scale_log2;
      }
      mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
      mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(kFull, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(kFull, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(kFull, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(kFull, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float c0 = exp2f(m0 - mn0), c1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n) {
      s[n][0] = exp2f(s[n][0] - mn0);
      s[n][1] = exp2f(s[n][1] - mn0);
      s[n][2] = exp2f(s[n][2] - mn1);
      s[n][3] = exp2f(s[n][3] - mn1);
      sum0 += s[n][0] + s[n][1];
      sum1 += s[n][2] + s[n][3];
    }
    l0 = l0 * c0 + sum0;                // this thread's part of the row sum
    l1 = l1 * c1 + sum1;
#pragma unroll
    for (int dn = 0; dn < DH / 8; ++dn) {
      acc[dn][0] *= c0;
      acc[dn][1] *= c0;
      acc[dn][2] *= c1;
      acc[dn][3] *= c1;
    }

    // acc += p·v: score tiles 2kk and 2kk+1 are the A fragment of keys
    // 16kk .. 16kk+15.
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dn = 0; dn < DH / 8; ++dn) {
        const __nv_bfloat16* vr = &vt[(dn * 8 + g) * kStrideV + kk * 16 + t4 * 2];
        mma_bf16(acc[dn], pa, load_pair(vr), load_pair(vr + 8));
      }
    }
  }

  l0 += __shfl_xor_sync(kFull, l0, 1);
  l0 += __shfl_xor_sync(kFull, l0, 2);
  l1 += __shfl_xor_sync(kFull, l1, 1);
  l1 += __shfl_xor_sync(kFull, l1, 2);
  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
#pragma unroll
  for (int dn = 0; dn < DH / 8; ++dn) {
    const int c = dn * 8 + t4 * 2;
    if (r0 < seq)
      *reinterpret_cast<uint32_t*>(ob + r0 * q_stride + c) =
          pack_bf16(acc[dn][0] * inv0, acc[dn][1] * inv0);
    if (r1 < seq)
      *reinterpret_cast<uint32_t*>(ob + r1 * q_stride + c) =
          pack_bf16(acc[dn][2] * inv1, acc[dn][3] * inv1);
  }
}

template <int DH>
__global__ void __launch_bounds__(kThreads32)
flash_f32(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, float* __restrict__ o, int seq,
          int heads, int kv_heads, int causal, float scale_log2) {
  constexpr int kPer = DH / 4;          // dims a thread holds: part + 4*i
  __shared__ float ks[kBK32 * DH];
  __shared__ float vs[kBK32 * DH];

  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const long long batch_off = static_cast<long long>(blockIdx.z) * seq;
  const int kvh = h / (heads / kv_heads);
  const int part = threadIdx.x & 3;
  const int row = qt * kBQ + (threadIdx.x >> 2);
  const long long q_stride = static_cast<long long>(heads) * DH;
  const long long kv_stride = static_cast<long long>(kv_heads) * DH;
  const float* qb = q + batch_off * q_stride + h * DH;
  const float* kb = k + batch_off * kv_stride + kvh * DH;
  const float* vb = v + batch_off * kv_stride + kvh * DH;
  float* ob = o + batch_off * q_stride + h * DH;

  float qr[kPer], acc[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    qr[i] = row < seq ? qb[row * q_stride + part + 4 * i] : 0.f;
    acc[i] = 0.f;
  }
  float m = kNegInf, l = 0.f;

  const int n_tiles = key_tiles(qt, seq, causal, kBK32);
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBK32;
    __syncthreads();
    for (int i = threadIdx.x; i < kBK32 * DH; i += kThreads32) {
      const int r = i / DH, c = i % DH;
      const bool in = k0 + r < seq;
      ks[i] = in ? kb[(k0 + r) * kv_stride + c] : 0.f;
      vs[i] = in ? vb[(k0 + r) * kv_stride + c] : 0.f;
    }
    __syncthreads();

    float s[kBK32];
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < kBK32; ++j) {
      float d = 0.f;
#pragma unroll
      for (int i = 0; i < kPer; ++i) d = fmaf(qr[i], ks[j * DH + part + 4 * i], d);
      d += __shfl_xor_sync(kFull, d, 1);
      d += __shfl_xor_sync(kFull, d, 2);
      const int key = k0 + j;
      const bool masked = key >= seq || (causal && key > row);
      s[j] = masked ? kNegInf : d * scale_log2;
      mx = fmaxf(mx, s[j]);
    }
    const float mn = fmaxf(m, mx);
    const float corr = exp2f(m - mn);
    m = mn;
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < kPer; ++i) acc[i] *= corr;
#pragma unroll
    for (int j = 0; j < kBK32; ++j) {
      const float p = exp2f(s[j] - mn);
      sum += p;
#pragma unroll
      for (int i = 0; i < kPer; ++i) acc[i] = fmaf(p, vs[j * DH + part + 4 * i], acc[i]);
    }
    l = l * corr + sum;
  }

  if (row < seq) {
    const float denom = fmaxf(l, 1e-30f);
#pragma unroll
    for (int i = 0; i < kPer; ++i) ob[row * q_stride + part + 4 * i] = acc[i] / denom;
  }
}

template <typename T>
using Kernel = void (*)(const T*, const T*, const T*, T*, int, int, int, int,
                        float);

}  // namespace

extern "C" {

// o = attention(q, k, v): q, o (batch, seq, heads, head_dim); k, v
// (batch, seq, kv_heads, head_dim); bf16 if `is_bf16`, else float32.
// head_dim is 64 or 128; the wrapper checks shapes, types and alignment.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, int batch, int seq, int heads,
                           int kv_heads, int head_dim, int is_bf16,
                           int causal, float scale_log2,
                           cudaStream_t stream) {
  if (head_dim != 64 && head_dim != 128)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((seq + kBQ - 1) / kBQ, heads, batch);
  if (is_bf16) {
    const Kernel<__nv_bfloat16> kernel =
        head_dim == 64 ? &flash_bf16<64> : &flash_bf16<128>;
    kernel<<<grid, kThreads16, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v),
        static_cast<__nv_bfloat16*>(o), seq, heads, kv_heads, causal,
        scale_log2);
  } else {
    const Kernel<float> kernel = head_dim == 64 ? &flash_f32<64> : &flash_f32<128>;
    kernel<<<grid, kThreads32, 0, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), seq, heads,
        kv_heads, causal, scale_log2);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
