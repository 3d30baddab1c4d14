// flash_attention_bwd: the gradient of causal or non-causal GQA attention
// for Hopper (sm_90a), at head dims (dh, dv) = (64, 64).
//
// Replaces no TPU kernel: the JAX package trains through jnp attention
// (`chunked_causal_attention`, src/repro/models/attention.py) and takes its
// gradient by autodiff, and its Pallas kernel
// (src/repro/kernels/flash_attention/flash_attention.py) has no backward.
// The port runs its forward kernel (flash_attention.cu) where the
// reference runs jnp attention, so training needs this kernel: the port's
// counterpart of the gradient JAX derives. Given q (B,S,H,64), k and v
// (B,S,KV,64), the forward's o (B,S,H,64) and dO = dL/do, it returns dq,
// dk and dv in the inputs' dtype (bf16 or float32), query head h reading
// KV head h / (H/KV), with the forward's mask (key >= S, or key > row when
// causal) and scale 1/√dh. With P = softmax(q·kᵀ/√dh):
//   dv = Pᵀ·dO,  dP = dO·vᵀ,  dS = P ∘ (dP − D),  D = rowsum(dO ∘ o),
//   dq = dS·k/√dh,  dk = dSᵀ·q/√dh.
//
// Bound on this card: operations. At the smollm-360m prefill shape
// (B=4, S=4096, H=15, causal) the gradient's five products take
// 2.5 times the forward's 1.29e11 operations (0.33 ms at 989 TFLOP/s
// bf16) against 168 MB of inputs and outputs (0.05 ms at 3.35 TB/s).
//
// Design: the simple, deterministic one. Three kernels, one stream, each
// in two versions: bf16 on the tensor cores (mma.sync, `mma_*`) and
// float32 on the CUDA cores (`bwd_*`), the card's exact float32 path; both
// sum in float32 and round each output once:
// * `*_stats`: a block a 64-row query tile of one head recomputes the
//   rows' logsumexp of q·kᵀ/√dh (in log2 units) over the key tiles the
//   mask leaves, and D = rowsum(dO ∘ o). (The forward does not keep its
//   logsumexp; taking it from there is later work, ROADMAP.md.)
// * `*_dkdv`: a block a 64-key tile of one KV head holds its k and v
//   tiles and its dk and dv sums in registers, and loops over the group's
//   H/KV query heads and over their query tiles at or below the diagonal:
//   P and dS of each (query tile, key tile) go into dv += Pᵀ·dO and
//   dk += dSᵀ·q. No two blocks write one key's gradient, so
//   GQA needs no atomics.
// * `*_dq`: a block a 64-row query tile of one head loops over the key
//   tiles at or below the diagonal: dq += dS·k.
// float32: every tile lies in shared memory as float32 rows padded to 65
// words, and thread (ty, tx) of 16 x 16 owns rows ty + 16 i and columns
// tx + 16 j (i, j < 4) of each 64 x 64 product, which keeps the warps'
// reads of shared memory free of bank conflicts. bf16: see the note that
// opens its section below.
// Each sum runs in a fixed order and nothing is added by atomics: two
// calls give the same bits. wgmma, TMA and the forward's logsumexp are
// later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int D = 64;         // head dim of q, k and v
constexpr int TILE = 64;      // query rows or keys a tile
constexpr int LD = D + 1;     // row stride of a shared tile, in floats
constexpr int THREADS = 256;  // 16 x 16
constexpr int TILE_FLOATS = TILE * LD;
constexpr int STATS_SMEM = 2 * TILE_FLOATS * 4;
constexpr int DKDV_SMEM = (6 * TILE_FLOATS + 2 * TILE) * 4;
constexpr int DQ_SMEM = (5 * TILE_FLOATS + 2 * TILE) * 4;

// Rows [row0, row0 + TILE) of one head's (S, 64) slab, rows `stride`
// elements apart, into a shared tile; rows past S read as zeros.
__device__ void load_tile(float* tile, const float* src, int row0, int s,
                          long long stride) {
  for (int idx = threadIdx.x; idx < TILE * D; idx += THREADS) {
    const int r = idx / D, c = idx % D, row = row0 + r;
    tile[r * LD + c] = row < s ? src[row * stride + c] : 0.f;
  }
}

// acc[i][j] += sum_d a[row_i][d] * b[col_j][d]   (a·bᵀ)
__device__ __forceinline__ void mm_nt(float (&acc)[4][4], const float* a,
                                      const float* b, int ty, int tx) {
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    float x[4], y[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = a[(ty + 16 * i) * LD + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) y[j] = b[(tx + 16 * j) * LD + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(x[i], y[j], acc[i][j]);
  }
}

// acc[i][j] += sum_r a[r][row_i] * b[r][col_j]   (aᵀ·b)
__device__ __forceinline__ void mm_tn(float (&acc)[4][4], const float* a,
                                      const float* b, int ty, int tx) {
#pragma unroll 8
  for (int r = 0; r < TILE; ++r) {
    float x[4], y[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = a[r * LD + ty + 16 * i];
#pragma unroll
    for (int j = 0; j < 4; ++j) y[j] = b[r * LD + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(x[i], y[j], acc[i][j]);
  }
}

// acc[i][j] += sum_r a[row_i][r] * b[r][col_j]   (a·b)
__device__ __forceinline__ void mm_nn(float (&acc)[4][4], const float* a,
                                      const float* b, int ty, int tx) {
#pragma unroll 8
  for (int r = 0; r < TILE; ++r) {
    float x[4], y[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = a[(ty + 16 * i) * LD + r];
#pragma unroll
    for (int j = 0; j < 4; ++j) y[j] = b[r * LD + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(x[i], y[j], acc[i][j]);
  }
}

__device__ __forceinline__ bool unmasked(int row, int key, int s,
                                         int causal) {
  return row < s && key < s && (!causal || key <= row);
}

// Query tiles a key tile meets: those at or below the diagonal if causal.
__device__ __forceinline__ int first_query_tile(int key_tile, int causal) {
  return causal ? key_tile : 0;
}

// Per-row logsumexp of q·kᵀ/√dh in log2 units and D = rowsum(dO ∘ o),
// each (B, H, S) float32. Block: (query tile, head, batch).
__global__ void __launch_bounds__(THREADS)
    bwd_stats(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ o, const float* __restrict__ dout,
              float* __restrict__ lse, float* __restrict__ delta, int s,
              int h, int kv, int causal, float scale_log2) {
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + TILE_FLOATS;
  const int qt = blockIdx.x, head = blockIdx.y, b = blockIdx.z;
  const int kvh = head / (h / kv);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const long long qstride = (long long)h * D, kstride = (long long)kv * D;
  const long long qoff = ((long long)b * s * h + head) * D;
  const float* kb = k + ((long long)b * s * kv + kvh) * D;
  load_tile(qs, q + qoff, qt * TILE, s, qstride);

  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
  }
  const int n_kt = causal ? qt + 1 : (s + TILE - 1) / TILE;
  for (int kt = 0; kt < n_kt; ++kt) {
    __syncthreads();
    load_tile(ks, kb, kt * TILE, s, kstride);
    __syncthreads();
    float acc[4][4] = {};
    mm_nt(acc, qs, ks, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int row = qt * TILE + ty + 16 * i, key = kt * TILE + tx + 16 * j;
        if (!unmasked(row, key, s, causal)) continue;
        const float x = acc[i][j] * scale_log2;
        if (x > m[i]) {
          l[i] = l[i] * exp2f(m[i] - x) + 1.f;
          m[i] = x;
        } else {
          l[i] += exp2f(x - m[i]);
        }
      }
  }
  // each row's (m, l) over the 16 lanes that share it (one half-warp)
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int off = 8; off >= 1; off >>= 1) {
      const float m2 = __shfl_xor_sync(0xffffffffu, m[i], off);
      const float l2 = __shfl_xor_sync(0xffffffffu, l[i], off);
      const float mx = fmaxf(m[i], m2);
      if (mx != -INFINITY) {
        l[i] = (m[i] == -INFINITY ? 0.f : l[i] * exp2f(m[i] - mx)) +
               (m2 == -INFINITY ? 0.f : l2 * exp2f(m2 - mx));
        m[i] = mx;
      }
    }
  }
  // D over the row's 64 columns: 4 a lane, then the half-warp
  float dsum[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = qt * TILE + ty + 16 * i;
    dsum[i] = 0.f;
    if (row < s) {
      const long long at = qoff + row * qstride;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        dsum[i] = fmaf(dout[at + c], o[at + c], dsum[i]);
      }
    }
#pragma unroll
    for (int off = 8; off >= 1; off >>= 1)
      dsum[i] += __shfl_xor_sync(0xffffffffu, dsum[i], off);
  }
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = qt * TILE + ty + 16 * i;
      if (row < s) {
        const long long at = ((long long)b * h + head) * s + row;
        lse[at] = m[i] + log2f(l[i]);
        delta[at] = dsum[i];
      }
    }
  }
}

// P and dS of query tile `qt` against the key tile held in shared memory:
// p[i][j] and ds[i][j] for rows ty + 16 i, keys tx + 16 j.
__device__ __forceinline__ void softmax_grad(
    float (&p)[4][4], float (&ds)[4][4], const float* qs, const float* dos,
    const float* ks, const float* vs, const float* lse_s, const float* d_s,
    int qt, int kt, int s, int causal, float scale_log2, int ty, int tx) {
  float dp[4][4] = {};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) p[i][j] = 0.f;
  mm_nt(p, qs, ks, ty, tx);
  mm_nt(dp, dos, vs, ty, tx);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = ty + 16 * i;
      const bool on =
          unmasked(qt * TILE + r, kt * TILE + tx + 16 * j, s, causal);
      p[i][j] = on ? exp2f(p[i][j] * scale_log2 - lse_s[r]) : 0.f;
      ds[i][j] = p[i][j] * (dp[i][j] - d_s[r]);
    }
}

// The row statistics of query tile `qt` of one (batch, head) into shared
// memory (0 past S).
__device__ __forceinline__ void load_stats(float* lse_s, float* d_s,
                                           const float* lse,
                                           const float* delta,
                                           long long row0, int qt, int s) {
  if (threadIdx.x < TILE) {
    const int row = qt * TILE + threadIdx.x;
    lse_s[threadIdx.x] = row < s ? lse[row0 + row] : 0.f;
    d_s[threadIdx.x] = row < s ? delta[row0 + row] : 0.f;
  }
}

// dk and dv of one 64-key tile of one KV head. Block: (key tile, KV head,
// batch).
__global__ void __launch_bounds__(THREADS)
    bwd_dkdv(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, const float* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ delta,
             float* __restrict__ dk, float* __restrict__ dv, int s, int h, int kv,
             int causal, float scale_log2, float scale) {
  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = ks + TILE_FLOATS;
  float* qs = vs + TILE_FLOATS;
  float* dos = qs + TILE_FLOATS;
  float* ps = dos + TILE_FLOATS;
  float* dss = ps + TILE_FLOATS;
  float* lse_s = dss + TILE_FLOATS;
  float* d_s = lse_s + TILE;
  const int kt = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int group = h / kv;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const long long qstride = (long long)h * D, kstride = (long long)kv * D;
  const long long koff = ((long long)b * s * kv + kvh) * D;
  load_tile(ks, k + koff, kt * TILE, s, kstride);
  load_tile(vs, v + koff, kt * TILE, s, kstride);

  float dk_acc[4][4] = {}, dv_acc[4][4] = {};
  const int n_qt = (s + TILE - 1) / TILE;
  for (int head = kvh * group; head < (kvh + 1) * group; ++head) {
    const long long qoff = ((long long)b * s * h + head) * D;
    const long long row0 = ((long long)b * h + head) * s;
    for (int qt = first_query_tile(kt, causal); qt < n_qt; ++qt) {
      __syncthreads();
      load_tile(qs, q + qoff, qt * TILE, s, qstride);
      load_tile(dos, dout + qoff, qt * TILE, s, qstride);
      load_stats(lse_s, d_s, lse, delta, row0, qt, s);
      __syncthreads();
      float p[4][4], ds[4][4];
      softmax_grad(p, ds, qs, dos, ks, vs, lse_s, d_s, qt, kt, s, causal,
                   scale_log2, ty, tx);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int at = (ty + 16 * i) * LD + tx + 16 * j;
          ps[at] = p[i][j];
          dss[at] = ds[i][j];
        }
      __syncthreads();
      mm_tn(dv_acc, ps, dos, ty, tx);   // dv[key][e] += P[row][key] dO[row][e]
      mm_tn(dk_acc, dss, qs, ty, tx);   // dk[key][e] += dS[row][key] q[row][e]
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = kt * TILE + ty + 16 * i;
    if (key >= s) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const long long at = koff + key * kstride + tx + 16 * j;
      dk[at] = dk_acc[i][j] * scale;
      dv[at] = dv_acc[i][j];
    }
  }
}

// dq of one 64-row query tile of one head. Block: (query tile, head,
// batch).
__global__ void __launch_bounds__(THREADS)
    bwd_dq(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, const float* __restrict__ dout,
           const float* __restrict__ lse, const float* __restrict__ delta,
           float* __restrict__ dq, int s, int h, int kv, int causal,
           float scale_log2, float scale) {
  extern __shared__ float smem[];
  float* qs = smem;
  float* dos = qs + TILE_FLOATS;
  float* ks = dos + TILE_FLOATS;
  float* vs = ks + TILE_FLOATS;
  float* dss = vs + TILE_FLOATS;
  float* lse_s = dss + TILE_FLOATS;
  float* d_s = lse_s + TILE;
  const int qt = blockIdx.x, head = blockIdx.y, b = blockIdx.z;
  const int kvh = head / (h / kv);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const long long qstride = (long long)h * D, kstride = (long long)kv * D;
  const long long qoff = ((long long)b * s * h + head) * D;
  const long long koff = ((long long)b * s * kv + kvh) * D;
  load_tile(qs, q + qoff, qt * TILE, s, qstride);
  load_tile(dos, dout + qoff, qt * TILE, s, qstride);
  load_stats(lse_s, d_s, lse, delta, ((long long)b * h + head) * s, qt, s);

  float dq_acc[4][4] = {};
  const int n_kt = causal ? qt + 1 : (s + TILE - 1) / TILE;
  for (int kt = 0; kt < n_kt; ++kt) {
    __syncthreads();
    load_tile(ks, k + koff, kt * TILE, s, kstride);
    load_tile(vs, v + koff, kt * TILE, s, kstride);
    __syncthreads();
    float p[4][4], ds[4][4];
    softmax_grad(p, ds, qs, dos, ks, vs, lse_s, d_s, qt, kt, s, causal,
                 scale_log2, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) dss[(ty + 16 * i) * LD + tx + 16 * j] =
          ds[i][j];
    __syncthreads();
    mm_nn(dq_acc, dss, ks, ty, tx);     // dq[row][e] += dS[row][key] k[key][e]
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = qt * TILE + ty + 16 * i;
    if (row >= s) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      dq[qoff + row * qstride + tx + 16 * j] = dq_acc[i][j] * scale;
  }
}

cudaError_t launch_f32(const void* q, const void* k, const void* v,
                       const void* o, const void* dout, void* dq, void* dk,
                       void* dv, float* lse, float* delta, int b, int s,
                       int h, int kv, int causal, float scale_log2,
                       float scale, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      bwd_dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, DKDV_SMEM);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      bwd_dq, cudaFuncAttributeMaxDynamicSharedMemorySize, DQ_SMEM);
  if (err != cudaSuccess) return err;
  const int tiles = (s + TILE - 1) / TILE;
  const dim3 by_query(tiles, h, b), by_key(tiles, kv, b);
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const float* dof = static_cast<const float*>(dout);
  bwd_stats<<<by_query, THREADS, STATS_SMEM, stream>>>(
      qf, kf, static_cast<const float*>(o), dof, lse, delta, s, h, kv,
      causal, scale_log2);
  bwd_dkdv<<<by_key, THREADS, DKDV_SMEM, stream>>>(
      qf, kf, vf, dof, lse, delta, static_cast<float*>(dk),
      static_cast<float*>(dv), s, h, kv, causal, scale_log2, scale);
  bwd_dq<<<by_query, THREADS, DQ_SMEM, stream>>>(
      qf, kf, vf, dof, lse, delta, static_cast<float*>(dq), s, h, kv,
      causal, scale_log2, scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: the same three kernels on the tensor cores (mma.sync m16n8k16, bf16
// operands, float32 sums). A block is 4 warps; warp w owns rows 16w..16w+15
// of the 64-row tile its kernel writes (query rows for the statistics and
// dq, keys for dk and dv), so no two warps add into one output. Tiles lie
// in shared memory as bf16 rows of 72 (64 and 8 of padding, which keeps
// ldmatrix free of bank conflicts). P and dS are rounded to bf16 before
// the products that take them (dv += Pᵀ·dO, dk += dSᵀ·q, dq += dS·k), as
// the forward rounds p before p·v.

constexpr int MMA_THREADS = 128;
constexpr int LDS = D + 8;                 // bf16 row stride of a tile
constexpr int MMA_TILE = TILE * LDS;       // bf16 elements of a tile
constexpr int MMA_STATS_SMEM = 2 * MMA_TILE * 2;
constexpr int MMA_SMEM = 4 * MMA_TILE * 2 + 2 * TILE * 4;

using bf16 = __nv_bfloat16;

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm(uint32_t (&r)[4], const bf16* p) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_t(uint32_t (&r)[4], const bf16* p) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Rows [row0, row0 + TILE) of one head's (S, 64) bf16 slab, rows `stride`
// elements apart, into a shared tile of row stride LDS; zeros past S.
__device__ void load_tile_bf16(bf16* tile, const bf16* src, int row0, int s,
                               long long stride) {
  for (int c = threadIdx.x; c < TILE * D / 8; c += MMA_THREADS) {
    const int r = c / (D / 8), col = (c % (D / 8)) * 8, row = row0 + r;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (row < s) v = *reinterpret_cast<const uint4*>(src + row * stride + col);
    *reinterpret_cast<uint4*>(tile + r * LDS + col) = v;
  }
}

// The A fragments of this warp's 16 rows of a shared tile, k = 0..63.
__device__ __forceinline__ void load_a(uint32_t (&a)[4][4], const bf16* tile,
                                       int lane, int warp) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    ldsm(a[kk], tile + (16 * warp + (lane & 15)) * LDS + 16 * kk +
                    (lane >> 4) * 8);
}

// acc (this warp's 16 rows x 64 columns) += a · bᵀ, b a shared tile stored
// [column][k].
__device__ __forceinline__ void mma_nt(float (&acc)[8][4],
                                       const uint32_t (&a)[4][4],
                                       const bf16* b, int lane) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t f[4];
      ldsm(f, b + (16 * j + (lane & 7) + ((lane >> 4) << 3)) * LDS +
                  16 * kk + ((lane >> 3) & 1) * 8);
      mma(acc[2 * j], a[kk], f[0], f[1]);
      mma(acc[2 * j + 1], a[kk], f[2], f[3]);
    }
}

// acc (16 rows x 64 columns) += a · b, b a shared tile stored [k][column].
__device__ __forceinline__ void mma_nn(float (&acc)[8][4],
                                       const uint32_t (&a)[4][4],
                                       const bf16* b, int lane) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t f[4];
      ldsm_t(f, b + (16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8) * LDS +
                    16 * j + (lane >> 4) * 8);
      mma(acc[2 * j], a[kk], f[0], f[1]);
      mma(acc[2 * j + 1], a[kk], f[2], f[3]);
    }
}

// A fragments (k = the 64 columns) of accumulators c rounded to bf16.
__device__ __forceinline__ void to_a(uint32_t (&a)[4][4],
                                     const float (&c)[8][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    a[kk][0] = pack(c[2 * kk][0], c[2 * kk][1]);
    a[kk][1] = pack(c[2 * kk][2], c[2 * kk][3]);
    a[kk][2] = pack(c[2 * kk + 1][0], c[2 * kk + 1][1]);
    a[kk][3] = pack(c[2 * kk + 1][2], c[2 * kk + 1][3]);
  }
}

__device__ __forceinline__ void zero(float (&c)[8][4]) {
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[n][e] = 0.f;
}

// Accumulator element (n, e) of a lane lies at row g + 8 (e / 2) of the
// warp's 16 and column 8 n + 2 t + e % 2, g = lane / 4, t = lane % 4.
__device__ __forceinline__ int acc_row(int lane, int e) {
  return (lane >> 2) + 8 * (e >> 1);
}
__device__ __forceinline__ int acc_col(int lane, int n, int e) {
  return 8 * n + 2 * (lane & 3) + (e & 1);
}

// D = rowsum(dO ∘ o) of a 64-row query tile: two threads a row.
__device__ __forceinline__ void tile_delta(const bf16* o, const bf16* dout,
                                           float* delta, long long qoff,
                                           long long qstride,
                                           long long row0, int qt, int s) {
  const int r = threadIdx.x >> 1, half = threadIdx.x & 1;
  const int row = qt * TILE + r;
  float sum = 0.f;
  if (row < s) {
    const long long at = qoff + row * qstride + half * 32;
#pragma unroll 8
    for (int c = 0; c < 32; ++c)
      sum = fmaf(__bfloat162float(dout[at + c]), __bfloat162float(o[at + c]),
                 sum);
  }
  sum += __shfl_xor_sync(0xffffffffu, sum, 1);
  if (row < s && half == 0) delta[row0 + row] = sum;
}

__global__ void __launch_bounds__(MMA_THREADS)
    mma_stats(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ o, const bf16* __restrict__ dout,
              float* __restrict__ lse, float* __restrict__ delta, int s,
              int h, int kv, int causal, float scale_log2) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* ks = qs + MMA_TILE;
  const int qt = blockIdx.x, head = blockIdx.y, b = blockIdx.z;
  const int kvh = head / (h / kv);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long qstride = (long long)h * D, kstride = (long long)kv * D;
  const long long qoff = ((long long)b * s * h + head) * D;
  const long long row0 = ((long long)b * h + head) * s;
  const bf16* kb = k + ((long long)b * s * kv + kvh) * D;
  tile_delta(o, dout, delta, qoff, qstride, row0, qt, s);
  load_tile_bf16(qs, q + qoff, qt * TILE, s, qstride);
  __syncthreads();
  uint32_t qf[4][4];
  load_a(qf, qs, lane, warp);

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const int n_kt = causal ? qt + 1 : (s + TILE - 1) / TILE;
  for (int kt = 0; kt < n_kt; ++kt) {
    __syncthreads();
    load_tile_bf16(ks, kb, kt * TILE, s, kstride);
    __syncthreads();
    float acc[8][4];
    zero(acc);
    mma_nt(acc, qf, ks, lane);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = qt * TILE + 16 * warp + (lane >> 2) + 8 * r;
      float mx = -INFINITY;
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e) {
          const int key = kt * TILE + acc_col(lane, n, e);
          acc[n][e] = unmasked(row, key, s, causal)
                          ? acc[n][e] * scale_log2 : -INFINITY;
          mx = fmaxf(mx, acc[n][e]);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx);
      if (m_new == -INFINITY) continue;
      float sum = m[r] == -INFINITY ? 0.f : l[r] * exp2f(m[r] - m_new);
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e)
          sum += acc[n][e] == -INFINITY ? 0.f : exp2f(acc[n][e] - m_new);
      m[r] = m_new;
      l[r] = sum;
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = qt * TILE + 16 * warp + (lane >> 2) + 8 * r;
    if ((lane & 3) == 0 && row < s) lse[row0 + row] = m[r] + log2f(l[r]);
  }
}

// P and dS of the warp's 16 rows against 64 columns from the products s
// (rows · cols) and dp, in place: s becomes P, dp becomes dS. The
// statistics are the rows' (`by_row`) or the columns'.
__device__ __forceinline__ void softmax_grad_mma(
    float (&s_)[8][4], float (&dp)[8][4], const float* lse_s,
    const float* d_s, bool by_row, int qrow0, int kcol0, int s, int causal,
    float scale_log2, int lane, int warp) {
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = 16 * warp + acc_row(lane, e), c = acc_col(lane, n, e);
      const int stat = by_row ? r : c;
      // by_row: rows are queries, columns keys; else the transpose
      const int query = by_row ? qrow0 + r : qrow0 + c;
      const int key = by_row ? kcol0 + c : kcol0 + r;
      const float p = unmasked(query, key, s, causal)
                          ? exp2f(s_[n][e] * scale_log2 - lse_s[stat]) : 0.f;
      s_[n][e] = p;
      dp[n][e] = p * (dp[n][e] - d_s[stat]);
    }
}

__global__ void __launch_bounds__(MMA_THREADS)
    mma_dkdv(const bf16* __restrict__ q, const bf16* __restrict__ k,
             const bf16* __restrict__ v, const bf16* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ delta,
             bf16* __restrict__ dk, bf16* __restrict__ dv, int s, int h,
             int kv, int causal, float scale_log2, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* vs = ks + MMA_TILE;
  bf16* qs = vs + MMA_TILE;
  bf16* dos = qs + MMA_TILE;
  float* lse_s = reinterpret_cast<float*>(dos + MMA_TILE);
  float* d_s = lse_s + TILE;
  const int kt = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int group = h / kv;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long qstride = (long long)h * D, kstride = (long long)kv * D;
  const long long koff = ((long long)b * s * kv + kvh) * D;
  load_tile_bf16(ks, k + koff, kt * TILE, s, kstride);
  load_tile_bf16(vs, v + koff, kt * TILE, s, kstride);
  __syncthreads();
  uint32_t kf[4][4], vf[4][4];
  load_a(kf, ks, lane, warp);
  load_a(vf, vs, lane, warp);

  float dk_acc[8][4], dv_acc[8][4];
  zero(dk_acc);
  zero(dv_acc);
  const int n_qt = (s + TILE - 1) / TILE;
  for (int head = kvh * group; head < (kvh + 1) * group; ++head) {
    const long long qoff = ((long long)b * s * h + head) * D;
    const long long row0 = ((long long)b * h + head) * s;
    for (int qt = first_query_tile(kt, causal); qt < n_qt; ++qt) {
      __syncthreads();
      load_tile_bf16(qs, q + qoff, qt * TILE, s, qstride);
      load_tile_bf16(dos, dout + qoff, qt * TILE, s, qstride);
      if (threadIdx.x < TILE) {
        const int row = qt * TILE + threadIdx.x;
        lse_s[threadIdx.x] = row < s ? lse[row0 + row] : 0.f;
        d_s[threadIdx.x] = row < s ? delta[row0 + row] : 0.f;
      }
      __syncthreads();
      float st[8][4], dpt[8][4];      // (keys of this warp) x (64 queries)
      zero(st);
      zero(dpt);
      mma_nt(st, kf, qs, lane);       // k · qᵀ
      mma_nt(dpt, vf, dos, lane);     // v · dOᵀ
      softmax_grad_mma(st, dpt, lse_s, d_s, false, qt * TILE, kt * TILE, s,
                       causal, scale_log2, lane, warp);
      uint32_t pf[4][4], dsf[4][4];
      to_a(pf, st);
      to_a(dsf, dpt);
      mma_nn(dv_acc, pf, dos, lane);  // dv += Pᵀ · dO
      mma_nn(dk_acc, dsf, qs, lane);  // dk += dSᵀ · q
    }
  }
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; e += 2) {
      const int key = kt * TILE + 16 * warp + acc_row(lane, e);
      if (key >= s) continue;
      const long long at = koff + key * kstride + acc_col(lane, n, e);
      *reinterpret_cast<__nv_bfloat162*>(dk + at) = __floats2bfloat162_rn(
          dk_acc[n][e] * scale, dk_acc[n][e + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + at) =
          __floats2bfloat162_rn(dv_acc[n][e], dv_acc[n][e + 1]);
    }
}

__global__ void __launch_bounds__(MMA_THREADS)
    mma_dq(const bf16* __restrict__ q, const bf16* __restrict__ k,
           const bf16* __restrict__ v, const bf16* __restrict__ dout,
           const float* __restrict__ lse, const float* __restrict__ delta,
           bf16* __restrict__ dq, int s, int h, int kv, int causal,
           float scale_log2, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* dos = qs + MMA_TILE;
  bf16* ks = dos + MMA_TILE;
  bf16* vs = ks + MMA_TILE;
  float* lse_s = reinterpret_cast<float*>(vs + MMA_TILE);
  float* d_s = lse_s + TILE;
  const int qt = blockIdx.x, head = blockIdx.y, b = blockIdx.z;
  const int kvh = head / (h / kv);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long qstride = (long long)h * D, kstride = (long long)kv * D;
  const long long qoff = ((long long)b * s * h + head) * D;
  const long long koff = ((long long)b * s * kv + kvh) * D;
  const long long row0 = ((long long)b * h + head) * s;
  load_tile_bf16(qs, q + qoff, qt * TILE, s, qstride);
  load_tile_bf16(dos, dout + qoff, qt * TILE, s, qstride);
  if (threadIdx.x < TILE) {
    const int row = qt * TILE + threadIdx.x;
    lse_s[threadIdx.x] = row < s ? lse[row0 + row] : 0.f;
    d_s[threadIdx.x] = row < s ? delta[row0 + row] : 0.f;
  }
  __syncthreads();
  uint32_t qf[4][4], dof[4][4];
  load_a(qf, qs, lane, warp);
  load_a(dof, dos, lane, warp);

  float dq_acc[8][4];
  zero(dq_acc);
  const int n_kt = causal ? qt + 1 : (s + TILE - 1) / TILE;
  for (int kt = 0; kt < n_kt; ++kt) {
    __syncthreads();
    load_tile_bf16(ks, k + koff, kt * TILE, s, kstride);
    load_tile_bf16(vs, v + koff, kt * TILE, s, kstride);
    __syncthreads();
    float sc[8][4], dp[8][4];         // (rows of this warp) x (64 keys)
    zero(sc);
    zero(dp);
    mma_nt(sc, qf, ks, lane);         // q · kᵀ
    mma_nt(dp, dof, vs, lane);        // dO · vᵀ
    softmax_grad_mma(sc, dp, lse_s, d_s, true, qt * TILE, kt * TILE, s,
                     causal, scale_log2, lane, warp);
    uint32_t dsf[4][4];
    to_a(dsf, dp);
    mma_nn(dq_acc, dsf, ks, lane);    // dq += dS · k
  }
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; e += 2) {
      const int row = qt * TILE + 16 * warp + acc_row(lane, e);
      if (row >= s) continue;
      *reinterpret_cast<__nv_bfloat162*>(
          dq + qoff + row * qstride + acc_col(lane, n, e)) =
          __floats2bfloat162_rn(dq_acc[n][e] * scale,
                                dq_acc[n][e + 1] * scale);
    }
}

cudaError_t launch_mma(const void* q, const void* k, const void* v,
                       const void* o, const void* dout, void* dq, void* dk,
                       void* dv, float* lse, float* delta, int b, int s,
                       int h, int kv, int causal, float scale_log2,
                       float scale, cudaStream_t stream) {
  const int tiles = (s + TILE - 1) / TILE;
  const dim3 by_query(tiles, h, b), by_key(tiles, kv, b);
  const bf16* qb = static_cast<const bf16*>(q);
  const bf16* kb = static_cast<const bf16*>(k);
  const bf16* vb = static_cast<const bf16*>(v);
  const bf16* dob = static_cast<const bf16*>(dout);
  mma_stats<<<by_query, MMA_THREADS, MMA_STATS_SMEM, stream>>>(
      qb, kb, static_cast<const bf16*>(o), dob, lse, delta, s, h, kv, causal,
      scale_log2);
  mma_dkdv<<<by_key, MMA_THREADS, MMA_SMEM, stream>>>(
      qb, kb, vb, dob, lse, delta, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), s, h, kv, causal, scale_log2, scale);
  mma_dq<<<by_query, MMA_THREADS, MMA_SMEM, stream>>>(
      qb, kb, vb, dob, lse, delta, static_cast<bf16*>(dq), s, h, kv, causal,
      scale_log2, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dq, dk, dv of o = attention(q, k, v): q, o, dout and dq (batch, seq,
// heads, 64), k, v, dk and dv (batch, seq, kv_heads, 64), all contiguous
// and of one dtype (`is_bf16`: bf16, else float32); `lse` and `delta`
// are (batch, heads, seq) float32 scratch. `scale_log2` is log2(e)/√64 and
// `scale` 1/√64.
int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                               const void* o, const void* dout, void* dq,
                               void* dk, void* dv, float* lse, float* delta,
                               int batch, int seq, int heads, int kv_heads,
                               int causal, int is_bf16, float scale_log2,
                               float scale, cudaStream_t stream) {
  if (is_bf16)
    return static_cast<int>(launch_mma(q, k, v, o, dout, dq, dk, dv, lse,
                                       delta, batch, seq, heads, kv_heads,
                                       causal, scale_log2, scale, stream));
  return static_cast<int>(launch_f32(q, k, v, o, dout, dq, dk, dv, lse,
                                     delta, batch, seq, heads, kv_heads,
                                     causal, scale_log2, scale, stream));
}

const char* flash_attention_bwd_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

}  // extern "C"
