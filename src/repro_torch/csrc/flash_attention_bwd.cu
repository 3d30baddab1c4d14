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
// (B,S,KV,64), the forward's o (B,S,H,64) and its rows' logsumexp `lse`
// ((B, H, s_pad) float32, natural units, s_pad = S rounded up to 128: the
// forward kernel writes it), and dO = dL/do, it returns dq, dk and dv in
// the inputs' dtype (bf16 or float32), query head h reading KV head
// h / (H/KV), with the forward's mask (key >= S, or key > row when causal)
// and scale 1/√dh. With P = exp(q·kᵀ/√dh − lse):
//   dv = Pᵀ·dO,  dP = dO·vᵀ,  dS = P ∘ (dP − D),  D = rowsum(dO ∘ o),
//   dq = dS·k/√dh,  dk = dSᵀ·q/√dh.
//
// Bound on this card: operations. The gradient's five products (q·kᵀ
// again, dO·vᵀ, Pᵀ·dO, dSᵀ·q, dS·k) are 2.5 times the forward's two: at
// the smollm-360m training shape (B=4, S=4096, H=15, causal) 3.22e11 bf16
// operations, 0.326 ms at 989 TFLOP/s, against 168 MB of inputs and
// outputs (0.05 ms at 3.35 TB/s).
//
// bf16 design: two launches on one stream, both persistent (one CTA an
// SM) with the forward's shape: a producer warpgroup whose first thread
// issues every TMA load and gives its registers away (setmaxnreg), and two
// consumer warpgroups of 64 rows each on wgmma m64n64k16 (bf16 operands,
// float32 sums). CTAs take work tiles from a counter in device memory,
// longest first; the last CTA of each launch resets it, so no launch needs
// a memset. Tiles lie in shared memory as the forward's: 64 columns of
// 128-byte rows with the 128-byte swizzle, written by TMA from 4-D tensor
// maps over (head dim, heads, S, batch), rows past S read as zeros.
// * `dq_wgmma`, over query tiles of 128 rows of one head: each row's
//   D = rowsum(dO ∘ o), read once from device memory and written to a
//   (B, H, s_pad) scratch for the second launch; then over the key tiles
//   the mask leaves, 64 keys a stage of a 4-deep ring of k and v tiles:
//   S = q·kᵀ and dP = dO·vᵀ with both operands in shared memory, P and dS
//   in registers, and dq += dS·k with dS as the register A operand (the
//   accumulator re-packed to bf16, as the forward re-packs p) and k read
//   as it lies (MN-major). q and dO are double-buffered across work tiles.
// * `dkdv_wgmma`, over key tiles of 128 keys of one KV head: k and v stay in
//   shared memory and dk, dv in registers while the group's H/KV query
//   heads and their query tiles at or below the diagonal stream through a
//   4-deep ring (64 rows of q and dO, 64 floats of lse and of D a stage;
//   the statistics by 1-D bulk copies). Sᵀ = k·qᵀ and dPᵀ = v·dOᵀ, so Pᵀ
//   and dSᵀ come out as register A operands; then dv += Pᵀ·dO and
//   dk += dSᵀ·q read dO and q MN-major. No two CTAs write one key's
//   gradient, so GQA needs no atomics.
// * In both, the two consumer warpgroups take turns issuing to the tensor
//   cores (named barriers, as in the forward), warpgroup 1 half a step
//   behind the other, so one's exp2s run while the other's products do.
//   Free-running, the two tend to fall into step (both wait on the same
//   stage and issue together), and the tensor cores idle while both
//   compute exp2s; with the turns the backward ran 4-10% faster
//   (tools/flash_ab.py and chip_smoke.py before and after, PERF.md §6).
// Seven products in all: q·kᵀ and dO·vᵀ run once in each launch. The five
// of the bound would need dq summed across key tiles by atomics
// (FlashAttention-3), whose order changes from run to run; the repeat
// costs 2/5 more operations and keeps every sum in a fixed order. No
// statistics pass: P comes from the forward's logsumexp. P and dS are
// rounded to bf16 before the products that take them, as the forward
// rounds p before p·v; each output is rounded once.
//
// float32 (`bwd_*`): the card's exact float32 arbiter, on the CUDA cores,
// three launches: D = rowsum(dO ∘ o) (`bwd_delta`), dk and dv over key
// tiles, dq over query tiles, each a 64-row tile of a block, P from the
// forward's lse as in bf16. Every tile lies in shared memory as float32
// rows padded to 65 words, and thread (ty, tx) of 16 x 16 owns rows
// ty + 16 i and columns tx + 16 j (i, j < 4) of each 64 x 64 product.
//
// Each sum runs in a fixed order and nothing is added by atomics: two
// calls give the same bits.
#include <math.h>

#include "hopper.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;

constexpr int D = 64;         // head dim of q, k and v
constexpr int TILE = 64;      // query rows or keys a tile
constexpr int LD = D + 1;     // row stride of a shared tile, in floats
constexpr int THREADS = 256;  // 16 x 16
constexpr int TILE_FLOATS = TILE * LD;
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

// D = rowsum(dO ∘ o) of one 64-row query tile into the (B, H, s_pad)
// scratch. Block: (query tile, head, batch).
__global__ void __launch_bounds__(THREADS)
    bwd_delta(const float* __restrict__ o, const float* __restrict__ dout,
              float* __restrict__ delta, int s, int s_pad, int h) {
  const int qt = blockIdx.x, head = blockIdx.y, b = blockIdx.z;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const long long qstride = (long long)h * D;
  const long long qoff = ((long long)b * s * h + head) * D;
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
      if (row < s) delta[((long long)b * h + head) * s_pad + row] = dsum[i];
    }
  }
}

// P and dS of query tile `qt` against the key tile held in shared memory:
// p[i][j] and ds[i][j] for rows ty + 16 i, keys tx + 16 j; lse_s in log2
// units.
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
// memory: lse in log2 units, and D (0 past S).
__device__ __forceinline__ void load_stats(float* lse_s, float* d_s,
                                           const float* lse,
                                           const float* delta,
                                           long long row0, int qt, int s) {
  if (threadIdx.x < TILE) {
    const int row = qt * TILE + threadIdx.x;
    lse_s[threadIdx.x] = row < s ? lse[row0 + row] * kLog2e : 0.f;
    d_s[threadIdx.x] = row < s ? delta[row0 + row] : 0.f;
  }
}

// dk and dv of one 64-key tile of one KV head. Block: (key tile, KV head,
// batch).
__global__ void __launch_bounds__(THREADS)
    bwd_dkdv(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, const float* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ delta,
             float* __restrict__ dk, float* __restrict__ dv, int s, int s_pad,
             int h, int kv, int causal, float scale_log2, float scale) {
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
    const long long row0 = ((long long)b * h + head) * s_pad;
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
           float* __restrict__ dq, int s, int s_pad, int h, int kv,
           int causal, float scale_log2, float scale) {
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
  load_stats(lse_s, d_s, lse, delta, ((long long)b * h + head) * s_pad, qt,
             s);

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
                       const void* o, const void* dout, const float* lse,
                       void* dq, void* dk, void* dv, float* delta, int b,
                       int s, int s_pad, int h, int kv, int causal,
                       float scale_log2, float scale, cudaStream_t stream) {
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
  bwd_delta<<<by_query, THREADS, 0, stream>>>(
      static_cast<const float*>(o), dof, delta, s, s_pad, h);
  bwd_dkdv<<<by_key, THREADS, DKDV_SMEM, stream>>>(
      qf, kf, vf, dof, lse, delta, static_cast<float*>(dk),
      static_cast<float*>(dv), s, s_pad, h, kv, causal, scale_log2, scale);
  bwd_dq<<<by_query, THREADS, DQ_SMEM, stream>>>(
      qf, kf, vf, dof, lse, delta, static_cast<float*>(dq), s, s_pad, h, kv,
      causal, scale_log2, scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 on wgmma with TMA loads (see the note at the top).

using bf16 = __nv_bfloat16;

constexpr int kThreadsBf16 = 384;       // producer + 2 consumer warpgroups
constexpr int kConsumerWarps = 8;
constexpr int kStatBytes = 256;         // 64 floats of lse or D

// The two consumer warpgroups take turns issuing to the tensor cores
// (named barriers `mine` and `theirs`), warpgroup 1 half a step behind:
// in each work tile its first turn is empty (`turns_begin`) and so is
// warpgroup 0's last (`turns_end`), so each one's exp2s run while the
// other's products do, and both leave the tile together: carried across
// tiles, warpgroup 0 would wait for the next tile's k and v, which wait
// for warpgroup 1 to free this tile's, which waits for warpgroup 0's turn.
__device__ __forceinline__ void turns_begin(int wg, uint32_t mine,
                                            uint32_t theirs) {
  if (wg == 1) {
    named_arrive(theirs);
    named_sync(mine);
    named_arrive(theirs);
  }
}

__device__ __forceinline__ void turns_end(int wg, uint32_t mine,
                                          uint32_t theirs) {
  if (wg == 0) {
    named_sync(mine);
    named_arrive(theirs);
    named_sync(mine);
  }
}

// `dq_wgmma`: work tiles of 128 query rows; k and v in stages of 64 keys.
// Shared memory from a 1024-aligned base: two buffers of q then dO
// (16 KB each), then the ring's stages of k then v (8 KB each).
constexpr int kDqRows = 128;
constexpr int kDqKeys = 64;
constexpr int kDqStages = 4;
constexpr int kDqQBufs = 2;
constexpr int kDqTile = kDqRows * kRowBytes;         // q or dO of a tile
constexpr int kDqKV = kDqKeys * kRowBytes;           // k or v of a stage
constexpr int kDqRing = kDqQBufs * 2 * kDqTile;
constexpr int kDqSmem = kDqRing + kDqStages * 2 * kDqKV + 1024;

// `dkdv_wgmma`: work tiles of 128 keys; q, dO, lse and D in stages of 64
// query rows. Shared memory from a 1024-aligned base: k then v (16 KB
// each), then the ring's stages: q, dO (8 KB each), lse, D (256 B each),
// padded to 1024 bytes.
constexpr int kKvKeys = 128;
constexpr int kKvRows = 64;
constexpr int kKvStages = 4;
constexpr int kKvTile = kKvKeys * kRowBytes;         // k or v of a tile
constexpr int kKvQ = kKvRows * kRowBytes;            // q or dO of a stage
constexpr int kKvStage = 2 * kKvQ + 1024;
constexpr int kKvRing = 2 * kKvTile;
constexpr int kKvSmem = kKvRing + kKvStages * kKvStage + 1024;
static_assert(2 * kKvQ + 2 * kStatBytes <= kKvStage, "stage");
static_assert(kDqSmem <= 232448 - 128 && kKvSmem <= 232448 - 128, "smem");

// `bytes` (a multiple of 16) from 16-byte aligned device memory.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes),
         "r"(bar)
      : "memory");
}

// d (64 x 64, float32) = a · bᵀ over 16 columns, a (64 x 16) and b
// (64 x 16) bf16 in shared memory, both K-major; d is overwritten if
// !accumulate.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a,
                                            uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 64) = a · bᵀ over the 64 head dims: a's and b's 64 rows in
// shared memory (K-major), 4 steps of 16 columns (32 bytes) each.
__device__ __forceinline__ void product_ss(float (&d)[32], uint32_t a_rows,
                                           uint32_t b_rows) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_ss_n64(d, smem_desc(a_rows + kk * 32, 16, 8 * kRowBytes),
                 smem_desc(b_rows + kk * 32, 16, 8 * kRowBytes), kk > 0);
}

// d (64 x 64) += a · b over b's 64 rows: a the bf16 A fragments of a
// 64 x 64 accumulator, b in shared memory as it lies (MN-major), 4 steps
// of 16 rows each.
__device__ __forceinline__ void product_rs(float (&d)[32],
                                           const uint32_t (&a)[16],
                                           uint32_t b_rows) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_rs_n64(d, &a[4 * kk],
                 smem_desc(b_rows + kk * 16 * kRowBytes, 64 * kRowBytes,
                           8 * kRowBytes));
}

// The persistent launches' work counter: `sched[0]` hands out tiles; every
// CTA takes one past the end and then counts itself in `sched[1]`, and
// the last to do so resets both for the next launch on this stream.
__device__ __forceinline__ void release_counter(int* sched) {
  __threadfence();
  if (atomicAdd(sched + 1, 1) == static_cast<int>(gridDim.x) - 1) {
    sched[0] = 0;
    sched[1] = 0;
  }
}

// D = rowsum(dO ∘ o) of one row, (B, S, H, 64) bf16 at element offset
// `at`: this thread's 16 columns, then the row's four threads.
__device__ __forceinline__ float row_delta(const bf16* o, const bf16* dout,
                                           long long at, bool in, int t4) {
  float sum = 0.f;
  if (in) {
    const uint4* po = reinterpret_cast<const uint4*>(o + at + 16 * t4);
    const uint4* pd = reinterpret_cast<const uint4*>(dout + at + 16 * t4);
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const uint4 a = po[c], b = pd[c];
      const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
      const __nv_bfloat162* b2 = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 x = __bfloat1622float2(a2[e]);
        const float2 y = __bfloat1622float2(b2[e]);
        sum = fmaf(x.x, y.x, sum);
        sum = fmaf(x.y, y.y, sum);
      }
    }
  }
  sum += __shfl_xor_sync(kFull, sum, 1);
  sum += __shfl_xor_sync(kFull, sum, 2);
  return sum;
}

// One `dq_wgmma` work tile: 128 query rows of one head and batch, numbered
// query tile fastest, longest (highest) first, and the key tiles of 64
// the mask leaves.
struct DqTile {
  int q0, h, b, kvh, n_tiles;
};

__device__ __forceinline__ DqTile dq_tile(int w, int q_tiles, int heads,
                                          int kv_heads, int seq, int causal) {
  const int qt = q_tiles - 1 - w % q_tiles, hb = w / q_tiles;
  DqTile t;
  t.q0 = qt * kDqRows;
  t.h = hb % heads;
  t.b = hb / heads;
  t.kvh = t.h / (heads / kv_heads);
  const int keys = causal ? min(seq, t.q0 + kDqRows) : seq;
  t.n_tiles = (keys + kDqKeys - 1) / kDqKeys;
  return t;
}

// P = exp2(s·scale_log2 − lse2) and dS = P ∘ (dP − D) of a 64 x 64 tile in
// this thread's fragment (rows row0 and row1, keys key0 + 8 i + {0, 1}),
// dS rounded to bf16 as the A fragments of dS·k. With `mask` (uniform),
// keys past S or past the row when causal get P = 0.
__device__ __forceinline__ void dq_grad(const float (&s)[32],
                                        const float (&dp)[32],
                                        uint32_t (&ds)[16], bool mask,
                                        int key0, int row0, int row1, int seq,
                                        int causal, float lse0, float lse1,
                                        float d0, float d1, float scale_log2) {
#pragma unroll
  for (int r = 0; r < 32; r += 2) {
    const bool hi = (r & 2) != 0;
    const float lse2 = hi ? lse1 : lse0, d = hi ? d1 : d0;
    float p0 = ex2(fmaf(s[r], scale_log2, -lse2));
    float p1 = ex2(fmaf(s[r + 1], scale_log2, -lse2));
    if (mask) {
      const int key = key0 + 8 * (r >> 2), row = hi ? row1 : row0;
      if (key >= seq || (causal && key > row)) p0 = 0.f;
      if (key + 1 >= seq || (causal && key + 1 > row)) p1 = 0.f;
    }
    ds[r >> 1] = pack_bf16(p0 * (dp[r] - d), p1 * (dp[r + 1] - d));
  }
}

__global__ void __launch_bounds__(kThreadsBf16, 1)
dq_wgmma(const __grid_constant__ CUtensorMap q_map,     // 128-row boxes
       const __grid_constant__ CUtensorMap do_map,    // 128-row boxes
       const __grid_constant__ CUtensorMap k_map,     // 64-row boxes
       const __grid_constant__ CUtensorMap v_map,     // 64-row boxes
       const bf16* __restrict__ o, const bf16* __restrict__ dout,
       const float* __restrict__ lse, float* __restrict__ delta,
       bf16* __restrict__ dq, int* __restrict__ sched, int seq, int s_pad,
       int batch, int heads, int kv_heads, int causal, float scale_log2,
       float scale) {
  extern __shared__ uint8_t smem_raw[];
  // mbarriers: per q buffer full and empty; per stage full and empty
  __shared__ __align__(8) uint64_t bars[2 * kDqQBufs + 2 * kDqStages];
  __shared__ int tile_slot[kDqQBufs];       // the work tile each buffer holds
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_full = smem_u32(&bars[0]);              // + 8 * buffer
  const uint32_t q_empty = smem_u32(&bars[kDqQBufs]);
  const uint32_t kv_full = smem_u32(&bars[2 * kDqQBufs]);  // + 8 * stage
  const uint32_t kv_empty = smem_u32(&bars[2 * kDqQBufs + kDqStages]);
  const int q_tiles = (seq + kDqRows - 1) / kDqRows;
  const int work = q_tiles * heads * batch;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kDqQBufs; ++i) {
      mbar_init(q_full + 8 * i, 1);
      mbar_init(q_empty + 8 * i, kConsumerWarps);
    }
    for (int st = 0; st < kDqStages; ++st) {
      mbar_init(kv_full + 8 * st, 1);
      mbar_init(kv_empty + 8 * st, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // The warpgroup index, warp-uniform as the compiler sees it (a shuffle),
  // so no wgmma sits on a path it must treat as divergent.
  const int role = __shfl_sync(kFull, static_cast<int>(threadIdx.x) / 128, 0);
  if (role == 0) {
    // Producer: its first thread takes work tiles from the counter and
    // keeps q, dO and the k/v ring full, running ahead into the next tile.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      int g = 0;                            // k/v stages issued so far
      for (int it = 0;; ++it) {
        const int w = atomicAdd(sched, 1);
        const int qb = it % kDqQBufs;
        const uint32_t qf = q_full + 8 * qb;
        if (it >= kDqQBufs)
          mbar_wait(q_empty + 8 * qb, ((it / kDqQBufs) & 1) ^ 1);
        tile_slot[qb] = w;
        if (w >= work) {
          mbar_arrive(qf);                  // no more work: let them exit
          break;
        }
        const DqTile t = dq_tile(w, q_tiles, heads, kv_heads, seq, causal);
        const uint32_t q_dst = base + qb * 2 * kDqTile;
        mbar_expect_tx(qf, 2 * kDqTile);
        tma_load(q_dst, &q_map, qf, 0, t.h, t.q0, t.b);
        tma_load(q_dst + kDqTile, &do_map, qf, 0, t.h, t.q0, t.b);
        for (int j = 0; j < t.n_tiles; ++j, ++g) {
          const int st = g % kDqStages;
          const uint32_t full = kv_full + 8 * st;
          if (g >= kDqStages)
            mbar_wait(kv_empty + 8 * st, ((g / kDqStages) & 1) ^ 1);
          const uint32_t dst = base + kDqRing + st * 2 * kDqKV;
          mbar_expect_tx(full, 2 * kDqKV);
          tma_load(dst, &k_map, full, 0, t.kvh, j * kDqKeys, t.b);
          tma_load(dst + kDqKV, &v_map, full, 0, t.kvh, j * kDqKeys, t.b);
        }
      }
      release_counter(sched);
    }
  } else {
    // Consumer warpgroups 0 and 1: 64 query rows each of every work tile.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int wg = role - 1;
    const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int g4 = lane >> 2, t4 = lane & 3;
    const uint32_t mine = kTurn0 + wg, theirs = kTurn0 + 1 - wg;
    float s[32], dp[32], acc[32];
    uint32_t ds[16];
    int g = 0;                              // k/v stages consumed so far
    for (int it = 0;; ++it) {
      const int qb = it % kDqQBufs;
      mbar_wait(q_full + 8 * qb, (it / kDqQBufs) & 1);
      // Read from shared memory, then shuffled: warp-uniform to ptxas.
      const int w = __shfl_sync(
          kFull, *reinterpret_cast<volatile int*>(&tile_slot[qb]), 0);
      if (w >= work) break;
      const DqTile t = dq_tile(w, q_tiles, heads, kv_heads, seq, causal);
      const uint32_t q_rows = base + qb * 2 * kDqTile + wg * 64 * kRowBytes;
      const uint32_t do_rows = q_rows + kDqTile;
      // This thread's two rows (the accumulator fragment's g and g + 8),
      // their D (written for the second launch; 0 past S) and lse.
      const int row0 = t.q0 + wg * 64 + warp * 16 + g4, row1 = row0 + 8;
      const long long o_stride = static_cast<long long>(heads) * 64;
      const long long at = static_cast<long long>(t.b) * seq * o_stride
                           + t.h * 64;
      const float d0 = row_delta(o, dout, at + row0 * o_stride, row0 < seq,
                                 t4);
      const float d1 = row_delta(o, dout, at + row1 * o_stride, row1 < seq,
                                 t4);
      const long long stat = (static_cast<long long>(t.b) * heads + t.h)
                             * s_pad;
      if (t4 == 0) {
        delta[stat + row0] = d0;
        delta[stat + row1] = d1;
      }
      const float lse0 = row0 < seq ? lse[stat + row0] * kLog2e : 0.f;
      const float lse1 = row1 < seq ? lse[stat + row1] * kLog2e : 0.f;
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] = 0.f;
      turns_begin(wg, mine, theirs);

      for (int j = 0; j < t.n_tiles; ++j, ++g) {
        const int st = g % kDqStages;
        const uint32_t k_tile = base + kDqRing + st * 2 * kDqKV;
        mbar_wait(kv_full + 8 * st, (g / kDqStages) & 1);
        named_sync(mine);
        wgmma_fence();
        product_ss(s, q_rows, k_tile);                  // q·kᵀ
        product_ss(dp, do_rows, k_tile + kDqKV);        // dO·vᵀ
        wgmma_commit();
        named_arrive(theirs);
        wgmma_wait<0>();
        fence_regs(s);
        fence_regs(dp);
        const int k0 = j * kDqKeys;
        dq_grad(s, dp, ds,
                k0 + kDqKeys > seq || (causal && k0 + kDqKeys > t.q0),
                k0 + 2 * t4, row0, row1, seq, causal, lse0, lse1, d0, d1,
                scale_log2);
        named_sync(mine);
        wgmma_fence();
        product_rs(acc, ds, k_tile);                    // dq += dS·k
        wgmma_commit();
        named_arrive(theirs);
        wgmma_wait<0>();
        fence_regs(acc);
        fence_regs(ds);
        mbar_arrive_lane0(kv_empty + 8 * st, lane);    // stage st is free
      }
      turns_end(wg, mine, theirs);
      mbar_arrive_lane0(q_empty + 8 * qb, lane);       // q, dO read: refill

      bf16* out = dq + at + 2 * t4;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        if (row0 < seq)
          *reinterpret_cast<uint32_t*>(out + row0 * o_stride + 8 * i) =
              pack_bf16(acc[4 * i] * scale, acc[4 * i + 1] * scale);
        if (row1 < seq)
          *reinterpret_cast<uint32_t*>(out + row1 * o_stride + 8 * i) =
              pack_bf16(acc[4 * i + 2] * scale, acc[4 * i + 3] * scale);
      }
    }
  }
}

// Pᵀ and dSᵀ of a 64-key x 64-query tile in this thread's fragment: rows
// are keys key0 and key1, columns queries q0 + 8 i + 2 t4 + {0, 1}, whose
// lse (natural units) and D lie in shared memory. Both come out rounded to
// bf16 as the A fragments of Pᵀ·dO and dSᵀ·q. With `mask` (uniform),
// queries past S, or before the key when causal, get P = 0.
__device__ __forceinline__ void dkdv_grad(
    const float (&st)[32], const float (&dpt)[32], uint32_t (&p)[16],
    uint32_t (&ds)[16], const float* lse_s, const float* d_s, bool mask,
    int q0, int t4, int key0, int key1, int seq, int causal,
    float scale_log2) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int c = 8 * i + 2 * t4;
    const float2 l = *reinterpret_cast<const float2*>(lse_s + c);
    const float2 d = *reinterpret_cast<const float2*>(d_s + c);
    const float la = l.x * kLog2e, lb = l.y * kLog2e;
    float pr[4] = {ex2(fmaf(st[4 * i], scale_log2, -la)),
                   ex2(fmaf(st[4 * i + 1], scale_log2, -lb)),
                   ex2(fmaf(st[4 * i + 2], scale_log2, -la)),
                   ex2(fmaf(st[4 * i + 3], scale_log2, -lb))};
    if (mask) {
      const int qa = q0 + c, qb = qa + 1;
      if (qa >= seq || (causal && key0 > qa)) pr[0] = 0.f;
      if (qb >= seq || (causal && key0 > qb)) pr[1] = 0.f;
      if (qa >= seq || (causal && key1 > qa)) pr[2] = 0.f;
      if (qb >= seq || (causal && key1 > qb)) pr[3] = 0.f;
    }
    p[2 * i] = pack_bf16(pr[0], pr[1]);
    p[2 * i + 1] = pack_bf16(pr[2], pr[3]);
    ds[2 * i] = pack_bf16(pr[0] * (dpt[4 * i] - d.x),
                          pr[1] * (dpt[4 * i + 1] - d.y));
    ds[2 * i + 1] = pack_bf16(pr[2] * (dpt[4 * i + 2] - d.x),
                              pr[3] * (dpt[4 * i + 3] - d.y));
  }
}

// One `dkdv_wgmma` work tile: 128 keys of one KV head and batch, numbered
// key tile fastest, lowest (longest when causal) first.
struct KvTile {
  int k0, kvh, b, first;                    // first: the first query tile
};

__device__ __forceinline__ KvTile kv_tile(int w, int k_tiles, int kv_heads,
                                          int causal) {
  const int kt = w % k_tiles, hb = w / k_tiles;
  KvTile t;
  t.k0 = kt * kKvKeys;
  t.kvh = hb % kv_heads;
  t.b = hb / kv_heads;
  t.first = causal ? t.k0 / kKvRows : 0;
  return t;
}

__global__ void __launch_bounds__(kThreadsBf16, 1)
dkdv_wgmma(const __grid_constant__ CUtensorMap k_map,    // 128-row boxes
         const __grid_constant__ CUtensorMap v_map,    // 128-row boxes
         const __grid_constant__ CUtensorMap q_map,    // 64-row boxes
         const __grid_constant__ CUtensorMap do_map,   // 64-row boxes
         const float* __restrict__ lse, const float* __restrict__ delta,
         bf16* __restrict__ dk, bf16* __restrict__ dv,
         int* __restrict__ sched, int seq, int s_pad, int batch, int heads,
         int kv_heads, int causal, float scale_log2, float scale) {
  extern __shared__ uint8_t smem_raw[];
  // mbarriers: k/v full and empty; per stage full and empty
  __shared__ __align__(8) uint64_t bars[2 + 2 * kKvStages];
  __shared__ int tile_slot;                 // the work tile k and v hold
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint8_t* base_ptr = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t kv_full = smem_u32(&bars[0]);
  const uint32_t kv_empty = smem_u32(&bars[1]);
  const uint32_t full = smem_u32(&bars[2]);                // + 8 * stage
  const uint32_t empty = smem_u32(&bars[2 + kKvStages]);
  const int k_tiles = (seq + kKvKeys - 1) / kKvKeys;
  const int n_qt = (seq + kKvRows - 1) / kKvRows;
  const int group = heads / kv_heads;
  const int work = k_tiles * kv_heads * batch;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    mbar_init(kv_empty, kConsumerWarps);
    for (int st = 0; st < kKvStages; ++st) {
      mbar_init(full + 8 * st, 1);
      mbar_init(empty + 8 * st, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int role = __shfl_sync(kFull, static_cast<int>(threadIdx.x) / 128, 0);
  if (role == 0) {
    // Producer: k and v of each work tile, then the group's query heads'
    // q, dO, lse and D tiles through the ring.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      int g = 0;                            // stages issued so far
      for (int it = 0;; ++it) {
        const int w = atomicAdd(sched, 1);
        if (it > 0) mbar_wait(kv_empty, (it & 1) ^ 1);
        tile_slot = w;
        if (w >= work) {
          mbar_arrive(kv_full);             // no more work: let them exit
          break;
        }
        const KvTile t = kv_tile(w, k_tiles, kv_heads, causal);
        mbar_expect_tx(kv_full, 2 * kKvTile);
        tma_load(base, &k_map, kv_full, 0, t.kvh, t.k0, t.b);
        tma_load(base + kKvTile, &v_map, kv_full, 0, t.kvh, t.k0, t.b);
        for (int h = t.kvh * group; h < (t.kvh + 1) * group; ++h) {
          const float* lse_h =
              lse + (static_cast<long long>(t.b) * heads + h) * s_pad;
          const float* delta_h =
              delta + (static_cast<long long>(t.b) * heads + h) * s_pad;
          for (int qt = t.first; qt < n_qt; ++qt, ++g) {
            const int st = g % kKvStages;
            const uint32_t bar = full + 8 * st;
            if (g >= kKvStages)
              mbar_wait(empty + 8 * st, ((g / kKvStages) & 1) ^ 1);
            const uint32_t dst = base + kKvRing + st * kKvStage;
            mbar_expect_tx(bar, 2 * kKvQ + 2 * kStatBytes);
            tma_load(dst, &q_map, bar, 0, h, qt * kKvRows, t.b);
            tma_load(dst + kKvQ, &do_map, bar, 0, h, qt * kKvRows, t.b);
            bulk_load(dst + 2 * kKvQ, lse_h + qt * kKvRows, kStatBytes, bar);
            bulk_load(dst + 2 * kKvQ + kStatBytes, delta_h + qt * kKvRows,
                      kStatBytes, bar);
          }
        }
      }
      release_counter(sched);
    }
  } else {
    // Consumer warpgroups 0 and 1: 64 keys each of every work tile.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int wg = role - 1;
    const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int g4 = lane >> 2, t4 = lane & 3;
    const uint32_t mine = kTurn0 + wg, theirs = kTurn0 + 1 - wg;
    const uint32_t k_rows = base + wg * 64 * kRowBytes;
    const uint32_t v_rows = k_rows + kKvTile;
    float st_[32], dpt[32], dk_acc[32], dv_acc[32];
    uint32_t p[16], ds[16];
    int g = 0;                              // stages consumed so far
    for (int it = 0;; ++it) {
      mbar_wait(kv_full, it & 1);
      const int w = __shfl_sync(
          kFull, *reinterpret_cast<volatile int*>(&tile_slot), 0);
      if (w >= work) break;
      const KvTile t = kv_tile(w, k_tiles, kv_heads, causal);
      // This thread's two keys (the accumulator fragment's g and g + 8).
      const int key0 = t.k0 + wg * 64 + warp * 16 + g4, key1 = key0 + 8;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        dk_acc[i] = 0.f;
        dv_acc[i] = 0.f;
      }
      turns_begin(wg, mine, theirs);
      for (int h = 0; h < group; ++h) {
        for (int qt = t.first; qt < n_qt; ++qt, ++g) {
          const int sg = g % kKvStages;
          const uint32_t q_tile = base + kKvRing + sg * kKvStage;
          const uint32_t do_tile = q_tile + kKvQ;
          const float* lse_s = reinterpret_cast<const float*>(
              base_ptr + kKvRing + sg * kKvStage + 2 * kKvQ);
          mbar_wait(full + 8 * sg, (g / kKvStages) & 1);
          named_sync(mine);
          wgmma_fence();
          product_ss(st_, k_rows, q_tile);              // k·qᵀ
          product_ss(dpt, v_rows, do_tile);             // v·dOᵀ
          wgmma_commit();
          named_arrive(theirs);
          wgmma_wait<0>();
          fence_regs(st_);
          fence_regs(dpt);
          dkdv_grad(st_, dpt, p, ds, lse_s, lse_s + kStatBytes / 4,
                    (causal && qt < t.first + 2)
                        || (qt + 1) * kKvRows > seq,
                    qt * kKvRows, t4, key0, key1, seq, causal, scale_log2);
          named_sync(mine);
          wgmma_fence();
          product_rs(dv_acc, p, do_tile);               // dv += Pᵀ·dO
          product_rs(dk_acc, ds, q_tile);               // dk += dSᵀ·q
          wgmma_commit();
          named_arrive(theirs);
          wgmma_wait<0>();
          fence_regs(dv_acc);
          fence_regs(dk_acc);
          fence_regs(p);
          fence_regs(ds);
          mbar_arrive_lane0(empty + 8 * sg, lane);     // stage sg is free
        }
      }
      turns_end(wg, mine, theirs);
      mbar_arrive_lane0(kv_empty, lane);               // k, v read: refill

      const long long k_stride = static_cast<long long>(kv_heads) * 64;
      const long long at = static_cast<long long>(t.b) * seq * k_stride
                           + t.kvh * 64 + 2 * t4;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        if (key0 < seq) {
          *reinterpret_cast<uint32_t*>(dk + at + key0 * k_stride + 8 * i) =
              pack_bf16(dk_acc[4 * i] * scale, dk_acc[4 * i + 1] * scale);
          *reinterpret_cast<uint32_t*>(dv + at + key0 * k_stride + 8 * i) =
              pack_bf16(dv_acc[4 * i], dv_acc[4 * i + 1]);
        }
        if (key1 < seq) {
          *reinterpret_cast<uint32_t*>(dk + at + key1 * k_stride + 8 * i) =
              pack_bf16(dk_acc[4 * i + 2] * scale, dk_acc[4 * i + 3] * scale);
          *reinterpret_cast<uint32_t*>(dv + at + key1 * k_stride + 8 * i) =
              pack_bf16(dv_acc[4 * i + 2], dv_acc[4 * i + 3]);
        }
      }
    }
  }
}

cudaError_t launch_bf16(const void* q, const void* k, const void* v,
                        const void* o, const void* dout, const float* lse,
                        void* dq, void* dk, void* dv, float* delta,
                        const long long* q_geom, const long long* k_geom,
                        int s_pad, int causal, float scale_log2, float scale,
                        int ctas_dq, int ctas_dkdv, int* sched,
                        cudaStream_t stream) {
  const int seq = static_cast<int>(q_geom[2]);
  if (q_geom[0] != D || k_geom[0] != D || s_pad % kDqRows != 0
      || s_pad < seq || ctas_dq < 1 || ctas_dkdv < 1)
    return cudaErrorInvalidValue;
  // dO is laid out as q, and v as k (the wrapper checks both).
  CUtensorMap q128, do128, k64, v64, k128, v128, q64, do64;
  cudaError_t err = encode_map(&q128, q, q_geom, kDqRows);
  if (err == cudaSuccess) err = encode_map(&do128, dout, q_geom, kDqRows);
  if (err == cudaSuccess) err = encode_map(&k64, k, k_geom, kDqKeys);
  if (err == cudaSuccess) err = encode_map(&v64, v, k_geom, kDqKeys);
  if (err == cudaSuccess) err = encode_map(&k128, k, k_geom, kKvKeys);
  if (err == cudaSuccess) err = encode_map(&v128, v, k_geom, kKvKeys);
  if (err == cudaSuccess) err = encode_map(&q64, q, q_geom, kKvRows);
  if (err == cudaSuccess) err = encode_map(&do64, dout, q_geom, kKvRows);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        dq_wgmma, cudaFuncAttributeMaxDynamicSharedMemorySize, kDqSmem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        dkdv_wgmma, cudaFuncAttributeMaxDynamicSharedMemorySize, kKvSmem);
  if (err != cudaSuccess) return err;
  const int batch = static_cast<int>(q_geom[3]);
  const int heads = static_cast<int>(q_geom[1]);
  const int kv_heads = static_cast<int>(k_geom[1]);
  // dq first: it writes D, which the second launch reads.
  dq_wgmma<<<ctas_dq, kThreadsBf16, kDqSmem, stream>>>(
      q128, do128, k64, v64, static_cast<const bf16*>(o),
      static_cast<const bf16*>(dout), lse, delta, static_cast<bf16*>(dq),
      sched, seq, s_pad, batch, heads, kv_heads, causal, scale_log2, scale);
  dkdv_wgmma<<<ctas_dkdv, kThreadsBf16, kKvSmem, stream>>>(
      k128, v128, q64, do64, lse, delta, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), sched, seq, s_pad, batch, heads, kv_heads,
      causal, scale_log2, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dq, dk, dv of o = attention(q, k, v): q, o, dout and dq (batch, seq,
// heads, 64), k, v, dk and dv (batch, seq, kv_heads, 64), all contiguous
// and of one dtype (`is_bf16`: bf16, else float32); `lse` the forward's
// (batch, heads, s_pad) float32 logsumexp in natural units, s_pad = seq
// rounded up to 128, and `delta` (batch, heads, s_pad) float32 scratch.
// `scale_log2` is log2(e)/√64 and `scale` 1/√64. bf16 only: `q_geom` and
// `k_geom` are the tensor maps' (64, heads, seq, batch) and byte strides of
// q (and dO) and of k (and v); `ctas_dq` and `ctas_dkdv` persistent CTAs
// take the two launches' work tiles from `sched`, two ints that are 0
// before the launches and 0 after each.
int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                               const void* o, const void* dout,
                               const float* lse, void* dq, void* dk,
                               void* dv, float* delta,
                               const long long* q_geom,
                               const long long* k_geom, int batch, int seq,
                               int heads, int kv_heads, int s_pad, int causal,
                               int is_bf16, float scale_log2, float scale,
                               int ctas_dq, int ctas_dkdv, int* sched,
                               cudaStream_t stream) {
  if (is_bf16)
    return static_cast<int>(launch_bf16(
        q, k, v, o, dout, lse, dq, dk, dv, delta, q_geom, k_geom, s_pad,
        causal, scale_log2, scale, ctas_dq, ctas_dkdv, sched, stream));
  return static_cast<int>(launch_f32(q, k, v, o, dout, lse, dq, dk, dv,
                                     delta, batch, seq, s_pad, heads,
                                     kv_heads, causal, scale_log2, scale,
                                     stream));
}

const char* flash_attention_bwd_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

}  // extern "C"
