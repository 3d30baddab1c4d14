// flash_attention_bwd: the gradient of causal or non-causal GQA attention
// for Hopper (sm_90a), at head dims (dh, dv) = (64, 64), (128, 128) and
// (192, 128), the forward's pairs.
//
// Replaces no TPU kernel: the JAX package trains through jnp attention
// (`chunked_causal_attention`, src/repro/models/attention.py) and takes its
// gradient by autodiff, and its Pallas kernel
// (src/repro/kernels/flash_attention/flash_attention.py) has no backward.
// The port runs its forward kernel (flash_attention.cu) where the
// reference runs jnp attention, so training needs this kernel: the port's
// counterpart of the gradient JAX derives. Given q (B,S,H,dh), k
// (B,S,KV,dh), v (B,S,KV,dv), the forward's o (B,S,H,dv) and its rows'
// logsumexp `lse` ((B, H, s_pad) float32, natural units, s_pad = S rounded
// up to 128: the forward kernel writes it), and dO = dL/do, it returns dq,
// dk and dv in the inputs' dtype (bf16 or float32), query head h reading
// KV head h / (H/KV), with the forward's mask (key >= S, or key > row when
// causal) and scale 1/√dh. With P = exp(q·kᵀ/√dh − lse):
//   dv = Pᵀ·dO,  dP = dO·vᵀ,  dS = P ∘ (dP − D),  D = rowsum(dO ∘ o),
//   dq = dS·k/√dh,  dk = dSᵀ·q/√dh.
// (192, 128) is MLA's (deepseek-v2: q and k over 128 latent-decompressed
// and 64 rotary dims, v of 128), with the forward's scale 1/√192.
//
// Bound on this card: operations. The gradient's five products (q·kᵀ
// again, dO·vᵀ, Pᵀ·dO, dSᵀ·q, dS·k) are 2.5 times the forward's two: at
// the smollm-360m training shape (B=4, S=4096, H=15, causal) 3.22e11 bf16
// operations, 0.326 ms at 989 TFLOP/s, against 168 MB of inputs and
// outputs (0.05 ms at 3.35 TB/s); at yi-6b's (4, 4096, 32/4, 128) 1.37e12
// (1.39 ms), at deepseek-v2's (4, 4096, 128/128, 192/128) B·H·S²·(192 +
// 128 + 128 + 192 + 192)/2·2 = 7.15e12 (7.23 ms).
//
// bf16 design: two launches on one stream (three at the wider pairs), all
// persistent (one CTA an SM) with the forward's shape: a producer
// warpgroup whose first thread issues every TMA load and gives its
// registers away (setmaxnreg), and two consumer warpgroups of 64 rows each
// on wgmma (bf16 operands, float32 sums). CTAs take work tiles from a
// counter in device memory, longest first; the last CTA of each launch
// resets it, so no launch needs a memset. Tiles lie in shared memory as
// the forward's: blocks of 64 columns of 128-byte rows with the 128-byte
// swizzle (dh/64 blocks of q and k, dv/64 of v and dO), written by TMA
// from 4-D tensor maps over (head dim, heads, S, batch), rows past S read
// as zeros. ptxas holds every region of these kernels, the consumers'
// too, to the 168 registers a thread that 384 threads leave (see
// `BwdLayout`), and that sizes the wider pairs' stages.
// * `dq_wgmma`, over query tiles of 128 rows of one head: each row's
//   D = rowsum(dO ∘ o), read once from device memory and written to a
//   (B, H, s_pad) scratch for the dk launch; then over the key tiles the
//   mask leaves, 64 keys a stage (32 at (192, 128)) of a ring of k and v
//   tiles: S = q·kᵀ and dP = dO·vᵀ (dh/16 and dv/16 wgmma steps) with both
//   operands in shared memory, P and dS in registers, and dq += dS·k
//   (m64n{dh}k16) with dS as the register A operand (the accumulator
//   re-packed to bf16, as the forward re-packs p) and k read as it lies
//   (MN-major, its dh/64 column blocks one leading offset apart). q and dO
//   are double-buffered across work tiles, except at (192, 128), whose
//   80 KB of q and dO a tile leave room for one buffer.
// * `dkdv_wgmma`, over key tiles of 128 keys of one KV head: k and v stay in
//   shared memory and the gradients in registers while the group's H/KV
//   query heads and their query tiles at or below the diagonal stream
//   through a ring (q, dO, and the rows' lse and D by 1-D bulk copies; 64
//   rows a stage, 32 for dk at dh 192). Sᵀ = k·qᵀ and
//   dPᵀ = v·dOᵀ, so Pᵀ and dSᵀ come out as register A operands; then
//   dv += Pᵀ·dO and dk += dSᵀ·q read dO and q MN-major. At (64, 64) one
//   launch computes both; at the wider pairs a consumer thread cannot hold
//   dk and dv (128 or 160 floats) beside the tiles within 168 registers,
//   so dv comes from one launch (Sᵀ, then Pᵀ·dO) and dk from another (Sᵀ,
//   dPᵀ, then dSᵀ·q). No two CTAs write one key's gradient, so GQA needs
//   no atomics.
// * In both, the two consumer warpgroups take turns issuing to the tensor
//   cores (named barriers, as in the forward), warpgroup 1 half a step
//   behind the other, so one's exp2s run while the other's products do.
//   Free-running, the two tend to fall into step (both wait on the same
//   stage and issue together), and the tensor cores idle while both
//   compute exp2s; with the turns the backward ran 4-10% faster
//   (tools/flash_ab.py and chip_smoke.py before and after, PERF.md §6).
// Seven products in all at (64, 64): q·kᵀ and dO·vᵀ run once in the dq
// launch and once in the dk/dv launch; eight at the wider pairs, whose dv
// launch computes k·qᵀ once more. The five of the bound would need dq
// summed across key tiles by atomics (FlashAttention-3), whose order
// changes from run to run; the repeat costs 2/5 more operations (3/5 at
// the wider pairs) and keeps every sum in a fixed order. No
// statistics pass: P comes from the forward's logsumexp. P and dS are
// rounded to bf16 before the products that take them, as the forward
// rounds p before p·v; each output is rounded once. Each (dh, dv) is an
// instance of its own templates.
//
// float32 (`bwd_*`): the card's exact float32 arbiter, on the CUDA cores,
// three launches: D = rowsum(dO ∘ o) (`bwd_delta`), dk and dv over key
// tiles, dq over query tiles, each a 64-row tile of a block, P from the
// forward's lse as in bf16. Every tile lies in shared memory as float32
// rows padded to one word more than their width (dh + 1, dv + 1, or 65
// for P and dS), and thread (ty, tx) of 16 x 16 owns rows ty + 16 i and
// columns tx + 16 j (i < 4) of each product: 198 KB of tiles at
// (192, 128).
//
// Each sum runs in a fixed order and nothing is added by atomics: two
// calls give the same bits.
#include <math.h>

#include "hopper.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;

constexpr int TILE = 64;      // query rows or keys a tile
constexpr int LDP = TILE + 1; // row stride of a P or dS tile, in floats
constexpr int THREADS = 256;  // 16 x 16

// Shared memory of the float32 kernels at (DQK, DV): tiles of q and k rows
// padded to DQK + 1 floats, of v and dO rows to DV + 1, of P and dS to 65,
// and 64 floats each of lse and D.
template <int DQK, int DV>
struct F32Layout {
  static constexpr int kLdQ = DQK + 1;     // row stride of a q or k tile
  static constexpr int kLdV = DV + 1;      // of a v or dO tile
  static constexpr int kQ = TILE * kLdQ;
  static constexpr int kV = TILE * kLdV;
  static constexpr int kP = TILE * LDP;
  static constexpr int kDkdvSmem = (2 * kQ + 2 * kV + 2 * kP + 2 * TILE) * 4;
  static constexpr int kDqSmem = (2 * kQ + 2 * kV + kP + 2 * TILE) * 4;
  static_assert(kDkdvSmem <= 232448 && kDqSmem <= 232448, "smem");
};

// Rows [row0, row0 + TILE) of one head's (S, D) slab, rows `stride`
// elements apart, into a shared tile of rows D + 1 apart; rows past S
// read as zeros.
template <int D>
__device__ void load_tile(float* tile, const float* src, int row0, int s,
                          long long stride) {
  for (int idx = threadIdx.x; idx < TILE * D; idx += THREADS) {
    const int r = idx / D, c = idx % D, row = row0 + r;
    tile[r * (D + 1) + c] = row < s ? src[row * stride + c] : 0.f;
  }
}

// acc[i][j] += sum_d a[row_i][d] * b[col_j][d]   (a·bᵀ over K columns;
// a's and b's rows K + 1 floats apart)
template <int K>
__device__ __forceinline__ void mm_nt(float (&acc)[4][4], const float* a,
                                      const float* b, int ty, int tx) {
#pragma unroll 8
  for (int d = 0; d < K; ++d) {
    float x[4], y[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = a[(ty + 16 * i) * (K + 1) + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) y[j] = b[(tx + 16 * j) * (K + 1) + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(x[i], y[j], acc[i][j]);
  }
}

// acc[i][j] += sum_r a[r][row_i] * b[r][col_j]   (aᵀ·b: a a 64 x 64 P or
// dS tile, b TILE rows of N columns, N + 1 floats apart)
template <int N>
__device__ __forceinline__ void mm_tn(float (&acc)[4][N / 16], const float* a,
                                      const float* b, int ty, int tx) {
#pragma unroll 8
  for (int r = 0; r < TILE; ++r) {
    float x[4], y[N / 16];
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = a[r * LDP + ty + 16 * i];
#pragma unroll
    for (int j = 0; j < N / 16; ++j) y[j] = b[r * (N + 1) + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < N / 16; ++j)
        acc[i][j] = fmaf(x[i], y[j], acc[i][j]);
  }
}

// acc[i][j] += sum_r a[row_i][r] * b[r][col_j]   (a·b: a a 64 x 64 dS
// tile, b TILE rows of N columns, N + 1 floats apart)
template <int N>
__device__ __forceinline__ void mm_nn(float (&acc)[4][N / 16], const float* a,
                                      const float* b, int ty, int tx) {
#pragma unroll 8
  for (int r = 0; r < TILE; ++r) {
    float x[4], y[N / 16];
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = a[(ty + 16 * i) * LDP + r];
#pragma unroll
    for (int j = 0; j < N / 16; ++j) y[j] = b[r * (N + 1) + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < N / 16; ++j)
        acc[i][j] = fmaf(x[i], y[j], acc[i][j]);
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
// scratch: o and dO (B, S, H, DV). Block: (query tile, head, batch).
template <int DV>
__global__ void __launch_bounds__(THREADS)
    bwd_delta(const float* __restrict__ o, const float* __restrict__ dout,
              float* __restrict__ delta, int s, int s_pad, int h) {
  const int qt = blockIdx.x, head = blockIdx.y, b = blockIdx.z;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const long long ostride = (long long)h * DV;
  const long long ooff = ((long long)b * s * h + head) * DV;
  // D over the row's DV columns: DV/16 a lane, then the half-warp
  float dsum[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = qt * TILE + ty + 16 * i;
    dsum[i] = 0.f;
    if (row < s) {
      const long long at = ooff + row * ostride;
#pragma unroll
      for (int j = 0; j < DV / 16; ++j) {
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
template <int DQK, int DV>
__device__ __forceinline__ void softmax_grad(
    float (&p)[4][4], float (&ds)[4][4], const float* qs, const float* dos,
    const float* ks, const float* vs, const float* lse_s, const float* d_s,
    int qt, int kt, int s, int causal, float scale_log2, int ty, int tx) {
  float dp[4][4] = {};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) p[i][j] = 0.f;
  mm_nt<DQK>(p, qs, ks, ty, tx);
  mm_nt<DV>(dp, dos, vs, ty, tx);
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
template <int DQK, int DV>
__global__ void __launch_bounds__(THREADS)
    bwd_dkdv(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, const float* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ delta,
             float* __restrict__ dk, float* __restrict__ dv, int s, int s_pad,
             int h, int kv, int causal, float scale_log2, float scale) {
  using L = F32Layout<DQK, DV>;
  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = ks + L::kQ;
  float* qs = vs + L::kV;
  float* dos = qs + L::kQ;
  float* ps = dos + L::kV;
  float* dss = ps + L::kP;
  float* lse_s = dss + L::kP;
  float* d_s = lse_s + TILE;
  const int kt = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int group = h / kv;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const long long qstride = (long long)h * DQK, ostride = (long long)h * DV;
  const long long kstride = (long long)kv * DQK, vstride = (long long)kv * DV;
  const long long koff = ((long long)b * s * kv + kvh) * DQK;
  const long long voff = ((long long)b * s * kv + kvh) * DV;
  load_tile<DQK>(ks, k + koff, kt * TILE, s, kstride);
  load_tile<DV>(vs, v + voff, kt * TILE, s, vstride);

  float dk_acc[4][DQK / 16] = {}, dv_acc[4][DV / 16] = {};
  const int n_qt = (s + TILE - 1) / TILE;
  for (int head = kvh * group; head < (kvh + 1) * group; ++head) {
    const long long qoff = ((long long)b * s * h + head) * DQK;
    const long long ooff = ((long long)b * s * h + head) * DV;
    const long long row0 = ((long long)b * h + head) * s_pad;
    for (int qt = first_query_tile(kt, causal); qt < n_qt; ++qt) {
      __syncthreads();
      load_tile<DQK>(qs, q + qoff, qt * TILE, s, qstride);
      load_tile<DV>(dos, dout + ooff, qt * TILE, s, ostride);
      load_stats(lse_s, d_s, lse, delta, row0, qt, s);
      __syncthreads();
      float p[4][4], ds[4][4];
      softmax_grad<DQK, DV>(p, ds, qs, dos, ks, vs, lse_s, d_s, qt, kt, s,
                            causal, scale_log2, ty, tx);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int at = (ty + 16 * i) * LDP + tx + 16 * j;
          ps[at] = p[i][j];
          dss[at] = ds[i][j];
        }
      __syncthreads();
      // dv[key][e] += P[row][key] dO[row][e], dk[key][e] += dS[row][key]
      // q[row][e]
      mm_tn<DV>(dv_acc, ps, dos, ty, tx);
      mm_tn<DQK>(dk_acc, dss, qs, ty, tx);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = kt * TILE + ty + 16 * i;
    if (key >= s) continue;
#pragma unroll
    for (int j = 0; j < DQK / 16; ++j)
      dk[koff + key * kstride + tx + 16 * j] = dk_acc[i][j] * scale;
#pragma unroll
    for (int j = 0; j < DV / 16; ++j)
      dv[voff + key * vstride + tx + 16 * j] = dv_acc[i][j];
  }
}

// dq of one 64-row query tile of one head. Block: (query tile, head,
// batch).
template <int DQK, int DV>
__global__ void __launch_bounds__(THREADS)
    bwd_dq(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, const float* __restrict__ dout,
           const float* __restrict__ lse, const float* __restrict__ delta,
           float* __restrict__ dq, int s, int s_pad, int h, int kv,
           int causal, float scale_log2, float scale) {
  using L = F32Layout<DQK, DV>;
  extern __shared__ float smem[];
  float* qs = smem;
  float* dos = qs + L::kQ;
  float* ks = dos + L::kV;
  float* vs = ks + L::kQ;
  float* dss = vs + L::kV;
  float* lse_s = dss + L::kP;
  float* d_s = lse_s + TILE;
  const int qt = blockIdx.x, head = blockIdx.y, b = blockIdx.z;
  const int kvh = head / (h / kv);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const long long qstride = (long long)h * DQK, ostride = (long long)h * DV;
  const long long kstride = (long long)kv * DQK, vstride = (long long)kv * DV;
  const long long qoff = ((long long)b * s * h + head) * DQK;
  const long long ooff = ((long long)b * s * h + head) * DV;
  const long long koff = ((long long)b * s * kv + kvh) * DQK;
  const long long voff = ((long long)b * s * kv + kvh) * DV;
  load_tile<DQK>(qs, q + qoff, qt * TILE, s, qstride);
  load_tile<DV>(dos, dout + ooff, qt * TILE, s, ostride);
  load_stats(lse_s, d_s, lse, delta, ((long long)b * h + head) * s_pad, qt,
             s);

  float dq_acc[4][DQK / 16] = {};
  const int n_kt = causal ? qt + 1 : (s + TILE - 1) / TILE;
  for (int kt = 0; kt < n_kt; ++kt) {
    __syncthreads();
    load_tile<DQK>(ks, k + koff, kt * TILE, s, kstride);
    load_tile<DV>(vs, v + voff, kt * TILE, s, vstride);
    __syncthreads();
    float p[4][4], ds[4][4];
    softmax_grad<DQK, DV>(p, ds, qs, dos, ks, vs, lse_s, d_s, qt, kt, s,
                          causal, scale_log2, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) dss[(ty + 16 * i) * LDP + tx + 16 * j] =
          ds[i][j];
    __syncthreads();
    // dq[row][e] += dS[row][key] k[key][e]
    mm_nn<DQK>(dq_acc, dss, ks, ty, tx);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = qt * TILE + ty + 16 * i;
    if (row >= s) continue;
#pragma unroll
    for (int j = 0; j < DQK / 16; ++j)
      dq[qoff + row * qstride + tx + 16 * j] = dq_acc[i][j] * scale;
  }
}

template <int DQK, int DV>
cudaError_t launch_f32(const void* q, const void* k, const void* v,
                       const void* o, const void* dout, const float* lse,
                       void* dq, void* dk, void* dv, float* delta, int b,
                       int s, int s_pad, int h, int kv, int causal,
                       float scale_log2, float scale, cudaStream_t stream) {
  using L = F32Layout<DQK, DV>;
  cudaError_t err = cudaFuncSetAttribute(
      bwd_dkdv<DQK, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      L::kDkdvSmem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      bwd_dq<DQK, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      L::kDqSmem);
  if (err != cudaSuccess) return err;
  const int tiles = (s + TILE - 1) / TILE;
  const dim3 by_query(tiles, h, b), by_key(tiles, kv, b);
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const float* dof = static_cast<const float*>(dout);
  bwd_delta<DV><<<by_query, THREADS, 0, stream>>>(
      static_cast<const float*>(o), dof, delta, s, s_pad, h);
  bwd_dkdv<DQK, DV><<<by_key, THREADS, L::kDkdvSmem, stream>>>(
      qf, kf, vf, dof, lse, delta, static_cast<float*>(dk),
      static_cast<float*>(dv), s, s_pad, h, kv, causal, scale_log2, scale);
  bwd_dq<DQK, DV><<<by_query, THREADS, L::kDqSmem, stream>>>(
      qf, kf, vf, dof, lse, delta, static_cast<float*>(dq), s, s_pad, h, kv,
      causal, scale_log2, scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 on wgmma with TMA loads (see the note at the top).

using bf16 = __nv_bfloat16;

constexpr int kThreadsBf16 = 384;       // producer + 2 consumer warpgroups
constexpr int kConsumerWarps = 8;

// `dq_wgmma`: work tiles of kDqRows query rows; k and v in stages of
// kDqKeys keys. `dkdv_wgmma`: work tiles of kKvKeys keys; q, dO, lse and D
// in stages of kKvRows query rows.
constexpr int kDqRows = 128;
constexpr int kKvKeys = 128;
constexpr int kDqBlock = kDqRows * kRowBytes;   // a 64-column block of q, dO
constexpr int kKvBlock = kKvKeys * kRowBytes;   // of the k or v tile

// What a `dkdv_wgmma` launch computes: dk and dv at (64, 64); at the
// wider pairs dv in one launch and dk in another, so that a consumer
// thread holds one of the two accumulators.
enum Part { kDkDv, kDv, kDk };

// ptxas (CUDA 12.9) holds each of these kernels to the 168 registers a
// thread that its launch bound leaves (65536 / 384), in the consumers'
// code too, whatever setmaxnreg gives them at run time; at the wider
// pairs it spilled and serialized the wgmmas (C7512) when a consumer
// thread held the (64, 64) design's arrays. So there dq's key stages
// narrow to 32 at dh 192 (S and dP 16 floats each, dq 96), and dk and dv
// come from separate launches: dv (64 floats) with Sᵀ and Pᵀ over 64-row
// stages, dk (64 floats) with Sᵀ, dPᵀ and dSᵀ over 64-row stages at
// dh 128, and (96 floats) over 32-row stages at dh 192.
//
// `dq_wgmma`'s tiles at (DQK, DV) and its shared memory in bytes from a
// 1024-aligned base: kDqQBufs buffers of q then dO, then the ring's
// kDqStages stages of k then v. Each tile is DQK/64 (q, k) or DV/64 (v,
// dO) column blocks of 128-byte rows, the TMA box and the swizzle atom.
template <int DQK, int DV>
struct BwdLayout {
  static constexpr bool kWide = DQK != 64;
  static constexpr int kQKBlocks = DQK / 64;
  static constexpr int kVBlocks = DV / 64;
  static constexpr int kDqKeys = DQK == 192 ? 32 : 64;
  static constexpr int kDqQBufs = DQK == 192 ? 1 : 2;
  static constexpr int kDqStages = DQK == 64 ? 4 : DQK == 128 ? 3 : 6;
  static constexpr int kDqKBlock = kDqKeys * kRowBytes;    // of a k stage
  static constexpr int kDqQ = kQKBlocks * kDqBlock;        // q of a tile
  static constexpr int kDqBuf = kDqQ + kVBlocks * kDqBlock;
  static constexpr int kDqK = kQKBlocks * kDqKBlock;       // k of a stage
  static constexpr int kDqStage = kDqK + kVBlocks * kDqKBlock;
  static constexpr int kDqRing = kDqQBufs * kDqBuf;
  static constexpr int kDqSmem = kDqRing + kDqStages * kDqStage + 1024;
  static_assert(kDqSmem <= 232448 - 128, "smem");
};

// A `dkdv_wgmma` launch's tiles and shared memory, from a 1024-aligned
// base: k and v (k alone for dv), then the ring's kKvStages stages of q,
// dO, lse and D (kKvRows query rows and floats each), each padded to 1024
// bytes; 4 stages at (64, 64), as deep as a CTA's 227 KB allow at the
// wider pairs.
template <int DQK, int DV, Part kPart>
struct KvLayout {
  static constexpr int kQKBlocks = DQK / 64;
  static constexpr int kVBlocks = DV / 64;
  static constexpr int kKvRows = kPart == kDk && DQK == 192 ? 32 : 64;
  static constexpr int kKvQBlock = kKvRows * kRowBytes;    // of a q stage
  static constexpr int kKvK = kQKBlocks * kKvBlock;        // the k tile
  static constexpr int kKvRing =
      kKvK + (kPart == kDv ? 0 : kVBlocks * kKvBlock);
  static constexpr int kKvQ = kQKBlocks * kKvQBlock;       // q of a stage
  static constexpr int kKvDo = kVBlocks * kKvQBlock;
  static constexpr int kStatBytes = kKvRows * 4;           // lse or D
  static constexpr int kKvStage =
      (kKvQ + kKvDo + 2 * kStatBytes + 1023) / 1024 * 1024;
  static constexpr int kKvStages =
      DQK == 64 ? 4 : (232448 - 128 - 1024 - kKvRing) / kKvStage;
  static constexpr int kKvSmem = kKvRing + kKvStages * kKvStage + 1024;
  static_assert(kKvStages >= 2 && kKvSmem <= 232448 - 128, "smem");
};

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

// d (64 x 32, float32) = a · bᵀ over 16 columns, as `wgmma_ss_n64` with
// b (32 x 16).
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t a,
                                            uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 192, float32) += a · b, as `wgmma_rs_n64` with b (16 x 192).
__device__ __forceinline__ void wgmma_rs_n192(float (&d)[96],
                                             const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95}, "
      "{%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x N) = a · bᵀ over K columns: a's 64 rows and b's N rows in
// shared memory (K-major), each as K/64 column blocks `a_block` and
// `b_block` bytes apart; K/16 steps of 16 columns (32 bytes) each.
template <int K, int N>
__device__ __forceinline__ void product_ss(float (&d)[N / 2], uint32_t a_rows,
                                           uint32_t a_block, uint32_t b_rows,
                                           uint32_t b_block) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    const uint32_t col = (kk % 4) * 32;
    const uint64_t a = smem_desc(a_rows + (kk / 4) * a_block + col, 16,
                                 8 * kRowBytes);
    const uint64_t b = smem_desc(b_rows + (kk / 4) * b_block + col, 16,
                                 8 * kRowBytes);
    if constexpr (N == 64) wgmma_ss_n64(d, a, b, kk > 0);
    else wgmma_ss_n32(d, a, b, kk > 0);
  }
}

// d (64 x N) += a · b over b's K rows: a the bf16 A fragments of a
// 64 x K accumulator, b in shared memory as it lies (MN-major), its N
// columns as N/64 blocks `b_block` bytes apart (the descriptor's leading
// offset); K/16 steps of 16 rows each.
template <int K, int N>
__device__ __forceinline__ void product_rs(float (&d)[N / 2],
                                           const uint32_t (&a)[K / 4],
                                           uint32_t b_rows,
                                           uint32_t b_block) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    const uint64_t b = smem_desc(b_rows + kk * 16 * kRowBytes, b_block,
                                 8 * kRowBytes);
    if constexpr (N == 64) wgmma_rs_n64(d, &a[4 * kk], b);
    else if constexpr (N == 128) wgmma_rs_n128(d, &a[4 * kk], b);
    else wgmma_rs_n192(d, &a[4 * kk], b);
  }
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

// D = rowsum(dO ∘ o) of one row, (B, S, H, DV) bf16 at element offset
// `at`: this thread's DV/4 columns, then the row's four threads.
template <int DV>
__device__ __forceinline__ float row_delta(const bf16* o, const bf16* dout,
                                           long long at, bool in, int t4) {
  float sum = 0.f;
  if (in) {
    const uint4* po = reinterpret_cast<const uint4*>(o + at + DV / 4 * t4);
    const uint4* pd =
        reinterpret_cast<const uint4*>(dout + at + DV / 4 * t4);
#pragma unroll
    for (int c = 0; c < DV / 32; ++c) {
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
// query tile fastest, longest (highest) first, and the key tiles of
// kDqKeys keys the mask leaves.
struct DqTile {
  int q0, h, b, kvh, n_tiles;
};

template <int kDqKeys>
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

// P = exp2(s·scale_log2 − lse2) and dS = P ∘ (dP − D) of a 64 x NK tile
// in this thread's fragment (rows row0 and row1, keys key0 + 8 i + {0,
// 1}), dS rounded to bf16 as the A fragments of dS·k. With `mask`
// (uniform), keys past S or past the row when causal get P = 0.
template <int NK>
__device__ __forceinline__ void dq_grad(const float (&s)[NK / 2],
                                        const float (&dp)[NK / 2],
                                        uint32_t (&ds)[NK / 4], bool mask,
                                        int key0, int row0, int row1, int seq,
                                        int causal, float lse0, float lse1,
                                        float d0, float d1, float scale_log2) {
#pragma unroll
  for (int r = 0; r < NK / 2; r += 2) {
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

template <int DQK, int DV>
__global__ void __launch_bounds__(kThreadsBf16, 1)
dq_wgmma(const __grid_constant__ CUtensorMap q_map,     // 128-row boxes
       const __grid_constant__ CUtensorMap do_map,    // 128-row boxes
       const __grid_constant__ CUtensorMap k_map,     // kDqKeys-row boxes
       const __grid_constant__ CUtensorMap v_map,     // kDqKeys-row boxes
       const bf16* __restrict__ o, const bf16* __restrict__ dout,
       const float* __restrict__ lse, float* __restrict__ delta,
       bf16* __restrict__ dq, int* __restrict__ sched, int seq, int s_pad,
       int batch, int heads, int kv_heads, int causal, float scale_log2,
       float scale) {
  using L = BwdLayout<DQK, DV>;
  constexpr int kDqQBufs = L::kDqQBufs, kDqStages = L::kDqStages;
  constexpr int kDqKeys = L::kDqKeys, kDqKBlock = L::kDqKBlock;
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
        const DqTile t =
            dq_tile<kDqKeys>(w, q_tiles, heads, kv_heads, seq, causal);
        const uint32_t q_dst = base + qb * L::kDqBuf;
        mbar_expect_tx(qf, L::kDqBuf);
#pragma unroll
        for (int c = 0; c < L::kQKBlocks; ++c)
          tma_load(q_dst + c * kDqBlock, &q_map, qf, c * 64, t.h, t.q0, t.b);
#pragma unroll
        for (int c = 0; c < L::kVBlocks; ++c)
          tma_load(q_dst + L::kDqQ + c * kDqBlock, &do_map, qf, c * 64, t.h,
                   t.q0, t.b);
        for (int j = 0; j < t.n_tiles; ++j, ++g) {
          const int st = g % kDqStages;
          const uint32_t full = kv_full + 8 * st;
          if (g >= kDqStages)
            mbar_wait(kv_empty + 8 * st, ((g / kDqStages) & 1) ^ 1);
          const uint32_t dst = base + L::kDqRing + st * L::kDqStage;
          mbar_expect_tx(full, L::kDqStage);
#pragma unroll
          for (int c = 0; c < L::kQKBlocks; ++c)
            tma_load(dst + c * kDqKBlock, &k_map, full, c * 64, t.kvh,
                     j * kDqKeys, t.b);
#pragma unroll
          for (int c = 0; c < L::kVBlocks; ++c)
            tma_load(dst + L::kDqK + c * kDqKBlock, &v_map, full, c * 64,
                     t.kvh, j * kDqKeys, t.b);
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
    float s[kDqKeys / 2], dp[kDqKeys / 2], acc[DQK / 2];
    uint32_t ds[kDqKeys / 4];
    int g = 0;                              // k/v stages consumed so far
    for (int it = 0;; ++it) {
      const int qb = it % kDqQBufs;
      mbar_wait(q_full + 8 * qb, (it / kDqQBufs) & 1);
      // Read from shared memory, then shuffled: warp-uniform to ptxas.
      const int w = __shfl_sync(
          kFull, *reinterpret_cast<volatile int*>(&tile_slot[qb]), 0);
      if (w >= work) break;
      const DqTile t =
          dq_tile<kDqKeys>(w, q_tiles, heads, kv_heads, seq, causal);
      const uint32_t q_rows = base + qb * L::kDqBuf + wg * 64 * kRowBytes;
      const uint32_t do_rows = q_rows + L::kDqQ;
      // This thread's two rows (the accumulator fragment's g and g + 8),
      // their D (written for the second launch; 0 past S) and lse.
      const int row0 = t.q0 + wg * 64 + warp * 16 + g4, row1 = row0 + 8;
      const long long o_stride = static_cast<long long>(heads) * DV;
      const long long at = static_cast<long long>(t.b) * seq * o_stride
                           + t.h * DV;
      const float d0 = row_delta<DV>(o, dout, at + row0 * o_stride,
                                     row0 < seq, t4);
      const float d1 = row_delta<DV>(o, dout, at + row1 * o_stride,
                                     row1 < seq, t4);
      const long long stat = (static_cast<long long>(t.b) * heads + t.h)
                             * s_pad;
      if (t4 == 0) {
        delta[stat + row0] = d0;
        delta[stat + row1] = d1;
      }
      const float lse0 = row0 < seq ? lse[stat + row0] * kLog2e : 0.f;
      const float lse1 = row1 < seq ? lse[stat + row1] * kLog2e : 0.f;
#pragma unroll
      for (int i = 0; i < DQK / 2; ++i) acc[i] = 0.f;
      turns_begin(wg, mine, theirs);

      for (int j = 0; j < t.n_tiles; ++j, ++g) {
        const int st = g % kDqStages;
        const uint32_t k_tile = base + L::kDqRing + st * L::kDqStage;
        mbar_wait(kv_full + 8 * st, (g / kDqStages) & 1);
        named_sync(mine);
        wgmma_fence();
        product_ss<DQK, kDqKeys>(s, q_rows, kDqBlock, k_tile,
                                 kDqKBlock);                       // q·kᵀ
        product_ss<DV, kDqKeys>(dp, do_rows, kDqBlock, k_tile + L::kDqK,
                                kDqKBlock);                        // dO·vᵀ
        wgmma_commit();
        named_arrive(theirs);
        wgmma_wait<0>();
        fence_regs(s);
        fence_regs(dp);
        const int k0 = j * kDqKeys;
        dq_grad<kDqKeys>(
            s, dp, ds, k0 + kDqKeys > seq || (causal && k0 + kDqKeys > t.q0),
            k0 + 2 * t4, row0, row1, seq, causal, lse0, lse1, d0, d1,
            scale_log2);
        named_sync(mine);
        wgmma_fence();
        product_rs<kDqKeys, DQK>(acc, ds, k_tile, kDqKBlock);   // dq += dS·k
        wgmma_commit();
        named_arrive(theirs);
        wgmma_wait<0>();
        fence_regs(acc);
        fence_regs(ds);
        mbar_arrive_lane0(kv_empty + 8 * st, lane);    // stage st is free
      }
      turns_end(wg, mine, theirs);
      mbar_arrive_lane0(q_empty + 8 * qb, lane);       // q, dO read: refill

      const long long q_stride = static_cast<long long>(heads) * DQK;
      bf16* out = dq + static_cast<long long>(t.b) * seq * q_stride
                  + t.h * DQK + 2 * t4;
#pragma unroll
      for (int i = 0; i < DQK / 8; ++i) {
        if (row0 < seq)
          *reinterpret_cast<uint32_t*>(out + row0 * q_stride + 8 * i) =
              pack_bf16(acc[4 * i] * scale, acc[4 * i + 1] * scale);
        if (row1 < seq)
          *reinterpret_cast<uint32_t*>(out + row1 * q_stride + 8 * i) =
              pack_bf16(acc[4 * i + 2] * scale, acc[4 * i + 3] * scale);
      }
    }
  }
}

// Pᵀ (kP) and dSᵀ (kDs) of a 64-key x NQ-query tile in this thread's
// fragment: rows are keys key0 and key1, columns queries q0 + 8 i + 2 t4 +
// {0, 1}, whose lse (natural units) and D lie in shared memory. Both come
// out rounded to bf16 as the A fragments of Pᵀ·dO and dSᵀ·q. With `mask`
// (uniform), queries past S, or before the key when causal, get P = 0.
template <int NQ, bool kP, bool kDs>
__device__ __forceinline__ void dkdv_grad(
    const float (&st)[NQ / 2], const float (&dpt)[NQ / 2],
    uint32_t (&p)[NQ / 4], uint32_t (&ds)[NQ / 4], const float* lse_s,
    const float* d_s, bool mask, int q0, int t4, int key0, int key1, int seq,
    int causal, float scale_log2) {
#pragma unroll
  for (int i = 0; i < NQ / 8; ++i) {
    const int c = 8 * i + 2 * t4;
    const float2 l = *reinterpret_cast<const float2*>(lse_s + c);
    const float2 d = kDs ? *reinterpret_cast<const float2*>(d_s + c)
                         : make_float2(0.f, 0.f);
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
    if constexpr (kP) {
      p[2 * i] = pack_bf16(pr[0], pr[1]);
      p[2 * i + 1] = pack_bf16(pr[2], pr[3]);
    }
    if constexpr (kDs) {
      ds[2 * i] = pack_bf16(pr[0] * (dpt[4 * i] - d.x),
                            pr[1] * (dpt[4 * i + 1] - d.y));
      ds[2 * i + 1] = pack_bf16(pr[2] * (dpt[4 * i + 2] - d.x),
                                pr[3] * (dpt[4 * i + 3] - d.y));
    }
  }
}

// One `dkdv_wgmma` work tile: 128 keys of one KV head and batch, numbered
// key tile fastest, lowest (longest when causal) first.
struct KvTile {
  int k0, kvh, b, first;                    // first: the first query tile
};

__device__ __forceinline__ KvTile kv_tile(int w, int k_tiles, int kv_heads,
                                          int causal, int rows) {
  const int kt = w % k_tiles, hb = w / k_tiles;
  KvTile t;
  t.k0 = kt * kKvKeys;
  t.kvh = hb % kv_heads;
  t.b = hb / kv_heads;
  t.first = causal ? t.k0 / rows : 0;
  return t;
}

template <int DQK, int DV, Part kPart>
__global__ void __launch_bounds__(kThreadsBf16, 1)
dkdv_wgmma(const __grid_constant__ CUtensorMap k_map,    // 128-row boxes
         const __grid_constant__ CUtensorMap v_map,    // 128-row boxes
         const __grid_constant__ CUtensorMap q_map,    // kKvRows-row boxes
         const __grid_constant__ CUtensorMap do_map,   // kKvRows-row boxes
         const float* __restrict__ lse, const float* __restrict__ delta,
         bf16* __restrict__ dk, bf16* __restrict__ dv,
         int* __restrict__ sched, int seq, int s_pad, int batch, int heads,
         int kv_heads, int causal, float scale_log2, float scale) {
  using L = KvLayout<DQK, DV, kPart>;
  constexpr int kKvRows = L::kKvRows, kKvStages = L::kKvStages;
  constexpr int kStatBytes = L::kStatBytes;
  // dv needs no v: dPᵀ = v·dOᵀ is dk's
  constexpr bool kWantDk = kPart != kDv, kWantDv = kPart != kDk;
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
    // Producer: k and v (k alone for dv) of each work tile, then the
    // group's query heads' q, dO, lse and D tiles through the ring.
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
        const KvTile t = kv_tile(w, k_tiles, kv_heads, causal, kKvRows);
        mbar_expect_tx(kv_full, L::kKvRing);
#pragma unroll
        for (int c = 0; c < L::kQKBlocks; ++c)
          tma_load(base + c * kKvBlock, &k_map, kv_full, c * 64, t.kvh, t.k0,
                   t.b);
        if constexpr (kWantDk) {
#pragma unroll
          for (int c = 0; c < L::kVBlocks; ++c)
            tma_load(base + L::kKvK + c * kKvBlock, &v_map, kv_full, c * 64,
                     t.kvh, t.k0, t.b);
        }
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
            const uint32_t dst = base + L::kKvRing + st * L::kKvStage;
            const uint32_t stats = dst + L::kKvQ + L::kKvDo;
            mbar_expect_tx(bar, L::kKvQ + L::kKvDo + 2 * kStatBytes);
#pragma unroll
            for (int c = 0; c < L::kQKBlocks; ++c)
              tma_load(dst + c * L::kKvQBlock, &q_map, bar, c * 64, h,
                       qt * kKvRows, t.b);
#pragma unroll
            for (int c = 0; c < L::kVBlocks; ++c)
              tma_load(dst + L::kKvQ + c * L::kKvQBlock, &do_map, bar,
                       c * 64, h, qt * kKvRows, t.b);
            bulk_load(stats, lse_h + qt * kKvRows, kStatBytes, bar);
            bulk_load(stats + kStatBytes, delta_h + qt * kKvRows, kStatBytes,
                      bar);
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
    const uint32_t v_rows = k_rows + L::kKvK;
    float st_[kKvRows / 2], dpt[kKvRows / 2];
    constexpr int kDkN = kWantDk ? DQK / 2 : 1, kDvN = kWantDv ? DV / 2 : 1;
    float dk_acc[kDkN], dv_acc[kDvN];
    uint32_t p[kKvRows / 4], ds[kKvRows / 4];
    int g = 0;                              // stages consumed so far
    for (int it = 0;; ++it) {
      mbar_wait(kv_full, it & 1);
      const int w = __shfl_sync(
          kFull, *reinterpret_cast<volatile int*>(&tile_slot), 0);
      if (w >= work) break;
      const KvTile t = kv_tile(w, k_tiles, kv_heads, causal, kKvRows);
      // This thread's two keys (the accumulator fragment's g and g + 8).
      const int key0 = t.k0 + wg * 64 + warp * 16 + g4, key1 = key0 + 8;
#pragma unroll
      for (int i = 0; i < kDkN; ++i) dk_acc[i] = 0.f;
#pragma unroll
      for (int i = 0; i < kDvN; ++i) dv_acc[i] = 0.f;
      turns_begin(wg, mine, theirs);
      for (int h = 0; h < group; ++h) {
        for (int qt = t.first; qt < n_qt; ++qt, ++g) {
          const int sg = g % kKvStages;
          const uint32_t q_tile = base + L::kKvRing + sg * L::kKvStage;
          const uint32_t do_tile = q_tile + L::kKvQ;
          const float* lse_s = reinterpret_cast<const float*>(
              base_ptr + L::kKvRing + sg * L::kKvStage + L::kKvQ + L::kKvDo);
          mbar_wait(full + 8 * sg, (g / kKvStages) & 1);
          named_sync(mine);
          wgmma_fence();
          product_ss<DQK, kKvRows>(st_, k_rows, kKvBlock, q_tile,
                                   L::kKvQBlock);             // k·qᵀ
          if constexpr (kWantDk)
            product_ss<DV, kKvRows>(dpt, v_rows, kKvBlock, do_tile,
                                    L::kKvQBlock);            // v·dOᵀ
          wgmma_commit();
          named_arrive(theirs);
          wgmma_wait<0>();
          fence_regs(st_);
          if constexpr (kWantDk) fence_regs(dpt);
          dkdv_grad<kKvRows, kWantDv, kWantDk>(st_, dpt, p, ds, lse_s,
                             lse_s + kStatBytes / 4,
                             (causal && qt < t.first + kKvKeys / kKvRows)
                                 || (qt + 1) * kKvRows > seq,
                             qt * kKvRows, t4, key0, key1, seq, causal,
                             scale_log2);
          named_sync(mine);
          wgmma_fence();
          if constexpr (kWantDv)
            product_rs<kKvRows, DV>(dv_acc, p, do_tile,
                                    L::kKvQBlock);            // dv += Pᵀ·dO
          if constexpr (kWantDk)
            product_rs<kKvRows, DQK>(dk_acc, ds, q_tile,
                                     L::kKvQBlock);           // dk += dSᵀ·q
          wgmma_commit();
          named_arrive(theirs);
          wgmma_wait<0>();
          if constexpr (kWantDv) fence_regs(dv_acc);
          if constexpr (kWantDk) fence_regs(dk_acc);
          if constexpr (kWantDv) fence_regs(p);
          if constexpr (kWantDk) fence_regs(ds);
          mbar_arrive_lane0(empty + 8 * sg, lane);     // stage sg is free
        }
      }
      turns_end(wg, mine, theirs);
      mbar_arrive_lane0(kv_empty, lane);               // k, v read: refill

      const long long k_stride = static_cast<long long>(kv_heads) * DQK;
      const long long v_stride = static_cast<long long>(kv_heads) * DV;
      const long long k_at = static_cast<long long>(t.b) * seq * k_stride
                             + t.kvh * DQK + 2 * t4;
      const long long v_at = static_cast<long long>(t.b) * seq * v_stride
                             + t.kvh * DV + 2 * t4;
#pragma unroll
      for (int i = 0; i < DQK / 8; ++i) {
        if (key0 < seq) {
          if constexpr (kWantDk)
            *reinterpret_cast<uint32_t*>(dk + k_at + key0 * k_stride
                                         + 8 * i) =
                pack_bf16(dk_acc[4 * i] * scale, dk_acc[4 * i + 1] * scale);
          if constexpr (kWantDv)
            if (i < DV / 8)
              *reinterpret_cast<uint32_t*>(dv + v_at + key0 * v_stride
                                           + 8 * i) =
                  pack_bf16(dv_acc[4 * i], dv_acc[4 * i + 1]);
        }
        if (key1 < seq) {
          if constexpr (kWantDk)
            *reinterpret_cast<uint32_t*>(dk + k_at + key1 * k_stride
                                         + 8 * i) =
                pack_bf16(dk_acc[4 * i + 2] * scale,
                          dk_acc[4 * i + 3] * scale);
          if constexpr (kWantDv)
            if (i < DV / 8)
              *reinterpret_cast<uint32_t*>(dv + v_at + key1 * v_stride
                                           + 8 * i) =
                  pack_bf16(dv_acc[4 * i + 2], dv_acc[4 * i + 3]);
        }
      }
    }
  }
}

// One `dkdv_wgmma` launch of part kPart, its q and dO tensor maps of
// kKvRows-row boxes made here; `smem` must be its layout's.
template <int DQK, int DV, Part kPart>
cudaError_t launch_dkdv(const CUtensorMap& k_map, const CUtensorMap& v_map,
                        const void* q, const void* dout,
                        const long long* q_geom, const long long* do_geom,
                        const float* lse, const float* delta, void* dk,
                        void* dv, int* sched, int seq, int s_pad, int batch,
                        int heads, int kv_heads, int causal, float scale_log2,
                        float scale, int ctas, int smem,
                        cudaStream_t stream) {
  using L = KvLayout<DQK, DV, kPart>;
  if (smem != L::kKvSmem) return cudaErrorInvalidValue;
  CUtensorMap q_map, do_map;
  cudaError_t err = encode_map(&q_map, q, q_geom, L::kKvRows);
  if (err == cudaSuccess)
    err = encode_map(&do_map, dout, do_geom, L::kKvRows);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(dkdv_wgmma<DQK, DV, kPart>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               L::kKvSmem);
  if (err != cudaSuccess) return err;
  dkdv_wgmma<DQK, DV, kPart><<<ctas, kThreadsBf16, L::kKvSmem, stream>>>(
      k_map, v_map, q_map, do_map, lse, delta, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), sched, seq, s_pad, batch, heads, kv_heads,
      causal, scale_log2, scale);
  return cudaSuccess;
}

template <int DQK, int DV>
cudaError_t launch_bf16(const void* q, const void* k, const void* v,
                        const void* o, const void* dout, const float* lse,
                        void* dq, void* dk, void* dv, float* delta,
                        const long long* q_geom, const long long* k_geom,
                        const long long* v_geom, const long long* do_geom,
                        int s_pad, int causal, float scale_log2, float scale,
                        int ctas_dq, int ctas_dkdv, int dq_smem,
                        int dv_smem, int dk_smem, int* sched,
                        cudaStream_t stream) {
  using L = BwdLayout<DQK, DV>;
  const int seq = static_cast<int>(q_geom[2]);
  if (dq_smem != L::kDqSmem || q_geom[0] != DQK
      || k_geom[0] != DQK || v_geom[0] != DV || do_geom[0] != DV
      || k_geom[2] != seq || v_geom[2] != seq || do_geom[2] != seq
      || s_pad % kDqRows != 0 || s_pad < seq
      || ctas_dq < 1 || ctas_dkdv < 1)
    return cudaErrorInvalidValue;
  CUtensorMap q128, do128, k64, v64, k128, v128;
  cudaError_t err = encode_map(&q128, q, q_geom, kDqRows);
  if (err == cudaSuccess) err = encode_map(&do128, dout, do_geom, kDqRows);
  if (err == cudaSuccess) err = encode_map(&k64, k, k_geom, L::kDqKeys);
  if (err == cudaSuccess) err = encode_map(&v64, v, v_geom, L::kDqKeys);
  if (err == cudaSuccess) err = encode_map(&k128, k, k_geom, kKvKeys);
  if (err == cudaSuccess) err = encode_map(&v128, v, v_geom, kKvKeys);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(dq_wgmma<DQK, DV>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               L::kDqSmem);
  if (err != cudaSuccess) return err;
  const int batch = static_cast<int>(q_geom[3]);
  const int heads = static_cast<int>(q_geom[1]);
  const int kv_heads = static_cast<int>(k_geom[1]);
  // dq first: it writes D, which the dk launch reads.
  dq_wgmma<DQK, DV><<<ctas_dq, kThreadsBf16, L::kDqSmem, stream>>>(
      q128, do128, k64, v64, static_cast<const bf16*>(o),
      static_cast<const bf16*>(dout), lse, delta, static_cast<bf16*>(dq),
      sched, seq, s_pad, batch, heads, kv_heads, causal, scale_log2, scale);
  // dk and dv in one launch at (64, 64) (dv_smem = dk_smem, its layout's);
  // wider, dv and then dk
  if constexpr (L::kWide) {
    err = launch_dkdv<DQK, DV, kDv>(k128, v128, q, dout, q_geom, do_geom,
        lse, delta, dk, dv, sched, seq, s_pad, batch, heads, kv_heads,
        causal, scale_log2, scale, ctas_dkdv, dv_smem, stream);
    if (err == cudaSuccess)
      err = launch_dkdv<DQK, DV, kDk>(k128, v128, q, dout, q_geom, do_geom,
          lse, delta, dk, dv, sched, seq, s_pad, batch, heads, kv_heads,
          causal, scale_log2, scale, ctas_dkdv, dk_smem, stream);
  } else {
    err = dv_smem == dk_smem ? cudaSuccess : cudaErrorInvalidValue;
    if (err == cudaSuccess)
      err = launch_dkdv<DQK, DV, kDkDv>(k128, v128, q, dout, q_geom,
          do_geom, lse, delta, dk, dv, sched, seq, s_pad, batch, heads,
          kv_heads, causal, scale_log2, scale, ctas_dkdv, dk_smem, stream);
  }
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dq, dk, dv of o = attention(q, k, v): q and dq (batch, seq, heads,
// head_dim), k and dk (batch, seq, kv_heads, head_dim), v and dv (batch,
// seq, kv_heads, v_dim), o and dout (batch, seq, heads, v_dim), all
// contiguous and of one dtype (`is_bf16`: bf16, else float32), with
// (head_dim, v_dim) = (64, 64), (128, 128) or (192, 128); `lse` the
// forward's (batch, heads, s_pad) float32 logsumexp in natural units,
// s_pad = seq rounded up to 128, and `delta` (batch, heads, s_pad) float32
// scratch. `scale_log2` is log2(e)/√head_dim and `scale` 1/√head_dim.
// bf16 only: `q_geom`, `k_geom`, `v_geom` and `do_geom` are the tensor
// maps' (head dim, heads, seq, batch) and byte strides of q, k, v and
// dout; `ctas_dq` and `ctas_dkdv` persistent CTAs take the two launches'
// work tiles from `sched`, two ints that are 0 before the launches and 0
// after each; `dq_smem`, `dv_smem` and `dk_smem` are the dynamic shared
// memory of the dq, dv and dk launches (dv_smem = dk_smem: the dk/dv
// launch's at (64, 64)), which must be the kernels' layouts.
int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                               const void* o, const void* dout,
                               const float* lse, void* dq, void* dk,
                               void* dv, float* delta,
                               const long long* q_geom,
                               const long long* k_geom,
                               const long long* v_geom,
                               const long long* do_geom, int batch, int seq,
                               int heads, int kv_heads, int head_dim,
                               int v_dim, int s_pad, int causal, int is_bf16,
                               float scale_log2, float scale, int ctas_dq,
                               int ctas_dkdv, int dq_smem, int dv_smem,
                               int dk_smem, int* sched,
                               cudaStream_t stream) {
  cudaError_t err = cudaErrorInvalidValue;
  if (is_bf16) {
    if (head_dim == 64 && v_dim == 64)
      err = launch_bf16<64, 64>(q, k, v, o, dout, lse, dq, dk, dv, delta,
          q_geom, k_geom, v_geom, do_geom, s_pad, causal, scale_log2, scale,
          ctas_dq, ctas_dkdv, dq_smem, dv_smem, dk_smem, sched, stream);
    else if (head_dim == 128 && v_dim == 128)
      err = launch_bf16<128, 128>(q, k, v, o, dout, lse, dq, dk, dv, delta,
          q_geom, k_geom, v_geom, do_geom, s_pad, causal, scale_log2, scale,
          ctas_dq, ctas_dkdv, dq_smem, dv_smem, dk_smem, sched, stream);
    else if (head_dim == 192 && v_dim == 128)
      err = launch_bf16<192, 128>(q, k, v, o, dout, lse, dq, dk, dv, delta,
          q_geom, k_geom, v_geom, do_geom, s_pad, causal, scale_log2, scale,
          ctas_dq, ctas_dkdv, dq_smem, dv_smem, dk_smem, sched, stream);
  } else if (head_dim == 64 && v_dim == 64) {
    err = launch_f32<64, 64>(q, k, v, o, dout, lse, dq, dk, dv, delta,
        batch, seq, s_pad, heads, kv_heads, causal, scale_log2, scale,
        stream);
  } else if (head_dim == 128 && v_dim == 128) {
    err = launch_f32<128, 128>(q, k, v, o, dout, lse, dq, dk, dv, delta,
        batch, seq, s_pad, heads, kv_heads, causal, scale_log2, scale,
        stream);
  } else if (head_dim == 192 && v_dim == 128) {
    err = launch_f32<192, 128>(q, k, v, o, dout, lse, dq, dk, dv, delta,
        batch, seq, s_pad, heads, kv_heads, causal, scale_log2, scale,
        stream);
  }
  return static_cast<int>(err);
}

const char* flash_attention_bwd_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

}  // extern "C"
