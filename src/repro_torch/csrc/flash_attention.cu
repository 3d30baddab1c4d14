// flash_attention: causal or non-causal GQA attention for Hopper (sm_90a).
//
// Replaces the TPU kernel
// src/repro/kernels/flash_attention/flash_attention.py (`flash_attention`,
// body `_flash_kernel`). Same function: o = softmax(q·kᵀ/√dh)·v per query
// head, query head h reading KV head h / (H/KV), the mask
// key >= S || (causal && key > row) at -1e30, an online softmax in log2
// units with float32 (m, l, acc) state, and 1/max(l, 1e-30) at the end; o
// is written in q's dtype. Layout is the model stack's: q (B,S,H,dh), k
// (B,Sk,KV,dh), v (B,Sk,KV,dv) and o (B,S,H,dv). k and v may have Sk >= S
// rows (context parallelism: a rank's query rows against every key up to
// its last row); query row i then sits at position Sk - S + i, aligned
// bottom-right as FlashAttention 2 aligns it, so the causal mask is
// key > Sk - S + row; the bf16 kernel asks (Sk - S) % 128 == 0 when
// causal, so its diagonal tile stays the only masked one besides the
// ragged last, and each row reads the same key tiles, in the same order,
// as in a launch over all Sk rows (so the same bits). Launches with
// Sk = S run an instance of their own in which the offset is 0 at compile
// time, the code they ran before. The TPU kernel takes
// dv = dh; (dh, dv) = (192, 128) is MLA's prefill (deepseek-v2: q·k over
// 128 latent-decompressed and 64 rotary dims, v of 128), which the
// reference's model computes in `chunked_causal_attention` with the same
// 1/√dh scale. Pairs: (64, 64), (128, 128) and (192, 128).
//
// Given a pointer `lse` (a float32 (B, H, s_pad) buffer, s_pad = S rounded
// up to 128), both paths also write each row's logsumexp of its scaled,
// masked scores, in natural units: ln 2 · (m + log2 l) from the (m, l) the
// online softmax ends with (m in log2 units). Every row of every query tile
// is written, rows past S too (their q reads as zeros, so theirs is
// finite). The backward kernel (flash_attention_bwd.cu) takes P from it
// instead of recomputing the statistics. With a null pointer (scoring and
// prefill, which need no gradient) nothing more is stored: the bf16 kernel
// is instantiated with and without the store, so those launches run the
// code they ran before it (a runtime branch in the epilogue cost the
// no-store launch up to 6% at zamba2's scoring shape in a side-by-side
// run, where each work tile reads one key tile).
//
// Bound on this card: operations. At the smollm-360m prefill shape
// (B=4, S=4096, H=15, dh=64, causal) the two products take
// 2·2·B·H·(S²/2)·dh = 1.29e11 bf16 operations (0.130 ms at 989 TFLOP/s)
// against 83.9 MB of q, k, v and o (0.025 ms at 3.35 TB/s). At the scoring
// shape (B=256, S=128) the same count is 8.1e9 operations against 168 MB:
// there the bytes bound it. The softmax's exp2s (B·H·S²/2 = 5.0e8 at the
// prefill shape) take about as long as the products on the special-function
// units (16 a clock per SM), so the kernel only nears its bound when they
// overlap the products. (Side-by-side variants that moved a quarter or a
// half of them to an FMA polynomial ran slower: the kernel is not held
// back by those units alone.)
//
// bf16 design (`flash_bf16`), one template for the three (dh, dv) pairs:
// * Persistent CTAs, one an SM, each with three warpgroups: a producer
//   warpgroup, whose first thread issues every TMA load and which gives
//   its registers to the consumers (setmaxnreg), and two consumer
//   warpgroups of 64 query rows each. A work tile is 128 query rows of one
//   head and batch; CTAs take them from a counter in device memory, so the
//   causal tiles' unequal lengths balance out. Tiles are numbered query
//   tile fastest, longest first: the CTAs in flight share a few heads' k
//   and v in L2, and the short causal tiles come last. The counter (two
//   ints a stream) is reset by the launch's last CTA, so no launch needs a
//   memset.
// * q goes through two buffers (one at dh 128 and 192) and k and v tiles
//   of 128 keys through a ring of 4 stages (3 at dh 128, 2 at (192, 128))
//   in dynamic shared memory, each with full and empty mbarriers: the next
//   work tile's q and first k and v load while this one finishes, and its
//   epilogue (stores from registers) overlaps them. (Side-by-side variants
//   with one q buffer, 2 stages or a grid of one CTA a work tile ran
//   slower.) The 4-D tensor maps over (head dim, heads, S, batch) are
//   built by the wrapper from the tensors' strides, one each for q, k and
//   v; TMA zero-fills rows past S and writes each 64-column block with
//   the 128-byte swizzle the wgmma descriptors name.
//   Key tiles wholly above the diagonal are never loaded.
// * s = q·kᵀ by dh/16 wgmma m64n128k16 with both operands in shared
//   memory (K-major); o += p·v by wgmma m64n{dv}k16 with p from registers
//   (the score accumulator re-packed as the A fragment, rounded to bf16 as
//   flash-attention kernels do) and v read as it lies, an MN-major B
//   operand (the transpose bf16 allows). Nothing of the S x S scores
//   leaves registers.
// * The two consumer warpgroups take turns on the tensor cores (named
//   barriers, FlashAttention-3's ping-pong). A turn issues q·kᵀ of tile
//   j + 1 and then p·v of tile j; the warpgroup then runs tile j + 1's
//   softmax while its own p·v and the other warpgroup's turn run, and
//   rescales acc and re-packs p once its p·v is done. The last key tile,
//   the only one with masked keys (the diagonal when causal, the ragged
//   tile otherwise), is peeled off the loop, and the warpgroup index and
//   the work tile read from shared memory are made warp-uniform with a
//   shuffle: ptxas serializes wgmmas that sit on a path it cannot prove
//   uniform (advisory C7520, which cost a fifth of the kernel's time in a
//   side-by-side variant). The reduction order is fixed and there are no
//   atomics in the sums: launches repeat bitwise.
// * At dh 128 the consumers' 232 registers do not hold s, p and a 64-wide
//   acc with the wgmma pipeline, and ptxas serializes the wgmmas (C7512):
//   right, but slower than it could be. dh 128 carries every attention
//   layer of yi-6b, deepseek-7b, qwen1.5-4b, chameleon-34b and
//   llama4-maverick (GQA ratios 8, 1, 1, 8 and 5); its times beside
//   scaled_dot_product_attention are in PERF.md §6.
// * (192, 128) keeps dh 128's registers (s, p and a 64-wide acc) and its
//   p·v, and runs q·kᵀ as 12 wgmma steps where dh 128 runs 8: a longer
//   chain under the same serialization. Its shared memory holds 48 KB of q
//   and two 80 KB stages (209 KB with the alignment slack). A simple path,
//   not yet tuned; its time beside its bound is in PERF.md §6.
//
// float32 (`flash_f32`): the card's exact float32 arbiter for the float32
// model copies. CUDA cores only (no TF32), so it is exact to float32
// rounding. One CTA per 64 query rows; four threads share a query row,
// each holding every fourth dimension of q and of acc; a row's dot products
// are summed with two warp shuffles. Both paths mask the ragged last tile,
// so any S >= 1 runs, where the Pallas kernel asserts S % block == 0.
//
// Times on NVIDIA H100 80GB HBM3, 700.00 W (chip_smoke.py --seed 0, bf16
// causal; PERF.md §6): 0.3432 ms at smollm-360m's (4, 4096, 15/5, 64)
// against scaled_dot_product_attention's 0.3142 ms and a 0.1303 ms bound;
// 0.6867 ms at zamba2-1.2b's (4, 4096, 32/32, 64) against 0.6342 ms; 0.0987
// ms at the scoring shape (256, 128, 15/5, 64) against 0.0908 ms. The
// mma.sync kernel this design replaced took 1.2694, 2.6201 and 0.1728 ms
// on the same card and limit (PERF.md §6).
#include <math_constants.h>

#include "hopper.cuh"

namespace {

constexpr int kBQ = 64;                 // query rows a CTA (float32)
constexpr int kBK32 = 32;               // keys a tile (float32)
constexpr int kThreads32 = 256;         // float32: 64 rows x 4 threads
constexpr float kNegInf = -1e30f;
constexpr float kLn2 = 0.6931471805599453f;

// -- bf16: tiles, shared memory, barriers ------------------------------------

constexpr int kTileQ = 128;             // query rows a CTA: 2 x 64
constexpr int kTileK = 128;             // keys a K/V tile
constexpr int kMaxStages = 4;           // K/V ring depth at dh 64 (Layout)
constexpr int kThreadsBf16 = 384;       // producer + 2 consumer warpgroups
constexpr int kConsumerWarps = 8;
static_assert(kTileQ == kTileK, "the causal tile count assumes it");

constexpr int kQBlock = kTileQ * kRowBytes;    // a 64-column block of q
constexpr int kKVBlock = kTileK * kRowBytes;   // of a K or V tile

// Shared memory of one CTA, in bytes from a 1024-aligned base: q, then the
// K ring, then the V ring; q and K tiles are DQK/64 column blocks and V
// tiles DV/64 of 128-byte rows (the TMA box and the 128-byte swizzle atom).
// The ring is as deep as a CTA's 227 KB allow, so loads run ahead of the
// products by more than their latency: 4 stages at (64, 64), 3 at
// (128, 128), 2 at (192, 128) (48 KB of q and 80 KB a stage; a third stage
// would need 289 KB).
template <int DQK, int DV>
struct Layout {
  static constexpr int kStages = DQK == 64 ? 4 : DQK == 128 ? 3 : 2;
  static constexpr int kQStages = DQK == 64 ? 2 : 1;  // q buffers
  static constexpr int kQKBlocks = DQK / 64;           // of q and K tiles
  static constexpr int kVBlocks = DV / 64;
  static constexpr int kQBytes = kQKBlocks * kQBlock;
  static constexpr int kKTileBytes = kQKBlocks * kKVBlock;
  static constexpr int kVTileBytes = kVBlocks * kKVBlock;
  static constexpr int kK = kQStages * kQBytes;
  static constexpr int kV = kK + kStages * kKTileBytes;
  static constexpr int kBytes = kV + kStages * kVTileBytes + 1024;  // + align
  static_assert(kStages <= kMaxStages && kBytes <= 232448 - 128, "smem");
};

// d (64 x 128, float32) += a · bᵀ, a (64 x 16) and b (128 x 16) bf16 in
// shared memory, both K-major (descriptors); d is overwritten if !accumulate.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a,
                                             uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

// Online softmax of one tile of scores in log2 units, for this thread's
// rows row0 and row1: the row maxima m and sums l move on, s becomes
// exp2(s · scale - m), and (c0, c1) are the factors the running output
// must be scaled by (`rescale_pack`, once the product that reads it has
// finished). With `mask` (the last tile, uniform), keys past seq_k, or
// past the row's position pos0 / pos1 when causal, score -inf (weight 0);
// k0 is the tile's first key. Every row keeps at least one key in every
// tile it reads.
__device__ __forceinline__ void softmax_scores(
    float (&s)[64], float& m0, float& m1, float& l0, float& l1, float& c0,
    float& c1, bool mask, int k0, int pos0, int pos1, int seq_k, int causal,
    float scale_log2) {
  if (mask) {
    const int key0 = k0 + 2 * (threadIdx.x & 3);
#pragma unroll
    for (int r = 0; r < 64; ++r) {
      const int key = key0 + 8 * (r >> 2) + (r & 1);
      const int pos = (r & 2) ? pos1 : pos0;
      if (key >= seq_k || (causal && key > pos)) s[r] = -CUDART_INF_F;
    }
  }
  float mx0 = -CUDART_INF_F, mx1 = -CUDART_INF_F;
#pragma unroll
  for (int r = 0; r < 64; r += 4) {
    mx0 = fmaxf(mx0, fmaxf(s[r], s[r + 1]));
    mx1 = fmaxf(mx1, fmaxf(s[r + 2], s[r + 3]));
  }
  mx0 = fmaxf(mx0, __shfl_xor_sync(kFull, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(kFull, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(kFull, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(kFull, mx1, 2));
  const float mn0 = fmaxf(m0, mx0 * scale_log2);
  const float mn1 = fmaxf(m1, mx1 * scale_log2);
  c0 = ex2(m0 - mn0);
  c1 = ex2(m1 - mn1);
  m0 = mn0;
  m1 = mn1;
  float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
  for (int r = 0; r < 64; r += 4) {
    s[r] = ex2(fmaf(s[r], scale_log2, -mn0));
    s[r + 1] = ex2(fmaf(s[r + 1], scale_log2, -mn0));
    s[r + 2] = ex2(fmaf(s[r + 2], scale_log2, -mn1));
    s[r + 3] = ex2(fmaf(s[r + 3], scale_log2, -mn1));
    sum0 += s[r] + s[r + 1];
    sum1 += s[r + 2] + s[r + 3];
  }
  l0 = l0 * c0 + sum0;                // this thread's part of the row sum
  l1 = l1 * c1 + sum1;
}

// acc *= (c0, c1) by row, and p = s as bf16: the A fragment of p·v (score
// blocks 2kk and 2kk + 1, keys 16kk .. 16kk + 15, are step kk's).
template <int DV>
__device__ __forceinline__ void rescale_pack(float (&acc)[DV / 2],
                                             uint32_t (&p)[32],
                                             const float (&s)[64], float c0,
                                             float c1) {
#pragma unroll
  for (int i = 0; i < DV / 2; i += 4) {
    acc[i] *= c0;
    acc[i + 1] *= c0;
    acc[i + 2] *= c1;
    acc[i + 3] *= c1;
  }
#pragma unroll
  for (int kk = 0; kk < kTileK / 16; ++kk) {
    p[4 * kk] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
    p[4 * kk + 1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
    p[4 * kk + 2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    p[4 * kk + 3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

// s (64 x 128 keys) = q·kᵀ for this warpgroup's 64 rows: DQK/16 steps of
// wgmma m64n128k16, each 16 columns (32 bytes) further into a row.
template <int DQK>
__device__ __forceinline__ void qk_product(float (&s)[64], uint32_t q_rows,
                                           uint32_t k_tile) {
#pragma unroll
  for (int kk = 0; kk < DQK / 16; ++kk) {
    const uint32_t col = (kk % 4) * 32;
    wgmma_ss_n128(s,
                  smem_desc(q_rows + (kk / 4) * kQBlock + col, 16,
                            8 * kRowBytes),
                  smem_desc(k_tile + (kk / 4) * kKVBlock + col, 16,
                            8 * kRowBytes),
                  kk > 0);
  }
}

// o (64 x DV) += p·v over the tile's 128 keys: 8 steps of wgmma
// m64n{DV}k16, each 16 keys (16 rows of v) further.
template <int DV>
__device__ __forceinline__ void pv_product(float (&o)[DV / 2],
                                           const uint32_t (&p)[32],
                                           uint32_t v_tile) {
#pragma unroll
  for (int kk = 0; kk < kTileK / 16; ++kk) {
    const uint64_t desc = smem_desc(v_tile + kk * 16 * kRowBytes, kKVBlock,
                                    8 * kRowBytes);
    if constexpr (DV == 64) wgmma_rs_n64(o, &p[4 * kk], desc);
    else wgmma_rs_n128(o, &p[4 * kk], desc);
  }
}

// One work tile: 128 query rows of one head and batch. Tiles are numbered
// query tile fastest, longest (highest) first, so the CTAs in flight share
// a few heads' k and v in L2 and the short causal tiles come last. With
// seq_k = seq + offset keys (offset a multiple of kTileK when causal),
// query row i sits at position offset + i: a causal tile reads offset /
// kTileK more key tiles, the last of them still its diagonal.
struct WorkTile {
  int q0, h, b, kvh, n_tiles;
};

__device__ __forceinline__ WorkTile work_tile(int w, int q_tiles, int heads,
                                              int kv_heads, int seq_k,
                                              int offset, int causal) {
  const int qt = q_tiles - 1 - w % q_tiles, hb = w / q_tiles;
  WorkTile t;
  t.q0 = qt * kTileQ;
  t.h = hb % heads;
  t.b = hb / heads;
  t.kvh = t.h / (heads / kv_heads);
  t.n_tiles = causal ? qt + 1 + offset / kTileK
                     : (seq_k + kTileK - 1) / kTileK;
  return t;
}

// kLse: store each row's logsumexp into `lse` (an instance of its own,
// so the launches that store none run the code they ran before). kLong:
// seq_k > seq keys, or any seq_k != seq; without it the offset is the
// constant 0 and the key bound seq, so launches with as many keys as
// queries run the code they ran before keys could be longer (a runtime
// offset cost those 3-5% at the prefill shapes in a side-by-side run).
template <int DQK, int DV, bool kLse, bool kLong>
__global__ void __launch_bounds__(kThreadsBf16, 1)
flash_bf16(const __grid_constant__ CUtensorMap q_map,
           const __grid_constant__ CUtensorMap k_map,
           const __grid_constant__ CUtensorMap v_map,
           __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
           int lse_stride, int* __restrict__ sched, int seq, int seq_k,
           int batch, int heads, int kv_heads, int causal,
           float scale_log2) {
  using L = Layout<DQK, DV>;
  constexpr int kStages = L::kStages, kQStages = L::kQStages;
  extern __shared__ uint8_t smem_raw[];
  // mbarriers: per q buffer full and empty; per stage K full, V full, K/V
  // empty.
  __shared__ __align__(8) uint64_t bars[4 + 3 * kMaxStages];
  __shared__ int tile_slot[2];              // the work tile each q holds
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_full = smem_u32(&bars[0]);              // + 8 * buffer
  const uint32_t q_empty = smem_u32(&bars[2]);
  const uint32_t k_full = smem_u32(&bars[4]);              // + 8 * stage
  const uint32_t v_full = smem_u32(&bars[4 + kStages]);
  const uint32_t empty = smem_u32(&bars[4 + 2 * kStages]);
  const int q_tiles = (seq + kTileQ - 1) / kTileQ;
  const int work = q_tiles * heads * batch;
  const int offset = kLong ? seq_k - seq : 0;   // query row i at offset + i
  const int keys = kLong ? seq_k : seq;

  if (threadIdx.x == 0) {
    for (int qs = 0; qs < kQStages; ++qs) {
      mbar_init(q_full + 8 * qs, 1);
      mbar_init(q_empty + 8 * qs, kConsumerWarps);
    }
    for (int st = 0; st < kStages; ++st) {
      mbar_init(k_full + 8 * st, 1);
      mbar_init(v_full + 8 * st, 1);
      mbar_init(empty + 8 * st, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // The warpgroup index, warp-uniform as the compiler sees it (a shuffle),
  // so no wgmma sits on a path it must treat as divergent.
  const int role = __shfl_sync(kFull, static_cast<int>(threadIdx.x) / 128, 0);
  if (role == 0) {
    // Producer warpgroup: its first thread takes work tiles from the
    // counter and keeps q and the K/V ring full, running ahead of the
    // consumers into the next work tile.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      int g = 0;                            // K/V tiles issued so far
      for (int it = 0;; ++it) {
        const int w = atomicAdd(sched, 1);
        const int qs = it % kQStages;
        const uint32_t qf = q_full + 8 * qs;
        if (it >= kQStages)
          mbar_wait(q_empty + 8 * qs, ((it / kQStages) & 1) ^ 1);
        tile_slot[qs] = w;
        if (w >= work) {
          mbar_arrive(qf);                  // no more work: let them exit
          break;
        }
        const WorkTile t =
            work_tile(w, q_tiles, heads, kv_heads, keys, offset, causal);
        const uint32_t q_dst = base + qs * L::kQBytes;
        mbar_expect_tx(qf, L::kQBytes);
        for (int c = 0; c < L::kQKBlocks; ++c)
          tma_load(q_dst + c * kQBlock, &q_map, qf, c * 64, t.h, t.q0, t.b);
        for (int j = 0; j < t.n_tiles; ++j, ++g) {
          const int st = g % kStages;
          if (g >= kStages)
            mbar_wait(empty + 8 * st, ((g / kStages) & 1) ^ 1);
          const uint32_t k_dst = base + L::kK + st * L::kKTileBytes;
          const uint32_t v_dst = base + L::kV + st * L::kVTileBytes;
          mbar_expect_tx(k_full + 8 * st, L::kKTileBytes);
          for (int c = 0; c < L::kQKBlocks; ++c)
            tma_load(k_dst + c * kKVBlock, &k_map, k_full + 8 * st, c * 64,
                     t.kvh, j * kTileK, t.b);
          mbar_expect_tx(v_full + 8 * st, L::kVTileBytes);
          for (int c = 0; c < L::kVBlocks; ++c)
            tma_load(v_dst + c * kKVBlock, &v_map, v_full + 8 * st, c * 64,
                     t.kvh, j * kTileK, t.b);
        }
      }
      // Every CTA takes one tile past the end; the last to do so resets
      // the counter for the next launch on this stream.
      __threadfence();
      if (atomicAdd(sched + 1, 1) == static_cast<int>(gridDim.x) - 1) {
        sched[0] = 0;
        sched[1] = 0;
      }
    }
  } else {
    // Consumer warpgroups 0 and 1: 64 query rows each of every work tile.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int wg = role - 1;
    const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int g4 = lane >> 2, t4 = lane & 3;
    const uint32_t mine = kTurn0 + wg, theirs = kTurn0 + 1 - wg;
    float s[64], acc[DV / 2];
    uint32_t p[32];

    // The turns alternate across work tiles: consumer 0 takes the first,
    // consumer 1 hands over after each of its bursts, and consumer 0 takes
    // one last turn at the end, so every arrival is waited for.
    if (wg == 1) named_arrive(theirs);
    int g = 0;                              // K/V tiles consumed so far
    for (int it = 0;; ++it) {
      const int qs = it % kQStages;
      mbar_wait(q_full + 8 * qs, (it / kQStages) & 1);
      // Read from shared memory, then shuffled: warp-uniform to ptxas.
      const int w = __shfl_sync(
          kFull, *reinterpret_cast<volatile int*>(&tile_slot[qs]), 0);
      if (w >= work) break;
      const uint32_t q_rows = base + qs * L::kQBytes + wg * 64 * kRowBytes;
      const WorkTile t =
          work_tile(w, q_tiles, heads, kv_heads, keys, offset, causal);
      // This thread's two rows (the accumulator fragment's g and g + 8),
      // and their positions among the keys.
      const int row0 = t.q0 + wg * 64 + warp * 16 + g4, row1 = row0 + 8;
      const int pos0 = row0 + offset, pos1 = row1 + offset;
#pragma unroll
      for (int i = 0; i < DV / 2; ++i) acc[i] = 0.f;
      float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f, c0, c1;

      // The first burst: s of the tile's first keys, and its softmax.
      mbar_wait(k_full + 8 * (g % kStages), (g / kStages) & 1);
      named_sync(mine);
      wgmma_fence();
      qk_product<DQK>(s, q_rows,
                      base + L::kK + (g % kStages) * L::kKTileBytes);
      wgmma_commit();
      named_arrive(theirs);
      wgmma_wait<0>();
      fence_regs(s);
      softmax_scores(s, m0, m1, l0, l1, c0, c1, t.n_tiles == 1, 0, pos0,
                     pos1, keys, causal, scale_log2);
      rescale_pack<DV>(acc, p, s, c0, c1);

      // Steady state, one burst on the tensor cores a key tile: q·kᵀ of
      // tile j + 1, then p·v of tile j. The softmax of tile j + 1 runs
      // while p·v does (and while the other warpgroup's burst does); acc
      // and p are touched only once p·v is done. Only the last key tile
      // has masked keys.
      for (int j = 0; j + 1 < t.n_tiles; ++j) {
        const int st = (g + j) % kStages, nx = (g + j + 1) % kStages;
        mbar_wait(k_full + 8 * nx, ((g + j + 1) / kStages) & 1);
        mbar_wait(v_full + 8 * st, ((g + j) / kStages) & 1);
        named_sync(mine);
        wgmma_fence();
        qk_product<DQK>(s, q_rows, base + L::kK + nx * L::kKTileBytes);
        wgmma_commit();
        pv_product<DV>(acc, p, base + L::kV + st * L::kVTileBytes);
        wgmma_commit();
        named_arrive(theirs);
        wgmma_wait<1>();                              // s of tile j + 1
        fence_regs(s);
        softmax_scores(s, m0, m1, l0, l1, c0, c1, j + 2 == t.n_tiles,
                       (j + 1) * kTileK, pos0, pos1, keys, causal,
                       scale_log2);
        wgmma_wait<0>();                              // p·v of tile j
        fence_regs(acc);
        fence_regs(p);
        mbar_arrive_lane0(empty + 8 * st, lane);     // stage st is free
        rescale_pack<DV>(acc, p, s, c0, c1);
      }
      mbar_arrive_lane0(q_empty + 8 * qs, lane);     // q is read: refill
      // p·v of the last key tile.
      {
        const int st = (g + t.n_tiles - 1) % kStages;
        mbar_wait(v_full + 8 * st, ((g + t.n_tiles - 1) / kStages) & 1);
        named_sync(mine);
        wgmma_fence();
        pv_product<DV>(acc, p, base + L::kV + st * L::kVTileBytes);
        wgmma_commit();
        named_arrive(theirs);
        wgmma_wait<0>();
        fence_regs(acc);
        mbar_arrive_lane0(empty + 8 * st, lane);
      }
      g += t.n_tiles;

      l0 += __shfl_xor_sync(kFull, l0, 1);
      l0 += __shfl_xor_sync(kFull, l0, 2);
      l1 += __shfl_xor_sync(kFull, l1, 1);
      l1 += __shfl_xor_sync(kFull, l1, 2);
      if (kLse && t4 == 0) {                // rows past S too: finite
        float* lb = lse + (static_cast<long long>(t.b) * heads + t.h)
                              * lse_stride;
        lb[row0] = kLn2 * (m0 + log2f(l0));
        lb[row1] = kLn2 * (m1 + log2f(l1));
      }
      const float inv0 = 1.f / fmaxf(l0, 1e-30f);
      const float inv1 = 1.f / fmaxf(l1, 1e-30f);
      const long long o_stride = static_cast<long long>(heads) * DV;
      __nv_bfloat16* ob = o + static_cast<long long>(t.b) * seq * o_stride
                          + t.h * DV + 2 * t4;
#pragma unroll
      for (int i = 0; i < DV / 8; ++i) {
        if (row0 < seq)
          *reinterpret_cast<uint32_t*>(ob + row0 * o_stride + 8 * i) =
              pack_bf16(acc[4 * i] * inv0, acc[4 * i + 1] * inv0);
        if (row1 < seq)
          *reinterpret_cast<uint32_t*>(ob + row1 * o_stride + 8 * i) =
              pack_bf16(acc[4 * i + 2] * inv1, acc[4 * i + 3] * inv1);
      }
    }
    if (wg == 0) named_sync(mine);          // consumer 1's last hand-over
  }
}

// Keys a float32 query tile reads: up to the diagonal when causal (query
// row i at position offset + i).
__device__ __forceinline__ int key_tiles(int qt, int seq_k, int offset,
                                         int causal, int bk) {
  const int last = causal ? min(seq_k - 1, (qt + 1) * kBQ - 1 + offset)
                          : seq_k - 1;
  return last / bk + 1;
}

template <int DQK, int DV>
__global__ void __launch_bounds__(kThreads32)
flash_f32(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, float* __restrict__ o,
          float* __restrict__ lse, int lse_stride, int seq, int seq_k,
          int heads, int kv_heads, int causal, float scale_log2) {
  constexpr int kPerQ = DQK / 4;        // dims a thread holds: part + 4*i
  constexpr int kPerV = DV / 4;
  __shared__ float ks[kBK32 * DQK];     // 40 KB at (192, 128)
  __shared__ float vs[kBK32 * DV];

  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const long long batch_off = static_cast<long long>(blockIdx.z) * seq;
  const long long kv_off = static_cast<long long>(blockIdx.z) * seq_k;
  const int offset = seq_k - seq;         // query row i's position: + i
  const int kvh = h / (heads / kv_heads);
  const int part = threadIdx.x & 3;
  const int row = qt * kBQ + (threadIdx.x >> 2);
  const long long q_stride = static_cast<long long>(heads) * DQK;
  const long long k_stride = static_cast<long long>(kv_heads) * DQK;
  const long long v_stride = static_cast<long long>(kv_heads) * DV;
  const long long o_stride = static_cast<long long>(heads) * DV;
  const float* qb = q + batch_off * q_stride + h * DQK;
  const float* kb = k + kv_off * k_stride + kvh * DQK;
  const float* vb = v + kv_off * v_stride + kvh * DV;
  float* ob = o + batch_off * o_stride + h * DV;

  float qr[kPerQ], acc[kPerV];
#pragma unroll
  for (int i = 0; i < kPerQ; ++i)
    qr[i] = row < seq ? qb[row * q_stride + part + 4 * i] : 0.f;
#pragma unroll
  for (int i = 0; i < kPerV; ++i) acc[i] = 0.f;
  float m = kNegInf, l = 0.f;

  const int n_tiles = key_tiles(qt, seq_k, offset, causal, kBK32);
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBK32;
    __syncthreads();
    if constexpr (DQK == DV) {
      for (int i = threadIdx.x; i < kBK32 * DQK; i += kThreads32) {
        const int r = i / DQK, c = i % DQK;
        const bool in = k0 + r < seq_k;
        ks[i] = in ? kb[(k0 + r) * k_stride + c] : 0.f;
        vs[i] = in ? vb[(k0 + r) * v_stride + c] : 0.f;
      }
    } else {
      for (int i = threadIdx.x; i < kBK32 * DQK; i += kThreads32) {
        const int r = i / DQK, c = i % DQK;
        ks[i] = k0 + r < seq_k ? kb[(k0 + r) * k_stride + c] : 0.f;
      }
      for (int i = threadIdx.x; i < kBK32 * DV; i += kThreads32) {
        const int r = i / DV, c = i % DV;
        vs[i] = k0 + r < seq_k ? vb[(k0 + r) * v_stride + c] : 0.f;
      }
    }
    __syncthreads();

    float s[kBK32];
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < kBK32; ++j) {
      float d = 0.f;
#pragma unroll
      for (int i = 0; i < kPerQ; ++i) d = fmaf(qr[i], ks[j * DQK + part + 4 * i], d);
      d += __shfl_xor_sync(kFull, d, 1);
      d += __shfl_xor_sync(kFull, d, 2);
      const int key = k0 + j;
      const bool masked = key >= seq_k || (causal && key > row + offset);
      s[j] = masked ? kNegInf : d * scale_log2;
      mx = fmaxf(mx, s[j]);
    }
    const float mn = fmaxf(m, mx);
    const float corr = exp2f(m - mn);
    m = mn;
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < kPerV; ++i) acc[i] *= corr;
#pragma unroll
    for (int j = 0; j < kBK32; ++j) {
      const float p = exp2f(s[j] - mn);
      sum += p;
#pragma unroll
      for (int i = 0; i < kPerV; ++i) acc[i] = fmaf(p, vs[j * DV + part + 4 * i], acc[i]);
    }
    l = l * corr + sum;
  }

  if (row < seq) {
    const float denom = fmaxf(l, 1e-30f);
#pragma unroll
    for (int i = 0; i < kPerV; ++i) ob[row * o_stride + part + 4 * i] = acc[i] / denom;
  }
  if (lse != nullptr && part == 0)        // rows past S too: finite
    lse[(static_cast<long long>(blockIdx.z) * heads + h) * lse_stride + row] =
        kLn2 * (m + log2f(l));
}


template <int DQK, int DV>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o,
                        float* lse, int lse_stride,
                        const long long* q_geom, const long long* k_geom,
                        const long long* v_geom, int causal, float scale_log2,
                        int ctas, int* sched, int smem_bytes,
                        cudaStream_t stream) {
  const long long seq = q_geom[2], seq_k = k_geom[2];
  if (smem_bytes != Layout<DQK, DV>::kBytes || q_geom[0] != DQK
      || k_geom[0] != DQK || v_geom[0] != DV || v_geom[2] != seq_k
      || (causal && (seq_k < seq || (seq_k - seq) % kTileK != 0)))
    return cudaErrorInvalidValue;
  CUtensorMap q_map, k_map, v_map;
  cudaError_t err = encode_map(&q_map, q, q_geom, kTileQ);
  if (err == cudaSuccess) err = encode_map(&k_map, k, k_geom, kTileK);
  if (err == cudaSuccess) err = encode_map(&v_map, v, v_geom, kTileK);
  const bool with_lse = lse != nullptr, long_keys = seq_k != seq;
  const auto kernel =
      with_lse ? (long_keys ? flash_bf16<DQK, DV, true, true>
                            : flash_bf16<DQK, DV, true, false>)
               : (long_keys ? flash_bf16<DQK, DV, false, true>
                            : flash_bf16<DQK, DV, false, false>);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_bytes);
  if (err != cudaSuccess) return err;
  kernel<<<ctas, kThreadsBf16, smem_bytes, stream>>>(
      q_map, k_map, v_map, static_cast<__nv_bfloat16*>(o), lse, lse_stride,
      sched, static_cast<int>(seq), static_cast<int>(seq_k),
      static_cast<int>(q_geom[3]),
      static_cast<int>(q_geom[1]), static_cast<int>(k_geom[1]), causal,
      scale_log2);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// bf16 o = attention(q, k, v) with the wrapper's launch plan: `q_geom`,
// `k_geom` and `v_geom` are (head dim, heads, S, batch) and the byte strides
// of dims 1-3 (o is laid out as q, with v's head dim); `ctas` persistent
// CTAs take the work tiles from `sched`, two ints that are 0 before the
// launch and 0 again after it (the last CTA resets them); `smem_bytes` is
// the dynamic shared memory, which must be the kernel's layout for
// (`head_dim`, `v_dim`): (64, 64), (128, 128) or (192, 128). k and v may
// have more rows than q (k_geom's S): query row i then sits at position
// S_k - S_q + i, which must be a multiple of 128 when causal. A non-null
// `lse` (batch, heads, lse_stride) float32, lse_stride S rounded up to 128,
// receives each row's logsumexp in natural units.
int flash_attention_bf16_launch(const void* q, const void* k, const void* v,
                                void* o, float* lse, int lse_stride,
                                const long long* q_geom,
                                const long long* k_geom,
                                const long long* v_geom, int head_dim,
                                int v_dim, int causal, float scale_log2,
                                int ctas, int* sched, int smem_bytes,
                                cudaStream_t stream) {
  cudaError_t err = cudaErrorInvalidValue;
  if (head_dim == 64 && v_dim == 64)
    err = launch_bf16<64, 64>(q, k, v, o, lse, lse_stride, q_geom, k_geom,
        v_geom, causal, scale_log2, ctas, sched, smem_bytes, stream);
  else if (head_dim == 128 && v_dim == 128)
    err = launch_bf16<128, 128>(q, k, v, o, lse, lse_stride, q_geom, k_geom,
        v_geom, causal, scale_log2, ctas, sched, smem_bytes, stream);
  else if (head_dim == 192 && v_dim == 128)
    err = launch_bf16<192, 128>(q, k, v, o, lse, lse_stride, q_geom, k_geom,
        v_geom, causal, scale_log2, ctas, sched, smem_bytes, stream);
  return static_cast<int>(err);
}

// float32 o = attention(q, k, v): q (batch, seq, heads, head_dim), k
// (batch, seq_k, kv_heads, head_dim), v (batch, seq_k, kv_heads, v_dim), o
// (batch, seq, heads, v_dim), contiguous; query row i sits at position
// seq_k - seq + i (seq_k >= seq when causal); (head_dim, v_dim) is (64,
// 64), (128, 128) or (192, 128); `lse` as for the bf16 launch (null:
// none).
int flash_attention_f32_launch(const void* q, const void* k, const void* v,
                               void* o, float* lse, int lse_stride,
                               int batch, int seq, int seq_k, int heads,
                               int kv_heads, int head_dim, int v_dim,
                               int causal, float scale_log2,
                               cudaStream_t stream) {
  decltype(&flash_f32<64, 64>) kernel = nullptr;
  if (head_dim == 64 && v_dim == 64) kernel = &flash_f32<64, 64>;
  else if (head_dim == 128 && v_dim == 128) kernel = &flash_f32<128, 128>;
  else if (head_dim == 192 && v_dim == 128) kernel = &flash_f32<192, 128>;
  if (kernel == nullptr || (causal && seq_k < seq))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((seq + kBQ - 1) / kBQ, heads, batch);
  kernel<<<grid, kThreads32, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, lse_stride,
      seq, seq_k, heads, kv_heads, causal, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
