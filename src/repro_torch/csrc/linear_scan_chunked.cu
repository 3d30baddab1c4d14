// linear_scan_chunked: Mamba2's diagonal-decay scan as SSD's chunked form
// on Hopper's tensor cores (sm_90a), with no ratio of decays.
//
// Replaces the TPU kernel src/repro/kernels/linear_scan/linear_scan.py
// (`linear_scan`, body `_scan_kernel`) for Mamba2's inputs: a scalar decay
// per (batch, head, step), read after the update, from a zero state.
//
//   S_t = a_t S_{t-1} + k_tᵀ v_t,   o_t = q_t S_t          (S is dk x dv)
//
// on a clipped to [1e-6, 1], returning o and the final state in float32.
// `csrc/linear_scan.cu` runs the same function step by step and stays the
// kernel of every other input (RWKV6's bonus u, a decay per state row).
//
// The chunked form. Over a chunk of c = 64 steps, with C = q, B = k and
// X = v (rows are steps):
//
//   G = C Bᵀ                       (c x c, over the state rows)
//   L[i, j] = a_{j+1} ··· a_i       (i >= j; 0 above the diagonal)
//   o = (G ∘ L) X + diag(din) C S_prev,      din_i = a_start ··· a_i
//   S = A S_prev + Bᵀ diag(dout) X,          dout_j = a_{j+1} ··· a_end
//
// where A = din_end. Every factor is a product of decays in [1e-6, 1],
// formed by multiplying, never as exp(cs_i - cs_j) of a cumulative log nor
// as a ratio: nothing can overflow, there is no floor on the log decay,
// and underflow to 0 is the exact limit. (A float32 cumulative log loses
// ulp(|cs_i|) of relative accuracy near 1, a few 1e-6 at Zamba2's law.)
//
// Bound on this card: bytes. The chunked form does, per chunk and head,
// about 2.9 MFLOP of TF32 products (with the split below) against 32 KB of
// v and o in float32: at Zamba2's prefill shape (B=4, H=64, S=4096,
// dk=dv=64) 0.10 ms of tensor-core time at 495 TFLOP/s against 0.16 ms of
// bytes at 3.35 TB/s. The step form's 5 float32 operations per state
// element a step would take 0.32 ms at 67 TFLOP/s on the CUDA cores.
//
// Precision. TF32 keeps 11 bits; the bar is 1e-6 of the largest output.
// So each float32 operand is split x = hi + lo into two TF32 values and a
// product takes hi·hi + hi·lo + lo·hi (the lo·lo term is below 2^-22 of
// it). q and k in bf16 are exact in TF32 and are not split: C S and
// Bᵀ(dout X) take two products, (G ∘ L) X three. G = C Bᵀ of bf16 q and k
// runs as bf16 MMA with float32 accumulation, where every product is
// exact. The tensor cores truncate each sum toward zero to about 24 bits
// of its largest term, a bias that adds up along an MMA chain. So the two
// products that carry the state, C S_prev and Bᵀ(dout X), sum each
// k-step's products on the tensor cores from zero and add them in IEEE
// float32 (`mma_sum`), and across chunks every sum rounds to nearest:
// o = o1 + din ∘ o2 and S = A S_prev + (the chunk's share). At decays of
// 1 over a long sequence (chip_smoke.py phase 9 has S = 4096) o and the
// state grow with the sequence and those chains decide their error: an
// MMA chain into the state itself fails the bar there, and chaining each
// chunk's k-steps leaves half the margin. (G ∘ L) X chains its k-steps on
// the bf16 path (at most 24 products over one chunk's steps). Float32 q
// and k (a float32 model, off the main path) take three products
// everywhere and round each k-step's sum there too, which keeps their G,
// computed in split TF32, as close as the bf16 path's.
//
// Design:
// * One block of 8 warps per (batch, head), walking its chunks in order.
//   Instructions are mma.sync (m16n8k8 TF32, m16n8k16 bf16): their
//   fragments are loaded by the threads, so X, read k-major where it is
//   laid out m-major, and Bᵀ cost no transpose. wgmma would take TF32 only
//   K-major from shared memory and would need both transposed.
// * Each chunk: (1) G's 20 lower-triangular 16 x 8 tiles and o2 = C S_prev
//   (skipped at the first chunk, where S_prev = 0); (2) L by products, in
//   place on G: the block is cut into four segments of 16 rows; a thread
//   holds one column's segment, multiplies its running product down the
//   segment, and takes the product of the earlier segments from three
//   short independent chains, so no chain is longer than 16 multiplies;
//   the same pass gives din and dout; (3) o = (G ∘ L) X + din ∘ o2, stored
//   from the accumulators, then the state's share Bᵀ (dout ∘ X) and the
//   update, which each thread applies to its own places of the state in
//   shared memory (the B operand of the next chunk's C S_prev). A warp
//   takes two row tiles (r, 3 - r) of 16 rows and 16 columns, which
//   balances the causal half of (G ∘ L) X across warps.
// * The k-step loops of C S_prev and Bᵀ(dout X) unroll by two, not fully,
//   which keeps the bf16 kernel within its 128 registers (two blocks an
//   SM) with no spill of their IEEE sums.
// * TF32 rounding is two integer operations (`tf32`): ptxas expands
//   cvt.rna.tf32.f32 into five, and the splits are a large share of the
//   instructions.
// * The next chunk's q, k and v rows are in flight by cp.async into the
//   other buffer while a chunk computes; its decays wait in a register.
// * Shared-memory rows are padded so that every fragment load is free of
//   bank conflicts (rows of 68 floats where the fragment walks rows and
//   columns as (lane / 4, lane % 4), 72 where it walks them as
//   (lane % 4, lane / 4)). About 108 KB a block: two blocks an SM.
// * A ragged last chunk reads zeros past S (cp.async zero fill) and decays
//   of 1, which leave the state unchanged; any S >= 1 runs.
// * No atomics and a fixed order of every sum: the output is the same at
//   every launch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kC = 64;                 // steps a chunk
constexpr int kD = 64;                 // state rows (dk) and columns (dv) held
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kTiles = 20;             // lower-triangular 16 x 8 tiles of G
constexpr float kWMin = 1e-6f;

constexpr int kRowK = 72;              // floats a row of X and S: k-major reads
constexpr int kRowM = 68;              // floats a row of G: m-major reads
template <typename T>
constexpr int kRowQK = sizeof(T) == 2 ? 72 : 68;   // a row of C and B

struct Strides4 {
  long long b, h, s, d;
};

struct Args {
  const void* q;           // q and k: TQK
  const void* k;
  const float* v;
  const float* w;
  float* o;
  float* state;            // (batch, heads, dk, dv), contiguous
  Strides4 sq, sk, sv, sw, so;
  int heads, seq, dk, dv;
};

// Element offsets of one (batch, head)'s q, k, v, w and o.
struct Bases {
  long long q, k, v, w, o;
};

__device__ __forceinline__ Bases bases(const Args& a, int b, int h) {
  return {b * a.sq.b + h * a.sq.h, b * a.sk.b + h * a.sk.h,
          b * a.sv.b + h * a.sv.h, b * a.sw.b + h * a.sw.h,
          b * a.so.b + h * a.so.h};
}

template <typename TQK>
struct Smem {
  float x[2][kC][kRowK];               // v's chunk (X), two buffers
  TQK c[2][kC][kRowQK<TQK>];           // q's chunk (C)
  TQK b[2][kC][kRowQK<TQK>];           // k's chunk (B)
  float s[kD][kRowK];                  // the state at the chunk's start
  float g[kC][kRowM];                  // G, then G ∘ L
  float a[2][kC];                      // the chunk's decays, clipped
  float din[kC], dout[kC];
};

// -- tensor-core primitives ---------------------------------------------------

// x rounded to TF32 (10 bits of mantissa), to nearest with ties away from
// zero, as cvt.rna.tf32.f32 rounds, in two integer operations (ptxas
// expands the cvt into five, with a test for inf and nan that finite
// inputs do not need).
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

struct Parts {
  uint32_t hi, lo;
};

// x = hi + lo in TF32, to 22 bits.
__device__ __forceinline__ Parts split(float x) {
  const uint32_t hi = tf32(x);
  return {hi, tf32(x - __uint_as_float(hi))};
}

// An element of C or B as TF32: a bf16 value is exact (lo is 0 and never
// used), a float32 one is split.
template <typename TQK>
__device__ __forceinline__ Parts operand(const TQK* p) {
  if constexpr (sizeof(TQK) == 2)
    return {static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(p))
                << 16, 0u};
  else
    return split(*p);
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a·b from split operands: lo·hi where a is split, hi·lo where b is,
// then hi·hi (the small terms first).
template <bool kSplitA, bool kSplitB>
__device__ __forceinline__ void mma_split(float (&d)[4], const Parts (&a)[4],
                                          const Parts (&b)[2]) {
  const uint32_t ahi[4] = {a[0].hi, a[1].hi, a[2].hi, a[3].hi};
  const uint32_t bhi[2] = {b[0].hi, b[1].hi};
  if constexpr (kSplitA) {
    const uint32_t alo[4] = {a[0].lo, a[1].lo, a[2].lo, a[3].lo};
    mma_tf32(d, alo, bhi);
  }
  if constexpr (kSplitB) {
    const uint32_t blo[2] = {b[0].lo, b[1].lo};
    mma_tf32(d, ahi, blo);
  }
  mma_tf32(d, ahi, bhi);
}

// acc += a·b. With kFresh the products are summed on the tensor cores from
// zero and added to acc in IEEE float32, so the tensor cores' truncation
// stays inside one k-step; without, they chain into acc (fewer
// instructions and registers: the bf16 path's choice for (G ∘ L) X).
template <bool kFresh, bool kSplitA, bool kSplitB>
__device__ __forceinline__ void mma_sum(float (&acc)[4], const Parts (&a)[4],
                                        const Parts (&b)[2]) {
  if constexpr (kFresh) {
    float t[4] = {0.f, 0.f, 0.f, 0.f};
    mma_split<kSplitA, kSplitB>(t, a, b);
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[e] += t[e];
  } else {
    mma_split<kSplitA, kSplitB>(acc, a, b);
  }
}

__device__ __forceinline__ uint32_t word(const void* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// -- loads --------------------------------------------------------------------

// 16 bytes from global to shared memory, or 16 zero bytes if !in.
__device__ __forceinline__ void cp16(void* dst, const void* src, bool in) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(s),
               "l"(src), "r"(in ? 16 : 0));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;");
}

__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// The chunk from step t0: rows of q, k and v into buffer `buf` (zeros past
// S, dk and dv).
template <typename TQK>
__device__ __forceinline__ void load_chunk(const Args& a, Smem<TQK>& sm,
                                           int buf, const Bases& at, int t0) {
  // Copy i of thread tid is 16-byte piece tid + i · kThreads of the chunk
  // (a fixed count a thread, so the loops unroll).
  constexpr int kPerX = kD / 4;                     // pieces a row of v
  constexpr int kPer = 16 / sizeof(TQK);            // elements a piece
  constexpr int kPerQK = kD / kPer;                 // pieces a row of q, k
  const int tid = threadIdx.x;
  const float* v = a.v;
#pragma unroll
  for (int i = 0; i < kC * kPerX / kThreads; ++i) {
    const int idx = tid + i * kThreads;
    const int r = idx / kPerX, col = 4 * (idx % kPerX), t = t0 + r;
    const bool in = t < a.seq && col < a.dv;
    cp16(&sm.x[buf][r][col], in ? v + at.v + t * a.sv.s + col : v, in);
  }
  const TQK* q = static_cast<const TQK*>(a.q);
  const TQK* k = static_cast<const TQK*>(a.k);
#pragma unroll
  for (int i = 0; i < kC * kPerQK / kThreads; ++i) {
    const int idx = tid + i * kThreads;
    const int r = idx / kPerQK, col = kPer * (idx % kPerQK), t = t0 + r;
    const bool in = t < a.seq && col < a.dk;
    cp16(&sm.c[buf][r][col], in ? q + at.q + t * a.sq.s + col : q, in);
    cp16(&sm.b[buf][r][col], in ? k + at.k + t * a.sk.s + col : k, in);
  }
}

// The decay of step t0 + tid (threads below kC), 1 past S.
__device__ __forceinline__ float load_w(const Args& a, long long wb, int t0) {
  const int t = t0 + static_cast<int>(threadIdx.x);
  return threadIdx.x < kC && t < a.seq ? __ldg(a.w + wb + t * a.sw.s) : 1.f;
}

// -- the three steps of a chunk -----------------------------------------------

// (1a) G's lower-triangular tiles (16 rows mt, 8 columns jt, jt <= 2mt + 1)
// into sm.g; tiles are dealt to the warps in turn.
template <typename TQK>
__device__ __forceinline__ void g_tiles(Smem<TQK>& sm, int buf, int warp,
                                        int g, int tig) {
  for (int tile = warp; tile < kTiles; tile += kWarps) {
    const int mt = tile < 2 ? 0 : tile < 6 ? 1 : tile < 12 ? 2 : 3;
    const int jt = tile - mt * (mt + 1);
    const int i0 = 16 * mt + g, j0 = 8 * jt + g;
    float d[4] = {0.f, 0.f, 0.f, 0.f};
    if constexpr (sizeof(TQK) == 2) {
#pragma unroll
      for (int ks = 0; ks < kD / 16; ++ks) {
        const int n = 16 * ks + 2 * tig;
        const uint32_t af[4] = {
            word(&sm.c[buf][i0][n]), word(&sm.c[buf][i0 + 8][n]),
            word(&sm.c[buf][i0][n + 8]), word(&sm.c[buf][i0 + 8][n + 8])};
        const uint32_t bf[2] = {word(&sm.b[buf][j0][n]),
                                word(&sm.b[buf][j0][n + 8])};
        float t[4] = {0.f, 0.f, 0.f, 0.f};
        mma_bf16(t, af, bf);
#pragma unroll
        for (int e = 0; e < 4; ++e) d[e] += t[e];
      }
    } else {
#pragma unroll
      for (int ks = 0; ks < kD / 8; ++ks) {
        const int n = 8 * ks + tig;
        const Parts af[4] = {
            split(sm.c[buf][i0][n]), split(sm.c[buf][i0 + 8][n]),
            split(sm.c[buf][i0][n + 4]), split(sm.c[buf][i0 + 8][n + 4])};
        const Parts bf[2] = {split(sm.b[buf][j0][n]),
                             split(sm.b[buf][j0][n + 4])};
        mma_sum<true, true, true>(d, af, bf);
      }
    }
    const int col = 8 * jt + 2 * tig;
    *reinterpret_cast<float2*>(&sm.g[i0][col]) = make_float2(d[0], d[1]);
    *reinterpret_cast<float2*>(&sm.g[i0 + 8][col]) = make_float2(d[2], d[3]);
  }
}

// (1b) o2 = C S_prev over this warp's row tiles `mts` and columns
// 16 pq .. 16 pq + 15.
template <typename TQK>
__device__ __forceinline__ void c_state(const Smem<TQK>& sm, int buf,
                                        const int (&mts)[2], int pq, int g,
                                        int tig, float (&o2)[2][2][4]) {
  constexpr bool kSplitQK = sizeof(TQK) != 2;
#pragma unroll 2
  for (int kb = 0; kb < kD / 8; ++kb) {
    const int n = 8 * kb + tig;
    Parts sf[2][2];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const int p = 16 * pq + 8 * nt + g;
      sf[nt][0] = split(sm.s[n][p]);
      sf[nt][1] = split(sm.s[n + 4][p]);
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const int i0 = 16 * mts[mi] + g;
      const Parts cf[4] = {
          operand(&sm.c[buf][i0][n]), operand(&sm.c[buf][i0 + 8][n]),
          operand(&sm.c[buf][i0][n + 4]), operand(&sm.c[buf][i0 + 8][n + 4])};
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
        mma_sum<true, kSplitQK, true>(o2[mi][nt], cf, sf[nt]);
    }
  }
}

// (2) L by products, in place on G (G ∘ L, zero above the diagonal), and
// din, dout. Warp w holds segment s = w % 4 (rows 16 s .. 16 s + 15) of
// columns 32 (w / 4) + lane.
template <typename TQK>
__device__ __forceinline__ void decay_products(Smem<TQK>& sm, int buf,
                                               int warp, int lane) {
  const int s = warp & 3, j = 32 * (warp >> 2) + lane;
  const float* av = sm.a[buf];
  // the product over the earlier segments' rows below j: three
  // independent chains (rows of segments >= s keep their factor 1)
  float part[3] = {1.f, 1.f, 1.f};
#pragma unroll
  for (int ii = 0; ii < 16; ++ii)
#pragma unroll
    for (int sp = 0; sp < 3; ++sp) {
      const int i = 16 * sp + ii;
      if (sp < s && i > j) part[sp] *= av[i];
    }
  const float pre = part[0] * part[1] * part[2];
  float run[16];
  float r = 1.f;
#pragma unroll
  for (int ii = 0; ii < 16; ++ii) {
    const int i = 16 * s + ii;
    if (i > j) r *= av[i];
    run[ii] = r;
  }
  if (s == 3) sm.dout[j] = pre * r;           // a_{j+1} ··· a_63
  const float a0 = av[0];
#pragma unroll
  for (int ii = 0; ii < 16; ++ii) {
    const int i = 16 * s + ii;
    const float l = pre * run[ii];            // L[i, j] for i >= j
    float& gij = sm.g[i][j];
    gij = i < j ? 0.f : gij * l;
    if (j == 0) sm.din[i] = a0 * l;           // a_0 ··· a_i
  }
}

template <typename TQK>
__global__ void __launch_bounds__(kThreads, sizeof(TQK) == 2 ? 2 : 1)
    chunked_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  Smem<TQK>& sm = *reinterpret_cast<Smem<TQK>*>(smem);
  constexpr bool kSplitQK = sizeof(TQK) != 2;
  const int bh = blockIdx.x;
  const Bases at = bases(a, bh / a.heads, bh % a.heads);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;
  // this warp's row tiles (of o and of the state) and 16 columns
  const int mts[2] = {warp >> 2, 3 - (warp >> 2)};
  const int pq = warp & 3;

  load_chunk(a, sm, 0, at, 0);
  cp_commit();
  float w_next = load_w(a, at.w, 0);
  const int chunks = (a.seq + kC - 1) / kC;
  for (int ck = 0; ck < chunks; ++ck) {
    const int buf = ck & 1, t0 = ck * kC;
    if (tid < kC) sm.a[buf][tid] = fminf(fmaxf(w_next, kWMin), 1.f);
    cp_wait_all();
    // The chunk's data is in; every read of the other buffer (the previous
    // chunk's) and of sm.g is done.
    __syncthreads();
    if (ck + 1 < chunks) {
      load_chunk(a, sm, buf ^ 1, at, t0 + kC);
      cp_commit();
      w_next = load_w(a, at.w, t0 + kC);
    }

    g_tiles(sm, buf, warp, g, tig);
    float o2[2][2][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) o2[mi][nt][e] = 0.f;
    if (ck > 0) c_state(sm, buf, mts, pq, g, tig, o2);   // S_prev = 0 at 0
    __syncthreads();                 // G is whole; S_prev's reads are done
    decay_products(sm, buf, warp, lane);
    __syncthreads();                 // G ∘ L, din and dout are whole

    // (3a) o = (G ∘ L) X + din ∘ o2
    float o1[2][2][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) o1[mi][nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kC / 8; ++kk) {
      const int j = 8 * kk + tig;
      Parts xf[2][2];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int p = 16 * pq + 8 * nt + g;
        xf[nt][0] = split(sm.x[buf][j][p]);
        xf[nt][1] = split(sm.x[buf][j + 4][p]);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int r0 = 16 * mts[mi] + g;
        if (kk <= 2 * mts[mi] + 1) {          // tiles on or below the diagonal
          const Parts gf[4] = {split(sm.g[r0][j]), split(sm.g[r0 + 8][j]),
                               split(sm.g[r0][j + 4]),
                               split(sm.g[r0 + 8][j + 4])};
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
            mma_sum<kSplitQK, true, true>(o1[mi][nt], gf, xf[nt]);
        }
      }
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int i = 16 * mts[mi] + g + 8 * half, t = t0 + i;
        const float dn = sm.din[i];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const int p = 16 * pq + 8 * nt + 2 * tig;
          if (t < a.seq && p < a.dv)
            *reinterpret_cast<float2*>(a.o + at.o + t * a.so.s + p) =
                make_float2(fmaf(dn, o2[mi][nt][2 * half],
                                 o1[mi][nt][2 * half]),
                            fmaf(dn, o2[mi][nt][2 * half + 1],
                                 o1[mi][nt][2 * half + 1]));
        }
      }

    // (3b) S = A S_prev + Bᵀ (dout ∘ X): the chunk's share from zero on the
    // tensor cores, then one rounding into the state, which each thread
    // keeps at its own places of sm.s (read by every warp only in step 1,
    // before the second barrier).
    float ds[2][2][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) ds[mi][nt][e] = 0.f;
#pragma unroll 2
    for (int kk = 0; kk < kC / 8; ++kk) {
      const int j = 8 * kk + tig;
      const float d0 = sm.dout[j], d1 = sm.dout[j + 4];
      Parts df[2][2];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int p = 16 * pq + 8 * nt + g;
        df[nt][0] = split(d0 * sm.x[buf][j][p]);
        df[nt][1] = split(d1 * sm.x[buf][j + 4][p]);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        // Bᵀ: row n = r0 of the state, column j of the chunk
        const int r0 = 16 * mts[mi] + g;
        const Parts bf[4] = {
            operand(&sm.b[buf][j][r0]), operand(&sm.b[buf][j][r0 + 8]),
            operand(&sm.b[buf][j + 4][r0]), operand(&sm.b[buf][j + 4][r0 + 8])};
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
          mma_sum<true, kSplitQK, true>(ds[mi][nt], bf, df[nt]);
      }
    }
    const float decay = sm.din[kC - 1];
    float* out = a.state + static_cast<long long>(bh) * a.dk * a.dv;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int n = 16 * mts[mi] + g + 8 * half;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const int p = 16 * pq + 8 * nt + 2 * tig;
          float2& s2 = *reinterpret_cast<float2*>(&sm.s[n][p]);
          const float2 prev = ck > 0 ? s2 : make_float2(0.f, 0.f);
          s2 = make_float2(fmaf(decay, prev.x, ds[mi][nt][2 * half]),
                           fmaf(decay, prev.y, ds[mi][nt][2 * half + 1]));
          if (ck == chunks - 1 && n < a.dk && p < a.dv)
            *reinterpret_cast<float2*>(out + n * a.dv + p) = s2;
        }
      }
  }
}

template <typename TQK>
int launch(const Args& a, int blocks, cudaStream_t stream) {
  const int smem = sizeof(Smem<TQK>);
  const cudaError_t set = cudaFuncSetAttribute(
      chunked_kernel<TQK>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (set != cudaSuccess) return static_cast<int>(set);
  chunked_kernel<TQK><<<blocks, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// o, state = linear_scan(q, k, v, w) in Mamba2 mode: q, k (batch, heads,
// seq, dk), v and o (batch, heads, seq, dv), w (batch, heads, seq, dk) read
// at dim 0 only (a scalar decay per step), at the element strides in
// `strides` (q, k, v, w, o; each batch, head, step, dim: 20 values); state
// (batch, heads, dk, dv) float32 contiguous. q and k are bf16 if `qk_bf16`,
// else float32; v, o and w float32. dk and dv are at most 64, dv a multiple
// of 4 and dk one of 16 bytes; q, k, v and o have dim stride 1 and rows on
// 16-byte boundaries. The wrapper checks all of it (`ops.route`).
int linear_scan_chunked_launch(const void* q, const void* k, const float* v,
                               const float* w, float* o, float* state,
                               int batch, int heads, int seq, int dk, int dv,
                               int qk_bf16, const long long* strides,
                               cudaStream_t stream) {
  const int per = qk_bf16 ? 8 : 4;
  if (dk < 1 || dk > kD || dv < 1 || dv > kD || dv % 4 || dk % per ||
      seq < 1 || batch < 1 || heads < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.q = q; a.k = k; a.v = v; a.w = w; a.o = o; a.state = state;
  Strides4* dst[5] = {&a.sq, &a.sk, &a.sv, &a.sw, &a.so};
  for (int i = 0; i < 5; ++i)
    *dst[i] = Strides4{strides[4 * i], strides[4 * i + 1],
                       strides[4 * i + 2], strides[4 * i + 3]};
  if (a.sq.d != 1 || a.sk.d != 1 || a.sv.d != 1 || a.so.d != 1)
    return static_cast<int>(cudaErrorInvalidValue);
  a.heads = heads; a.seq = seq; a.dk = dk; a.dv = dv;
  const long long blocks = static_cast<long long>(batch) * heads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  return qk_bf16 ? launch<__nv_bfloat16>(a, static_cast<int>(blocks), stream)
                 : launch<float>(a, static_cast<int>(blocks), stream);
}

const char* linear_scan_chunked_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
