// linear_scan: the diagonal-decay linear recurrence with a decay per
// channel (RWKV6, and every input the chunked kernel does not take) as a
// chunked scan on Hopper's tensor cores (sm_90a), with no ratio of decays.
//
// Replaces the TPU kernel src/repro/kernels/linear_scan/linear_scan.py
// (`linear_scan`, body `_scan_kernel`). Same function, from a zero state:
//
//   S_t = diag(w_t) S_{t-1} + k_tᵀ v_t          (S is dk x dv, float32)
//   o_t = q_t S_t                                (no bonus: Mamba2's read)
//   o_t = q_t S_{t-1} + (q_t · u · k_t) v_t      (RWKV6: bonus u)
//
// on w clipped to [1e-6, 1], returning o in v's dtype (bf16 or float32, as
// the Pallas kernel's o_ref) and the final state in float32.
// `csrc/linear_scan_chunked.cu` runs Mamba2's inputs (a scalar decay per
// step); this kernel takes any 1 <= dk, dv <= 64, any S >= 1, bf16 or
// float32 q, k and v, and any strides, stride-0 views included.
//
// The chunked form with a decay per channel. Over a chunk of c = 16 steps
// (i, j = 0..15), with S the state at the chunk's start:
//
//   pre_i = w_0 ··· w_{i-1}    (w_0 ··· w_i for the read after the update)
//   suf_j = w_{j+1} ··· w_15,   A = w_0 ··· w_15           (per channel)
//   M[i, j] = Σ_d q_id k_jd w_{j+1,d} ··· w_{i-1,d}  (j < i; to w_i after)
//   M[i, i] = q_i · (u ⊙ k_i)                      (q_i · k_i after)
//   o = (q ⊙ pre) S + M v,        S <- diag(A) S + (k ⊙ suf)ᵀ v
//
// Every decay factor is a product of decays in [1e-6, 1], formed by
// multiplying, never a ratio nor exp of a cumulative log: RWKV6's decays,
// exp(-exp(clip(w0 + dw, -20, 8))), underflow to 0 and clip to 1e-6, where
// a ratio of products overflows. The Pallas kernel factors the ratios as
// q·L and k/L and floors each step's log decay at -2.5; this kernel has no
// floor, and underflow to 0 is the exact limit.
//
// Why c = 16 and no larger chunk. (q ⊙ pre) S and (k ⊙ suf)ᵀ v cost
// 2·dk·dv operations a step whatever c is; only M's share grows with c.
// Within a chunk M[i, j] needs the products w_{j+1} ··· w_{i-1} of each
// pair, which factor into one matrix product only across sub-blocks
// (pre · A-between · suf); inside a sub-block they are running products on
// the CUDA cores. At c = 16 M is that one sub-block: 120 pairs, run on the
// CUDA cores while the tensor cores carry the two state products. A chunk
// of 64 would add six cross-sub-block products and their factors for less
// state traffic; at dk = dv = 64 it does more tensor-core work a step.
//
// Bound on this card: bytes. At rwkv6-7b's prefill shape (B=4, H=64,
// S=4096, dk=dv=64) with bf16 r, k, v and o and float32 w: 805 MB, 0.240
// ms at 3.35 TB/s, against 47.2 GFLOP of split-TF32 products (0.095 ms at
// 495 TFLOP/s) and 1.5 GFLOP of float32 products and sums on the CUDA
// cores (0.022 ms at 67 TFLOP/s). The step-by-step form it replaces did 5
// float32 operations per state element a step: 0.32 ms of CUDA-core time
// alone, with v and o in float32 besides.
//
// Precision. TF32 keeps 11 bits; the bar is 1e-6 of the largest output.
// So each float32 operand (q ⊙ pre, k ⊙ suf, M, S, a float32 v) is split
// x = hi + lo: hi rounded to TF32, lo = x - hi, which the tensor cores
// read truncated to TF32 (below 2^-22 |x| in all), and a product takes
// lo·hi + hi·lo + hi·hi (lo·lo is below 2^-22 of it). A bf16 v is exact in
// TF32 and is not split. The tensor cores truncate each sum toward zero to
// about 24 bits of its largest term, a bias that adds up along a chain of
// products, so each k-step's products are summed on the tensor cores from
// zero and added in IEEE float32, and the state takes S = fma(A, S, the
// chunk's share). A running product of at most 16 decays rounds 15 times;
// the state rounds once a chunk.
//
// Design:
// * One block of two warpgroups per (batch, head); 2 blocks an SM, so the
//   256 (batch, head) pairs of the prefill run in one wave on 132 SMs.
// * Warpgroup 0 (the consumers, 168 registers a thread by setmaxnreg)
//   holds the state in registers, transposed: warp w holds columns
//   16w .. 16w + 15, all 64 rows, as the accumulator fragments of
//   wgmma m64nNk8 TF32 (Sᵀ). Each chunk it computes oᵀ = Sᵀ (q ⊙ pre)ᵀ +
//   vᵀ Mᵀ and Sᵀ <- Sᵀ diag(A) + vᵀ (k ⊙ suf) with A (Sᵀ or vᵀ) from
//   registers and B from shared memory. The k index of every product is
//   permuted (`kpos`: within each 8, the even rows, then the odd ones),
//   which makes a thread's accumulator fragment of Sᵀ its A fragment of
//   the next chunk's product, with no shuffle. Two k-steps of Sᵀ (q ⊙
//   pre)ᵀ are in flight at once (four spill registers and run slower).
//   wgmma, not mma.sync: with the same products on mma.sync m16n8k8 the
//   consumers were bound by its TF32 rate and the kernel ran slower.
// * Warpgroup 1 (the producers, 88 registers) loads the chunks and runs
//   one chunk ahead: from the chunk's q, k and w alone it forms q ⊙ pre,
//   k ⊙ suf (one channel a thread, running products), A and M (a pair of
//   rows 15 - p and p for each 16-lane half-warp, 4 channels a lane,
//   running products of the 4 channels, a reduce-scatter over the lanes),
//   and writes each split into hi and lo tiles: K-major, 128-byte rows,
//   the 128-byte swizzle the wgmma descriptors name, then
//   fence.proxy.async. One __syncthreads a chunk hands the operands over.
// * The producers load the chunks 3 ahead into a ring of 4 by cp.async
//   (16-byte copies) where every row is 16-byte aligned; otherwise
//   element by element through the strides (any strides, stride 0
//   included).
// * A ragged last chunk reads zeros past S and decays of 1, which leave
//   the state unchanged; zeros past dk and dv leave it too.
// * o is staged per consumer warp in shared memory and written in 16-byte
//   pieces, 32 contiguous bytes a row.
// * No atomics and a fixed order of every sum: the output is the same at
//   every launch.
//
// What holds it back: it takes 0.61 ms at rwkv6-7b's prefill shape on an
// H100 at 700 W (chip_smoke.py phase 16), 0.39 of the bytes bound. With
// either warpgroup's work switched off, the other's time and its own add
// up to the whole; of the producers' share M is the largest.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kC = 16;                 // steps a chunk
constexpr int kD = 64;                 // state rows (dk) and columns (dv) held
constexpr int kThreads = 256;          // 4 consumer warps, then 4 producers
constexpr int kProducers = 128;
constexpr int kConsumerRegs = 168;     // registers a consumer thread
constexpr int kProducerRegs = 88;      // and a producer: 2 blocks an SM
constexpr int kRing = 4;               // chunks of input in shared memory
constexpr int kAhead = 3;              // chunks loaded ahead of the consumers
constexpr unsigned kFull = 0xffffffffu;
constexpr float kWMin = 1e-6f;

// The wgmma B operands are K-major tiles of 128-byte rows (32 TF32 values)
// in 8-row groups of 1024 bytes, with the 128-byte swizzle (the 16-byte
// piece x of row r at piece x ^ (r % 8)).
constexpr int kRowTf = 32;             // TF32 values a tile row
// Elements a row of v: the consumers' 2-byte (or 4-byte) A-fragment loads
// of rows 2t, t = 0..3, fall 32 bytes apart modulo 128.
template <typename TV>
constexpr int kRowV = sizeof(TV) == 2 ? 72 : 68;

struct Strides4 {
  long long b, h, s, d;
};

struct Args {
  const void* q;           // q and k: TQK
  const void* k;
  const void* v;           // v and o: TV
  const float* w;
  const float* u;          // (heads, dk), or null
  void* o;
  float* state;            // (batch, heads, dk, dv), contiguous
  Strides4 sq, sk, sv, sw, so;
  int heads, seq, dk, dv;
  int vec;                 // every row is read and written by 16-byte copies
};

// Element offsets of one (batch, head)'s q, k, v, w and o.
struct Bases {
  long long q, k, v, w, o;
};

template <typename TQK, typename TV>
struct Smem {                          // at a 1024-byte boundary
  struct Ops {                         // one chunk's operands: [hi, lo]
    float qd[2][kD / kRowTf][kC][kRowTf];   // q ⊙ pre: rows i, k = d
    float kd[2][kD][kRowTf];           // (k ⊙ suf)ᵀ: rows d, k = j < 16
    float m[2][kC][kRowTf];            // M: rows i, k = j < 16 (0 above
                                       // the diagonal)
    float blk[kD];                     // A
    float pad[256 - kD];               // to a multiple of 1024 bytes
  } ops[2];
  struct Raw {                         // one chunk as loaded
    TQK q[kC][kD];
    TQK k[kC][kD];
    float w[kC][kD];                   // clipped in place by the producers
    TV v[kC][kRowV<TV>];
  } raw[kRing];
  TV ost[4][kC][16];                   // each consumer warp's o
};

// -- numbers ------------------------------------------------------------------

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// x rounded to TF32 (10 bits of mantissa), to nearest with ties away from
// zero, as cvt.rna.tf32.f32 rounds, in two integer operations.
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

struct Parts {
  uint32_t hi, lo;
};

// x = hi + lo in TF32, to 22 bits: hi rounded to nearest, lo = x - hi
// exact in float32, which the tensor cores read truncated to TF32 (an
// error below 2^-22 |x|, its sign lo's).
__device__ __forceinline__ Parts split(float x) {
  const uint32_t hi = tf32(x);
  return {hi, __float_as_uint(x - __uint_as_float(hi))};
}

// An element of v as TF32: a bf16 value is exact (lo is 0 and never used),
// a float32 one is split.
__device__ __forceinline__ Parts v_operand(float x) { return split(x); }
__device__ __forceinline__ Parts v_operand(__nv_bfloat16 x) {
  return {static_cast<uint32_t>(__bfloat16_as_ushort(x)) << 16, 0u};
}

// The position of index x (a state row d or a step j) in the k order of
// the products: within each 8, the even ones, then the odd ones. Then the
// C fragment of Sᵀ (columns 2t, 2t + 1 of an n-tile) is a thread's A
// fragment (k columns t and t + 4) of the next product, with no shuffle.
__device__ __forceinline__ int kpos(int x) {
  return (x & ~7) | ((x & 1) << 2) | ((x & 7) >> 1);
}

// Float index of (row r, k position p < 32) in a tile of 128-byte rows
// with the 128-byte swizzle.
__device__ __forceinline__ int swz(int r, int p) {
  return r * kRowTf + ((((p >> 2) ^ (r & 7)) << 2) | (p & 3));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// wgmma shared-memory matrix descriptor of a K-major tile with the
// 128-byte swizzle: start address, leading byte offset (unused), stride
// byte offset between 8-row groups (1024), layout type 1 in bits 62-63.
__device__ __forceinline__ uint64_t tile_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(1) << 16 |
         static_cast<uint64_t>(1024 >> 4) << 32 | 1ull << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Wait until at most n (0..3, known when the caller is unrolled) groups
// are in flight.
__device__ __forceinline__ void wgmma_wait_upto(int n) {
  if (n <= 0) wgmma_wait<0>();
  else if (n == 1) wgmma_wait<1>();
  else if (n == 2) wgmma_wait<2>();
  else wgmma_wait<3>();
}

// Keep the compiler from moving reads or writes of a wgmma accumulator
// across this point (the wgmma runs asynchronously to the code around it).
template <int N>
__device__ __forceinline__ void fence_regs(float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(x[i])::"memory");
}

// d (64 x 16) = a·b (+ d if `acc`): a (64 x 8 TF32) in registers, this
// warp's 16 rows as the C fragment layout's, b (8 x 16) a K-major tile.
__device__ __forceinline__ void wgmma_n16(float (&d)[8],
                                          const uint32_t (&a)[4], uint64_t b,
                                          int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

// d (64 x 64) = a·b (+ d if `acc`), as `wgmma_n16`.
__device__ __forceinline__ void wgmma_n64(float (&d)[32],
                                          const uint32_t (&a)[4], uint64_t b,
                                          int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
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

template <int kPending>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(kPending) : "memory");
}

// kRows rows of n elements of T from `src` (row stride `rs`) into dst
// (row stride kRowDst) by 16-byte copies, zeros past `rows` and `n`.
template <typename T, int kRowDst>
__device__ __forceinline__ void copy_rows(T* dst, const T* src, long long rs,
                                         int rows, int n, int p) {
  constexpr int kPer = 16 / sizeof(T), kPieces = kD / kPer;
  static_assert(kC * kPieces % kProducers == 0, "pieces a producer");
#pragma unroll
  for (int it = 0; it < kC * kPieces / kProducers; ++it) {
    const int idx = p + it * kProducers;
    const int r = idx / kPieces, col = kPer * (idx % kPieces);
    const bool in = r < rows && col < n;
    cp16(dst + r * kRowDst + col, in ? src + r * rs + col : src, in);
  }
}

// The same element by element through the strides (s along the row, d
// along the columns): plain loads and shared stores.
template <typename T, int kRowDst>
__device__ __forceinline__ void gather_rows(T* dst, const T* src,
                                            long long rs, long long cs,
                                            int rows, int n, int p) {
#pragma unroll
  for (int idx = p; idx < kC * kD; idx += kProducers) {
    const int r = idx / kD, col = idx % kD;
    dst[r * kRowDst + col] =
        r < rows && col < n ? src[r * rs + col * cs] : from_float<T>(0.f);
  }
}

// Chunk `ck` (steps 16 ck ..) into its slot of the ring (producer threads
// p = tid - 128 only).
template <typename TQK, typename TV>
__device__ __forceinline__ void load_chunk(const Args& a, Smem<TQK, TV>& sm,
                                           const Bases& at, int ck) {
  auto& r = sm.raw[ck % kRing];
  const int p = threadIdx.x - (kThreads - kProducers);
  const long long t0 = static_cast<long long>(ck) * kC;
  const int rows = min(kC, a.seq - static_cast<int>(t0));
  const TQK* q = static_cast<const TQK*>(a.q) + at.q + t0 * a.sq.s;
  const TQK* k = static_cast<const TQK*>(a.k) + at.k + t0 * a.sk.s;
  const TV* v = static_cast<const TV*>(a.v) + at.v + t0 * a.sv.s;
  const float* w = a.w + at.w + t0 * a.sw.s;
  if (a.vec) {
    copy_rows<TQK, kD>(&r.q[0][0], q, a.sq.s, rows, a.dk, p);
    copy_rows<TQK, kD>(&r.k[0][0], k, a.sk.s, rows, a.dk, p);
    copy_rows<float, kD>(&r.w[0][0], w, a.sw.s, rows, a.dk, p);
    copy_rows<TV, kRowV<TV>>(&r.v[0][0], v, a.sv.s, rows, a.dv, p);
  } else {
    gather_rows<TQK, kD>(&r.q[0][0], q, a.sq.s, a.sq.d, rows, a.dk, p);
    gather_rows<TQK, kD>(&r.k[0][0], k, a.sk.s, a.sk.d, rows, a.dk, p);
    gather_rows<float, kD>(&r.w[0][0], w, a.sw.s, a.sw.d, rows, a.dk, p);
    gather_rows<TV, kRowV<TV>>(&r.v[0][0], v, a.sv.s, a.sv.d, rows, a.dv,
                               p);
  }
}

// -- producers ----------------------------------------------------------------

__device__ __forceinline__ void producer_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kProducers) : "memory");
}

__device__ __forceinline__ void load4(const float* p, float (&x)[4]) {
  const float4 f = *reinterpret_cast<const float4*>(p);
  x[0] = f.x; x[1] = f.y; x[2] = f.z; x[3] = f.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&x)[4]) {
  const uint2 b = *reinterpret_cast<const uint2*>(p);
  x[0] = __uint_as_float(b.x << 16);
  x[1] = __uint_as_float(b.x & 0xffff0000u);
  x[2] = __uint_as_float(b.y << 16);
  x[3] = __uint_as_float(b.y & 0xffff0000u);
}

// The dot product of 4 channels.
__device__ __forceinline__ float dot4(const float (&a)[4],
                                      const float (&b)[4]) {
  return fmaf(a[3], b[3], fmaf(a[2], b[2], fmaf(a[1], b[1], a[0] * b[0])));
}

// One round of a reduce-scatter over the lanes of a 16-lane half-warp:
// the lane keeps the half of the slots (low or high kHalf) that its lane
// bit kHalf / 2 picks, summed with its partner's.
template <int kHalf>
__device__ __forceinline__ void reduce_half(float (&acc)[32], int lane) {
  const bool up = lane & (kHalf / 2);
#pragma unroll
  for (int s = 0; s < kHalf; ++s) {
    const float lo = acc[s], hi = acc[s + kHalf];
    const float keep = up ? hi : lo, send = up ? lo : hi;
    acc[s] = keep + __shfl_xor_sync(kFull, send, kHalf / 2);
  }
}
// The operands of chunk ck from its loaded inputs (producer threads p =
// tid - 128 only).
template <typename TQK, typename TV, bool kBonus>
__device__ __forceinline__ void produce(const Args& a, Smem<TQK, TV>& sm,
                                        int ck, const float (&u4)[4]) {
  auto& r = sm.raw[ck % kRing];
  auto& op = sm.ops[ck & 1];
  const int p = threadIdx.x - (kThreads - kProducers);
  const int t0 = ck * kC;
  // (1) the decays clipped to [1e-6, 1] in place, 1 past S (every load
  // before any store: the compiler cannot tell that they do not alias)
  constexpr int kPer = kC * kD / 4 / kProducers;
  float4 w4[kPer];
#pragma unroll
  for (int it = 0; it < kPer; ++it) {
    const int x = p + it * kProducers;
    w4[it] = *reinterpret_cast<const float4*>(
        &r.w[x / (kD / 4)][4 * (x % (kD / 4))]);
  }
#pragma unroll
  for (int it = 0; it < kPer; ++it) {
    const int x = p + it * kProducers, i = x / (kD / 4);
    const float4 f = w4[it];
    *reinterpret_cast<float4*>(&r.w[i][4 * (x % (kD / 4))]) =
        t0 + i < a.seq ? make_float4(fminf(fmaxf(f.x, kWMin), 1.f),
                                     fminf(fmaxf(f.y, kWMin), 1.f),
                                     fminf(fmaxf(f.z, kWMin), 1.f),
                                     fminf(fmaxf(f.w, kWMin), 1.f))
                       : make_float4(1.f, 1.f, 1.f, 1.f);
  }
  producer_sync();
  // (2) q ⊙ pre and A (threads 0-63), (k ⊙ suf)ᵀ (64-127): one channel a
  // thread, by running products
  // (every load before any store, as in (1))
  const int d = p & (kD - 1);
  float wd[kC], x[kC];
#pragma unroll
  for (int i = 0; i < kC; ++i) {
    wd[i] = r.w[i][d];
    x[i] = to_float(p < kD ? r.q[i][d] : r.k[i][d]);
  }
  if (p < kD) {
    float pr = 1.f;
#pragma unroll
    for (int i = 0; i < kC; ++i) {
      if constexpr (!kBonus) pr *= wd[i];
      x[i] *= pr;
      if constexpr (kBonus) pr *= wd[i];
    }
    // row i, k position kpos(d), split into the hi and lo tiles
    const int pos = kpos(d), kb = pos / kRowTf, col = pos % kRowTf;
#pragma unroll
    for (int i = 0; i < kC; ++i) {
      const Parts xs = split(x[i]);
      (&op.qd[0][kb][0][0])[swz(i, col)] = __uint_as_float(xs.hi);
      (&op.qd[1][kb][0][0])[swz(i, col)] = __uint_as_float(xs.lo);
    }
    op.blk[d] = pr;
  } else {
    float pr = 1.f;
    float (&kd)[kC] = x;
#pragma unroll
    for (int j = kC - 1; j >= 0; --j) {
      kd[j] *= pr;
      pr *= wd[j];
    }
    // row d: k positions 0-3 hold steps 0, 2, 4, 6, then 1, 3, 5, 7,
    // 8, 10, 12, 14 and 9, 11, 13, 15 (kpos), 16-byte pieces swizzled
    Parts ks[kC];
#pragma unroll
    for (int j = 0; j < kC; ++j) ks[j] = split(kd[j]);
#pragma unroll
    for (int piece = 0; piece < kC / 4; ++piece) {
      const int j0 = 8 * (piece >> 1) + (piece & 1);
      const int at = swz(d, 4 * piece);
      *reinterpret_cast<uint4*>(&(&op.kd[0][0][0])[at]) =
          make_uint4(ks[j0].hi, ks[j0 + 2].hi, ks[j0 + 4].hi, ks[j0 + 6].hi);
      *reinterpret_cast<uint4*>(&(&op.kd[1][0][0])[at]) =
          make_uint4(ks[j0].lo, ks[j0 + 2].lo, ks[j0 + 4].lo, ks[j0 + 6].lo);
    }
  }
  // (3) M: half-warp h2 (0..7) takes rows i1 = 15 - h2 and i0 = h2 (15
  // pairs below the diagonal and 2 diagonals, whatever h2), its lane cg
  // the channels 4 cg .. 4 cg + 3. Slot v < 15 holds the v-th pair of a
  // walk down row i1 (j = i1 - 1 .. 0), then row i0 (j = 14 - v ..
  // 0); slots 15 and 16 the diagonals of i1 and i0.
  const int lane = threadIdx.x & 31, cg = lane & 15;
  const int h2 = 2 * (p >> 5) + (lane >> 4);
  const int i0 = h2, i1 = kC - 1 - h2;
  float acc[32];
  float t[4], tz[4];
  {
    float q1[4], k1[4], q0[4], k0[4], w1[4], w0[4];
    load4(&r.q[i1][4 * cg], q1);
    load4(&r.k[i1][4 * cg], k1);
    load4(&r.q[i0][4 * cg], q0);
    load4(&r.k[i0][4 * cg], k0);
    load4(&r.w[i1][4 * cg], w1);
    load4(&r.w[i0][4 * cg], w0);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      // the diagonal: q·(u ⊙ k), or q·k for the read after the update,
      // whose pairs below it take w_i too
      t[e] = kBonus ? q1[e] : q1[e] * w1[e];
      tz[e] = kBonus ? q0[e] : q0[e] * w0[e];
      if constexpr (kBonus) {
        q1[e] *= u4[e];
        q0[e] *= u4[e];
      }
    }
    acc[15] = dot4(q1, k1);
    acc[16] = dot4(q0, k0);
  }
  // step v reads row j = i1 - 1 - v of k and w, then j = 14 - v
  const TQK* k1 = &r.k[i1 - 1][4 * cg];
  const TQK* k0 = &r.k[kC - 2][4 * cg];
  const float* w1 = &r.w[i1 - 1][4 * cg];
  const float* w0 = &r.w[kC - 2][4 * cg];
#pragma unroll
  for (int v = 0; v < kC - 1; ++v) {
    const bool first = v < i1;
    if (v == i1) {
#pragma unroll
      for (int e = 0; e < 4; ++e) t[e] = tz[e];
    }
    float kj[4], wj[4];
    load4((first ? k1 : k0) - v * kD, kj);
    load4((first ? w1 : w0) - v * kD, wj);
    acc[v] = dot4(t, kj);
#pragma unroll
    for (int e = 0; e < 4; ++e) t[e] *= wj[e];
  }
#pragma unroll
  for (int v = 17; v < 32; ++v) acc[v] = 0.f;
  // lane cg ends with slots 2 cg and 2 cg + 1, summed over the 16 lanes
  reduce_half<16>(acc, lane);
  reduce_half<8>(acc, lane);
  reduce_half<4>(acc, lane);
  reduce_half<2>(acc, lane);
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int v = 2 * cg + e;
    int i = -1, j = 0;
    if (v < kC - 1) {
      i = v < i1 ? i1 : i0;
      j = v < i1 ? i1 - 1 - v : kC - 2 - v;
    } else if (v == kC - 1) {
      i = j = i1;
    } else if (v == kC) {
      i = j = i0;
    }
    if (i >= 0) {
      const Parts ms = split(acc[e]);
      const int at = swz(i, kpos(j));
      (&op.m[0][0][0])[at] = __uint_as_float(ms.hi);
      (&op.m[1][0][0])[at] = __uint_as_float(ms.lo);
    }
  }
  // the tiles are read by the consumers' wgmma (the async proxy)
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// -- consumers ----------------------------------------------------------------

// Chunk ck: o from the state at its start and the chunk's operands, then
// the state at its end (the consumer warpgroup, warps 0-3; warp cw holds
// columns 16 cw .. 16 cw + 15 of the state as s[n-tile of 8 rows][C
// fragment], the rows of Sᵀ that its wgmma fragments hold).
template <typename TQK, typename TV>
__device__ __forceinline__ void consume(const Args& a, Smem<TQK, TV>& sm,
                                        const Bases& at, int ck,
                                        float (&s)[32]) {
  constexpr bool kSplitV = sizeof(TV) == 4;
  const auto& r = sm.raw[ck % kRing];
  const auto& op = sm.ops[ck & 1];
  const int cw = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, c0 = 16 * cw;

  // vᵀ's A fragments (rows c0 + g (+ 8), k columns t and t + 4: steps
  // 8 ks + 2t and 8 ks + 2t + 1), hi and lo
  uint32_t vh[2][4], vl[2][4];
#pragma unroll
  for (int ks = 0; ks < 2; ++ks) {
    const int j = 8 * ks + 2 * t;
    const Parts x[4] = {
        v_operand(r.v[j][c0 + g]), v_operand(r.v[j][c0 + g + 8]),
        v_operand(r.v[j + 1][c0 + g]), v_operand(r.v[j + 1][c0 + g + 8])};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      vh[ks][e] = x[e].hi;
      vl[ks][e] = x[e].lo;
    }
  }
  const uint32_t qd_hi = smem_addr(&op.qd[0][0][0][0]);
  const uint32_t qd_lo = smem_addr(&op.qd[1][0][0][0]);
  const uint32_t kd_hi = smem_addr(&op.kd[0][0][0]);
  const uint32_t kd_lo = smem_addr(&op.kd[1][0][0]);
  const uint32_t m_hi = smem_addr(&op.m[0][0][0]);
  const uint32_t m_lo = smem_addr(&op.m[1][0][0]);
  constexpr uint32_t kQBlock = kC * kRowTf * 4;   // a 32-column block of qd

  // oᵀ = Sᵀ (q ⊙ pre)ᵀ: each k-step's three products from zero into one of
  // kDepth buffers, added to oi in order once done, with the next
  // kDepth - 1 k-steps in flight
  constexpr int kDepth = 2;
  float oi[8], tb[kDepth][8];
  if (ck > 0) {                        // the state is 0 before the first
#pragma unroll
    for (int ks = 0; ks < kD / 8 + kDepth - 1; ++ks) {
      if (ks < kD / 8) {
        // state rows 8 ks + 2t, + 1: the C fragment of n-tile ks
        const Parts sa[4] = {split(s[4 * ks]), split(s[4 * ks + 2]),
                             split(s[4 * ks + 1]), split(s[4 * ks + 3])};
        const uint32_t ahi[4] = {sa[0].hi, sa[1].hi, sa[2].hi, sa[3].hi};
        const uint32_t alo[4] = {sa[0].lo, sa[1].lo, sa[2].lo, sa[3].lo};
        const uint32_t off = (ks / 4) * kQBlock + (ks % 4) * 32;
        float (&tk)[8] = tb[ks % kDepth];
        wgmma_fence();
        wgmma_n16(tk, alo, tile_desc(qd_hi + off), 0);
        wgmma_n16(tk, ahi, tile_desc(qd_lo + off), 1);
        wgmma_n16(tk, ahi, tile_desc(qd_hi + off), 1);
        wgmma_commit();
      }
      const int kt = ks - (kDepth - 1);        // the k-step to take
      if (kt >= 0) {
        // groups complete in order: wait until kt's is done, the later
        // ones issued may stay in flight
        wgmma_wait_upto((ks < kD / 8 ? ks : kD / 8 - 1) - kt);
        float (&done)[8] = tb[kt % kDepth];
        fence_regs(done);
#pragma unroll
        for (int e = 0; e < 8; ++e)
          oi[e] = kt == 0 ? done[e] : oi[e] + done[e];
      }
    }
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) oi[e] = 0.f;
  }

  // Sᵀ's share vᵀ (k ⊙ suf) and oᵀ's vᵀ Mᵀ, each k-step from zero
  float ds[2][32], om[2][8];
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < 2; ++ks) {
    const uint32_t off = ks * 32;
    if constexpr (kSplitV) {
      wgmma_n64(ds[ks], vl[ks], tile_desc(kd_hi + off), 0);
      wgmma_n64(ds[ks], vh[ks], tile_desc(kd_lo + off), 1);
      wgmma_n16(om[ks], vl[ks], tile_desc(m_hi + off), 0);
      wgmma_n16(om[ks], vh[ks], tile_desc(m_lo + off), 1);
    } else {
      wgmma_n64(ds[ks], vh[ks], tile_desc(kd_lo + off), 0);
      wgmma_n16(om[ks], vh[ks], tile_desc(m_lo + off), 0);
    }
    wgmma_n64(ds[ks], vh[ks], tile_desc(kd_hi + off), 1);
    wgmma_n16(om[ks], vh[ks], tile_desc(m_hi + off), 1);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(ds[0]);
  fence_regs(ds[1]);
  fence_regs(om[0]);
  fence_regs(om[1]);
  // S <- diag(A) S + the share: element e of n-tile nd is state row
  // 8 nd + 2t + (e & 1)
#pragma unroll
  for (int nd = 0; nd < kD / 8; ++nd) {
    const float2 decay =
        *reinterpret_cast<const float2*>(&op.blk[8 * nd + 2 * t]);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      s[4 * nd + e] = fmaf(e & 1 ? decay.y : decay.x, s[4 * nd + e],
                           ds[0][4 * nd + e] + ds[1][4 * nd + e]);
  }

  // o: element e of n-tile nt is step 8 nt + 2t + (e & 1), column
  // c0 + g + 8 (e >> 1)
  TV (&ost)[kC][16] = sm.ost[cw];
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      ost[8 * nt + 2 * t + (e & 1)][g + 8 * (e >> 1)] = from_float<TV>(
          oi[4 * nt + e] + (om[0][4 * nt + e] + om[1][4 * nt + e]));
  __syncwarp();
  const long long t0 = static_cast<long long>(ck) * kC;
  TV* o = static_cast<TV*>(a.o) + at.o + t0 * a.so.s;
  const int rows = min(kC, a.seq - static_cast<int>(t0));
  if (a.vec) {
    constexpr int kPer = 16 / sizeof(TV), kPieces = 16 / kPer;
#pragma unroll
    for (int idx = lane; idx < kC * kPieces; idx += 32) {
      const int i = idx / kPieces, col = kPer * (idx % kPieces);
      if (i < rows && c0 + col < a.dv)
        *reinterpret_cast<uint4*>(o + i * a.so.s + c0 + col) =
            *reinterpret_cast<const uint4*>(&ost[i][col]);
    }
  } else {
#pragma unroll
    for (int idx = lane; idx < kC * 16; idx += 32) {
      const int i = idx / 16, col = idx % 16;
      if (i < rows && c0 + col < a.dv)
        o[i * a.so.s + (c0 + col) * a.so.d] = ost[i][col];
    }
  }
  __syncwarp();
}

template <typename TQK, typename TV, bool kBonus>
__global__ void __launch_bounds__(kThreads, 2) channel_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  // the operand tiles at a 1024-byte boundary (the swizzle's)
  Smem<TQK, TV>& sm = *reinterpret_cast<Smem<TQK, TV>*>(
      smem + ((1024 - (smem_addr(smem) & 1023)) & 1023));
  const int bh = blockIdx.x, b = bh / a.heads, h = bh % a.heads;
  const Bases at{b * a.sq.b + h * a.sq.h, b * a.sk.b + h * a.sk.h,
                 b * a.sv.b + h * a.sv.h, b * a.sw.b + h * a.sw.h,
                 b * a.so.b + h * a.so.h};
  const int tid = threadIdx.x;
  const int chunks = (a.seq + kC - 1) / kC;

  // M above the diagonal stays 0: the producers write j <= i only
#pragma unroll
  for (int x = tid; x < 2 * kC * kRowTf; x += kThreads) {
    (&sm.ops[0].m[0][0][0])[x] = 0.f;
    (&sm.ops[1].m[0][0][0])[x] = 0.f;
  }

  // The warpgroup, warp-uniform as the compiler sees it (a shuffle), so no
  // wgmma sits on a path it must treat as divergent. Both roles pass the
  // same __syncthreads: one before chunk 0, one a chunk.
  const int role = __shfl_sync(kFull, tid / 128, 0);
  if (role == 0) {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    float s[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) s[e] = 0.f;
    __syncthreads();
    for (int ck = 0; ck < chunks; ++ck) {
      // The operands of chunk ck are whole.
      __syncthreads();
      consume(a, sm, at, ck, s);
    }
    const int lane = tid & 31, g = lane >> 2, t = lane & 3;
    const int c0 = 16 * (tid >> 5);
    float* out = a.state + static_cast<long long>(bh) * a.dk * a.dv;
#pragma unroll
    for (int nd = 0; nd < 8; ++nd)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = 8 * nd + 2 * t + (e & 1), c = c0 + g + 8 * (e >> 1);
        if (d < a.dk && c < a.dv) out[d * a.dv + c] = s[4 * nd + e];
      }
  } else {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    // the bonus over this lane's 4 channels
    float u4[4] = {0.f, 0.f, 0.f, 0.f};
    if (kBonus) {
      const int c = 4 * (tid & 15);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (c + e < a.dk) u4[e] = a.u[h * a.dk + c + e];
    }
    // the chunks, kAhead ahead of the consumers
#pragma unroll
    for (int ck = 0; ck < kAhead; ++ck) {
      if (ck < chunks) load_chunk(a, sm, at, ck);
      cp_commit();
    }
    cp_wait<kAhead - 1>();             // chunk 0 is in
    __syncthreads();
    produce<TQK, TV, kBonus>(a, sm, 0, u4);
    for (int ck = 0; ck < chunks; ++ck) {
      cp_wait<kAhead - 2>();           // chunk ck + 1 is in
      // Every read of chunk ck - 1's ring slot and operands is done.
      __syncthreads();
      if (ck + kAhead < chunks) load_chunk(a, sm, at, ck + kAhead);
      cp_commit();
      if (ck + 1 < chunks) produce<TQK, TV, kBonus>(a, sm, ck + 1, u4);
    }
  }
}

using Kernel = void (*)(const Args);

template <typename TQK, typename TV>
int launch(const Args& a, int blocks, bool bonus, cudaStream_t stream) {
  const Kernel kernel = bonus ? &channel_kernel<TQK, TV, true>
                              : &channel_kernel<TQK, TV, false>;
  const int smem = sizeof(Smem<TQK, TV>) + 1024;   // and room to align
  const cudaError_t set = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (set != cudaSuccess) return static_cast<int>(set);
  kernel<<<blocks, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// Whether 16-byte copies read (or write) a tensor's rows of n elements as
// they lie: dim stride 1, the row's bytes and every other stride a
// multiple of 16 bytes, the data on a 16-byte boundary.
bool rows16(const void* p, const Strides4& s, int n, int size) {
  return s.d == 1 && (n * size) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(p) % 16 == 0 && (s.b * size) % 16 == 0 &&
         (s.h * size) % 16 == 0 && (s.s * size) % 16 == 0;
}

}  // namespace

extern "C" {

// o, state = linear_scan(q, k, v, w, u): q, k, w (batch, heads, seq, dk),
// v and o (batch, heads, seq, dv) at the element strides in `strides`
// (q, k, v, w, o; each batch, head, step, dim: 20 values); state
// (batch, heads, dk, dv) float32 contiguous; u (heads, dk) float32
// contiguous, or null for the read after the update. q and k are bf16 if
// `qk_bf16`, else float32; v and o bf16 if `v_bf16`, else float32; w
// float32. dk and dv are at most 64; the wrapper checks shapes and types.
int linear_scan_launch(const void* q, const void* k, const void* v,
                       const float* w, const float* u, void* o,
                       float* state, int batch, int heads, int seq, int dk,
                       int dv, int qk_bf16, int v_bf16,
                       const long long* strides, cudaStream_t stream) {
  if (dk < 1 || dk > kD || dv < 1 || dv > kD || seq < 1 || batch < 1 ||
      heads < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.q = q; a.k = k; a.v = v; a.w = w; a.u = u; a.o = o; a.state = state;
  Strides4* dst[5] = {&a.sq, &a.sk, &a.sv, &a.sw, &a.so};
  for (int i = 0; i < 5; ++i)
    *dst[i] = Strides4{strides[4 * i], strides[4 * i + 1],
                       strides[4 * i + 2], strides[4 * i + 3]};
  a.heads = heads; a.seq = seq; a.dk = dk; a.dv = dv;
  const int qs = qk_bf16 ? 2 : 4, vs = v_bf16 ? 2 : 4;
  a.vec = rows16(q, a.sq, dk, qs) && rows16(k, a.sk, dk, qs) &&
          rows16(w, a.sw, dk, 4) && rows16(v, a.sv, dv, vs) &&
          rows16(o, a.so, dv, vs);
  const long long blocks = static_cast<long long>(batch) * heads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int n = static_cast<int>(blocks);
  const bool bonus = u != nullptr;
  if (qk_bf16)
    return v_bf16 ? launch<__nv_bfloat16, __nv_bfloat16>(a, n, bonus, stream)
                  : launch<__nv_bfloat16, float>(a, n, bonus, stream);
  return v_bf16 ? launch<float, __nv_bfloat16>(a, n, bonus, stream)
                : launch<float, float>(a, n, bonus, stream);
}

const char* linear_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
