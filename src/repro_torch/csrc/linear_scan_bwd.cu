// linear_scan_bwd: the gradient of linear_scan's output, for both reads,
// step by step on the CUDA cores of Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package takes this gradient by autodiff
// of its chunked jnp form (src/repro/models/scan_ops.py:72,
// `linear_scan_chunked`), and its Pallas kernel
// (src/repro/kernels/linear_scan/linear_scan.py:108) has no backward. The
// forward, from a zero state, on w clipped to [1e-6, 1]:
//
//   S_t = diag(w_t) S_{t-1} + k_tᵀ v_t            (S is dk x dv, float32)
//   o_t = q_t S_t                                  (Mamba2: no bonus)
//   o_t = q_t S_{t-1} + (q_t · u · k_t) v_t        (RWKV6: bonus u)
//
// Its gradient, given dL/do and none into the final state, with H_t =
// dL/dS_t carried backward in time:
//
//   Mamba2: H_t = q_tᵀ do_t + diag(w_{t+1}) H_{t+1};  dq_t = do_t S_tᵀ
//   RWKV6:  H_{t-1} = q_tᵀ do_t + diag(w_t) H_t;
//           dq_t = do_t S_{t-1}ᵀ + u ⊙ k_t (do_t · v_t)
//           dk_t += u ⊙ q_t (do_t · v_t);  dv_t += (q_t · u · k_t) do_t
//           du += q_t ⊙ k_t (do_t · v_t)
//   both:   dk_t = H_t v_tᵀ,  dv_t = k_t H_t,
//           dw_t[i] = Σ_j H_t[i, j] S_{t-1}[i, j] times the reference's clip
//           factor (1 inside (1e-6, 1), 0.5 at either end, 0 outside)
//
// dw needs the states in reverse order. Nothing divides by w (w underflows
// to 0 and clips to 1e-6 in RWKV6): the states are recomputed forward from
// kept ones, with the same fma as every other sweep, so every sweep sees
// the same bits. Three levels:
// * a first sweep keeps the state before every 64 steps in a float32
//   scratch the wrapper allocates (B·H·ceil(S/64) states of 64 x 64);
// * the reverse sweep, chunk by chunk from the last, rebuilds the chunk's
//   state before each 8 steps into shared memory (8 x 16 KB);
// * for each 8 steps, last first, their 8 states go into registers, and
//   the 8 steps run backward from them.
// Each state element is so computed three times, and each reverse step
// does 6 more float32 operations on it (H, dq, dk, dv, dw). Every decay
// factor stays a product of w's, and the result is deterministic: no
// atomics, every sum in a fixed order (du's (b, h) partials are summed
// over b by the wrapper).
//
// Design: one block of 512 threads per (batch, head), 16 warps; warp g
// holds state rows 4g .. 4g + 3, lane l row 4g + l / 8 and the 8 columns
// 8 (l % 8) .. + 7, of S and of H, zeros past dk and dv. A row's sums (dq,
// dk, dw, do · v) are butterflies over its 8 lanes; dv's column sums a
// reduce-scatter over a warp's 4 rows, then the 16 warps' partials summed
// in order from shared memory once each 8 steps. Each 8 steps' inputs are
// staged in shared memory as float32 (zeros past S and decays of 1, which
// leave S and H as they are), the next 8 loaded into registers while the
// current ones run.
//
// Bound on this card: operations. At rwkv6-7b's prefill shape (4, 64,
// 4096, 64, 64), 12 float32 operations a state element a step (the state
// once, H, dq, dk, dv, dw) are 51.5 GFLOP, 0.77 ms at 67 TFLOP/s, against
// 1.48 GB of inputs and gradients (0.44 ms at 3.35 TB/s). This kernel
// computes the state three times and sums across threads by shuffles: a
// simple first design, a tensor-core chunked form is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kD = 64;                 // state rows (dk) and columns (dv)
constexpr int kThreads = 512;          // 16 warps of 4 state rows each
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 8;               // state columns a thread holds
constexpr int kElems = kD * kD;        // floats a state
constexpr int kSub = 8;                // steps whose states sit in registers
constexpr int kNSub = 8;               // such groups a chunk
constexpr int kChunk = kSub * kNSub;   // steps between kept states
constexpr unsigned kFull = 0xffffffffu;
constexpr float kWMin = 1e-6f;

struct Strides4 {
  long long b, h, s, d;
};

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const float* w;
  const float* u;          // (heads, dk) float32, or null (Mamba2)
  const void* dout;        // in v's dtype
  void* gq;                // dL/dq, dense (B, H, S, dk), q's dtype
  void* gk;                // dL/dk, dense, k's dtype
  void* gv;                // dL/dv, dense (B, H, S, dv), v's dtype
  float* gw;               // dL/dw, dense (B, H, S, dk)
  float* gu;               // dL/du's (B, H, dk) partials, or null
  float* kept;             // (B·H, n_chunks, kElems)
  Strides4 sq, sk, sv, sw, sdo;
  int heads, seq, dk, dv, n_chunks;
};

struct Smem {
  float ck[kNSub][kElems];     // the state before each 8 steps of a chunk
  float q[kSub][kD];           // the staged steps, float32, zero-padded
  float k[kSub][kD];
  float w[kSub][kD];           // clipped; 1 past S
  float m[kSub][kD];           // the clip's gradient factor
  float v[kSub][kD];
  float g[kSub][kD];           // dL/do
  float dvp[kSub][kWarps][kD]; // each warp's dv partial over its 4 rows
  float cp[kSub][kWarps];      // each warp's share of q · u · k
  float dq[kSub][kD];
  float dk[kSub][kD];
  float dw[kSub][kD];
};

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st(float* p, float x) { *p = x; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ long long at(const Strides4& s, int b, int h,
                                        int t, int d) {
  return b * s.b + h * s.h + t * s.s + d * s.d;
}

// One thread's share of 8 steps' inputs: step t0 + tid / 64, dim tid % 64.
template <typename TQK, typename TV>
struct Stage {
  float q, k, w, v, g;

  template <bool kAll>
  __device__ void fetch(const Args& a, int b, int h, int t0) {
    const int t = t0 + threadIdx.x / kD, d = threadIdx.x % kD;
    const bool live = t < a.seq;
    const bool in_k = live && d < a.dk, in_v = live && d < a.dv;
    k = in_k ? ld(static_cast<const TQK*>(a.k) + at(a.sk, b, h, t, d)) : 0.f;
    w = in_k ? a.w[at(a.sw, b, h, t, d)] : 1.f;
    v = in_v ? ld(static_cast<const TV*>(a.v) + at(a.sv, b, h, t, d)) : 0.f;
    if (kAll) {
      q = in_k ? ld(static_cast<const TQK*>(a.q) + at(a.sq, b, h, t, d))
               : 0.f;
      g = in_v ? ld(static_cast<const TV*>(a.dout) + at(a.sdo, b, h, t, d))
               : 0.f;
    }
  }

  template <bool kAll>
  __device__ void put(Smem& sm) const {
    const int s = threadIdx.x / kD, d = threadIdx.x % kD;
    sm.k[s][d] = k;
    sm.w[s][d] = fminf(fmaxf(w, kWMin), 1.f);
    sm.v[s][d] = v;
    if (kAll) {
      sm.q[s][d] = q;
      sm.g[s][d] = g;
      sm.m[s][d] = (w > kWMin && w < 1.f)      ? 1.f
                   : (w == kWMin || w == 1.f) ? 0.5f
                                              : 0.f;
    }
  }
};

// The state a thread holds, advanced over the 8 staged steps.
__device__ __forceinline__ void advance(const Smem& sm, int row, int c0,
                                        float (&s)[kCols]) {
#pragma unroll
  for (int i = 0; i < kSub; ++i) {
    const float w = sm.w[i][row], k = sm.k[i][row];
#pragma unroll
    for (int e = 0; e < kCols; ++e) s[e] = fmaf(w, s[e], k * sm.v[i][c0 + e]);
  }
}

__device__ __forceinline__ void save(float* dst, const float (&s)[kCols]) {
  float4* p = reinterpret_cast<float4*>(dst + threadIdx.x * kCols);
  p[0] = make_float4(s[0], s[1], s[2], s[3]);
  p[1] = make_float4(s[4], s[5], s[6], s[7]);
}

__device__ __forceinline__ void restore(const float* src, float (&s)[kCols]) {
  const float4* p = reinterpret_cast<const float4*>(src + threadIdx.x * kCols);
  const float4 x = p[0], y = p[1];
  s[0] = x.x; s[1] = x.y; s[2] = x.z; s[3] = x.w;
  s[4] = y.x; s[5] = y.y; s[6] = y.z; s[7] = y.w;
}

// The sum over the 8 lanes of a state row, in every one of them.
__device__ __forceinline__ float row_sum(float x) {
  x += __shfl_xor_sync(kFull, x, 1);
  x += __shfl_xor_sync(kFull, x, 2);
  x += __shfl_xor_sync(kFull, x, 4);
  return x;
}

template <typename TQK, typename TV, bool kBonus>
__global__ void __launch_bounds__(kThreads, 1) bwd_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 15) & ~uintptr_t(15));
  const int bh = blockIdx.x, b = bh / a.heads, h = bh % a.heads;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = 4 * warp + lane / 8, c0 = kCols * (lane % 8);
  float* kept = a.kept + static_cast<long long>(bh) * a.n_chunks * kElems;
  Stage<TQK, TV> stage;

  // Sweep 1: the state before every chunk but the first, kept.
  float s[kCols];
#pragma unroll
  for (int e = 0; e < kCols; ++e) s[e] = 0.f;
  save(kept, s);
  const int n_sub = (a.n_chunks - 1) * kNSub;   // groups before the last chunk
  if (n_sub > 0) stage.template fetch<false>(a, b, h, 0);
  for (int j = 0; j < n_sub; ++j) {
    __syncthreads();
    stage.template put<false>(sm);
    if (j + 1 < n_sub) stage.template fetch<false>(a, b, h, (j + 1) * kSub);
    __syncthreads();
    advance(sm, row, c0, s);
    if ((j + 1) % kNSub == 0) save(kept + ((j + 1) / kNSub) * kElems, s);
  }

  // Sweep 2: chunk by chunk from the last.
  const float ur = (kBonus && row < a.dk) ? a.u[h * a.dk + row] : 0.f;
  float hs[kCols];                 // H: dL/dS, this thread's elements
#pragma unroll
  for (int e = 0; e < kCols; ++e) hs[e] = 0.f;
  float du_acc = 0.f;
  for (int c = a.n_chunks - 1; c >= 0; --c) {
    const int t_chunk = c * kChunk;
    const int steps = min(kChunk, a.seq - t_chunk);
    const int groups = (steps + kSub - 1) / kSub;
    // the state before each group of 8 steps, into shared memory
    restore(kept + static_cast<long long>(c) * kElems, s);
    if (groups > 1) stage.template fetch<false>(a, b, h, t_chunk);
    for (int m = 0; m < groups; ++m) {
      save(sm.ck[m], s);
      if (m + 1 == groups) break;
      __syncthreads();
      stage.template put<false>(sm);
      if (m + 2 < groups)
        stage.template fetch<false>(a, b, h, t_chunk + (m + 1) * kSub);
      __syncthreads();
      advance(sm, row, c0, s);
    }
    // each group of 8 steps, last first
    stage.template fetch<true>(a, b, h, t_chunk + (groups - 1) * kSub);
    for (int m = groups - 1; m >= 0; --m) {
      const int t0 = t_chunk + m * kSub;
      __syncthreads();
      stage.template put<true>(sm);
      if (m > 0) stage.template fetch<true>(a, b, h, t0 - kSub);
      __syncthreads();
      float st8[kSub][kCols];      // S_{t0} .. S_{t0 + 7}
      restore(sm.ck[m], s);
#pragma unroll
      for (int i = 0; i < kSub; ++i) {
        const float w = sm.w[i][row], k = sm.k[i][row];
#pragma unroll
        for (int e = 0; e < kCols; ++e) {
          s[e] = fmaf(w, s[e], k * sm.v[i][c0 + e]);
          st8[i][e] = s[e];
        }
      }
#pragma unroll
      for (int i = kSub - 1; i >= 0; --i) {
        float prev[kCols];         // S_{t-1}
        if (i > 0) {
#pragma unroll
          for (int e = 0; e < kCols; ++e) prev[e] = st8[i - 1][e];
        } else {
          restore(sm.ck[m], prev);
        }
        const float qr = sm.q[i][row], kr = sm.k[i][row], wr = sm.w[i][row];
        float vv[kCols], gg[kCols];
#pragma unroll
        for (int e = 0; e < kCols; ++e) {
          vv[e] = sm.v[i][c0 + e];
          gg[e] = sm.g[i][c0 + e];
        }
        if (!kBonus) {
#pragma unroll
          for (int e = 0; e < kCols; ++e) hs[e] = fmaf(qr, gg[e], hs[e]);
        }
        float pq = 0.f, pk = 0.f, pw = 0.f, pdo = 0.f, dvc[kCols];
#pragma unroll
        for (int e = 0; e < kCols; ++e) {
          pq = fmaf(gg[e], kBonus ? prev[e] : st8[i][e], pq);
          pk = fmaf(hs[e], vv[e], pk);
          pw = fmaf(hs[e], prev[e], pw);
          dvc[e] = kr * hs[e];
          if (kBonus) pdo = fmaf(gg[e], vv[e], pdo);
        }
        pq = row_sum(pq);
        pk = row_sum(pk);
        pw = row_sum(pw);
        // dv: the warp's 4 rows summed, two columns left in each lane
        const bool hi16 = lane & 16, hi8 = lane & 8;
        float r4[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float send = hi16 ? dvc[e] : dvc[e + 4];
          r4[e] = (hi16 ? dvc[e + 4] : dvc[e]) +
                  __shfl_xor_sync(kFull, send, 16);
        }
        float r2[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float send = hi8 ? r4[e] : r4[e + 2];
          r2[e] = (hi8 ? r4[e + 2] : r4[e]) + __shfl_xor_sync(kFull, send, 8);
        }
        const int col = c0 + (hi16 ? 4 : 0) + (hi8 ? 2 : 0);
        *reinterpret_cast<float2*>(&sm.dvp[i][warp][col]) =
            make_float2(r2[0], r2[1]);
        if (kBonus) {
          const float dov = row_sum(pdo);
          pq = fmaf(ur * kr, dov, pq);
          pk = fmaf(ur * qr, dov, pk);
          du_acc = fmaf(qr * kr, dov, du_acc);
          float c = qr * ur * kr;          // the same in a row's 8 lanes
          c += __shfl_xor_sync(kFull, c, 8);
          c += __shfl_xor_sync(kFull, c, 16);
          if (lane == 0) sm.cp[i][warp] = c;
#pragma unroll
          for (int e = 0; e < kCols; ++e) hs[e] = fmaf(wr, hs[e], qr * gg[e]);
        } else {
#pragma unroll
          for (int e = 0; e < kCols; ++e) hs[e] *= wr;
        }
        if (lane % 8 == 0) {
          sm.dq[i][row] = pq;
          sm.dk[i][row] = pk;
          sm.dw[i][row] = pw;
        }
      }
      __syncthreads();
      // the group's gradients, one (step, dim) a thread
      const int i = threadIdx.x / kD, d = threadIdx.x % kD, t = t0 + i;
      if (t < a.seq) {
        const long long base = (static_cast<long long>(bh) * a.seq + t);
        if (d < a.dk) {
          st(static_cast<TQK*>(a.gq) + base * a.dk + d, sm.dq[i][d]);
          st(static_cast<TQK*>(a.gk) + base * a.dk + d, sm.dk[i][d]);
          a.gw[base * a.dk + d] = sm.dw[i][d] * sm.m[i][d];
        }
        if (d < a.dv) {
          float x = 0.f;
#pragma unroll
          for (int g = 0; g < kWarps; ++g) x += sm.dvp[i][g][d];
          if (kBonus) {
            float c = 0.f;
#pragma unroll
            for (int g = 0; g < kWarps; ++g) c += sm.cp[i][g];
            x = fmaf(c, sm.g[i][d], x);
          }
          st(static_cast<TV*>(a.gv) + base * a.dv + d, x);
        }
      }
    }
  }
  if (kBonus && lane % 8 == 0 && row < a.dk)
    a.gu[static_cast<long long>(bh) * a.dk + row] = du_acc;
}

using Kernel = void (*)(const Args);

template <typename TQK, typename TV>
int launch(const Args& a, int blocks, bool bonus, cudaStream_t stream) {
  const Kernel kernel = bonus ? &bwd_kernel<TQK, TV, true>
                              : &bwd_kernel<TQK, TV, false>;
  const int smem = sizeof(Smem) + 16;          // and room to align
  const cudaError_t set = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (set != cudaSuccess) return static_cast<int>(set);
  kernel<<<blocks, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// gq, gk, gv, gw, gu = the gradient of linear_scan(q, k, v, w, u)'s o,
// given dout. q, k, w (batch, heads, seq, dk) and v, dout (batch, heads,
// seq, dv) at the element strides in `strides` (q, k, v, w, dout; each
// batch, head, step, dim: 20 values); gq, gk, gw and gv dense in those
// shapes; gu (batch, heads, dk) float32 partials of dL/du, null with u
// (heads, dk, float32 contiguous), which is null for the read after the
// update; kept a float32 scratch of batch · heads · n_chunks · 4096
// floats, n_chunks = ceil(seq / 64). q, k, gq and gk are bf16 if
// `qk_bf16`, else float32; v, dout and gv bf16 if `v_bf16`, else float32;
// w and gw float32. dk and dv are at most 64; the wrapper checks shapes
// and types.
int linear_scan_bwd_launch(const void* q, const void* k, const void* v,
                           const float* w, const float* u, const void* dout,
                           void* gq, void* gk, void* gv, float* gw,
                           float* gu, float* kept, int batch, int heads,
                           int seq, int dk, int dv, int n_chunks, int qk_bf16,
                           int v_bf16, const long long* strides,
                           cudaStream_t stream) {
  if (dk < 1 || dk > kD || dv < 1 || dv > kD || seq < 1 || batch < 1 ||
      heads < 1 || n_chunks != (seq + kChunk - 1) / kChunk ||
      (u == nullptr) != (gu == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.q = q; a.k = k; a.v = v; a.w = w; a.u = u; a.dout = dout;
  a.gq = gq; a.gk = gk; a.gv = gv; a.gw = gw; a.gu = gu;
  a.kept = kept;
  Strides4* dst[5] = {&a.sq, &a.sk, &a.sv, &a.sw, &a.sdo};
  for (int i = 0; i < 5; ++i)
    *dst[i] = Strides4{strides[4 * i], strides[4 * i + 1],
                       strides[4 * i + 2], strides[4 * i + 3]};
  a.heads = heads; a.seq = seq; a.dk = dk; a.dv = dv; a.n_chunks = n_chunks;
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

const char* linear_scan_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
