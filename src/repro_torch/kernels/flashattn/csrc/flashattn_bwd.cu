// Flash attention backward (K5 bwd) on Hopper (sm_90a), plain C interface.
//
// Given the forward's q (B, S, H, dh), k, v (B, S, KV, dh), its output o
// and row logsumexp lse (float32 (B, H, S), written by the forward's kLse
// mode, csrc/flashattn.cu) and the output's gradient dO, it computes the
// gradients of the forward's function (causal, full or sliding-window,
// GQA with g = H / KV), with the FlashAttention-2 formulas:
//
//   D    = rowsum(dO * O)                       (a row pass)
//   P    = exp(S * scale - lse),  S = Q K^T     (masked entries 0)
//   dV   = sum over the g query heads of P^T dO
//   dS   = P * (dO V^T - D)
//   dQ   = dS K * scale
//   dK   = sum over the g query heads of dS^T Q * scale
//
// with float32 sums whatever the inputs' type (the bfloat16 route rounds
// P and dS to bf16 as operands of their products, below; the results
// are rounded once, to the inputs' type).
//
// Replaces no TPU kernel: the TPU kernel (src/repro/kernels/flashattn/
// kernel.py: flash_attention_pallas) has no backward, and the JAX package
// trains through XLA's autodiff of dense_attention and
// masked_chunk_attention (src/repro/models/transformer.py:256-263).  The
// port runs K5 for every layer's forward on the card, so training there
// needs this gradient; the plain version (ref.py
// flash_attention_bwd_ref) would hold (B H, S, S) float32 scores.
//
// Three kernels behind one entry point, on the caller's stream:
//
// * bwd_delta_kernel: D, one warp a row;
// * a dK/dV kernel: one block a (batch, KV head, key tile).  K and V of
//   the tile sit in shared memory; the block loops over the g query
//   heads of its KV head and, for each, over the query tiles that can
//   see its keys (from the diagonal to the end when causal, only the
//   tiles within `window` of it in the window mode), recomputing P and
//   dS and accumulating dV and dK in registers.  GQA is a reduction
//   inside the block: no atomics, no repeated heads;
// * a dQ kernel: one block a (batch, head, query tile), which loops over
//   the KV tiles its rows see and accumulates dQ in registers.  No
//   atomics anywhere: two runs give the same bits.
//
// P and dS are recomputed in both (7 products of a tile pair, where
// FlashAttention-2 takes 5 and adds dQ with atomics; a deterministic dQ
// summed in the dK/dV kernel would need per-key-tile float32 partials,
// 4.8 GB at 32 x 4096 tokens of llama3.2-3b, and a second pass).
//
// bfloat16 route (bwd_dkdv_wgmma_kernel, bwd_dq_wgmma_kernel): wgmma +
// TMA, warp-specialised, the arrangement of K5's forward (csrc/
// flashattn.cu; the PTX helpers are csrc/sm90.cuh) and of FlashAttention-
// 3's backward.  A block is 3 warpgroups:
//
// * a producer warpgroup, shrunk with setmaxnreg to 24 registers.  In
//   the dK/dV kernel one thread loads the block's K and V tiles (128
//   keys) once, then streams the Q and dO tiles of 64 query rows through
//   a ring of 2 stages, each with a "full" and an "empty" mbarrier, over
//   the g query heads and their query tiles; a second warp copies each
//   stage's rows' logsumexp (in log2 units) and D beside them (a TMA map
//   of the (B, H, S) rows would need S a multiple of 4) and arrives on
//   the same "full" barrier.  In the dQ kernel one thread loads the
//   block's Q and dO tiles (128 rows) once, then streams K and V tiles
//   of 128 keys, K and V on barriers of their own, so that S = Q K^T
//   starts before V lands.  Copies are TMA, tensor maps over the (dh, S,
//   heads, B) views encoded on the host per call: q, k, v through their
//   strides (GQA needs no copy), dO contiguous; TMA zero-fills rows past
//   S;
// * two consumer warpgroups, grown to 240 registers, 64 keys (dK/dV) or
//   64 query rows (dQ) each.  dK/dV, per stage: S^T = K Q^T and dP^T = V
//   dO^T with wgmma.m64n64k16 (both operands in shared memory,
//   K-major); P^T = exp2(S^T scale - lse) and dS^T = P^T (dP^T - D) in
//   registers, masked where a key or row lies past S, above the diagonal
//   or outside the window; rounded to bf16 they are the A operands
//   (register fragments: the accumulator layout is the A layout, the
//   forward's trick with P) of dV += P^T dO and dK += dS^T Q with
//   wgmma.m64n{dh}k16, dO and Q read MN-major from the stage.  dQ, per
//   stage: S = Q K^T and dP = dO V^T (m64n128k16, shared-memory
//   operands), dS in registers, dQ += dS K (K read MN-major).  After its
//   products each consumer warp arrives on the stage's empty barrier; a
//   warpgroup none of whose keys (rows) the stage's rows (keys) see
//   skips the products but still waits and arrives.  P (P^T) is formed
//   while the products of dP (dP^T) still run; while one warpgroup
//   computes P and dS the other's products use the tensor cores.
//
// Two further overlaps were tried on the card and dropped: issuing dV +=
// P^T dO before dS^T is formed kept P^T, dP^T and both accumulators
// live, and the dh 128 kernel spilled; waiting for the dQ kernel's dQ +=
// dS K only after the next stage's S = Q K^T was issued gained nothing.
// At llama3.2-3b's layer at 3 x 4,096 tokens the two kernels take
// about 1.1 ms each, 2.27 ms in all with the row pass, against 9.2-9.4
// ms for the mma.sync kernels they replace (tools/flash_bwd_ab.py,
// NVIDIA H100 80GB HBM3, 700 W).
//
// FlashAttention-2's rounding (P and dS to bf16 before their products),
// with the gradients' own rounding, keeps dq, dk, dv within 1e-2 of the
// float32 plain version in relative L2.  Shared memory at dh 128: 130 KB
// a dK/dV block (K, V, 2 stages of Q, dO, lse and D), 193 KB a dQ block
// (Q, dO, 2 stages of K and V); one block an SM.  The longest blocks
// launch first (causal: key tile 0 sees every query tile; the dQ
// kernel's last query tile sees every key tile), so the short tail tiles
// fill the last wave.  The window mode is its own instantiation of each
// kernel (kWin), every window term under `if constexpr`; the ring's slot
// and phase count from the loop's first tile.
//
// float32 route (bwd_dkdv_kernel, bwd_dq_kernel): scalar float32 FMAs on
// float32 tiles in shared memory, each thread a 4 x 4 block of S and dP
// and a 4-key (or 4-row) x dh / 16 block of the outputs, operands read
// as float4 (within 1e-5 of the plain version: a product on the tensor
// cores would need the forward's three TF32 passes).
//
// Bound on the card.  At llama3.2-3b's training layer (B 1, S 4096, 24 /
// 8 heads of 128, bf16, causal) the five products over the 2.01e8 kept
// (query, key) pairs are 2.58e11 operations: 0.261 ms at the bf16
// tensor-core rate (989 TFLOP/s), against 135 MB of bytes (q, k, v, o,
// dO, lse read once, dq, dk, dv written once), 0.040 ms at 3.35 TB/s:
// bound by operations.  The seven products executed here take 1.4x
// that bound at the same rate.
//
// dh is 16, 64 or 128 in float32, 64 or 128 in bfloat16: the forward's
// table.  Offsets are 64-bit.  The entry point returns
// cudaGetLastError() (or the error of raising a shared-memory limit), or
// minus the CUresult of a tensor map the driver refused; the caller
// raises on a non-zero code.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

#include <type_traits>

#include "sm90.cuh"

namespace {

constexpr int kRows = 64;       // query rows a tile
constexpr int kKeys = 64;       // keys a tile
constexpr int kThreads = 256;   // 16 x 16 threads, 4 x 4 of S each
constexpr int kLdP = kKeys + 4; // row stride of the P and dS tiles
constexpr float kLog2e = 1.4426950408889634f;

typedef __nv_bfloat16 bf16;

struct BwdParams {
  const void* q;
  const void* k;
  const void* v;
  const void* o;               // (B, S, H, dh) contiguous
  const void* dout;            // (B, S, H, dh) contiguous
  const float* lse;            // (B, H, S)
  float* delta;                // (B, H, S) scratch
  void* dq;                    // (B, S, H, dh) contiguous
  void* dk;                    // (B, S, KV, dh) contiguous
  void* dv;
  long long q_sb, q_ss, q_sh;  // strides in elements (dh is contiguous)
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  int seq;
  int n_heads;
  int group;                   // H / KV
  int causal;
  float sm_scale;
  int window;                  // sliding window (causal only); 0: none
};

// 4 consecutive elements as float32
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const bf16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}


__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// 64 rows from r0 of a (seq, D) slab of row stride ss into shared memory
// at row stride D + 4, widened to float32; rows past seq land as zeros
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          long long ss, int r0, int seq) {
  constexpr int kLd = D + 4;
  constexpr int kVec = D / 4;
  for (int i = threadIdx.x; i < kRows * kVec; i += kThreads) {
    const int r = i / kVec;
    const int c = (i % kVec) * 4;
    float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (r0 + r < seq) x = load4(src + (r0 + r) * ss + c);
    store4(dst + r * kLd + c, x);
  }
}

// The dh columns a thread owns in the dh-wide products: with DC = dh / 16
// of them, chunks of 4 (at 64-column strides across the 16 threads of a
// group) where DC >= 4, else column tc * DC + j
template <int D>
__device__ __forceinline__ int out_col(int tc, int j) {
  constexpr int DC = D / 16;
  if constexpr (DC >= 4) return (j / 4) * 64 + tc * 4 + (j % 4);
  return tc * DC + j;
}

// whether query row `row` sees key `key`: both inside S, causal, and with
// a window (win) at most window - 1 back
__device__ __forceinline__ bool kept(const BwdParams& p, int row, int key,
                                     bool win) {
  return row < p.seq && key < p.seq && !(p.causal && key > row)
      && !(win && row - key >= p.window);
}

// S = Q K^T and dP = dO V^T of one tile pair, thread (tr, tc) holding rows
// 4 tr + a and keys tc + 16 b; then P and dS (P * (dP - D)) for the rows
// and keys the mask keeps, 0 elsewhere.  lse_s and delta_s hold the tile's
// rows' logsumexp in log2 units and D.
template <int D, bool kWin>
__device__ __forceinline__ void tile_p_ds(
    const float* qs, const float* dos, const float* ks, const float* vs,
    const float* lse_s, const float* delta_s, int q0, int k0,
    const BwdParams& p, float (&pr)[4][4], float (&ds)[4][4]) {
  constexpr int kLd = D + 4;
  const int tr = threadIdx.x / 16;
  const int tc = threadIdx.x % 16;
  float sc[4][4], dp[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) sc[a][b] = dp[a][b] = 0.0f;
#pragma unroll 2
  for (int d = 0; d < D; d += 4) {
    float4 qa[4], oa[4], kb[4], vb[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      qa[a] = load4(qs + (tr * 4 + a) * kLd + d);
      oa[a] = load4(dos + (tr * 4 + a) * kLd + d);
    }
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      kb[b] = load4(ks + (tc + 16 * b) * kLd + d);
      vb[b] = load4(vs + (tc + 16 * b) * kLd + d);
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        sc[a][b] = dot4(qa[a], kb[b], sc[a][b]);
        dp[a][b] = dot4(oa[a], vb[b], dp[a][b]);
      }
  }
  const float scale = p.sm_scale * kLog2e;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int rl = tr * 4 + a;
    const int row = q0 + rl;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const float pv = kept(p, row, k0 + tc + 16 * b, kWin)
          ? exp2f(fmaf(sc[a][b], scale, -lse_s[rl])) : 0.0f;
      pr[a][b] = pv;
      ds[a][b] = pv * (dp[a][b] - delta_s[rl]);
    }
  }
}

// the tile's rows' logsumexp (log2 units) and D into shared memory
__device__ __forceinline__ void load_rows(float* lse_s, float* delta_s,
                                          const BwdParams& p, long long base,
                                          int q0) {
  for (int r = threadIdx.x; r < kRows; r += blockDim.x) {
    const bool in = q0 + r < p.seq;
    lse_s[r] = in ? p.lse[base + q0 + r] * kLog2e : 0.0f;
    delta_s[r] = in ? p.delta[base + q0 + r] : 0.0f;
  }
}

template <int D>
constexpr int bwd_smem_bytes() {
  return (4 * kRows * (D + 4) + 2 * kRows * kLdP + 2 * kRows) * 4;
}

// D = rowsum(dO * O), one warp a row; rows (b, h, s) in (B, H, S) order
template <typename T>
__global__ void bwd_delta_kernel(const BwdParams p, int head_dim,
                                 long long n_rows) {
  const long long row = static_cast<long long>(blockIdx.x) * (blockDim.x / 32)
                        + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= n_rows) return;
  const long long s = row % p.seq;
  const long long bh = row / p.seq;
  const long long h = bh % p.n_heads;
  const long long b = bh / p.n_heads;
  const long long off = ((b * p.seq + s) * p.n_heads + h) * head_dim;
  const T* o = static_cast<const T*>(p.o) + off;
  const T* g = static_cast<const T*>(p.dout) + off;
  float acc = 0.0f;
  for (int c = lane * 4; c < head_dim; c += 128) {
    const float4 x = load4(o + c);
    const float4 y = load4(g + c);
    acc = dot4(x, y, acc);
  }
#pragma unroll
  for (int w = 16; w > 0; w /= 2)
    acc += __shfl_xor_sync(0xffffffffu, acc, w);
  if (lane == 0) p.delta[row] = acc;
}

// dK and dV of one (batch, KV head, key tile), summed over the group's
// query heads and the query tiles that see the keys
template <int D, bool kWin>
__global__ void __launch_bounds__(kThreads, 1)
bwd_dkdv_kernel(const BwdParams p) {
  constexpr int kLd = D + 4;
  constexpr int DC = D / 16;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* dos = qs + kRows * kLd;
  float* ks = dos + kRows * kLd;
  float* vs = ks + kKeys * kLd;
  float* ps = vs + kKeys * kLd;              // P, [row][key]
  float* dss = ps + kRows * kLdP;            // dS, [row][key]
  float* lse_s = dss + kRows * kLdP;
  float* delta_s = lse_s + kRows;

  const int j = blockIdx.x;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int k0 = j * kKeys;
  const int n_qt = (p.seq + kRows - 1) / kRows;
  // query tiles that see a key of this tile
  const int i_lo = p.causal ? k0 / kRows : 0;
  int i_hi = n_qt;
  if constexpr (kWin)
    i_hi = min(n_qt, (k0 + kKeys - 1 + p.window - 1) / kRows + 1);
  const int kg = threadIdx.x / 16;           // keys 4 kg .. 4 kg + 3
  const int tc = threadIdx.x % 16;

  load_tile<D>(ks, static_cast<const float*>(p.k) + b * p.k_sb + kvh * p.k_sh,
               p.k_ss, k0, p.seq);
  load_tile<D>(vs, static_cast<const float*>(p.v) + b * p.v_sb + kvh * p.v_sh,
               p.v_ss, k0, p.seq);

  float dk[4][DC], dv[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) dk[i][c] = dv[i][c] = 0.0f;

  for (int hh = 0; hh < p.group; ++hh) {
    const int h = kvh * p.group + hh;
    const long long hrows = (static_cast<long long>(b) * p.n_heads + h)
                            * p.seq;
    const float* qg = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
    const long long o_ss = static_cast<long long>(p.n_heads) * D;
    const float* dog = static_cast<const float*>(p.dout)
        + static_cast<long long>(b) * p.seq * o_ss
        + static_cast<long long>(h) * D;
    for (int i = i_lo; i < i_hi; ++i) {
      const int q0 = i * kRows;
      __syncthreads();          // the previous tile's readers are done
      load_tile<D>(qs, qg, p.q_ss, q0, p.seq);
      load_tile<D>(dos, dog, o_ss, q0, p.seq);
      load_rows(lse_s, delta_s, p, hrows, q0);
      __syncthreads();
      float pr[4][4], ds[4][4];
      tile_p_ds<D, kWin>(qs, dos, ks, vs, lse_s, delta_s, q0, k0, p, pr,
                         ds);
      const int tr = threadIdx.x / 16;
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int bb = 0; bb < 4; ++bb) {
          ps[(tr * 4 + a) * kLdP + tc + 16 * bb] = pr[a][bb];
          dss[(tr * 4 + a) * kLdP + tc + 16 * bb] = ds[a][bb];
        }
      __syncthreads();
      // dV += P^float dO and dK += dS^float Q over the tile's rows
#pragma unroll 2
      for (int r = 0; r < kRows; ++r) {
        const float4 p4 = load4(ps + r * kLdP + kg * 4);
        const float4 s4 = load4(dss + r * kLdP + kg * 4);
        const float pk[4] = {p4.x, p4.y, p4.z, p4.w};
        const float sk[4] = {s4.x, s4.y, s4.z, s4.w};
        float ov[DC], qv[DC];
        if constexpr (DC >= 4) {
#pragma unroll
          for (int c = 0; c < DC; c += 4) {
            const float4 o4 = load4(dos + r * kLd + out_col<D>(tc, c));
            const float4 q4 = load4(qs + r * kLd + out_col<D>(tc, c));
            ov[c] = o4.x; ov[c + 1] = o4.y; ov[c + 2] = o4.z; ov[c + 3] = o4.w;
            qv[c] = q4.x; qv[c + 1] = q4.y; qv[c + 2] = q4.z; qv[c + 3] = q4.w;
          }
        } else {
#pragma unroll
          for (int c = 0; c < DC; ++c) {
            ov[c] = dos[r * kLd + out_col<D>(tc, c)];
            qv[c] = qs[r * kLd + out_col<D>(tc, c)];
          }
        }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int c = 0; c < DC; ++c) {
            dv[kk][c] = fmaf(pk[kk], ov[c], dv[kk][c]);
            dk[kk][c] = fmaf(sk[kk], qv[c], dk[kk][c]);
          }
      }
    }
  }

  // dk (times scale) and dv, keys past S not written
  const int n_kv = p.n_heads / p.group;
  float* dkg = static_cast<float*>(p.dk);
  float* dvg = static_cast<float*>(p.dv);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int key = k0 + kg * 4 + kk;
    if (key >= p.seq) continue;
    const long long off = ((static_cast<long long>(b) * p.seq + key) * n_kv
                           + kvh) * D;
    if constexpr (DC >= 4) {
#pragma unroll
      for (int c = 0; c < DC; c += 4) {
        const int col = out_col<D>(tc, c);
        store4(dkg + off + col,
               make_float4(dk[kk][c] * p.sm_scale, dk[kk][c + 1] * p.sm_scale,
                           dk[kk][c + 2] * p.sm_scale,
                           dk[kk][c + 3] * p.sm_scale));
        store4(dvg + off + col, make_float4(dv[kk][c], dv[kk][c + 1],
                                            dv[kk][c + 2], dv[kk][c + 3]));
      }
    } else {
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        dkg[off + out_col<D>(tc, c)] = dk[kk][c] * p.sm_scale;
        dvg[off + out_col<D>(tc, c)] = dv[kk][c];
      }
    }
  }
}

// dQ of one (batch, head, query tile) over the key tiles its rows see
template <int D, bool kWin>
__global__ void __launch_bounds__(kThreads, 1)
bwd_dq_kernel(const BwdParams p) {
  constexpr int kLd = D + 4;
  constexpr int DC = D / 16;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* dos = qs + kRows * kLd;
  float* ks = dos + kRows * kLd;
  float* vs = ks + kKeys * kLd;
  float* dst = vs + kKeys * kLd + kRows * kLdP;   // dS^float, [key][row]
  float* lse_s = dst + kRows * kLdP;
  float* delta_s = lse_s + kRows;

  const int n_qt = (p.seq + kRows - 1) / kRows;
  const int n_kt = (p.seq + kKeys - 1) / kKeys;
  const int i = n_qt - 1 - static_cast<int>(blockIdx.x);  // long first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / p.group;
  const int q0 = i * kRows;
  const int j_hi = p.causal ? min(n_kt, (q0 + kRows - 1) / kKeys + 1)
                            : n_kt;
  int j_lo = 0;
  if constexpr (kWin) j_lo = max(0, q0 - p.window + 1) / kKeys;
  const int rg = threadIdx.x / 16;           // rows 4 rg .. 4 rg + 3
  const int tc = threadIdx.x % 16;
  const long long o_ss = static_cast<long long>(p.n_heads) * D;

  load_tile<D>(qs, static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh,
               p.q_ss, q0, p.seq);
  load_tile<D>(dos, static_cast<const float*>(p.dout)
                        + static_cast<long long>(b) * p.seq * o_ss
                        + static_cast<long long>(h) * D,
               o_ss, q0, p.seq);
  load_rows(lse_s, delta_s, p,
            (static_cast<long long>(b) * p.n_heads + h) * p.seq, q0);
  const float* kg = static_cast<const float*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const float* vg = static_cast<const float*>(p.v) + b * p.v_sb + kvh * p.v_sh;

  float dq[4][DC];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < DC; ++c) dq[a][c] = 0.0f;

  for (int j = j_lo; j < j_hi; ++j) {
    const int k0 = j * kKeys;
    __syncthreads();            // the previous tile's readers are done
    load_tile<D>(ks, kg, p.k_ss, k0, p.seq);
    load_tile<D>(vs, vg, p.v_ss, k0, p.seq);
    __syncthreads();
    float pr[4][4], ds[4][4];
    tile_p_ds<D, kWin>(qs, dos, ks, vs, lse_s, delta_s, q0, k0, p, pr, ds);
    const int tr = threadIdx.x / 16;
#pragma unroll
    for (int bb = 0; bb < 4; ++bb)
      store4(dst + (tc + 16 * bb) * kLdP + tr * 4,
             make_float4(ds[0][bb], ds[1][bb], ds[2][bb], ds[3][bb]));
    __syncthreads();
    // dQ += dS K over the tile's keys
#pragma unroll 2
    for (int c = 0; c < kKeys; ++c) {
      const float4 s4 = load4(dst + c * kLdP + rg * 4);
      const float sr[4] = {s4.x, s4.y, s4.z, s4.w};
      float kv[DC];
      if constexpr (DC >= 4) {
#pragma unroll
        for (int x = 0; x < DC; x += 4) {
          const float4 k4 = load4(ks + c * kLd + out_col<D>(tc, x));
          kv[x] = k4.x; kv[x + 1] = k4.y; kv[x + 2] = k4.z; kv[x + 3] = k4.w;
        }
      } else {
#pragma unroll
        for (int x = 0; x < DC; ++x) kv[x] = ks[c * kLd + out_col<D>(tc, x)];
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int x = 0; x < DC; ++x) dq[a][x] = fmaf(sr[a], kv[x], dq[a][x]);
    }
  }

  float* dqg = static_cast<float*>(p.dq);
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int row = q0 + rg * 4 + a;
    if (row >= p.seq) continue;
    const long long off = ((static_cast<long long>(b) * p.seq + row)
                           * p.n_heads + h) * D;
    if constexpr (DC >= 4) {
#pragma unroll
      for (int x = 0; x < DC; x += 4)
        store4(dqg + off + out_col<D>(tc, x),
               make_float4(dq[a][x] * p.sm_scale, dq[a][x + 1] * p.sm_scale,
                           dq[a][x + 2] * p.sm_scale,
                           dq[a][x + 3] * p.sm_scale));
    } else {
#pragma unroll
      for (int x = 0; x < DC; ++x)
        dqg[off + out_col<D>(tc, x)] = dq[a][x] * p.sm_scale;
    }
  }
}


// ---------------------------------------------------------------------------
// bfloat16 route: wgmma + TMA, warp-specialised
// ---------------------------------------------------------------------------

constexpr int kWgmmaThreads = 3 * kWgThreads;  // a producer, two consumers
constexpr int kBlockKeys = 128;   // dK/dV: keys a block, 64 a consumer
constexpr int kStepRows = 64;     // dK/dV: query rows a ring stage
constexpr int kBlockRows = 128;   // dQ: query rows a block, 64 a consumer
constexpr int kStepKeys = 128;    // dQ: keys a ring stage
constexpr int kRing = 2;          // stages of each ring
constexpr int kLseWarpLanes = 32; // the producer warp that copies lse and D

// bytes of a bf16 tile of ROWS rows and D columns: D / 64 boxes of ROWS
// rows of 128 bytes
template <int D, int ROWS>
__host__ __device__ constexpr int tile_bytes() {
  return (D / kBoxCols) * ROWS * 128;
}

// shared memory of a dK/dV block: the K and V tiles, kRing stages of Q,
// dO and their rows' lse and D, the barriers, the alignment slack
template <int D>
constexpr int dkdv_smem_bytes() {
  return 2 * tile_bytes<D, kBlockKeys>()
       + kRing * (2 * tile_bytes<D, kStepRows>() + 2 * kStepRows * 4)
       + (1 + 2 * kRing) * 8 + kSwizzleAtom;
}

// shared memory of a dQ block: the Q and dO tiles, kRing stages of K and
// V, the barriers, the alignment slack
template <int D>
constexpr int dq_smem_bytes() {
  return 2 * tile_bytes<D, kBlockRows>()
       + kRing * 2 * tile_bytes<D, kStepKeys>()
       + (1 + 3 * kRing) * 8 + kSwizzleAtom;
}

// the first 1024-byte aligned shared address of the dynamic shared memory
__device__ __forceinline__ uint32_t aligned_base(const unsigned char* raw) {
  return (smem_addr(raw) + kSwizzleAtom - 1)
         & ~static_cast<uint32_t>(kSwizzleAtom - 1);
}

// TMA copies of a tile of ROWS rows from row r0 (D / 64 boxes, ROWS the
// tensor map's box height)
template <int D, int ROWS>
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int r0, int head,
                                         int b) {
#pragma unroll
  for (int x = 0; x < D / kBoxCols; ++x)
    tma_load(dst + x * ROWS * 128, map, bar, x * kBoxCols, r0, head, b);
}

// dK and dV of one (batch, KV head, 128-key tile): consumer warpgroup c
// owns keys 64 c .. 64 c + 63 of the tile.  The ring walks the group's
// query heads and, for each, the 64-row query tiles that see the tile's
// keys; per stage S^T = K Q^T and dP^T = V dO^T (wgmma, both operands in
// shared memory, K-major), P^T and dS^T in registers, rounded to bf16 as
// the A operands of dV += P^T dO and dK += dS^T Q (B MN-major)
template <int D, bool kWin>
__global__ void __launch_bounds__(kWgmmaThreads, 1)
bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tdo,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const BwdParams p) {
  constexpr int kKVBox = kBlockKeys * 128;           // bytes of a K / V box
  constexpr int kKVBytes = tile_bytes<D, kBlockKeys>();
  constexpr int kQBox = kStepRows * 128;             // of a Q / dO box
  constexpr int kQBytes = tile_bytes<D, kStepRows>();
  constexpr int kSteps = D / 16;                     // k-steps over dh
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t base = aligned_base(smem_raw);
  const uint32_t k_s = base;
  const uint32_t v_s = k_s + kKVBytes;
  const uint32_t q_s = v_s + kKVBytes;               // + stage * kQBytes
  const uint32_t do_s = q_s + kRing * kQBytes;
  const uint32_t rows_s = do_s + kRing * kQBytes;    // lse (log2), D
  const uint32_t kv_full = rows_s + kRing * 2 * kStepRows * 4;
  const uint32_t full = kv_full + 8;                 // + 8 * stage
  const uint32_t empty = full + 8 * kRing;
  float* rows_p = reinterpret_cast<float*>(smem_raw + (rows_s
                                                       - smem_addr(smem_raw)));

  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int k0 = blockIdx.z * kBlockKeys;  // tile 0 (causal: the longest)
  const int n_qt = (p.seq + kStepRows - 1) / kStepRows;
  // the query tiles that see a key of the tile
  const int i_lo = p.causal ? k0 / kStepRows : 0;
  int i_hi = n_qt;
  if constexpr (kWin)
    i_hi = min(n_qt, (k0 + kBlockKeys - 2 + p.window) / kStepRows + 1);
  const int n_steps = p.group * (i_hi - i_lo);
  const int wg = threadIdx.x / kWgThreads;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kRing; ++s) {
      mbar_init(full + 8 * s, 1 + kLseWarpLanes);   // TMA, lse / D copies
      mbar_init(empty + 8 * s, 2 * kWgThreads / 32);  // consumer warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 :: "n"(kProducerRegs));
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    if (warp == 0 && lane == 0) {
      // warp 0: the K and V tiles once, then Q and dO through the ring
      mbar_expect_tx(kv_full, 2 * kKVBytes);
      tma_tile<D, 128>(k_s, &tk, kv_full, k0, kvh, b);
      tma_tile<D, 128>(v_s, &tv, kv_full, k0, kvh, b);
      int h = kvh * p.group, i = i_lo;
      for (int n = 0; n < n_steps; ++n) {
        const int s = n % kRing;
        mbar_wait(empty + 8 * s, ((n / kRing) & 1) ^ 1);
        mbar_expect_tx(full + 8 * s, 2 * kQBytes);
        tma_tile<D, 64>(q_s + s * kQBytes, &tq, full + 8 * s, i * kStepRows,
                       h, b);
        tma_tile<D, 64>(do_s + s * kQBytes, &tdo, full + 8 * s,
                       i * kStepRows, h, b);
        if (++i == i_hi) { i = i_lo; ++h; }
      }
    } else if (warp == 1) {
      // warp 1: the stage's rows' logsumexp (log2 units) and D; 0 past S
      int h = kvh * p.group, i = i_lo;
      for (int n = 0; n < n_steps; ++n) {
        const int s = n % kRing;
        mbar_wait(empty + 8 * s, ((n / kRing) & 1) ^ 1);
        const long long hrows = (static_cast<long long>(b) * p.n_heads + h)
                                * p.seq;
        float* rs = rows_p + s * 2 * kStepRows;
        for (int r = lane; r < kStepRows; r += 32) {
          const int row = i * kStepRows + r;
          const bool in = row < p.seq;
          rs[r] = in ? p.lse[hrows + row] * kLog2e : 0.0f;
          rs[kStepRows + r] = in ? p.delta[hrows + row] : 0.0f;
        }
        mbar_arrive(full + 8 * s);
        if (++i == i_hi) { i = i_lo; ++h; }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
                 :: "n"(kConsumerRegs));
    const int c = wg - 1;
    const int tid = threadIdx.x - wg * kWgThreads;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int g = lane >> 2;
    const int t = lane & 3;
    const int kw0 = k0 + 64 * c;               // this warpgroup's keys
    const int key_a = kw0 + 16 * warp + g;     // rows g and g + 8 of S^T
    const int key_b = key_a + 8;
    const float scale = p.sm_scale * kLog2e;
    const uint32_t k_rows = k_s + c * 64 * 128;
    const uint32_t v_rows = v_s + c * 64 * 128;

    float dk[D / 2], dv[D / 2];                // D / 8 n8-blocks x 4
#pragma unroll
    for (int x = 0; x < D / 2; ++x) dk[x] = dv[x] = 0.0f;
    float st[32], dpt[32];                     // S^T, dP^T: 8 n8-blocks x 4
#pragma unroll
    for (int x = 0; x < 32; ++x) st[x] = dpt[x] = 0.0f;
    uint32_t pa[4][4], sa[4][4];               // P^T, dS^T in bf16

    mbar_wait(kv_full, 0);
    int i = i_lo;
    for (int n = 0; n < n_steps; ++n) {
      const int s = n % kRing;
      const int q0 = i * kStepRows;
      if (++i == i_hi) i = i_lo;
      mbar_wait(full + 8 * s, (n / kRing) & 1);
      // whether no row of the stage sees a key of this warpgroup
      bool none = kw0 >= p.seq || (p.causal && q0 + kStepRows - 1 < kw0);
      if constexpr (kWin) none = none || q0 - (kw0 + 63) >= p.window;
      if (!none) {
        const uint32_t qs = q_s + s * kQBytes;
        const uint32_t dos = do_s + s * kQBytes;
        // S^T = K Q^T and dP^T = V dO^T, two groups of products
        fence_regs(st);
        fence_regs(dpt);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kSteps; ++kk)
          wgmma_ss_n64(st, smem_desc(k_rows + (kk / 4) * kKVBox + (kk % 4) * 32,
                                     16, kSwizzleAtom),
                       smem_desc(qs + (kk / 4) * kQBox + (kk % 4) * 32, 16,
                                 kSwizzleAtom), kk > 0);
        wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < kSteps; ++kk)
          wgmma_ss_n64(dpt, smem_desc(v_rows + (kk / 4) * kKVBox + (kk % 4) * 32,
                                      16, kSwizzleAtom),
                       smem_desc(dos + (kk / 4) * kQBox + (kk % 4) * 32, 16,
                                 kSwizzleAtom), kk > 0);
        wgmma_commit();
        wgmma_wait<1>();                       // S^T; dP^T runs on
        fence_regs(st);

        // P^T = exp2(S^T scale - lse); element e of n8-block nt: key key_a
        // (key_b for e >= 2), query q0 + 8 nt + 2 t (+ 1 for odd e);
        // masked entries 0
        bool edge = kw0 + 64 > p.seq || q0 + kStepRows > p.seq
                    || (p.causal && q0 < kw0 + 63);
        if constexpr (kWin) edge = edge || q0 + kStepRows - 1 - kw0 >= p.window;
        const float* rs = rows_p + s * 2 * kStepRows;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const float2 l2 = *reinterpret_cast<const float2*>(rs + 8 * nt
                                                             + 2 * t);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float pv = fast_exp2(fmaf(st[4 * nt + e], scale,
                                      -((e & 1) ? l2.y : l2.x)));
            if (edge) {
              const int row = q0 + 8 * nt + 2 * t + (e & 1);
              const int key = e < 2 ? key_a : key_b;
              bool keep = row < p.seq && key < p.seq
                          && !(p.causal && key > row);
              if constexpr (kWin) keep = keep && row - key < p.window;
              if (!keep) pv = 0.0f;
            }
            st[4 * nt + e] = pv;
          }
        }
        wgmma_wait<0>();                       // dP^T
        fence_regs(dpt);

        // dS^T = P^T (dP^T - D)
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const float2 d2 = *reinterpret_cast<const float2*>(
              rs + kStepRows + 8 * nt + 2 * t);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            dpt[4 * nt + e] = st[4 * nt + e]
                * (dpt[4 * nt + e] - ((e & 1) ? d2.y : d2.x));
        }
        pack_a<4>(st, pa);
        pack_a<4>(dpt, sa);

        // dV += P^T dO and dK += dS^T Q over the stage's 64 query rows
        fence_regs(dv);
        fence_regs(dk);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          wgmma_pv<D>(dv, pa[kk], smem_desc(dos + kk * 16 * 128, kQBox,
                                            kSwizzleAtom));
          wgmma_pv<D>(dk, sa[kk], smem_desc(qs + kk * 16 * 128, kQBox,
                                            kSwizzleAtom));
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dv);
        fence_regs(dk);
      }
      // this warp is done with the stage
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * s);
    }

    // dk (times scale) and dv, keys past S not written
    const int n_kv = p.n_heads / p.group;
    bf16* dkg = static_cast<bf16*>(p.dk);
    bf16* dvg = static_cast<bf16*>(p.dv);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = r ? key_b : key_a;
      if (key >= p.seq) continue;
      const long long off = ((static_cast<long long>(b) * p.seq + key) * n_kv
                             + kvh) * D + 2 * t;
#pragma unroll
      for (int x = 0; x < D / 8; ++x) {
        *reinterpret_cast<uint32_t*>(dkg + off + 8 * x) = pack_bf16(
            dk[4 * x + 2 * r] * p.sm_scale, dk[4 * x + 2 * r + 1] * p.sm_scale);
        *reinterpret_cast<uint32_t*>(dvg + off + 8 * x) =
            pack_bf16(dv[4 * x + 2 * r], dv[4 * x + 2 * r + 1]);
      }
    }
  }
}

// dQ of one (batch, head, 128-row query tile): consumer warpgroup c owns
// rows 64 c .. 64 c + 63.  The ring walks the KV tiles of 128 keys the
// rows see; per stage S = Q K^T and dP = dO V^T (wgmma, shared-memory
// operands, K-major), dS in registers, rounded to bf16 as the A operand
// of dQ += dS K (K MN-major)
template <int D, bool kWin>
__global__ void __launch_bounds__(kWgmmaThreads, 1)
bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tdo,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const BwdParams p) {
  constexpr int kBox = 128 * 128;                    // bytes of a box
  constexpr int kTileBytes = tile_bytes<D, 128>();
  constexpr int kSteps = D / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t base = aligned_base(smem_raw);
  const uint32_t q_s = base;
  const uint32_t do_s = q_s + kTileBytes;
  const uint32_t k_s = do_s + kTileBytes;            // + stage * kTileBytes
  const uint32_t v_s = k_s + kRing * kTileBytes;
  const uint32_t q_full = v_s + kRing * kTileBytes;
  const uint32_t k_full = q_full + 8;                // + 8 * stage
  const uint32_t v_full = k_full + 8 * kRing;
  const uint32_t empty = v_full + 8 * kRing;

  const int n_qt = (p.seq + kBlockRows - 1) / kBlockRows;
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.z);  // long first
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int kvh = h / p.group;
  const int q0 = qt * kBlockRows;
  const int n_kv = p.causal ? qt + 1 : n_qt;       // 128-key tiles
  int j0 = 0;                                      // the loop's first
  if constexpr (kWin) j0 = max(0, q0 - p.window + 1) / kStepKeys;
  const int wg = threadIdx.x / kWgThreads;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kRing; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(empty + 8 * s, 2 * kWgThreads / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 :: "n"(kProducerRegs));
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, 2 * kTileBytes);
      tma_tile<D, 128>(q_s, &tq, q_full, q0, h, b);
      tma_tile<D, 128>(do_s, &tdo, q_full, q0, h, b);
      for (int j = j0; j < n_kv; ++j) {
        const int s = (j - j0) % kRing;
        mbar_wait(empty + 8 * s, (((j - j0) / kRing) & 1) ^ 1);
        mbar_expect_tx(k_full + 8 * s, kTileBytes);
        tma_tile<D, 128>(k_s + s * kTileBytes, &tk, k_full + 8 * s,
                        j * kStepKeys, kvh, b);
        mbar_expect_tx(v_full + 8 * s, kTileBytes);
        tma_tile<D, 128>(v_s + s * kTileBytes, &tv, v_full + 8 * s,
                        j * kStepKeys, kvh, b);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
                 :: "n"(kConsumerRegs));
    const int c = wg - 1;
    const int tid = threadIdx.x - wg * kWgThreads;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int g = lane >> 2;
    const int t = lane & 3;
    const int qw0 = q0 + 64 * c;               // this warpgroup's rows
    const int row_a = qw0 + 16 * warp + g;
    const int row_b = row_a + 8;
    const float scale = p.sm_scale * kLog2e;
    // the rows' logsumexp (log2 units) and D
    const long long hrows = (static_cast<long long>(b) * p.n_heads + h)
                            * p.seq;
    float lse2[2], dl[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r ? row_b : row_a;
      lse2[r] = row < p.seq ? p.lse[hrows + row] * kLog2e : 0.0f;
      dl[r] = row < p.seq ? p.delta[hrows + row] : 0.0f;
    }
    const uint32_t q_rows = q_s + c * 64 * 128;
    const uint32_t do_rows = do_s + c * 64 * 128;

    float dq[D / 2];
#pragma unroll
    for (int x = 0; x < D / 2; ++x) dq[x] = 0.0f;
    float sc[64], dp[64];                      // S, dP: 16 n8-blocks x 4
#pragma unroll
    for (int x = 0; x < 64; ++x) sc[x] = dp[x] = 0.0f;
    uint32_t sa[8][4];                         // dS in bf16

    mbar_wait(q_full, 0);
    for (int j = j0; j < n_kv; ++j) {
      const int s = (j - j0) % kRing;
      const uint32_t parity = ((j - j0) / kRing) & 1;
      const int kt0 = j * kStepKeys;
      const uint32_t ks = k_s + s * kTileBytes;
      const uint32_t vs = v_s + s * kTileBytes;
      bool none = qw0 >= p.seq || (p.causal && kt0 > qw0 + 63);
      if constexpr (kWin)
        none = none || qw0 - (kt0 + kStepKeys - 1) >= p.window;
      mbar_wait(k_full + 8 * s, parity);
      if (!none) {
        // S = Q K^T, then dP = dO V^T once V has landed
        fence_regs(sc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kSteps; ++kk) {
          const uint32_t off = (kk / 4) * kBox + (kk % 4) * 32;
          wgmma_ss_n128(sc, smem_desc(q_rows + off, 16, kSwizzleAtom),
                        smem_desc(ks + off, 16, kSwizzleAtom), kk > 0);
        }
        wgmma_commit();
      }
      mbar_wait(v_full + 8 * s, parity);
      if (!none) {
        fence_regs(dp);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kSteps; ++kk) {
          const uint32_t off = (kk / 4) * kBox + (kk % 4) * 32;
          wgmma_ss_n128(dp, smem_desc(do_rows + off, 16, kSwizzleAtom),
                        smem_desc(vs + off, 16, kSwizzleAtom), kk > 0);
        }
        wgmma_commit();
        wgmma_wait<1>();                       // S; dP runs on
        fence_regs(sc);

        // P = exp2(S scale - lse); element e of n8-block nt: row row_a
        // (row_b for e >= 2), key kt0 + 8 nt + 2 t (+ 1 for odd e); masked
        // entries 0
        bool edge = kt0 + kStepKeys > p.seq || qw0 + 64 > p.seq
                    || (p.causal && kt0 + kStepKeys - 1 > qw0);
        if constexpr (kWin) edge = edge || qw0 + 63 - kt0 >= p.window;
#pragma unroll
        for (int nt = 0; nt < 16; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e >> 1;
            float pv = fast_exp2(fmaf(sc[4 * nt + e], scale, -lse2[r]));
            if (edge) {
              const int row = r ? row_b : row_a;
              const int key = kt0 + 8 * nt + 2 * t + (e & 1);
              bool keep = row < p.seq && key < p.seq
                          && !(p.causal && key > row);
              if constexpr (kWin) keep = keep && row - key < p.window;
              if (!keep) pv = 0.0f;
            }
            sc[4 * nt + e] = pv;
          }
        }
        wgmma_wait<0>();                       // dP
        fence_regs(dp);
        // dS = P (dP - D)
#pragma unroll
        for (int x = 0; x < 64; ++x) dp[x] = sc[x] * (dp[x] - dl[(x >> 1) & 1]);
        pack_a<8>(dp, sa);

        // dQ += dS K over the stage's 128 keys
        fence_regs(dq);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 8; ++kk)
          wgmma_pv<D>(dq, sa[kk], smem_desc(ks + kk * 16 * 128, kBox,
                                            kSwizzleAtom));
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dq);
      }
      // this warp is done with the stage
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * s);
    }

    bf16* dqg = static_cast<bf16*>(p.dq);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r ? row_b : row_a;
      if (row >= p.seq) continue;
      const long long off = ((static_cast<long long>(b) * p.seq + row)
                             * p.n_heads + h) * D + 2 * t;
#pragma unroll
      for (int x = 0; x < D / 8; ++x)
        *reinterpret_cast<uint32_t*>(dqg + off + 8 * x) = pack_bf16(
            dq[4 * x + 2 * r] * p.sm_scale, dq[4 * x + 2 * r + 1] * p.sm_scale);
    }
  }
}

// the float32 route's dK/dV and dQ kernels: their shared memory, and a
// launch
template <int smem>
int launch_pair(void (*dkdv)(BwdParams), void (*dq)(BwdParams), int threads,
                const BwdParams& p, int batch, int n_kv_heads,
                cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(dq, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_kt = (p.seq + kKeys - 1) / kKeys;
  const int n_qt = (p.seq + kRows - 1) / kRows;
  dkdv<<<dim3(n_kt, n_kv_heads, batch), threads, smem, stream>>>(p);
  dq<<<dim3(n_qt, p.n_heads, batch), threads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// the bfloat16 route's dK/dV and dQ kernels: the tensor maps (q, k, v
// through their strides, the contiguous dO), their shared memory, and a
// launch; a map the driver refuses returns minus its CUresult
template <int D, bool kWin>
int launch_wgmma(const BwdParams& p, int batch, int n_kv_heads,
                 cudaStream_t stream) {
  const long long o_ss = static_cast<long long>(p.n_heads) * D;
  CUtensorMap q64, do64, q128, do128, k128, v128;
  CUresult res = encode_map(&q64, p.q, D, p.seq, p.n_heads, batch, p.q_ss,
                            p.q_sh, p.q_sb, kStepRows);
  if (res == CUDA_SUCCESS)
    res = encode_map(&do64, p.dout, D, p.seq, p.n_heads, batch, o_ss, D,
                     o_ss * p.seq, kStepRows);
  if (res == CUDA_SUCCESS)
    res = encode_map(&q128, p.q, D, p.seq, p.n_heads, batch, p.q_ss, p.q_sh,
                     p.q_sb, kBlockRows);
  if (res == CUDA_SUCCESS)
    res = encode_map(&do128, p.dout, D, p.seq, p.n_heads, batch, o_ss, D,
                     o_ss * p.seq, kBlockRows);
  if (res == CUDA_SUCCESS)
    res = encode_map(&k128, p.k, D, p.seq, n_kv_heads, batch, p.k_ss, p.k_sh,
                     p.k_sb, kBlockKeys);
  if (res == CUDA_SUCCESS)
    res = encode_map(&v128, p.v, D, p.seq, n_kv_heads, batch, p.v_ss, p.v_sh,
                     p.v_sb, kBlockKeys);
  if (res != CUDA_SUCCESS) return -static_cast<int>(res);
  constexpr int smem_kv = dkdv_smem_bytes<D>();
  constexpr int smem_q = dq_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      bwd_dkdv_wgmma_kernel<D, kWin>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem_kv);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(bwd_dq_wgmma_kernel<D, kWin>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_q);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_kt = (p.seq + kBlockKeys - 1) / kBlockKeys;
  const int n_qt = (p.seq + kBlockRows - 1) / kBlockRows;
  if (n_kt > 65535 || n_qt > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  bwd_dkdv_wgmma_kernel<D, kWin>
      <<<dim3(n_kv_heads, batch, n_kt), kWgmmaThreads, smem_kv, stream>>>(
          q64, do64, k128, v128, p);
  bwd_dq_wgmma_kernel<D, kWin>
      <<<dim3(p.n_heads, batch, n_qt), kWgmmaThreads, smem_q, stream>>>(
          q128, do128, k128, v128, p);
  return static_cast<int>(cudaGetLastError());
}

// the row pass, then the dK/dV and dQ kernels: wgmma for bfloat16,
// scalar FMAs for float32
template <int D, bool kWin, typename T>
int launch_bwd(const BwdParams& p, int batch, int n_kv_heads,
               cudaStream_t stream) {
  if (batch > 65535 || p.n_heads > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n_rows = static_cast<long long>(batch) * p.n_heads * p.seq;
  const int warps = kThreads / 32;
  bwd_delta_kernel<T><<<static_cast<unsigned>((n_rows + warps - 1) / warps),
                        kThreads, 0, stream>>>(p, D, n_rows);
  if constexpr (std::is_same<T, bf16>::value)
    return launch_wgmma<D, kWin>(p, batch, n_kv_heads, stream);
  else
    return launch_pair<bwd_smem_bytes<D>()>(
        bwd_dkdv_kernel<D, kWin>, bwd_dq_kernel<D, kWin>, kThreads, p,
        batch, n_kv_heads, stream);
}

template <bool kWin>
int launch_mode(const BwdParams& p, int batch, int n_kv_heads, int head_dim,
                int dtype, cudaStream_t s) {
  if (dtype == 1 && head_dim == 128)
    return launch_bwd<128, kWin, bf16>(p, batch, n_kv_heads, s);
  if (dtype == 1 && head_dim == 64)
    return launch_bwd<64, kWin, bf16>(p, batch, n_kv_heads, s);
  if (dtype == 0 && head_dim == 128)
    return launch_bwd<128, kWin, float>(p, batch, n_kv_heads, s);
  if (dtype == 0 && head_dim == 64)
    return launch_bwd<64, kWin, float>(p, batch, n_kv_heads, s);
  if (dtype == 0 && head_dim == 16)
    return launch_bwd<16, kWin, float>(p, batch, n_kv_heads, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  window: 0 none, else (causal only) the
// sliding window.  q, k, v in the model's layout through their strides
// (elements; dh contiguous); o, dout and dq contiguous (B, S, H, dh), dk
// and dv contiguous (B, S, KV, dh), lse and the delta scratch float32
// (B, H, S).  Returns a CUDA error code (0 = launched), or minus the
// CUresult of a tensor map that cuTensorMapEncodeTiled refused.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* delta, void* dq, void* dk,
    void* dv, long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    int batch, int seq, int n_heads, int n_kv_heads, int head_dim,
    int dtype, int causal, int window, float sm_scale, void* stream) {
  if (seq < 1 || batch < 1 || n_heads < 1 || n_kv_heads < 1
      || n_heads % n_kv_heads != 0 || window < 0 || (window > 0 && !causal))
    return static_cast<int>(cudaErrorInvalidValue);
  BwdParams p{q, k, v, o, dout, lse, delta, dq, dk, dv,
              q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
              seq, n_heads, n_heads / n_kv_heads, causal, sm_scale, window};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return window > 0
      ? launch_mode<true>(p, batch, n_kv_heads, head_dim, dtype, s)
      : launch_mode<false>(p, batch, n_kv_heads, head_dim, dtype, s);
}
