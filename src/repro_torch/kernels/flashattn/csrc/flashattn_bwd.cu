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
// in float32 whatever the inputs' type (bfloat16 inputs are widened as
// they are read; the results are rounded once, to the inputs' type).
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
// * a dK/dV kernel: one block a (batch, KV head, 64-key tile).  K and V
//   of the tile sit in shared memory; the block loops over the g query
//   heads of its KV head and, for each, over the 64-row query tiles that
//   can see its keys (from the diagonal to the end when causal, only the
//   tiles within `window` of it in the window mode), loading each Q and
//   dO tile, recomputing P and dS, and accumulating dV and dK in
//   registers.  GQA is a reduction inside the block: no atomics, no
//   repeated heads;
// * a dQ kernel: one block a (batch, head, 64-row query tile), which
//   loops over the KV tiles its rows see and accumulates dQ in
//   registers.  No atomics anywhere: two runs give the same bits.
//
// P and dS are recomputed in both (7 products of 64 x 64 x dh a tile
// pair, where FlashAttention-2 takes 5 and adds dQ with atomics).
//
// bfloat16 route (bwd_dkdv_mma_kernel, bwd_dq_mma_kernel): the products
// on the tensor cores with mma.sync.m16n8k16 (bf16 operands, float32
// sums), 4 warps a block, each 16 keys (dK/dV) or 16 query rows (dQ).
// The dK/dV kernel computes S^T = K Q^T and dP^T = V dO^T, so that P^T
// and dS^T come out in the accumulator layout, which is the A operand's
// of the next products: they are rounded to bf16 there (FlashAttention-
// 2's rounding; with the gradients' own rounding it keeps dq, dk, dv
// within 1e-2 of the float32 plain version in relative L2), and dV +=
// P^T dO, dK += dS^T Q (and the dQ kernel's dQ += dS K) read their B
// operand from the row-major tile transposed, with ldmatrix.trans.  Tiles
// are bf16 at a row stride of dh + 8 elements (rows 4 banks apart: the
// ldmatrix reads are conflict-free), 70 KB a block at dh 128, loaded with
// 16-byte copies and no overlap with the products.
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
// bound by operations.
//
// First version, simple and right: tiles loaded without overlap, no
// warp specialisation; the wgmma / TMA redesign is later work.  dh is
// 16, 64 or 128 in float32, 64 or 128 in bfloat16: the forward's table.
// The window mode is its own instantiation (kWin), as in the forward.
//
// Offsets are 64-bit.  The entry point returns cudaGetLastError() (or the
// error of raising a shared-memory limit); the caller raises on a
// non-zero code.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

#include <type_traits>

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
// bfloat16 route: mma.sync.m16n8k16 (bf16 operands, float32 sums)
// ---------------------------------------------------------------------------

constexpr int kMmaThreads = 128;  // 4 warps, 16 keys (or query rows) each

// four 8 x 8 bf16 matrices from shared memory, lane 8 m + i giving row i
// of matrix m; with kTrans each is read transposed
template <bool kTrans>
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  if constexpr (kTrans)
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
        "[%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a)
        : "memory");
  else
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a)
        : "memory");
}

// two floats as a bf16 pair, the first in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// d (16 x 8, float32) += a (16 x 16, bf16, row) b (16 x 8, bf16, col)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The fragments of a row-major bf16 tile of row stride ld (lane (g, t)
// of an A fragment holds rows g and g + 8 at columns 2t, 2t + 1 and 2t +
// 8, 2t + 9; of a B fragment, k = 2t, 2t + 1 (and + 8) at n = g), by
// ldmatrix, lane 8 m + i addressing row i of matrix m:
//
// the A fragment of rows r0 .. r0 + 15 and columns c0 .. c0 + 15
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* tile,
                                       int ld, int r0, int c0, int lane) {
  const int m = lane >> 3, i = lane & 7;
  ldsm_x4<false>(a, tile + (r0 + (m & 1) * 8 + i) * ld + c0 + (m >> 1) * 8);
}

// the B fragments (k 16, n 8) of n-blocks n0, n0 + 8 at k from c0, the
// tile holding n on its rows (B = the tile's rows transposed): b[0], b[1]
// of the first, b[2], b[3] of the second
__device__ __forceinline__ void load_b_rows(uint32_t (&b)[4],
                                            const bf16* tile, int ld, int n0,
                                            int c0, int lane) {
  const int m = lane >> 3, i = lane & 7;
  ldsm_x4<false>(b, tile + (n0 + (m >> 1) * 8 + i) * ld + c0 + (m & 1) * 8);
}

// the same with k on the tile's rows (B = the tile itself): k from r0, n
// from c0 and c0 + 8
__device__ __forceinline__ void load_b_cols(uint32_t (&b)[4],
                                            const bf16* tile, int ld, int r0,
                                            int c0, int lane) {
  const int m = lane >> 3, i = lane & 7;
  ldsm_x4<true>(b, tile + (r0 + (m & 1) * 8 + i) * ld + c0 + (m >> 1) * 8);
}

// 64 rows from r0 of a (seq, D) bf16 slab of row stride ss into shared
// memory at row stride D + 8; rows past seq land as zeros
template <int D>
__device__ __forceinline__ void load_tile_bf16(bf16* dst, const bf16* src,
                                               long long ss, int r0,
                                               int seq) {
  constexpr int kLd = D + 8;
  constexpr int kVec = D / 8;                     // 16-byte chunks a row
  for (int i = threadIdx.x; i < kRows * kVec; i += blockDim.x) {
    const int r = i / kVec;
    const int c = (i % kVec) * 8;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < seq)
      x = *reinterpret_cast<const uint4*>(src + (r0 + r) * ss + c);
    *reinterpret_cast<uint4*>(dst + r * kLd + c) = x;
  }
}

// (8 x 4 accumulators of two n8-blocks a k16 step) to the bf16 A
// fragments of the 4 k16 steps of 64
__device__ __forceinline__ void pack_a(const float (&c)[8][4],
                                       uint32_t (&a)[4][4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    a[k][0] = pack_bf16(c[2 * k][0], c[2 * k][1]);
    a[k][1] = pack_bf16(c[2 * k][2], c[2 * k][3]);
    a[k][2] = pack_bf16(c[2 * k + 1][0], c[2 * k + 1][1]);
    a[k][3] = pack_bf16(c[2 * k + 1][2], c[2 * k + 1][3]);
  }
}

// shared memory of an mma block: four 64-row bf16 tiles, the rows'
// logsumexp and D
template <int D>
constexpr int mma_smem_bytes() {
  return 4 * kRows * (D + 8) * 2 + 2 * kRows * 4;
}

// dK and dV of one (batch, KV head, key tile) on the tensor cores: warp w
// owns keys 16 w .. 16 w + 15 and computes S^T = K Q^T and dP^T = V dO^T
// (16 keys x 64 queries), P^T and dS^T in registers, rounded to bf16 as
// the A operands of dV += P^T dO and dK += dS^T Q (FlashAttention-2's
// rounding), whose B operands are dO and Q read transposed (ldmatrix)
template <int D, bool kWin>
__global__ void __launch_bounds__(kMmaThreads, 1)
bwd_dkdv_mma_kernel(const BwdParams p) {
  constexpr int kLd = D + 8;
  constexpr int NB = D / 8;                  // n8-blocks of dh
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* vs = ks + kKeys * kLd;
  bf16* qs = vs + kKeys * kLd;
  bf16* dos = qs + kRows * kLd;
  float* lse_s = reinterpret_cast<float*>(dos + kRows * kLd);
  float* delta_s = lse_s + kRows;

  const int j = blockIdx.x;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int k0 = j * kKeys;
  const int n_qt = (p.seq + kRows - 1) / kRows;
  const int i_lo = p.causal ? k0 / kRows : 0;
  int i_hi = n_qt;
  if constexpr (kWin)
    i_hi = min(n_qt, (k0 + kKeys - 1 + p.window - 1) / kRows + 1);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int key_a = k0 + 16 * warp + g;      // keys of c[0..1], c[2..3]
  const float scale = p.sm_scale * kLog2e;

  load_tile_bf16<D>(ks, static_cast<const bf16*>(p.k) + b * p.k_sb
                    + kvh * p.k_sh, p.k_ss, k0, p.seq);
  load_tile_bf16<D>(vs, static_cast<const bf16*>(p.v) + b * p.v_sb
                    + kvh * p.v_sh, p.v_ss, k0, p.seq);

  float dk[NB][4], dv[NB][4];
#pragma unroll
  for (int i = 0; i < NB; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[i][e] = dv[i][e] = 0.0f;

  for (int hh = 0; hh < p.group; ++hh) {
    const int h = kvh * p.group + hh;
    const long long hrows = (static_cast<long long>(b) * p.n_heads + h)
                            * p.seq;
    const long long o_ss = static_cast<long long>(p.n_heads) * D;
    const bf16* qg = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh;
    const bf16* dog = static_cast<const bf16*>(p.dout)
        + static_cast<long long>(b) * p.seq * o_ss
        + static_cast<long long>(h) * D;
    for (int i = i_lo; i < i_hi; ++i) {
      const int q0 = i * kRows;
      __syncthreads();          // the previous tile's readers are done
      load_tile_bf16<D>(qs, qg, p.q_ss, q0, p.seq);
      load_tile_bf16<D>(dos, dog, o_ss, q0, p.seq);
      load_rows(lse_s, delta_s, p, hrows, q0);
      __syncthreads();
      // S^T = K Q^T and dP^T = V dO^T: this warp's 16 keys x 64 queries
      float st[8][4], dpt[8][4];
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t ak[4], av[4];
        load_a(ak, ks, kLd, 16 * warp, 16 * kk, lane);
        load_a(av, vs, kLd, 16 * warp, 16 * kk, lane);
#pragma unroll
        for (int n = 0; n < 8; n += 2) {
          uint32_t bq[4], bo[4];
          load_b_rows(bq, qs, kLd, 8 * n, 16 * kk, lane);
          load_b_rows(bo, dos, kLd, 8 * n, 16 * kk, lane);
          mma_bf16(st[n], ak, bq[0], bq[1]);
          mma_bf16(st[n + 1], ak, bq[2], bq[3]);
          mma_bf16(dpt[n], av, bo[0], bo[1]);
          mma_bf16(dpt[n + 1], av, bo[2], bo[3]);
        }
      }
      // P^T and dS^T: element e of block n is key key_a (+ 8 for e >= 2),
      // query q0 + 8 n + 2 t (+ 1 for odd e)
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ql = 8 * n + 2 * t + (e & 1);
          const float pv = kept(p, q0 + ql, key_a + (e >> 1) * 8, kWin)
              ? exp2f(fmaf(st[n][e], scale, -lse_s[ql])) : 0.0f;
          st[n][e] = pv;
          dpt[n][e] = pv * (dpt[n][e] - delta_s[ql]);
        }
      uint32_t ap[4][4], as[4][4];
      pack_a(st, ap);
      pack_a(dpt, as);
      // dV += P^T dO and dK += dS^T Q (k: the tile's 64 queries)
#pragma unroll
      for (int d = 0; d < NB; d += 2) {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          uint32_t bo[4], bq[4];
          load_b_cols(bo, dos, kLd, 16 * k, 8 * d, lane);
          load_b_cols(bq, qs, kLd, 16 * k, 8 * d, lane);
          mma_bf16(dv[d], ap[k], bo[0], bo[1]);
          mma_bf16(dv[d + 1], ap[k], bo[2], bo[3]);
          mma_bf16(dk[d], as[k], bq[0], bq[1]);
          mma_bf16(dk[d + 1], as[k], bq[2], bq[3]);
        }
      }
    }
  }

  // dk (times scale) and dv, keys past S not written
  const int n_kv = p.n_heads / p.group;
  bf16* dkg = static_cast<bf16*>(p.dk);
  bf16* dvg = static_cast<bf16*>(p.dv);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key_a + 8 * r;
    if (key >= p.seq) continue;
    const long long off = ((static_cast<long long>(b) * p.seq + key) * n_kv
                           + kvh) * D + 2 * t;
#pragma unroll
    for (int d = 0; d < NB; ++d) {
      *reinterpret_cast<uint32_t*>(dkg + off + 8 * d) = pack_bf16(
          dk[d][2 * r] * p.sm_scale, dk[d][2 * r + 1] * p.sm_scale);
      *reinterpret_cast<uint32_t*>(dvg + off + 8 * d) =
          pack_bf16(dv[d][2 * r], dv[d][2 * r + 1]);
    }
  }
}

// dQ of one (batch, head, query tile) on the tensor cores: warp w owns
// rows 16 w .. 16 w + 15; S = Q K^T and dP = dO V^T, dS in registers
// (rounded to bf16), dQ += dS K with K read transposed (ldmatrix)
template <int D, bool kWin>
__global__ void __launch_bounds__(kMmaThreads, 1)
bwd_dq_mma_kernel(const BwdParams p) {
  constexpr int kLd = D + 8;
  constexpr int NB = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* dos = qs + kRows * kLd;
  bf16* ks = dos + kRows * kLd;
  bf16* vs = ks + kKeys * kLd;
  float* lse_s = reinterpret_cast<float*>(vs + kKeys * kLd);
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
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int rl = 16 * warp + g;              // rows of c[0..1], + 8 c[2..3]
  const float scale = p.sm_scale * kLog2e;
  const long long o_ss = static_cast<long long>(p.n_heads) * D;

  load_tile_bf16<D>(qs, static_cast<const bf16*>(p.q) + b * p.q_sb
                    + h * p.q_sh, p.q_ss, q0, p.seq);
  load_tile_bf16<D>(dos, static_cast<const bf16*>(p.dout)
                    + static_cast<long long>(b) * p.seq * o_ss
                    + static_cast<long long>(h) * D, o_ss, q0, p.seq);
  load_rows(lse_s, delta_s, p,
            (static_cast<long long>(b) * p.n_heads + h) * p.seq, q0);
  const bf16* kg = static_cast<const bf16*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const bf16* vg = static_cast<const bf16*>(p.v) + b * p.v_sb + kvh * p.v_sh;

  float dq[NB][4];
#pragma unroll
  for (int d = 0; d < NB; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[d][e] = 0.0f;

  for (int j = j_lo; j < j_hi; ++j) {
    const int k0 = j * kKeys;
    __syncthreads();            // the previous tile's readers are done
    load_tile_bf16<D>(ks, kg, p.k_ss, k0, p.seq);
    load_tile_bf16<D>(vs, vg, p.v_ss, k0, p.seq);
    __syncthreads();
    float sc[8][4], dp[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] = dp[n][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t aq[4], ao[4];
      load_a(aq, qs, kLd, 16 * warp, 16 * kk, lane);
      load_a(ao, dos, kLd, 16 * warp, 16 * kk, lane);
#pragma unroll
      for (int n = 0; n < 8; n += 2) {
        uint32_t bk[4], bv[4];
        load_b_rows(bk, ks, kLd, 8 * n, 16 * kk, lane);
        load_b_rows(bv, vs, kLd, 8 * n, 16 * kk, lane);
        mma_bf16(sc[n], aq, bk[0], bk[1]);
        mma_bf16(sc[n + 1], aq, bk[2], bk[3]);
        mma_bf16(dp[n], ao, bv[0], bv[1]);
        mma_bf16(dp[n + 1], ao, bv[2], bv[3]);
      }
    }
    // dS: element e of block n is row rl (+ 8 for e >= 2), key k0 + 8 n +
    // 2 t (+ 1 for odd e)
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = rl + (e >> 1) * 8;
        const float pv = kept(p, q0 + r, k0 + 8 * n + 2 * t + (e & 1), kWin)
            ? exp2f(fmaf(sc[n][e], scale, -lse_s[r])) : 0.0f;
        dp[n][e] = pv * (dp[n][e] - delta_s[r]);
      }
    uint32_t as[4][4];
    pack_a(dp, as);
    // dQ += dS K (k: the tile's 64 keys)
#pragma unroll
    for (int d = 0; d < NB; d += 2) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        uint32_t bk[4];
        load_b_cols(bk, ks, kLd, 16 * k, 8 * d, lane);
        mma_bf16(dq[d], as[k], bk[0], bk[1]);
        mma_bf16(dq[d + 1], as[k], bk[2], bk[3]);
      }
    }
  }

  bf16* dqg = static_cast<bf16*>(p.dq);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + rl + 8 * r;
    if (row >= p.seq) continue;
    const long long off = ((static_cast<long long>(b) * p.seq + row)
                           * p.n_heads + h) * D + 2 * t;
#pragma unroll
    for (int d = 0; d < NB; ++d)
      *reinterpret_cast<uint32_t*>(dqg + off + 8 * d) = pack_bf16(
          dq[d][2 * r] * p.sm_scale, dq[d][2 * r + 1] * p.sm_scale);
  }
}

// one route's dK/dV and dQ kernels: their shared memory, and a launch
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

// the row pass, then the dK/dV and dQ kernels: mma.sync for bfloat16,
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
    return launch_pair<mma_smem_bytes<D>()>(
        bwd_dkdv_mma_kernel<D, kWin>, bwd_dq_mma_kernel<D, kWin>,
        kMmaThreads, p, batch, n_kv_heads, stream);
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
// (B, H, S).  Returns a CUDA error code (0 = launched).
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
