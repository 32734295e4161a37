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
// float32 route (bwd_dkdv_tf32_kernel, bwd_dq_tf32_kernel): the
// arithmetic of K5's float32 forward, split TF32 on mma.sync.m16n8k8
// (split_tf32, mma3_tf32 and the cp.async copies are csrc/sm90.cuh's):
// each of the seven products is three TF32 products, a_lo b_hi + a_hi
// b_lo + a_hi b_hi, every sum float32, which holds dq, dk, dv within 1e-5
// of the plain backward in relative L2 (one TF32 product lands 4-9x
// beyond that, tests/test_torch_flash_bwd_f32_split.py).  Not wgmma: its
// TF32 form reads B only K-major from shared memory, and dV += P^T dO,
// dK += dS^T Q and dQ += dS K read theirs MN-major.  A block is 8 warps,
// 4 pairs (w, w + 4):
//
// * dK/dV: a block owns 64 keys, a pair 16 of them.  K and V stay in
//   shared memory; Q and dO stream through a 2-stage cp.async ring of 64
//   query rows (32 at dh 128), their lse and D beside them, over the
//   group's query heads and the query tiles that see the keys.  S^T = K
//   Q^T and dP^T = V dO^T come out key-major: their accumulators (rows g,
//   g + 8; columns 2t, 2t + 1) are the A fragments of dV += P^T dO and
//   dK += dS^T Q as they stand, A's reduction column t taken as query row
//   2t and t + 4 as row 2t + 1 (the forward's P V trick).  Each warp of
//   a pair computes S^T and dP^T for half of a stage's rows and leaves
//   P^T and dS^T in shared memory for the other (a 64-thread barrier);
//   then each runs dV and dK over all the stage's rows for half of dh's
//   columns.  So a thread holds 64 floats of dK and dV at dh 128, not
//   the 128 of a warp that keeps all of dh (which spilled at 255
//   registers whatever its unrolling), and no reduction is left for the
//   end;
// * dQ: a block owns 64 query rows, a pair 16.  Q, dO, lse and D stay
//   resident; K and V stream through a 2-stage ring of 64 keys, each warp
//   of a pair takes 32 of them: S = Q K^T, dP = dO V^T, dS in registers
//   as the A fragment of dQ += dS K; the pair's two partial dQ are summed
//   in a fixed order at the end.
//
// The tensor core truncates the sums it returns, so the long sums are
// not left in its accumulators (the note above mma3_slice).  Warps whose
// keys (rows) a stage cannot see skip its products.  A streamed tile is
// read in two patterns; its stride and row order (f32_ld_b, perm8) serve
// both without bank conflicts.  Shared memory at dh 128 / 64 / 16: dK/dV
// 160,256 / 148,480 / 66,560 bytes, dQ 212,992 / 114,688 / 32,768; one
// block an SM.  At (1, 2048, 24/8, 128) causal the three kernels take
// 1.858-1.866 ms against 4.158-4.211 for the scalar float32 kernels they
// replaced, 2.27-2.31 for SDPA's backward and a 0.391 ms bound (the five
// products as three TF32 products each at 495 TFLOP/s); the dK/dV kernel
// 1.08 ms, the dQ kernel 0.74 (tools/flash_bwd_ab.py, NVIDIA H100 80GB
// HBM3, 700 W).
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

constexpr int kThreads = 256;   // the row pass: a warp a row
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

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
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

// ---------------------------------------------------------------------------
// float32 route: split TF32 on the tensor cores (mma.sync), cp.async ring
// ---------------------------------------------------------------------------

constexpr int kF32Threads = 256;  // 8 warps: 4 pairs (w, w + 4)
constexpr int kF32Tile = 64;      // keys a dK/dV block, query rows a dQ block
constexpr int kF32Ring = 2;       // stages of each ring
constexpr int kDqStep = 64;       // keys a stage of the dQ ring, 32 a warp

// Query rows a stage of the dK/dV ring, half of them a warp's in the
// first products.  At dh 128 a stage is 32 rows: 64 would not leave room
// for the exchange of P^T and dS^T beside K, V and the ring.
template <int D>
__host__ __device__ constexpr int dkdv_step() {
  return D == 128 ? 32 : 64;
}

// Row strides (floats) in shared memory.  A resident tile read only as
// the A operand (rows g and g + 8, float4 at column 4t: K and V in the
// dK/dV kernel, Q and dO in the dQ kernel) takes the forward's Q/K
// stride, 16 banks mod 32, so the two rows of a quarter warp fall on
// disjoint halves.  A streamed tile is read two ways: as B of the first
// products (S^T = K Q^T: row 8m + perm8(g), float4 at column 4t) and as B
// of the last (dK += dS^T Q: rows 8m + perm8(2t) and 8m + perm8(2t + 1),
// float2 at column 2g).  No stride serves both with the rows in order
// (the first wants 16 banks mod 32 between rows 2q and 2q + 1, the second
// rows 0, 2, 4, 6 8 banks apart); with the rows of each group of 8
// taken in the order perm8, a stride of 8 banks mod 16 does (chosen by
// that count of banks: no profiler on the card reads bank conflicts).
template <int D>
__host__ __device__ constexpr int f32_ld_a() {
  return D % 32 == 16 ? D : D + 16;
}

template <int D>
__host__ __device__ constexpr int f32_ld_b() {
  return D + 8;
}

// The order of the 8 rows (keys) of an n8-block of the first products:
// column j of the block is row perm8(j), {0, 6, 1, 7, 2, 4, 3, 5}.  A
// quarter warp's float4 reads (j = 2q, 2q + 1) are then 2 or 6 rows
// apart, 16 banks mod 32 at a stride of 8 mod 16, and a half warp's
// float2 reads (rows perm8(2t), or perm8(2t + 1), t = 0 .. 3) 4 rows in
// one of the residues 0 .. 3 mod 4, 8 banks apart.
__device__ __forceinline__ int perm8(int j) {
  return (j & 1) ? 4 + ((j >> 1) ^ 2) : j >> 1;
}

// rows r0 .. r0 + ROWS - 1 of a (seq, D) float32 slab of row stride ss
// into shared memory at row stride LD, every thread of the block a
// share, asynchronously; rows past seq land as zeros
template <int D, int ROWS, int LD>
__device__ __forceinline__ void copy_rows(uint32_t dst, const float* src,
                                          long long ss, int r0, int seq) {
  constexpr int kChunks = D / 4;                  // 16-byte chunks a row
  for (int c = threadIdx.x; c < ROWS * kChunks; c += kF32Threads) {
    const int r = c / kChunks;
    const int col = (c % kChunks) * 4;
    const bool valid = r0 + r < seq;
    const long long row = valid ? r0 + r : 0;
    cp_async16(dst + (r * LD + col) * 4, src + row * ss + col, valid);
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&x)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) x[i][0] = x[i][1] = x[i][2] = x[i][3] = 0.0f;
}

// The tensor core truncates the sum it returns (toward zero), so a long
// sum kept in its accumulator drifts by about a unit in the last place a
// product: on an H100, dK and dV at (1, 2048, 24/8, 128) came out 2.5e-5
// from the plain backward in relative L2 that way, and dP's sum over dh
// left dS = P (dP - D), 0 by construction under a lone key, at 1.2e-5.  So the
// products whose error matters are summed from zero over a few k-steps
// and then added in float32, which rounds to nearest: dP (dP^T) a slice
// of 16 columns of dh, dK, dV and dQ two k-steps of rows (keys).  S's
// error moves P only relatively, by its size times the scale: S is summed
// in the accumulator.

// d (NB blocks of 16 x 8) += A B over the 16 columns of a slice of dh:
// A's rows g and g + 8 (a, b: float4 at column 4 t of the slice), B's
// rows of block m at bp + 8 m LD (float4 at column 4 t).  k-step e takes
// columns 4 t + 2 e (A column t) and + 1 (column t + 4), for A and B
// alike: the reduction may run in any order.  With kSum each block's two
// k-steps are summed from zero and added to d in float32.
template <int NB, int LD, bool kSum>
__device__ __forceinline__ void mma3_slice(float (&d)[NB][4], float4 a,
                                           float4 b, const float* bp) {
  uint32_t ah[2][4], al[2][4];
  split_tf32(a.x, ah[0][0], al[0][0]);
  split_tf32(b.x, ah[0][1], al[0][1]);
  split_tf32(a.y, ah[0][2], al[0][2]);
  split_tf32(b.y, ah[0][3], al[0][3]);
  split_tf32(a.z, ah[1][0], al[1][0]);
  split_tf32(b.z, ah[1][1], al[1][1]);
  split_tf32(a.w, ah[1][2], al[1][2]);
  split_tf32(b.w, ah[1][3], al[1][3]);
#pragma unroll
  for (int m = 0; m < NB; ++m) {
    const float4 x = *reinterpret_cast<const float4*>(bp + 8 * m * LD);
    uint32_t bh[2][2], bl[2][2];
    split_tf32(x.x, bh[0][0], bl[0][0]);
    split_tf32(x.y, bh[0][1], bl[0][1]);
    split_tf32(x.z, bh[1][0], bl[1][0]);
    split_tf32(x.w, bh[1][1], bl[1][1]);
    if constexpr (kSum) {
      float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      mma3_tf32(s, ah[0], al[0], bh[0], bl[0]);
      mma3_tf32(s, ah[1], al[1], bh[1], bl[1]);
#pragma unroll
      for (int e = 0; e < 4; ++e) d[m][e] += s[e];
    } else {
      mma3_tf32(d[m], ah[0], al[0], bh[0], bl[0]);
      mma3_tf32(d[m], ah[1], al[1], bh[1], bl[1]);
    }
  }
}

// d += A B over two k-steps of 8 reduction rows each, for NCOL columns
// of dh.  A's first (second) k-step is the accumulator block c0 (c1):
// rows g, g + 8, columns 2t, 2t + 1, as it stands: its column 2t is A's
// column t and column 2t + 1 A's column t + 4.  B's rows for those two are at r0 and
// r1 (+ 8 LD for the second k-step): with NCOL a multiple of 16, float2
// at column 2g of each 16-column slice (n8-block 2 i + x holds column
// 16 i + 2 j + x at its column j); with NCOL 8, a float at column g.
// Each n8-block's two k-steps are summed from zero, then added to d.
template <int NCOL, int LD>
__device__ __forceinline__ void mma3_rows(float (&d)[NCOL / 8][4],
                                          const float (&c0)[4],
                                          const float (&c1)[4],
                                          const float* r0, const float* r1) {
  uint32_t ah[2][4], al[2][4];
  split_tf32(c0[0], ah[0][0], al[0][0]);
  split_tf32(c0[2], ah[0][1], al[0][1]);
  split_tf32(c0[1], ah[0][2], al[0][2]);
  split_tf32(c0[3], ah[0][3], al[0][3]);
  split_tf32(c1[0], ah[1][0], al[1][0]);
  split_tf32(c1[2], ah[1][1], al[1][1]);
  split_tf32(c1[1], ah[1][2], al[1][2]);
  split_tf32(c1[3], ah[1][3], al[1][3]);
  constexpr int kW = NCOL >= 16 ? 2 : 1;          // n8-blocks a read
#pragma unroll
  for (int i = 0; i < NCOL / (8 * kW); ++i) {
    float s[kW][4] = {};
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      uint32_t bh[kW][2], bl[kW][2];
      if constexpr (kW == 2) {
        const float2 x0 =
            *reinterpret_cast<const float2*>(r0 + 8 * k * LD + 16 * i);
        const float2 x1 =
            *reinterpret_cast<const float2*>(r1 + 8 * k * LD + 16 * i);
        split_tf32(x0.x, bh[0][0], bl[0][0]);
        split_tf32(x1.x, bh[0][1], bl[0][1]);
        split_tf32(x0.y, bh[1][0], bl[1][0]);
        split_tf32(x1.y, bh[1][1], bl[1][1]);
      } else {
        split_tf32(r0[8 * k * LD], bh[0][0], bl[0][0]);
        split_tf32(r1[8 * k * LD], bh[0][1], bl[0][1]);
      }
#pragma unroll
      for (int x = 0; x < kW; ++x) mma3_tf32(s[x], ah[k], al[k], bh[x], bl[x]);
    }
#pragma unroll
    for (int x = 0; x < kW; ++x)
#pragma unroll
      for (int e = 0; e < 4; ++e) d[kW * i + x][e] += s[x][e];
  }
}

// row g (r = 0) or g + 8 (r = 1) of an accumulator of NCOL columns laid
// out as mma3_rows leaves it, times scale, at dst (its first column)
template <int NCOL>
__device__ __forceinline__ void store_row(float* dst,
                                          const float (&a)[NCOL / 8][4],
                                          int r, float scale) {
  const int t = threadIdx.x & 3;
  if constexpr (NCOL >= 16) {
#pragma unroll
    for (int i = 0; i < NCOL / 16; ++i)
      *reinterpret_cast<float4*>(dst + 16 * i + 4 * t) = make_float4(
          a[2 * i][2 * r] * scale, a[2 * i + 1][2 * r] * scale,
          a[2 * i][2 * r + 1] * scale, a[2 * i + 1][2 * r + 1] * scale);
  } else {
    *reinterpret_cast<float2*>(dst + 2 * t) =
        make_float2(a[0][2 * r] * scale, a[0][2 * r + 1] * scale);
  }
}

// the two warps w and w + 4 of a pair meet (named barrier 1 + w % 4)
__device__ __forceinline__ void pair_sync() {
  asm volatile("bar.sync %0, 64;\n" :: "r"(1 + ((threadIdx.x >> 5) & 3))
               : "memory");
}

// shared memory of a dK/dV block: K and V, kF32Ring stages of Q, dO and
// their rows' lse and D, and each warp's P^T and dS^T for its partner
template <int D>
constexpr int dkdv_tf32_smem_bytes() {
  return (2 * kF32Tile * f32_ld_a<D>()
          + kF32Ring * (2 * dkdv_step<D>() * f32_ld_b<D>()
                        + 2 * dkdv_step<D>())
          + 8 * 16 * dkdv_step<D>()) * 4;
}

// shared memory of a dQ block: Q and dO, then kF32Ring stages of K and V
template <int D>
constexpr int dq_tf32_smem_bytes() {
  return (2 * kF32Tile * f32_ld_a<D>()
          + kF32Ring * 2 * kDqStep * f32_ld_b<D>()) * 4;
}

// dK and dV of one (batch, KV head, 64-key tile).  The warps of pair w %
// 4 own keys 16 (w % 4) .. + 15 of the tile.  The ring walks the group's
// query heads and, for each, the query tiles (of a stage's rows) that
// see the tile's keys.  Per stage, warp w takes the first (w < 4) or
// second half of the rows for S^T = K Q^T and dP^T = V dO^T (keys the M,
// query rows the N), forms P^T and dS^T in registers and leaves them in
// shared memory for its partner; then each warp of the pair runs dV +=
// P^T dO and dK += dS^T Q over all the stage's rows for its half of dh's
// columns, its own rows' A operands from its registers, its partner's
// from shared memory.  A warp holds dK and dV for 16 keys and D / 2
// columns.
template <int D, bool kWin>
__global__ void __launch_bounds__(kF32Threads, 1)
bwd_dkdv_tf32_kernel(const BwdParams p) {
  constexpr int kStep = dkdv_step<D>();
  constexpr int kHalf = kStep / 2;                 // a warp's rows
  constexpr int kNB = kHalf / 8;                   // its n8-blocks
  constexpr int kCols = D / 2;                     // its columns of dK, dV
  constexpr int kLdA = f32_ld_a<D>();
  constexpr int kLdB = f32_ld_b<D>();
  constexpr int kStage = 2 * kStep * kLdB + 2 * kStep;  // floats
  constexpr int kXch = 16 * kHalf;                 // a warp's P^T (dS^T)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* const k_tile = reinterpret_cast<float*>(smem_raw);
  float* const v_tile = k_tile + kF32Tile * kLdA;
  float* const ring = v_tile + kF32Tile * kLdA;    // Q, dO, lse, D
  float* const xch = ring + kF32Ring * kStage;
  const uint32_t k_s = smem_addr(smem_raw);
  const uint32_t v_s = k_s + kF32Tile * kLdA * 4;
  const uint32_t ring_s = v_s + kF32Tile * kLdA * 4;

  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int k0 = blockIdx.z * kF32Tile;     // tile 0 (causal: the longest)
  const int n_qt = (p.seq + kStep - 1) / kStep;
  // the query tiles that see a key of the tile
  const int i_lo = p.causal ? k0 / kStep : 0;
  int i_hi = n_qt;
  if constexpr (kWin)
    i_hi = min(n_qt, (k0 + kF32Tile - 2 + p.window) / kStep + 1);
  const int n_i = i_hi - i_lo;
  const int n_steps = p.group * n_i;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int hf = warp >> 2;                 // which half of a stage's rows
  const int kw = k0 + 16 * (warp & 3);      // the pair's first key
  const int half = kHalf * hf;              // this warp's first row
  const int col0 = kCols * hf;              // its first column of dK, dV
  const long long o_ss = static_cast<long long>(p.n_heads) * D;
  // P^T then dS^T, block m's fragment at [m][lane][4]
  float* const mine = xch + warp * 2 * kXch;
  const float* const theirs = xch + (warp ^ 4) * 2 * kXch;

  // stage n's copies: the Q and dO rows of query tile i_lo + n % n_i of
  // head kvh * group + n / n_i, and their lse and D, slot j of each 8
  // holding row perm8(j)
  auto load_stage = [&](int n) {
    const int h = kvh * p.group + n / n_i;
    const int q0 = (i_lo + n % n_i) * kStep;
    const uint32_t dst = ring_s + (n % kF32Ring) * kStage * 4;
    copy_rows<D, kStep, kLdB>(
        dst, static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh,
        p.q_ss, q0, p.seq);
    copy_rows<D, kStep, kLdB>(
        dst + kStep * kLdB * 4,
        static_cast<const float*>(p.dout)
            + static_cast<long long>(b) * p.seq * o_ss + h * D,
        o_ss, q0, p.seq);
    if (threadIdx.x < 2 * kStep) {
      const int j = threadIdx.x % kStep;
      const int row = q0 + (j & ~7) + perm8(j & 7);
      const bool valid = row < p.seq;
      const float* src = threadIdx.x < kStep ? p.lse : p.delta;
      cp_async4(dst + (2 * kStep * kLdB + threadIdx.x) * 4,
                src + (static_cast<long long>(b) * p.n_heads + h) * p.seq
                    + (valid ? row : 0),
                valid);
    }
  };

  // K and V with the first stage: one group of copies
  copy_rows<D, kF32Tile, kLdA>(
      k_s, static_cast<const float*>(p.k) + b * p.k_sb + kvh * p.k_sh, p.k_ss,
      k0, p.seq);
  copy_rows<D, kF32Tile, kLdA>(
      v_s, static_cast<const float*>(p.v) + b * p.v_sb + kvh * p.v_sh, p.v_ss,
      k0, p.seq);
  load_stage(0);                            // n_steps >= group >= 1
  cp_async_commit();

  float dk[kCols / 8][4], dv[kCols / 8][4];
  zero(dk);
  zero(dv);
  const float scale = p.sm_scale * kLog2e;
  // the pair's K and V rows g and g + 8, at column 4 t
  const float* k_rows = k_tile + (kw - k0 + g) * kLdA + 4 * t;
  const float* v_rows = v_tile + (kw - k0 + g) * kLdA + 4 * t;
  const int key_a = kw + g;
  const int key_b = key_a + 8;
  // B's rows: of the first products, row perm8(g) of each block, float4
  // at column 4t; of the last, rows perm8(2t) and perm8(2t + 1) of each
  // block, at this warp's columns (mma3_rows)
  const int b_first = (half + perm8(g)) * kLdB + 4 * t;
  const int col_b = col0 + (kCols >= 16 ? 2 * g : g);
  const int b_last0 = perm8(2 * t) * kLdB + col_b;
  const int b_last1 = perm8(2 * t + 1) * kLdB + col_b;

  for (int n = 0; n < n_steps; ++n) {
    const float* qs = ring + (n % kF32Ring) * kStage;
    const float* dos = qs + kStep * kLdB;
    cp_async_wait<0>();        // this stage's copies have landed
    __syncthreads();           // and every warp is done with the last one
    if (n + 1 < n_steps) {     // into the last one's slot
      load_stage(n + 1);
      cp_async_commit();
    }
    const int rs = (i_lo + n % n_i) * kStep;       // the stage's first row
    // whether half x of the stage's rows sees a key of the pair's 16: not
    // if the keys or rows lie past S, (causal) every key after every row,
    // (window) every row a window or more past every key
    auto sees = [&](int x) {
      const int ra = rs + kHalf * x;
      bool any = kw < p.seq && ra < p.seq
                 && !(p.causal && kw > ra + kHalf - 1);
      if constexpr (kWin) any = any && ra - (kw + 15) < p.window;
      return any;
    };
    const bool own = sees(hf);
    const bool other = sees(hf ^ 1);
    if (!own && !other) continue;            // the pair agrees
    float st[kNB][4], dpt[kNB][4];
    if (own) {
      const int r0 = rs + half;                    // this warp's first row
      const float* rows = dos + kStep * kLdB + half;   // lse, D slots
      // S^T = K Q^T and dP^T = V dO^T over the warp's rows: block m's
      // column c is row 8 m + perm8(c)
      zero(st);
      zero(dpt);
#pragma unroll
      for (int i = 0; i < D / 16; ++i)
        mma3_slice<kNB, kLdB, false>(
            st, *reinterpret_cast<const float4*>(k_rows + 16 * i),
            *reinterpret_cast<const float4*>(k_rows + 8 * kLdA + 16 * i),
            qs + b_first + 16 * i);
#pragma unroll
      for (int i = 0; i < D / 16; ++i)
        mma3_slice<kNB, kLdB, true>(
            dpt, *reinterpret_cast<const float4*>(v_rows + 16 * i),
            *reinterpret_cast<const float4*>(v_rows + 8 * kLdA + 16 * i),
            dos + b_first + 16 * i);

      // P^T = exp2(S^T scale - lse log2 e), masked entries 0, and dS^T =
      // P^T (dP^T - D); element e of block m: key key_a (key_b for e >=
      // 2), row r0 + 8 m + perm8(2 t + (e & 1))
      bool edge = kw + 15 >= p.seq || r0 + kHalf - 1 >= p.seq
                  || (p.causal && kw + 15 > r0);
      if constexpr (kWin) edge = edge || r0 + kHalf - 1 - kw >= p.window;
#pragma unroll
      for (int m = 0; m < kNB; ++m) {
        const float2 l2 = *reinterpret_cast<const float2*>(rows + 8 * m
                                                           + 2 * t);
        const float2 d2 = *reinterpret_cast<const float2*>(
            rows + kStep + 8 * m + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float pv = exp2f(fmaf(st[m][e], scale,
                                -((e & 1) ? l2.y : l2.x) * kLog2e));
          if (edge) {
            const int row = r0 + 8 * m + perm8(2 * t + (e & 1));
            const int key = e < 2 ? key_a : key_b;
            bool keep = row < p.seq && key < p.seq
                        && !(p.causal && key > row);
            if constexpr (kWin) keep = keep && row - key < p.window;
            if (!keep) pv = 0.0f;
          }
          st[m][e] = pv;
          dpt[m][e] = pv * (dpt[m][e] - ((e & 1) ? d2.y : d2.x));
        }
        *reinterpret_cast<float4*>(mine + (m * 32 + lane) * 4) =
            make_float4(st[m][0], st[m][1], st[m][2], st[m][3]);
        *reinterpret_cast<float4*>(mine + kXch + (m * 32 + lane) * 4) =
            make_float4(dpt[m][0], dpt[m][1], dpt[m][2], dpt[m][3]);
      }
    }
    pair_sync();               // each warp's P^T and dS^T are out

    // dV += P^T dO and dK += dS^T Q over the rows of half x, two k-steps
    // (blocks) at a time
    auto last = [&](const float (&pt)[kNB][4], const float (&dst)[kNB][4],
                    int x) {
#pragma unroll
      for (int m = 0; m < kNB; m += 2) {
        const int r = (kHalf * x + 8 * m) * kLdB;
        mma3_rows<kCols, kLdB>(dv, pt[m], pt[m + 1], dos + r + b_last0,
                               dos + r + b_last1);
        mma3_rows<kCols, kLdB>(dk, dst[m], dst[m + 1], qs + r + b_last0,
                               qs + r + b_last1);
      }
    };
    if (own) last(st, dpt, hf);
    if (other) {
#pragma unroll
      for (int m = 0; m < kNB; ++m) {
        const float4 a = *reinterpret_cast<const float4*>(
            theirs + (m * 32 + lane) * 4);
        const float4 c = *reinterpret_cast<const float4*>(
            theirs + kXch + (m * 32 + lane) * 4);
        st[m][0] = a.x, st[m][1] = a.y, st[m][2] = a.z, st[m][3] = a.w;
        dpt[m][0] = c.x, dpt[m][1] = c.y, dpt[m][2] = c.z, dpt[m][3] = c.w;
      }
      last(st, dpt, hf ^ 1);
    }
  }

  const int n_kv = p.n_heads / p.group;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = r ? key_b : key_a;
    if (key >= p.seq) continue;
    const long long off = ((static_cast<long long>(b) * p.seq + key) * n_kv
                           + kvh) * D + col0;
    store_row<kCols>(static_cast<float*>(p.dk) + off, dk, r, p.sm_scale);
    store_row<kCols>(static_cast<float*>(p.dv) + off, dv, r, 1.0f);
  }
}

// the sum of the two warps w and w + 4 that share 16 rows: warps 4 .. 7
// leave their partial a (D / 2 floats a thread) at `red`, warps 0 .. 3
// add it to theirs, in that order (the same bits every run).  The block
// has finished with the shared memory at `red`.
template <int D>
__device__ __forceinline__ void add_partner(float (&a)[D / 8][4],
                                            float* red) {
  const int warp = threadIdx.x >> 5;
  float* slot = red + (warp & 3) * (D / 2) * 32 + (threadIdx.x & 31);
  __syncthreads();
  if (warp >= 4) {
#pragma unroll
    for (int x = 0; x < D / 8; ++x)
#pragma unroll
      for (int e = 0; e < 4; ++e) slot[(4 * x + e) * 32] = a[x][e];
  }
  __syncthreads();
  if (warp < 4) {
#pragma unroll
    for (int x = 0; x < D / 8; ++x)
#pragma unroll
      for (int e = 0; e < 4; ++e) a[x][e] += slot[(4 * x + e) * 32];
  }
}

// dQ of one (batch, head, 64-row query tile).  Warp w owns rows
// 16 (w % 4) .. + 15 of the tile and the first (w < 4) or second half of
// each stage's keys.  The ring walks the key tiles (of a stage's keys)
// the rows see; per stage S = Q K^T and dP = dO V^T, dS in registers as
// the A operand of dQ += dS K.
template <int D, bool kWin>
__global__ void __launch_bounds__(kF32Threads, 1)
bwd_dq_tf32_kernel(const BwdParams p) {
  constexpr int kStep = kDqStep;
  constexpr int kHalf = kStep / 2;                 // a warp's keys
  constexpr int kNB = kHalf / 8;                   // its n8-blocks
  constexpr int kLdA = f32_ld_a<D>();
  constexpr int kLdB = f32_ld_b<D>();
  constexpr int kStage = 2 * kStep * kLdB;         // floats
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* const q_tile = reinterpret_cast<float*>(smem_raw);
  float* const do_tile = q_tile + kF32Tile * kLdA;
  float* const ring = do_tile + kF32Tile * kLdA;   // K, V
  const uint32_t q_s = smem_addr(smem_raw);
  const uint32_t do_s = q_s + kF32Tile * kLdA * 4;
  const uint32_t ring_s = do_s + kF32Tile * kLdA * 4;

  const int n_qt = (p.seq + kF32Tile - 1) / kF32Tile;
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.z);  // long first
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int kvh = h / p.group;
  const int q0 = qt * kF32Tile;
  const int n_kt = (p.seq + kStep - 1) / kStep;
  const int j_hi = p.causal ? min(n_kt, (q0 + kF32Tile - 1) / kStep + 1)
                            : n_kt;
  int j_lo = 0;
  if constexpr (kWin) j_lo = max(0, q0 - p.window + 1) / kStep;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int rw = q0 + 16 * (warp & 3);      // this warp's first row
  const int half = kHalf * (warp >> 2);     // its first key of a stage
  const int row_a = rw + g;
  const int row_b = row_a + 8;
  const long long o_ss = static_cast<long long>(p.n_heads) * D;
  const float* kg = static_cast<const float*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const float* vg = static_cast<const float*>(p.v) + b * p.v_sb + kvh * p.v_sh;

  // key tile j's K and V into its slot
  auto load_stage = [&](int j) {
    const uint32_t dst = ring_s + ((j - j_lo) % kF32Ring) * kStage * 4;
    copy_rows<D, kStep, kLdB>(dst, kg, p.k_ss, j * kStep, p.seq);
    copy_rows<D, kStep, kLdB>(dst + kStep * kLdB * 4, vg, p.v_ss, j * kStep,
                              p.seq);
  };

  // Q and dO with the first stage: one group of copies
  copy_rows<D, kF32Tile, kLdA>(
      q_s, static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh, p.q_ss,
      q0, p.seq);
  copy_rows<D, kF32Tile, kLdA>(
      do_s,
      static_cast<const float*>(p.dout)
          + static_cast<long long>(b) * p.seq * o_ss + h * D,
      o_ss, q0, p.seq);
  load_stage(j_lo);
  cp_async_commit();

  // the rows' logsumexp (log2 units) and D
  const long long hrows = (static_cast<long long>(b) * p.n_heads + h) * p.seq;
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r ? row_b : row_a;
    lse2[r] = row < p.seq ? p.lse[hrows + row] * kLog2e : 0.0f;
    dl[r] = row < p.seq ? p.delta[hrows + row] : 0.0f;
  }
  float dq[D / 8][4];
  zero(dq);
  const float scale = p.sm_scale * kLog2e;
  // this warp's Q and dO rows g and g + 8, at column 4 t
  const float* q_rows = q_tile + (rw - q0 + g) * kLdA + 4 * t;
  const float* do_rows = do_tile + (rw - q0 + g) * kLdA + 4 * t;
  // B's rows (keys), as in the dK/dV kernel
  const int b_first = (half + perm8(g)) * kLdB + 4 * t;
  const int b_last0 = (half + perm8(2 * t)) * kLdB + 2 * g;
  const int b_last1 = (half + perm8(2 * t + 1)) * kLdB + 2 * g;

  for (int j = j_lo; j < j_hi; ++j) {
    const float* ks = ring + ((j - j_lo) % kF32Ring) * kStage;
    const float* vs = ks + kStep * kLdB;
    cp_async_wait<0>();        // this stage's copies have landed
    __syncthreads();           // and every warp is done with the last one
    if (j + 1 < j_hi) {        // into the last one's slot
      load_stage(j + 1);
      cp_async_commit();
    }
    const int kk = j * kStep + half;         // this warp's first key
    // no row of this warp sees a key of its half: as in the dK/dV kernel
    bool none = kk >= p.seq || rw >= p.seq || (p.causal && kk > rw + 15);
    if constexpr (kWin) none = none || rw - (kk + kHalf - 1) >= p.window;
    if (!none) {
      // S = Q K^T and dP = dO V^T over the warp's keys: block n's column
      // c is key 8 n + perm8(c)
      float sc[kNB][4], dp[kNB][4];
      zero(sc);
      zero(dp);
      // unrolled by 2: unrolled fully, the dh 128 kernel spills
#pragma unroll 2
      for (int i = 0; i < D / 16; ++i)
        mma3_slice<kNB, kLdB, false>(
            sc, *reinterpret_cast<const float4*>(q_rows + 16 * i),
            *reinterpret_cast<const float4*>(q_rows + 8 * kLdA + 16 * i),
            ks + b_first + 16 * i);
#pragma unroll 2
      for (int i = 0; i < D / 16; ++i)
        mma3_slice<kNB, kLdB, true>(
            dp, *reinterpret_cast<const float4*>(do_rows + 16 * i),
            *reinterpret_cast<const float4*>(do_rows + 8 * kLdA + 16 * i),
            vs + b_first + 16 * i);

      // P = exp2(S scale - lse log2 e), masked entries 0, and dS = P (dP
      // - D); element e of block n: row row_a (row_b for e >= 2), key
      // kk + 8 n + perm8(2 t + (e & 1))
      bool edge = kk + kHalf - 1 >= p.seq || rw + 15 >= p.seq
                  || (p.causal && kk + kHalf - 1 > rw);
      if constexpr (kWin) edge = edge || rw + 15 - kk >= p.window;
#pragma unroll
      for (int n = 0; n < kNB; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          float pv = exp2f(fmaf(sc[n][e], scale, -lse2[r]));
          if (edge) {
            const int row = r ? row_b : row_a;
            const int key = kk + 8 * n + perm8(2 * t + (e & 1));
            bool keep = row < p.seq && key < p.seq
                        && !(p.causal && key > row);
            if constexpr (kWin) keep = keep && row - key < p.window;
            if (!keep) pv = 0.0f;
          }
          dp[n][e] = pv * (dp[n][e] - dl[r]);
        }
      }

      // dQ += dS K, two k-steps (blocks) at a time
#pragma unroll
      for (int n = 0; n < kNB; n += 2)
        mma3_rows<D, kLdB>(dq, dp[n], dp[n + 1], ks + b_last0 + 8 * n * kLdB,
                           ks + b_last1 + 8 * n * kLdB);
    }
  }

  // warps w and w + 4 hold two halves of the same rows' sums
  static_assert(4 * 32 * D / 2 <= kF32Ring * kStage,
                "partials fit the ring");
  add_partner<D>(dq, ring);
  if (warp < 4) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r ? row_b : row_a;
      if (row >= p.seq) continue;
      store_row<D>(static_cast<float*>(p.dq)
                       + ((static_cast<long long>(b) * p.seq + row)
                          * p.n_heads + h) * D,
                   dq, r, p.sm_scale);
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
template <int D, bool kWin>
int launch_tf32(const BwdParams& p, int batch, int n_kv_heads,
                cudaStream_t stream) {
  constexpr int smem_kv = dkdv_tf32_smem_bytes<D>();
  constexpr int smem_q = dq_tf32_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      bwd_dkdv_tf32_kernel<D, kWin>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem_kv);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(bwd_dq_tf32_kernel<D, kWin>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_q);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_t = (p.seq + kF32Tile - 1) / kF32Tile;   // key, query tiles
  if (n_t > 65535) return static_cast<int>(cudaErrorInvalidValue);
  bwd_dkdv_tf32_kernel<D, kWin>
      <<<dim3(n_kv_heads, batch, n_t), kF32Threads, smem_kv, stream>>>(p);
  bwd_dq_tf32_kernel<D, kWin>
      <<<dim3(p.n_heads, batch, n_t), kF32Threads, smem_q, stream>>>(p);
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
// split TF32 on mma.sync for float32
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
    return launch_tf32<D, kWin>(p, batch, n_kv_heads, stream);
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
