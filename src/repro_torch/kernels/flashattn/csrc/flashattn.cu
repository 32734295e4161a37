// Flash attention (fused online softmax) on Hopper (sm_90a), plain C
// interface:
//
//   out[b, s, h] = softmax_k(q[b, s, h] . k[b, k, h / g] * sm_scale,
//                            masked to k <= s when causal, and to
//                            s - k < window with a window)
//                  @ v[b, :, h / g]
//
// with g = H / KV (grouped-query attention), q (B, S, H, dh) and k, v
// (B, S, KV, dh) read through their strides in the model's layout: the
// GQA repeat and the (B, S, H) -> (B*H, S) fold of the JAX wrapper are
// never materialised.  The scores, the running max and sum (m, l) and
// the accumulator are float32; the output is in q's type (float32 or
// bfloat16), divided by max(l, 1e-30).  dh is 16, 64 or 128 in float32
// (16: the head width of every smoke config), 64 or 128 in bfloat16;
// any S >= 1.
//
// Replaces the TPU kernel
//   src/repro/kernels/flashattn/kernel.py: flash_attention_pallas
// (body _kernel).  The TPU walks a (BH, q-block, kv-block) grid whose kv
// axis runs in order on one core, carrying (m, l, acc) in VMEM scratch
// from step to step, and masks the blocks above the diagonal instead of
// skipping them.  The card's blocks run in no order, so here one thread
// block owns one (b, h, query tile) and walks the KV tiles from 0 upward
// in a loop of its own: (m, l, acc) stay in registers and never reach
// device memory.  With `causal` the loop ends at the query tile's
// diagonal, so the tiles above it are skipped, not masked, and only the
// diagonal tile (and a ragged last tile) is masked.  Without a window
// every row starts at KV tile 0, which always holds a key the row may
// see, so the finite -1e30 mask of the reference never gives
// exp(m - m) = 1 for a masked key.  Keys past S are masked and query
// rows past S are not written; the TPU's S % block == 0 is a fact of its
// tiling, not of the function.
//
// Sliding-window mode (window > 0, causal only; 0 means none).  Row r
// sees keys r - window < k <= r, the mask of the JAX package's
// masked_chunk_attention and trapezoid_attention
// (src/repro/models/attention.py:97, :60), which compute it in XLA: no
// TPU kernel has a window.  It is gemma3's local layers (5 of every 6,
// window 1024).  A query tile's KV loop starts at j0, the first tile
// holding a key at or above (first row) - window + 1, and ends at the
// diagonal as before: the trapezoid schedule at the kernel's tile.  The
// tiles where some row's window begins (one when window is a multiple
// of the tile, else two) are masked like the diagonal.  The ring slot
// and mbarrier phase count from j - j0, so producer and consumers agree
// whatever tile the loop starts at.  A row may see no key of its first
// tile (window 1024, 128-key tiles: row 128 qt + 127 in tile qt - 8):
// its scores are all -1e30, the running max stays -1e30, P = exp2(0) =
// 1 for those keys, and the next tile, which holds a key the row sees,
// rescales that by exp2(-1e30 - m) = 0, as the reference's next chunk
// does; the finite -1e30 keeps it NaN-free.  Bound at gemma3's local
// shape (B 1, S 32768, 32 / 16 heads, dh 128, window 1024): 33.03e6 kept
// (query, key) pairs a head, 5.41e11 operations, 0.547 ms at the bf16
// rate, against 0.805 GB of bytes, 0.240 ms: bound by operations, 16.3x
// fewer than causal.  The loop visits 9 tiles a query tile (8 at the
// window's start when window is a multiple of 128), about 1.1x the kept
// pairs; the kernel is the causal one otherwise, not tuned for windows.
// The window mode is its own instantiation of each kernel (template flag
// kWin, below), so the kernels without it keep the causal and full
// modes' tiles, order, arithmetic and code.
//
// Bound on the card.  The function reads q, k, v once and writes out
// once; at the serving path's shape (B = 2, S = 32768, 24 / 8 heads,
// dh = 128) that is ~1 GB, 0.3 ms at the HBM rate, against 1.3e13
// causal FLOPs, 13 ms at the bf16 tensor-core rate: it is bound by
// operations, and by the tensor cores in bf16.
//
// bfloat16 route (flash_bf16_kernel): wgmma + TMA, warp-specialised, the
// FlashAttention-3 arrangement, since Hopper reaches its tensor-core rate
// only through wgmma.  A block is 3 warpgroups and owns 128 query rows:
//
// * a producer warpgroup, shrunk with setmaxnreg to 24 registers, of
//   which one thread issues every copy: the Q tile once, then the K and
//   V tiles of 128 keys into a ring of 2 stages, each stage with a
//   "full" mbarrier (K and V apart, so Q K^T starts before V lands) and
//   an "empty" one.  Copies are TMA (cp.async.bulk.tensor), described by
//   tensor maps over the (dh, S, heads, B) view with the tensors' own
//   strides, so GQA still needs no copy; the maps are encoded on the host
//   per call (cuTensorMapEncodeTiled) and passed as __grid_constant__
//   parameters.  TMA zero-fills rows past S.  With the 128-byte swizzle
//   a box is 64 bf16 wide, so a 128-wide head is two boxes;
// * two consumer warpgroups of 64 query rows each, grown to 240
//   registers.  For each KV tile: S = Q K^T with wgmma.m64n128k16 (Q
//   and K from shared memory, K-major); the online softmax in registers
//   (ex2.approx.ftz, log2 e folded into sm_scale); P rounded to bf16
//   into the A-operand register layout (the accumulator layout of S is
//   that layout); O += P V with wgmma.m64n{dh}k16, V from shared memory
//   read transposed (MN-major, which 16-bit types allow).  After P V a
//   warp's lane 0 arrives on the stage's empty barrier; the producer
//   refills it when all 8 consumer warps have.
//
// While one consumer warpgroup runs its softmax the other's products
// use the tensor cores.  FlashAttention-3's two further overlaps were
// slower here, measured on the card: issuing tile j's Q K^T before tile
// j - 1's P V so that the softmax runs under P V, and making the two
// warpgroups take turns on named barriers (ping-pong).  P is rounded to
// bf16 before P V (the tensor cores take bf16), and that rounding, with
// the output's own rounding, is why the bf16 route is held to 2e-2 and
// not to the float32 route's 3e-5.  Shared memory: Q, 2 x K and 2 x V
// tiles of 128 rows, 160 KB at dh = 128 (80 KB at 64), one block an SM;
// the launch raises the dynamic limit first.  Query tiles are the
// slowest grid axis, the longest (causal) first across every head, so
// the short tail tiles fill the last wave.
//
// float32 route (flash_f32_kernel): split TF32 on the tensor cores.  It
// is held to 3e-5 (absolute and relative) against the plain float32
// version.  At (1, 4096, 24 / 8 heads, 128), causal, it does 1.03e11
// operations (4 dh a kept (query, key) pair): 1.54 ms on the float32
// pipe (67 TFLOP/s), 0.63 ms as three TF32 products on the tensor cores
// (495 TFLOP/s), against 0.04 ms of bytes.  One TF32 product (10
// mantissa bits) misses 3e-5 by 7-26x; three keep it.  Each float32
// operand is split x = hi + lo, hi rounded to TF32 to nearest (ties
// away, as cvt.rna.tf32.f32 but in two integer operations: cvt takes
// four) and lo = x - hi passed whole, which the tensor core reads
// truncated to TF32; a b = a_lo b_hi + a_hi b_lo + a_hi b_hi is summed
// in the float32 accumulator.  The dropped a_lo b_lo and lo's
// truncation stay within 2^-21 of a b, a few float32 units in the last
// place.  A CPU emulation puts the kernel's arithmetic 30-80x inside
// 3e-5 on N(0, 1) inputs at S 320 and 512, and one TF32 product 7-26x
// beyond (tools/flash_f32_emulation.py; tests/test_torch_flash_f32_split.py
// holds both).
//
// The products are mma.sync.m16n8k8 TF32, not wgmma: wgmma's TF32 form
// reads B only K-major from shared memory, so P V would need a
// transposed V, and both halves of K and V^T in shared memory (128 KB
// for a 64-key stage at dh 128).  A block is 8 warps and owns 128 query
// rows, 16 a warp.  The Q tile (raw) and a 2-stage ring of raw K and V
// tiles of 64 keys sit in shared memory, filled by cp.async from every
// thread (the next tile's copies fly while this one computes; rows past
// S land as zeros); each warp splits the fragments it reads.  In each
// 16-column slice of dh, a thread's A and B columns are dh 4t .. 4t + 3
// (the reduction may run in any order), so Q and K are read as float4.
// In each 8-key step of P V, A column t is key 2t and column t + 4 key
// 2t + 1, so the S accumulator is P's A fragment as it stands, with no
// shuffle, and V's B fragment is rows 2t, 2t + 1; V's columns are
// permuted so that a thread reads float2 and writes its output as
// float4.  Padded row strides keep the reads free of bank conflicts.
// With `causal` the loop ends at the query tile's diagonal, a warp skips
// a tile whose keys all lie past its rows, and only diagonal and ragged
// tiles are masked.  The online softmax is float32, exp2f with log2 e
// folded into the scale.  Query tiles run longest first, as in bf16.
//
// Row logsumexp (training).  Given an `lse` buffer, float32 (B, H, S),
// each kernel also writes every row's logsumexp of its scaled scores,
// (m + log2 l) ln 2 from the epilogue's running max m (log2 units) and
// sum l (floored at 1e-30, as the output's divisor): the residual that
// the backward kernels (csrc/flashattn_bwd.cu) need.  It is a template
// flag (kLse) like kWin, so the serving path, which passes no buffer,
// runs the kernels without it, instruction for instruction.
//
// The PTX helpers (mbarriers, TMA, wgmma, the split TF32 product and
// cp.async) and the tensor maps' encoding live in csrc/sm90.cuh, shared
// with the backward (csrc/flashattn_bwd.cu).
//
// Offsets are 64-bit (B S H dh passes 2^31 at the serving shapes).  The
// entry point launches on the caller's stream and returns
// cudaGetLastError() (or the error of raising the shared-memory limit);
// a tensor map the driver refuses returns minus its CUresult.  The
// caller raises on a non-zero code.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

#include "sm90.cuh"

namespace {

// float32 route
constexpr int kF32Rows = 128;         // query rows a block, 16 a warp
constexpr int kF32Keys = 64;          // keys a KV tile
constexpr int kF32Stages = 2;         // K/V ring
constexpr int kF32Threads = 256;      // 8 warps
// bfloat16 route
constexpr int kTile = 128;            // query rows a block, keys a KV tile
constexpr int kStages = 2;            // K/V ring
constexpr int kBf16Threads = 3 * kWgThreads;
constexpr int kBoxBytes = kTile * 128;

constexpr float kNegBig = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

typedef __nv_bfloat16 bf16;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  long long q_sb, q_ss, q_sh;  // strides in elements (dh is contiguous)
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  int seq;
  int group;                   // H / KV
  int causal;
  float sm_scale;
  int window;                  // sliding window (causal only); 0: none
  float* lse;                  // (B, H, S) row logsumexp, kLse only
};

// The window mode is a template flag (kWin) of each kernel, and every
// window term sits under `if constexpr (kWin)`: the kernels without it
// are the causal and full modes' code as it was, instruction for
// instruction.  (A runtime window in one kernel, folded to 0 by the
// compiler, still moved its schedule: the causal mode ran 16% slower at
// dh 128 and 27% at dh 64 on an NVIDIA H100 80GB HBM3 at 700.00 W.)

// the first KV tile of `tile` keys that holds a key of query tile qt's
// window (rows of `rows` a tile): key (first row) - window + 1
__device__ __forceinline__ int first_kv_tile(const Params& p, int qt,
                                             int rows, int tile) {
  return max(0, qt * rows - p.window + 1) / tile;
}

// ---------------------------------------------------------------------------
// bfloat16 route: wgmma + TMA, warp-specialised
// ---------------------------------------------------------------------------

// S (64 rows x 128 keys of one KV tile, wgmma accumulator layout) to
// log2 units, masked when `edge`, folded into the running max and sum:
// sc becomes P = exp2(S - m) (float32), alpha the factor that rescales
// the accumulator of the earlier tiles
template <bool kWin>
__device__ __forceinline__ void online_softmax(
    float (&sc)[64], float (&m_run)[2], float (&l_run)[2],
    float (&alpha)[2], float scale, bool edge, int k0, int row_a, int row_b,
    int t, const Params& p) {
  float mx[2] = {kNegBig, kNegBig};
#pragma unroll
  for (int nt = 0; nt < 16; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = sc[4 * nt + e] * scale;
      if (edge) {
        const int key = k0 + nt * 8 + t * 2 + (e & 1);
        const int row = (e < 2) ? row_a : row_b;
        if (key >= p.seq || (p.causal && key > row)) x = kNegBig;
        if constexpr (kWin) {
          if (row - key >= p.window) x = kNegBig;
        }
      }
      sc[4 * nt + e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m_run[r], mx[r]);
    alpha[r] = fast_exp2(m_run[r] - m_new);
    m_run[r] = m_new;
    l_run[r] *= alpha[r];
  }
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const int r = (i >> 1) & 1;
    sc[i] = fast_exp2(sc[i] - m_run[r]);
    l_run[r] += sc[i];
  }
}

// shared memory of one block: Q, then kStages K tiles, then kStages V
// tiles (each D / 64 boxes of 128 rows x 128 bytes), then the barriers;
// plus the slack that aligns the start to the swizzle atom
template <int D>
constexpr int bf16_smem_bytes() {
  return (1 + 2 * kStages) * (D / kBoxCols) * kBoxBytes
       + (1 + 3 * kStages) * 8 + kSwizzleAtom;
}

// kWin: the sliding-window mode (p.window > 0); without it the window
// is the constant 0.  kLse: write each row's logsumexp to p.lse
template <int D, bool kWin, bool kLse>
__global__ void __launch_bounds__(kBf16Threads, 1)
flash_bf16_kernel(const __grid_constant__ CUtensorMap tq,
                  const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv, const Params p) {
  constexpr int kBoxes = D / kBoxCols;
  constexpr int kTileBytes = kBoxes * kBoxBytes;
  constexpr int kSteps = D / 16;             // k-steps of Q K^T
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + kSwizzleAtom - 1)
                        & ~static_cast<uint32_t>(kSwizzleAtom - 1);
  const uint32_t q_s = base;
  const uint32_t k_s = q_s + kTileBytes;                 // + stage tiles
  const uint32_t v_s = k_s + kStages * kTileBytes;
  const uint32_t q_full = v_s + kStages * kTileBytes;
  const uint32_t k_full = q_full + 8;                    // + 8 * stage
  const uint32_t v_full = k_full + 8 * kStages;
  const uint32_t empty = v_full + 8 * kStages;

  const int n_qt = (p.seq + kTile - 1) / kTile;
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.z);  // long first
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int n_kv = p.causal ? qt + 1 : n_qt;
  int j0 = 0;                                // the loop's first KV tile
  if constexpr (kWin) j0 = first_kv_tile(p, qt, kTile, kTile);
  const int wg = threadIdx.x / kWgThreads;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(empty + 8 * s, 2 * kWgThreads / 32);   // consumer warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 :: "n"(kProducerRegs));
    if (threadIdx.x == 0) {
      const int kvh = h / p.group;
      mbar_expect_tx(q_full, kTileBytes);
      for (int x = 0; x < kBoxes; ++x)
        tma_load(q_s + x * kBoxBytes, &tq, q_full, x * kBoxCols, qt * kTile,
                 h, b);
      for (int j = j0; j < n_kv; ++j) {
        const int s = (j - j0) % kStages;
        mbar_wait(empty + 8 * s, (((j - j0) / kStages) & 1) ^ 1);
        mbar_expect_tx(k_full + 8 * s, kTileBytes);
        for (int x = 0; x < kBoxes; ++x)
          tma_load(k_s + s * kTileBytes + x * kBoxBytes, &tk, k_full + 8 * s,
                   x * kBoxCols, j * kTile, kvh, b);
        mbar_expect_tx(v_full + 8 * s, kTileBytes);
        for (int x = 0; x < kBoxes; ++x)
          tma_load(v_s + s * kTileBytes + x * kBoxBytes, &tv, v_full + 8 * s,
                   x * kBoxCols, j * kTile, kvh, b);
      }
    }
  } else {
    // consumer warpgroup c: query rows 64 c .. 64 c + 63 of the tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
                 :: "n"(kConsumerRegs));
    const int c = wg - 1;
    const int tid = threadIdx.x - wg * kWgThreads;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int g = lane >> 2;                 // row in the 8-row group
    const int t = lane & 3;                  // thread in the group
    const int row_a = qt * kTile + c * 64 + warp * 16 + g;
    const int row_b = row_a + 8;
    const float scale = p.sm_scale * kLog2e;

    float acc[D / 2];                        // O: D / 8 n8-blocks x 4
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;
    float m_run[2] = {kNegBig, kNegBig};     // rows g and g + 8
    float l_run[2] = {0.0f, 0.0f};           // this thread's columns
    float alpha[2];                          // rescale of acc before P V
    float sc[64];                            // S, then P: 16 n8-blocks x 4
#pragma unroll
    for (int i = 0; i < 64; ++i) sc[i] = 0.0f;
    uint32_t pa[8][4];                       // P in bf16, A-operand layout
    const uint32_t q_rows = q_s + c * 64 * 128;

    mbar_wait(q_full, 0);
    for (int j = j0; j < n_kv; ++j) {
      const int s = (j - j0) % kStages;
      const uint32_t parity = ((j - j0) / kStages) & 1;
      // S = Q K^T: this warpgroup's 64 rows against the tile's 128 keys
      mbar_wait(k_full + 8 * s, parity);
      fence_regs(sc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk) {
        const uint32_t off = (kk / 4) * kBoxBytes + (kk % 4) * 32;
        wgmma_ss_n128(sc, smem_desc(q_rows + off, 16, kSwizzleAtom),
                      smem_desc(k_s + s * kTileBytes + off, 16, kSwizzleAtom),
                      kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);

      const int k0 = j * kTile;
      bool edge = (p.causal && j == qt) || k0 + kTile > p.seq;
      // a tile where a window begins: the query tile's last row sees no
      // key k0
      if constexpr (kWin)
        edge = edge || qt * kTile + kTile - 1 - k0 >= p.window;
      online_softmax<kWin>(sc, m_run, l_run, alpha, scale, edge, k0, row_a,
                           row_b, t, p);
      pack_a<8>(sc, pa);
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        acc[4 * i] *= alpha[0];
        acc[4 * i + 1] *= alpha[0];
        acc[4 * i + 2] *= alpha[1];
        acc[4 * i + 3] *= alpha[1];
      }

      // O += P V: V's 16-key slices MN-major, the dh boxes kBoxBytes apart
      mbar_wait(v_full + 8 * s, parity);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
        wgmma_pv<D>(acc, pa[kk],
                    smem_desc(v_s + s * kTileBytes + kk * 16 * 128,
                              kBoxBytes, kSwizzleAtom));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      // this warp is done with the stage
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * s);
    }

    // out = acc / max(l, 1e-30); l summed over the row's four threads
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float l = l_run[r];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      inv[r] = 1.0f / fmaxf(l, 1e-30f);
      if constexpr (kLse) {
        const int row = r ? row_b : row_a;
        if (t == 0 && row < p.seq)
          p.lse[(static_cast<long long>(b) * gridDim.x + h) * p.seq + row] =
              (m_run[r] + log2f(fmaxf(l, 1e-30f))) * kLn2;
      }
    }
    bf16* og = static_cast<bf16*>(p.o) + b * p.o_sb + h * p.o_sh;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      const int col = i * 8 + t * 2;
      if (row_a < p.seq)
        *reinterpret_cast<uint32_t*>(og + row_a * p.o_ss + col) =
            pack_bf16(acc[4 * i] * inv[0], acc[4 * i + 1] * inv[0]);
      if (row_b < p.seq)
        *reinterpret_cast<uint32_t*>(og + row_b * p.o_ss + col) =
            pack_bf16(acc[4 * i + 2] * inv[1], acc[4 * i + 3] * inv[1]);
    }
  }
}

// ---------------------------------------------------------------------------
// float32 route: split TF32 on the tensor cores (mma.sync), cp.async ring
// ---------------------------------------------------------------------------

// Row strides (floats) of the Q, K and V tiles in shared memory.  Q and
// K are read as float4 at column 4t of rows g: a quarter warp is rows g,
// g + 1, so a stride of 16 banks (mod 32) puts them on disjoint halves.
// V is read as float2 at column 2g of rows 2t: a half warp is rows 0, 2,
// 4, 6 apart, so a stride of 4 banks (mod 16) puts them 8 banks apart.
template <int D>
__host__ __device__ constexpr int f32_ld_qk() {
  return D % 32 == 16 ? D : D + 16;
}

template <int D>
__host__ __device__ constexpr int f32_ld_v() {
  return D + 4;
}

// shared memory of one block: the Q tile, then kF32Stages x (K tile, V
// tile)
template <int D>
constexpr int f32_smem_bytes() {
  return (kF32Rows * f32_ld_qk<D>()
          + kF32Stages * kF32Keys * (f32_ld_qk<D>() + f32_ld_v<D>())) * 4;
}

// rows r0 .. r0 + ROWS - 1 of a (seq, D) float32 slab of row stride ss
// into shared memory at row stride LD, every thread of the block a
// share, asynchronously; rows past seq land as zeros
template <int D, int ROWS, int LD>
__device__ __forceinline__ void load_rows_f32(uint32_t dst, const float* src,
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

// kWin: the sliding-window mode, kLse the logsumexp output, as in
// flash_bf16_kernel
template <int D, bool kWin, bool kLse>
__global__ void __launch_bounds__(kF32Threads, 1)
flash_f32_kernel(const Params p) {
  constexpr int kLd = f32_ld_qk<D>();                // Q and K rows
  constexpr int kLdV = f32_ld_v<D>();
  constexpr int kStage = kF32Keys * (kLd + kLdV);    // floats a stage
  constexpr int kSlices = D / 16;                    // 16-column slices of dh
  constexpr int kKeyBlocks = kF32Keys / 8;           // n8-blocks a tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const float* q_tile = reinterpret_cast<const float*>(smem_raw);
  const float* ring = q_tile + kF32Rows * kLd;
  const uint32_t q_s = smem_addr(smem_raw);
  const uint32_t ring_s = q_s + kF32Rows * kLd * 4;

  const int n_qt = (p.seq + kF32Rows - 1) / kF32Rows;
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.z);  // long first
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int kvh = h / p.group;
  const int n_kt = (p.seq + kF32Keys - 1) / kF32Keys;
  const int n_kv = p.causal ? min(n_kt, (qt + 1) * (kF32Rows / kF32Keys))
                            : n_kt;
  int j0 = 0;                                // the loop's first KV tile
  if constexpr (kWin) j0 = first_kv_tile(p, qt, kF32Rows, kF32Keys);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;                   // row in the 8-row group
  const int t = lane & 3;                    // thread in the group
  const int r0 = qt * kF32Rows + warp * 16;  // this warp's first row
  const int row_a = r0 + g;
  const int row_b = row_a + 8;
  const float* qg = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kg = static_cast<const float*>(p.k) + b * p.k_sb
      + kvh * p.k_sh;
  const float* vg = static_cast<const float*>(p.v) + b * p.v_sb
      + kvh * p.v_sh;

  // the Q tile and KV tile j0: one group of copies
  load_rows_f32<D, kF32Rows, kLd>(q_s, qg, p.q_ss, qt * kF32Rows, p.seq);
  load_rows_f32<D, kF32Keys, kLd>(ring_s, kg, p.k_ss, j0 * kF32Keys, p.seq);
  load_rows_f32<D, kF32Keys, kLdV>(ring_s + kF32Keys * kLd * 4, vg, p.v_ss,
                                   j0 * kF32Keys, p.seq);
  cp_async_commit();
  // this thread's Q rows g and g + 8 of the warp's 16, at column 4 t
  const float* q_rows = q_tile + (warp * 16 + g) * kLd + 4 * t;
  float acc[D / 8][4];                       // O: D / 8 n8-blocks
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.0f;
  float m_run[2] = {kNegBig, kNegBig};       // rows g and g + 8, log2 units
  float l_run[2] = {0.0f, 0.0f};             // this thread's columns
  const float scale = p.sm_scale * kLog2e;

  for (int j = j0; j < n_kv; ++j) {
    const int s = (j - j0) % kF32Stages;
    if (j + 1 < n_kv) {
      const uint32_t next = ring_s
          + ((j - j0 + 1) % kF32Stages) * kStage * 4;
      load_rows_f32<D, kF32Keys, kLd>(next, kg, p.k_ss, (j + 1) * kF32Keys,
                                      p.seq);
      load_rows_f32<D, kF32Keys, kLdV>(next + kF32Keys * kLd * 4, vg, p.v_ss,
                                       (j + 1) * kF32Keys, p.seq);
    }
    cp_async_commit();         // (empty on the last tile)
    cp_async_wait<1>();        // this tile's copies have landed
    __syncthreads();
    const int k0 = j * kF32Keys;
    // a warp whose rows all lie past S, or (causal) before every key of
    // the tile, or (window) a window or more past every key of it, gains
    // nothing from it
    if (r0 < p.seq && !(p.causal && k0 > r0 + 15)
        && !(kWin && r0 - (k0 + kF32Keys - 1) >= p.window)) {
      const float* ks = ring + s * kStage;
      const float* vs = ks + kF32Keys * kLd;
      // S = Q K^T: in slice i, k-step e takes columns 16 i + 4 t + 2 e
      // (A column t) and + 1 (A column t + 4), for A and B alike
      float sc[kKeyBlocks][4];               // S
#pragma unroll
      for (int n = 0; n < kKeyBlocks; ++n)
        sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.0f;
#pragma unroll
      for (int i = 0; i < kSlices; ++i) {
        const float4 qa = *reinterpret_cast<const float4*>(q_rows + 16 * i);
        const float4 qb = *reinterpret_cast<const float4*>(
            q_rows + 8 * kLd + 16 * i);
        uint32_t ah[2][4], al[2][4];
        split_tf32(qa.x, ah[0][0], al[0][0]);
        split_tf32(qb.x, ah[0][1], al[0][1]);
        split_tf32(qa.y, ah[0][2], al[0][2]);
        split_tf32(qb.y, ah[0][3], al[0][3]);
        split_tf32(qa.z, ah[1][0], al[1][0]);
        split_tf32(qb.z, ah[1][1], al[1][1]);
        split_tf32(qa.w, ah[1][2], al[1][2]);
        split_tf32(qb.w, ah[1][3], al[1][3]);
#pragma unroll
        for (int n = 0; n < kKeyBlocks; ++n) {
          const float4 kx = *reinterpret_cast<const float4*>(
              ks + (8 * n + g) * kLd + 16 * i + 4 * t);
          uint32_t bh[2][2], bl[2][2];
          split_tf32(kx.x, bh[0][0], bl[0][0]);
          split_tf32(kx.y, bh[0][1], bl[0][1]);
          split_tf32(kx.z, bh[1][0], bl[1][0]);
          split_tf32(kx.w, bh[1][1], bl[1][1]);
          mma3_tf32(sc[n], ah[0], al[0], bh[0], bl[0]);
          mma3_tf32(sc[n], ah[1], al[1], bh[1], bl[1]);
        }
      }

      // online softmax: sc[n] holds rows g (0, 1) and g + 8 (2, 3) at
      // keys k0 + 8 n + 2 t (0, 2) and + 1 (1, 3)
      bool edge = k0 + kF32Keys > p.seq
          || (p.causal && k0 + kF32Keys - 1 > r0);
      if constexpr (kWin) edge = edge || r0 + 15 - k0 >= p.window;
      float mx[2] = {kNegBig, kNegBig};
#pragma unroll
      for (int n = 0; n < kKeyBlocks; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = sc[n][e] * scale;
          if (edge) {
            const int key = k0 + 8 * n + 2 * t + (e & 1);
            const int row = e < 2 ? row_a : row_b;
            if (key >= p.seq || (p.causal && key > row)) x = kNegBig;
            if constexpr (kWin) {
              if (row - key >= p.window) x = kNegBig;
            }
          }
          sc[n][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m_run[r], mx[r]);
        alpha[r] = exp2f(m_run[r] - m_new);
        m_run[r] = m_new;
        l_run[r] *= alpha[r];
      }
#pragma unroll
      for (int n = 0; n < kKeyBlocks; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sc[n][e] = exp2f(sc[n][e] - m_run[e >> 1]);
          l_run[e >> 1] += sc[n][e];
        }
      }
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        acc[i][0] *= alpha[0];
        acc[i][1] *= alpha[0];
        acc[i][2] *= alpha[1];
        acc[i][3] *= alpha[1];
      }

      // O += P V: in key step n, A column t is key 8 n + 2 t and column
      // t + 4 key 8 n + 2 t + 1, so sc[n] is the A fragment as it
      // stands; B's column g of n8-block 2 i + c is V column 16 i + 2 g + c
#pragma unroll
      for (int n = 0; n < kKeyBlocks; ++n) {
        uint32_t ph[4], pl[4];
        split_tf32(sc[n][0], ph[0], pl[0]);
        split_tf32(sc[n][2], ph[1], pl[1]);
        split_tf32(sc[n][1], ph[2], pl[2]);
        split_tf32(sc[n][3], ph[3], pl[3]);
        const float* v0 = vs + (8 * n + 2 * t) * kLdV + 2 * g;
#pragma unroll
        for (int i = 0; i < kSlices; ++i) {
          const float2 x0 = *reinterpret_cast<const float2*>(v0 + 16 * i);
          const float2 x1 = *reinterpret_cast<const float2*>(
              v0 + kLdV + 16 * i);
          uint32_t bh[2][2], bl[2][2];
          split_tf32(x0.x, bh[0][0], bl[0][0]);
          split_tf32(x1.x, bh[0][1], bl[0][1]);
          split_tf32(x0.y, bh[1][0], bl[1][0]);
          split_tf32(x1.y, bh[1][1], bl[1][1]);
          mma3_tf32(acc[2 * i], ph, pl, bh[0], bl[0]);
          mma3_tf32(acc[2 * i + 1], ph, pl, bh[1], bl[1]);
        }
      }
    }
    __syncthreads();           // before the next pass refills this stage
  }

  // out = acc / max(l, 1e-30), l summed over the row's four threads; in
  // slice i this thread holds columns 16 i + 4 t .. + 3 of rows g, g + 8
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv[r] = 1.0f / fmaxf(l, 1e-30f);
    if constexpr (kLse) {
      const int row = r ? row_b : row_a;
      if (t == 0 && row < p.seq)
        p.lse[(static_cast<long long>(b) * gridDim.x + h) * p.seq + row] =
            (m_run[r] + log2f(fmaxf(l, 1e-30f))) * kLn2;
    }
  }
  float* og = static_cast<float*>(p.o) + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int i = 0; i < kSlices; ++i) {
    const int col = 16 * i + 4 * t;
    if (row_a < p.seq)
      *reinterpret_cast<float4*>(og + row_a * p.o_ss + col) = make_float4(
          acc[2 * i][0] * inv[0], acc[2 * i + 1][0] * inv[0],
          acc[2 * i][1] * inv[0], acc[2 * i + 1][1] * inv[0]);
    if (row_b < p.seq)
      *reinterpret_cast<float4*>(og + row_b * p.o_ss + col) = make_float4(
          acc[2 * i][2] * inv[1], acc[2 * i + 1][2] * inv[1],
          acc[2 * i][3] * inv[1], acc[2 * i + 1][3] * inv[1]);
  }
}

template <int D, bool kWin, bool kLse>
int launch_f32(const Params& p, int batch, int n_heads, cudaStream_t stream) {
  const int smem = f32_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_f32_kernel<D, kWin, kLse>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_qt = (p.seq + kF32Rows - 1) / kF32Rows;
  if (n_qt > 65535 || batch > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(n_heads, batch, n_qt);
  flash_f32_kernel<D, kWin, kLse><<<grid, kF32Threads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int D, bool kWin, bool kLse>
int launch_bf16(const Params& p, int batch, int n_heads, int n_kv_heads,
                cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  CUresult res = encode_map(&tq, p.q, D, p.seq, n_heads, batch, p.q_ss,
                            p.q_sh, p.q_sb, kTile);
  if (res == CUDA_SUCCESS)
    res = encode_map(&tk, p.k, D, p.seq, n_kv_heads, batch, p.k_ss, p.k_sh,
                     p.k_sb, kTile);
  if (res == CUDA_SUCCESS)
    res = encode_map(&tv, p.v, D, p.seq, n_kv_heads, batch, p.v_ss, p.v_sh,
                     p.v_sb, kTile);
  if (res != CUDA_SUCCESS) return -static_cast<int>(res);
  const int smem = bf16_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bf16_kernel<D, kWin, kLse>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_qt = (p.seq + kTile - 1) / kTile;
  if (n_qt > 65535 || batch > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(n_heads, batch, n_qt);
  flash_bf16_kernel<D, kWin, kLse><<<grid, kBf16Threads, smem, stream>>>(
      tq, tk, tv, p);
  return static_cast<int>(cudaGetLastError());
}

// the kernel of (dtype, head_dim) in the mode (kWin, kLse)
template <bool kWin, bool kLse>
int launch_mode(const Params& p, int batch, int n_heads, int n_kv_heads,
                int head_dim, int dtype, cudaStream_t s) {
  if (dtype == 1 && head_dim == 128)
    return launch_bf16<128, kWin, kLse>(p, batch, n_heads, n_kv_heads, s);
  if (dtype == 1 && head_dim == 64)
    return launch_bf16<64, kWin, kLse>(p, batch, n_heads, n_kv_heads, s);
  if (dtype == 0 && head_dim == 128)
    return launch_f32<128, kWin, kLse>(p, batch, n_heads, s);
  if (dtype == 0 && head_dim == 64)
    return launch_f32<64, kWin, kLse>(p, batch, n_heads, s);
  if (dtype == 0 && head_dim == 16)
    return launch_f32<16, kWin, kLse>(p, batch, n_heads, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  window: 0 none, else (causal only) the
// sliding window.  lse: null (serving), or a float32 (B, H, S) buffer
// for each row's logsumexp.  Strides in elements; the last axis of every
// tensor is contiguous.  Returns a CUDA error code (0 = launched), or
// minus the CUresult of a tensor map that cuTensorMapEncodeTiled refused.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh,
    int batch, int seq, int n_heads, int n_kv_heads, int head_dim,
    int dtype, int causal, int window, float sm_scale, void* stream,
    float* lse) {
  if (seq < 1 || batch < 1 || n_heads < 1 || n_kv_heads < 1
      || n_heads % n_kv_heads != 0 || window < 0 || (window > 0 && !causal))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{q, k, v, o, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
           o_sb, o_ss, o_sh, seq, n_heads / n_kv_heads, causal, sm_scale,
           window, lse};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (window > 0)
    return lse ? launch_mode<true, true>(p, batch, n_heads, n_kv_heads,
                                         head_dim, dtype, s)
               : launch_mode<true, false>(p, batch, n_heads, n_kv_heads,
                                          head_dim, dtype, s);
  return lse ? launch_mode<false, true>(p, batch, n_heads, n_kv_heads,
                                        head_dim, dtype, s)
             : launch_mode<false, false>(p, batch, n_heads, n_kv_heads,
                                         head_dim, dtype, s);
}
