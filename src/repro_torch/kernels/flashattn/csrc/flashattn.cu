// Flash attention (fused online softmax) on Hopper (sm_90a), plain C
// interface:
//
//   out[b, s, h] = softmax_k(q[b, s, h] . k[b, k, h / g] * sm_scale,
//                            masked to k <= s when causal)
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
// diagonal tile (and a ragged last tile) is masked.  Every row starts at
// KV tile 0, which always holds a key the row may see, so the finite
// -1e30 mask of the reference never gives exp(m - m) = 1 for a masked
// key.  Keys past S are masked and query rows past S are not written;
// the TPU's S % block == 0 is a fact of its tiling, not of the function.
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
// float32 route (flash_f32_kernel).  64-row query tiles, scalar FMAs, so
// that the float32 comparison shows the algorithm without bfloat16
// rounding: two threads a query row, each scoring every other key of the
// tile and accumulating every other output column.
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

namespace {

// float32 route
constexpr int kBlockM = 64;   // query rows a block
constexpr int kBlockN = 64;   // keys a KV tile
constexpr int kThreads = 128;
// bfloat16 route
constexpr int kTile = 128;            // query rows a block, keys a KV tile
constexpr int kStages = 2;            // K/V ring
constexpr int kWgThreads = 128;       // one warpgroup
constexpr int kBf16Threads = 3 * kWgThreads;
constexpr int kBoxCols = 64;          // bf16 columns of one 128-byte row
constexpr int kBoxBytes = kTile * 128;
constexpr int kSwizzleAtom = 1024;    // 8 rows of 128 bytes
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;

constexpr float kNegBig = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

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
};

// ---------------------------------------------------------------------------
// PTX helpers
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// two floats as a bf16 pair, the first in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

// one arrival that also expects `bytes` of TMA transactions
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

// until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred P1;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\nbra LAB_WAIT;\nDONE:\n}\n"
      :: "r"(bar), "r"(parity) : "memory");
}

// box (c0 column, c1 row, c2 head, c3 batch) of `map` into shared memory
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
         "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// shared-memory matrix descriptor, 128-byte swizzle; offsets in bytes
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
       | static_cast<uint64_t>(lbo >> 4) << 16
       | static_cast<uint64_t>(sbo >> 4) << 32
       | 1ull << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// until at most N committed groups of products are pending
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// keeps the compiler from moving accesses of an accumulator across the
// asynchronous products
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

// d (64 x 128, float32) = a (64 x 16) b (16 x 128) [+ d when scale_d]:
// a and b both K-major in shared memory (128-byte swizzle)
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
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
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 128, float32) += a (64 x 16, bf16 registers) b (16 x 128):
// b MN-major in shared memory (128-byte swizzle), read transposed
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 64, float32) += a (64 x 16, bf16 registers) b (16 x 64):
// b MN-major in shared memory (128-byte swizzle), read transposed
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_pv(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t db);

template <>
__device__ __forceinline__ void wgmma_pv<128>(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  wgmma_rs_n128(d, a, db);
}

template <>
__device__ __forceinline__ void wgmma_pv<64>(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  wgmma_rs_n64(d, a, db);
}

// ---------------------------------------------------------------------------
// bfloat16 route: wgmma + TMA, warp-specialised
// ---------------------------------------------------------------------------

// 2^x on the special-function unit, subnormal results flushed to zero
// (exp2f adds range scaling around the same instruction)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// S (64 rows x 128 keys of one KV tile, wgmma accumulator layout) to
// log2 units, masked when `edge`, folded into the running max and sum:
// sc becomes P = exp2(S - m) (float32), alpha the factor that rescales
// the accumulator of the earlier tiles
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

// P (float32, accumulator layout) rounded to bf16 in the A-operand
// layout of m64k16: per 16 keys, rows g and g + 8, keys 2t, 2t + 1 and
// 2t + 8, 2t + 9
__device__ __forceinline__ void pack_p(const float (&sc)[64],
                                       uint32_t (&pa)[8][4]) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    pa[kk][0] = pack_bf16(sc[8 * kk], sc[8 * kk + 1]);
    pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
    pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
    pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
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

template <int D>
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
      for (int j = 0; j < n_kv; ++j) {
        const int s = j % kStages;
        mbar_wait(empty + 8 * s, ((j / kStages) & 1) ^ 1);
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
    for (int j = 0; j < n_kv; ++j) {
      const int s = j % kStages;
      const uint32_t parity = (j / kStages) & 1;
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
      online_softmax(sc, m_run, l_run, alpha, scale,
                     (p.causal && j == qt) || k0 + kTile > p.seq, k0, row_a,
                     row_b, t, p);
      pack_p(sc, pa);
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
// float32 route: the same structure with scalar FMAs
// ---------------------------------------------------------------------------

// rows row0 .. row0 + 63 into a shared tile of row stride `ld`; rows >=
// seq are zeros
template <int D>
__device__ __forceinline__ void load_tile_f32(float* tile,
                                              const float* __restrict__ base,
                                              long long stride, int row0,
                                              int seq, int ld) {
  for (int c = threadIdx.x; c < kBlockM * D; c += kThreads) {
    const int r = c / D;
    const int col = c % D;
    const int row = row0 + r;
    tile[r * ld + col] =
        row < seq ? base[(long long)row * stride + col] : 0.0f;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_f32_kernel(const Params p) {
  constexpr int kLd = D + 1;                      // Q, K rows (padded)
  constexpr int kLdP = kBlockN + 1;
  constexpr int kHalf = D / 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* q_s = reinterpret_cast<float*>(smem_raw);
  float* k_s = q_s + kBlockM * kLd;
  float* v_s = k_s + kBlockN * kLd;               // rows of D
  float* p_s = v_s + kBlockN * D;                 // (64, 65) probabilities

  const int n_qt = (p.seq + kBlockM - 1) / kBlockM;
  const int qt = n_qt - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / p.group;
  const int r = threadIdx.x >> 1;                 // this thread's row
  const int half = threadIdx.x & 1;               // keys / columns of parity
  const float* qg = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kg = static_cast<const float*>(p.k) + b * p.k_sb
      + kvh * p.k_sh;
  const float* vg = static_cast<const float*>(p.v) + b * p.v_sb
      + kvh * p.v_sh;
  const int q0 = qt * kBlockM;
  const int row = q0 + r;
  const int n_kv = p.causal ? qt + 1 : n_qt;

  load_tile_f32<D>(q_s, qg, p.q_ss, q0, p.seq, kLd);
  float acc[kHalf];
#pragma unroll
  for (int i = 0; i < kHalf; ++i) acc[i] = 0.0f;
  float m_run = kNegBig;
  float l_run = 0.0f;

  for (int j = 0; j < n_kv; ++j) {
    const int k0 = j * kBlockN;
    load_tile_f32<D>(k_s, kg, p.k_ss, k0, p.seq, kLd);
    load_tile_f32<D>(v_s, vg, p.v_ss, k0, p.seq, D);
    __syncthreads();

    // scores of keys 2i + half, i = 0 .. 31
    float s[kBlockN / 2];
#pragma unroll
    for (int i = 0; i < kBlockN / 2; ++i) s[i] = 0.0f;
    for (int d = 0; d < D; ++d) {
      const float qv = q_s[r * kLd + d];
#pragma unroll
      for (int i = 0; i < kBlockN / 2; ++i)
        s[i] = fmaf(qv, k_s[(2 * i + half) * kLd + d], s[i]);
    }
    float mx = kNegBig;
#pragma unroll
    for (int i = 0; i < kBlockN / 2; ++i) {
      const int key = k0 + 2 * i + half;
      float x = s[i] * p.sm_scale;
      if (key >= p.seq || (p.causal && key > row)) x = kNegBig;
      s[i] = x;
      mx = fmaxf(mx, x);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m_run, mx);
    const float alpha = expf(m_run - m_new);
    m_run = m_new;
    l_run *= alpha;
#pragma unroll
    for (int i = 0; i < kBlockN / 2; ++i) {
      const float pe = expf(s[i] - m_new);
      l_run += pe;
      p_s[r * kLdP + 2 * i + half] = pe;
    }
    __syncwarp();      // a row's two threads share a warp
#pragma unroll
    for (int i = 0; i < kHalf; ++i) acc[i] *= alpha;
    for (int key = 0; key < kBlockN; ++key) {
      const float pk = p_s[r * kLdP + key];
#pragma unroll
      for (int i = 0; i < kHalf; ++i)
        acc[i] = fmaf(pk, v_s[key * D + 2 * i + half], acc[i]);
    }
    __syncthreads();   // before the next tile overwrites k_s, v_s, p_s
  }

  const float l = fmaxf(l_run + __shfl_xor_sync(0xffffffffu, l_run, 1),
                        1e-30f);
  if (row < p.seq) {
    float* og = static_cast<float*>(p.o) + b * p.o_sb + h * p.o_sh
        + (long long)row * p.o_ss;
#pragma unroll
    for (int i = 0; i < kHalf; ++i) og[2 * i + half] = acc[i] / l;
  }
}

template <typename Kernel>
cudaError_t launch_f32(Kernel kernel, const Params& p, int batch,
                       int n_heads, int smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.seq + kBlockM - 1) / kBlockM, n_heads, batch);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// A (dh, S, heads, B) bf16 view with element strides (ss, sh, sb), in
// boxes of 64 columns x kTile rows, 128-byte swizzle, zeros past S
CUresult encode_map(CUtensorMap* map, const void* ptr, int head_dim, int seq,
                    int heads, int batch, long long ss, long long sh,
                    long long sb) {
  const cuuint64_t dims[4] = {(cuuint64_t)head_dim, (cuuint64_t)seq,
                              (cuuint64_t)heads, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)ss * 2, (cuuint64_t)sh * 2,
                                 (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {kBoxCols, kTile, 1, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  return cuTensorMapEncodeTiled(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <int D>
int launch_bf16(const Params& p, int batch, int n_heads, int n_kv_heads,
                cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  CUresult res = encode_map(&tq, p.q, D, p.seq, n_heads, batch, p.q_ss,
                            p.q_sh, p.q_sb);
  if (res == CUDA_SUCCESS)
    res = encode_map(&tk, p.k, D, p.seq, n_kv_heads, batch, p.k_ss, p.k_sh,
                     p.k_sb);
  if (res == CUDA_SUCCESS)
    res = encode_map(&tv, p.v, D, p.seq, n_kv_heads, batch, p.v_ss, p.v_sh,
                     p.v_sb);
  if (res != CUDA_SUCCESS) return -static_cast<int>(res);
  const int smem = bf16_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bf16_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_qt = (p.seq + kTile - 1) / kTile;
  if (n_qt > 65535 || batch > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(n_heads, batch, n_qt);
  flash_bf16_kernel<D><<<grid, kBf16Threads, smem, stream>>>(tq, tk, tv, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  Strides in elements; the last axis of
// every tensor is contiguous.  Returns a CUDA error code (0 = launched),
// or minus the CUresult of a tensor map the driver refused.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh,
    int batch, int seq, int n_heads, int n_kv_heads, int head_dim,
    int dtype, int causal, float sm_scale, void* stream) {
  if (seq < 1 || batch < 1 || n_heads < 1 || n_kv_heads < 1
      || n_heads % n_kv_heads != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{q, k, v, o, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
           o_sb, o_ss, o_sh, seq, n_heads / n_kv_heads, causal, sm_scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int f32_smem = (kBlockM * (head_dim + 1) * 2 + kBlockN * head_dim
                        + kBlockM * (kBlockN + 1)) * 4;
  if (dtype == 1 && head_dim == 128)
    return launch_bf16<128>(p, batch, n_heads, n_kv_heads, s);
  if (dtype == 1 && head_dim == 64)
    return launch_bf16<64>(p, batch, n_heads, n_kv_heads, s);
  if (dtype == 0 && head_dim == 128)
    return static_cast<int>(launch_f32(flash_f32_kernel<128>, p, batch,
                                       n_heads, f32_smem, s));
  if (dtype == 0 && head_dim == 64)
    return static_cast<int>(launch_f32(flash_f32_kernel<64>, p, batch,
                                       n_heads, f32_smem, s));
  if (dtype == 0 && head_dim == 16)
    return static_cast<int>(launch_f32(flash_f32_kernel<16>, p, batch,
                                       n_heads, f32_smem, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
