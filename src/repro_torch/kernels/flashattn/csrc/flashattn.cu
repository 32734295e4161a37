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
// bfloat16), divided by max(l, 1e-30).  dh is 64 or 128; any S >= 1.
//
// Replaces the TPU kernel
//   src/repro/kernels/flashattn/kernel.py: flash_attention_pallas
// (body _kernel).  The TPU walks a (BH, q-block, kv-block) grid whose kv
// axis runs in order on one core, carrying (m, l, acc) in VMEM scratch
// from step to step, and masks the blocks above the diagonal instead of
// skipping them.  The card's blocks run in no order, so here one thread
// block owns one (b, h, 64-row query tile) and walks the KV tiles from
// 0 upward in a loop of its own: (m, l, acc) stay in registers and
// never reach device memory.  With `causal` the loop ends at the query
// tile's diagonal, so the tiles above it are skipped, not masked.  Every
// row starts at KV tile 0, which always holds a key the row may see, so
// the finite -1e30 mask of the reference never gives exp(m - m) = 1 for
// a masked key.  The ragged last tile is masked (keys >= S) and query
// rows >= S are not written; the TPU's S % block == 0 is a fact of its
// tiling, not of the function.
//
// Bound on the card.  The function reads q, k, v once and writes out
// once; at the serving path's shape (B = 2, S = 32768, 24 / 8 heads,
// dh = 128) that is ~1 GB, 0.3 ms at the HBM rate, against 1.3e13
// causal FLOPs, 13 ms at the bf16 tensor-core rate: it is bound by
// operations, and by the tensor cores in bf16.
//
// bfloat16 route (flash_bf16_kernel).  The FlashAttention-2 arrangement
// with mma.sync.m16n8k16 (bf16 in, float32 accumulate): 4 warps a block,
// each owning 16 query rows.  The Q tile is staged in shared memory once
// and held in registers as A fragments; K and V tiles of 64 keys are
// double-buffered in shared memory with cp.async (16 bytes a thread,
// zero-filled past S), so the next tile's copy overlaps this tile's
// products.  Shared-memory rows are padded by 8 elements, so ldmatrix
// reads eight rows from eight distinct bank groups.  S = Q K^T comes out
// of the products in the accumulator layout, which is the A-fragment
// layout of the P V product: the probabilities never leave registers.
// P is rounded to bfloat16 before P V (the tensor cores take bf16), and
// that rounding, with the output's own rounding, is why the bf16 route
// is held to 2e-2 and not to the float32 route's 3e-5.  exp2f with
// log2(e) folded into sm_scale.  Shared memory: (64 + 4 * 64) rows of
// dh + 8 bf16, 85 KB at dh = 128, above the 48 KB default, so the launch
// raises the dynamic limit first.
//
// float32 route (flash_f32_kernel).  The same block structure with
// scalar FMAs, so that the float32 comparison shows the algorithm
// without bfloat16 rounding: two threads a query row, each scoring every
// other key of the tile and accumulating every other output column.
//
// Not here: wgmma, TMA and warp specialisation, the way to the card's
// full tensor-core rate; they are the later kernel work.
//
// Offsets are 64-bit (B S H dh passes 2^31 at the serving shapes).  The
// entry point launches on the caller's stream and returns
// cudaGetLastError() (or the error of raising the shared-memory limit);
// the caller raises on a non-zero code.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int kBlockM = 64;   // query rows a block
constexpr int kBlockN = 64;   // keys a KV tile
constexpr int kThreads = 128;
constexpr int kPad = 8;       // bf16 elements of padding a shared row
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

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zero-filled when !valid (src not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a (16x16, row) * b (16x8, col), bf16 in, float32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats as a bf16 pair, the first in the low half
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// ---------------------------------------------------------------------------
// bfloat16 route: mma.sync, FlashAttention-2 arrangement
// ---------------------------------------------------------------------------

// rows row0 .. row0 + 63 of a (S, D) slice with row stride `stride` into
// a shared tile of rows D + kPad; rows >= seq are zero-filled
template <int D>
__device__ __forceinline__ void load_tile_bf16(bf16* tile,
                                               const bf16* __restrict__ base,
                                               long long stride, int row0,
                                               int seq) {
  constexpr int kChunksPerRow = D / 8;            // 16-byte chunks
  constexpr int kChunks = kBlockM * kChunksPerRow;
  for (int c = threadIdx.x; c < kChunks; c += kThreads) {
    const int r = c / kChunksPerRow;
    const int col = (c % kChunksPerRow) * 8;
    const int row = row0 + r;
    const bool valid = row < seq;
    const bf16* src = valid ? base + (long long)row * stride + col : base;
    cp_async16(tile + r * (D + kPad) + col, src, valid);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bf16_kernel(const Params p) {
  constexpr int kStride = D + kPad;
  constexpr int kTile = kBlockM * kStride;        // elements a tile
  constexpr int kSteps = D / 16;                  // k-steps of Q K^T
  constexpr int kDTiles = D / 8;                  // n-tiles of the output
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* k_s = q_s + kTile;                        // 2 buffers
  bf16* v_s = k_s + 2 * kTile;                    // 2 buffers

  const int n_qt = (p.seq + kBlockM - 1) / kBlockM;
  const int qt = n_qt - 1 - blockIdx.x;           // long rows first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / p.group;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;                        // row in the 8-row group
  const int tig = lane & 3;                       // thread in the group
  const int mi = lane >> 3;                       // ldmatrix matrix index
  const int ri = lane & 7;                        // ldmatrix row index

  const bf16* qg = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const bf16* kg = static_cast<const bf16*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const bf16* vg = static_cast<const bf16*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  const int q0 = qt * kBlockM;
  const int n_kv = p.causal ? qt + 1 : n_qt;      // kBlockN == kBlockM
  const float scale = p.sm_scale * kLog2e;

  load_tile_bf16<D>(q_s, qg, p.q_ss, q0, p.seq);
  load_tile_bf16<D>(k_s, kg, p.k_ss, 0, p.seq);
  load_tile_bf16<D>(v_s, vg, p.v_ss, 0, p.seq);
  cp_async_commit();

  unsigned qf[kSteps][4];
  float acc[kDTiles][4];
#pragma unroll
  for (int i = 0; i < kDTiles; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.0f;
  float m_run[2] = {kNegBig, kNegBig};            // rows g and g + 8
  float l_run[2] = {0.0f, 0.0f};                  // this thread's columns
  const int row_a = q0 + warp * 16 + g;           // absolute query rows
  const int row_b = row_a + 8;

  for (int j = 0; j < n_kv; ++j) {
    const int buf = j & 1;
    if (j + 1 < n_kv) {
      const int nb = (j + 1) & 1;
      load_tile_bf16<D>(k_s + nb * kTile, kg, p.k_ss, (j + 1) * kBlockN,
                        p.seq);
      load_tile_bf16<D>(v_s + nb * kTile, vg, p.v_ss, (j + 1) * kBlockN,
                        p.seq);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (j == 0) {
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk) {
        const int r = warp * 16 + (mi & 1) * 8 + ri;
        const int c = kk * 16 + (mi >> 1) * 8;
        ldmatrix_x4(qf[kk], q_s + r * kStride + c);
      }
    }
    const bf16* kt = k_s + buf * kTile;
    const bf16* vt = v_s + buf * kTile;

    // S = Q K^T for this warp's 16 rows and the tile's 64 keys
    float s[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        unsigned kb[4];
        const int r = np * 16 + (mi >> 1) * 8 + ri;
        const int c = kk * 16 + (mi & 1) * 8;
        ldmatrix_x4(kb, kt + r * kStride + c);
        mma_bf16(s[2 * np], qf[kk], kb[0], kb[1]);
        mma_bf16(s[2 * np + 1], qf[kk], kb[2], kb[3]);
      }
    }

    // scale to log2 units, mask, online softmax
    const int k0 = j * kBlockN;
    const bool edge = (p.causal && j == qt) || k0 + kBlockN > p.seq;
    float mx[2] = {kNegBig, kNegBig};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[nt][e] * scale;
        if (edge) {
          const int key = k0 + nt * 8 + tig * 2 + (e & 1);
          const int row = (e < 2) ? row_a : row_b;
          if (key >= p.seq || (p.causal && key > row)) x = kNegBig;
        }
        s[nt][e] = x;
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
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = exp2f(s[nt][e] - m_run[e >> 1]);
        s[nt][e] = pe;
        l_run[e >> 1] += pe;
      }
    }
#pragma unroll
    for (int i = 0; i < kDTiles; ++i) {
      acc[i][0] *= alpha[0];
      acc[i][1] *= alpha[0];
      acc[i][2] *= alpha[1];
      acc[i][3] *= alpha[1];
    }

    // acc += P V: P from registers (accumulator layout = A layout)
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk) {
      unsigned pa[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int dp = 0; dp < kDTiles / 2; ++dp) {
        unsigned vb[4];
        const int r = kk * 16 + (mi & 1) * 8 + ri;
        const int c = dp * 16 + (mi >> 1) * 8;
        ldmatrix_x4_trans(vb, vt + r * kStride + c);
        mma_bf16(acc[2 * dp], pa, vb[0], vb[1]);
        mma_bf16(acc[2 * dp + 1], pa, vb[2], vb[3]);
      }
    }
    __syncthreads();   // this buffer is refilled two iterations on
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
  for (int i = 0; i < kDTiles; ++i) {
    const int col = i * 8 + tig * 2;
    if (row_a < p.seq)
      *reinterpret_cast<unsigned*>(og + row_a * p.o_ss + col) =
          pack_bf16(acc[i][0] * inv[0], acc[i][1] * inv[0]);
    if (row_b < p.seq)
      *reinterpret_cast<unsigned*>(og + row_b * p.o_ss + col) =
          pack_bf16(acc[i][2] * inv[1], acc[i][3] * inv[1]);
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
cudaError_t launch(Kernel kernel, const Params& p, int batch, int n_heads,
                   int smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.seq + kBlockM - 1) / kBlockM, n_heads, batch);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  Strides in elements; the last axis of
// every tensor is contiguous.  Returns a CUDA error code (0 = launched).
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
  const int bf16_smem = 5 * kBlockM * (head_dim + kPad) * 2;
  const int f32_smem = (kBlockM * (head_dim + 1) * 2 + kBlockN * head_dim
                        + kBlockM * (kBlockN + 1)) * 4;
  if (dtype == 1 && head_dim == 128)
    return static_cast<int>(launch(flash_bf16_kernel<128>, p, batch, n_heads,
                                   bf16_smem, s));
  if (dtype == 1 && head_dim == 64)
    return static_cast<int>(launch(flash_bf16_kernel<64>, p, batch, n_heads,
                                   bf16_smem, s));
  if (dtype == 0 && head_dim == 128)
    return static_cast<int>(launch(flash_f32_kernel<128>, p, batch, n_heads,
                                   f32_smem, s));
  if (dtype == 0 && head_dim == 64)
    return static_cast<int>(launch(flash_f32_kernel<64>, p, batch, n_heads,
                                   f32_smem, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
