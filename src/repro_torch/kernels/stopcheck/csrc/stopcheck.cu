// Fused KADABRA stop check on Hopper (sm_90a), plain C interface.
//
// Computes, over the V vertices,
//
//   out = [ max_x f(x), max_x g(x) ]
//
//   btilde = counts[x] / tau                 tau clamped >= 1
//   a      = omega / tau - 1/3,  b = omega / tau + 1/3
//   f      = (ell_l / tau) * (-a + sqrt(a*a + 2*btilde*omega / ell_l))
//   g      = (ell_u / tau) * ( b + sqrt(b*b + 2*btilde*omega / ell_u))
//
// with ell_l = max(ln(1/delta_L[x]), 1e-8), ell_u likewise.
//
// Replaces the TPU kernel
//   src/repro/kernels/stopcheck/kernel.py: stopcheck_pallas (body _kernel).
// The TPU runs its grid in order on one core and carries the running max
// in the (1, 2) output tile from step to step, padding V to a block
// multiple.  Blocks of the card run in parallel in no order; a bounds
// check takes the place of the padding.
//
// Bound on the card: three float32 streams, 12 bytes per vertex, against
// about 20 float operations per vertex, so memory bound: 12.6 MB at
// V = 2^20, 3.8 us at 3.35 TB/s.  That is about as long as one launch
// takes to start and drain, so the design spends exactly one launch a
// check and no second pass:
//
// * one wave of 1,024-thread blocks (the wrapper sizes the grid from the
//   occupancy query, never more than the card holds at once), each
//   grid-striding over the three streams with 16-byte loads when all
//   three are 16-byte aligned (a scalar tail after the last whole
//   float4), so every thread has its three loads in flight together;
// * each block reduces its share to one (max f, max g) pair in scratch;
//   then it takes a ticket (an atomic add after __threadfence()), and the
//   block that draws the last ticket reads every pair back through L2,
//   writes `out` and resets the ticket to 0 for the next check.  The
//   scratch pairs and the ticket are the wrapper's, one set per (device,
//   stream): two checks in flight on different streams never share a
//   ticket, and checks on one stream run one after the other.
//
// What is left above the bound (tools/stopcheck_probe.py, H100 80GB
// HBM3, 700 W; PERF.md): the finish, from the last block's ticket to
// `out`, 1.1 to 1.8 us; and the arithmetic, about 3.5 us, which the
// bitwise contract fixes: five IEEE divisions and two square roots a
// vertex, issued after the loads land.  Smaller or fewer blocks, two
// float4s in flight a thread, acq_rel fences and full occupancy were
// no faster.
//
// Arithmetic: every operation is an explicitly rounded intrinsic in the
// operation order of the plain version (repro_torch.core.kadabra f_term /
// g_term), so nvcc contracts nothing into an FMA and each f and g equals
// the plain version's on the card bit for bit.  A max is order-free, so
// the result is bitwise too.  NaN propagates as in torch.clamp and
// torch.max: fmaxf would drop it, so neither the clamp nor the reduction
// uses it.
//
// Scalars: tau is a host number (the engine's sample count); omega is
// read through a device pointer, so the check adds no host sync.  The
// entry point launches on the caller's stream and returns
// cudaGetLastError(); the caller raises on a non-zero code.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 1024;  // THREADS in kernel.py
constexpr int kWarps = kThreads / 32;

// torch.clamp(x, min=lo): NaN stays NaN
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return isnan(x) ? x : (x < lo ? lo : x);
}

// torch.max: a NaN anywhere wins
__device__ __forceinline__ float max_nan(float m, float v) {
  return (isnan(v) || v > m) ? v : m;
}

__device__ __forceinline__ void warp_max(float& mf, float& mg) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    mf = max_nan(mf, __shfl_xor_sync(0xffffffffu, mf, off));
    mg = max_nan(mg, __shfl_xor_sync(0xffffffffu, mg, off));
  }
}

// Block-wide max of (mf, mg); thread 0 writes the pair to out[0..1].
__device__ __forceinline__ void block_max_store(float mf, float mg,
                                                float* out) {
  __shared__ float sf[kWarps], sg[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  warp_max(mf, mg);
  if (lane == 0) {
    sf[warp] = mf;
    sg[warp] = mg;
  }
  __syncthreads();
  if (warp == 0) {
    mf = lane < kWarps ? sf[lane] : -INFINITY;
    mg = lane < kWarps ? sg[lane] : -INFINITY;
    warp_max(mf, mg);
    if (lane == 0) {
      out[0] = mf;
      out[1] = mg;
    }
  }
}

// The terms every vertex shares.
struct Shared {
  float tau, omega, a, b, aa, bb;
};

__device__ __forceinline__ Shared shared_terms(float tau_in,
                                               const float* omega_ptr) {
  const float third = (float)(1.0 / 3.0);
  Shared s;
  s.tau = tau_in < 1.0f ? 1.0f : tau_in;
  s.omega = *omega_ptr;
  const float r = __fdiv_rn(s.omega, s.tau);
  s.a = __fsub_rn(r, third);
  s.b = __fadd_rn(r, third);
  s.aa = __fmul_rn(s.a, s.a);
  s.bb = __fmul_rn(s.b, s.b);
  return s;
}

// f and g of one vertex, folded into the running maxima.
__device__ __forceinline__ void fold(const Shared& s, float count, float lil,
                                     float liu, float& mf, float& mg) {
  const float tiny = (float)1e-8;
  const float bo2 =
      __fmul_rn(__fmul_rn(2.0f, __fdiv_rn(count, s.tau)), s.omega);
  const float el = clamp_min(lil, tiny);
  const float eu = clamp_min(liu, tiny);
  const float f = __fmul_rn(
      __fdiv_rn(el, s.tau),
      __fadd_rn(-s.a, __fsqrt_rn(__fadd_rn(s.aa, __fdiv_rn(bo2, el)))));
  const float g = __fmul_rn(
      __fdiv_rn(eu, s.tau),
      __fadd_rn(s.b, __fsqrt_rn(__fadd_rn(s.bb, __fdiv_rn(bo2, eu)))));
  mf = max_nan(mf, f);
  mg = max_nan(mg, g);
}

__global__ void __launch_bounds__(kThreads)
stopcheck_kernel(const float* __restrict__ counts,
                 const float* __restrict__ lil,
                 const float* __restrict__ liu, long long n, int vec4,
                 float tau_in, const float* __restrict__ omega_ptr,
                 float* __restrict__ partial, unsigned* __restrict__ ticket,
                 float* __restrict__ out) {
  const Shared s = shared_terms(tau_in, omega_ptr);
  float mf = -INFINITY, mg = -INFINITY;
  const long long stride = (long long)gridDim.x * kThreads;
  long long tail = 0;
  if (vec4) {
    const long long n4 = n >> 2;
    const float4* c4 = reinterpret_cast<const float4*>(counts);
    const float4* l4 = reinterpret_cast<const float4*>(lil);
    const float4* u4 = reinterpret_cast<const float4*>(liu);
    for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
         i < n4; i += stride) {
      const float4 c = __ldg(c4 + i), l = __ldg(l4 + i), u = __ldg(u4 + i);
      fold(s, c.x, l.x, u.x, mf, mg);
      fold(s, c.y, l.y, u.y, mf, mg);
      fold(s, c.z, l.z, u.z, mf, mg);
      fold(s, c.w, l.w, u.w, mf, mg);
    }
    tail = n4 << 2;
  }
  for (long long i = tail + (long long)blockIdx.x * kThreads + threadIdx.x;
       i < n; i += stride) {
    fold(s, __ldg(counts + i), __ldg(lil + i), __ldg(liu + i), mf, mg);
  }
  block_max_store(mf, mg, partial + 2 * blockIdx.x);

  // the last block to finish reduces every block's pair
  __shared__ bool last;
  if (threadIdx.x == 0) {
    __threadfence();
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  // every other block fenced its pair before its ticket, and the pairs
  // are read through L2, after the ticket came back
  mf = -INFINITY;
  mg = -INFINITY;
  for (int k = threadIdx.x; k < (int)gridDim.x; k += kThreads) {
    mf = max_nan(mf, __ldcg(partial + 2 * k));
    mg = max_nan(mg, __ldcg(partial + 2 * k + 1));
  }
  block_max_store(mf, mg, out);
  if (threadIdx.x == 0) *ticket = 0u;
}

}  // namespace

extern "C" {

// Blocks of stopcheck_kernel one SM holds at once (the occupancy query).
int stopcheck_blocks_per_sm(int* blocks) {
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, stopcheck_kernel, kThreads, 0);
  return (int)err;
}

// counts, lil, liu: (n,) float32 on the device, n >= 1, all three 16-byte
// aligned when vec4 != 0; omega: one float32 on the device; partial:
// 2 * n_blocks float32 scratch; ticket: one unsigned, 0 between checks;
// out: (2,) float32.  n_blocks >= 1, at most one wave.
int stopcheck_launch(const float* counts, const float* lil, const float* liu,
                     long long n, int vec4, float tau, const float* omega,
                     float* partial, unsigned* ticket, int n_blocks,
                     float* out, cudaStream_t stream) {
  stopcheck_kernel<<<n_blocks, kThreads, 0, stream>>>(
      counts, lil, liu, n, vec4, tau, omega, partial, ticket, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
