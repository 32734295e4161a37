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
// multiple.  Blocks of the card run in parallel in no order, so here each
// block reduces its grid-stride share to one (max f, max g) pair and a
// second one-block launch reduces the pairs; a bounds check takes the
// place of the padding.
//
// Bound on the card: three float32 streams, 12 bytes per vertex, against
// about 20 float operations per vertex, so memory bound (12.6 MB at
// V = 2^20, 3.8 us at 3.35 TB/s).  At that size two launches cost about
// as much as the stream itself; the design does not hide that.
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

constexpr int kThreads = 256;  // THREADS in kernel.py
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

__global__ void __launch_bounds__(kThreads)
stopcheck_partial_kernel(const float* __restrict__ counts,
                         const float* __restrict__ lil,
                         const float* __restrict__ liu, long long n,
                         float tau_in, const float* __restrict__ omega_ptr,
                         float* __restrict__ partial) {
  const float third = (float)(1.0 / 3.0);
  const float tiny = (float)1e-8;
  const float tau = tau_in < 1.0f ? 1.0f : tau_in;
  const float omega = *omega_ptr;
  const float r = __fdiv_rn(omega, tau);
  const float a = __fsub_rn(r, third);
  const float b = __fadd_rn(r, third);
  const float aa = __fmul_rn(a, a);
  const float bb = __fmul_rn(b, b);
  float mf = -INFINITY, mg = -INFINITY;
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += stride) {
    const float bo2 = __fmul_rn(__fmul_rn(2.0f, __fdiv_rn(counts[i], tau)),
                                omega);
    const float el = clamp_min(lil[i], tiny);
    const float eu = clamp_min(liu[i], tiny);
    const float f = __fmul_rn(
        __fdiv_rn(el, tau),
        __fadd_rn(-a, __fsqrt_rn(__fadd_rn(aa, __fdiv_rn(bo2, el)))));
    const float g = __fmul_rn(
        __fdiv_rn(eu, tau),
        __fadd_rn(b, __fsqrt_rn(__fadd_rn(bb, __fdiv_rn(bo2, eu)))));
    mf = max_nan(mf, f);
    mg = max_nan(mg, g);
  }
  block_max_store(mf, mg, partial + 2 * blockIdx.x);
}

__global__ void __launch_bounds__(kThreads)
stopcheck_final_kernel(const float* __restrict__ partial, int n_parts,
                       float* __restrict__ out) {
  float mf = -INFINITY, mg = -INFINITY;
  for (int k = threadIdx.x; k < n_parts; k += kThreads) {
    mf = max_nan(mf, partial[2 * k]);
    mg = max_nan(mg, partial[2 * k + 1]);
  }
  block_max_store(mf, mg, out);
}

}  // namespace

extern "C" {

// counts, lil, liu: (n,) float32 on the device, n >= 1; omega: one
// float32 on the device; partial: 2 * n_blocks float32 scratch; out: (2,)
// float32.  n_blocks >= 1 partial blocks, then one finishing block.
int stopcheck_launch(const float* counts, const float* lil, const float* liu,
                     long long n, float tau, const float* omega,
                     float* partial, int n_blocks, float* out,
                     cudaStream_t stream) {
  stopcheck_partial_kernel<<<n_blocks, kThreads, 0, stream>>>(
      counts, lil, liu, n, tau, omega, partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  stopcheck_final_kernel<<<1, kThreads, 0, stream>>>(partial, n_blocks, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
