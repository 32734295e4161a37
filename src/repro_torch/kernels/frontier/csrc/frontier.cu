// Batched BFS frontier expansion on Hopper (sm_90a), plain C interface.
//
// Both kernels compute one level of B concurrent BFS searches over a
// vertex-major (rows, B) state:
//
//   out[v, b] += sigma[src[e], b]  for every edge e with dst[e] == v
//                                  and dist[src[e], b] == levels[b]
//
// `out` is zero-filled by the caller.  Padded edges point at the sink
// row, whose dist (-3) never equals a level, so they add nothing.
//
// frontier_flat_kernel replaces the TPU kernel
//   src/repro/kernels/frontier/kernel.py: frontier_expand_batched_pallas
// (body _flat_kernel).  The TPU pins the whole state in VMEM and scatters
// through a one-hot MXU matmul; here the state stays in device memory and
// the scatter is a direct atomic add.
//
// frontier_nb_kernel replaces the TPU kernel
//   src/repro/kernels/frontier/kernel.py: frontier_expand_node_blocked_pallas
// (body _nb_kernel) on its replicated route (not wide_state).  One thread
// block per edge block of the node-blocked CSC layout; blocks whose edges
// hold no frontier source (block_active[k] == 0) return at once.  The
// TPU's DMA double-buffering, staged source tiles and one-hot matmuls
// are fast-memory devices the card does not need: the output is
// zero-filled up front (in place of block_first zeroing) and accumulated
// in device memory.
//
// Bound on the card.  One level moves at least E * 8 bytes of edge
// indices plus (V+1) * B * 12 bytes of dist, sigma and out; it does
// E * B compares and at most E * B adds, far below the card's
// arithmetic rate, so both kernels are bound by memory traffic.  The
// design answer: lanes of a thread group run over the B columns of one
// edge, so the reads of dist[src, :] and sigma[src, :] are one
// contiguous row, and the source-sorted edge order (COO sorted by src;
// CSC ranged by source block) keeps consecutive edges on the same or
// nearby rows, which the L1/L2 caches serve.  Only frontier hits touch
// sigma and issue an atomic.
//
// Float sums: atomics add in an order that varies from run to run.
// While sigma holds exact integers below 2^24 every order gives the same
// bits; beyond that results agree to float32 rounding (rtol 1e-6).
//
// Each entry point launches on the caller's stream and returns
// cudaGetLastError(); the caller raises on a non-zero code.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxGrid = 132 * 64;  // SMs x resident blocks, grid-stride

// Column lanes per edge: up to one warp's worth; the rest of the block
// runs over edges.
inline dim3 block_shape(int batch) {
  int bx = batch < 32 ? batch : 32;
  if (bx < 1) bx = 1;
  return dim3(bx, kThreads / bx);
}

__device__ __forceinline__ void expand_edge(
    long long u, long long v, const int* __restrict__ dist,
    const float* __restrict__ sigma, const int* __restrict__ levels,
    float* __restrict__ out, int batch) {
  const long long src_row = u * batch;
  const long long dst_row = v * batch;
  for (int b = threadIdx.x; b < batch; b += blockDim.x) {
    if (dist[src_row + b] == levels[b]) {
      atomicAdd(out + dst_row + b, sigma[src_row + b]);
    }
  }
}

__global__ void frontier_flat_kernel(const int* __restrict__ src,
                                     const int* __restrict__ dst,
                                     const int* __restrict__ dist,
                                     const float* __restrict__ sigma,
                                     const int* __restrict__ levels,
                                     float* __restrict__ out,
                                     long long n_edges, int batch) {
  const long long stride = (long long)gridDim.x * blockDim.y;
  for (long long e = (long long)blockIdx.x * blockDim.y + threadIdx.y;
       e < n_edges; e += stride) {
    expand_edge(src[e], dst[e], dist, sigma, levels, out, batch);
  }
}

__global__ void frontier_nb_kernel(const int* __restrict__ csc_src,
                                   const int* __restrict__ csc_dst,
                                   const int* __restrict__ block_active,
                                   const int* __restrict__ dist,
                                   const float* __restrict__ sigma,
                                   const int* __restrict__ levels,
                                   float* __restrict__ out, int block_e,
                                   int batch) {
  const int k = blockIdx.x;
  if (block_active[k] == 0) return;
  // this edge block's source and destination ids, staged once for all
  // B columns
  extern __shared__ int stage[];
  int* s_src = stage;
  int* s_dst = stage + block_e;
  const long long base = (long long)k * block_e;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;
  for (int i = tid; i < block_e; i += nthreads) {
    s_src[i] = csc_src[base + i];
    s_dst[i] = csc_dst[base + i];
  }
  __syncthreads();
  for (int e = threadIdx.y; e < block_e; e += blockDim.y) {
    expand_edge(s_src[e], s_dst[e], dist, sigma, levels, out, batch);
  }
}

}  // namespace

extern "C" int frontier_flat_launch(const void* src, const void* dst,
                                    const void* dist, const void* sigma,
                                    const void* levels, void* out,
                                    long long n_edges, int batch,
                                    void* stream) {
  if (n_edges > 0 && batch > 0) {
    const dim3 block = block_shape(batch);
    long long blocks = (n_edges + block.y - 1) / block.y;
    const int grid = (int)(blocks < kMaxGrid ? blocks : kMaxGrid);
    frontier_flat_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
        (const int*)src, (const int*)dst, (const int*)dist,
        (const float*)sigma, (const int*)levels, (float*)out, n_edges,
        batch);
  }
  return (int)cudaGetLastError();
}

extern "C" int frontier_nb_launch(const void* csc_src, const void* csc_dst,
                                  const void* block_active, const void* dist,
                                  const void* sigma, const void* levels,
                                  void* out, int n_edge_blocks, int block_e,
                                  int batch, void* stream) {
  if (n_edge_blocks > 0 && batch > 0) {
    const size_t smem = 2 * (size_t)block_e * sizeof(int);
    if (smem > 48 * 1024) {
      cudaError_t err = cudaFuncSetAttribute(
          frontier_nb_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    frontier_nb_kernel<<<n_edge_blocks, block_shape(batch), smem,
                         (cudaStream_t)stream>>>(
        (const int*)csc_src, (const int*)csc_dst, (const int*)block_active,
        (const int*)dist, (const float*)sigma, (const int*)levels,
        (float*)out, block_e, batch);
  }
  return (int)cudaGetLastError();
}
