// Gradient-histogram kernels for Hopper (sm_90a), bound to Python with ctypes
// from dmlc_core_tpu_torch/ops/hist_cuda.py.  Build:
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libdmlc_hist.so hist.cu
//
// Two kernels, each the counterpart of a Pallas TPU kernel in
// dmlc_core_tpu/ops/hist_pallas.py:
//
//  * hist_matmul_kernel  <- hist_matmul_pallas / _kernel (K1):
//      out[m, f*nbins + b] = sum_i w[m, i] * [bins[i, f] == b]
//    for w [M, B] bf16 and bins [B, F] uint8 or int32, f32 sums.
//  * grad_hist_fused_kernel <- grad_hist_pallas_fused / _fused_kernel (K3):
//      G[n, f, b] = sum_i bf16(g_i) * [node_i == n] * [bins[i, f] == b]
//    (and H from h), with the node one-hot built in the kernel from 12 B of
//    node/g/h per row.
//
// Both read a window of feature columns, bins[i * ld_bins + f_offset + f]
// for f < num_feature, straight from a row-major [B, ld_bins] array
// (ld_bins = num_feature, f_offset = 0 for the whole array).  That is the
// counterpart of grad_hist_pallas_sharded (K4, hist_pallas.py:350): each
// model shard of the TPU program slices its F/mp columns with a
// dynamic_slice and runs K2/K3 on the copy; a rank here hands its window to
// the same kernels instead, so no B x F/mp copy is made per tree level.
// Outputs stay [..., num_feature * nbins] for the window.  A window of 14
// uint8 columns of a 28-byte row still touches every 32-byte sector of the
// row, so the window costs as many DRAM sectors as the whole row; a layout
// that stores each rank's columns contiguously would fix that (later work).
// K4's bound at chip_smoke.py's shape (1,000,000 rows and a 14-column window
// per rank, 32 nodes, 256 bins): 14 MB of bins (28 MB of sectors), 12 MB of
// node/g/h and 0.92 MB of output, about 8 us at 3.35 TB/s.
//
// Design.  The Pallas kernels keep one [M, F*nbins] f32 accumulator resident
// in VMEM across a sequential grid of row tiles.  A CTA has at most 227 KB of
// shared memory and CTAs run in parallel with nothing carried between them,
// so here each CTA owns one (row chunk, feature, node/weight-row block): it
// stages TILE rows at a time through shared memory and accumulates a
// [rows-of-block, nbins] f32 histogram in shared memory.  Every accumulator
// cell has exactly one writer thread, which adds the rows in order, so no
// atomics are used; per-chunk partial histograms go to a scratch buffer and
// sum_chunks_kernel adds them in chunk order.  The result is therefore bitwise
// identical from launch to launch (the JAX package's fits are bitwise
// reproducible, and the port keeps that).  The chunking is a function of the
// shapes only, never of the card.
//
// Bound.  Both kernels are bound by bytes on this card: K3 reads
// B*F bins + 12 B per row once (about 80 MB per tree level at 2M x 28), K1
// also reads W (2*M*B bytes).  This simple design instead spends most of its
// time issuing one shared-memory compare per (row, feature, bin-warp); making
// it reach the byte bound (tensor cores for W x one-hot, TMA, a persistent
// grid) is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 256;  // rows staged per step; TILE in ops/hist_cuda.py
constexpr int kMaxSmem = 232448;  // dynamic shared memory one block may use

// K1.  Block = 32 * ceil(nbins / 32) threads; warp v owns bins
// [32v, 32v + 32), lane l owns weight rows m = l, l + 32, ...  The branch on
// the staged bin is warp-uniform, so a row costs the other warps one
// broadcast load and a compare.
template <typename BinT>
__global__ void hist_matmul_kernel(const __nv_bfloat16* __restrict__ w,
                                   const BinT* __restrict__ bins,
                                   long long num_rows, int num_feature,
                                   int ld_bins, int f_offset,
                                   int m_total, int num_bins, int m_block,
                                   long long rows_per_chunk,
                                   float* __restrict__ partial) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int acc_stride = num_bins + 1;  // odd stride: lanes hit distinct banks
  const int w_stride = m_block + 2;
  float* acc = reinterpret_cast<float*>(smem_raw);        // [m_block][stride]
  int* sbin = reinterpret_cast<int*>(acc + m_block * acc_stride);  // [kTile]
  __nv_bfloat16* sw = reinterpret_cast<__nv_bfloat16*>(sbin + kTile);
                                                           // [kTile][w_stride]
  const int chunk = blockIdx.x;
  const int f = blockIdx.y;
  const int m0 = blockIdx.z * m_block;
  const int m_count = min(m_block, m_total - m0);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  for (int k = threadIdx.x; k < m_block * acc_stride; k += blockDim.x)
    acc[k] = 0.f;

  const long long r_begin = chunk * rows_per_chunk;
  const long long r_end = min(num_rows, r_begin + rows_per_chunk);
  for (long long t0 = r_begin; t0 < r_end; t0 += kTile) {
    const int tn = static_cast<int>(min(static_cast<long long>(kTile),
                                        r_end - t0));
    __syncthreads();  // the previous tile is consumed
    for (int r = threadIdx.x; r < tn; r += blockDim.x)
      sbin[r] = static_cast<int>(bins[(t0 + r) * ld_bins + f_offset + f]);
    for (int k = threadIdx.x; k < m_count * kTile; k += blockDim.x) {
      const int m = k / kTile;
      const int r = k - m * kTile;
      if (r < tn)
        sw[r * w_stride + m] = w[static_cast<long long>(m0 + m) * num_rows
                                 + t0 + r];
    }
    __syncthreads();
#pragma unroll 4
    for (int r = 0; r < tn; ++r) {
      const int b = sbin[r];
      if (static_cast<unsigned>(b) < static_cast<unsigned>(num_bins)
          && (b >> 5) == warp) {
        for (int m = lane; m < m_count; m += 32)
          acc[m * acc_stride + b] += __bfloat162float(sw[r * w_stride + m]);
      }
    }
  }
  __syncthreads();
  const long long row_len = static_cast<long long>(num_feature) * num_bins;
  float* out = partial + (static_cast<long long>(chunk) * m_total + m0)
                             * row_len
                       + static_cast<long long>(f) * num_bins;
  for (int k = threadIdx.x; k < m_count * num_bins; k += blockDim.x) {
    const int m = k / num_bins;
    const int j = k - m * num_bins;
    out[m * row_len + j] = acc[m * acc_stride + j];
  }
}

// K3.  Block = 32 * ceil(nbins / 32) threads; thread j owns bin column j of
// every node row of the block, so each accumulator cell has one writer.
// g and h are rounded to bf16 (round to nearest even) as the TPU kernel does
// before its MXU dot; the sums stay f32.
template <typename BinT>
__global__ void grad_hist_fused_kernel(const BinT* __restrict__ bins,
                                       const int* __restrict__ node,
                                       const float* __restrict__ grad,
                                       const float* __restrict__ hess,
                                       long long num_rows, int num_feature,
                                       int ld_bins, int f_offset,
                                       int num_nodes, int num_bins,
                                       int node_block,
                                       long long rows_per_chunk,
                                       float* __restrict__ partial) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* acc = reinterpret_cast<float*>(smem_raw);   // [2*node_block][nbins]
  int* sbin = reinterpret_cast<int*>(acc + 2 * node_block * num_bins);
  int* snode = sbin + kTile;
  float* sg = reinterpret_cast<float*>(snode + kTile);
  float* sh = sg + kTile;

  const int chunk = blockIdx.x;
  const int f = blockIdx.y;
  const int n0 = blockIdx.z * node_block;
  const int n_count = min(node_block, num_nodes - n0);
  const int j = threadIdx.x;

  for (int k = threadIdx.x; k < 2 * node_block * num_bins; k += blockDim.x)
    acc[k] = 0.f;

  const long long r_begin = chunk * rows_per_chunk;
  const long long r_end = min(num_rows, r_begin + rows_per_chunk);
  for (long long t0 = r_begin; t0 < r_end; t0 += kTile) {
    const int tn = static_cast<int>(min(static_cast<long long>(kTile),
                                        r_end - t0));
    __syncthreads();
    for (int r = threadIdx.x; r < tn; r += blockDim.x) {
      const long long i = t0 + r;
      const int local = node[i] - n0;  // rows of other blocks, -1: dropped
      const bool live = local >= 0 && local < n_count;
      sbin[r] = live ? static_cast<int>(bins[i * ld_bins + f_offset + f])
                     : -1;
      snode[r] = local;
      sg[r] = __bfloat162float(__float2bfloat16_rn(grad[i]));
      sh[r] = __bfloat162float(__float2bfloat16_rn(hess[i]));
    }
    __syncthreads();
    if (j < num_bins) {
#pragma unroll 4
      for (int r = 0; r < tn; ++r) {
        if (sbin[r] == j) {
          const int k = snode[r];
          acc[k * num_bins + j] += sg[r];
          acc[(node_block + k) * num_bins + j] += sh[r];
        }
      }
    }
  }
  __syncthreads();
  const long long row_len = static_cast<long long>(num_feature) * num_bins;
  for (int k = threadIdx.x; k < 2 * n_count * num_bins; k += blockDim.x) {
    const int s = k / (n_count * num_bins);  // 0: G, 1: H
    const int rem = k - s * n_count * num_bins;
    const int kk = rem / num_bins;
    const int jj = rem - kk * num_bins;
    const long long row = (static_cast<long long>(chunk) * 2 + s) * num_nodes
                          + n0 + kk;
    partial[row * row_len + static_cast<long long>(f) * num_bins + jj] =
        acc[(s * node_block + kk) * num_bins + jj];
  }
}

// out[i] = sum over chunks c, in order, of partial[c * n + i].
__global__ void sum_chunks_kernel(const float* __restrict__ partial,
                                  long long n, int n_chunks,
                                  float* __restrict__ out) {
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x
                     + threadIdx.x;
       i < n; i += step) {
    float s = 0.f;
    for (int c = 0; c < n_chunks; ++c) s += partial[c * n + i];
    out[i] = s;
  }
}

int threads_for(int num_bins) { return 32 * ((num_bins + 31) / 32); }

cudaError_t sum_chunks(const float* partial, long long n, int n_chunks,
                       float* out, cudaStream_t stream) {
  if (n_chunks == 1) return cudaSuccess;  // the kernel wrote out directly
  long long blocks = (n + 255) / 256;
  if (blocks > 4096) blocks = 4096;
  sum_chunks_kernel<<<static_cast<int>(blocks), 256, 0, stream>>>(
      partial, n, n_chunks, out);
  return cudaGetLastError();
}

template <typename BinT>
cudaError_t launch_hist_matmul(const void* w, const void* bins,
                               long long num_rows, int num_feature,
                               int ld_bins, int f_offset, int m_total,
                               int num_bins, int m_block,
                               long long rows_per_chunk, int n_chunks,
                               float* partial, float* out,
                               cudaStream_t stream) {
  const int smem = m_block * (num_bins + 1) * 4 + kTile * 4
                   + kTile * (m_block + 2) * 2;
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      hist_matmul_kernel<BinT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(n_chunks, num_feature, (m_total + m_block - 1) / m_block);
  hist_matmul_kernel<BinT><<<grid, threads_for(num_bins), smem, stream>>>(
      static_cast<const __nv_bfloat16*>(w), static_cast<const BinT*>(bins),
      num_rows, num_feature, ld_bins, f_offset, m_total, num_bins, m_block,
      rows_per_chunk, partial);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return sum_chunks(partial,
                    static_cast<long long>(m_total) * num_feature * num_bins,
                    n_chunks, out, stream);
}

template <typename BinT>
cudaError_t launch_grad_hist_fused(const void* bins, const void* node,
                                   const void* grad, const void* hess,
                                   long long num_rows, int num_feature,
                                   int ld_bins, int f_offset,
                                   int num_nodes, int num_bins,
                                   int node_block, long long rows_per_chunk,
                                   int n_chunks, float* partial, float* out,
                                   cudaStream_t stream) {
  const int smem = 2 * node_block * num_bins * 4 + kTile * 16;
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      grad_hist_fused_kernel<BinT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(n_chunks, num_feature,
                  (num_nodes + node_block - 1) / node_block);
  grad_hist_fused_kernel<BinT><<<grid, threads_for(num_bins), smem,
                                 stream>>>(
      static_cast<const BinT*>(bins), static_cast<const int*>(node),
      static_cast<const float*>(grad), static_cast<const float*>(hess),
      num_rows, num_feature, ld_bins, f_offset, num_nodes, num_bins,
      node_block, rows_per_chunk, partial);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return sum_chunks(partial,
                    2LL * num_nodes * num_feature * num_bins, n_chunks, out,
                    stream);
}

bool bad_shape(long long num_rows, int num_feature, int ld_bins,
               int f_offset, int rows_out, int num_bins, int block,
               long long rows_per_chunk, int n_chunks) {
  return num_rows <= 0 || num_feature <= 0 || num_feature > 65535
         || f_offset < 0 || ld_bins < f_offset + num_feature
         || rows_out <= 0 || num_bins <= 0 || num_bins > 1024 || block <= 0
         || (rows_out + block - 1) / block > 65535 || rows_per_chunk <= 0
         || rows_per_chunk % kTile != 0 || n_chunks <= 0
         || static_cast<long long>(n_chunks) * rows_per_chunk < num_rows;
}

}  // namespace

extern "C" {

// Rows staged per step; the Python wrapper checks it matches its TILE.
int dmlc_hist_tile() { return kTile; }

const char* dmlc_hist_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// K1.  w [m_total, num_rows] bf16, bins [num_rows, ld_bins] (uint8 when
// bins_u8, else int32) of which columns [f_offset, f_offset + num_feature)
// are read, partial [n_chunks, m_total, F*nbins] f32 (may alias out when
// n_chunks == 1), out [m_total, F*nbins] f32 with F = num_feature.  Returns
// the CUDA error of the launches (0 on success).
int dmlc_hist_matmul(const void* w, const void* bins, int bins_u8,
                     long long num_rows, int num_feature, int ld_bins,
                     int f_offset, int m_total, int num_bins, int m_block,
                     long long rows_per_chunk, int n_chunks, void* partial,
                     void* out, void* stream) {
  if (bad_shape(num_rows, num_feature, ld_bins, f_offset, m_total, num_bins,
                m_block, rows_per_chunk, n_chunks))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(partial);
  float* o = static_cast<float*>(out);
  return bins_u8
             ? launch_hist_matmul<uint8_t>(w, bins, num_rows, num_feature,
                                           ld_bins, f_offset, m_total,
                                           num_bins, m_block, rows_per_chunk,
                                           n_chunks, p, o, s)
             : launch_hist_matmul<int32_t>(w, bins, num_rows, num_feature,
                                           ld_bins, f_offset, m_total,
                                           num_bins, m_block, rows_per_chunk,
                                           n_chunks, p, o, s);
}

// K3.  bins as for K1, node [num_rows] int32, grad/hess [num_rows] f32,
// partial [n_chunks, 2, num_nodes, F*nbins] f32 (may alias out when
// n_chunks == 1), out [2, num_nodes, F*nbins] f32 with F = num_feature.
int dmlc_grad_hist_fused(const void* bins, int bins_u8, const void* node,
                         const void* grad, const void* hess,
                         long long num_rows, int num_feature, int ld_bins,
                         int f_offset, int num_nodes, int num_bins,
                         int node_block, long long rows_per_chunk,
                         int n_chunks, void* partial, void* out,
                         void* stream) {
  if (bad_shape(num_rows, num_feature, ld_bins, f_offset, num_nodes,
                num_bins, node_block, rows_per_chunk, n_chunks))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(partial);
  float* o = static_cast<float*>(out);
  return bins_u8
             ? launch_grad_hist_fused<uint8_t>(
                   bins, node, grad, hess, num_rows, num_feature, ld_bins,
                   f_offset, num_nodes, num_bins, node_block, rows_per_chunk,
                   n_chunks, p, o, s)
             : launch_grad_hist_fused<int32_t>(
                   bins, node, grad, hess, num_rows, num_feature, ld_bins,
                   f_offset, num_nodes, num_bins, node_block, rows_per_chunk,
                   n_chunks, p, o, s);
}

}  // extern "C"
