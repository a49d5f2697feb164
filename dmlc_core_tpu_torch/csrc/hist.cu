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
//    for w [M, B] bf16 and bins [B, F] uint8 or int32, f32 sums; bins
//    outside [0, nbins) add nothing.
//  * grad_hist_fused_kernel <- grad_hist_pallas_fused / _fused_kernel (K3):
//      G[n, f, b] = sum_i bf16(g_i) * [node_i == n] * [bins[i, f] == b]
//    (and H from h), with the weight rows [nodehot*g ; nodehot*h] built in
//    registers from 12 B of node/g/h per row: no W matrix exists.
//
// grad_hist_pallas (K2) computes K3's function from a W built in XLA and
// runs K1 over it, sweeping node blocks at deep levels.  It has no kernel of
// its own here: grad_hist_cuda launches grad_hist_fused_kernel over every
// node in one launch, so K2 and K3 give the same bits, and K1 serves
// callers that hold a W of their own.
//
// Both read a window of feature columns, bins[i * ld_bins + f_offset + f]
// for f < num_feature, straight from a row-major [B, ld_bins] array
// (ld_bins = num_feature, f_offset = 0 for the whole array).  That is the
// counterpart of grad_hist_pallas_sharded (K4, hist_pallas.py:350): each
// model shard of the TPU program slices its F/mp columns with a
// dynamic_slice and runs K2/K3 on the copy; a rank here hands its window to
// K3's kernel (K2's route on the card) instead, so no B x F/mp copy is made
// per tree level.
// Outputs stay [..., num_feature * nbins] for the window.  A window of 14
// uint8 columns of a 28-byte row still touches every 32-byte sector of the
// row, so the window costs as many DRAM sectors as the whole row; a layout
// that stores each rank's columns contiguously would fix that (later work).
// K4's bound at chip_smoke.py's shape (1,000,000 rows and a 14-column window
// per rank, 32 nodes, 256 bins): 14 MB of bins (28 MB of sectors), 12 MB of
// node/g/h and 0.92 MB of output, about 8 us at 3.35 TB/s.
//
// Determinism, both kernels.  The Pallas kernels keep one [M, F*nbins] f32
// accumulator resident in VMEM across a sequential grid of row tiles.  CTAs
// run in parallel with nothing carried between them, so here each CTA owns a
// chunk of rows and writes a partial histogram for it; sum_chunks_kernel adds
// the partials in chunk order.  Every accumulator cell has exactly one owner
// (a lane's register) that adds its rows in order, so no atomics are used
// and the result is bitwise identical from launch to launch (the JAX
// package's fits are bitwise reproducible, and the port keeps that).  The
// chunking is a function of the shapes only, never of the card.
//
// K1 on Hopper's tensor cores.  K1 replaces hist_matmul_pallas (_kernel and
// _accumulate_tile, hist_pallas.py:110-187), which computes per row tile and
// feature the MXU product W[M, TB] @ onehot[TB, nbins].  Its two bounds on an
// H100 at chip_smoke.py's shape (M = 64, B = 2,000,000, F = 28, 256 bins):
//   * bytes: W (2*M*B = 256 MB), the bins (56 MB) and the output (1.8 MB)
//     once each, 0.094 ms at 3.35 TB/s;
//   * the dense product 2*M*B*F*nbins = 1.84 TFLOP, 1.86 ms at the 989
//     TFLOP/s dense bf16 peak (0.46 ms at M = 16).
// The one-hot is mostly zeros, so the dense product is the price of using
// the tensor cores; it is still far below the scalar work of the first
// design (one shared-memory compare per row, feature and bin-warp).
//
// What the design does about the causes of the first design's 38.5 ms:
//   * W was read once per feature (each CTA did one feature): here a CTA of
//     up to 8 warps covers 8 (feature, 64-bin slice) units of one 64-row
//     block of W, and stages each W tile and bins slab once for all of them.
//     The grid is (unit group, row chunk, m-block) with the unit group
//     fastest, so the CTAs that share a row chunk run side by side and W
//     comes from DRAM about once per launch and from L2 for the rest.
//   * W was staged by latency-bound 2-byte loads: here every W tile
//     [64 x 256 rows] and the bins of the tile's rows go through a two-stage
//     cp.async ring in 16-byte copies, so the next tile loads while the
//     tensor cores work on this one.
//   * The tensor cores sat idle: here each warp issues
//     mma.sync.m16n8k16.row.col.f32.bf16.bf16.f32.  A (16 weight rows x 16
//     data rows) comes from the staged W tile by ldmatrix (row pitch 528 B,
//     an odd number of 16-byte units, so ldmatrix is free of bank
//     conflicts).  B (16 data rows x 8 bins) is built in registers: lane l
//     holds data rows 2(l%4) + {0, 1, 8, 9} of bin n0 + l/4, bf16 1.0
//     (0x3F80) where the row's bin equals it.  A lane turns its 4 bins into
//     one bit per n-tile once per k-step, and each n-tile's B register is
//     then an AND and a multiply.  No one-hot reaches shared memory.
//   * Accumulators live in registers, MT m-tiles x 8 n-tiles x 4 f32 (128 a
//     lane at MT = 4): a warp owns one (feature, 64-bin slice, 64-row
//     m-block) for its whole row chunk.  MT = ceil(M / 16), at most 4, is a
//     template parameter: runtime m-tile guards made the first version
//     issue-bound.  What still bounds it is issue too: building a B register
//     costs about as much as the mma that reads it (numbers in PERF.md).
// Ragged shapes: n-tiles past nbins are skipped and their columns never
// written; a ragged last m-block computes rows on stale shared memory that
// it does not write (an mma row depends on its own A row only); data rows
// past the end of the chunk get W = 0 (cp.async's source size zero-fills the
// copy), so whatever one-hot bit their stale bins give adds exactly 0.
// W rows must start 16-byte aligned: the kernel takes W's row stride ld_w (a
// multiple of 8), and the wrapper passes a row-padded copy when B % 8 != 0.
// Bins rows of any stride and offset are copied as the 16-byte-aligned
// granules that hold the CTA's columns; an aligned granule that holds one
// byte of the array lies in the array's allocation, so the copy may read a
// few bytes beside the window but never outside mapped memory.
//
// K3 on Hopper's tensor cores.  K3 replaces grad_hist_pallas_fused
// (_fused_kernel, hist_pallas.py:236-291), which builds the weight tile
// [nodehot*g ; nodehot*h] in VMEM from node/g/h and runs K1's MXU product.
// Here the same product runs on mma.sync with both operands built in
// registers.  Bounds on an H100 at chip_smoke.py's shape (B = 2,000,000,
// F = 28, 256 bins):
//   * bytes: the bins (56 MB), 12 B of node/g/h a row (24 MB) and the output
//     (2 * n * F * nbins f32) once each: 0.024 ms at n = 32, 3.35 TB/s;
//   * the dense product over M = 16 * m-tiles * m-blocks A rows (G and H of
//     8 nodes per m-tile): 1.86 ms at n = 32 (M = 64), 0.46 ms at n = 1
//     (M = 16) and 14.8 ms at n = 256 (8 m-blocks of M = 64), 989 TFLOP/s.
// The one-hots are mostly zeros, so the dense product is the price of the
// tensor cores, as for K1; deep levels pay it once per m-block.
//
// The design.  K1's units, warps and CTA groups; what changes is where the
// operands come from:
//   * Each tile of 256 rows is packed once for the whole CTA: thread x
//     loads row x of the next tile (node, g, h and the bins of the CTA's
//     columns) into registers before the warps start on this tile, so the
//     loads' latency hides behind the products, and then packs it into
//     the tile's stage: per row pair one 16-byte word {node pair as f16
//     (local to the m-block), g pair and h pair rounded to bf16 by
//     __float2bfloat16_rn}, and per column a bf16 pattern 0x3F80 + bin per
//     row (normal numbers, distinct for bins < 1024).  So the conversions
//     and the one-hot's per-row work are done once a tile, not once per
//     feature or per warp.
//   * A, no W anywhere: m-tile t of an m-block of 32 nodes (grid z) holds
//     nodes n0 + 8t .. n0 + 8t + 7, A rows 0-7 their G rows and rows 8-15
//     their H rows.  So lane (grp, tig) serves one node, 8t + grp, in all
//     four A registers: a0 = G and a1 = H of data rows 2 tig, 2 tig + 1; a2
//     = G and a3 = H of rows 2 tig + 8, 2 tig + 9.  One set.eq.u32.f16x2 of
//     a row pair's nodes against the lane's gives a 0xFFFF mask per
//     matching row, which ANDs both the g and the h pair: 2 compares and 4
//     ANDs per m-tile per k-step.  MT = ceil(min(n, 32) / 8) m-tiles (a
//     template parameter, as K1's) make n <= 8 one m-tile.
//   * B, the bin one-hot: one set.eq.bf16x2 of a row pair's patterns
//     against the pattern of the lane's bin in n-tile j gives bf16 1.0 or 0
//     per row, the B register itself: one instruction (K1 spends an AND and
//     a multiply, after building one bit per row and n-tile in each lane).
//   * One barrier a tile: stages alternate, and the stage a thread packs
//     after its warp's products of tile k was last read for tile k - 1.
//   * The epilogue un-interleaves: accumulator (t, row) of a lane goes to
//     (s = row >= 8, node = n0 + 8t + row % 8), written for nodes below
//     num_nodes only.
// Hazards:
//   * Node ids are int32 and may be -1 or >= num_nodes.  A row's id is
//     made local to the m-block with unsigned arithmetic and packed only
//     when it lies in [0, nodes of this block); every other id becomes
//     kNoNode, an f16 NaN, which equals no node.  So no id aliases a live
//     node in 16 bits (the wrapper also keeps num_nodes below 65,535).
//   * Rows past the chunk's end are not read: their node is kNoNode, g = h
//     = 0 and their bins kNoBin, so they add exactly 0.  (A zero-filled
//     copy would give node 0, a live node.)
//   * Bins outside [0, nbins) (int32 bins may be negative) pack as kNoBin,
//     a bf16 NaN, which equals no pattern; n-tiles past nbins are skipped
//     (n_live, kFull) and their columns never written.  Windows and row
//     strides need nothing more: each thread reads its row's columns.
// What bounds it now is instruction issue and latency: the mma, the A and B
// builds and the k-step's loads come to more than the tensor cores' time,
// with one CTA of 8 warps per SM at 4 m-tiles (the accumulators take 128
// registers a thread).  Numbers in PERF.md, from tools/k3_variants.py.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 256;  // rows staged per step; TILE in ops/hist_cuda.py
constexpr int kMaxSmem = 232448;  // dynamic shared memory one block may use

// K1's launch plan; hist_matmul_plan in ops/hist_cuda.py computes the same.
constexpr int kMBlock = 64;            // weight rows per CTA: 4 m-tiles of 16
constexpr int kMTiles = kMBlock / 16;
constexpr int kSlice = 64;             // bins per warp: 8 n-tiles of 8
constexpr int kNTiles = kSlice / 8;
constexpr int kWarps = 8;              // (feature, slice) units per CTA
constexpr int kWPitch = kTile + 8;     // bf16 per staged W row (528 B)
constexpr int kWStageBytes = kMBlock * kWPitch * 2;

// K3's launch plan: K1's units, warps and groups (grad_hist_fused_plan in
// ops/hist_cuda.py computes the same), 32-node m-blocks on grid z
constexpr int kNodeTile = 8;                     // nodes per m-tile
constexpr int kNodeBlock = 4 * kNodeTile;        // nodes per CTA
constexpr int kPairBytes = 16;   // packed node, g and h of a row pair
// one stage: the packed row pairs, then the one-hot patterns of each of the
// CTA's (at most kWarps) feature columns, a u16 per row
constexpr int kK3StageBytes = kTile / 2 * kPairBytes + kWarps * kTile * 2;
constexpr int kK3Smem = 2 * kK3StageBytes;
constexpr unsigned short kNoNode = 0x7FFF;       // f16 NaN: equals no node
constexpr unsigned short kNoBin = 0x7FFF;        // bf16 NaN: equals no bin

struct MatmulPlan {
  int slices;      // 64-bin slices per feature
  long long units; // (feature, slice) pairs, one per warp
  int warps;       // warps per CTA
  long long groups;  // CTAs per (row chunk, m-block)
  int span;        // most feature columns one CTA stages
  int bins_pitch;  // bytes per staged bins row
  int smem;        // dynamic shared memory: two stages of W and bins
};

MatmulPlan matmul_plan(int num_feature, int num_bins, int bin_bytes) {
  MatmulPlan p;
  p.slices = (num_bins + kSlice - 1) / kSlice;
  p.units = static_cast<long long>(num_feature) * p.slices;
  p.warps = static_cast<int>(p.units < kWarps ? p.units : kWarps);
  p.groups = (p.units + kWarps - 1) / kWarps;
  // `warps` consecutive units starting anywhere in a feature touch at most
  // this many features
  p.span = (p.warps + p.slices - 2) / p.slices + 1;
  if (p.span > num_feature) p.span = num_feature;
  // a row's columns start anywhere in a 16-byte granule: up to 15 B ahead
  p.bins_pitch = 16 * ((15 + p.span * bin_bytes + 15) / 16);
  p.smem = 2 * (kWStageBytes + kTile * p.bins_pitch);
  return p;
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; bytes past src_bytes are zero-filled
__device__ __forceinline__ void cp_async16(unsigned dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// volatile keeps it after the barrier that publishes the tile
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// c += a (16x16, row) * b (16x8, col), bf16 in, f32 sums
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 0xFFFF in each half where the f16 halves of a and b are equal, else 0
__device__ __forceinline__ unsigned f16x2_eq_mask(unsigned a, unsigned b) {
  unsigned d;
  asm("set.eq.u32.f16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// bf16 1.0 in each half where the bf16 halves of a and b are equal, else 0
__device__ __forceinline__ unsigned bf16x2_eq_one(unsigned a, unsigned b) {
  unsigned d;
  asm("set.eq.bf16x2.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// The k-steps of one staged tile for one warp: MT m-tiles of W against the
// first n_live n-tiles of the warp's bin slice (all of them when kFull).
// bg = first bin of the slice + this lane's column in an n-tile.  Rows past
// the end of the chunk need no test: their W columns are zero-filled, and
// whatever one-hot bit their stale bins give adds exactly 0.
template <typename BinT, int MT, bool kFull>
__device__ __forceinline__ void k1_tile(float (&acc)[MT][kNTiles][4],
                                        unsigned a_lane,
                                        const unsigned char* sb,
                                        const int (&row_off)[4],
                                        int bins_pitch, int k_steps,
                                        unsigned bg, int n_live) {
#pragma unroll 2
  for (int ks = 0; ks < k_steps; ++ks) {
    // bit j (of the low half for rows 2 tig and 2 tig + 8, of the high
    // half for the rows after them) is set when the row's bin is bg + 8 j
    unsigned m01 = 0, m89 = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const unsigned t = static_cast<unsigned>(static_cast<int>(
          *reinterpret_cast<const BinT*>(sb + ks * 16 * bins_pitch
                                         + row_off[i]))) - bg;
      const unsigned bit =
          (t & ~0x38u) == 0 ? (1u << (16 * (i & 1))) << (t >> 3) : 0u;
      if (i < 2) m01 |= bit;
      else m89 |= bit;
    }
    unsigned a[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
      ldmatrix_x4(a[mt], a_lane + (mt * 16 * kWPitch + ks * 16) * 2);
#pragma unroll
    for (int j = 0; j < kNTiles; ++j) {
      if (!kFull && j >= n_live) break;
      // bit j of each half times 0x3F80 >> j: bf16 1.0 or 0 in each half
      const unsigned b0 = (m01 & (0x10001u << j)) * (0x3F80u >> j);
      const unsigned b1 = (m89 & (0x10001u << j)) * (0x3F80u >> j);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) mma_bf16(acc[mt][j], a[mt], b0, b1);
    }
  }
}

// K3's k-steps of one packed tile for one warp: MT m-tiles of A built from
// the row pairs' node/g/h against the first n_live n-tiles of the warp's
// bin slice (all of them when kFull), B built from the rows' one-hot
// patterns.  node2[mt] is this lane's node in m-tile mt (8 mt + grp of the
// m-block) and bin2[j] its bin in n-tile j (base + 8 j + grp) as
// patterns, each in both halves.  The k-step loop is unrolled 4 times at
// 1-2 m-tiles and not at 3-4, the fastest of 1, 2 and 4 for each
// (tools/k3_variants.py).
template <int MT, bool kFull>
__device__ __forceinline__ void k3_tile(float (&acc)[MT][kNTiles][4],
                                        const uint4* pairs,
                                        const uint2* patterns,
                                        const unsigned (&node2)[MT],
                                        const unsigned (&bin2)[kNTiles],
                                        int k_steps, int n_live, int tig) {
#pragma unroll (MT >= 3 ? 1 : 4)
  for (int ks = 0; ks < k_steps; ++ks) {
    // data rows 2 tig, 2 tig + 1 (lo) and 2 tig + 8, 2 tig + 9 (hi)
    const uint2 pat = patterns[4 * ks + tig];
    const uint4 lo = pairs[8 * ks + tig];
    const uint4 hi = pairs[8 * ks + 4 + tig];
    unsigned a[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const unsigned in_lo = f16x2_eq_mask(lo.x, node2[mt]);
      const unsigned in_hi = f16x2_eq_mask(hi.x, node2[mt]);
      a[mt][0] = in_lo & lo.y;   // G row of the lane's node
      a[mt][1] = in_lo & lo.z;   // its H row
      a[mt][2] = in_hi & hi.y;
      a[mt][3] = in_hi & hi.z;
    }
#pragma unroll
    for (int j = 0; j < kNTiles; ++j) {
      if (!kFull && j >= n_live) break;
      const unsigned b0 = bf16x2_eq_one(pat.x, bin2[j]);
      const unsigned b1 = bf16x2_eq_one(pat.y, bin2[j]);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) mma_bf16(acc[mt][j], a[mt], b0, b1);
    }
  }
}

// K1.  Grid (unit group, row chunk, m-block); block = 32 * warps threads.
// Warp v of group g owns unit u = 8g + v: feature u / slices, bins
// [64 (u % slices), +64), for weight rows [64 m-block, +64) and the rows of
// the chunk, as MT m-tiles of 16 (MT = ceil(M / 16), at most 4: the guards
// that a runtime count needs cost as many instructions as the mma).  Shared memory: two stages, each a W tile [64][kWPitch] bf16
// and a bins slab [kTile][bins_pitch] bytes holding, for each row, the
// 16-byte granules over columns [feat_lo, feat_lo + nf) of the window.
template <typename BinT, int MT>
__global__ void __launch_bounds__(kWarps * 32, 1)
hist_matmul_kernel(const __nv_bfloat16* __restrict__ w, long long ld_w,
                   const BinT* __restrict__ bins, long long num_rows,
                   int num_feature, int ld_bins, int f_offset, int m_total,
                   int num_bins, long long rows_per_chunk, int slices,
                   int bins_pitch, float* __restrict__ partial) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int kBinBytes = sizeof(BinT);
  const int stage_bytes = kWStageBytes + kTile * bins_pitch;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int grp = lane >> 2;   // mma fragment row / column group
  const int tig = lane & 3;    // thread in group

  const long long units = static_cast<long long>(num_feature) * slices;
  const long long u0 = static_cast<long long>(blockIdx.x) * kWarps;
  const long long u_last = min(units, u0 + (blockDim.x >> 5)) - 1;
  const int feat_lo = static_cast<int>(u0 / slices);
  const int nf = static_cast<int>(u_last / slices) - feat_lo + 1;
  const long long unit = u0 + warp;
  const bool active = unit < units;
  const int f = active ? static_cast<int>(unit / slices) : feat_lo;
  const int base = active ? static_cast<int>(unit % slices) * kSlice : 0;

  const long long chunk = blockIdx.y;
  const int m0 = blockIdx.z * kMBlock;
  const int m_count = min(kMBlock, m_total - m0);
  const unsigned bg = static_cast<unsigned>(base + grp);
  const int n_live = min(kNTiles, (num_bins - base + 7) >> 3);

  // bins: the staged columns of row r of a tile start (lead + r * ld_s) mod
  // 16 bytes into a granule (a tile starts a multiple of kTile rows, so of
  // 16 bytes, after the first row of the array)
  const char* bins_b = reinterpret_cast<const char*>(bins);
  const long long ld_s = static_cast<long long>(ld_bins) * kBinBytes;
  const int col_bytes = (f_offset + feat_lo) * kBinBytes;
  const int seg_bytes = nf * kBinBytes;
  const int lead = static_cast<int>(
      (reinterpret_cast<uintptr_t>(bins) + col_bytes) & 15);
  const int ld_mod = static_cast<int>(ld_s & 15);
  const int granules = bins_pitch >> 4;

  // this lane's 4 rows of each k-step: 2*tig + {0, 1, 8, 9}; a row's shift
  // in its granule is the same in every k-step (16 rows = 0 mod 16 bytes)
  int row_off[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int q = 2 * tig + (i & 1) + 8 * (i >> 1);
    row_off[i] = q * bins_pitch + ((lead + q * ld_mod) & 15)
                 + (f - feat_lo) * kBinBytes;
  }

  const long long r_begin = chunk * rows_per_chunk;
  const long long r_end = min(num_rows, r_begin + rows_per_chunk);
  const int n_tiles =
      r_end > r_begin ? static_cast<int>((r_end - r_begin + kTile - 1) / kTile)
                      : 0;

  // issue the copies of tile k into its stage
  auto stage_tile = [&](int k) {
    const long long t0 = r_begin + static_cast<long long>(k) * kTile;
    const int tn = static_cast<int>(min(static_cast<long long>(kTile),
                                        r_end - t0));
    const int k_cols = (tn + 15) & ~15;     // W columns the k-steps read
    unsigned char* st = smem_raw + (k & 1) * stage_bytes;
    const unsigned sw = smem_u32(st);
    const unsigned sb = smem_u32(st + kWStageBytes);
    for (int idx = threadIdx.x; idx < m_count * (kTile / 8);
         idx += blockDim.x) {
      const int m = idx >> 5;               // kTile / 8 = 32 granules a row
      const int c = (idx & 31) * 8;
      if (c < k_cols) {
        const int n = min(8, max(0, tn - c));
        const __nv_bfloat16* src =
            n > 0 ? w + (m0 + m) * ld_w + t0 + c : w;
        cp_async16(sw + (m * kWPitch + c) * 2, src, 2 * n);
      }
    }
    for (int idx = threadIdx.x; idx < tn * granules; idx += blockDim.x) {
      const int r = idx / granules;
      const int g = idx - r * granules;
      const int shift = (lead + r * ld_mod) & 15;
      if (g < (shift + seg_bytes + 15) >> 4) {
        const char* src = bins_b + (t0 + r) * ld_s + col_bytes - shift + 16 * g;
        cp_async16(sb + r * bins_pitch + 16 * g, src, 16);
      }
    }
    cp_async_commit();
  };

  float acc[MT][kNTiles][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < kNTiles; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;

  if (n_tiles > 0) stage_tile(0);
  for (int k = 0; k < n_tiles; ++k) {
    if (k + 1 < n_tiles) {
      stage_tile(k + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();   // tile k has landed for every thread
    if (active) {
      const long long t0 = r_begin + static_cast<long long>(k) * kTile;
      const int tn = static_cast<int>(min(static_cast<long long>(kTile),
                                          r_end - t0));
      const unsigned char* st = smem_raw + (k & 1) * stage_bytes;
      const unsigned a_lane = smem_u32(st)
          + ((lane & 15) * kWPitch + (lane >> 4) * 8) * 2;
      const unsigned char* sb = st + kWStageBytes;
      if (n_live == kNTiles)
        k1_tile<BinT, MT, true>(acc, a_lane, sb, row_off, bins_pitch,
                                (tn + 15) >> 4, bg, n_live);
      else
        k1_tile<BinT, MT, false>(acc, a_lane, sb, row_off, bins_pitch,
                                 (tn + 15) >> 4, bg, n_live);
    }
    __syncthreads();   // tile k is consumed before its stage is refilled
  }

  if (!active) return;
  const long long row_len = static_cast<long long>(num_feature) * num_bins;
  float* out = partial + (chunk * m_total + m0) * row_len
               + static_cast<long long>(f) * num_bins;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < kNTiles; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = mt * 16 + grp + 8 * (e >> 1);
        const int col = base + 8 * j + 2 * tig + (e & 1);
        if (m < m_count && col < num_bins)
          out[m * row_len + col] = acc[mt][j][e];
      }
}

// K3.  Grid (unit group, row chunk, m-block); block = 256 threads.  Warp v
// of group g owns unit u = 8g + v as in K1 (warps past the last unit only
// pack), for the 32 nodes [32 m-block, +32) as MT m-tiles of 8 (MT =
// ceil(min(num_nodes, 32) / 8); a ragged last m-block computes nodes it
// does not write, whose rows all carry kNoNode).  Shared memory: two
// stages (kK3StageBytes each) of packed rows.  The launch bounds ask for
// 3 CTAs an SM at 1 m-tile and 2 at 2 (so at most 85 and 128 registers a
// thread), for more warps to hide latency; 4 m-tiles take one.
template <typename BinT, int MT>
__global__ void __launch_bounds__(kWarps * 32,
                                  MT == 1 ? 3 : MT == 2 ? 2 : 1)
grad_hist_fused_kernel(const BinT* __restrict__ bins,
                       const int* __restrict__ node,
                       const float* __restrict__ grad,
                       const float* __restrict__ hess, long long num_rows,
                       int num_feature, int ld_bins, int f_offset,
                       int num_nodes, int num_bins, long long rows_per_chunk,
                       int slices, float* __restrict__ partial) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int grp = lane >> 2;   // mma fragment row / column group
  const int tig = lane & 3;    // thread in group

  const long long units = static_cast<long long>(num_feature) * slices;
  const long long u0 = static_cast<long long>(blockIdx.x) * kWarps;
  const long long u_last = min(units, u0 + kWarps) - 1;
  const int feat_lo = static_cast<int>(u0 / slices);
  const int nf = static_cast<int>(u_last / slices) - feat_lo + 1;
  const long long unit = u0 + warp;
  const bool active = unit < units;
  const int f = active ? static_cast<int>(unit / slices) : feat_lo;
  const int base = active ? static_cast<int>(unit % slices) * kSlice : 0;

  const long long chunk = blockIdx.y;
  const int n0 = blockIdx.z * kNodeBlock;
  const unsigned n_count =
      static_cast<unsigned>(min(kNodeBlock, num_nodes - n0));
  const int n_live = min(kNTiles, (num_bins - base + 7) >> 3);

  // this lane's node in each m-tile and bin in each n-tile, as the
  // patterns the packed rows carry, in both halves
  unsigned node2[MT];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
    node2[mt] = 0x10001u * __half_as_ushort(__uint2half_rn(
                               static_cast<unsigned>(kNodeTile * mt + grp)));
  unsigned bin2[kNTiles];
#pragma unroll
  for (int j = 0; j < kNTiles; ++j)
    bin2[j] = 0x10001u * (0x3F80u + base + 8 * j + grp);

  const long long r_begin = chunk * rows_per_chunk;
  const long long r_end = min(num_rows, r_begin + rows_per_chunk);
  const int n_tiles =
      r_end > r_begin ? static_cast<int>((r_end - r_begin + kTile - 1) / kTile)
                      : 0;

  // thread x owns row x of every tile: its node, g, h and bins of the CTA's
  // nf columns, loaded into registers one tile ahead (rows past the
  // chunk's end: no node, g = h = 0, no bin) ...
  const BinT* cols = bins + f_offset + feat_lo;
  int row_node = -1;
  float row_g = 0.f, row_h = 0.f;
  int row_bin[kWarps];
  auto load_row = [&](int k) {
    const long long i =
        r_begin + static_cast<long long>(k) * kTile + threadIdx.x;
    const bool in = i < r_end;
    row_node = in ? node[i] : -1;
    row_g = in ? grad[i] : 0.f;
    row_h = in ? hess[i] : 0.f;
#pragma unroll
    for (int c = 0; c < kWarps; ++c)
      if (c < nf) row_bin[c] = in ? static_cast<int>(cols[i * ld_bins + c])
                                  : -1;
  };
  // ... and packed into tile k's stage, in the order the lanes read it:
  // the row pair {node, g, h} (node local to the m-block as an f16, kNoNode
  // outside it; g and h rounded to bf16 as the TPU kernel does before its
  // MXU dot), and per column the bf16 pattern 0x3F80 + bin (kNoBin for a
  // bin outside [0, num_bins)) at the slot of k-step x / 16, tig, lo/hi and
  // half of the row
  auto pack_row = [&](int k) {
    unsigned char* st = smem_raw + (k & 1) * kK3StageBytes;
    unsigned short* pk = reinterpret_cast<unsigned short*>(st)
        + (threadIdx.x >> 1) * (kPairBytes / 2) + (threadIdx.x & 1);
    const unsigned loc =
        static_cast<unsigned>(row_node) - static_cast<unsigned>(n0);
    pk[0] = loc < n_count ? __half_as_ushort(__uint2half_rn(loc)) : kNoNode;
    pk[2] = __bfloat16_as_ushort(__float2bfloat16_rn(row_g));
    pk[4] = __bfloat16_as_ushort(__float2bfloat16_rn(row_h));
    const int r = threadIdx.x & 15;
    unsigned short* pt = reinterpret_cast<unsigned short*>(
        st + kTile / 2 * kPairBytes)
        + (threadIdx.x & ~15) + ((r & 7) >> 1) * 4 + (r >> 3) * 2 + (r & 1);
#pragma unroll
    for (int c = 0; c < kWarps; ++c)
      if (c < nf)
        pt[c * kTile] = static_cast<unsigned>(row_bin[c])
                                < static_cast<unsigned>(num_bins)
                            ? static_cast<unsigned short>(0x3F80 + row_bin[c])
                            : kNoBin;
  };

  float acc[MT][kNTiles][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < kNTiles; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;

  if (n_tiles > 0) {
    load_row(0);
    pack_row(0);
  }
  // one barrier a tile: the stage a thread packs after computing tile k was
  // last read for tile k - 1, which every warp finished before this barrier
  for (int k = 0; k < n_tiles; ++k) {
    if (k + 1 < n_tiles) load_row(k + 1);
    __syncthreads();   // tile k is packed
    if (active) {
      const long long t0 = r_begin + static_cast<long long>(k) * kTile;
      const int k_steps = static_cast<int>(
          (min(static_cast<long long>(kTile), r_end - t0) + 15) >> 4);
      const unsigned char* st = smem_raw + (k & 1) * kK3StageBytes;
      const uint4* pairs = reinterpret_cast<const uint4*>(st);
      const uint2* patterns = reinterpret_cast<const uint2*>(
          st + kTile / 2 * kPairBytes + (f - feat_lo) * kTile * 2);
      if (n_live == kNTiles)
        k3_tile<MT, true>(acc, pairs, patterns, node2, bin2, k_steps, n_live,
                          tig);
      else
        k3_tile<MT, false>(acc, pairs, patterns, node2, bin2, k_steps,
                           n_live, tig);
    }
    if (k + 1 < n_tiles) pack_row(k + 1);
  }

  if (!active) return;
  // accumulator e of m-tile mt holds row grp + 8 (e >> 1) of the m-tile:
  // G (e < 2) or H of node n0 + 8 mt + grp, bin column 2 tig + (e & 1)
  const long long row_len = static_cast<long long>(num_feature) * num_bins;
  float* out = partial + chunk * 2 * num_nodes * row_len
               + static_cast<long long>(f) * num_bins;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int nd = n0 + kNodeTile * mt + grp;
    if (nd >= num_nodes) continue;
#pragma unroll
    for (int j = 0; j < kNTiles; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = base + 8 * j + 2 * tig + (e & 1);
        if (col < num_bins)
          out[(static_cast<long long>(e >> 1) * num_nodes + nd) * row_len
              + col] = acc[mt][j][e];
      }
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
cudaError_t launch_hist_matmul(const void* w, long long ld_w,
                               const void* bins, long long num_rows,
                               int num_feature, int ld_bins, int f_offset,
                               int m_total, int num_bins,
                               long long rows_per_chunk, int n_chunks,
                               float* partial, float* out,
                               cudaStream_t stream) {
  const MatmulPlan p = matmul_plan(num_feature, num_bins, sizeof(BinT));
  if (p.smem > kMaxSmem) return cudaErrorInvalidValue;
  // m-tiles per block from M: a ragged last block computes rows it does not
  // write, on stale shared memory (an mma row depends on its own A row only)
  auto kernel = hist_matmul_kernel<BinT, kMTiles>;
  switch ((m_total + 15) / 16) {
    case 1: kernel = hist_matmul_kernel<BinT, 1>; break;
    case 2: kernel = hist_matmul_kernel<BinT, 2>; break;
    case 3: kernel = hist_matmul_kernel<BinT, 3>; break;
    default: break;
  }
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(p.groups), n_chunks,
                  (m_total + kMBlock - 1) / kMBlock);
  kernel<<<grid, 32 * p.warps, p.smem, stream>>>(
      static_cast<const __nv_bfloat16*>(w), ld_w,
      static_cast<const BinT*>(bins), num_rows, num_feature, ld_bins,
      f_offset, m_total, num_bins, rows_per_chunk, p.slices, p.bins_pitch,
      partial);
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
                                   long long rows_per_chunk, int n_chunks,
                                   float* partial, float* out,
                                   cudaStream_t stream) {
  const MatmulPlan p = matmul_plan(num_feature, num_bins, sizeof(BinT));
  // m-tiles per warp from the nodes of one m-block
  auto kernel = grad_hist_fused_kernel<BinT, 4>;
  switch ((min(num_nodes, kNodeBlock) + kNodeTile - 1) / kNodeTile) {
    case 1: kernel = grad_hist_fused_kernel<BinT, 1>; break;
    case 2: kernel = grad_hist_fused_kernel<BinT, 2>; break;
    case 3: kernel = grad_hist_fused_kernel<BinT, 3>; break;
    default: break;
  }
  const dim3 grid(static_cast<unsigned>(p.groups), n_chunks,
                  (num_nodes + kNodeBlock - 1) / kNodeBlock);
  kernel<<<grid, kWarps * 32, kK3Smem, stream>>>(
      static_cast<const BinT*>(bins), static_cast<const int*>(node),
      static_cast<const float*>(grad), static_cast<const float*>(hess),
      num_rows, num_feature, ld_bins, f_offset, num_nodes, num_bins,
      rows_per_chunk, p.slices, partial);
  const cudaError_t err = cudaGetLastError();
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

// K1.  w [m_total, ld_w] bf16 of which columns [0, num_rows) are read (ld_w
// a multiple of 8 and w 16-byte aligned, so W rows copy in 16-byte pieces),
// bins [num_rows, ld_bins] (uint8 when bins_u8, else int32) of which
// columns [f_offset, f_offset + num_feature) are read, partial [n_chunks,
// m_total, F*nbins] f32 (may alias out when n_chunks == 1), out [m_total,
// F*nbins] f32 with F = num_feature.  Returns the CUDA error of the launches
// (0 on success).
int dmlc_hist_matmul(const void* w, const void* bins, int bins_u8,
                     long long num_rows, int num_feature, int ld_bins,
                     int f_offset, int m_total, int num_bins, int ld_w,
                     long long rows_per_chunk, int n_chunks, void* partial,
                     void* out, void* stream) {
  if (bad_shape(num_rows, num_feature, ld_bins, f_offset, m_total, num_bins,
                kMBlock, rows_per_chunk, n_chunks)
      || n_chunks > 65535 || ld_w < num_rows || ld_w % 8 != 0
      || reinterpret_cast<uintptr_t>(w) % 16 != 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(partial);
  float* o = static_cast<float*>(out);
  return bins_u8
             ? launch_hist_matmul<uint8_t>(w, ld_w, bins, num_rows,
                                           num_feature, ld_bins, f_offset,
                                           m_total, num_bins, rows_per_chunk,
                                           n_chunks, p, o, s)
             : launch_hist_matmul<int32_t>(w, ld_w, bins, num_rows,
                                           num_feature, ld_bins, f_offset,
                                           m_total, num_bins, rows_per_chunk,
                                           n_chunks, p, o, s);
}

// K3.  bins as for K1, node [num_rows] int32 (num_nodes < 65535),
// grad/hess [num_rows] f32, partial [n_chunks, 2, num_nodes, F*nbins] f32
// (may alias out when n_chunks == 1), out [2, num_nodes, F*nbins] f32 with
// F = num_feature.  Returns the CUDA error of the launches (0 on success).
int dmlc_grad_hist_fused(const void* bins, int bins_u8, const void* node,
                         const void* grad, const void* hess,
                         long long num_rows, int num_feature, int ld_bins,
                         int f_offset, int num_nodes, int num_bins,
                         long long rows_per_chunk, int n_chunks,
                         void* partial, void* out, void* stream) {
  if (bad_shape(num_rows, num_feature, ld_bins, f_offset, num_nodes,
                num_bins, kNodeBlock, rows_per_chunk, n_chunks)
      || n_chunks > 65535 || num_nodes >= 65535)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(partial);
  float* o = static_cast<float*>(out);
  return bins_u8
             ? launch_grad_hist_fused<uint8_t>(
                   bins, node, grad, hess, num_rows, num_feature, ld_bins,
                   f_offset, num_nodes, num_bins, rows_per_chunk, n_chunks,
                   p, o, s)
             : launch_grad_hist_fused<int32_t>(
                   bins, node, grad, hess, num_rows, num_feature, ld_bins,
                   f_offset, num_nodes, num_bins, rows_per_chunk, n_chunks,
                   p, o, s);
}

}  // extern "C"
