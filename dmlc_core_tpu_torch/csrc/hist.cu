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
//    (and H from h), as a product transposed onto Hopper's wgmma: the bin
//    one-hot is A, built in registers, and the node-masked g/h rows are
//    B, built once a stage in shared memory: no W matrix exists.  Below
//    the root it runs listed: it reads only the rows of the nodes it
//    builds, through a row list that row_partition (three small kernels,
//    the counterpart of no TPU kernel: the TPU kernel masks every row)
//    groups by node on the card.
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
// K3's design, bounds and hazards: the note above grad_hist_fused_kernel.

#include <cuda_bf16.h>
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

// K3's launch plan (grad_hist_fused_plan in ops/hist_cuda.py computes the
// same): K1's 64-bin slices as units, 1 to 4 a consumer warpgroup; node
// blocks of a power of two nodes (wgmma's N = 2 * nodes, 8 to 64) on grid z
constexpr int kK3MaxCols = 64;       // wgmma's largest N here: 32 nodes
constexpr int kK3Consumers = 4;      // consumer warpgroups a CTA
constexpr int kK3RawStages = 2;      // stages of raw rows in flight
constexpr int kK3BStages = 2;        // stages of built B and patterns
constexpr int kK3BulkSlab = 32768;   // most bins bytes a stage copies whole
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

// -- Hopper's barriers, bulk copies and warpgroup products (K3) -----------
__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

// makes the barriers' initialisation visible to the async proxy
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned bar) {
  asm volatile("{\n.reg .b64 state;\n"
               "mbarrier.arrive.shared::cta.b64 state, [%0];\n}\n"
               :: "r"(bar) : "memory");
}

// one arrival that also expects `bytes` of bulk copies to complete
__device__ __forceinline__ void mbar_arrive_tx(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

// until the phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  asm volatile("{\n.reg .pred done;\n"
               "K3_WAIT:\n"
               "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
               "@!done bra K3_WAIT;\n}\n"
               :: "r"(bar), "r"(parity) : "memory");
}

// global -> shared bulk copy (16-byte aligned ends, a multiple of 16 bytes)
// completing `bytes` on the barrier
__device__ __forceinline__ void bulk_copy(unsigned dst, const void* src,
                                          unsigned bytes, unsigned bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx"
               "::bytes [%0], [%1], %2, [%3];\n"
               :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

__device__ __forceinline__ void cp_async4(unsigned dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(dst), "l"(src) : "memory");
}

// one arrival on the barrier once this thread's cp.async copies land
__device__ __forceinline__ void cp_async_arrive(unsigned bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
               :: "r"(bar) : "memory");
}

// orders this thread's shared-memory accesses before the async proxy's
// (wgmma's reads of B, the bulk copies' writes)
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// wgmma's shared-memory matrix descriptor: the start address, the leading
// and the stride byte offsets (each in 16-byte units) and the layout type
// (0 no swizzle, 1 128-byte, 2 64-byte, 3 32-byte swizzle)
__device__ __forceinline__ unsigned long long smem_desc(unsigned addr,
                                                        unsigned lbo,
                                                        unsigned sbo,
                                                        unsigned layout) {
  return static_cast<unsigned long long>((addr & 0x3FFFF) >> 4)
         | static_cast<unsigned long long>(lbo >> 4) << 16
         | static_cast<unsigned long long>(sbo >> 4) << 32
         | static_cast<unsigned long long>(layout) << 62;
}

// d (64 x N f32, accumulated) += a (64 x 16 bf16, registers) * b (16 x N
// bf16, shared memory, N-major: imm-trans-b = 1) for one warpgroup
template <int N>
struct Wgmma;

#define K3_D4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define K3_D8(i) K3_D4(i), K3_D4(i + 4)
#define K3_D32(i) K3_D8(i), K3_D8(i + 8), K3_D8(i + 16), K3_D8(i + 24)

template <>
struct Wgmma<8> {
  static __device__ __forceinline__ void mma(float (&d)[4],
                                           const unsigned (&a)[4],
                                           unsigned long long desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, %8, p, 1, 1, 1;\n}\n"
        : K3_D4(0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

template <>
struct Wgmma<16> {
  static __device__ __forceinline__ void mma(float (&d)[8],
                                           const unsigned (&a)[4],
                                           unsigned long long desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7}, "
        "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
        : K3_D8(0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

template <>
struct Wgmma<32> {
  static __device__ __forceinline__ void mma(float (&d)[16],
                                           const unsigned (&a)[4],
                                           unsigned long long desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : K3_D8(0), K3_D8(8)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void mma(float (&d)[32],
                                           const unsigned (&a)[4],
                                           unsigned long long desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : K3_D32(0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

#undef K3_D32
#undef K3_D8
#undef K3_D4
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

// K3 on Hopper's warpgroup products.  K3 replaces grad_hist_pallas_fused
// (_fused_kernel, dmlc_core_tpu/ops/hist_pallas.py:236-291), which builds
// the weight tile [nodehot*g ; nodehot*h] in VMEM from node/g/h and runs
// K1's MXU product with the bin one-hot.  Bounds on an H100 at
// chip_smoke.py's shape (B = 2,000,000, F = 28, 256 bins):
//   * bytes: the bins (56 MB), 12 B of node/g/h a row (24 MB) and the output
//     (2 * n * F * nbins f32) once each: 0.024 ms at n = 32, 3.35 TB/s;
//   * the product done densely on the tensor cores, 2 * 64 * N * B * F *
//     slices per node block (N below): 1.855 ms at n = 32 (N = 64), 0.232 ms
//     at n = 1 (N = 8) and 14.8 ms at n = 256 (eight blocks of N = 64), at
//     989 TFLOP/s.
// The one-hots are mostly zeros, so the dense product is the price of the
// tensor cores; the design's job is to keep them fed, so that building the
// operands costs less than the products.
//
// The design: the product is transposed.  For one (feature, 64-bin slice)
// unit and a block of nodes, out^T[bin, (node, G|H)] = onehot[bin, row] x
// rows[row, (node, G|H)], one wgmma.mma_async.m64nNk16 (bf16 in, f32 sums
// in registers) per 16 rows:
//   * M = the unit's 64 bins.  A, the one-hot, is built in registers: the
//     thread of warp w of a warpgroup, lane (g, t), holds bins 16w + g and
//     16w + g + 8 of rows 2t, 2t + 1, 2t + 8 and 2t + 9, so four
//     set.eq.bf16x2 of the rows' patterns (bf16 0x3F80 + bin; kNoBin, a
//     NaN, for a bin outside [0, num_bins)) against its bins' patterns give
//     its four A registers, whatever N is.
//   * N = 2 * the nodes of the CTA's node block (a power of two, 8 to 64):
//     column 2 node + s holds G (s = 0) or H (s = 1) of a node.  B, the
//     node-masked g/h rows [16 rows x N] bf16, lives in shared memory and is
//     built once a stage for every unit of the CTA: a row's B row is zero
//     but for the word (bf16 g, bf16 h) at its node's columns, so the node
//     masking is done once per row and block, not once per feature.  Rows
//     of other blocks and rows past the chunk's end are zero rows.  Blocks
//     of 64 and 128 nodes (N = 128, 256: fewer passes over the rows at deep
//     levels) measured slower on an H100 at n = 256 (29.6 and 30.3 ms
//     against 25.9 for blocks of 32), so a block holds at most 32 nodes.
//   * B's layout is N-major (imm-trans-b = 1) and swizzled as wide as N
//     allows: atoms of 8 rows x W 16-byte chunks (8 W columns), W = 8 at N
//     = 64 (the descriptor's 128-byte swizzle), 4 at N = 32 (64-byte), 2
//     at N = 16 (32-byte), 1 at N = 8 (no swizzle, one core matrix).  Row k
//     of an atom is 16 W bytes at (k % 8) * 16 W; its chunk c lands at c ^
//     ((k % 8) >> (3 - log2 W)) (address bits 4.. XOR bits 7..).  Atoms
//     along N follow each other (128 W bytes: the leading byte offset),
//     groups of 8 rows follow those (16 N bytes: the stride byte offset;
//     without swizzle the two swap roles), so a k-step's B starts 32 N
//     bytes after the last's.  The B stages start 1024-byte aligned.  A
//     warp's 16-byte stores of one chunk over 8 rows hit 8 distinct bank
//     groups, and so do the tensor cores' reads of a row.
//   * Feeding: a producer warpgroup keeps kK3RawStages stages of raw rows
//     in flight: node, g and h of the stage's rows, and the bins rows, each
//     by one cp.async.bulk where its base is 16-byte aligned (a stage of whole
//     ld_bins-wide rows is contiguous and a multiple of 16 bytes), else by
//     cp.async (a value of 4 bytes a copy; the bins as the 16-byte granules
//     over the CTA's columns of each row, as K1 stages them, which also
//     serves rows too wide for a stage), completing on the stage's
//     mbarrier.  From each raw stage its 128 threads build B and the
//     one-hot patterns of the CTA's columns (a row or two each) into one of
//     kK3BStages built stages, meet at a named barrier of their own, and
//     one arrives on the stage's full barrier and refills the raw stage;
//     the consumers arrive on its empty barrier once the wgmmas that read it
//     have retired.  No CTA-wide barrier after set-up.  (A single producer
//     warp was the bottleneck: on an H100 at n = 1 the kernel took 2.9 ms
//     with its wgmmas and 2.6 ms without them.)
//   * Consumers: warpgroup v of C = 4 owns units C U blockIdx.x + U v .. +
//     U - 1 (U = 4 at N <= 16, 2 at N = 32, 1 at N = 64: U N / 2 f32
//     accumulators a thread) for its whole row chunk.  More units a
//     warpgroup mean fewer CTAs, so less of the producer's work and fewer
//     raw copies, which are repeated in every CTA.  Each k-step:
//     wgmma.fence, a wgmma per unit on the same B, commit, then wait until
//     one group is in flight, so a k-step's A is built while the last one
//     multiplies.  A wgmma reads its A registers until it retires, so the
//     even and odd k-steps build A at two call sites (two register sets)
//     and each overwrites its set only after the wait has retired the
//     wgmma that read it; waiting for two groups instead gave wrong sums.
//     The stage a warpgroup last read is released after the first k-step
//     of the next, whose wait leaves that k-step's group alone in flight.
//     A stage holds 512 rows (a B stage of at most 64 KB): each stage costs
//     its CTA a fixed ~1,000 cycles of barrier round trips and copies, so
//     long stages pay.
//   * Epilogue: accumulator e of a unit, in warp w, lane (g, t), holds bin
//     16w + g + 8 ((e >> 1) & 1) of the unit's slice and column 8 (e >> 2)
//     + 2t + (e & 1): s = e & 1 of node 4 (e >> 2) + t of the block.  It is
//     written to the chunk's partial when the unit, node and bin lie in
//     range.
// Hazards:
//   * Node ids are int32 and may be -1 or >= num_nodes: a row's id is made
//     local to the block with unsigned arithmetic and placed only when it
//     lies in [0, nodes of this block).
//   * Bins outside [0, num_bins) (int32 bins may be negative) become kNoBin,
//     which equals no pattern; A rows of bins past num_bins are all zero,
//     and the epilogue does not write them.  Windows and row strides need
//     nothing more: the producer reads each row's columns where they landed.
//   * Rows past the chunk's end are not read: their B rows are zero and
//     their patterns kNoBin, so they add exactly 0.  A bulk copy rounded up
//     to 16 bytes reads at most the aligned granule that holds the last
//     byte, which lies in the array's allocation.
//   * g or h NaN or infinite spreads over every bin of its node's column, as
//     in the TPU kernel's product (W times a one-hot).
template <int N>
struct K3Shape {
  static_assert(N == 8 || N == 16 || N == 32 || N == kK3MaxCols,
                "N: the G and H columns of 4 to 32 nodes");
  static constexpr int kUnits = N <= 16 ? 4 : N == 32 ? 2 : 1;  // a warpgroup
  static constexpr int kPerCta = kK3Consumers * kUnits;  // units a CTA
  // the consumers and one producer warpgroup
  static constexpr int kThreads = 128 * (kK3Consumers + 1);
  static constexpr int kRows = 2 * kTile;   // a stage
  // B's swizzle: W 16-byte chunks a row of an atom, 2^kSwz = W
  static constexpr int kW = N / 8;
  static constexpr int kSwz = kW == 8 ? 3 : kW == 4 ? 2 : kW == 2 ? 1 : 0;
  static constexpr unsigned kLayout = kW == 8 ? 1 : kW == 4 ? 2 : kW == 2 ? 3
                                                                        : 0;
  static constexpr unsigned kLbo = kW == 1 ? 16 * N : 128 * kW;
  static constexpr unsigned kSbo = kW == 1 ? 128 : 16 * N;
};

// byte offset of B's 16-byte chunk c (columns 8c .. 8c + 7) of row k in a
// stage
template <int N>
__device__ __forceinline__ int b_chunk(int k, int c) {
  using S = K3Shape<N>;
  return (k >> 3) * (16 * N) + (c >> S::kSwz) * (128 * S::kW)
         + (k & 7) * (16 * S::kW)
         + (((c & (S::kW - 1)) ^ ((k & 7) >> (3 - S::kSwz))) << 4);
}

// One k-step of a consumer warpgroup for each of its U units: A from the
// patterns of the unit's row pairs (lo: rows 2t, 2t + 1; hi: rows 2t + 8,
// 2t + 9) against this thread's two bins of the unit (m0, m1 as
// patterns), times the B at b_addr; returns with one wgmma group, this
// one, in flight
template <int N, int U>
__device__ __forceinline__ void k3_step(float (&acc)[U][N / 2],
                                        const unsigned (&lo)[U],
                                        const unsigned (&hi)[U],
                                        const unsigned (&m0)[U],
                                        const unsigned (&m1)[U],
                                        unsigned b_addr) {
  unsigned a[U][4];
#pragma unroll
  for (int k = 0; k < U; ++k) {
    a[k][0] = bf16x2_eq_one(lo[k], m0[k]);
    a[k][1] = bf16x2_eq_one(lo[k], m1[k]);
    a[k][2] = bf16x2_eq_one(hi[k], m0[k]);
    a[k][3] = bf16x2_eq_one(hi[k], m1[k]);
  }
  const unsigned long long desc = smem_desc(
      b_addr, K3Shape<N>::kLbo, K3Shape<N>::kSbo, K3Shape<N>::kLayout);
  wgmma_fence();
#pragma unroll
  for (int k = 0; k < U; ++k) Wgmma<N>::mma(acc[k], a[k], desc);
  wgmma_commit();
  wgmma_wait<1>();
}

// Shared memory of one K3 CTA, from a 1024-byte aligned base (allocated
// with 1024 bytes to spare): kK3BStages stages of B and of patterns,
// kK3RawStages stages of raw rows (node, g, h as 4 B a row; in the listed
// mode a byte a row, the row's shift in its first bins granule; then the
// bins slab), then the barriers (raw full, built full, built empty).
struct K3Layout {
  int b_stage, pat_stage, raw_stage;   // bytes of one stage of each
  int off_slab;                        // the bins slab in a raw stage
  int off_pat, off_raw, off_bar, smem;
};

__host__ __device__ inline K3Layout k3_layout(int cols, int rows, int span,
                                              int slab_pitch, bool listed) {
  K3Layout l;
  l.b_stage = rows * cols * 2;
  l.pat_stage = span * rows * 2;
  l.off_slab = rows * (listed ? 13 : 12);   // 16-byte aligned: rows % 16 == 0
  l.raw_stage = l.off_slab + rows * slab_pitch;
  l.off_pat = kK3BStages * l.b_stage;
  l.off_raw = l.off_pat + kK3BStages * l.pat_stage;
  l.off_bar = l.off_raw + kK3RawStages * l.raw_stage;
  l.smem = 1024 + l.off_bar + 8 * (kK3RawStages + 2 * kK3BStages);
  return l;
}

// K3.  Grid (unit group, row chunk, node block); block = K3Shape<N>::
// kThreads: C consumer warpgroups, then the producer warpgroup.  bins_bulk
// says that the bins come as whole rows by bulk copy (slab_pitch = the
// row's bytes), else as granules over the CTA's span of columns
// (slab_pitch a multiple of 16).
//
// The listed mode (kListed, with rows and offsets; a level below the root,
// where half the rows or more belong to no built node): rows [0,
// offsets[num_nodes]) is the level's row list grouped by node id, node n's
// rows at positions [offsets[n], offsets[n + 1]) in row order
// (row_partition).  A template parameter, so the dense launch of the root
// compiles to the code it had without the mode.  Node block z
// then reads the positions [offsets[n0], offsets[min(n0 + N / 2,
// num_nodes)]) alone, cut into the launch's gridDim.y chunks of
// ceil(len / gridDim.y) positions rounded up to whole tiles (from the
// offsets, so from the data alone), and the producer reads each listed
// row's node, g, h and bins granules through the list by cp.async.  Rows
// of other blocks and of no built node are never read.  A node block's
// rows keep their order, so each accumulator still adds its rows in a
// fixed order.
template <typename BinT, int N, bool kListed>
__global__ void __launch_bounds__(K3Shape<N>::kThreads, 1)
grad_hist_fused_kernel(const BinT* __restrict__ bins,
                       const int* __restrict__ node,
                       const float* __restrict__ grad,
                       const float* __restrict__ hess,
                       const int* __restrict__ rows,
                       const int* __restrict__ offsets, long long num_rows,
                       int num_feature, int ld_bins, int f_offset,
                       int num_nodes, int num_bins, long long rows_per_chunk,
                       int slices, int span, int bins_bulk, int slab_pitch,
                       float* __restrict__ partial) {
  constexpr int C = kK3Consumers;
  constexpr int U = K3Shape<N>::kUnits;
  constexpr int R = K3Shape<N>::kRows;
  constexpr int kRowsPt = R / 128;   // rows of a stage a producer thread
  constexpr int kBinBytes = sizeof(BinT);
  extern __shared__ __align__(16) unsigned char k3_smem_raw[];
  constexpr bool listed = kListed;
  const K3Layout lay = k3_layout(N, R, span, slab_pitch, listed);
  const unsigned sbase = (smem_u32(k3_smem_raw) + 1023) & ~1023u;
  unsigned char* k3_smem = k3_smem_raw + (sbase - smem_u32(k3_smem_raw));
  const unsigned raw_full = sbase + lay.off_bar;         // kK3RawStages
  const unsigned b_full = raw_full + 8 * kK3RawStages;   // kK3BStages
  const unsigned b_empty = b_full + 8 * kK3BStages;      // kK3BStages
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  const long long units = static_cast<long long>(num_feature) * slices;
  const long long u0 = static_cast<long long>(blockIdx.x) * (C * U);
  const int live = static_cast<int>(min(static_cast<long long>(C * U),
                                        units - u0));   // units
  const int live_wg = (live + U - 1) / U;               // their warpgroups
  const int feat_lo = static_cast<int>(u0 / slices);
  const int nf = static_cast<int>((u0 + live - 1) / slices) - feat_lo + 1;
  const long long chunk = blockIdx.y;
  const int n0 = blockIdx.z * (N / 2);
  // rows [r_begin, r_end) of the array, or positions of the row list
  long long r_begin, r_end;
  if constexpr (listed) {
    const long long lo = offsets[n0];
    const long long hi = offsets[min(n0 + N / 2, num_nodes)];
    const long long per =
        ((hi - lo + gridDim.y - 1) / gridDim.y + kTile - 1) / kTile * kTile;
    r_begin = min(hi, lo + chunk * per);
    r_end = min(hi, r_begin + per);
  } else {
    r_begin = chunk * rows_per_chunk;
    r_end = min(num_rows, r_begin + rows_per_chunk);
  }
  const int n_stages =
      r_end > r_begin ? static_cast<int>((r_end - r_begin + R - 1) / R) : 0;

  if (threadIdx.x == 0) {
    // a raw stage completes on the producer's first thread's expect-tx
    // arrival and one cp.async arrival from each producer thread; a built
    // stage on that first thread (full) and the live consumers' warps
    // (empty)
    for (int s = 0; s < kK3RawStages; ++s) mbar_init(raw_full + 8 * s, 129);
    for (int s = 0; s < kK3BStages; ++s) {
      mbar_init(b_full + 8 * s, 1);
      mbar_init(b_empty + 8 * s, 4 * live_wg);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= 4 * C) {
    // ---- producer: raw rows in, B and the patterns out ----
    const int pt = threadIdx.x - 128 * C;   // producer thread
    const char* bins_b = reinterpret_cast<const char*>(bins);
    const long long ld_s = static_cast<long long>(ld_bins) * kBinBytes;
    const int col_bytes = (f_offset + feat_lo) * kBinBytes;
    const int seg_bytes = nf * kBinBytes;
    // granules: row r's columns start (lead + r * ld_mod) mod 16 bytes into
    // its first granule (a stage starts a multiple of 256 rows, so of 16
    // bytes, after the first row of the array)
    const int lead = static_cast<int>(
        (reinterpret_cast<uintptr_t>(bins) + col_bytes) & 15);
    const int ld_mod = static_cast<int>(ld_s & 15);
    const int granules = slab_pitch >> 4;
    const char* vec[3] = {reinterpret_cast<const char*>(node),
                          reinterpret_cast<const char*>(grad),
                          reinterpret_cast<const char*>(hess)};
    bool vec_bulk[3];
#pragma unroll
    for (int v = 0; v < 3; ++v)
      vec_bulk[v] =
          !listed && (reinterpret_cast<uintptr_t>(vec[v]) & 15) == 0;

    // listed: this thread's rows pt + 128 q of stage i, from the row list
    auto fetch = [&](int i, int (&rw)[kRowsPt]) {
      const long long t0 = r_begin + static_cast<long long>(i) * R;
#pragma unroll
      for (int q = 0; q < kRowsPt; ++q)
        rw[q] = t0 + pt + 128 * q < r_end ? rows[t0 + pt + 128 * q] : 0;
    };

    // the copies of stage i into its raw stage (rw: its listed rows)
    auto issue = [&](int i, const int (&rw)[kRowsPt]) {
      const int slot = i % kK3RawStages;
      const long long t0 = r_begin + static_cast<long long>(i) * R;
      const int tn = static_cast<int>(min(static_cast<long long>(R),
                                          r_end - t0));
      const unsigned raw = sbase + lay.off_raw + slot * lay.raw_stage;
      const unsigned bar = raw_full + 8 * slot;
      const unsigned vec_bytes = (4u * tn + 15) & ~15u;
      const unsigned slab_bytes =
          static_cast<unsigned>((tn * ld_s + 15) & ~15LL);
      if (pt == 0) {
        unsigned tx = bins_bulk ? slab_bytes : 0u;
#pragma unroll
        for (int v = 0; v < 3; ++v)
          if (vec_bulk[v]) tx += vec_bytes;
        mbar_arrive_tx(bar, tx);
#pragma unroll
        for (int v = 0; v < 3; ++v)
          if (vec_bulk[v])
            bulk_copy(raw + v * 4 * R, vec[v] + 4 * t0, vec_bytes, bar);
        if (bins_bulk)
          bulk_copy(raw + lay.off_slab, bins_b + t0 * ld_s, slab_bytes, bar);
      }
      if constexpr (listed) {
        unsigned char* shifts =
            k3_smem + lay.off_raw + slot * lay.raw_stage + 12 * R;
#pragma unroll
        for (int q = 0; q < kRowsPt; ++q) {
          const int r = pt + 128 * q;
          if (r < tn) {
            const long long row = rw[q];
#pragma unroll
            for (int v = 0; v < 3; ++v)
              cp_async4(raw + v * 4 * R + 4 * r, vec[v] + 4 * row);
            const int shift = static_cast<int>((lead + row * ld_mod) & 15);
            shifts[r] = static_cast<unsigned char>(shift);
            const char* src = bins_b + row * ld_s + col_bytes - shift;
            for (int gi = 0; gi < (shift + seg_bytes + 15) >> 4; ++gi)
              cp_async16(raw + lay.off_slab + r * slab_pitch + 16 * gi,
                         src + 16 * gi, 16);
          }
        }
      } else {
#pragma unroll
        for (int v = 0; v < 3; ++v)
          if (!vec_bulk[v])
            for (int r = pt; r < tn; r += 128)
              cp_async4(raw + v * 4 * R + 4 * r, vec[v] + 4 * (t0 + r));
        if (!bins_bulk) {
          for (int idx = pt; idx < tn * granules; idx += 128) {
            const int r = idx / granules;
            const int gi = idx - r * granules;
            const int shift = (lead + r * ld_mod) & 15;
            if (gi < (shift + seg_bytes + 15) >> 4)
              cp_async16(
                  raw + lay.off_slab + r * slab_pitch + 16 * gi,
                  bins_b + (t0 + r) * ld_s + col_bytes - shift + 16 * gi, 16);
          }
        }
      }
      cp_async_arrive(bar);
    };

    const unsigned n_count =
        static_cast<unsigned>(min(N / 2, num_nodes - n0));
    int rw[kRowsPt] = {};   // listed: the rows of the next stage to issue
    for (int i = 0; i < n_stages && i < kK3RawStages; ++i) {
      if (listed) fetch(i, rw);
      issue(i, rw);
    }
    for (int i = 0; i < n_stages; ++i) {
      const int rs = i % kK3RawStages;
      const int bs = i % kK3BStages;
      const long long t0 = r_begin + static_cast<long long>(i) * R;
      const int tn = static_cast<int>(min(static_cast<long long>(R),
                                          r_end - t0));
      // the list's loads stay in flight while this stage is built
      if (listed && i + kK3RawStages < n_stages) fetch(i + kK3RawStages, rw);
      mbar_wait(raw_full + 8 * rs, (i / kK3RawStages) & 1);
      // a fresh barrier passes parity 1: the first round finds B free
      mbar_wait(b_empty + 8 * bs, ((i / kK3BStages) & 1) ^ 1);
      const unsigned char* raw = k3_smem + lay.off_raw + rs * lay.raw_stage;
      const int* r_node = reinterpret_cast<const int*>(raw);
      const float* r_g = reinterpret_cast<const float*>(raw + 4 * R);
      const float* r_h = reinterpret_cast<const float*>(raw + 8 * R);
      const unsigned char* r_shift = raw + 12 * R;
      const unsigned char* r_bins = raw + lay.off_slab;
      unsigned char* b_st = k3_smem + bs * lay.b_stage;
      unsigned short* pat = reinterpret_cast<unsigned short*>(
          k3_smem + lay.off_pat + bs * lay.pat_stage);
#pragma unroll
      for (int r = pt; r < R; r += 128) {
        const bool in = r < tn;
        const unsigned loc =
            in ? static_cast<unsigned>(r_node[r]) - static_cast<unsigned>(n0)
               : 0xFFFFFFFFu;
        // B row r: zero, then (g, h) as bf16 at columns 2 loc, 2 loc + 1
#pragma unroll
        for (int q = 0; q < N / 8; ++q)
          *reinterpret_cast<uint4*>(b_st + b_chunk<N>(r, q)) =
              make_uint4(0, 0, 0, 0);
        if (loc < n_count)
          *reinterpret_cast<__nv_bfloat162*>(
              b_st + b_chunk<N>(r, loc >> 2) + 4 * (loc & 3)) =
              __halves2bfloat162(__float2bfloat16_rn(r_g[r]),
                                 __float2bfloat16_rn(r_h[r]));
        // the row's pattern in each column: in the uint4 of k-step pair
        // ks / 2 and lane t = (r % 8) / 2, the u16 of (ks odd, row >= 8 in
        // its k-step, odd row)
        const int rr = r & 15;
        const int ks = r >> 4;
        const int slot = ((ks >> 1) * 4 + ((rr & 7) >> 1)) * 8
                         + (ks & 1) * 4 + (rr >> 3) * 2 + (rr & 1);
        const unsigned char* cols =
            r_bins + r * slab_pitch
            + (listed ? r_shift[r]
                      : bins_bulk ? col_bytes : (lead + r * ld_mod) & 15);
        for (int c = 0; c < nf; ++c) {
          unsigned short p = kNoBin;
          if (in) {
            const unsigned b = static_cast<unsigned>(static_cast<int>(
                *reinterpret_cast<const BinT*>(cols + c * kBinBytes)));
            if (b < static_cast<unsigned>(num_bins))
              p = static_cast<unsigned short>(0x3F80u + b);
          }
          pat[c * R + slot] = p;
        }
      }
      fence_async_smem();   // B is read by wgmma, in the async proxy
      // the producer's threads only: B is built and the raw stage read
      asm volatile("bar.sync 1, 128;\n" ::: "memory");
      if (pt == 0) mbar_arrive(b_full + 8 * bs);
      if (i + kK3RawStages < n_stages) issue(i + kK3RawStages, rw);
    }
  } else if (warp < 4 * live_wg) {
    // ---- consumers: U units a warpgroup ----
    const int wl = warp & 3;   // A rows 16 wl .. 16 wl + 15 of each slice
    const int g = lane >> 2;
    const int t = lane & 3;
    const int unit0 = static_cast<int>(u0) + (warp >> 2) * U;
    // this thread's bins 16 wl + g and + 8 of each unit, as patterns
    unsigned m0[U], m1[U];
    int pcol[U];      // the unit's pattern column in a stage, lane t's uint4
#pragma unroll
    for (int k = 0; k < U; ++k) {
      // a unit past the last computes the first one's slice, unwritten
      const int u = unit0 + k < units ? unit0 + k : unit0;
      m0[k] = 0x10001u * (0x3F80u + (u % slices) * kSlice + 16 * wl + g);
      m1[k] = m0[k] + 0x80008u;
      pcol[k] = (u / slices - feat_lo) * R * 2 + 16 * t;
    }
    float acc[U][N / 2];
#pragma unroll
    for (int k = 0; k < U; ++k)
#pragma unroll
      for (int e = 0; e < N / 2; ++e) acc[k][e] = 0.f;
    for (int i = 0; i < n_stages; ++i) {
      const int bs = i % kK3BStages;
      const long long t0 = r_begin + static_cast<long long>(i) * R;
      const int tn = static_cast<int>(min(static_cast<long long>(R),
                                          r_end - t0));
      mbar_wait(b_full + 8 * bs, (i / kK3BStages) & 1);
      // lane t's patterns of k-steps 2j and 2j + 1: one uint4 a pair
      const unsigned char* pst = k3_smem + lay.off_pat + bs * lay.pat_stage;
      const unsigned b0 = sbase + bs * lay.b_stage;
      for (int j = 0; j < (tn + 31) >> 5; ++j) {
        unsigned lo[U], hi[U], lo2[U], hi2[U];
#pragma unroll
        for (int k = 0; k < U; ++k) {
          const uint4 p =
              *reinterpret_cast<const uint4*>(pst + pcol[k] + 64 * j);
          lo[k] = p.x;
          hi[k] = p.y;
          lo2[k] = p.z;
          hi2[k] = p.w;
        }
        k3_step<N, U>(acc, lo, hi, m0, m1, b0 + 64 * N * j);
        if (j == 0 && i > 0) {
          // one wgmma group in flight, of this stage: the last stage's
          // wgmmas have retired
          if (lane == 0) mbar_arrive(b_empty + 8 * ((i - 1) % kK3BStages));
          __syncwarp();
        }
        k3_step<N, U>(acc, lo2, hi2, m0, m1, b0 + 64 * N * j + 32 * N);
      }
    }
    wgmma_wait<0>();
    if (n_stages > 0 && lane == 0)
      mbar_arrive(b_empty + 8 * ((n_stages - 1) % kK3BStages));

    const long long row_len = static_cast<long long>(num_feature) * num_bins;
#pragma unroll
    for (int k = 0; k < U; ++k) {
      const int u = unit0 + k;
      if (u >= units) continue;
      const int base = (u % slices) * kSlice;
      float* out = partial + chunk * 2 * num_nodes * row_len
                   + static_cast<long long>(u / slices) * num_bins;
#pragma unroll
      for (int e = 0; e < N / 2; ++e) {
        const int nd = n0 + 4 * (e >> 2) + t;
        const int bin = base + 16 * wl + g + 8 * ((e >> 1) & 1);
        if (nd < num_nodes && bin < num_bins)
          out[(static_cast<long long>(e & 1) * num_nodes + nd) * row_len
              + bin] = acc[k][e];
      }
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

// wgmma's N for a launch: twice the nodes, as a power of two in [8, 256]
int k3_cols(int num_nodes) {
  int cols = 8;
  while (cols < 2 * num_nodes && cols < kK3MaxCols) cols *= 2;
  return cols;
}

template <typename BinT, int N>
cudaError_t launch_k3(const void* bins, const void* node, const void* grad,
                      const void* hess, const int* rows, const int* offsets,
                      long long num_rows, int num_feature, int ld_bins,
                      int f_offset, int num_nodes, int num_bins,
                      long long rows_per_chunk, int n_chunks, float* partial,
                      cudaStream_t stream) {
  using S = K3Shape<N>;
  const int slices = (num_bins + kSlice - 1) / kSlice;
  const long long units = static_cast<long long>(num_feature) * slices;
  const int per_cta = static_cast<int>(
      units < S::kPerCta ? units : S::kPerCta);
  const long long groups = (units + S::kPerCta - 1) / S::kPerCta;
  // `per_cta` consecutive units starting anywhere in a feature touch at
  // most this many features
  int span = (per_cta + slices - 2) / slices + 1;
  if (span > num_feature) span = num_feature;
  const long long ld_s = static_cast<long long>(ld_bins) * sizeof(BinT);
  // the listed mode reads rows through the list: granules
  const int bulk = rows == nullptr
                   && (reinterpret_cast<uintptr_t>(bins) & 15) == 0
                   && S::kRows * ld_s <= kK3BulkSlab;
  // granules: a row's columns start anywhere in a 16-byte granule
  const int slab_pitch =
      bulk ? static_cast<int>(ld_s)
           : 16 * ((15 + span * static_cast<int>(sizeof(BinT)) + 15) / 16);
  const K3Layout lay =
      k3_layout(N, S::kRows, span, slab_pitch, rows != nullptr);
  if (lay.smem > kMaxSmem) return cudaErrorInvalidValue;
  auto kernel = rows != nullptr ? grad_hist_fused_kernel<BinT, N, true>
                                 : grad_hist_fused_kernel<BinT, N, false>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, lay.smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(groups), n_chunks,
                  (num_nodes + N / 2 - 1) / (N / 2));
  kernel<<<grid, S::kThreads, lay.smem, stream>>>(
      static_cast<const BinT*>(bins), static_cast<const int*>(node),
      static_cast<const float*>(grad), static_cast<const float*>(hess),
      rows, offsets, num_rows, num_feature, ld_bins, f_offset, num_nodes,
      num_bins, rows_per_chunk, slices, span, bulk, slab_pitch, partial);
  return cudaGetLastError();
}

template <typename BinT>
cudaError_t launch_grad_hist_fused(const void* bins, const void* node,
                                   const void* grad, const void* hess,
                                   const int* rows, const int* offsets,
                                   long long num_rows, int num_feature,
                                   int ld_bins, int f_offset,
                                   int num_nodes, int num_bins,
                                   long long rows_per_chunk, int n_chunks,
                                   float* partial, float* out,
                                   cudaStream_t stream) {
  auto launch = launch_k3<BinT, kK3MaxCols>;
  switch (k3_cols(num_nodes)) {
    case 8: launch = launch_k3<BinT, 8>; break;
    case 16: launch = launch_k3<BinT, 16>; break;
    case 32: launch = launch_k3<BinT, 32>; break;
    case 64: launch = launch_k3<BinT, 64>; break;
    default: break;
  }
  const cudaError_t err = launch(bins, node, grad, hess, rows, offsets,
                                 num_rows, num_feature, ld_bins, f_offset,
                                 num_nodes, num_bins, rows_per_chunk,
                                 n_chunks, partial, stream);
  if (err != cudaSuccess) return err;
  return sum_chunks(partial,
                    2LL * num_nodes * num_feature * num_bins, n_chunks, out,
                    stream);
}

// K3's listed mode groups a level's rows by built node first: a stable
// counting partition of the node ids [0, num_nodes) (an id outside it is a
// row of no built node and is dropped), in three launches and with no read
// by the host.  A warp owns the rows [p * rows_per_part, +rows_per_part)
// (part p, of `parts`):
//   1. partition_count_kernel: each warp counts its ids, counts[n * parts +
//      p];
//   2. partition_scan_kernel: one block scans counts in place, exclusive, in
//      (id, part) order, so counts[n * parts + p] is where part p's rows of
//      id n start in the list, and copies offsets[n] = counts[n * parts]
//      (counts[num_nodes * parts], a 0 before the scan, becomes the listed
//      total);
//   3. partition_scatter_kernel: each warp walks its rows in order, 32 at a
//      time, with a cursor per id from the scan: __match_any_sync gives a
//      row the lanes of its id, its place is the cursor plus the lanes
//      before it, and the first of them moves the cursor on.
// So node n's rows land in row order: the list does not depend on the
// card, the part count or the timing.  A warp's cursors sit in shared
// memory up to kPartSmemNodes ids, else in counts itself (a part's column
// is its warp's alone).  Cost on 10M rows (PERF.md): each row's id is read
// twice and each listed row's index written once, 4-8 B a row.
constexpr int kPartSmemNodes = 12288;   // 48 KB of int cursors a warp
constexpr int kPartStep = 8;            // rows a lane loads at once

template <bool kSmem>
__global__ void __launch_bounds__(32)
partition_count_kernel(const int* __restrict__ node, long long num_rows,
                       int num_nodes, long long rows_per_part, int parts,
                       int* __restrict__ counts) {
  extern __shared__ int part_cur[];
  const int p = blockIdx.x;
  const int lane = threadIdx.x;
  const long long r0 = static_cast<long long>(p) * rows_per_part;
  const long long r1 = min(num_rows, r0 + rows_per_part);
  for (int k = lane; k < num_nodes; k += 32) {
    if (kSmem) part_cur[k] = 0;
    else counts[static_cast<long long>(k) * parts + p] = 0;
  }
  if (p == 0 && lane == 0)
    counts[static_cast<long long>(num_nodes) * parts] = 0;
  __syncwarp();
  for (long long base = r0; base < r1; base += 32 * kPartStep) {
    int id[kPartStep];
#pragma unroll
    for (int j = 0; j < kPartStep; ++j) {
      const long long r = base + 32 * j + lane;
      id[j] = r < r1 ? node[r] : -1;
    }
#pragma unroll
    for (int j = 0; j < kPartStep; ++j) {
      if (static_cast<unsigned>(id[j]) < static_cast<unsigned>(num_nodes)) {
        if (kSmem) atomicAdd(&part_cur[id[j]], 1);
        else atomicAdd(&counts[static_cast<long long>(id[j]) * parts + p], 1);
      }
    }
  }
  if (kSmem) {
    __syncwarp();
    for (int k = lane; k < num_nodes; k += 32)
      counts[static_cast<long long>(k) * parts + p] = part_cur[k];
  }
}

// one block of 1024 threads: thread t scans a contiguous segment of counts
// after a block scan of the segments' sums
__global__ void __launch_bounds__(1024)
partition_scan_kernel(int* __restrict__ counts, long long n, int num_nodes,
                      int parts, int* __restrict__ offsets) {
  __shared__ int warp_sum[32];
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const long long seg = (n + 1023) / 1024;
  const long long beg = min(n, t * seg);
  const long long end = min(n, beg + seg);
  int sum = 0;
  for (long long i = beg; i < end; ++i) sum += counts[i];
  int x = sum;   // inclusive scan over the warp
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xFFFFFFFFu, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) warp_sum[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = warp_sum[lane];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xFFFFFFFFu, w, d);
      if (lane >= d) w += y;
    }
    warp_sum[lane] = w;
  }
  __syncthreads();
  int run = x - sum + (warp > 0 ? warp_sum[warp - 1] : 0);
  for (long long i = beg; i < end; ++i) {
    const int c = counts[i];
    counts[i] = run;
    run += c;
  }
  __syncthreads();   // the block's writes of counts are visible to it
  for (int k = t; k <= num_nodes; k += 1024)
    offsets[k] = counts[static_cast<long long>(k) * parts];
}

template <bool kSmem>
__global__ void __launch_bounds__(32)
partition_scatter_kernel(const int* __restrict__ node, long long num_rows,
                         int num_nodes, long long rows_per_part, int parts,
                         int* starts, int* __restrict__ rows_out) {
  extern __shared__ int part_cur[];
  const int p = blockIdx.x;
  const int lane = threadIdx.x;
  const unsigned before = (1u << lane) - 1;   // the lanes below this one
  const long long r0 = static_cast<long long>(p) * rows_per_part;
  const long long r1 = min(num_rows, r0 + rows_per_part);
  if (kSmem) {
    for (int k = lane; k < num_nodes; k += 32)
      part_cur[k] = starts[static_cast<long long>(k) * parts + p];
    __syncwarp();
  }
  for (long long base = r0; base < r1; base += 32 * kPartStep) {
    int id[kPartStep];
#pragma unroll
    for (int j = 0; j < kPartStep; ++j) {
      const long long r = base + 32 * j + lane;
      id[j] = r < r1 ? node[r] : -1;
    }
#pragma unroll
    for (int j = 0; j < kPartStep; ++j) {
      const bool in =
          static_cast<unsigned>(id[j]) < static_cast<unsigned>(num_nodes);
      const int key = in ? id[j] : 0;
      const unsigned peers = __match_any_sync(0xFFFFFFFFu, in ? key : -1);
      volatile int* cur =
          kSmem ? part_cur + key
                : starts + static_cast<long long>(key) * parts + p;
      const int at = in ? *cur : 0;
      __syncwarp();   // every lane has read its cursor before one moves
      if (in) {
        const int rank = __popc(peers & before);
        rows_out[at + rank] = static_cast<int>(base + 32 * j + lane);
        if (rank == 0) *cur = at + __popc(peers);
      }
      __syncwarp();
    }
  }
}

cudaError_t row_partition(const int* node, long long num_rows, int num_nodes,
                          int parts, long long rows_per_part, int* rows_out,
                          int* counts, int* offsets, cudaStream_t stream) {
  const bool smem = num_nodes <= kPartSmemNodes;
  const int bytes = smem ? num_nodes * 4 : 0;   // within the default 48 KB
  if (smem)
    partition_count_kernel<true><<<parts, 32, bytes, stream>>>(
        node, num_rows, num_nodes, rows_per_part, parts, counts);
  else
    partition_count_kernel<false><<<parts, 32, 0, stream>>>(
        node, num_rows, num_nodes, rows_per_part, parts, counts);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  partition_scan_kernel<<<1, 1024, 0, stream>>>(
      counts, static_cast<long long>(num_nodes) * parts + 1, num_nodes,
      parts, offsets);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (smem)
    partition_scatter_kernel<true><<<parts, 32, bytes, stream>>>(
        node, num_rows, num_nodes, rows_per_part, parts, counts, rows_out);
  else
    partition_scatter_kernel<false><<<parts, 32, 0, stream>>>(
        node, num_rows, num_nodes, rows_per_part, parts, counts, rows_out);
  return cudaGetLastError();
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
// F = num_feature.  rows and offsets are null, or the listed mode's row list
// [num_rows] and offsets [num_nodes + 1] int32 from dmlc_row_partition on
// the same node ids.  Returns the CUDA error of the launches (0 on success).
int dmlc_grad_hist_fused(const void* bins, int bins_u8, const void* node,
                         const void* grad, const void* hess, const void* rows,
                         const void* offsets, long long num_rows,
                         int num_feature, int ld_bins, int f_offset,
                         int num_nodes, int num_bins,
                         long long rows_per_chunk, int n_chunks,
                         void* partial, void* out, void* stream) {
  if (bad_shape(num_rows, num_feature, ld_bins, f_offset, num_nodes,
                num_bins, kK3MaxCols / 2, rows_per_chunk, n_chunks)
      || n_chunks > 65535 || num_nodes >= 65535
      || (rows == nullptr) != (offsets == nullptr)
      || (rows != nullptr && num_rows >= (1LL << 31)))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* r = static_cast<const int*>(rows);
  const int* off = static_cast<const int*>(offsets);
  float* p = static_cast<float*>(partial);
  float* o = static_cast<float*>(out);
  return bins_u8
             ? launch_grad_hist_fused<uint8_t>(
                   bins, node, grad, hess, r, off, num_rows, num_feature,
                   ld_bins, f_offset, num_nodes, num_bins, rows_per_chunk,
                   n_chunks, p, o, s)
             : launch_grad_hist_fused<int32_t>(
                   bins, node, grad, hess, r, off, num_rows, num_feature,
                   ld_bins, f_offset, num_nodes, num_bins, rows_per_chunk,
                   n_chunks, p, o, s);
}

// The rows of node ids [0, num_nodes) grouped by id, stable: rows_out
// [num_rows] int32 holds node n's rows in row order at positions
// [offsets[n], offsets[n + 1]) of offsets [num_nodes + 1] int32; positions
// from offsets[num_nodes] on are left as they were.  counts [num_nodes *
// parts + 1] int32 is scratch.  The row ranges of the parts warps are
// [p * rows_per_part, +rows_per_part); parts * rows_per_part >= num_rows.
// Returns the CUDA error of the launches (0 on success).
int dmlc_row_partition(const void* node, long long num_rows, int num_nodes,
                       int parts, long long rows_per_part, void* rows_out,
                       void* counts, void* offsets, void* stream) {
  if (num_rows <= 0 || num_rows >= (1LL << 31) || num_nodes <= 0
      || num_nodes >= 65535 || parts <= 0 || rows_per_part <= 0
      || static_cast<long long>(parts) * rows_per_part < num_rows)
    return cudaErrorInvalidValue;
  return row_partition(static_cast<const int*>(node), num_rows, num_nodes,
                       parts, rows_per_part, static_cast<int*>(rows_out),
                       static_cast<int*>(counts), static_cast<int*>(offsets),
                       static_cast<cudaStream_t>(stream));
}

}  // extern "C"
