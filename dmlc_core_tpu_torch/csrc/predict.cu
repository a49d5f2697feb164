// Tree-ensemble scoring for Hopper (sm_90a), bound to Python with ctypes from
// dmlc_core_tpu_torch/ops/predict_cuda.py and built with hist.cu by
// ops/_build.py (one nvcc call over every csrc/*.cu).
//
// predict_kernel computes GBDT.predict_margin in one launch:
//   out[i, k] = ((base + leaf(0, k, i)) + leaf(1, k, i)) + ... + leaf(T-1, k, i)
// in f32, left to right, where leaf(t, k, i) routes row i down tree (t, k) of
// the level-order ensemble: at each of `depth` levels node = 2*node +
// go_right with go_right = (bin > split_bin) & (split_feat >= 0), and with
// handle_missing go_right &= !((bin == miss_id) & default_left).  That is
// predict_margin_ref (route_tree / predict_tree) bit for bit.
//
// It replaces no Pallas kernel.  The JAX package scores with XLA ops
// (dmlc_core_tpu/models/gbdt.py, _route_tree and _predict_fn: a lax.scan over
// the trees that XLA fuses into a few kernels).  Eager PyTorch gets no such
// fusion: the same loop is ~107 launches a depth-8 tree, each a pass over the
// rows in int64, so scoring was bound by launches and HBM traffic.
//
// Bound.  A 4,194,304-row batch of a 500-tree depth-8 model over 28 uint8
// features is 16.8 G node visits.  Its bytes are small (117 MB of bins read
// once, 17 MB of scores written, 1 MB of trees that stay in L2): the visits
// bound it, 0.25 ms at one compare a clock on every f32 lane (67 T/s).  A
// visit is a dependent chain (read the node, read the row's bin of the
// node's feature, compare), so what binds it on the card is shared memory:
// two loads a visit, one 32-lane wavefront a clock on each of the 132 SMs,
// ~4.8 ms a batch without bank conflicts.  The deep levels' and the leaves'
// loads meet bank conflicts (a warp's 32 rows ask for random nodes of 64 to
// 256), ~22 wavefronts a tree of 32 rows against 17 without.
//
// Design.
//  * One thread walks one row, and a CTA of kRows rows walks every tree.  A
//    thread walks kChains trees at once (independent chains hide the loads'
//    latency) and then adds their leaves to its sum in tree order, so the sum
//    is the plain version's, bitwise (__fadd_rn: nothing fuses or reorders).
//  * pack_trees_kernel first packs the ensemble into records of 2^(d+1)
//    32-bit words, class-major: 2^d - 1 nodes, one unused word, then 2^d leaf
//    values.  A walk keeps the heap index idx (children 2 idx + 1 and
//    2 idx + 2), which ends at 2^d - 1 + leaf, so the leaf is record[idx + 1].
//    A node word holds the feature (bits 0-18; where the bins are staged,
//    the byte offset of its bins there), default_left (bit 19) and the split
//    bin clamped to [-1, 1024] (bits 20-31, signed).  A node that does not
//    split, or splits on a feature outside [0, F), holds feature 0 and split
//    bin 1024, which no clamped bin exceeds: every row goes left (the plain
//    version raises on such a feature).
//  * A bin is compared as a bin word: clamped to [-1, 1024] and shifted to
//    the split bin's place, so bin > split bin is one signed compare of the
//    bin word with the whole node word.  The clamp changes no comparison
//    with a split bin in [-1, 1023] nor with a miss_id in [0, 1023]: every
//    tree a fit grows (num_bins <= 1024), and any tree at all for uint8 bins.
//  * Where the CTA's rows fit beside the trees, the CTA stages their bin
//    words in shared memory transposed to [feature][row]: a warp's 32 bin
//    loads then hit 32 banks whatever features its rows ask for, and a bin's
//    address is the node's feature offset plus the row's.  Else a thread
//    reads its row's bins from global memory.
//  * Tiles of trees go to shared memory by cp.async, double-buffered, the
//    next tile loading while the CTA walks this one.  A warp's 32 rows walk
//    the same tree, so the top levels' node loads are broadcasts.  With both
//    in shared memory a walk holds 32-bit shared addresses (walk_shared):
//    about 8 instructions a visit.  Trees too deep for two records beside
//    the bins are read from global memory.
// The wrapper chooses the plan (bins in shared memory or not, trees per
// tile) from the shapes alone: predict_cuda.predict_plan.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 512;        // rows (threads) a CTA; ROWS in predict_cuda
constexpr int kChains = 4;        // trees a thread walks at once; CHAINS
constexpr int kMaxSmem = 232448;  // dynamic shared memory one block may use
constexpr int kMaxDepth = 14;
constexpr int kFeatBits = 19;     // features a node can name: 2^19
constexpr unsigned kFeatMask = (1u << kFeatBits) - 1;
constexpr unsigned kDefaultLeft = 1u << kFeatBits;
constexpr int kBinShift = 20;
constexpr int kBinLo = -1;
constexpr int kBinHi = 1024;      // also the split bin of a node that does
                                  // not split

__device__ __forceinline__ int clamp_bin(int v) {
  return min(max(v, kBinLo), kBinHi);
}

template <typename BinT>
__device__ __forceinline__ int bin_value(BinT v) {
  if constexpr (sizeof(BinT) == 1) {
    return static_cast<int>(v);  // uint8: inside the clamp already
  } else {
    return clamp_bin(static_cast<int>(v));
  }
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(unsigned dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// One word of the packed ensemble a thread: record k * num_trees + t holds
// tree (t, k) of the [T, K] inputs (K = 1 for a binary ensemble).  A node's
// feature f is stored as f * feat_scale: the byte offset of its bins in
// shared memory (4 * kRows) where the CTA stages them, else f.
__global__ void pack_trees_kernel(const int* __restrict__ split_feat,
                                  const int* __restrict__ split_bin,
                                  const uint8_t* __restrict__ default_left,
                                  const float* __restrict__ leaf_value,
                                  int num_trees, int num_class, int depth,
                                  int num_feature, unsigned feat_scale,
                                  unsigned* __restrict__ packed) {
  const int inner = (1 << depth) - 1;
  const int words = 2 << depth;
  const long long total =
      static_cast<long long>(num_trees) * num_class * words;
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int w = static_cast<int>(i % words);
  const long long rec = i / words;
  const long long tree = (rec % num_trees) * num_class + rec / num_trees;
  unsigned v = 0;
  if (w < inner) {
    const long long at = tree * inner + w;
    const int f = split_feat[at];
    v = f >= 0 && f < num_feature
            ? (static_cast<unsigned>(clamp_bin(split_bin[at])) << kBinShift)
                  | (default_left[at] ? kDefaultLeft : 0u)
                  | static_cast<unsigned>(f) * feat_scale
            : static_cast<unsigned>(kBinHi) << kBinShift;
  } else if (w > inner) {
    v = __float_as_uint(leaf_value[tree * (inner + 1) + (w - inner - 1)]);
  }
  packed[i] = v;
}

// A bin as it is compared: clamped, shifted to the split bin's place in a
// node word, so that bin > split bin is (bin << 20) > (int)node whatever the
// node's lower 20 bits hold.
template <typename BinT>
__device__ __forceinline__ int bin_word(BinT v) {
  return bin_value(v) * (1 << kBinShift);
}

__device__ __forceinline__ unsigned lds(unsigned addr) {
  unsigned v;
  asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}

// N trees whose records lie `bytes` apart from shared address `rec`, walked
// in lockstep for this thread's row, whose bins sit at shared address
// (feature offset) + `row_at`; their leaves are added to acc in tree order.
// A walk holds the node's shared address a = record + 4 idx, so a child is
// 2 a + (4 - record) + 4 right and the leaf a + 4.
template <int N, bool kMissing>
__device__ __forceinline__ float walk_shared(unsigned rec, unsigned bytes,
                                             int depth, unsigned row_at,
                                             int miss_word, float acc) {
  unsigned a[N], to_child[N];
#pragma unroll
  for (int c = 0; c < N; ++c) {
    a[c] = rec + c * bytes;
    to_child[c] = 4u - a[c];
  }
  for (int level = 0; level < depth; ++level) {
#pragma unroll
    for (int c = 0; c < N; ++c) {
      const unsigned node = lds(a[c]);
      const int bin = static_cast<int>(lds((node & kFeatMask) + row_at));
      bool right = bin > static_cast<int>(node);
      if (kMissing)
        right = right && !((node & kDefaultLeft) && bin == miss_word);
      a[c] = 2u * a[c] + to_child[c] + (right ? 4u : 0u);
    }
  }
#pragma unroll
  for (int c = 0; c < N; ++c)
    acc = __fadd_rn(acc, __uint_as_float(lds(a[c] + 4)));
  return acc;
}

// The same walk where the records or the bins are read from global memory:
// records `words` apart from `rec`, the bins of this thread's row staged at
// shared `sbins` (byte offsets) or at `row_bins`.
template <int N, typename BinT, bool kBinsSmem, bool kMissing>
__device__ __forceinline__ float walk(const unsigned* rec, int words,
                                      int depth, const unsigned char* sbins,
                                      const BinT* row_bins, int miss_word,
                                      float acc) {
  int idx[N];
#pragma unroll
  for (int c = 0; c < N; ++c) idx[c] = 0;
  for (int level = 0; level < depth; ++level) {
#pragma unroll
    for (int c = 0; c < N; ++c) {
      const unsigned node = rec[c * words + idx[c]];
      const unsigned f = node & kFeatMask;
      const int bin = kBinsSmem
                          ? *reinterpret_cast<const int*>(sbins + f)
                          : bin_word(row_bins[f]);
      bool right = bin > static_cast<int>(node);
      if (kMissing)
        right = right && !((node & kDefaultLeft) && bin == miss_word);
      idx[c] = 2 * idx[c] + 1 + static_cast<int>(right);
    }
  }
#pragma unroll
  for (int c = 0; c < N; ++c)
    acc = __fadd_rn(acc, __uint_as_float(rec[c * words + idx[c] + 1]));
  return acc;
}

// Grid: one CTA per kRows rows.  Shared memory: the bin words [F][kRows]
// when kBinsSmem, then two tiles of trees_per_tile records when kTreesSmem.
// The launch bounds ask for no second block: with at most 56 registers a
// thread two blocks still fit an SM where their shared memory does, and
// ptxas schedules the walk 3-6% faster than under a 64-register cap.
template <typename BinT, bool kBinsSmem, bool kTreesSmem, bool kMissing>
__global__ void __launch_bounds__(kRows, 1)
predict_kernel(const BinT* __restrict__ bins, long long num_rows,
               int num_feature, const unsigned* __restrict__ packed,
               int num_trees, int num_class, int depth, int trees_per_tile,
               int miss_id, float base, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* sbins = reinterpret_cast<int*>(smem);
  unsigned* stree = reinterpret_cast<unsigned*>(
      smem + (kBinsSmem ? 4 * num_feature * kRows : 0));
  const int r = threadIdx.x;
  const long long row = static_cast<long long>(blockIdx.x) * kRows + r;
  const bool live = row < num_rows;
  const BinT* row_bins = bins + (live ? row : 0) * num_feature;
  const int words = 2 << depth;
  const int miss_word = miss_id * (1 << kBinShift);

  if (kBinsSmem && live) {
    // [feature][row] as bin words; each thread its own row: the stores fall
    // in 32 banks, and the warp's loads cover 32 neighbouring rows, so after
    // the first they hit L1
    if (sizeof(BinT) == 1 && num_feature % 4 == 0
        && reinterpret_cast<uintptr_t>(bins) % 4 == 0) {
      const unsigned* four = reinterpret_cast<const unsigned*>(row_bins);
      for (int q = 0; q < num_feature / 4; ++q) {
        const unsigned v = four[q];
#pragma unroll
        for (int b = 0; b < 4; ++b)
          sbins[(4 * q + b) * kRows + r] =
              static_cast<int>((v >> (8 * b)) & 0xFF) << kBinShift;
      }
    } else {
      for (int f = 0; f < num_feature; ++f)
        sbins[f * kRows + r] = bin_word(row_bins[f]);
    }
  }

  const int tile = kTreesSmem ? trees_per_tile : num_trees;
  const int per_class = (num_trees + tile - 1) / tile;
  const int n_tiles = per_class * num_class;
  const int tile_words = tile * words;
  auto first_record = [&](int q, int* k, int* t0) {
    *k = q / per_class;
    *t0 = (q - *k * per_class) * tile;
    return packed + (static_cast<long long>(*k) * num_trees + *t0) * words;
  };
  auto stage = [&](int q) {
    int k, t0;
    const unsigned* src = first_record(q, &k, &t0);
    const int pieces = min(tile, num_trees - t0) * words / 4;
    const unsigned dst = smem_u32(stree + (q & 1) * tile_words);
    for (int p = r; p < pieces; p += kRows) cp_async16(dst + 16 * p, src + 4 * p);
    cp_async_commit();
  };
  if (kTreesSmem) stage(0);

  float acc = base;
  for (int q = 0; q < n_tiles; ++q) {
    int k, t0;
    const unsigned* in_global = first_record(q, &k, &t0);
    const int n = min(tile, num_trees - t0);
    if (kTreesSmem) {
      if (q + 1 < n_tiles) {
        stage(q + 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();  // tile q (and the staged bins) visible to all
    }
    const unsigned* trees =
        kTreesSmem ? stree + (q & 1) * tile_words : in_global;
    if (live) {
      int j = 0;
      if constexpr (kTreesSmem && kBinsSmem) {
        const unsigned rec = smem_u32(trees);
        const unsigned row_at = smem_u32(sbins + r);
        for (; j + kChains <= n; j += kChains)
          acc = walk_shared<kChains, kMissing>(rec + 4 * j * words,
                                               4 * words, depth, row_at,
                                               miss_word, acc);
        for (; j < n; ++j)
          acc = walk_shared<1, kMissing>(rec + 4 * j * words, 4 * words,
                                         depth, row_at, miss_word, acc);
      } else {
        const unsigned char* row_at =
            reinterpret_cast<const unsigned char*>(sbins + r);
        for (; j + kChains <= n; j += kChains)
          acc = walk<kChains, BinT, kBinsSmem, kMissing>(
              trees + j * words, words, depth, row_at, row_bins, miss_word,
              acc);
        for (; j < n; ++j)
          acc = walk<1, BinT, kBinsSmem, kMissing>(
              trees + j * words, words, depth, row_at, row_bins, miss_word,
              acc);
      }
      if (t0 + n == num_trees) out[row * num_class + k] = acc;
    }
    if (t0 + n == num_trees) acc = base;
    if (kTreesSmem) __syncthreads();  // tile q read before q + 2 lands on it
  }
}

struct PredictArgs {
  const void* bins;
  long long num_rows;
  int num_feature;
  const unsigned* packed;
  int num_trees;
  int num_class;
  int depth;
  int trees_per_tile;
  int miss_id;
  float base;
  float* out;
  int smem;
  cudaStream_t stream;
};

template <typename BinT, bool kBinsSmem, bool kTreesSmem, bool kMissing>
cudaError_t launch_predict(const PredictArgs& a) {
  auto kernel = predict_kernel<BinT, kBinsSmem, kTreesSmem, kMissing>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, a.smem);
  if (err != cudaSuccess) return err;
  const long long ctas = (a.num_rows + kRows - 1) / kRows;
  kernel<<<static_cast<unsigned>(ctas), kRows, a.smem, a.stream>>>(
      static_cast<const BinT*>(a.bins), a.num_rows, a.num_feature, a.packed,
      a.num_trees, a.num_class, a.depth, a.trees_per_tile, a.miss_id, a.base,
      a.out);
  return cudaGetLastError();
}

template <typename BinT, bool kBinsSmem, bool kTreesSmem>
cudaError_t pick_missing(const PredictArgs& a) {
  return a.miss_id >= 0
             ? launch_predict<BinT, kBinsSmem, kTreesSmem, true>(a)
             : launch_predict<BinT, kBinsSmem, kTreesSmem, false>(a);
}

template <typename BinT, bool kBinsSmem>
cudaError_t pick_trees(const PredictArgs& a) {
  return a.trees_per_tile > 0 ? pick_missing<BinT, kBinsSmem, true>(a)
                              : pick_missing<BinT, kBinsSmem, false>(a);
}

template <typename BinT>
cudaError_t pick_bins(const PredictArgs& a, bool bins_smem) {
  return bins_smem ? pick_trees<BinT, true>(a) : pick_trees<BinT, false>(a);
}

}  // namespace

extern "C" {

// Rows a CTA walks; the Python wrapper checks it matches its ROWS.
int dmlc_predict_rows() { return kRows; }

// GBDT.predict_margin.  bins [num_rows, num_feature] row-major (uint8 when
// bins_u8, else int32); split_feat, split_bin [T, K, 2^depth - 1] int32,
// default_left of that shape as bytes (0 or 1), leaf_value [T, K, 2^depth]
// f32 (K = num_class, 1 for a binary ensemble); packed [K, T, 2^(depth+1)]
// 32-bit scratch; out [num_rows, K] f32.  bins_smem and trees_per_tile (0:
// trees read from global memory) are predict_plan's.  Returns the CUDA error
// of the launches (0 on success).
int dmlc_predict_margin(const void* bins, int bins_u8, long long num_rows,
                        int num_feature, const void* split_feat,
                        const void* split_bin, const void* default_left,
                        const void* leaf_value, int num_trees, int num_class,
                        int depth, int miss_id, float base, int bins_smem,
                        int trees_per_tile, void* packed, void* out,
                        void* stream) {
  if (num_rows <= 0 || num_feature <= 0
      || num_feature > static_cast<int>(kFeatMask) || num_trees <= 0
      || num_class <= 0 || depth < 1 || depth > kMaxDepth || miss_id < -1
      || miss_id >= kBinHi || trees_per_tile < 0
      || (num_rows + kRows - 1) / kRows > 0x7FFFFFFFLL)
    return cudaErrorInvalidValue;
  const long long words = 2LL << depth;
  const long long smem =
      (bins_smem ? 4LL * num_feature * kRows : 0)
      + 2LL * trees_per_tile * words * 4;
  const long long total = static_cast<long long>(num_trees) * num_class * words;
  if (smem > kMaxSmem || trees_per_tile > num_trees
      || (total + 255) / 256 > 0x7FFFFFFFLL)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned* p = static_cast<unsigned*>(packed);
  pack_trees_kernel<<<static_cast<unsigned>((total + 255) / 256), 256, 0,
                      s>>>(
      static_cast<const int*>(split_feat), static_cast<const int*>(split_bin),
      static_cast<const uint8_t*>(default_left),
      static_cast<const float*>(leaf_value), num_trees, num_class, depth,
      num_feature, bins_smem ? 4u * kRows : 1u, p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const PredictArgs a{bins, num_rows, num_feature, p, num_trees, num_class,
                      depth, trees_per_tile, miss_id, base,
                      static_cast<float*>(out), static_cast<int>(smem), s};
  return bins_u8 ? pick_bins<uint8_t>(a, bins_smem != 0)
                 : pick_bins<int32_t>(a, bins_smem != 0);
}

}  // extern "C"
