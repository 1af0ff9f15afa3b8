// Traversal kernels of a pushed-down ensemble over raw uint8 binned rows:
// f32 margins [R, C] = base + lr * the sum of the selected leaf values, from
// f32 tables (K3) and from the quantized (TreeLUT) int8 / int4 tables (K4,
// K5). One template walks all three; the leaf kind is a template argument.
//
// ddt_traverse_f32 replaces ddt_tpu/ops/predict_pallas.py::_traverse_kernel
// (K3, the f32 tier: int32 thresholds, f32 leaves). ddt_lut_int8 replaces
// ddt_tpu/ops/predict_lut.py::_lut_kernel (K4, the int8 tier: int8
// thresholds, fp16 leaves or int8 leaves with a per-tree f32 scale).
// ddt_lut_int4 replaces ::_lut4_kernel (K5, the int4 tier: leaves two
// nibbles per byte with a per-tree scale; thresholds nibble-packed when
// every real one is <= 14, else the int8 form). The TPU kernels contract a
// feature one-hot on the MXU, compare in bf16 and k-select with predicated
// lane slices. On Hopper a thread reads a byte by address, so these walk
// the trees directly, D dependent steps node = 2 node + 1 + go per tree.
//
// Tables. The reference's operands (K3: the CompiledEnsemble arrays,
// ops/predict_cuda.pack_tables; K4/K5: the node-major operands of
// ops/predict_lut.lut_device_operands and PackedTables.ops,
// ops/predict_lut_cuda.pack_records) are repacked once per model into one
// tree-major record a tree, 16-byte aligned (rec_words 32-bit words):
//   words [0, n_int)  one word per internal node: bits 0-8 the threshold
//                     t stored as t + 1, with t clamped to [-1, 256] (K3's
//                     int32 thresholds; K4's int8 recentred, thr + 128 in
//                     [0, 255]; K5's nibble, 15 decoded to 256), bit 9
//                     default_left, bit 10 categorical (gated on feature
//                     >= 0), bits 16-31 the feature as int16 (-1 on a
//                     pushed-down node);
//   word n_int        the tree's class; word n_int + 1 its f32 scale (1.0
//                     where the leaves need none);
//   then the leaves   f32 bits, fp16 bits, int8, or int4 (leaf k in nibble
//                     k & 1 of byte k >> 1, two's complement), zero padded.
// A bin is in [0, 255], so every threshold above 256 routes as 256 (> is
// never true, != always) and every one below -1 as -1 (> always true, !=
// always): the clamp changes no route.
// Trailing trees whose leaves are all zero are not packed: each would add
// +0.0 to a class sum that starts at +0.0 and is never -0.0 under
// round-to-nearest, so leaving them out changes no bit. A level of the
// descent is one shared load of the node word plus one of the row's byte;
// a warp's lanes on one tree read words of one level, which lie in
// distinct banks (a node-major staging puts every node of a tree in one
// bank).
//
// Routing, exactly as the plain versions: a pushed-down node reads bin 0
// without touching the row; go = bin > t; a categorical node goes right
// iff bin != t; a row in the reserved missing bin (mbv, -1 when the model
// has none) goes right iff the node's default_left is 0. A model with
// neither a missing bin nor a categorical node (route = 0, the repo's
// main-path models) runs a step compiled without those two tests: half
// the time of the full step at 1M rows on an H100, the level's chain of
// dependent instructions being what the descent waits on.
//
// Two mappings of the work (the wrapper's plan picks one from the row and
// tree counts and the card's SM and shared-memory sizes):
//   rows   (large batches) two rows a thread (one where 512 rows do not
//          fit beside a tree), every tree in series with the class sums in
//          registers; the two descents are independent chains of
//          dependent loads, which the scheduler interleaves;
//   pairs  (small batches) `rows` rows a block, threads over (row, tree)
//          pairs; each leaf value lands in shared memory, then one thread
//          a (row, class) adds them in tree order. A batch of 1-256 rows
//          is then spread over many blocks and its descents run in
//          parallel, where one block would walk every tree in series.
// Both keep the plain versions' order: per chunk of tree_chunk trees a
// class sum in tree order, acc += chunk sum, then base + lr * acc, each
// product and sum written with __fmul_rn / __fadd_rn so that nvcc cannot
// contract it into an FMA. A row's score does not depend on its batch or
// on the mapping: K3 equals its plain version bit for bit on any model,
// K4/K5 theirs, and exact-grid models match the host oracle too.
//
// Bound on this card: operations. At 1M rows x 28 features the rows are
// 28 MB in and 4 MB out (~9.6 us at 3.35 TB/s) and the tables a few tens
// of KB, but 100 depth-6 trees need ~600M integer compares, ~36 us at the
// INT32 rate. Each block stages its rows (transposed, one byte a row
// and feature) and the records of a pass of trees (one TMA bulk copy of a
// contiguous range, completed on an mbarrier) in shared memory; what
// remains is the descent's chain of D dependent shared loads per tree and
// row, which resident warps and the rows mapping's second row hide. A
// pass holds every tree at the shapes served here (100 depth-6 trees are
// 31-53 KB of records); larger ensembles stage pass by pass.

#include <cstdint>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxDevices = 64;
enum Leaf { kF16 = 0, kI8 = 1, kI4 = 2, kF32 = 3 };

struct Args {
  const uint8_t* x;
  const uint4* rec;
  float* out;
  long long n_rows;
  int n_feat, n_trees, depth, tree_chunk, rec_words, n_classes, mbv;
  int route;  // 1: the model has a missing bin or categorical nodes
  int pairs;  // 1: the pairs mapping; 0: the rows mapping
  int rows;   // rows a block (rows mapping: kThreads or 2 kThreads)
  int sub;   // trees staged a pass
  float lr, base;
};

// Rows [0, rows) of x (F bytes each) into s[f * stride + r].
__device__ __forceinline__ void stage_rows(uint8_t* __restrict__ s,
                                           const uint8_t* __restrict__ x,
                                           int rows, int n_feat,
                                           int stride) {
  for (int i = threadIdx.x; i < rows * n_feat; i += kThreads) {
    const int r = i / n_feat;
    const int f = i - r * n_feat;
    s[f * stride + r] = x[i];
  }
}

// The block's mbarrier for the record copies: one arrival (thread 0's,
// with the byte count) completes a phase.
__device__ __forceinline__ void bar_init(uint64_t* bar) {
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                     (unsigned)__cvta_generic_to_shared(bar))
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
}

// Records of trees [t0, t0 + n) into shared memory: one contiguous range,
// copied by one TMA bulk copy (cp.async.bulk) that thread 0 issues; every
// thread waits on the mbarrier's phase `phase`, which then flips. The
// caller has synchronised the block since the last readers of `s`.
__device__ __forceinline__ void stage_trees(uint32_t* s, const uint4* g,
                                            int t0, int n, int rec_words,
                                            uint64_t* bar, int& phase) {
  const unsigned sb = (unsigned)__cvta_generic_to_shared(bar);
  if (threadIdx.x == 0) {
    const unsigned bytes = (unsigned)(n * rec_words * 4);
    const unsigned dst = (unsigned)__cvta_generic_to_shared(s);
    const uint4* src = g + (long long)t0 * (rec_words / 4);
    // Order the generic-proxy reads of the last pass before the copy.
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(sb),
        "r"(bytes)
        : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n" ::"r"(dst),
        "l"(src), "r"(bytes), "r"(sb)
        : "memory");
  }
  asm volatile(
      "{\n.reg .pred p;\nWAIT%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT%=;\n}\n" ::"r"(sb),
      "r"(phase)
      : "memory");
  phase ^= 1;
}

// One level: node's word w against the row whose byte of feature f is
// xr[f * stride]; returns the child, 2 node + 1 + go. ROUTE = false
// compiles the model without a missing bin or categorical node: every
// node is then bin > t, and a pushed-down node (threshold 256) goes left
// whatever byte it reads, so it reads feature 0's.
template <bool ROUTE>
__device__ __forceinline__ int step(uint32_t w, int node, const uint8_t* xr,
                                    int stride, int mbv) {
  const int f = (int)w >> 16;
  const int t = (int)(w & 0x1FFu) - 1;
  if (!ROUTE) return 2 * node + ((int)xr[max(f, 0) * stride] > t ? 2 : 1);
  const int v = f >= 0 ? (int)xr[f * stride] : 0;
  bool go = v > t;
  if (w & 0x400u) go = v != t;
  if (v == mbv) go = !(w & 0x200u);
  return 2 * node + (go ? 2 : 1);
}

// Bottom-level index k of the row whose byte of feature f is xr[f * stride].
template <bool ROUTE>
__device__ __forceinline__ int descend(const uint32_t* tr,
                                       const uint8_t* xr, int stride,
                                       int depth, int mbv) {
  int node = 0;
#pragma unroll
  for (int d = 0; d < depth; ++d)
    node = step<ROUTE>(tr[node], node, xr, stride, mbv);
  return node - ((1 << depth) - 1);
}

template <int LEAF>
__device__ __forceinline__ float leaf_value(const uint32_t* tr, int n_int,
                                            int k) {
  if (LEAF == kF32) return __uint_as_float(tr[n_int + 2 + k]);
  const uint8_t* lb = reinterpret_cast<const uint8_t*>(tr + n_int + 2);
  if (LEAF == kF16)
    return __half2float(
        __ushort_as_half(reinterpret_cast<const uint16_t*>(lb)[k]));
  const float scale = __uint_as_float(tr[n_int + 1]);
  if (LEAF == kI8) return __fmul_rn((float)(int8_t)lb[k], scale);
  const int b = (lb[k >> 1] >> ((k & 1) * 4)) & 15;
  return __fmul_rn((float)(b >= 8 ? b - 16 : b), scale);
}

// H rows a thread, walked side by side (independent chains of dependent
// loads, which the scheduler interleaves); H * kThreads rows a block. D > 0
// fixes the depth at compile time (the level loop unrolls), 0 reads it.
template <int CM, int LEAF, int H, int D, bool ROUTE>
__global__ void __launch_bounds__(kThreads) lut_rows(const Args a) {
  constexpr int kRowBlock = H * kThreads;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(8) uint64_t bar;
  const int depth = D > 0 ? D : a.depth;
  const int n_int = (1 << depth) - 1;
  const int rw = a.rec_words, tc = a.tree_chunk;
  uint32_t* s_rec = reinterpret_cast<uint32_t*>(smem);
  uint8_t* s_x = smem + (size_t)a.sub * rw * 4;

  const int tid = threadIdx.x;
  const long long r0 = (long long)blockIdx.x * kRowBlock;
  const long long left = a.n_rows - r0;
  const int rows = (int)(left < kRowBlock ? left : kRowBlock);
  stage_rows(s_x, a.x + r0 * a.n_feat, rows, a.n_feat, kRowBlock);
  bar_init(&bar);
  int phase = 0;

  float acc[H][CM];
  float cs[H][CM];
#pragma unroll
  for (int h = 0; h < H; ++h)
#pragma unroll
    for (int c = 0; c < CM; ++c) acc[h][c] = cs[h][c] = 0.f;
  int next = tc;  // first tree of the next chunk
  for (int s0 = 0; s0 < a.n_trees; s0 += a.sub) {
    const int n = min(a.sub, a.n_trees - s0);
    __syncthreads();  // the previous pass's readers are done
    stage_trees(s_rec, a.rec, s0, n, rw, &bar, phase);
    if (tid >= rows) continue;
    for (int tl = 0; tl < n; ++tl) {
      if (s0 + tl == next) {
#pragma unroll
        for (int h = 0; h < H; ++h)
#pragma unroll
          for (int c = 0; c < CM; ++c) {
            acc[h][c] = __fadd_rn(acc[h][c], cs[h][c]);
            cs[h][c] = 0.f;
          }
        next += tc;
      }
      const uint32_t* tr = s_rec + tl * rw;
      // The rows' descents side by side (a row past the block's end walks
      // unwritten bytes of the staging area; its result is dropped).
      int node[H];
#pragma unroll
      for (int h = 0; h < H; ++h) node[h] = 0;
#pragma unroll
      for (int d = 0; d < depth; ++d)
#pragma unroll
        for (int h = 0; h < H; ++h)
          node[h] = step<ROUTE>(tr[node[h]], node[h],
                                s_x + tid + h * kThreads, kRowBlock, a.mbv);
      const int c = CM == 1 ? 0 : (int)tr[n_int];
#pragma unroll
      for (int h = 0; h < H; ++h)
        cs[h][c] = __fadd_rn(cs[h][c],
                             leaf_value<LEAF>(tr, n_int, node[h] - n_int));
    }
  }
#pragma unroll
  for (int h = 0; h < H; ++h) {
    const int r = tid + h * kThreads;
    if (r >= rows) break;
    float* o = a.out + (r0 + r) * a.n_classes;
    for (int c = 0; c < a.n_classes && c < CM; ++c)
      o[c] = __fadd_rn(a.base,
                       __fmul_rn(a.lr, __fadd_rn(acc[h][c], cs[h][c])));
  }
}

// `a.rows` rows a block; threads over (row, tree) pairs, then one thread
// a (row, class) sums the leaf values in tree order (rows * C <= 256).
template <int LEAF, int D, bool ROUTE>
__global__ void __launch_bounds__(kThreads) lut_pairs(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(8) uint64_t bar;
  const int depth = D > 0 ? D : a.depth;
  const int n_int = (1 << depth) - 1;
  const int rw = a.rec_words, tc = a.tree_chunk, nb = a.rows;
  uint32_t* s_rec = reinterpret_cast<uint32_t*>(smem);
  float* s_val = reinterpret_cast<float*>(s_rec + (size_t)a.sub * rw);
  uint8_t* s_x = reinterpret_cast<uint8_t*>(s_val + (size_t)a.sub * nb);

  const int tid = threadIdx.x;
  const long long r0 = (long long)blockIdx.x * nb;
  const long long left = a.n_rows - r0;
  const int rows = (int)(left < nb ? left : nb);
  stage_rows(s_x, a.x + r0 * a.n_feat, rows, a.n_feat, nb);
  bar_init(&bar);
  int phase = 0;

  // This thread's (row, class) of the sum.
  const int my_c = tid / nb;
  const int my_r = tid - my_c * nb;
  const bool owner = my_c < a.n_classes && my_r < rows;
  float acc = 0.f, cs = 0.f;
  int next = tc;
  for (int s0 = 0; s0 < a.n_trees; s0 += a.sub) {
    const int n = min(a.sub, a.n_trees - s0);
    __syncthreads();  // the previous pass's sums are done
    stage_trees(s_rec, a.rec, s0, n, rw, &bar, phase);
    for (int q = tid; q < n * nb; q += kThreads) {
      const int tl = q / nb;
      const int r = q - tl * nb;
      if (r >= rows) continue;
      const uint32_t* tr = s_rec + tl * rw;
      const int k = descend<ROUTE>(tr, s_x + r, nb, depth, a.mbv);
      s_val[q] = leaf_value<LEAF>(tr, n_int, k);
    }
    __syncthreads();
    if (!owner) continue;
#pragma unroll 4
    for (int tl = 0; tl < n; ++tl) {
      if (s0 + tl == next) {
        acc = __fadd_rn(acc, cs);
        cs = 0.f;
        next += tc;
      }
      if (a.n_classes == 1 || (int)s_rec[tl * rw + n_int] == my_c)
        cs = __fadd_rn(cs, s_val[tl * nb + my_r]);
    }
  }
  if (!owner) return;
  a.out[(r0 + my_r) * a.n_classes + my_c] =
      __fadd_rn(a.base, __fmul_rn(a.lr, __fadd_rn(acc, cs)));
}

// Raises the kernel's dynamic shared-memory limit to `bytes` once per
// instantiation, device and size (`done` holds the largest set so far).
template <typename K>
cudaError_t opt_in(K kernel, int bytes, int* done) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (bytes <= done[dev]) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess) done[dev] = bytes;
  return e;
}

template <int CM, int LEAF, int H, int D, bool R>
int launch_rows(const Args& a, int smem_bytes, cudaStream_t stream) {
  static int done[kMaxDevices] = {0};
  cudaError_t e = opt_in(lut_rows<CM, LEAF, H, D, R>, smem_bytes, done);
  if (e != cudaSuccess) return (int)e;
  const long long blocks = (a.n_rows + H * kThreads - 1) / (H * kThreads);
  lut_rows<CM, LEAF, H, D, R>
      <<<(unsigned)blocks, kThreads, smem_bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int LEAF, int D, bool R>
int launch_pairs(const Args& a, int smem_bytes, cudaStream_t stream) {
  static int done[kMaxDevices] = {0};
  cudaError_t e = opt_in(lut_pairs<LEAF, D, R>, smem_bytes, done);
  if (e != cudaSuccess) return (int)e;
  const long long blocks = (a.n_rows + a.rows - 1) / a.rows;
  lut_pairs<LEAF, D, R><<<(unsigned)blocks, kThreads, smem_bytes, stream>>>(
      a);
  return (int)cudaGetLastError();
}

template <int LEAF, int D, bool R>
int launch(const Args& a, int smem_bytes, cudaStream_t stream) {
  if (a.pairs) return launch_pairs<LEAF, D, R>(a, smem_bytes, stream);
  if (a.n_classes == 1) {
    if (a.rows == 2 * kThreads)
      return launch_rows<1, LEAF, 2, D, R>(a, smem_bytes, stream);
    return launch_rows<1, LEAF, 1, D, R>(a, smem_bytes, stream);
  }
  if (a.rows == 2 * kThreads)
    return launch_rows<32, LEAF, 2, D, R>(a, smem_bytes, stream);
  return launch_rows<32, LEAF, 1, D, R>(a, smem_bytes, stream);
}

// The depths of the repo's configurations (6: Higgs, 8: Covertype) are
// compiled with the level loop unrolled; any other depth reads it. Models
// with neither a missing bin nor a categorical node take the plain step.
template <int LEAF, bool R>
int launch_depth(const Args& a, int smem_bytes, cudaStream_t stream) {
  if (a.depth == 6) return launch<LEAF, 6, R>(a, smem_bytes, stream);
  if (a.depth == 8) return launch<LEAF, 8, R>(a, smem_bytes, stream);
  return launch<LEAF, 0, R>(a, smem_bytes, stream);
}

template <int LEAF>
int dispatch(const Args& a, int smem_bytes, cudaStream_t stream) {
  if (a.n_classes < 1 || a.n_classes > 32 || a.rec_words % 4 ||
      a.sub < 1 || a.rows < 1 ||
      (a.pairs && a.rows * a.n_classes > kThreads) ||
      (!a.pairs && a.rows != kThreads && a.rows != 2 * kThreads))
    return (int)cudaErrorInvalidValue;
  if (a.route) return launch_depth<LEAF, true>(a, smem_bytes, stream);
  return launch_depth<LEAF, false>(a, smem_bytes, stream);
}

Args make_args(const void* x, const void* rec, void* out, long long n_rows,
               int n_feat, int n_trees, int depth, int tree_chunk,
               int rec_words, int n_classes, int mbv, int route, int pairs,
               int rows, int sub, float lr, float base) {
  Args a;
  a.x = (const uint8_t*)x;
  a.rec = (const uint4*)rec;
  a.out = (float*)out;
  a.n_rows = n_rows;
  a.n_feat = n_feat;
  a.n_trees = n_trees;
  a.depth = depth;
  a.tree_chunk = tree_chunk;
  a.rec_words = rec_words;
  a.n_classes = n_classes;
  a.mbv = mbv;
  a.route = route;
  a.pairs = pairs;
  a.rows = rows;
  a.sub = sub;
  a.lr = lr;
  a.base = base;
  return a;
}

__global__ void empty_kernel() {}

}  // namespace

extern "C" {

// K3: f32 leaves (raw bits). rec: n_trees records of rec_words words
// (ops/predict_cuda.pack_tables); the other arguments as ddt_lut_int8's.
int ddt_traverse_f32(const void* x, const void* rec, void* out,
                     long long n_rows, int n_feat, int n_trees, int depth,
                     int tree_chunk, int rec_words, int n_classes, int mbv,
                     int route, int pairs, int rows, int sub, float lr,
                     float base, int smem_bytes, void* stream) {
  const Args a = make_args(x, rec, out, n_rows, n_feat, n_trees, depth,
                           tree_chunk, rec_words, n_classes, mbv, route,
                           pairs, rows, sub, lr, base);
  return dispatch<kF32>(a, smem_bytes, (cudaStream_t)stream);
}

// K4. leaf_f16 = 1: fp16 leaves; 0: int8 leaves with a per-tree scale.
// rec: n_trees records of rec_words words (ops/predict_lut_cuda.
// pack_records); pairs = 1 takes the pairs mapping, 0 the rows mapping,
// with `rows` rows a block (the rows mapping takes 256 or 512: one or two
// rows a thread); sub trees are staged a pass; mbv is the missing bin or
// -1; route = 0 declares that mbv is -1 and no node is categorical.
// Launches on `stream`; returns cudaGetLastError() (0 = launched).
// n_classes must be in [1, 32].
int ddt_lut_int8(const void* x, const void* rec, void* out, long long n_rows,
                 int n_feat, int n_trees, int depth, int tree_chunk,
                 int rec_words, int n_classes, int mbv, int route, int pairs,
                 int rows, int sub, int leaf_f16, float lr, float base,
                 int smem_bytes, void* stream) {
  const Args a = make_args(x, rec, out, n_rows, n_feat, n_trees, depth,
                           tree_chunk, rec_words, n_classes, mbv, route,
                           pairs, rows, sub, lr, base);
  cudaStream_t s = (cudaStream_t)stream;
  return leaf_f16 ? dispatch<kF16>(a, smem_bytes, s)
                  : dispatch<kI8>(a, smem_bytes, s);
}

// K5: int4 leaves with a per-tree scale; the thresholds were decoded
// (nibble or int8) into the records.
int ddt_lut_int4(const void* x, const void* rec, void* out, long long n_rows,
                 int n_feat, int n_trees, int depth, int tree_chunk,
                 int rec_words, int n_classes, int mbv, int route, int pairs,
                 int rows, int sub, float lr, float base, int smem_bytes,
                 void* stream) {
  const Args a = make_args(x, rec, out, n_rows, n_feat, n_trees, depth,
                           tree_chunk, rec_words, n_classes, mbv, route,
                           pairs, rows, sub, lr, base);
  return dispatch<kI4>(a, smem_bytes, (cudaStream_t)stream);
}

// An empty kernel on `stream`: the latency floor of one launch, timed by
// chip_smoke.py beside the traversal kernels at serving sizes.
int ddt_lut_empty(void* stream) {
  empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

}  // extern "C"
