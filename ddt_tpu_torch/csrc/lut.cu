// Quantized (TreeLUT) traversal kernels: raw margins of a pushed-down
// ensemble from int8 / int4 tables and raw uint8 binned rows.
//
// ddt_lut_int8 replaces ddt_tpu/ops/predict_lut.py::_lut_kernel (K4, the
// int8 tier: int8 thresholds, fp16 leaves or int8 leaves with a per-tree
// f32 scale). ddt_lut_int4 replaces ::_lut4_kernel (K5, the int4 tier:
// leaves two nibbles per byte with a per-tree scale; thresholds nibble-
// packed when every real one is <= 14, else the int8 form). The TPU
// kernels contract a feature one-hot on the MXU, compare in bf16 and
// k-select with predicated lane slices. On Hopper a thread reads a byte
// by address, so these run K3's design (csrc/traverse.cu): one thread per
// row, the block's rows staged transposed in shared memory, one chunk of
// tables staged in shared memory, D dependent steps k = 2k + go per tree.
//
// Operands are the reference's node-major tuples, unchanged
// (ops/predict_lut.lut_device_operands, PackedTables.ops): each [n_tc,
// width * Tc], element (chunk c, node n, tree t) at c*width*Tc + n*Tc + t.
// cls int32 [Tpad] is the class of each tree (cls_oh.argmax(1), derived
// once per model by the wrapper). Output f32 [R, C] = base + lr * acc.
//
// Decoding, as the plain versions in ops/predict_lut.py do it:
//   int8 threshold   t = (int)thr_i8 + 128, in [0, 255]; a clipped +BIG is
//                    255 and no uint8 bin exceeds it: always left.
//   nibble threshold byte block n holds node n (low) and node n + h_n
//                    (high), h_n = 2^(D-1); nibble 15 decodes to 256.
//   int4 leaf        leaves j and j + h_l share a byte; v >= 8 ? v - 16 : v.
//   leaf value       __half2float of the fp16 bits, or __fmul_rn(q, scale).
// Routing, exactly as K3: a pushed-down node (feature -1) reads bin 0
// without touching the row and goes left; go = bin > t; a categorical node
// goes right iff bin != t; a row in the reserved missing bin (compared
// raw, before any recentring) goes right iff the node's default_left is 0.
// Every product and sum is written with __fmul_rn / __fadd_rn so that nvcc
// cannot contract it into an FMA: per chunk of tree_chunk trees a class
// sum in tree order, acc += chunk sum, then base + lr * acc, the plain
// versions' order, so exact-grid models match them bit for bit.
//
// Bound on this card: operations, as for K3. At 1M rows x 28 features
// the rows are 28 MB in and 4 MB out (~9.6 us at 3.35 TB/s) and the
// tables a few hundred KB, but 100 depth-6 trees need ~600M integer
// compares, ~36 us at the INT32 rate. The quantized tables shrink shared
// memory per depth-6 tree (577 B for the int8 tier with fp16 leaves,
// 450-481 B for int4, against 827 B for K3's f32 tables), which lets more
// trees stage per pass; the descent's ~D
// dependent shared-memory loads per tree and row are what this simple
// design pays, as K3 does.

#include <cstdint>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
enum Leaf { kF16 = 0, kI8 = 1, kI4 = 2 };

struct Args {
  const uint8_t* x;
  const int* feat;
  const uint8_t* thr;
  const void* leaf;
  const float* scale;
  const int* cls;
  const uint8_t* dl;
  const uint8_t* cat;
  float* out;
  long long n_rows;
  int n_feat, n_trees, depth, tree_chunk, sub, n_classes;
  int missing_bin_value, use_missing, use_cat, thr_packed;
  float lr, base;
};

// Trees [o, o + sub) of node-major chunk `cb` (w entries per tree) into
// s[n * sub + tl].
template <typename T>
__device__ void stage(T* __restrict__ s, const T* __restrict__ g,
                      long long cb, int w, int tc, int o, int sub) {
  const T* src = g + cb * (long long)w * tc + o;
  for (int i = threadIdx.x; i < w * sub; i += kThreads) {
    const int n = i / sub;
    const int tl = i - n * sub;
    s[i] = src[(long long)n * tc + tl];
  }
}

template <int CM, int LEAF>
__global__ void __launch_bounds__(kThreads) lut_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int depth = a.depth, sub = a.sub, tc = a.tree_chunk;
  const int n_int = (1 << depth) - 1;
  const int n_leaf = 1 << depth;
  const int h_n = (n_int + 1) / 2;
  const int h_l = (n_leaf + 1) / 2;
  const int leaf_n = LEAF == kI4 ? h_l : n_leaf;       // entries per tree
  const int leaf_w = LEAF == kF16 ? 2 * n_leaf : leaf_n;  // bytes per tree
  const int thr_w = a.thr_packed ? h_n : n_int;
  // Layout: ops/predict_lut_cuda.tree_bytes counts the same regions.
  int* s_feat = reinterpret_cast<int*>(smem);
  float* s_scale = reinterpret_cast<float*>(s_feat + sub * n_int);
  int* s_cls = reinterpret_cast<int*>(s_scale + sub);
  uint8_t* s_leaf = reinterpret_cast<uint8_t*>(s_cls + sub);
  uint16_t* s_leaf16 = reinterpret_cast<uint16_t*>(s_leaf);
  uint8_t* s_thr = s_leaf + sub * leaf_w;
  uint8_t* s_dl = s_thr + sub * thr_w;
  uint8_t* s_cat = s_dl + sub * n_int;
  uint8_t* s_x = s_cat + sub * n_int;

  const int tid = threadIdx.x;
  const int n_feat = a.n_feat;
  const long long rb = (long long)blockIdx.x * kThreads;
  const long long left = a.n_rows - rb;
  const int rows = (int)(left < kThreads ? left : kThreads);
  const bool active = tid < rows;

  // Stage this block's rows, transposed: s_x[f * kThreads + row].
  for (int i = tid; i < rows * n_feat; i += kThreads) {
    const int row = i / n_feat;
    const int f = i - row * n_feat;
    s_x[f * kThreads + row] = a.x[rb * n_feat + i];
  }

  float acc[CM];
  float cs[CM];
#pragma unroll
  for (int c = 0; c < CM; ++c) acc[c] = 0.f;

  for (int c0 = 0; c0 < a.n_trees; c0 += tc) {
    const long long cb = c0 / tc;
#pragma unroll
    for (int c = 0; c < CM; ++c) cs[c] = 0.f;
    for (int o = 0; o < tc; o += sub) {
      __syncthreads();  // the previous stage's readers are done
      stage(s_feat, a.feat, cb, n_int, tc, o, sub);
      stage(s_thr, a.thr, cb, thr_w, tc, o, sub);
      if (LEAF == kF16)
        stage(s_leaf16, static_cast<const uint16_t*>(a.leaf), cb, n_leaf,
              tc, o, sub);
      else
        stage(s_leaf, static_cast<const uint8_t*>(a.leaf), cb, leaf_n, tc,
              o, sub);
      if (a.use_missing) stage(s_dl, a.dl, cb, n_int, tc, o, sub);
      if (a.use_cat) stage(s_cat, a.cat, cb, n_int, tc, o, sub);
      for (int i = tid; i < sub; i += kThreads) {
        s_cls[i] = a.cls[c0 + o + i];
        if (LEAF != kF16) s_scale[i] = a.scale[c0 + o + i];
      }
      __syncthreads();
      if (!active) continue;
      for (int tl = 0; tl < sub; ++tl) {
        int k = 0;
        for (int d = 0; d < depth; ++d) {
          const int node = (1 << d) - 1 + k;
          const int idx = node * sub + tl;
          const int f = s_feat[idx];
          const int v = f >= 0 ? (int)s_x[f * kThreads + tid] : 0;
          int t;
          if (a.thr_packed) {
            const int b = node < h_n ? (s_thr[idx] & 15)
                                     : (s_thr[(node - h_n) * sub + tl] >> 4);
            t = b == 15 ? 256 : b;
          } else {
            t = (int)(int8_t)s_thr[idx] + 128;
          }
          bool go = v > t;
          if (a.use_cat && s_cat[idx]) go = v != t;
          if (a.use_missing && v == a.missing_bin_value) go = !s_dl[idx];
          k = 2 * k + (go ? 1 : 0);
        }
        float val;
        if (LEAF == kF16) {
          val = __half2float(__ushort_as_half(s_leaf16[k * sub + tl]));
        } else if (LEAF == kI8) {
          val = __fmul_rn((float)(int8_t)s_leaf[k * sub + tl], s_scale[tl]);
        } else {
          const int b = k < h_l ? (s_leaf[k * sub + tl] & 15)
                                : (s_leaf[(k - h_l) * sub + tl] >> 4);
          val = __fmul_rn((float)(b >= 8 ? b - 16 : b), s_scale[tl]);
        }
        if (CM == 1) {
          cs[0] = __fadd_rn(cs[0], val);
        } else {
          const int c = s_cls[tl];
          cs[c] = __fadd_rn(cs[c], val);
        }
      }
    }
#pragma unroll
    for (int c = 0; c < CM; ++c) acc[c] = __fadd_rn(acc[c], cs[c]);
  }

  if (!active) return;
  float* o = a.out + (rb + tid) * a.n_classes;
  for (int c = 0; c < a.n_classes && c < CM; ++c)
    o[c] = __fadd_rn(a.base, __fmul_rn(a.lr, acc[c]));
}

template <int CM, int LEAF>
int launch(const Args& a, int smem_bytes, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      lut_kernel<CM, LEAF>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (e != cudaSuccess) return (int)e;
  const long long blocks = (a.n_rows + kThreads - 1) / kThreads;
  lut_kernel<CM, LEAF><<<(unsigned)blocks, kThreads, smem_bytes, stream>>>(
      a);
  return (int)cudaGetLastError();
}

template <int LEAF>
int dispatch(const Args& a, int smem_bytes, cudaStream_t stream) {
  if ((a.use_missing && !a.dl) || (a.use_cat && !a.cat) ||
      (LEAF != kF16 && !a.scale))
    return (int)cudaErrorInvalidValue;
  if (a.n_classes == 1) return launch<1, LEAF>(a, smem_bytes, stream);
  if (a.n_classes > 32) return (int)cudaErrorInvalidValue;
  return launch<32, LEAF>(a, smem_bytes, stream);
}

Args make_args(const void* x, const void* feat, const void* thr,
               const void* leaf, const void* scale, const void* cls,
               const void* dl, const void* cat, void* out, long long n_rows,
               int n_feat, int n_trees, int depth, int tree_chunk, int sub,
               int n_classes, int missing_bin_value, int use_missing,
               int use_cat, int thr_packed, float lr, float base) {
  Args a;
  a.x = (const uint8_t*)x;
  a.feat = (const int*)feat;
  a.thr = (const uint8_t*)thr;
  a.leaf = leaf;
  a.scale = (const float*)scale;
  a.cls = (const int*)cls;
  a.dl = (const uint8_t*)dl;
  a.cat = (const uint8_t*)cat;
  a.out = (float*)out;
  a.n_rows = n_rows;
  a.n_feat = n_feat;
  a.n_trees = n_trees;
  a.depth = depth;
  a.tree_chunk = tree_chunk;
  a.sub = sub;
  a.n_classes = n_classes;
  a.missing_bin_value = missing_bin_value;
  a.use_missing = use_missing;
  a.use_cat = use_cat;
  a.thr_packed = thr_packed;
  a.lr = lr;
  a.base = base;
  return a;
}

}  // namespace

extern "C" {

// K4. leaf_f16 = 1: fp16 leaves (scale unused, may be null); 0: int8
// leaves with a per-tree scale. Launches on `stream`; returns
// cudaGetLastError() (0 = launched). n_classes must be 1 or at most 32.
int ddt_lut_int8(const void* x, const void* feat, const void* thr,
                 const void* leaf, const void* scale, const void* cls,
                 const void* dl, const void* cat, void* out,
                 long long n_rows, int n_feat, int n_trees, int depth,
                 int tree_chunk, int sub, int n_classes,
                 int missing_bin_value, int use_missing, int use_cat,
                 int leaf_f16, float lr, float base, int smem_bytes,
                 void* stream) {
  const Args a = make_args(x, feat, thr, leaf, scale, cls, dl, cat, out,
                           n_rows, n_feat, n_trees, depth, tree_chunk, sub,
                           n_classes, missing_bin_value, use_missing,
                           use_cat, 0, lr, base);
  cudaStream_t s = (cudaStream_t)stream;
  return leaf_f16 ? dispatch<kF16>(a, smem_bytes, s)
                  : dispatch<kI8>(a, smem_bytes, s);
}

// K5. thr_packed = 1: thresholds nibble-packed [n_tc, 2^(D-1) * Tc];
// 0: int8 thresholds [n_tc, (2^D - 1) * Tc]. Leaves always nibbles.
int ddt_lut_int4(const void* x, const void* feat, const void* thr,
                 const void* leaf, const void* scale, const void* cls,
                 const void* dl, const void* cat, void* out,
                 long long n_rows, int n_feat, int n_trees, int depth,
                 int tree_chunk, int sub, int n_classes,
                 int missing_bin_value, int use_missing, int use_cat,
                 int thr_packed, float lr, float base, int smem_bytes,
                 void* stream) {
  const Args a = make_args(x, feat, thr, leaf, scale, cls, dl, cat, out,
                           n_rows, n_feat, n_trees, depth, tree_chunk, sub,
                           n_classes, missing_bin_value, use_missing,
                           use_cat, thr_packed, lr, base);
  return dispatch<kI4>(a, smem_bytes, (cudaStream_t)stream);
}

}  // extern "C"
