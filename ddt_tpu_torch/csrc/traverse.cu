// Batch traversal kernel: raw margins of a pushed-down ensemble, binned rows.
//
// Replaces ddt_tpu/ops/predict_pallas.py::_traverse_kernel. The TPU kernel
// turns the descent into a feature one-hot matmul on the MXU (colval =
// X @ fohT), a comparison matrix and k-indexed predicated selects, because
// a TPU has no cheap per-lane gather. On Hopper a thread reads a byte by
// address, so the kernel runs the descent directly: one thread per row,
// D steps of k = 2k + go per tree.
//
// Operands (ops/predict_cuda.pack_tables builds them from a
// CompiledEnsemble): X uint8 [R, F]; nodes int2 [Tpad, Nint] = (feature,
// threshold) of the internal nodes after leaf pushdown (feature -1 on
// pushed-down leaves); flags uint8 [Tpad, Nint] (bit 0 default_left,
// bit 1 categorical, already gated on feature >= 0); vals f32 [Tpad, 2^D]
// bottom-level values; cls int32 [Tpad] the class of each tree. Output f32
// [R, C] = base + lr * acc.
//
// Routing, exactly as ddt_tpu/ops/predict._descend_comp: a pushed-down
// leaf reads 0 and goes left; otherwise go = bin > thr; a categorical node
// goes right iff bin != thr; a row in the reserved missing bin goes right
// iff the node's default_left is false. Accumulation mirrors the plain
// version's order: per chunk of `tree_chunk` trees a per-class chunk sum,
// then acc += chunk sum. The final multiply and add are written with
// __fmul_rn / __fadd_rn so that nvcc cannot contract them into an FMA,
// which would round differently from the plain version.
//
// Bound on this card: operations. 1M rows x 28 features read 28 MB and
// write 4 MB (~9.6 us at 3.35 TB/s; the tables are ~40 KB a 64-tree
// chunk), but 100 depth-6 trees need ~600M integer compares, ~36 us at the
// INT32 rate (64 lanes per SM per clock, a quarter of the data sheet's
// FMA-doubled 67 TFLOP/s). Each
// block stages its rows' bytes (transposed, so that a warp's reads of one
// feature fall in distinct banks) and one chunk of tree tables in shared
// memory, so global memory sees each input byte once per block. The
// descent itself is ~D dependent shared-memory loads per tree and row:
// at 100 trees x depth 6 that latency chain, not bandwidth, is what this
// simple design pays.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <int CM>
__global__ void __launch_bounds__(kThreads)
traverse_kernel(const uint8_t* __restrict__ x, const int2* __restrict__ nodes,
                const uint8_t* __restrict__ flags,
                const float* __restrict__ vals, const int* __restrict__ cls,
                float* __restrict__ out, long long n_rows, int n_feat,
                int n_trees, int depth, int tree_chunk, int sub,
                int n_classes, int missing_bin_value, int use_missing,
                int use_cat, float lr, float base) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n_int = (1 << depth) - 1;
  const int n_leaf = 1 << depth;
  int2* s_nodes = reinterpret_cast<int2*>(smem);
  float* s_vals = reinterpret_cast<float*>(s_nodes + sub * n_int);
  int* s_cls = reinterpret_cast<int*>(s_vals + sub * n_leaf);
  uint8_t* s_flags = reinterpret_cast<uint8_t*>(s_cls + sub);
  uint8_t* s_x = s_flags + sub * n_int;

  const int tid = threadIdx.x;
  const long long rb = (long long)blockIdx.x * kThreads;
  const long long left = n_rows - rb;
  const int rows = (int)(left < kThreads ? left : kThreads);
  const bool active = tid < rows;

  // Stage this block's rows, transposed: s_x[f * kThreads + row].
  for (int i = tid; i < rows * n_feat; i += kThreads) {
    const int row = i / n_feat;
    const int f = i - row * n_feat;
    s_x[f * kThreads + row] = x[rb * n_feat + i];
  }

  float acc[CM];
  float cs[CM];
#pragma unroll
  for (int c = 0; c < CM; ++c) acc[c] = 0.f;

  for (int c0 = 0; c0 < n_trees; c0 += tree_chunk) {
#pragma unroll
    for (int c = 0; c < CM; ++c) cs[c] = 0.f;
    for (int s0 = c0; s0 < c0 + tree_chunk; s0 += sub) {
      __syncthreads();  // the previous stage's readers are done
      for (int i = tid; i < sub * n_int; i += kThreads) {
        s_nodes[i] = nodes[(long long)s0 * n_int + i];
        s_flags[i] = flags[(long long)s0 * n_int + i];
      }
      for (int i = tid; i < sub * n_leaf; i += kThreads)
        s_vals[i] = vals[(long long)s0 * n_leaf + i];
      for (int i = tid; i < sub; i += kThreads) s_cls[i] = cls[s0 + i];
      __syncthreads();
      if (!active) continue;
      for (int tl = 0; tl < sub; ++tl) {
        const int2* tn = s_nodes + tl * n_int;
        const uint8_t* tf = s_flags + tl * n_int;
        int k = 0;
        for (int d = 0; d < depth; ++d) {
          const int node = (1 << d) - 1 + k;
          const int2 nd = tn[node];
          const int v = nd.x >= 0 ? (int)s_x[nd.x * kThreads + tid] : 0;
          bool go = v > nd.y;
          if (use_cat && (tf[node] & 2)) go = v != nd.y;
          if (use_missing && v == missing_bin_value) go = !(tf[node] & 1);
          k = 2 * k + (go ? 1 : 0);
        }
        const float val = s_vals[tl * n_leaf + k];
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
  float* o = out + (rb + tid) * n_classes;
  for (int c = 0; c < n_classes && c < CM; ++c)
    o[c] = __fadd_rn(base, __fmul_rn(lr, acc[c]));
}

template <int CM>
int launch(const void* x, const void* nodes, const void* flags,
           const void* vals, const void* cls, void* out, long long n_rows,
           int n_feat, int n_trees, int depth, int tree_chunk, int sub,
           int n_classes, int missing_bin_value, int use_missing,
           int use_cat, float lr, float base, int smem_bytes,
           cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      traverse_kernel<CM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (e != cudaSuccess) return (int)e;
  const long long blocks = (n_rows + kThreads - 1) / kThreads;
  traverse_kernel<CM><<<(unsigned)blocks, kThreads, smem_bytes, stream>>>(
      (const uint8_t*)x, (const int2*)nodes, (const uint8_t*)flags,
      (const float*)vals, (const int*)cls, (float*)out, n_rows, n_feat,
      n_trees, depth, tree_chunk, sub, n_classes, missing_bin_value,
      use_missing, use_cat, lr, base);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Rows per block; the wrapper sizes the row staging area from it.
int ddt_traverse_threads() { return kThreads; }

// Launches on `stream`; returns cudaGetLastError() (0 = launched).
// n_classes must be 1 or at most 32.
int ddt_traverse_f32(const void* x, const void* nodes, const void* flags,
                     const void* vals, const void* cls, void* out,
                     long long n_rows, int n_feat, int n_trees, int depth,
                     int tree_chunk, int sub, int n_classes,
                     int missing_bin_value, int use_missing, int use_cat,
                     float lr, float base, int smem_bytes, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n_classes == 1)
    return launch<1>(x, nodes, flags, vals, cls, out, n_rows, n_feat,
                     n_trees, depth, tree_chunk, sub, n_classes,
                     missing_bin_value, use_missing, use_cat, lr, base,
                     smem_bytes, s);
  if (n_classes > 32) return (int)cudaErrorInvalidValue;
  return launch<32>(x, nodes, flags, vals, cls, out, n_rows, n_feat,
                    n_trees, depth, tree_chunk, sub, n_classes,
                    missing_bin_value, use_missing, use_cat, lr, base,
                    smem_bytes, s);
}

}  // extern "C"
