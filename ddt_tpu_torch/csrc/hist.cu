// Histogram kernel: per-(node, feature, bin) sums of g and h.
//
// Replaces ddt_tpu/ops/hist_pallas.py::_hist_kernel (K1, the 255-bin
// row-major TPU kernel) and ::_hist_kernel_t (K2, the <= 128-bin transposed
// form), each in its f32 and its integer mode: one source, one planner
// (ops/hist_cuda.plan_tiles) for both bin regimes.
//
// Contract (ddt_tpu/ops/histogram.py): Xb uint8 [R, F] row-major, g and h
// [R], node_index int32 [R] with -1 = frozen row; output [N, F, n_bins, 2]
// in ddt_tpu's layout, n_bins <= 256, zeroed by the wrapper. Bins >= n_bins
// are skipped (the caller validates binned data once at upload). Modes:
// - f32: g, h float, output float (`ddt_hist_f32`);
// - integer (quantized gradients): g, h int8 or int16, output the RAW int32
//   histogram (`ddt_hist_i8`, `ddt_hist_i16`); the caller dequantizes once.
//
// What bounds it on this card. The byte bound: one level reads R*F bytes
// of Xb, 4 B of node index a row and 2 x itemsize of g/h per active row,
// and writes the small table: ~42 MB at 1M x 28, ~12.5 us at 3.35 TB/s.
// What sets its time instead is the rate of shared-memory atomics: one
// add per (row, feature) and channel, 28M (row, feature) pairs a level at
// 1M x 28. On sm_90 only the 32-bit integer shared add is native (SASS
// ATOMS.ADD); a shared f32 add and a shared 64-bit add compile to
// compare-and-swap loops (ATOMS.CAST.SPIN). The design:
//
// 1. A thread takes a row, not a (row, feature) element. It reads the
//    row's node index once and drops a frozen row, or a row of another
//    node range, after that one 4-byte read; it reads g and h once and the
//    row's bytes as aligned 4-byte words (a head and a tail of single
//    bytes for any F and any row alignment), the lanes of a warp starting
//    at different words so that they add into different features. No
//    division per element.
// 2. Node ranges: a block's table holds as many nodes as its shared memory
//    does (4 at 255 bins and F = 28, 16 at 64 bins). A level with more
//    nodes runs one range per grid row; every range scans the node index,
//    but a row's bytes, g and h are read only by the range of its node, so
//    the extra ranges cost 4 B a row each.
// 3. f32 mode: one 64-bit compare-and-swap adds a (row, feature)'s g and h
//    together (one CAS loop where two f32 atomicAdds are two). Integer
//    mode: two native 32-bit adds, skipped per channel when its q is 0 and
//    per row when both are (every bagged-out row).
// 4. The flush is a TMA bulk reduction: a cell is 8 bytes in both modes,
//    laid out as the output is, so each node's row of cells is one
//    contiguous segment of the output and one `cp.reduce.async.bulk ...
//    .add` adds it in L2, instead of one global atomic per cell. Segments
//    whose ends are not 16-byte aligned (odd F with odd n_bins) fall back
//    to atomics.
// 5. The grid is sized to the card (blocks resident at once for the plan's
//    shared memory); each block walks a contiguous share of the rows and
//    flushes once.
//
// Tried on the card and not taken (PERF.md gives the times):
// - A thread-block cluster whose distributed shared memory holds a level's
//   whole table, each block adding its rows into the owning block's table
//   through cooperative_groups::this_cluster().map_shared_rank: remote
//   atomics cost more than the node-index scans they save (2x slower in
//   f32 at N >= 8). Clusters of 2 that sum their tables over distributed
//   shared memory before the flush: slower too (the flush is not where
//   the time goes).
// - One packed 64-bit integer add of ((int64)qh << 32) + qg per (row,
//   feature), decoded at the flush (G = (int32)low, H = (sum - G) >> 32):
//   exact, but the 64-bit shared add is a CAS loop on sm_90, 1.7x slower
//   than two native 32-bit adds.
// - Loading the next rows' node indices ahead: no change.
// Not built: TMA multicast of row tiles to the blocks of a cluster. With
// (2) a row's bytes are already read once, by its own range; multicast
// could share only the node index of the extra ranges (12 MB at N = 16,
// ~4 us of HBM time a level). Nor the TPU kernel's one-hot form on tensor
// cores (hist_pallas.py:188-207, s8 x s8 -> s32 in integer mode): a
// one-hot tile of T x F x 256 costs ~7 KB of shared-memory writes a row,
// ~0.25 ms a level at 1M rows, ~20x the byte bound, and in f32 it would
// need TF32, which is not f32.
//
// Numerics: f32 mode adds full f32 g and h; float atomics make the
// summation order, and so the last bits of each sum, change from run to
// run (the seam documented in ddt_tpu/ops/split.py); histograms are held
// to a stated f32 tolerance, trees to the tie-aware comparator. Integer
// mode is exact and order-free: bitwise equal to the plain version, every
// run.

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;

struct Args {
  const uint8_t* xb;
  const void* g;
  const void* h;
  const int* ni;
  void* out;
  long long n_rows;
  int n_feat, n_bins, n_nodes;
  int fs;         // features per slab
  int nr;         // nodes per block (one node range)
  int n_slabs;
};

__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Queues an add of `bytes` of shared memory at `src` into global memory
// at `dst`, elementwise, in L2 (f32 or s32 adds). bulk_wait() commits the
// queued adds and waits until their sources have been read.
template <bool kInt>
__device__ __forceinline__ void bulk_reduce_add(void* dst, const void* src,
                                                unsigned bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(src);
  if constexpr (kInt) {
    asm volatile(
        "cp.reduce.async.bulk.global.shared::cta.bulk_group.add.s32 "
        "[%0], [%1], %2;\n" ::"l"(dst), "r"(s), "r"(bytes)
        : "memory");
  } else {
    asm volatile(
        "cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32 "
        "[%0], [%1], %2;\n" ::"l"(dst), "r"(s), "r"(bytes)
        : "memory");
  }
}

__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// G: the g/h element type (float, int8_t, int16_t).
template <typename G>
__global__ void __launch_bounds__(kThreads) hist_kernel(const Args a) {
  constexpr bool kInt = !std::is_same<G, float>::value;
  // A cell is (g, h) of one (node, feature, bin): 8 bytes, two f32 or two
  // int32, in the output's layout.
  extern __shared__ __align__(16) unsigned long long cells[];

  const int slab = blockIdx.y % a.n_slabs;
  const int range = blockIdx.y / a.n_slabs;
  const int B = a.n_bins;
  const int f0 = slab * a.fs;
  const int fw = min(a.fs, a.n_feat - f0);
  const int n0 = range * a.nr;
  const int nw = min(a.nr, a.n_nodes - n0);
  const int per_node = fw * B;  // cells per node
  const int n_cells = nw * per_node;

  for (int i = threadIdx.x; i < n_cells; i += kThreads) cells[i] = 0ull;
  __syncthreads();

  const G* __restrict__ gp = static_cast<const G*>(a.g);
  const G* __restrict__ hp = static_cast<const G*>(a.h);
  const long long rpb = (a.n_rows + gridDim.x - 1) / gridDim.x;
  const long long r_begin = (long long)blockIdx.x * rpb;
  const long long r_end = min(a.n_rows, r_begin + rpb);
  const unsigned lane = threadIdx.x & 31u;

  // One row: its g and h read once, its bytes as aligned 4-byte words
  // (single bytes before the first and after the last), each word's
  // features added in turn. Lanes start at different words, so the 32
  // rows of a warp touch several features at once.
  auto add_row = [&](long long r, int ln) {
    unsigned long long* t = cells + ln * per_node;
    const G gv = __ldg(gp + r);
    const G hv = __ldg(hp + r);
    if constexpr (kInt) {
      if (gv == 0 && hv == 0) return;  // adds nothing
    }
    auto add = [&](int fl, unsigned b) {
      if (b >= (unsigned)B) return;
      unsigned long long* c = t + fl * B + b;
      if constexpr (kInt) {
        int* w = reinterpret_cast<int*>(c);
        if (gv != 0) atomicAdd(w, (int)gv);
        if (hv != 0) atomicAdd(w + 1, (int)hv);
      } else {
        // One 64-bit compare-and-swap adds g and h together.
        unsigned long long cur =
            *reinterpret_cast<volatile unsigned long long*>(c);
        while (true) {
          float2 v = *reinterpret_cast<const float2*>(&cur);
          v.x += gv;
          v.y += hv;
          const unsigned long long seen = atomicCAS(
              c, cur, *reinterpret_cast<const unsigned long long*>(&v));
          if (seen == cur) break;
          cur = seen;
        }
      }
    };
    const uint8_t* p = a.xb + r * a.n_feat + f0;
    int head = (int)((4u - ((unsigned)(uintptr_t)p & 3u)) & 3u);
    if (head > fw) head = fw;
    for (int fl = 0; fl < head; ++fl) add(fl, __ldg(p + fl));
    const unsigned* w = reinterpret_cast<const unsigned*>(p + head);
    const int n_words = (fw - head) >> 2;
    int k = n_words ? (int)(lane % (unsigned)n_words) : 0;
    for (int j = 0; j < n_words; ++j) {
      const unsigned v = __ldg(w + k);
      const int fl = head + 4 * k;
      add(fl, v & 0xffu);
      add(fl + 1, (v >> 8) & 0xffu);
      add(fl + 2, (v >> 16) & 0xffu);
      add(fl + 3, v >> 24);
      if (++k == n_words) k = 0;
    }
    for (int fl = head + 4 * n_words; fl < fw; ++fl) add(fl, __ldg(p + fl));
  };

  // Rows of this block's chunk: a frozen row, or one of another range's
  // nodes, costs its 4-byte read.
  for (long long r = r_begin + threadIdx.x; r < r_end; r += kThreads) {
    const int ln = __ldg(a.ni + r) - n0;  // frozen rows (-1) fall below 0
    if ((unsigned)ln < (unsigned)nw) add_row(r, ln);
  }
  // The bulk reduction reads the table through the async proxy.
  fence_async_shared();
  __syncthreads();

  // One segment per node: cells [ln * per_node, (ln + 1) * per_node) go to
  // output cells of node n0 + ln, features [f0, f0 + fw).
  using Out = typename std::conditional<kInt, int, float>::type;
  Out* out = static_cast<Out*>(a.out);
  for (int ln = 0; ln < nw; ++ln) {
    Out* dst = out + ((long long)(n0 + ln) * a.n_feat + f0) * B * 2;
    const Out* src = reinterpret_cast<const Out*>(cells + ln * per_node);
    const unsigned bytes = (unsigned)per_node * 8u;
    if ((((uintptr_t)dst | (uintptr_t)src | bytes) & 15u) == 0) {
      if (threadIdx.x == 0) bulk_reduce_add<kInt>(dst, src, bytes);
    } else {
      for (int i = threadIdx.x; i < per_node * 2; i += kThreads) {
        const Out v = src[i];
        if (v != Out(0)) atomicAdd(dst + i, v);
      }
    }
  }
  if (threadIdx.x == 0) bulk_wait();
}

template <typename G>
int max_blocks(int smem_bytes, int* out) {
  cudaError_t e = cudaFuncSetAttribute(
      hist_kernel<G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  int per_sm = 0, dev = 0, sms = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, hist_kernel<G>, kThreads, (size_t)smem_bytes);
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  *out = per_sm * sms;
  return (int)e;
}

template <typename G>
int launch(const void* xb, const void* g, const void* h, const void* ni,
           void* out, long long n_rows, int n_feat, int n_bins, int n_nodes,
           int fs, int nr, int blocks_x, int smem_bytes, void* stream) {
  cudaError_t e = cudaFuncSetAttribute(
      hist_kernel<G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (e != cudaSuccess) return (int)e;
  const Args a{(const uint8_t*)xb, g, h, (const int*)ni, out, n_rows,
               n_feat, n_bins, n_nodes, fs, nr, (n_feat + fs - 1) / fs};
  const int n_ranges = (n_nodes + nr - 1) / nr;
  const dim3 grid((unsigned)blocks_x, (unsigned)(a.n_slabs * n_ranges), 1);
  hist_kernel<G><<<grid, kThreads, smem_bytes, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Each launches on `stream` and returns cudaGetLastError() (0 = launched).
// Grid: blocks_x blocks along the rows, n_slabs * ceil(n_nodes / nr) tiles
// along y. f32 g/h -> f32 histogram.
int ddt_hist_f32(const void* xb, const void* g, const void* h,
                 const void* ni, void* out, long long n_rows, int n_feat,
                 int n_bins, int n_nodes, int fs, int nr, int blocks_x,
                 int smem_bytes, void* stream) {
  return launch<float>(xb, g, h, ni, out, n_rows, n_feat, n_bins, n_nodes,
                       fs, nr, blocks_x, smem_bytes, stream);
}

// int8 g/h -> raw int32 histogram.
int ddt_hist_i8(const void* xb, const void* g, const void* h,
                const void* ni, void* out, long long n_rows, int n_feat,
                int n_bins, int n_nodes, int fs, int nr, int blocks_x,
                int smem_bytes, void* stream) {
  return launch<int8_t>(xb, g, h, ni, out, n_rows, n_feat, n_bins, n_nodes,
                        fs, nr, blocks_x, smem_bytes, stream);
}

// int16 g/h -> raw int32 histogram.
int ddt_hist_i16(const void* xb, const void* g, const void* h,
                 const void* ni, void* out, long long n_rows, int n_feat,
                 int n_bins, int n_nodes, int fs, int nr, int blocks_x,
                 int smem_bytes, void* stream) {
  return launch<int16_t>(xb, g, h, ni, out, n_rows, n_feat, n_bins, n_nodes,
                         fs, nr, blocks_x, smem_bytes, stream);
}

// Blocks with `smem_bytes` of dynamic shared memory each that the current
// card holds at once, for mode 0 (f32), 1 (int8) or 2 (int16). Returns the
// CUDA error code.
int ddt_hist_max_blocks(int mode, int smem_bytes, int* out) {
  *out = 0;
  if (mode == 0) return max_blocks<float>(smem_bytes, out);
  if (mode == 1) return max_blocks<int8_t>(smem_bytes, out);
  if (mode == 2) return max_blocks<int16_t>(smem_bytes, out);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
