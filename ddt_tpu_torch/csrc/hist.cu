// Histogram kernel: per-(node, feature, bin) sums of g and h.
//
// Replaces ddt_tpu/ops/hist_pallas.py::_hist_kernel (the 255-bin row-major
// TPU kernel) and ::_hist_kernel_t (the <= 128-bin transposed form), each in
// its f32 and its integer mode. The TPU kernels build a node one-hot and a
// bin one-hot in VMEM and contract them on the MXU, because XLA on a TPU
// handles scatter badly. On Hopper the direct form is cheaper: each block
// keeps a private histogram in shared memory and fills it with atomicAdd,
// then adds its partial into the zeroed output with global atomicAdd.
//
// Contract (ddt_tpu/ops/histogram.py): Xb uint8 [R, F] row-major, g and h
// [R], node_index int32 [R] with -1 = frozen row; output [N, F, n_bins, 2]
// in ddt_tpu's layout, n_bins <= 256. Bins >= n_bins are skipped (the
// caller validates binned data once at upload). Two modes, one template:
// - f32: g, h float, cells and output float (`ddt_hist_f32`);
// - integer (quantized gradients): g, h int8 or int16, cells and output
//   int32, the RAW integer histogram (`ddt_hist_i8`, `ddt_hist_i16`); the
//   caller dequantizes once. A q of 0 adds nothing, so its atomic is
//   skipped (bagged-out rows skip both).
//
// Tiling: the widest main-path level (N = 32, F = 28, 255 bins) needs
// 1.8 MB of 4-byte cells, far more than one block's 227 KB of shared
// memory. blockIdx.y picks a tile = (feature slab, node range); blockIdx.x
// picks a row chunk. A block reads the node index of every row of its chunk
// and skips rows outside its node range. ops/hist_cuda.plan_tiles sizes the
// slab and range widths from the card's real shared-memory limit; an int32
// cell is 4 B like an f32 one, so both modes share the plan.
//
// Numerics: f32 mode accumulates full f32 g and h (the TPU default rounds
// them to bf16 inside its one-hot; the port's target is the reference's
// f32 CPU segment path). Float atomics make the summation order, and so
// the last bits of each sum, change from run to run: the same class of
// seam as the MXU-order seam documented in ddt_tpu/ops/split.py. Trees are
// held to the tie-aware comparator, histograms to a stated f32 tolerance.
// Integer mode: int32 adds commute and cannot overflow (the quantizer caps
// sum|q| below 2^31, ddt_tpu_torch/ops/grad.py), so its result is bitwise
// independent of thread and block order and equals the plain version
// exactly, every run.
//
// Bound on this card: bytes. One level reads R*F bytes of Xb plus 4 B of
// node index and 2 x itemsize of g/h a row (12 B f32, 6 B int8, 8 B
// int16) and writes the small table: ~42 MB at 1M x 28, ~12.5 us at
// 3.35 TB/s; the adds are ~56M operations, under 2 us at 33.5 T f32 adds/s
// (the data sheet's 67 TFLOP/s counts an FMA as two) and ~3.3 us at
// 16.75 T INT32 ops/s. The design keeps each row's Xb bytes to one read per
// slab (threads walk (row, feature) pairs, so neighbouring threads read
// neighbouring bytes) and keeps every add in shared memory until the flush.
// Each extra node range re-reads the node index of every row: that and the
// flush's global atomics are what the simple design pays over the bound.

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;

// G: the g/h element type (float, int8_t, int16_t); Acc: the cell and
// output type (float, int).
template <typename G, typename Acc>
__global__ void __launch_bounds__(kThreads)
hist_kernel(const uint8_t* __restrict__ xb, const G* __restrict__ g,
            const G* __restrict__ h, const int* __restrict__ ni,
            Acc* __restrict__ out, long long n_rows, int n_feat,
            int n_bins, int n_nodes, int fs, int nr, int n_slabs,
            int rows_per_block) {
  extern __shared__ __align__(16) unsigned char smem[];
  Acc* cells = reinterpret_cast<Acc*>(smem);
  const int slab = blockIdx.y % n_slabs;
  const int range = blockIdx.y / n_slabs;
  const int f0 = slab * fs;
  const int fw = min(fs, n_feat - f0);
  const int n0 = range * nr;
  const int nw = min(nr, n_nodes - n0);
  const int n_cells = nw * fw * n_bins * 2;

  for (int i = threadIdx.x; i < n_cells; i += blockDim.x) cells[i] = Acc(0);
  __syncthreads();

  const long long r0 = (long long)blockIdx.x * rows_per_block;
  const long long rows_left = n_rows - r0;
  const int rows = (int)(rows_left < rows_per_block ? rows_left
                                                    : rows_per_block);
  const int n_el = rows * fw;  // the wrapper keeps this below 2^31
  for (int e = threadIdx.x; e < n_el; e += blockDim.x) {
    const int rl = e / fw;
    const int fl = e - rl * fw;
    const long long r = r0 + rl;
    const int node = __ldg(ni + r) - n0;  // frozen rows (-1) fall below 0
    if ((unsigned)node >= (unsigned)nw) continue;
    const int b = __ldg(xb + r * n_feat + f0 + fl);
    if (b >= n_bins) continue;
    Acc* c = cells + ((node * fw + fl) * n_bins + b) * 2;
    const Acc gv = static_cast<Acc>(__ldg(g + r));
    const Acc hv = static_cast<Acc>(__ldg(h + r));
    if constexpr (std::is_same<Acc, float>::value) {
      atomicAdd(c, gv);
      atomicAdd(c + 1, hv);
    } else {  // exact: a zero q changes no integer sum
      if (gv != Acc(0)) atomicAdd(c, gv);
      if (hv != Acc(0)) atomicAdd(c + 1, hv);
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < n_cells; i += blockDim.x) {
    const Acc v = cells[i];
    if (v == Acc(0)) continue;  // adding 0 (+0.f) changes no sum
    const int ch = i & 1;
    int rest = i >> 1;
    const int b = rest % n_bins;
    rest /= n_bins;
    const int fl = rest % fw;
    const int nl = rest / fw;
    const long long o =
        (((long long)(n0 + nl) * n_feat + f0 + fl) * n_bins + b) * 2 + ch;
    atomicAdd(out + o, v);
  }
}

template <typename G, typename Acc>
int launch(const void* xb, const void* g, const void* h, const void* ni,
           void* out, long long n_rows, int n_feat, int n_bins, int n_nodes,
           int fs, int nr, int blocks_x, int rows_per_block, int smem_bytes,
           void* stream) {
  cudaError_t e = cudaFuncSetAttribute(
      hist_kernel<G, Acc>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (e != cudaSuccess) return (int)e;
  const int n_slabs = (n_feat + fs - 1) / fs;
  const int n_ranges = (n_nodes + nr - 1) / nr;
  dim3 grid(blocks_x, n_slabs * n_ranges);
  hist_kernel<G, Acc><<<grid, kThreads, smem_bytes, (cudaStream_t)stream>>>(
      (const uint8_t*)xb, (const G*)g, (const G*)h, (const int*)ni,
      (Acc*)out, n_rows, n_feat, n_bins, n_nodes, fs, nr, n_slabs,
      rows_per_block);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Each launches on `stream` and returns cudaGetLastError() (0 = launched).
// f32 g/h -> f32 histogram.
int ddt_hist_f32(const void* xb, const void* g, const void* h,
                 const void* ni, void* out, long long n_rows, int n_feat,
                 int n_bins, int n_nodes, int fs, int nr, int blocks_x,
                 int rows_per_block, int smem_bytes, void* stream) {
  return launch<float, float>(xb, g, h, ni, out, n_rows, n_feat, n_bins,
                              n_nodes, fs, nr, blocks_x, rows_per_block,
                              smem_bytes, stream);
}

// int8 g/h -> raw int32 histogram.
int ddt_hist_i8(const void* xb, const void* g, const void* h,
                const void* ni, void* out, long long n_rows, int n_feat,
                int n_bins, int n_nodes, int fs, int nr, int blocks_x,
                int rows_per_block, int smem_bytes, void* stream) {
  return launch<int8_t, int>(xb, g, h, ni, out, n_rows, n_feat, n_bins,
                             n_nodes, fs, nr, blocks_x, rows_per_block,
                             smem_bytes, stream);
}

// int16 g/h -> raw int32 histogram.
int ddt_hist_i16(const void* xb, const void* g, const void* h,
                 const void* ni, void* out, long long n_rows, int n_feat,
                 int n_bins, int n_nodes, int fs, int nr, int blocks_x,
                 int rows_per_block, int smem_bytes, void* stream) {
  return launch<int16_t, int>(xb, g, h, ni, out, n_rows, n_feat, n_bins,
                              n_nodes, fs, nr, blocks_x, rows_per_block,
                              smem_bytes, stream);
}

}  // extern "C"
