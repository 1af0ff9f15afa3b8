// Native CPU reference kernels for the histogram-GBDT hot loop.
//
// The reference ships a compiled CPU implementation of the HistogramBuilder
// and compares device throughput against it (BASELINE.md: ">=5x the repo's
// CPU-reference histogram throughput"). A NumPy np.add.at baseline would be
// dishonestly slow (~1 Mrows/s); this kernel is the real CPU contender the
// device path must beat. The port's copy of ddt_tpu/native/histogram.cpp:
// built by ddt_tpu_torch/native/__init__.py (g++, into ddt_tpu_torch/_build)
// and loaded via ctypes — no pybind11 dependency.
//
// Contract identical to reference/numpy_trainer.build_histograms:
//   out[node, f, bin, {0,1}] += (g, h) over rows with node_index >= 0.
// out is float32 [n_nodes, F, n_bins, 2], zero-initialised by the caller.
//
// Parallelisation: rows are chunked across OpenMP threads, each thread
// accumulates into a private histogram copy, then copies are reduced. With
// OMP_NUM_THREADS=1 (or no OpenMP) it runs the plain serial loop with no
// allocation overhead.

#include <cstdint>
#include <cstring>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

extern "C" {

void ddt_build_histograms(
    const uint8_t* Xb,         // [R, F] row-major binned features
    const float* g,            // [R]
    const float* h,            // [R]
    const int32_t* node_index, // [R], -1 = frozen (skip row)
    int64_t R,
    int64_t F,
    int32_t n_nodes,
    int32_t n_bins,
    float* out                 // [n_nodes, F, n_bins, 2], pre-zeroed
) {
    const int64_t node_stride = F * (int64_t)n_bins * 2;

#ifdef _OPENMP
    int n_threads = omp_get_max_threads();
#else
    int n_threads = 1;
#endif

    if (n_threads <= 1) {
        for (int64_t r = 0; r < R; ++r) {
            const int32_t n = node_index[r];
            if (n < 0) continue;
            const float gr = g[r];
            const float hr = h[r];
            const uint8_t* row = Xb + r * F;
            float* base = out + (int64_t)n * node_stride;
            for (int64_t f = 0; f < F; ++f) {
                float* cell = base + (f * n_bins + row[f]) * 2;
                cell[0] += gr;
                cell[1] += hr;
            }
        }
        return;
    }

#ifdef _OPENMP
    const int64_t total = (int64_t)n_nodes * node_stride;
    std::vector<std::vector<float>> privs(n_threads);

#pragma omp parallel
    {
        const int t = omp_get_thread_num();
        // Actual team size — can be smaller than omp_get_max_threads()
        // (dynamic adjustment, thread limits); privs[nt..) then stay
        // empty and must not be read by the reduction below.
        const int nt = omp_get_num_threads();
        privs[t].assign(total, 0.0f);
        float* priv = privs[t].data();

#pragma omp for schedule(static)
        for (int64_t r = 0; r < R; ++r) {
            const int32_t n = node_index[r];
            if (n < 0) continue;
            const float gr = g[r];
            const float hr = h[r];
            const uint8_t* row = Xb + r * F;
            float* base = priv + (int64_t)n * node_stride;
            for (int64_t f = 0; f < F; ++f) {
                float* cell = base + (f * n_bins + row[f]) * 2;
                cell[0] += gr;
                cell[1] += hr;
            }
        }

        // Tree-free reduction: each thread owns a disjoint slice of `out`
        // and sums all private copies into it. The cross-thread reads of
        // privs[tt] are ordered by the implicit barrier at the end of the
        // row loop above (every assign + private accumulation
        // happens-before every read here). TSan cannot see that edge when
        // libgomp is uninstrumented and reports these reads as races —
        // the documented false-positive class in native/tsan.supp.
        //
        // Deterministic for a FIXED team size (static chunks, reduction
        // in thread order), but the summation ORDER differs from the
        // serial row-order loop, so multi-thread results differ from the
        // 1-thread/NumPy oracle at the float32 reassociation level
        // (~1e-6 relative). Bit-exactness contracts pin 1 thread via
        // ddt_omp_set_threads.
#pragma omp for schedule(static)
        for (int64_t i = 0; i < total; ++i) {
            float acc = 0.0f;
            for (int tt = 0; tt < nt; ++tt) acc += privs[tt][i];
            out[i] += acc;
        }
    }
#endif
}

// Batch ensemble traversal (CPU reference of the gather+compare predict
// path): complete-heap trees, node <- 2*node+1+(x > thr) unless leaf.
// leaf_out is int32 [T, R] heap slots.
//
// Missing-value support (twin of models/tree._traverse_np): when
// missing_bin_value >= 0, rows whose bin equals it are NaN rows and route
// by default_left[t, n] (1 = left) instead of the threshold compare.
// default_left may be NULL only when missing_bin_value < 0.
// Categorical one-vs-rest (v3): cat_node[t, n] = 1 marks nodes splitting
// "bin == thr goes LEFT" instead of the ordinal compare; NULL = none.
void ddt_traverse_v3(
    const uint8_t* Xb,          // [R, F] binned rows
    const int32_t* feature,     // [T, N] split feature (-1 on leaves)
    const int32_t* thr_bin,     // [T, N]
    const uint8_t* is_leaf,     // [T, N]
    const uint8_t* default_left, // [T, N] or NULL (no missing handling)
    const uint8_t* cat_node,    // [T, N] or NULL (no categorical splits)
    int64_t R,
    int64_t F,
    int64_t T,
    int64_t N,
    int32_t max_depth,
    int32_t missing_bin_value,  // reserved NaN bin id; -1 = disabled
    int32_t* leaf_out           // [T, R]
) {
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
    for (int64_t t = 0; t < T; ++t) {
        const int32_t* feat_t = feature + t * N;
        const int32_t* thr_t = thr_bin + t * N;
        const uint8_t* leaf_t = is_leaf + t * N;
        const uint8_t* dl_t =
            default_left ? default_left + t * N : nullptr;
        const uint8_t* cat_t = cat_node ? cat_node + t * N : nullptr;
        int32_t* out_t = leaf_out + t * R;
        for (int64_t r = 0; r < R; ++r) {
            const uint8_t* row = Xb + r * F;
            int32_t node = 0;
            for (int32_t d = 0; d < max_depth; ++d) {
                if (leaf_t[node]) break;
                const int32_t f = feat_t[node];
                const uint8_t v = row[f];
                int right;
                if (missing_bin_value >= 0 &&
                    v == (uint8_t)missing_bin_value) {
                    right = dl_t && dl_t[node] ? 0 : 1;
                } else if (cat_t && cat_t[node]) {
                    right = v != (uint8_t)thr_t[node] ? 1 : 0;
                } else {
                    right = v > thr_t[node] ? 1 : 0;
                }
                node = 2 * node + 1 + right;
            }
            out_t[r] = node;
        }
    }
}

// OpenMP thread control for callers that need summation-order
// determinism (the multi-thread histogram reduction is deterministic per
// team size but differs from the serial order — see the reduction
// comment above). The bit-exactness tests pin 1 thread around their
// assertions through these.
int32_t ddt_omp_max_threads(void) {
#ifdef _OPENMP
    return omp_get_max_threads();
#else
    return 1;
#endif
}

void ddt_omp_set_threads(int32_t n) {
#ifdef _OPENMP
    if (n > 0) omp_set_num_threads(n);
#else
    (void)n;
#endif
}

}  // extern "C"
