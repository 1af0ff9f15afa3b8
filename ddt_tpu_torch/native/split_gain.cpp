// Native CPU SplitGain kernel — the reference's second named kernel
// [BASELINE: "SplitGain"], CPU edition (the TPU edition is ops/split.py).
//
// BIT-PARITY CONTRACT with reference/numpy_trainer.best_splits: float32
// sequential cumsum over bins, float32 gain arithmetic, bfloat16
// round-to-nearest-even rounding of gains before a first-occurrence argmax
// over the flattened (feature, bin) axis. This is what makes the native CPU
// training path grow trees identical to the NumPy oracle and to the TPU
// backend (the repo-wide deterministic-split rule, see ops/split.py).

#include <cmath>
#include <cstdint>
#include <cstring>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

// Round float32 -> bfloat16 (round-to-nearest-even), returned as the
// float32 value the bf16 bits represent. Matches ml_dtypes/XLA semantics
// for finite values; -inf passes through; NaN never reaches this (masked).
inline float to_bf16(float x) {
    uint32_t bits;
    std::memcpy(&bits, &x, 4);
    uint32_t rounded = bits + 0x7FFFu + ((bits >> 16) & 1u);
    rounded &= 0xFFFF0000u;
    float out;
    std::memcpy(&out, &rounded, 4);
    return out;
}

}  // namespace

extern "C" {

void ddt_split_gain(
    const float* hist,        // [n_nodes, F, B, 2] (g, h) sums
    int32_t n_nodes,
    int64_t F,
    int32_t B,
    float reg_lambda,
    float min_child_weight,
    float* best_gain,         // [n_nodes] (bf16-valued float32; -inf if none)
    int32_t* best_feature,    // [n_nodes]
    int32_t* best_bin         // [n_nodes]
) {
    const int64_t fstride = (int64_t)B * 2;
    const int64_t nstride = F * fstride;
    const float NEG_INF = -INFINITY;

#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
    for (int32_t n = 0; n < n_nodes; ++n) {
        const float* hn = hist + (int64_t)n * nstride;
        float bg = NEG_INF;
        int64_t bidx = -1;
        for (int64_t f = 0; f < F; ++f) {
            const float* hf = hn + f * fstride;
            // PER-FEATURE totals in np.cumsum's sequential order (twin
            // convention with numpy_trainer/ops-split: feature f's own
            // total makes degenerate complements exactly zero).
            float G = 0.0f, H = 0.0f;
            for (int32_t b = 0; b < B; ++b) {
                G += hf[b * 2 + 0];
                H += hf[b * 2 + 1];
            }
            const float parent = (G * G) / (H + reg_lambda);
            float GL = 0.0f, HL = 0.0f;
            for (int32_t b = 0; b < B - 1; ++b) {  // last bin never valid
                GL += hf[b * 2 + 0];
                HL += hf[b * 2 + 1];
                const float GR = G - GL;
                const float HR = H - HL;
                if (HL < min_child_weight || HR < min_child_weight) continue;
                float gain = 0.5f * (
                    (GL * GL) / (HL + reg_lambda)
                    + (GR * GR) / (HR + reg_lambda)
                    - parent);
                if (std::isnan(gain)) continue;    // 0/0 when reg_lambda == 0
                gain = to_bf16(gain);
                if (gain > bg) {                   // strict >: first index wins
                    bg = gain;
                    bidx = f * B + b;
                }
            }
        }
        best_gain[n] = bg;
        best_feature[n] = bidx < 0 ? 0 : (int32_t)(bidx / B);
        best_bin[n] = bidx < 0 ? 0 : (int32_t)(bidx % B);
    }
}

// Full-contract SplitGain: feature_mask (colsample), missing_bin (the
// reserved NaN bin B-1 with a learned default direction), cat_mask
// (categorical one-vs-rest, "bin == k goes LEFT"). Bit-parity twin of
// reference/numpy_trainer.best_splits: the argmax runs over the flattened
// [direction(RIGHT first), feature, bin] axis with bf16-rounded gains and
// a strict-> first-occurrence rule, so ties resolve exactly like the
// NumPy oracle and the TPU kernel. feature_mask/cat_mask may be NULL.
void ddt_split_gain_full(
    const float* hist,        // [n_nodes, F, B, 2]
    int32_t n_nodes,
    int64_t F,
    int32_t B,
    float reg_lambda,
    float min_child_weight,
    const uint8_t* feature_mask,   // [F] 1 = allowed, or NULL
    int32_t missing_bin,           // 0/1
    const uint8_t* cat_mask,       // [F] 1 = categorical, or NULL
    float* best_gain,         // [n_nodes] (bf16-valued; -inf if none)
    int32_t* best_feature,
    int32_t* best_bin,
    uint8_t* default_left     // [n_nodes] 1 = NaN rows go LEFT
) {
    const int64_t fstride = (int64_t)B * 2;
    const int64_t nstride = F * fstride;
    const float NEG_INF = -INFINITY;

#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
    for (int32_t n = 0; n < n_nodes; ++n) {
        const float* hn = hist + (int64_t)n * nstride;
        float bg = NEG_INF;
        int64_t bidx = -1;       // flattened (dir, f, b); RIGHT block first
        const int n_dirs = missing_bin ? 2 : 1;
        for (int dir = 0; dir < n_dirs; ++dir) {
            for (int64_t f = 0; f < F; ++f) {
                if (feature_mask && !feature_mask[f]) continue;
                const bool is_cat = cat_mask && cat_mask[f];
                if (dir == 1 && is_cat) continue;   // cat: RIGHT block only
                const float* hf = hn + f * fstride;
                // Per-feature totals in sequential f32 order (shared twin
                // convention — see ddt_split_gain above).
                float G = 0.0f, H = 0.0f;
                for (int32_t b = 0; b < B; ++b) {
                    G += hf[b * 2 + 0];
                    H += hf[b * 2 + 1];
                }
                const float parent = (G * G) / (H + reg_lambda);
                // Missing mass (bin B-1) moves LEFT in the dir==1 block.
                const float mg = missing_bin ? hf[(B - 1) * 2 + 0] : 0.0f;
                const float mh = missing_bin ? hf[(B - 1) * 2 + 1] : 0.0f;
                float GLrun = 0.0f, HLrun = 0.0f;
                for (int32_t b = 0; b < B; ++b) {
                    GLrun += hf[b * 2 + 0];
                    HLrun += hf[b * 2 + 1];
                    float GL, HL;
                    if (is_cat) {
                        // One-vs-rest: left child is exactly bin b; every
                        // bin (incl. the last) is a candidate.
                        GL = hf[b * 2 + 0];
                        HL = hf[b * 2 + 1];
                    } else {
                        // Ordinal cumsum; the NaN bin itself (and under
                        // missing, the bin below it) never splits, and
                        // the last bin leaves an empty right child.
                        if (b == B - 1) continue;
                        if (missing_bin && dir == 1 && b == B - 2) continue;
                        GL = GLrun + (dir == 1 ? mg : 0.0f);
                        HL = HLrun + (dir == 1 ? mh : 0.0f);
                    }
                    const float GR = G - GL;
                    const float HR = H - HL;
                    if (HL < min_child_weight || HR < min_child_weight)
                        continue;
                    float gain = 0.5f * (
                        (GL * GL) / (HL + reg_lambda)
                        + (GR * GR) / (HR + reg_lambda)
                        - parent);
                    if (std::isnan(gain)) continue;
                    gain = to_bf16(gain);
                    if (gain > bg) {               // strict >: first wins
                        bg = gain;
                        bidx = ((int64_t)dir * F + f) * B + b;
                    }
                }
            }
        }
        best_gain[n] = bg;
        const int64_t fb = bidx < 0 ? 0 : bidx % (F * B);
        best_feature[n] = bidx < 0 ? 0 : (int32_t)(fb / B);
        best_bin[n] = bidx < 0 ? 0 : (int32_t)(fb % B);
        default_left[n] = bidx >= (int64_t)F * B ? 1 : 0;
    }
}

}  // extern "C"
