"""score.traverse_roofline: K3's least time for the window's batches
(benchmark/core/work.traverse_work: int32 compares on each row's real
path, an f32 add a row and tree, rows, trees and margins moved once)
over the trace's summed device time of K3 (csrc/lut.cu's `lut_rows` or
`lut_pairs` with f32 leaves, LEAF = kF32 = 3, launched by
`ddt_traverse_f32`), in %."""

from benchmark.core import work

K3 = r"\blut_(rows<\d+, 3,|pairs<3,)"


def read(x):
    s, w, peaks = x["summary"], x.get("work"), x["peaks"]
    if s is None or w is None or peaks is None:
        return None
    t = s.kernel_s(K3)
    return 100.0 * work.least_s(w["traverse"], peaks) / t if t > 0 else None
