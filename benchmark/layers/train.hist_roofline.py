"""train.hist_roofline: K1's least time for the traced jobs' histogram
work (benchmark/core/work.hist_work, on the rows each level really
built) over the trace's summed device time of K1 (csrc/hist.cu's
`hist_kernel`, launched by `ddt_hist_*`), in %."""

from benchmark.core import work

K1 = r"\bhist_kernel<"


def read(x):
    s, w, peaks = x["summary"], x.get("work"), x["peaks"]
    if s is None or w is None or peaks is None:
        return None
    t = s.kernel_s(K1)
    return 100.0 * work.least_s(w["hist"], peaks) / t if t > 0 else None
