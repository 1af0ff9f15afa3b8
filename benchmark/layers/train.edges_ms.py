"""train.edges_ms: host milliseconds of edge fitting
(data/quantizer.fit_bin_mapper) a job, from the harness's span around
its own call in the traced run."""


def read(x):
    s = x["spans"].get("bench.edges")
    return 1e3 * sum(s) / len(s) if s else None
