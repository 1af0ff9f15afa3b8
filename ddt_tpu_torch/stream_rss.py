"""Peak host memory of a streamed training run, for the O(chunk) witness.

    python -m ddt_tpu_torch.stream_rss <rows> <features> <n_chunks> \\
        <bins> <work_dir>

A process of its own (peak RSS is process-wide): it stamps ru_maxrss
after importing torch and the port (the baseline), after cutting `rows`
of the stress generator into npz shards one chunk at a time
(data/chunks.shard_stress_chunks), and after one streamed tree of depth 2
over the shard directory on the CPU with the device chunk cache off (on
the CPU the "device" is host memory, so a cache would hold the dataset by
design). Prints one JSON line. tests/test_torch_stream_scale.py runs it
twice at one chunk size and asserts the peak does not grow with the
dataset.
"""

from __future__ import annotations

import json
import os
import resource
import sys


def _rss_mb() -> float:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0


def main(argv: list[str]) -> int:
    rows, features, n_chunks, bins = (int(a) for a in argv[:4])
    work_dir = argv[4]
    import torch

    from ddt_tpu_torch.config import TrainConfig
    from ddt_tpu_torch.data import chunks
    from ddt_tpu_torch.streaming import fit_streaming

    torch.set_num_threads(1)
    baseline = _rss_mb()
    shard_dir = os.path.join(work_dir, "shards")
    chunk_rows = chunks.shard_stress_chunks(shard_dir, rows, n_chunks,
                                            n_features=features, seed=5,
                                            n_bins=bins)
    sharded = _rss_mb()
    src = chunks.directory_chunks(shard_dir)
    ens = fit_streaming(src, src.n_chunks,
                        TrainConfig(device="cpu", n_trees=1, max_depth=2,
                                    n_bins=bins),
                        device_chunk_cache=False)
    trained = _rss_mb()
    print(json.dumps({
        "rc": 0 if ens.n_trees == 1 else 1, "rows": rows,
        "n_chunks": src.n_chunks,
        "chunk_mb": chunk_rows * features / 1e6,
        "dataset_binned_mb": rows * features / 1e6,
        "rss_baseline_mb": round(baseline, 1),
        "rss_sharded_mb": round(sharded, 1),
        "rss_trained_mb": round(trained, 1)}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
