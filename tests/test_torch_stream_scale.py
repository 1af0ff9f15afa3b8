"""The port's O(chunk) memory witness (the twin of
tests/test_stream_scale.py): peak host memory of a streamed run tracks
the chunk size, not the dataset size. The worker
(ddt_tpu_torch/stream_rss.py) runs in a fresh process twice at the same
250,000-row chunks, with the dataset quadrupled (1M -> 4M rows of 64
binned features: 64 -> 256 MB), and the peak RSS growth between the two
must stay under half the binned dataset's growth (96 of 192 MB). What may
grow is the resident per-row state (labels, weights, predictions and
leaf slots, 14 bytes a row: ~42 MB); a path that held the binned chunks
would add the whole 192 MB.
"""

import json
import os
import subprocess
import sys

FEATURES, BINS, CHUNK_ROWS = 64, 31, 250_000
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _measure(n_chunks, work_dir):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "ddt_tpu_torch.stream_rss",
         str(n_chunks * CHUNK_ROWS), str(FEATURES), str(n_chunks),
         str(BINS), str(work_dir)],
        capture_output=True, text=True, timeout=600, env=env, cwd=REPO)
    assert out.returncode == 0, out.stdout + "\n" + out.stderr
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert rec["rc"] == 0 and rec["n_chunks"] == n_chunks
    return rec


def test_streamed_memory_is_o_chunk(tmp_path):
    small = _measure(4, tmp_path / "small")
    big = _measure(16, tmp_path / "big")
    for rec in (small, big):
        # The shard writer holds one generated chunk and its npz buffers.
        assert rec["rss_sharded_mb"] - rec["rss_baseline_mb"] \
            < 8 * rec["chunk_mb"], rec
    d_small = small["rss_trained_mb"] - small["rss_baseline_mb"]
    d_big = big["rss_trained_mb"] - big["rss_baseline_mb"]
    growth = big["dataset_binned_mb"] - small["dataset_binned_mb"]
    assert d_big - d_small < growth / 2, (small, big)
