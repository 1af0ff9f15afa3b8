"""Backend selection (port of ddt_tpu/backends/__init__.py).

Two backends, by cfg.backend: "cuda" (the default) is CUDADevice on
`cfg.device` ("cuda" by default, "cpu" for the plain versions); "cpu" is
the NumPy / native C++ oracle, backends/cpu.CPUDevice (the CPU baseline).
"fpga" is the reference's flag-parity stub (FPGADevice): the flag is
accepted and the backend's construction raises NotImplementedError.
For scoring a batch over several cards of one
process the memoised RowShardedScorer (`row_sharded_backend`).
Instances are cached on the config with the fields that never change a
backend's behaviour normalised, so repeated
train/predict calls share one compiled-ensemble cache: n_trees and
fused_block_rounds (read by the Driver) always, and seed unless it is
live. The backend reads cfg.seed as the
quantized-gradient rounding key, and the reference keys bagged runs on it
too (ddt_tpu/backends/__init__.py), so seed stays in the key whenever
subsample < 1 or grad_dtype != "f32".

A backend that binds a mesh (cfg.world_size the world size of an
initialised group, parallel/mesh.binds; any shape, a group of one rank
too) is not cached: a process that destroys and re-initialises its group
(a test pool, say) must never get one back that holds dead groups. Every
other backend is, a rank's scoring backend (one partition in a larger
group) too.
"""

from __future__ import annotations

import threading

from ddt_tpu_torch.backends.base import DeviceBackend, HostTree
from ddt_tpu_torch.backends.cpu import CPUDevice
from ddt_tpu_torch.backends.cuda import CUDADevice, RowShardedScorer
from ddt_tpu_torch.config import TrainConfig
from ddt_tpu_torch.parallel import mesh


class FPGADevice:
    """Flag-parity stub for the reference's FPGA backend: the flag exists
    (BASELINE: backend selection by flag), the backend does not."""

    name = "fpga"

    def __init__(self, cfg: TrainConfig):
        raise NotImplementedError(
            "The FPGA backend exists in this framework's flag surface for "
            "parity with the reference, but this build targets NVIDIA "
            "cards: no FPGA shell or runtime is present. Use "
            "backend='cuda' or backend='cpu'.")


_CACHE_MAX = 8
_CACHE: dict = {}
_LOCK = threading.Lock()        # serving threads call get_backend too


def get_backend(cfg: TrainConfig) -> DeviceBackend:
    """The backend of cfg.backend on cfg.device (cached, least recently
    used evicted; a fresh one where it binds a mesh). backend="fpga"
    raises NotImplementedError (FPGADevice)."""
    if cfg.backend == "fpga":
        return FPGADevice(cfg)
    if cfg.backend == "cuda" and mesh.binds(cfg):
        return CUDADevice(cfg)
    seed_live = cfg.subsample < 1.0 or cfg.grad_dtype != "f32"
    key = cfg.replace(n_trees=1, fused_block_rounds=1,
                      seed=cfg.seed if seed_live else 0)
    with _LOCK:
        be = _CACHE.pop(key, None)
        if be is None:
            be = CPUDevice(cfg) if cfg.backend == "cpu" else CUDADevice(cfg)
        _CACHE[key] = be                      # most recently used
        while len(_CACHE) > _CACHE_MAX:
            _CACHE.pop(next(iter(_CACHE)))
    return be


#: Row-sharded scorers, one per (partition count, device type): rebuilding
#: one per call would drop every shard's cached scoring tables.
_ROW_SHARDED: dict = {}


def row_sharded_backend(n_partitions: int,
                        device: str = "cuda") -> RowShardedScorer:
    """The memoised RowShardedScorer over `n_partitions` devices of type
    `device` (api.predict(n_partitions=)). Raises when more partitions
    than visible cards are asked of "cuda"."""
    key = (int(n_partitions), device)
    with _LOCK:
        sc = _ROW_SHARDED.get(key)
        if sc is None:
            sc = RowShardedScorer(n_partitions, device)
            _ROW_SHARDED[key] = sc
    return sc


__all__ = ["CPUDevice", "CUDADevice", "DeviceBackend", "FPGADevice",
           "HostTree", "RowShardedScorer",
           "get_backend", "row_sharded_backend"]
