"""Backend selection (port of ddt_tpu/backends/__init__.py).

One backend, CUDADevice, on `cfg.device` ("cuda" by default, "cpu" for
the plain versions). Instances are cached on the config with the fields
that never change a backend's behaviour normalised, so repeated
train/predict calls share one compiled-ensemble cache: n_trees always,
and seed unless it is live. The backend reads cfg.seed as the
quantized-gradient rounding key, and the reference keys bagged runs on it
too (ddt_tpu/backends/__init__.py), so seed stays in the key whenever
subsample < 1 or grad_dtype != "f32".
"""

from __future__ import annotations

import threading

from ddt_tpu_torch.backends.base import DeviceBackend, HostTree
from ddt_tpu_torch.backends.cuda import CUDADevice
from ddt_tpu_torch.config import TrainConfig

_CACHE_MAX = 8
_CACHE: dict = {}
_LOCK = threading.Lock()        # serving threads call get_backend too


def get_backend(cfg: TrainConfig) -> DeviceBackend:
    """The backend for cfg.device (cached, least recently used evicted)."""
    seed_live = cfg.subsample < 1.0 or cfg.grad_dtype != "f32"
    key = cfg.replace(n_trees=1, seed=cfg.seed if seed_live else 0)
    with _LOCK:
        be = _CACHE.pop(key, None)
        if be is None:
            be = CUDADevice(cfg)
        _CACHE[key] = be                      # most recently used
        while len(_CACHE) > _CACHE_MAX:
            _CACHE.pop(next(iter(_CACHE)))
    return be


__all__ = ["CUDADevice", "DeviceBackend", "HostTree", "get_backend"]
