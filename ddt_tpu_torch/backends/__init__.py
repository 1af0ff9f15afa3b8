"""Backend selection (port of ddt_tpu/backends/__init__.py).

One backend, CUDADevice, on `cfg.device` ("cuda" by default, "cpu" for
the plain versions). Instances are cached on the config with the fields
that never change a backend's behaviour (n_trees, seed) normalised, so
repeated train/predict calls share one compiled-ensemble cache.
"""

from __future__ import annotations

from ddt_tpu_torch.backends.base import DeviceBackend, HostTree
from ddt_tpu_torch.backends.cuda import CUDADevice
from ddt_tpu_torch.config import TrainConfig

_CACHE_MAX = 8
_CACHE: dict = {}


def get_backend(cfg: TrainConfig) -> DeviceBackend:
    """The backend for cfg.device (cached, least recently used evicted)."""
    key = cfg.replace(n_trees=1, seed=0)
    be = _CACHE.pop(key, None)
    if be is None:
        be = CUDADevice(cfg)
    _CACHE[key] = be                          # most recently used
    while len(_CACHE) > _CACHE_MAX:
        _CACHE.pop(next(iter(_CACHE)))
    return be


__all__ = ["CUDADevice", "DeviceBackend", "HostTree", "get_backend"]
