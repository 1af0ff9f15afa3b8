"""Digest-addressed model registry (port of ddt_tpu/registry).

Submodules: `manifest` (provenance and integrity schemas, stdlib and
numpy), `store` (the on-disk object and version store, the reference's
layout), `loader` (restore a servable model; imports the serving
engine, so load it where it is needed)."""

from ddt_tpu_torch.registry.manifest import IntegrityError  # noqa: F401
from ddt_tpu_torch.registry.store import Registry, RegistryError  # noqa: F401
