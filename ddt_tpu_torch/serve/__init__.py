"""Serving tier of the port (ddt_tpu/serve/): ServeEngine over a
MicroBatcher, at the f32, int8 and int4 tiers."""

from ddt_tpu_torch.serve.engine import ServeEngine

__all__ = ["ServeEngine"]
