"""models layer of the PyTorch/CUDA port (mirrors ddt_tpu/models)."""
