"""ops layer of the PyTorch/CUDA port (mirrors ddt_tpu/ops)."""
