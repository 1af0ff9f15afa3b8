"""ddt_tpu_torch: the PyTorch/CUDA port of ddt_tpu for NVIDIA Hopper.

The package mirrors ddt_tpu's layout (config, data, models, ops, backends,
driver, api, serve). It imports torch and numpy, never JAX and nothing of
ddt_tpu. Plain tensor code is PyTorch; the TPU's Pallas kernels on the
port's path are hand-written CUDA C++ under csrc/, built at first use by
_build.py. Entry points run on the card unless the caller asks for the CPU
(TrainConfig.device / device="cpu").
"""
