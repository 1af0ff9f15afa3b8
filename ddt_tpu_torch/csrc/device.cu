// Device queries the kernel wrappers size their launches from
// (ddt_tpu_torch/_build.smem_limit). No kernel here.

#include <cuda_runtime.h>

extern "C" {

// Largest dynamic shared memory a block may opt in to on `device`;
// returns the CUDA error code (0 = ok).
int ddt_smem_optin(int device, int* bytes) {
  return (int)cudaDeviceGetAttribute(
      bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
}

}  // extern "C"
