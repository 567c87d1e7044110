// The calling thread's current CUDA device, set for one C entry and given
// back after it.
//
// Every C entry launches on the device its caller names. cudaSetDevice
// changes the calling thread's current device, which PyTorch reads
// (torch.cuda.current_device()) for every later call that names no index;
// so each entry holds a DeviceGuard: it saves the current device with
// cudaGetDevice, sets the named one, and restores the saved one when the
// entry returns (after the launch's error has been read).

#pragma once

#include <cuda_runtime.h>

namespace {

struct DeviceGuard {
  int previous = -1;
  cudaError_t error;

  explicit DeviceGuard(int device) {
    error = cudaGetDevice(&previous);
    if (error != cudaSuccess) {
      previous = -1;
      return;
    }
    if (previous != device) error = cudaSetDevice(device);
  }
  ~DeviceGuard() {
    if (previous >= 0) cudaSetDevice(previous);
  }
  DeviceGuard(const DeviceGuard&) = delete;
  DeviceGuard& operator=(const DeviceGuard&) = delete;
};

}  // namespace
