// The calling thread's current device for the life of one C entry: the entry
// launches on the device its tensors are on and gives the caller's device
// back when it returns, on every path. Without it, a launch on cuda:1 would
// leave cuda:1 current for whatever the caller's thread makes next.

#pragma once

#include <cuda_runtime.h>

namespace ics {

class DeviceGuard {
 public:
  explicit DeviceGuard(int device) {
    err_ = cudaGetDevice(&previous_);
    if (err_ == cudaSuccess && previous_ != device) {
      err_ = cudaSetDevice(device);
      restore_ = err_ == cudaSuccess;
    }
  }
  ~DeviceGuard() {
    if (restore_) cudaSetDevice(previous_);
  }
  DeviceGuard(const DeviceGuard&) = delete;
  DeviceGuard& operator=(const DeviceGuard&) = delete;

  // cudaSuccess, or why the device could not be made current
  cudaError_t error() const { return err_; }

 private:
  int previous_ = -1;
  bool restore_ = false;
  cudaError_t err_ = cudaSuccess;
};

}  // namespace ics
