// Makes a CUDA device current for the calling thread for one C entry and
// restores the thread's previous device when the entry returns, so a call
// on a tensor of another card leaves the caller's current device as it was.
#pragma once

#include <cuda_runtime.h>

namespace xsdba {

class DeviceGuard {
 public:
  explicit DeviceGuard(int device) {
    status_ = cudaGetDevice(&prev_);
    if (status_ == cudaSuccess && prev_ != device) {
      status_ = cudaSetDevice(device);
      if (status_ == cudaSuccess) restore_ = true;
    }
  }
  ~DeviceGuard() {
    if (restore_) cudaSetDevice(prev_);
  }
  DeviceGuard(const DeviceGuard&) = delete;
  DeviceGuard& operator=(const DeviceGuard&) = delete;

  // cudaSuccess, or the error that kept `device` from becoming current.
  cudaError_t status() const { return status_; }

 private:
  int prev_ = 0;
  bool restore_ = false;
  cudaError_t status_;
};

}  // namespace xsdba
