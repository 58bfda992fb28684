// Host-side occupancy query shared by the port's persistent launchers.
#pragma once

#include <cuda_runtime.h>

namespace {

// Blocks of `kernel` co-resident on one SM at (threads, smem bytes) and
// the SM count, cached per device, kernel and configuration (the
// queries cost host time that a short kernel's launch would otherwise
// pay every time).  The caller raises the shared-memory limit first.
cudaError_t blocks_per_sm(const void* kernel, int threads, size_t smem,
                          int* per_sm, int* sms) {
  struct Entry {
    const void* fn;
    int dev, threads;
    size_t smem;
    int per_sm, sms;
  };
  static Entry cache[16];
  static int n = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  for (int i = 0; i < n; ++i) {
    const Entry& e = cache[i];
    if (e.fn == kernel && e.dev == dev && e.threads == threads &&
        e.smem == smem) {
      *per_sm = e.per_sm;
      *sms = e.sms;
      return cudaSuccess;
    }
  }
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel,
                                                      threads, smem);
  if (err != cudaSuccess) return err;
  if (n < 16) cache[n++] = Entry{kernel, dev, threads, smem, *per_sm, *sms};
  return cudaSuccess;
}

}  // namespace
