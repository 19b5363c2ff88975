// Column-wise row gather, the function of the TPU probe kernel
// scripts/pallas_gather_probe.py::run (jnp.take_along_axis(tbl, idx,
// axis=0) inside one VMEM block):
//
//   out[i, j] = tbl[idx[i, j], j]
//
// tbl [R, C] f32, idx [R, C] int32, out [R, C] f32. Indices follow
// take_along_axis: a negative index counts from the end, and an index
// still outside [0, R) gives NaN (JAX's fill mode).
//
// Bound: bytes. Each element reads its index and one table element and
// writes one output element. Design: one thread per element, so a warp
// reads 32 consecutive indices and writes 32 consecutive outputs (one
// 128-byte line each); the table reads are scattered across rows. The TPU
// version holds the whole table in VMEM; here the 4 MB table at the probe's
// shape stays in the 50 MB L2.
#include <cuda_runtime.h>

namespace kinet {

__global__ void __launch_bounds__(256)
    gather_rows_kernel(const float* __restrict__ tbl,
                       const int* __restrict__ idx, float* __restrict__ out,
                       int R, int C) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)R * C) return;
  const int j = (int)(t % C);
  int r = __ldg(idx + t);
  if (r < 0) r += R;
  out[t] = (r >= 0 && r < R) ? __ldg(tbl + (long long)r * C + j)
                             : __int_as_float(0x7fc00000);  // NaN
}

}  // namespace kinet

// C entry bound with ctypes. Returns cudaGetLastError() after the launch.
extern "C" int gather_rows(const void* tbl, const void* idx, void* out, int R,
                           int C, void* stream) {
  const long long n = (long long)R * C;
  const int threads = 256;
  const unsigned int blocks = (unsigned int)((n + threads - 1) / threads);
  kinet::gather_rows_kernel<<<blocks, threads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(tbl), static_cast<const int*>(idx),
      static_cast<float*>(out), R, C);
  return (int)cudaGetLastError();
}
