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
// Bound: bytes. Each element reads its index and writes its output once,
// and the table is read once: 12 MB at the probe's [8192, 128], 3.76 us
// at 3.35 TB/s. The TPU kernel holds the whole table in VMEM and gathers
// from there. Here each table element is its own 32-byte sector from L2
// (33.5 MB of sectors at the probe's shape, the 4 MB table staying in L2
// from call to call), and what bounds the kernel is how many sectors an
// SM has in flight: it reads about 3.8 TB/s of sectors, 34 % of the bound.
//
// Design: block b takes the flat elements [b * 2048, (b + 1) * 2048),
// thread t the elements b * 2048 + u * 256 + t for u < 8, so each load and
// store of a warp is coalesced and a thread's 8 table loads are all in
// flight; the column advances by 256 % C from one item to the next.
//
// Staging the table in shared memory in column strips of 8 columns (32
// bytes a row: whole sectors), so that gathers read shared memory, was
// built and measured on an H100 (PERF.md, Findings) and ran slower in every
// form: a strip is 256 KB at R = 8192, more than a block holds. Slices of
// it in the CTAs of a cluster, gathered through distributed shared memory:
// a random 4-byte remote read costs about 8 SM cycles (0.019-0.033 ms).
// The whole strip in each CTA in two passes, staged by TMA (multicast to
// 2, 4 or 8 CTAs) or by 16-byte cp.async: each SM then receives as many
// sectors as the direct gather reads (0.016-0.028 ms). The direct gather
// takes 0.011 ms.
#include <cuda_runtime.h>

namespace kinet {

constexpr int kThreads = 256;
constexpr int kItems = 8;  // elements a thread

__global__ void __launch_bounds__(kThreads)
    gather_rows_kernel(const float* __restrict__ tbl,
                       const int* __restrict__ idx, float* __restrict__ out,
                       int R, int C, long long n, int step) {
  const long long t0 = (long long)blockIdx.x * kThreads * kItems + threadIdx.x;
  if (t0 >= n) return;
  int r[kItems];
#pragma unroll
  for (int u = 0; u < kItems; ++u) {
    const long long t = t0 + (long long)u * kThreads;
    r[u] = t < n ? __ldg(idx + t) : 0;
  }
  int col = (int)(t0 % C);
  float v[kItems];
#pragma unroll
  for (int u = 0; u < kItems; ++u) {
    const int row = r[u] + (r[u] < 0 ? R : 0);
    v[u] = (unsigned)row < (unsigned)R
               ? __ldg(tbl + (long long)row * C + col)
               : __int_as_float(0x7fc00000);  // NaN
    col += step;
    col -= col >= C ? C : 0;
  }
#pragma unroll
  for (int u = 0; u < kItems; ++u) {
    const long long t = t0 + (long long)u * kThreads;
    if (t < n) out[t] = v[u];
  }
}

}  // namespace kinet

// C entry bound with ctypes. Returns cudaGetLastError() after the launch.
extern "C" int gather_rows(const void* tbl, const void* idx, void* out, int R,
                           int C, void* stream) {
  const long long n = (long long)R * C;
  const long long per_block = kinet::kThreads * kinet::kItems;
  kinet::gather_rows_kernel<<<(unsigned int)((n + per_block - 1) / per_block),
                              kinet::kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(tbl), static_cast<const int*>(idx),
      static_cast<float*>(out), R, C, n, kinet::kThreads % C);
  return (int)cudaGetLastError();
}
