// Multi-scale deformable attention forward with head-shared sampling
// locations (enc_msda_shared_locs): every head samples the same (level,
// point) locations, each with its own attention weights.
//
// Replaces the XLA formulation
// kinet_tpu/ops/msda.py::ms_deform_attn_patch_shared (one [2, 2, M*D] patch
// gather per sample and level, all heads in one row):
//
//   out[b, q, m*D + d] = sum_{l, p} aw[b,q,m,l,p] *
//       bilinear(value[b, level l, m, d] at loc[b,q,l,p])
//
// value [B, S, M, D] f32 or bf16 (a row of M*D channels per token);
// loc [B, Lq, L, P, 2] and aw [B, Lq, M, L, P] f32; out [B, Lq, M*D] f32,
// accumulated in f32. Levels of height or width 1 follow grid_sample's
// zeros padding (corner_at), as the JAX package's pad to 2 does.
//
// What bounds it on an H100: the corner reads from L2. A sample's four
// corner cells are whole M*D rows (576 bytes in bf16 at hidden 288), read
// once for all heads: M times fewer, longer corner reads than per-head
// sampling, the access pattern of msda_raw_pool_fwd, not msda_fwd's.
//
// Design (simple first): one thread per (b, q, V channels of the row), a
// query's M*D / V threads forming its group; V divides D, so a thread's
// channels lie in one head, whose weights it reads. Neighbouring threads
// read neighbouring addresses of the same corner row. (L, P) = (2, 2) and
// (1, 2), the flagship's encoder shapes, are fixed at compile time (the
// query's locations and the head's weights read as vectors, all 4*L*P
// corner loads in flight before the first FMA); a generic instance takes
// any (L, P).
#include <algorithm>

#include "msda_common.cuh"

namespace kinet {

constexpr int kThreads = 256;

template <typename T, int V, int kL, int kP>
__global__ void __launch_bounds__(kThreads)
    msda_shared_fwd_kernel(const T* __restrict__ value,
                           const int* __restrict__ spatial_shapes,
                           const int* __restrict__ level_start,
                           const float* __restrict__ loc,
                           const float* __restrict__ aw,
                           float* __restrict__ out, int B, int S, int M,
                           int D, int Lq, int L, int P) {
  const long long row = (long long)M * D;
  const int groups = (int)(row / V);
  const long long items = (long long)B * Lq * groups;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < items; i += (long long)gridDim.x * blockDim.x) {
    const long long bq = i / groups;
    const int c0 = (int)(i - bq * groups) * V;
    const int m = c0 / D;
    const int b = (int)(bq / Lq);
    const T* rows = value + (long long)b * S * row + c0;
    const long long bqm = bq * M + m;
    float acc[V];
#pragma unroll
    for (int j = 0; j < V; ++j) acc[j] = 0.0f;
    if constexpr (kL > 0) {
      constexpr int kLP = kL * kP;
      float xy[2 * kLP], a[kLP];
      load_floats<2 * kLP>(loc + bq * 2 * kLP, xy);
      load_floats<kLP>(aw + bqm * kLP, a);
      float v[4 * kLP][V], wt[4 * kLP];
#pragma unroll
      for (int l = 0; l < kL; ++l) {
        const int h = __ldg(spatial_shapes + 2 * l);
        const int w = __ldg(spatial_shapes + 2 * l + 1);
        const T* base = rows + (long long)__ldg(level_start + l) * row;
#pragma unroll
        for (int p = 0; p < kP; ++p) {
          const int k = l * kP + p;
          const float x = xy[2 * k] * w - 0.5f;
          const float y = xy[2 * k + 1] * h - 0.5f;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const long long cell =
                corner_branch_free(c, h, w, x, y, a[k], wt[4 * k + c]);
            VecIO<T, V>::load(base + cell * row, v[4 * k + c]);
          }
        }
      }
#pragma unroll
      for (int k = 0; k < 4 * kLP; ++k)
#pragma unroll
        for (int j = 0; j < V; ++j) acc[j] = fmaf(wt[k], v[k][j], acc[j]);
    } else {
      for (int l = 0; l < L; ++l) {
        const int h = __ldg(spatial_shapes + 2 * l);
        const int w = __ldg(spatial_shapes + 2 * l + 1);
        const T* base = rows + (long long)__ldg(level_start + l) * row;
        for (int p = 0; p < P; ++p) {
          const long long s = bq * L * P + l * P + p;
          const float x = __ldg(loc + 2 * s) * w - 0.5f;
          const float y = __ldg(loc + 2 * s + 1) * h - 0.5f;
          const float a = __ldg(aw + bqm * L * P + l * P + p);
          float v[4][V], wt[4];
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const long long cell = corner_branch_free(c, h, w, x, y, a, wt[c]);
            VecIO<T, V>::load(base + cell * row, v[c]);
          }
#pragma unroll
          for (int c = 0; c < 4; ++c)
#pragma unroll
            for (int j = 0; j < V; ++j) acc[j] = fmaf(wt[c], v[c][j], acc[j]);
        }
      }
    }
    VecIO<float, V>::store(out + bq * row + c0, acc);
  }
}

template <typename T, int V>
static cudaError_t launch_v(const T* value, const int* sh, const int* st,
                            const float* lc, const float* a, float* o, int B,
                            int S, int M, int D, int Lq, int L, int P,
                            bool fixed, cudaStream_t stream) {
  const long long items = (long long)B * Lq * M * (D / V);
  const unsigned blocks =
      (unsigned)std::min<long long>((items + kThreads - 1) / kThreads, 1 << 30);
  auto go = [&](auto kernel) {
    kernel<<<blocks, kThreads, 0, stream>>>(value, sh, st, lc, a, o, B, S, M,
                                            D, Lq, L, P);
  };
  if (fixed && L == 2 && P == 2)
    go(msda_shared_fwd_kernel<T, V, 2, 2>);
  else if (fixed && L == 1 && P == 2)
    go(msda_shared_fwd_kernel<T, V, 1, 2>);
  else
    go(msda_shared_fwd_kernel<T, V, 0, 0>);
  return cudaGetLastError();
}

template <typename T>
static cudaError_t launch(const void* value, const void* shapes,
                          const void* starts, const void* loc, const void* aw,
                          void* out, int B, int S, int M, int D, int Lq,
                          int L, int P, cudaStream_t stream) {
  const T* val = static_cast<const T*>(value);
  const int* sh = static_cast<const int*>(shapes);
  const int* st = static_cast<const int*>(starts);
  const float* lc = static_cast<const float*>(loc);
  const float* a = static_cast<const float*>(aw);
  float* o = static_cast<float*>(out);
  // the fixed instances read a query's loc and a head's aw as vectors
  const bool fixed = (uintptr_t)loc % 16 == 0 && (uintptr_t)aw % 16 == 0;
  // V divides D: a thread's channels lie in one head
  const int v = pick_vec(D, value, sizeof(T), out, sizeof(float));
  if (v == 4)
    return launch_v<T, 4>(val, sh, st, lc, a, o, B, S, M, D, Lq, L, P, fixed,
                          stream);
  if (v == 2)
    return launch_v<T, 2>(val, sh, st, lc, a, o, B, S, M, D, Lq, L, P, fixed,
                          stream);
  return launch_v<T, 1>(val, sh, st, lc, a, o, B, S, M, D, Lq, L, P, fixed,
                        stream);
}

}  // namespace kinet

// C entry bound with ctypes. Returns the launch's CUDA error (0 if none).
extern "C" int msda_shared_fwd(const void* value, int dtype,
                               const void* shapes, const void* starts,
                               const void* loc, const void* aw, void* out,
                               int B, int S, int M, int D, int Lq, int L,
                               int P, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kinet::kBF16)
    return (int)kinet::launch<__nv_bfloat16>(value, shapes, starts, loc, aw,
                                             out, B, S, M, D, Lq, L, P, s);
  if (dtype == kinet::kF32)
    return (int)kinet::launch<float>(value, shapes, starts, loc, aw, out, B,
                                     S, M, D, Lq, L, P, s);
  return (int)cudaErrorInvalidValue;
}
