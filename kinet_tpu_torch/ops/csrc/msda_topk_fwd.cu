// Multi-scale deformable attention forward with top-k sample pruning
// (enc_msda_topk): per (query, head), only the K of the L*P samples with
// the largest attention weights are read and summed.
//
// Replaces the XLA formulation kinet_tpu/ops/msda.py::ms_deform_attn_topk_quad
// (jax.lax.top_k over the weights, then a quad-table row gather of the kept
// samples):
//
//   out[b, q, m*D + d] = sum_{(l, p) in topK(aw[b,q,m])} aw[b,q,m,l,p] *
//       bilinear(value[b, level l, m, d] at loc[b,q,m,l,p])
//
// value [B, S, M, D] f32 or bf16; loc [B, Lq, M, L, P, 2] and
// aw [B, Lq, M, L, P] f32; out [B, Lq, M*D] f32, accumulated in f32.
// Ties go to the lower (level, point) index, as jax.lax.top_k breaks them:
// a freshly initialised model's weights are an exact uniform softmax, so
// every sample ties.
//
// What bounds it on an H100: as msda_fwd, the corner reads from L2, here
// K / (L*P) of them (3 of 4 at the flagship's high-level Lite layers). The
// selection costs (L*P)^2 compares of registers a thread, no memory.
//
// Design (simple first): one thread per (b, q, m, V channels), a head's
// D / V threads forming its group; each reads the (q, m)'s L*P weights,
// ranks every sample in registers (rank = the samples that beat it: a
// larger weight, or an equal one at a lower index; kept iff rank < K, the
// set a stable descending sort keeps), then reads only the kept samples'
// locations and corners, in (level, point) order. (L, P) = (2, 2) and
// (1, 2), the flagship's encoder shapes, are fixed at compile time (the
// weights and locations read as vectors); a generic instance takes any
// L*P <= 64, reading its weights from L1 in the ranking loops.
#include <algorithm>

#include "msda_common.cuh"

namespace kinet {

constexpr int kThreads = 256;

// Kept-sample bit mask of one (q, m) from its weights a[0..LP).
template <int kLP>
__device__ __forceinline__ unsigned long long rank_fixed(const float (&a)[kLP],
                                                         int K) {
  unsigned long long keep = 0;
#pragma unroll
  for (int j = 0; j < kLP; ++j) {
    int rank = 0;
#pragma unroll
    for (int i = 0; i < kLP; ++i)
      rank += (a[i] > a[j]) || (a[i] == a[j] && i < j);
    keep |= (unsigned long long)(rank < K) << j;
  }
  return keep;
}

__device__ __forceinline__ unsigned long long rank_generic(
    const float* __restrict__ a, int LP, int K) {
  unsigned long long keep = 0;
  for (int j = 0; j < LP; ++j) {
    const float aj = __ldg(a + j);
    int rank = 0;
    for (int i = 0; i < LP; ++i) {
      const float ai = __ldg(a + i);
      rank += (ai > aj) || (ai == aj && i < j);
    }
    keep |= (unsigned long long)(rank < K) << j;
  }
  return keep;
}

// acc += aw * bilinear sample of V channels at (x, y) of one level.
template <typename T, int V>
__device__ __forceinline__ void add_sample(const T* __restrict__ base,
                                           long long row_stride, int h, int w,
                                           float x, float y, float a,
                                           float (&acc)[V]) {
  float v[4][V], wt[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const long long cell = corner_branch_free(c, h, w, x, y, a, wt[c]);
    VecIO<T, V>::load(base + cell * row_stride, v[c]);
  }
#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int i = 0; i < V; ++i) acc[i] = fmaf(wt[c], v[c][i], acc[i]);
}

template <typename T, int V, int kL, int kP>
__global__ void __launch_bounds__(kThreads)
    msda_topk_fwd_kernel(const T* __restrict__ value,
                         const int* __restrict__ spatial_shapes,
                         const int* __restrict__ level_start,
                         const float* __restrict__ loc,
                         const float* __restrict__ aw,
                         float* __restrict__ out, int B, int S, int M, int D,
                         int Lq, int L, int P, int K) {
  const int groups = D / V;
  const long long items = (long long)B * Lq * M * groups;
  const long long row_stride = (long long)M * D;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < items; i += (long long)gridDim.x * blockDim.x) {
    const long long bqm = i / groups;
    const int g = (int)(i - bqm * groups);
    const int m = (int)(bqm % M);
    const int b = (int)(bqm / ((long long)Lq * M));
    const T* head = value + (long long)b * S * row_stride + (long long)m * D +
                    (long long)g * V;
    float acc[V];
#pragma unroll
    for (int j = 0; j < V; ++j) acc[j] = 0.0f;
    if constexpr (kL > 0) {
      constexpr int kLP = kL * kP;
      float a[kLP], xy[2 * kLP];
      load_floats<kLP>(aw + bqm * kLP, a);
      const unsigned long long keep = rank_fixed<kLP>(a, K);
      load_floats<2 * kLP>(loc + bqm * 2 * kLP, xy);
#pragma unroll
      for (int l = 0; l < kL; ++l) {
        const int h = __ldg(spatial_shapes + 2 * l);
        const int w = __ldg(spatial_shapes + 2 * l + 1);
        const T* base = head + (long long)__ldg(level_start + l) * row_stride;
#pragma unroll
        for (int p = 0; p < kP; ++p) {
          const int k = l * kP + p;
          if ((keep >> k) & 1ull)
            add_sample<T, V>(base, row_stride, h, w, xy[2 * k] * w - 0.5f,
                             xy[2 * k + 1] * h - 0.5f, a[k], acc);
        }
      }
    } else {
      const int LP = L * P;
      const unsigned long long keep = rank_generic(aw + bqm * LP, LP, K);
      for (int l = 0; l < L; ++l) {
        const int h = __ldg(spatial_shapes + 2 * l);
        const int w = __ldg(spatial_shapes + 2 * l + 1);
        const T* base = head + (long long)__ldg(level_start + l) * row_stride;
        for (int p = 0; p < P; ++p) {
          const int k = l * P + p;
          if (!((keep >> k) & 1ull)) continue;
          const long long s = bqm * LP + k;
          add_sample<T, V>(base, row_stride, h, w,
                           __ldg(loc + 2 * s) * w - 0.5f,
                           __ldg(loc + 2 * s + 1) * h - 0.5f, __ldg(aw + s),
                           acc);
        }
      }
    }
    VecIO<float, V>::store(out + bqm * D + (long long)g * V, acc);
  }
}

template <typename T, int V>
static cudaError_t launch_v(const T* value, const int* sh, const int* st,
                            const float* lc, const float* a, float* o, int B,
                            int S, int M, int D, int Lq, int L, int P, int K,
                            bool fixed, cudaStream_t stream) {
  const long long items = (long long)B * Lq * M * (D / V);
  const unsigned blocks =
      (unsigned)std::min<long long>((items + kThreads - 1) / kThreads, 1 << 30);
  auto go = [&](auto kernel) {
    kernel<<<blocks, kThreads, 0, stream>>>(value, sh, st, lc, a, o, B, S, M,
                                            D, Lq, L, P, K);
  };
  if (fixed && L == 2 && P == 2)
    go(msda_topk_fwd_kernel<T, V, 2, 2>);
  else if (fixed && L == 1 && P == 2)
    go(msda_topk_fwd_kernel<T, V, 1, 2>);
  else
    go(msda_topk_fwd_kernel<T, V, 0, 0>);
  return cudaGetLastError();
}

template <typename T>
static cudaError_t launch(const void* value, const void* shapes,
                          const void* starts, const void* loc, const void* aw,
                          void* out, int B, int S, int M, int D, int Lq,
                          int L, int P, int K, cudaStream_t stream) {
  if (L * P > 64 || K < 1) return cudaErrorInvalidValue;
  const T* val = static_cast<const T*>(value);
  const int* sh = static_cast<const int*>(shapes);
  const int* st = static_cast<const int*>(starts);
  const float* lc = static_cast<const float*>(loc);
  const float* a = static_cast<const float*>(aw);
  float* o = static_cast<float*>(out);
  // the fixed instances read a (q, m)'s loc/aw as vectors: 16-byte aligned
  const bool fixed = (uintptr_t)loc % 16 == 0 && (uintptr_t)aw % 16 == 0;
  const int v = pick_vec(D, value, sizeof(T), out, sizeof(float));
  if (v == 4)
    return launch_v<T, 4>(val, sh, st, lc, a, o, B, S, M, D, Lq, L, P, K,
                          fixed, stream);
  if (v == 2)
    return launch_v<T, 2>(val, sh, st, lc, a, o, B, S, M, D, Lq, L, P, K,
                          fixed, stream);
  return launch_v<T, 1>(val, sh, st, lc, a, o, B, S, M, D, Lq, L, P, K, fixed,
                        stream);
}

}  // namespace kinet

// C entry bound with ctypes. Returns the launch's CUDA error (0 if none).
extern "C" int msda_topk_fwd(const void* value, int dtype, const void* shapes,
                             const void* starts, const void* loc,
                             const void* aw, void* out, int B, int S, int M,
                             int D, int Lq, int L, int P, int K,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kinet::kBF16)
    return (int)kinet::launch<__nv_bfloat16>(value, shapes, starts, loc, aw,
                                             out, B, S, M, D, Lq, L, P, K, s);
  if (dtype == kinet::kF32)
    return (int)kinet::launch<float>(value, shapes, starts, loc, aw, out, B,
                                     S, M, D, Lq, L, P, K, s);
  return (int)cudaErrorInvalidValue;
}
