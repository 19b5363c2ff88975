// Backward of the decoder's gather-then-project pooling
// (msda_raw_pool_fwd.cu).
//
// Replaces the training backward of kinet_tpu/ops/msda.py::
// ms_deform_attn_raw_pool (the scatter-add VJP of _rows_gather plus the
// autodiff of _flat_cell_index with valid extents). With
//   w_c = aw * bil_c   (0 for a corner outside the level or in the
//                       bottom/right pad given by valid_extents)
// and dw_c = <grad_pooled[b,q,m], src_c> + grad_wsum[b,q,m]:
//
//   dsrc[b, cell_c, :]   += w_c * grad_pooled[b, q, m, :]
//   daw[b,q,m,l,p]        = sum_c bil_c * dw_c
//   dloc[b,q,m,l,p,0]     = W_l * aw * sum_c d bil_c/dx * dw_c
//   dloc[b,q,m,l,p,1]     = H_l * aw * sum_c d bil_c/dy * dw_c
//
// No gradient flows into valid_extents.
//
// src [B, S, C] and grad_pooled [B, Lq, M, C] f32 or bf16 (the same type);
// loc, aw, grad_wsum [B, Lq, M] and valid_extents [B, L, 2] (or null) f32.
// Outputs: dsrc [B, S, C] f32, zeroed by the caller and accumulated with
// atomicAdd (run-to-run rounding order); dloc and daw f32.
//
// Bound: bytes. Each sample reads 4 corner rows of C channels and adds 4
// rows into dsrc; all heads of a query read the same rows. Design: one warp
// per (b, q, m), each lane taking channel groups lane, lane + 32, ...
// (C = 288: 72 groups of 4, three passes), the dot products over C reduced
// with __shfl_xor_sync.
#include "msda_common.cuh"

namespace kinet {

template <typename T, int V, int G>
__global__ void __launch_bounds__(256) msda_raw_pool_bwd_kernel(
    const T* __restrict__ src, const int* __restrict__ spatial_shapes,
    const int* __restrict__ level_start, const float* __restrict__ loc,
    const float* __restrict__ aw, const float* __restrict__ valid_extents,
    const T* __restrict__ grad_pooled, const float* __restrict__ grad_wsum,
    float* __restrict__ dsrc, float* __restrict__ dloc,
    float* __restrict__ daw, int B, int S, int C, int Lq, int M, int L,
    int P) {
  const int groups = C / V;
  const int iters = (groups + G - 1) / G;
  const long long gtid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = (int)(threadIdx.x & (G - 1));
  const long long total = (long long)B * Lq * M;
  // no early return: every lane of the warp takes part in the shuffles
  const bool valid = gtid / G < total;
  const long long bqm = valid ? gtid / G : 0;  // (b * Lq + q) * M + m
  const int b = (int)(bqm / ((long long)M * Lq));

  const float* loc_p = loc + bqm * L * P * 2;
  const float* aw_p = aw + bqm * L * P;
  const T* go_p = grad_pooled + bqm * C;
  const float gws = __ldg(grad_wsum + bqm);
  for (int l = 0; l < L; ++l) {
    const int h = __ldg(spatial_shapes + 2 * l);
    const int w = __ldg(spatial_shapes + 2 * l + 1);
    float vh = (float)h, vw = (float)w;
    if (valid_extents != nullptr) {
      vh = __ldg(valid_extents + ((long long)b * L + l) * 2);
      vw = __ldg(valid_extents + ((long long)b * L + l) * 2 + 1);
    }
    const long long row0 = ((long long)b * S + __ldg(level_start + l)) * C;
    for (int p = 0; p < P; ++p) {
      const int k = l * P + p;
      const float x = __ldg(loc_p + 2 * k) * w - 0.5f;
      const float y = __ldg(loc_p + 2 * k + 1) * h - 0.5f;
      const float a_w = __ldg(aw_p + k);
      float a = 0.0f, bx = 0.0f, by = 0.0f;
      for (int it = 0; it < iters; ++it) {
        const int g = lane + it * G;
        if (valid && g < groups) {
          float go[V];
          VecIO<T, V>::load(go_p + (long long)g * V, go);
          sample_point_bwd<T, V>(src + row0 + (long long)g * V,
                                 dsrc + row0 + (long long)g * V, C, h, w, x,
                                 y, a_w, vh, vw, go, a, bx, by);
        }
      }
      a = group_sum<G>(a);
      bx = group_sum<G>(bx);
      by = group_sum<G>(by);
      if (valid && lane == 0) {
        // the weight sum's gradient reaches every corner that was read
        float s, sx, sy;
        corner_weight_sums(h, w, x, y, vh, vw, s, sx, sy);
        a = fmaf(gws, s, a);
        bx = fmaf(gws, sx, bx);
        by = fmaf(gws, sy, by);
        const long long o = bqm * L * P + k;
        daw[o] = a;
        dloc[2 * o] = a_w * bx * w;
        dloc[2 * o + 1] = a_w * by * h;
      }
    }
  }
}

template <typename T, int V, int G>
static void launch_g(const void* src, const void* shapes, const void* starts,
                     const void* loc, const void* aw, const void* ext,
                     const void* grad_pooled, const void* grad_wsum,
                     void* dsrc, void* dloc, void* daw, int B, int S, int C,
                     int Lq, int M, int L, int P, cudaStream_t stream) {
  const long long lanes = (long long)B * Lq * M * G;
  const int threads = 256;
  const unsigned int blocks = (unsigned int)((lanes + threads - 1) / threads);
  msda_raw_pool_bwd_kernel<T, V, G><<<blocks, threads, 0, stream>>>(
      static_cast<const T*>(src), static_cast<const int*>(shapes),
      static_cast<const int*>(starts), static_cast<const float*>(loc),
      static_cast<const float*>(aw), static_cast<const float*>(ext),
      static_cast<const T*>(grad_pooled),
      static_cast<const float*>(grad_wsum), static_cast<float*>(dsrc),
      static_cast<float*>(dloc), static_cast<float*>(daw), B, S, C, Lq, M, L,
      P);
}

template <typename T, int V>
static void launch_v(int g, const void* src, const void* shapes,
                     const void* starts, const void* loc, const void* aw,
                     const void* ext, const void* grad_pooled,
                     const void* grad_wsum, void* dsrc, void* dloc, void* daw,
                     int B, int S, int C, int Lq, int M, int L, int P,
                     cudaStream_t stream) {
  if (g == 32)
    launch_g<T, V, 32>(src, shapes, starts, loc, aw, ext, grad_pooled,
                       grad_wsum, dsrc, dloc, daw, B, S, C, Lq, M, L, P,
                       stream);
  else if (g == 16)
    launch_g<T, V, 16>(src, shapes, starts, loc, aw, ext, grad_pooled,
                       grad_wsum, dsrc, dloc, daw, B, S, C, Lq, M, L, P,
                       stream);
  else
    launch_g<T, V, 8>(src, shapes, starts, loc, aw, ext, grad_pooled,
                      grad_wsum, dsrc, dloc, daw, B, S, C, Lq, M, L, P,
                      stream);
}

template <typename T>
static void launch(const void* src, const void* shapes, const void* starts,
                   const void* loc, const void* aw, const void* ext,
                   const void* grad_pooled, const void* grad_wsum, void* dsrc,
                   void* dloc, void* daw, int B, int S, int C, int Lq, int M,
                   int L, int P, cudaStream_t stream) {
  const int v = pick_vec(C, src, sizeof(T), grad_pooled, sizeof(T));
  const int g = pick_group(C / v);
  if (v == 4)
    launch_v<T, 4>(g, src, shapes, starts, loc, aw, ext, grad_pooled,
                   grad_wsum, dsrc, dloc, daw, B, S, C, Lq, M, L, P, stream);
  else if (v == 2)
    launch_v<T, 2>(g, src, shapes, starts, loc, aw, ext, grad_pooled,
                   grad_wsum, dsrc, dloc, daw, B, S, C, Lq, M, L, P, stream);
  else
    launch_v<T, 1>(g, src, shapes, starts, loc, aw, ext, grad_pooled,
                   grad_wsum, dsrc, dloc, daw, B, S, C, Lq, M, L, P, stream);
}

}  // namespace kinet

// C entry bound with ctypes. dsrc must be zeroed. Returns
// cudaGetLastError() after the launch.
extern "C" int msda_raw_pool_bwd(const void* src, int dtype,
                                 const void* shapes, const void* starts,
                                 const void* loc, const void* aw,
                                 const void* valid_extents,
                                 const void* grad_pooled,
                                 const void* grad_wsum, void* dsrc,
                                 void* dloc, void* daw, int B, int S, int C,
                                 int Lq, int M, int L, int P, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kinet::kBF16)
    kinet::launch<__nv_bfloat16>(src, shapes, starts, loc, aw, valid_extents,
                                 grad_pooled, grad_wsum, dsrc, dloc, daw, B,
                                 S, C, Lq, M, L, P, s);
  else if (dtype == kinet::kF32)
    kinet::launch<float>(src, shapes, starts, loc, aw, valid_extents,
                         grad_pooled, grad_wsum, dsrc, dloc, daw, B, S, C,
                         Lq, M, L, P, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
