// Multi-scale deformable attention backward (the gradient of msda_fwd.cu).
//
// Replaces the training backward of the TPU kernel
// kinet_tpu/ops/pallas_msda.py::level_sample_matmul (its custom VJP
// recomputes through XLA) and of kinet_tpu/ops/msda.py::
// ms_deform_attn_quad_unroll (the scatter-add VJP of _rows_gather plus the
// autodiff of _flat_cell_index):
//
//   dvalue[b, cell, m, d] += aw * bil_c * grad_out[b, q, m*D + d]
//   daw[b,q,m,l,p]        = sum_c bil_c * <grad_out[b,q,m], v_c>
//   dloc[b,q,m,l,p,0]     = W_l * aw * sum_c d bil_c/dx * <grad_out, v_c>
//   dloc[b,q,m,l,p,1]     = H_l * aw * sum_c d bil_c/dy * <grad_out, v_c>
//
// over the 4 bilinear corners c of each sample; a corner outside the level
// weighs 0 in every term (grid_sample's zeros padding).
//
// value [B, S, M, D] f32 or bf16; loc [B, Lq, M, L, P, 2], aw [B, Lq, M, L,
// P], grad_out [B, Lq, M*D] f32. Outputs: dvalue [B, S, M, D] f32, zeroed
// by the caller and accumulated with atomicAdd (the summation order, and so
// the last bits, change from run to run); dloc and daw f32, written once.
//
// Bound: bytes, as the forward: each sample reads 4 corner rows of D
// channels and adds 4 rows into dvalue. Design: one group of G lanes (G a
// power of two, 16 at D = 36 with 4 channels a lane) per (b, q, m), inside
// one warp, so the per-sample dot products over a head's channels reduce
// with __shfl_xor_sync and no shared memory; a lane takes channel groups
// lane, lane + G, ... when a head has more than G * 4 channels.
#include "msda_common.cuh"

namespace kinet {

template <typename T, int V, int G>
__global__ void __launch_bounds__(256)
    msda_bwd_kernel(const T* __restrict__ value,
                    const int* __restrict__ spatial_shapes,
                    const int* __restrict__ level_start,
                    const float* __restrict__ loc,
                    const float* __restrict__ aw,
                    const float* __restrict__ grad_out,
                    float* __restrict__ dvalue, float* __restrict__ dloc,
                    float* __restrict__ daw, int B, int S, int M, int D,
                    int Lq, int L, int P) {
  const int groups = D / V;
  const int iters = (groups + G - 1) / G;
  const long long gtid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = (int)(threadIdx.x & (G - 1));
  const long long total = (long long)B * Lq * M;
  // no early return: every lane of the warp takes part in the shuffles
  const bool valid = gtid / G < total;
  const long long bqm = valid ? gtid / G : 0;  // (b * Lq + q) * M + m
  const int m = (int)(bqm % M);
  const int b = (int)(bqm / ((long long)M * Lq));

  const float* loc_p = loc + bqm * L * P * 2;
  const float* aw_p = aw + bqm * L * P;
  const float* go_p = grad_out + bqm * D;
  const long long row_stride = (long long)M * D;
  for (int l = 0; l < L; ++l) {
    const int h = __ldg(spatial_shapes + 2 * l);
    const int w = __ldg(spatial_shapes + 2 * l + 1);
    const long long row0 =
        ((long long)b * S + __ldg(level_start + l)) * row_stride +
        (long long)m * D;
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
          VecIO<float, V>::load(go_p + (long long)g * V, go);
          sample_point_bwd<T, V>(value + row0 + (long long)g * V,
                                 dvalue + row0 + (long long)g * V,
                                 row_stride, h, w, x, y, a_w, (float)h,
                                 (float)w, go, a, bx, by);
        }
      }
      a = group_sum<G>(a);
      bx = group_sum<G>(bx);
      by = group_sum<G>(by);
      if (valid && lane == 0) {
        const long long s = bqm * L * P + k;
        daw[s] = a;
        dloc[2 * s] = a_w * bx * w;
        dloc[2 * s + 1] = a_w * by * h;
      }
    }
  }
}

template <typename T, int V, int G>
static void launch_g(const void* value, const void* shapes,
                     const void* starts, const void* loc, const void* aw,
                     const void* grad_out, void* dvalue, void* dloc,
                     void* daw, int B, int S, int M, int D, int Lq, int L,
                     int P, cudaStream_t stream) {
  const long long lanes = (long long)B * Lq * M * G;
  const int threads = 256;
  const unsigned int blocks = (unsigned int)((lanes + threads - 1) / threads);
  msda_bwd_kernel<T, V, G><<<blocks, threads, 0, stream>>>(
      static_cast<const T*>(value), static_cast<const int*>(shapes),
      static_cast<const int*>(starts), static_cast<const float*>(loc),
      static_cast<const float*>(aw), static_cast<const float*>(grad_out),
      static_cast<float*>(dvalue), static_cast<float*>(dloc),
      static_cast<float*>(daw), B, S, M, D, Lq, L, P);
}

template <typename T, int V>
static void launch_v(int g, const void* value, const void* shapes,
                     const void* starts, const void* loc, const void* aw,
                     const void* grad_out, void* dvalue, void* dloc,
                     void* daw, int B, int S, int M, int D, int Lq, int L,
                     int P, cudaStream_t stream) {
  if (g == 32)
    launch_g<T, V, 32>(value, shapes, starts, loc, aw, grad_out, dvalue, dloc,
                       daw, B, S, M, D, Lq, L, P, stream);
  else if (g == 16)
    launch_g<T, V, 16>(value, shapes, starts, loc, aw, grad_out, dvalue, dloc,
                       daw, B, S, M, D, Lq, L, P, stream);
  else
    launch_g<T, V, 8>(value, shapes, starts, loc, aw, grad_out, dvalue, dloc,
                      daw, B, S, M, D, Lq, L, P, stream);
}

template <typename T>
static void launch(const void* value, const void* shapes, const void* starts,
                   const void* loc, const void* aw, const void* grad_out,
                   void* dvalue, void* dloc, void* daw, int B, int S, int M,
                   int D, int Lq, int L, int P, cudaStream_t stream) {
  const int v = pick_vec(D, value, sizeof(T), grad_out, sizeof(float));
  const int g = pick_group(D / v);
  if (v == 4)
    launch_v<T, 4>(g, value, shapes, starts, loc, aw, grad_out, dvalue, dloc,
                   daw, B, S, M, D, Lq, L, P, stream);
  else if (v == 2)
    launch_v<T, 2>(g, value, shapes, starts, loc, aw, grad_out, dvalue, dloc,
                   daw, B, S, M, D, Lq, L, P, stream);
  else
    launch_v<T, 1>(g, value, shapes, starts, loc, aw, grad_out, dvalue, dloc,
                   daw, B, S, M, D, Lq, L, P, stream);
}

}  // namespace kinet

// C entry bound with ctypes. dvalue must be zeroed. Returns
// cudaGetLastError() after the launch.
extern "C" int msda_bwd(const void* value, int dtype, const void* shapes,
                        const void* starts, const void* loc, const void* aw,
                        const void* grad_out, void* dvalue, void* dloc,
                        void* daw, int B, int S, int M, int D, int Lq, int L,
                        int P, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kinet::kBF16)
    kinet::launch<__nv_bfloat16>(value, shapes, starts, loc, aw, grad_out,
                                 dvalue, dloc, daw, B, S, M, D, Lq, L, P, s);
  else if (dtype == kinet::kF32)
    kinet::launch<float>(value, shapes, starts, loc, aw, grad_out, dvalue,
                         dloc, daw, B, S, M, D, Lq, L, P, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
