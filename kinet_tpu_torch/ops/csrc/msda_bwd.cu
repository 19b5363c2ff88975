// Multi-scale deformable attention backward (the gradient of msda_fwd.cu).
//
// Replaces the training backward of the TPU kernel
// kinet_tpu/ops/pallas_msda.py::level_sample_matmul (its custom VJP
// _hybrid_bwd recomputes through XLA) and of kinet_tpu/ops/msda.py::
// ms_deform_attn_quad_unroll (the scatter-add VJP _rows_gather_bwd,
// zeros(...).at[rows].add(dg), plus the autodiff of _flat_cell_index):
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
// P], grad_out [B, Lq, M*D] f32. Outputs, each written once: dvalue
// [B, S, M, D] in value's type, dloc and daw f32. Scratch: the int32
// buffer of msda_segment.cuh.
//
// Bound: bytes. The touched rows of value are read once and all of dvalue
// is written once, both in value's type, with grad_out and the samples:
// at the flagship's training shapes in bf16 about 0.0079 ms a launch over
// a step's mix on an H100 (3.35 TB/s). What held the first version to
// about 6 % of that bound was its scatter of dvalue: one f32 atomicAdd
// per channel per corner (19-29 M a launch), all at one shared rate, into
// a zeroed f32 buffer that was then cast. Design now, one entry point enqueuing:
//   - the dots pass (msda_bwd_dots_kernel): one lane per corner of each
//     sample (8 samples a warp, every lane busy); a lane takes its
//     corner's dot product of grad_out with the corner's row of D
//     channels in registers, the 4 lanes of a sample combine them with
//     __shfl_xor_sync, and each lane records its corner for the table
//     gradient (key (b, cell, m), one int atomic; the entries of a warp
//     are stored as one coalesced run);
//   - the segmented reduction of msda_segment.cuh, which writes each row
//     of dvalue once, 36 channels from the f32 grad_out rows of its
//     segment. No floating-point atomics.
#include "msda_segment.cuh"

namespace kinet {

template <typename T, int V>
__global__ void __launch_bounds__(256)
    msda_bwd_dots_kernel(const T* __restrict__ value,
                         const int* __restrict__ spatial_shapes,
                         const int* __restrict__ level_start,
                         const float* __restrict__ loc,
                         const float* __restrict__ aw,
                         const float* __restrict__ grad_out,
                         float* __restrict__ dloc, float* __restrict__ daw,
                         Segments sg, int B, int S, int M, int D, int Lq,
                         int L, int P) {
  // lane e = entry e = (sample s, corner); s = (bqm * L + l) * P + p
  const int n_entries = B * Lq * M * L * P * 4;  // < 2^31: the wrapper
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  // no early return: the 4 lanes of a sample take part in the shuffles
  const bool valid = e < n_entries;
  const int corner = e & 3;
  const int s = valid ? e >> 2 : 0;
  const int bqm = s / (L * P);  // (b * Lq + q) * M + m
  const int l = s / P % L;
  const int m = bqm % M;
  const int b = bqm / (M * Lq);
  const int h = __ldg(spatial_shapes + 2 * l);
  const int w = __ldg(spatial_shapes + 2 * l + 1);
  const float x = __ldg(loc + 2LL * s) * w - 0.5f;
  const float y = __ldg(loc + 2LL * s + 1) * h - 0.5f;
  const float a_w = __ldg(aw + s);
  CornerEntry c;
  if (valid)
    c = count_corner(sg, corner, h, w, x, y, a_w, (float)h, (float)w,
                     (long long)b * S + __ldg(level_start + l), M, m);
  const bool inside = c.key >= 0;
  const float wy = c.wy;
  const float wx = c.wx;
  float dot = 0.0f;
  if (inside) {
    // the corner's row of value is row `key` of D channels
    const T* v_row = value + (long long)c.key * D;
    const float* g_row = grad_out + (long long)bqm * D;
#pragma unroll 3
    for (int i = 0; i < D; i += V) {
      float v[V], g[V];
      VecIO<T, V>::load(v_row + i, v);
      VecIO<float, V>::load(g_row + i, g);
#pragma unroll
      for (int j = 0; j < V; ++j) dot = fmaf(g[j], v[j], dot);
    }
  }
  const int dy = corner >> 1;
  const int dx = corner & 1;
  // the sample's sums over its 4 corner lanes
  float a = group_sum<4>(inside ? wy * wx * dot : 0.0f);
  float bx = group_sum<4>(inside ? (dx ? wy : -wy) * dot : 0.0f);
  float by = group_sum<4>(inside ? (dy ? wx : -wx) * dot : 0.0f);
  if (valid) {
    store_entry(sg, e, c);
    if (corner == 0) {
      daw[s] = a;
      dloc[2LL * s] = a_w * bx * w;
      dloc[2LL * s + 1] = a_w * by * h;
    }
  }
}

template <typename T, int V>
static void launch_dots(const T* value, const int* shapes, const int* starts,
                        const float* loc, const float* aw,
                        const float* grad_out, float* dloc, float* daw,
                        const Segments& sg, int B, int S, int M, int D,
                        int Lq, int L, int P, cudaStream_t stream) {
  const long long lanes = (long long)B * Lq * M * L * P * 4;
  msda_bwd_dots_kernel<T, V><<<blocks_for(lanes, 256), 256, 0, stream>>>(
      value, shapes, starts, loc, aw, grad_out, dloc, daw, sg, B, S, M, D, Lq,
      L, P);
}

template <typename T>
static cudaError_t launch(const void* value_, const void* shapes_,
                          const void* starts_, const void* loc_,
                          const void* aw_, const void* grad_out_,
                          void* dvalue_, void* dloc_, void* daw_,
                          const Segments& sg, int B, int S, int M, int D,
                          int Lq, int L, int P, cudaStream_t stream) {
  const T* value = static_cast<const T*>(value_);
  const int* shapes = static_cast<const int*>(shapes_);
  const int* starts = static_cast<const int*>(starts_);
  const float* loc = static_cast<const float*>(loc_);
  const float* aw = static_cast<const float*>(aw_);
  const float* grad_out = static_cast<const float*>(grad_out_);
  float* dloc = static_cast<float*>(dloc_);
  float* daw = static_cast<float*>(daw_);
  const long long n_keys = (long long)B * S * M;
  const long long n_entries = (long long)B * Lq * M * L * P * 4;

  cudaError_t err = segment_clear(sg, n_keys, stream);
  if (err != cudaSuccess) return err;
  const int v = pick_vec(D, value, sizeof(T), grad_out, sizeof(float));
  if (v == 4)
    launch_dots<T, 4>(value, shapes, starts, loc, aw, grad_out, dloc, daw, sg,
                      B, S, M, D, Lq, L, P, stream);
  else if (v == 2)
    launch_dots<T, 2>(value, shapes, starts, loc, aw, grad_out, dloc, daw, sg,
                      B, S, M, D, Lq, L, P, stream);
  else
    launch_dots<T, 1>(value, shapes, starts, loc, aw, grad_out, dloc, daw, sg,
                      B, S, M, D, Lq, L, P, stream);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return segment_reduce<float, T>(sg, n_keys, n_entries, L * P, grad_out,
                                  static_cast<T*>(dvalue_), D, stream);
}

}  // namespace kinet

// C entry bound with ctypes: enqueues every pass on `stream`. scratch holds
// scratch_ints int32 elements, at least kinet::segment_scratch_ints(B * S
// * M, B * Lq * M * L * P * 4). Returns the first CUDA error of a launch,
// or cudaErrorInvalidValue for an unknown dtype or too small a scratch.
extern "C" int msda_bwd(const void* value, int dtype, const void* shapes,
                        const void* starts, const void* loc, const void* aw,
                        const void* grad_out, void* dvalue, void* dloc,
                        void* daw, void* scratch, long long scratch_ints,
                        int B, int S, int M, int D, int Lq, int L, int P,
                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n_keys = (long long)B * S * M;
  const long long n_entries = (long long)B * Lq * M * L * P * 4;
  if (scratch_ints < kinet::segment_scratch_ints(n_keys, n_entries))
    return (int)cudaErrorInvalidValue;
  const kinet::Segments sg = kinet::carve_segments(scratch, n_keys, n_entries);
  if (dtype == kinet::kBF16)
    return (int)kinet::launch<__nv_bfloat16>(value, shapes, starts, loc, aw,
                                             grad_out, dvalue, dloc, daw, sg,
                                             B, S, M, D, Lq, L, P, s);
  if (dtype == kinet::kF32)
    return (int)kinet::launch<float>(value, shapes, starts, loc, aw,
                                     grad_out, dvalue, dloc, daw, sg, B, S,
                                     M, D, Lq, L, P, s);
  return (int)cudaErrorInvalidValue;
}
