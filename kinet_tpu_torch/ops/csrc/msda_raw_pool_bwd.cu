// Backward of the decoder's gather-then-project pooling
// (msda_raw_pool_fwd.cu).
//
// Replaces the training backward of kinet_tpu/ops/msda.py::
// ms_deform_attn_raw_pool (the scatter-add VJP _rows_gather_bwd,
// zeros(...).at[rows].add(dg), plus the autodiff of _flat_cell_index with
// valid extents). With
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
// Outputs, each written once: dsrc [B, S, C] in src's type, dloc and daw
// f32. Scratch: the int32 buffer of msda_segment.cuh.
//
// Bound: bytes. The touched rows of src are read once and all of dsrc is
// written once, both in src's type, with grad_pooled and the samples: at
// the flagship's training shapes in bf16 about 0.0105 ms a launch on an
// H100 (3.35 TB/s). What held the first version to about 4 % of that
// bound was its scatter of dsrc: one f32 atomicAdd per channel per corner
// (44 M a launch), all at one shared rate, into a zeroed f32 buffer of
// 36 MB that was then cast. Design now, one entry point enqueuing:
//   - the dots pass (msda_raw_pool_bwd_dots_kernel): one warp per
//     (b, q, m, level), each lane taking channel groups lane, lane + 32, ...
//     (C = 288: 72 groups of 4, three passes), the dot products over C
//     reduced with __shfl_xor_sync; lanes 0-3 record the sample's corners
//     for the table gradient (key (b, cell), one int atomic each,
//     whose result the lanes do not wait for);
//   - the segmented reduction of msda_segment.cuh, which writes each row
//     of dsrc once, 288 channels from the grad_pooled rows of its segment
//     (16-byte loads: 8 bf16 channels a thread). No floating-point
//     atomics.
#include "msda_segment.cuh"

namespace kinet {

template <typename T, int V, int G>
__global__ void __launch_bounds__(256) msda_raw_pool_bwd_dots_kernel(
    const T* __restrict__ src, const int* __restrict__ spatial_shapes,
    const int* __restrict__ level_start, const float* __restrict__ loc,
    const float* __restrict__ aw, const float* __restrict__ valid_extents,
    const T* __restrict__ grad_pooled, const float* __restrict__ grad_wsum,
    float* __restrict__ dloc, float* __restrict__ daw, Segments sg, int B,
    int S, int C, int Lq, int M, int L, int P) {
  const int groups = C / V;
  const int iters = (groups + G - 1) / G;
  const long long gtid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = (int)(threadIdx.x & (G - 1));
  const long long total = (long long)B * Lq * M * L;
  // no early return: every lane of the warp takes part in the shuffles
  const bool valid = gtid / G < total;
  const long long bqml = valid ? gtid / G : 0;
  const long long bqm = bqml / L;  // (b * Lq + q) * M + m
  const int l = (int)(bqml % L);
  const int b = (int)(bqm / ((long long)M * Lq));

  const float* loc_p = loc + bqm * L * P * 2;
  const float* aw_p = aw + bqm * L * P;
  const T* go_p = grad_pooled + bqm * C;
  const float gws = __ldg(grad_wsum + bqm);
  const int h = __ldg(spatial_shapes + 2 * l);
  const int w = __ldg(spatial_shapes + 2 * l + 1);
  float vh = (float)h, vw = (float)w;
  if (valid_extents != nullptr) {
    vh = __ldg(valid_extents + ((long long)b * L + l) * 2);
    vw = __ldg(valid_extents + ((long long)b * L + l) * 2 + 1);
  }
  const long long cell0 = (long long)b * S + __ldg(level_start + l);
  const long long row0 = cell0 * C;
  for (int p = 0; p < P; ++p) {
    const int k = l * P + p;
    const float x = __ldg(loc_p + 2 * k) * w - 0.5f;
    const float y = __ldg(loc_p + 2 * k + 1) * h - 0.5f;
    const float a_w = __ldg(aw_p + k);
    const long long o = bqm * L * P + k;
    CornerEntry corner;
    if (valid && lane < 4)
      corner = count_corner(sg, lane, h, w, x, y, a_w, vh, vw, cell0, 1, 0);
    float a = 0.0f, bx = 0.0f, by = 0.0f;
    for (int it = 0; it < iters; ++it) {
      const int g = lane + it * G;
      if (valid && g < groups) {
        float go[V];
        VecIO<T, V>::load(go_p + (long long)g * V, go);
        sample_point_bwd<T, V>(src + row0 + (long long)g * V, C, h, w, x,
                               y, vh, vw, go, a, bx, by);
      }
    }
    if (valid && lane < 4) store_entry(sg, o * 4 + lane, corner);
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
      daw[o] = a;
      dloc[2 * o] = a_w * bx * w;
      dloc[2 * o + 1] = a_w * by * h;
    }
  }
}

template <typename T, int V, int G>
static void launch_g(const T* src, const int* shapes, const int* starts,
                     const float* loc, const float* aw, const float* ext,
                     const T* grad_pooled, const float* grad_wsum,
                     float* dloc, float* daw, const Segments& sg, int B,
                     int S, int C, int Lq, int M, int L, int P,
                     cudaStream_t stream) {
  const long long lanes = (long long)B * Lq * M * L * G;
  const int threads = 256;
  msda_raw_pool_bwd_dots_kernel<T, V, G>
      <<<blocks_for(lanes, threads), threads, 0, stream>>>(
          src, shapes, starts, loc, aw, ext, grad_pooled, grad_wsum, dloc,
          daw, sg, B, S, C, Lq, M, L, P);
}

template <typename T, int V>
static void launch_v(int g, const T* src, const int* shapes,
                     const int* starts, const float* loc, const float* aw,
                     const float* ext, const T* grad_pooled,
                     const float* grad_wsum, float* dloc, float* daw,
                     const Segments& sg, int B, int S, int C, int Lq, int M,
                     int L, int P, cudaStream_t stream) {
  if (g == 32)
    launch_g<T, V, 32>(src, shapes, starts, loc, aw, ext, grad_pooled,
                       grad_wsum, dloc, daw, sg, B, S, C, Lq, M, L, P,
                       stream);
  else if (g == 16)
    launch_g<T, V, 16>(src, shapes, starts, loc, aw, ext, grad_pooled,
                       grad_wsum, dloc, daw, sg, B, S, C, Lq, M, L, P,
                       stream);
  else
    launch_g<T, V, 8>(src, shapes, starts, loc, aw, ext, grad_pooled,
                      grad_wsum, dloc, daw, sg, B, S, C, Lq, M, L, P,
                      stream);
}

template <typename T>
static cudaError_t launch(const void* src_, const void* shapes_,
                          const void* starts_, const void* loc_,
                          const void* aw_, const void* ext_,
                          const void* grad_pooled_, const void* grad_wsum_,
                          void* dsrc_, void* dloc_, void* daw_,
                          const Segments& sg, int B, int S, int C, int Lq,
                          int M, int L, int P, cudaStream_t stream) {
  const T* src = static_cast<const T*>(src_);
  const int* shapes = static_cast<const int*>(shapes_);
  const int* starts = static_cast<const int*>(starts_);
  const float* loc = static_cast<const float*>(loc_);
  const float* aw = static_cast<const float*>(aw_);
  const float* ext = static_cast<const float*>(ext_);
  const T* grad_pooled = static_cast<const T*>(grad_pooled_);
  const float* grad_wsum = static_cast<const float*>(grad_wsum_);
  float* dloc = static_cast<float*>(dloc_);
  float* daw = static_cast<float*>(daw_);
  const long long n_keys = (long long)B * S;
  const long long n_entries = (long long)B * Lq * M * L * P * 4;

  cudaError_t err = segment_clear(sg, n_keys, stream);
  if (err != cudaSuccess) return err;
  const int v = pick_vec(C, src, sizeof(T), grad_pooled, sizeof(T));
  const int g = pick_group(C / v);
  if (v == 4)
    launch_v<T, 4>(g, src, shapes, starts, loc, aw, ext, grad_pooled,
                   grad_wsum, dloc, daw, sg, B, S, C, Lq, M, L, P, stream);
  else if (v == 2)
    launch_v<T, 2>(g, src, shapes, starts, loc, aw, ext, grad_pooled,
                   grad_wsum, dloc, daw, sg, B, S, C, Lq, M, L, P, stream);
  else
    launch_v<T, 1>(g, src, shapes, starts, loc, aw, ext, grad_pooled,
                   grad_wsum, dloc, daw, sg, B, S, C, Lq, M, L, P, stream);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return segment_reduce<T, T>(sg, n_keys, n_entries, L * P, grad_pooled,
                              static_cast<T*>(dsrc_), C, stream);
}

}  // namespace kinet

// C entry bound with ctypes: enqueues every pass on `stream`. scratch holds
// scratch_ints int32 elements, at least kinet::segment_scratch_ints(B * S,
// B * Lq * M * L * P * 4). Returns the first CUDA error of a launch, or
// cudaErrorInvalidValue for an unknown dtype or too small a scratch.
extern "C" int msda_raw_pool_bwd(const void* src, int dtype,
                                 const void* shapes, const void* starts,
                                 const void* loc, const void* aw,
                                 const void* valid_extents,
                                 const void* grad_pooled,
                                 const void* grad_wsum, void* dsrc,
                                 void* dloc, void* daw, void* scratch,
                                 long long scratch_ints, int B, int S, int C,
                                 int Lq, int M, int L, int P, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n_keys = (long long)B * S;
  const long long n_entries = (long long)B * Lq * M * L * P * 4;
  if (scratch_ints < kinet::segment_scratch_ints(n_keys, n_entries))
    return (int)cudaErrorInvalidValue;
  const kinet::Segments sg = kinet::carve_segments(scratch, n_keys, n_entries);
  if (dtype == kinet::kBF16)
    return (int)kinet::launch<__nv_bfloat16>(
        src, shapes, starts, loc, aw, valid_extents, grad_pooled, grad_wsum,
        dsrc, dloc, daw, sg, B, S, C, Lq, M, L, P, s);
  if (dtype == kinet::kF32)
    return (int)kinet::launch<float>(src, shapes, starts, loc, aw,
                                     valid_extents, grad_pooled, grad_wsum,
                                     dsrc, dloc, daw, sg, B, S, C, Lq, M, L,
                                     P, s);
  return (int)cudaErrorInvalidValue;
}
