// Multi-scale deformable attention forward (the encoder's sampling core).
//
// Replaces the TPU kernel kinet_tpu/ops/pallas_msda.py::level_sample_matmul
// (one level at a time, as a one-hot matmul) and its XLA counterpart
// kinet_tpu/ops/msda.py::ms_deform_attn_quad_unroll, over all levels:
//
//   out[b, q, m*D + d] = sum_{l, p} aw[b,q,m,l,p] *
//       bilinear(value[b, level l, m, d] at loc[b,q,m,l,p])
//
// value [B, S, M, D] f32 or bf16; spatial_shapes [L, 2] and level_start [L]
// int32 on the device; loc [B, Lq, M, L, P, 2] and aw [B, Lq, M, L, P] f32;
// out [B, Lq, M*D] f32, accumulated in f32.
//
// What bounds it on an H100: the corner reads from L2 and their latency,
// not HBM. The flagship's value table (22,500 tokens x 288 channels, 13 MB
// in bf16) stays in the 50 MB L2; every corner of every sample reads a
// 72-byte head slice (three 32-byte sectors) from it, 2 flops a channel:
// ~71 MB of sectors a high-lite launch on the main path's samples, ~108 MB
// a low-lite one. A thread that loops over levels and points known only at
// run time, with a branch per corner and three scalar loads per sample, has
// one sample's corners in flight at a time, and 8-byte lanes make a warp
// ask for a slice in many small pieces.
//
// Design:
//   - for the (L, P) the flagship launches, (2, 2) and (1, 2), L and P are
//     fixed at compile time: a thread reads its (q, m)'s L*P*3 floats of
//     loc/aw as vectors, computes every corner branch-free (a corner that
//     is not read gets cell 0 and weight 0) and has all 4*L*P corner loads
//     in flight before its first FMA;
//   - bf16 with D a multiple of 12 (the main path): one thread per 12
//     channels of a head, 3 at D = 36, each reading its 24 bytes of a slice
//     as one 16-byte and one 8-byte load (msda_fwd_wide_kernel); otherwise
//     one thread per V channels (msda_fwd_kernel, 9 x 16 bytes at D = 36 in
//     f32), and a generic instance for other (L, P);
//   - the int8 instance (C entry msda_fwd_i8, enc_msda_int8): value int8
//     [B, S, M, D] with scales [B, M] f32; a head slice is D bytes (36 at
//     the flagship, not a multiple of 8), so a thread takes 4 channels as
//     one 4-byte load where D % 4 == 0, sign-extended to f32; the head's
//     scale multiplies its attention weights once, so every corner weight;
//     sums in f32 (the JAX package sums in the scale's type);
//   - a block walks a run of consecutive queries, as many as spread the
//     launch evenly over the blocks that fit on the card at once: the
//     encoder's queries are raster-ordered tokens whose samples overlap, so
//     the slices a run shares come from the SM's L1 (loads through the
//     read-only path allocate there) rather than L2.
#include <mutex>
#include <type_traits>
#include <vector>

#include "msda_common.cuh"

namespace kinet {

// Only the largest block size bounds ptxas: asked for a minimum of blocks
// an SM as well, it spent more registers (the fixed instances 64-96 instead
// of 48-80) and ran slower.
constexpr int kMaxThreads = 288;

// The int8 instance: each (batch, head)'s dequantization scale multiplies
// the (q, m)'s attention weights, so every corner weight, once.
template <typename T>
constexpr bool kInt8 = std::is_same<T, int8_t>::value;

// Threads of a block: whole queries (per_query threads each) when a
// multiple of 32 of them fits in kMaxThreads, so that a block's passes over
// its run have no idle tail (4 queries x 72, or 12 x 24, at the flagship),
// else 256.
inline int block_threads(int per_query) {
  const int q = kMaxThreads / per_query;
  return q > 0 && (q * per_query) % 32 == 0 ? q * per_query : 256;
}

// Blocks of `kernel` with `threads` threads that fit on the card at once:
// asked of the runtime once per (kernel, device, block size) and kept, so
// that a launch adds no device queries to the host's work.
static long long resident_blocks(const void* kernel, int threads) {
  struct Entry {
    const void* kernel;
    int dev, threads;
    long long slots;
  };
  static std::mutex mu;
  static std::vector<Entry> known;
  int dev = 0;
  cudaGetDevice(&dev);
  std::lock_guard<std::mutex> hold(mu);
  for (const Entry& e : known)
    if (e.kernel == kernel && e.dev == dev && e.threads == threads)
      return e.slots;
  int sms = 1, per_sm = 1;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, 0);
  const long long slots = (long long)sms * (per_sm > 0 ? per_sm : 1);
  known.push_back({kernel, dev, threads, slots});
  return slots;
}

// (blocks, run): as many blocks as fit on the card at once, each walking an
// even share of the queries, `run` consecutive ones.
static void grid_for(const void* kernel, int threads, long long queries,
                     int& run, unsigned& blocks) {
  const long long slots = resident_blocks(kernel, threads);
  run = (int)((queries + slots - 1) / slots);
  blocks = (unsigned)((queries + run - 1) / run);
}

// One (b, q, m, channel group) with L and P fixed at compile time: the
// (q, m)'s samples read as vectors, then all 4*L*P corner loads issued
// before the first FMA.
template <typename T, int V, int kL, int kP>
__device__ __forceinline__ void sample_fixed(
    const T* __restrict__ value, const int* __restrict__ spatial_shapes,
    const int* __restrict__ level_start, const float* __restrict__ loc,
    const float* __restrict__ aw, long long bqm, int b, int m, int g, int S,
    int M, int D, float scale, float (&acc)[V]) {
  constexpr int kLP = kL * kP;
  float xy[2 * kLP], a[kLP];
  load_floats<2 * kLP>(loc + bqm * 2 * kLP, xy);
  load_floats<kLP>(aw + bqm * kLP, a);
  if constexpr (kInt8<T>) {
#pragma unroll
    for (int k = 0; k < kLP; ++k) a[k] *= scale;
  }
  const long long row_stride = (long long)M * D;
  float v[4 * kLP][V];
  float wt[4 * kLP];
#pragma unroll
  for (int l = 0; l < kL; ++l) {
    const int h = __ldg(spatial_shapes + 2 * l);
    const int w = __ldg(spatial_shapes + 2 * l + 1);
    const T* base = value +
                    ((long long)b * S + __ldg(level_start + l)) * row_stride +
                    (long long)m * D + (long long)g * V;
#pragma unroll
    for (int p = 0; p < kP; ++p) {
      const int k = l * kP + p;
      const float x = xy[2 * k] * w - 0.5f;
      const float y = xy[2 * k + 1] * h - 0.5f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const long long cell = corner_branch_free(c, h, w, x, y, a[k],
                                                  wt[4 * k + c]);
        VecIO<T, V>::load(base + cell * row_stride, v[4 * k + c]);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < 4 * kLP; ++k)
#pragma unroll
    for (int i = 0; i < V; ++i) acc[i] = fmaf(wt[k], v[k][i], acc[i]);
}

// The same with L and P known only at run time: one sample's corners in
// flight at a time.
template <typename T, int V>
__device__ __forceinline__ void sample_generic(
    const T* __restrict__ value, const int* __restrict__ spatial_shapes,
    const int* __restrict__ level_start, const float* __restrict__ loc,
    const float* __restrict__ aw, long long bqm, int b, int m, int g, int S,
    int M, int D, int L, int P, float scale, float (&acc)[V]) {
  const long long row_stride = (long long)M * D;
  for (int l = 0; l < L; ++l) {
    const int h = __ldg(spatial_shapes + 2 * l);
    const int w = __ldg(spatial_shapes + 2 * l + 1);
    const T* base = value +
                    ((long long)b * S + __ldg(level_start + l)) * row_stride +
                    (long long)m * D + (long long)g * V;
    for (int p = 0; p < P; ++p) {
      const long long k = bqm * L * P + l * P + p;
      const float x = __ldg(loc + 2 * k) * w - 0.5f;
      const float y = __ldg(loc + 2 * k + 1) * h - 0.5f;
      const float a = kInt8<T> ? __ldg(aw + k) * scale : __ldg(aw + k);
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
  }
}

template <typename T, int V, int kL, int kP>
__global__ void __launch_bounds__(kMaxThreads)
    msda_fwd_kernel(const T* __restrict__ value,
                    const int* __restrict__ spatial_shapes,
                    const int* __restrict__ level_start,
                    const float* __restrict__ loc,
                    const float* __restrict__ aw,
                    const float* __restrict__ scales, float* __restrict__ out,
                    int B, int S, int M, int D, int Lq, int L, int P,
                    int run) {
  const int groups = D / V;
  const int per_query = M * groups;
  const long long q0 = (long long)blockIdx.x * run;
  const long long q_end = min(q0 + run, (long long)B * Lq);
  const long long items = (q_end - q0) * per_query;
  for (long long i = threadIdx.x; i < items; i += blockDim.x) {
    const long long bq = q0 + i / per_query;
    const int r = (int)(i % per_query);
    const int m = r / groups;
    const int g = r - m * groups;
    const int b = (int)(bq / Lq);
    const long long bqm = bq * M + m;
    float scale = 1.0f;
    if constexpr (kInt8<T>) scale = __ldg(scales + (long long)b * M + m);
    float acc[V];
#pragma unroll
    for (int j = 0; j < V; ++j) acc[j] = 0.0f;
    if constexpr (kL > 0)
      sample_fixed<T, V, kL, kP>(value, spatial_shapes, level_start, loc, aw,
                                 bqm, b, m, g, S, M, D, scale, acc);
    else
      sample_generic<T, V>(value, spatial_shapes, level_start, loc, aw, bqm,
                           b, m, g, S, M, D, L, P, scale, acc);
    VecIO<float, V>::store(out + bqm * D + (long long)g * V, acc);
  }
}

// bf16 with D a multiple of 12: one thread per 12 channels of a head
// (three at D = 36). Its 24 bytes of a corner slice start 8-byte aligned
// and are read as one 16-byte and one 8-byte load, the 16-byte one first
// where the start is 16-byte aligned (an even e0 / 4), else second: the
// same two loads on every lane, at other offsets, no branch.
template <int kL, int kP>
__global__ void __launch_bounds__(kMaxThreads)
    msda_fwd_wide_kernel(const __nv_bfloat16* __restrict__ value,
                         const int* __restrict__ spatial_shapes,
                         const int* __restrict__ level_start,
                         const float* __restrict__ loc,
                         const float* __restrict__ aw,
                         float* __restrict__ out, int B, int S, int M, int D,
                         int Lq, int run) {
  constexpr int kLP = kL * kP;
  const int groups = D / 12;
  const int per_query = M * groups;
  const long long q0 = (long long)blockIdx.x * run;
  const long long q_end = min(q0 + run, (long long)B * Lq);
  const long long items = (q_end - q0) * per_query;
  const long long row_stride = (long long)M * D;
  for (long long i = threadIdx.x; i < items; i += blockDim.x) {
    const long long bq = q0 + i / per_query;
    const int r = (int)(i % per_query);
    const int m = r / groups;
    const int e0 = m * D + 12 * (r - m * groups);  // first channel in the row
    const bool odd = (e0 >> 2) & 1;
    const int off16 = odd ? 4 : 0;
    const int off8 = odd ? 0 : 8;
    const int b = (int)(bq / Lq);
    const long long bqm = bq * M + m;
    float xy[2 * kLP], a[kLP];
    load_floats<2 * kLP>(loc + bqm * 2 * kLP, xy);
    load_floats<kLP>(aw + bqm * kLP, a);
    uint4 r16[4 * kLP];
    uint2 r8[4 * kLP];
    float wt[4 * kLP];
#pragma unroll
    for (int l = 0; l < kL; ++l) {
      const int h = __ldg(spatial_shapes + 2 * l);
      const int w = __ldg(spatial_shapes + 2 * l + 1);
      const __nv_bfloat16* base =
          value + ((long long)b * S + __ldg(level_start + l)) * row_stride +
          e0;
#pragma unroll
      for (int p = 0; p < kP; ++p) {
        const int k = l * kP + p;
        const float x = xy[2 * k] * w - 0.5f;
        const float y = xy[2 * k + 1] * h - 0.5f;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const __nv_bfloat16* q =
              base + corner_branch_free(c, h, w, x, y, a[k], wt[4 * k + c]) *
                         row_stride;
          r16[4 * k + c] = __ldg(reinterpret_cast<const uint4*>(q + off16));
          r8[4 * k + c] = __ldg(reinterpret_cast<const uint2*>(q + off8));
        }
      }
    }
    float a16[8], a8[4];
#pragma unroll
    for (int t = 0; t < 8; ++t) a16[t] = 0.0f;
#pragma unroll
    for (int t = 0; t < 4; ++t) a8[t] = 0.0f;
#pragma unroll
    for (int k = 0; k < 4 * kLP; ++k) {
      const unsigned int u[6] = {r16[k].x, r16[k].y, r16[k].z, r16[k].w,
                                 r8[k].x, r8[k].y};
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const float2 f = bf2_to_f2(u[t]);
        a16[2 * t] = fmaf(wt[k], f.x, a16[2 * t]);
        a16[2 * t + 1] = fmaf(wt[k], f.y, a16[2 * t + 1]);
      }
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const float2 f = bf2_to_f2(u[4 + t]);
        a8[2 * t] = fmaf(wt[k], f.x, a8[2 * t]);
        a8[2 * t + 1] = fmaf(wt[k], f.y, a8[2 * t + 1]);
      }
    }
    float o[12];
#pragma unroll
    for (int t = 0; t < 12; ++t)
      o[t] = odd ? (t < 4 ? a8[t] : a16[t - 4]) : (t < 8 ? a16[t] : a8[t - 8]);
    float* dst = out + bq * row_stride + e0;
#pragma unroll
    for (int t = 0; t < 3; ++t)
      VecIO<float, 4>::store(dst + 4 * t, o + 4 * t);
  }
}

template <typename T, int V>
static cudaError_t launch_v(const T* value, const float* scales,
                            const int* sh, const int* st, const float* lc,
                            const float* a, float* o, int B, int S, int M,
                            int D, int Lq, int L, int P, bool fixed,
                            cudaStream_t stream) {
  const int threads = block_threads(M * (D / V));
  int run;
  unsigned blocks;
  auto launch_k = [&](auto kernel) {
    grid_for((const void*)kernel, threads, (long long)B * Lq, run, blocks);
    kernel<<<blocks, threads, 0, stream>>>(value, sh, st, lc, a, scales, o,
                                           B, S, M, D, Lq, L, P, run);
  };
  if (fixed && L == 2)
    launch_k(msda_fwd_kernel<T, V, 2, 2>);
  else if (fixed)
    launch_k(msda_fwd_kernel<T, V, 1, 2>);
  else
    launch_k(msda_fwd_kernel<T, V, 0, 0>);
  return cudaGetLastError();
}

template <typename T>
static cudaError_t launch(const void* value, const float* scales,
                          const void* shapes, const void* starts,
                          const void* loc, const void* aw, void* out, int B,
                          int S, int M, int D, int Lq, int L, int P,
                          cudaStream_t stream) {
  const T* val = static_cast<const T*>(value);
  const int* sh = static_cast<const int*>(shapes);
  const int* st = static_cast<const int*>(starts);
  const float* lc = static_cast<const float*>(loc);
  const float* a = static_cast<const float*>(aw);
  float* o = static_cast<float*>(out);
  // the fixed instances read a (q, m)'s loc/aw as vectors: 16-byte aligned
  const bool fixed = (uintptr_t)loc % 16 == 0 && (uintptr_t)aw % 16 == 0 &&
                     P == 2 && (L == 2 || L == 1);
  if constexpr (sizeof(T) == 2) {
    if (fixed && D % 12 == 0 &&
        (uintptr_t)value % 16 == 0 && (uintptr_t)out % 16 == 0 &&
        ((long long)M * D) % 8 == 0) {
      const int threads = block_threads(M * (D / 12));
      int run;
      unsigned blocks;
      auto launch_k = [&](auto kernel) {
        grid_for((const void*)kernel, threads, (long long)B * Lq, run,
                 blocks);
        kernel<<<blocks, threads, 0, stream>>>(val, sh, st, lc, a, o, B, S,
                                               M, D, Lq, run);
      };
      if (L == 2)
        launch_k(msda_fwd_wide_kernel<2, 2>);
      else
        launch_k(msda_fwd_wide_kernel<1, 2>);
      return cudaGetLastError();
    }
  }
  const int v = pick_vec(D, value, sizeof(T), out, sizeof(float));
  if (v == 4)
    return launch_v<T, 4>(val, scales, sh, st, lc, a, o, B, S, M, D, Lq, L, P,
                          fixed, stream);
  if (v == 2)
    return launch_v<T, 2>(val, scales, sh, st, lc, a, o, B, S, M, D, Lq, L, P,
                          fixed, stream);
  return launch_v<T, 1>(val, scales, sh, st, lc, a, o, B, S, M, D, Lq, L, P,
                        fixed, stream);
}

}  // namespace kinet

// C entry bound with ctypes. Returns the launch's CUDA error (0 if none).
extern "C" int msda_fwd(const void* value, int dtype, const void* shapes,
                        const void* starts, const void* loc, const void* aw,
                        void* out, int B, int S, int M, int D, int Lq, int L,
                        int P, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kinet::kBF16)
    return (int)kinet::launch<__nv_bfloat16>(value, nullptr, shapes, starts,
                                             loc, aw, out, B, S, M, D, Lq, L,
                                             P, s);
  if (dtype == kinet::kF32)
    return (int)kinet::launch<float>(value, nullptr, shapes, starts, loc, aw,
                                     out, B, S, M, D, Lq, L, P, s);
  return (int)cudaErrorInvalidValue;
}

// The int8 instance (enc_msda_int8): value [B, S, M, D] int8, scales [B, M]
// f32, each head's scale folded into its corner weights.
extern "C" int msda_fwd_i8(const void* value, const void* scales,
                           const void* shapes, const void* starts,
                           const void* loc, const void* aw, void* out, int B,
                           int S, int M, int D, int Lq, int L, int P,
                           void* stream) {
  return (int)kinet::launch<int8_t>(
      value, static_cast<const float*>(scales), shapes, starts, loc, aw, out,
      B, S, M, D, Lq, L, P, static_cast<cudaStream_t>(stream));
}
