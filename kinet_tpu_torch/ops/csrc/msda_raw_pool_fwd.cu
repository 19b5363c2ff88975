// Gather-then-project pooling of the decoder's cross-attention.
//
// Replaces kinet_tpu/ops/msda.py::ms_deform_attn_raw_pool (an XLA gather
// over a 4C-wide quad table built by build_raw_quad): it samples RAW,
// pre-projection rows of src directly, per head, and pools them:
//
//   pooled[b, q, m, c] = sum_{l, p, corner} w * src[b, cell, c]
//   wsum[b, q, m]      = sum_{l, p, corner} w
//   w = aw[b,q,m,l,p] * bilinear corner weight, and 0 for a corner outside
//       the level or, when valid_extents is given, at row >= vh or
//       column >= vw of that level (the bottom/right pad region)
//
// The caller applies the value projection after pooling, restoring its
// bias through wsum (exact by linearity).
//
// src [B, S, C] f32 or bf16 with pad rows zeroed by the caller;
// spatial_shapes [L, 2], level_start [L] int32 on the device;
// loc [B, Lq, M, L, P, 2], aw [B, Lq, M, L, P] f32; valid_extents [B, L, 2]
// f32 (vh, vw) or null. Outputs pooled [B, Lq, M, C] in src's dtype
// (accumulated in f32) and wsum [B, Lq, M] f32.
//
// What bounds it on an H100: the corner reads from L2 and their latency,
// not HBM. The flagship's raw table (45,000 tokens x 288 channels, 26 MB
// in bf16) stays in the 50 MB L2, and a query's 8 heads x 4 levels x 2
// points x 4 corners read 256 rows of 576 B: ~88 MB of sectors a launch.
// On the main path's samples the heads of a query share almost no cell
// (distinct rows per query 0.99 of its corners in five of the six decoder
// layers, 0.55 in the first), so the bytes cannot be cut by merging; they
// have to be read faster: with wide loads, and many of them in flight (a
// thread that loops over levels and points known only at run time, with a
// branch per corner, has one sample's corners in flight at a time).
//
// Design (msda_raw_pool_fwd_kernel): one thread per (b, q, m, 16-byte
// channel group), the C/V threads of a (q, m) side by side, so each corner
// row is read as one coalesced run of full 16-byte loads. For the (L, P)
// the decoder launches, (4, 2) and (2, 2), L and P are fixed at compile
// time: a thread reads its (q, m)'s samples as vectors, computes all
// 4 * L * P corners branch-free with corner_at, the corner rule the
// backward kernels use (a corner that is not read loads its level's cell 0
// with weight 0), and has their loads in flight before its first FMA. A
// generic instance covers other (L, P), and 8-, 4- or 2-byte groups other
// widths and alignments.
//
// Over an int8 table (C entry msda_raw_pool_fwd_i8; dec_msda_int8:
// ms_deform_attn_raw_pool with quad_scales, the table from quantize_rows)
// the same kernel replaces the same function: src is int8 with one
// dequantization scale per batch element and level, quad_scales [B, L] f32,
// folded into each corner's pooling weight (w * scale), while wsum sums the
// unscaled w (it restores the projection's bias). A row is 288 bytes at
// C = 288, half the bf16 row, so a launch reads half the corner bytes, in
// 16-byte lanes of 16 channels (18 lanes a row). The row loader (RowIO) is
// the only difference: it keeps a corner's int8 channels as raw words until
// its FMA and converts a channel without I2F (a quarter-rate instruction on
// the SM): its byte, offset by 128, becomes the low byte of the float
// 2^23 + byte (one PRMT), and one FADD takes the offset off, exactly.
// pooled is written in f32 or bf16.
//
// Tried and dropped (PERF.md): one block per query that merges the corner
// pairs its heads and points share and fetches each distinct row once into
// shared memory with cp.async.bulk and mbarriers. On the main path's
// samples it took 1.7x this kernel's time on an H100: it merges almost
// nothing there, and its per-level plan and small bulk copies add latency.
#include "msda_common.cuh"

namespace kinet {

// Only the block size bounds ptxas (see msda_fwd.cu): with a minimum of
// blocks an SM as well, the fixed instances spilled or took 150 registers.
constexpr int kDirectThreads = 256;

struct RawPoolArgs {
  const int* spatial_shapes;
  const int* level_start;
  const float* loc;
  const float* aw;
  const float* valid_extents;
  const float* quad_scales;  // [B, L] for an int8 table, else null
  float* wsum_out;
  int B, S, C, Lq, M, L, P;
};

// V consecutive channels of a table row of TS: Raw holds them between the
// load and the FMA that adds them, weighted, to V f32 sums. A float table
// (f32, bf16) converts at the load; an int8 table keeps its raw words
// (V / 4 of them; V = 1 or 2 keeps its bytes in the low bits of one) and
// is scaled by its level's quad_scales (a float table's scale is 1, which
// the compiler folds away).
template <typename TS, int V>
struct RowIO {
  using Raw = float[V];
  __device__ __forceinline__ static float level_scale(const float*,
                                                      long long) {
    return 1.0f;
  }
  __device__ __forceinline__ static void load(const TS* p, Raw& r) {
    VecIO<TS, V>::load(p, r);
  }
  __device__ __forceinline__ static void fma(float wt, const Raw& r,
                                             float (&acc)[V]) {
#pragma unroll
    for (int i = 0; i < V; ++i) acc[i] = fmaf(wt, r[i], acc[i]);
  }
};

template <int V>
struct RowIO<int8_t, V> {
  static constexpr int kWords = V >= 4 ? V / 4 : 1;
  static constexpr int kPerWord = V >= 4 ? 4 : V;
  using Raw = unsigned int[kWords];
  __device__ __forceinline__ static float level_scale(const float* q,
                                                      long long i) {
    return __ldg(q + i);
  }
  __device__ __forceinline__ static void load(const int8_t* p, Raw& w) {
    if constexpr (V == 16) {
      const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
      w[0] = u.x;
      w[1] = u.y;
      w[2] = u.z;
      w[3] = u.w;
    } else if constexpr (V == 4) {
      w[0] = __ldg(reinterpret_cast<const unsigned int*>(p));
    } else if constexpr (V == 2) {
      w[0] = __ldg(reinterpret_cast<const unsigned short*>(p));
    } else {
      w[0] = (unsigned int)(unsigned char)__ldg(p);
    }
  }
  __device__ __forceinline__ static void fma(float wt, const Raw& w,
                                             float (&acc)[V]) {
#pragma unroll
    for (int j = 0; j < kWords; ++j) {
      const unsigned int f = w[j] ^ 0x80808080u;
#pragma unroll
      for (int k = 0; k < kPerWord; ++k)
        acc[kPerWord * j + k] = fmaf(wt, i8_at(f, k), acc[kPerWord * j + k]);
    }
  }
};

// V f32 sums stored as V channels of TO, in stores of up to 16 bytes.
template <typename TO, int V>
__device__ __forceinline__ void store_channels(TO* p, const float (&acc)[V]) {
  constexpr int kW = V < 16 / (int)sizeof(TO) ? V : 16 / (int)sizeof(TO);
#pragma unroll
  for (int j = 0; j < V; j += kW) VecIO<TO, kW>::store(p + j, acc + j);
}

// The kernel (see the top): a table of TS, pooled written as TO. kL > 0
// fixes L and P at compile time; kL = 0 is the generic instance, one
// sample's corners at a time.
template <typename TS, typename TO, int V, int kL, int kP>
__global__ void __launch_bounds__(kDirectThreads)
    msda_raw_pool_fwd_kernel(const TS* __restrict__ src, RawPoolArgs a,
                             TO* __restrict__ pooled) {
  using Row = RowIO<TS, V>;
  const int groups = a.C / V;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= (long long)a.B * a.Lq * a.M * groups) return;
  const int g = (int)(tid % groups);
  const long long bqm = tid / groups;  // (b * Lq + q) * M + m
  const int b = (int)(bqm / ((long long)a.M * a.Lq));
  const int L = kL > 0 ? kL : a.L;
  const int P = kL > 0 ? kP : a.P;
  const TS* src_b = src + (long long)b * a.S * a.C + (long long)g * V;
  float acc[V];
#pragma unroll
  for (int i = 0; i < V; ++i) acc[i] = 0.0f;
  float wsum = 0.0f;
  if constexpr (kL > 0) {
    constexpr int kLP = kL * kP;
    float xy[2 * kLP], aw[kLP], scale[kL];
    load_floats<2 * kLP>(a.loc + bqm * 2 * kLP, xy);
    load_floats<kLP>(a.aw + bqm * kLP, aw);
    typename Row::Raw v[4 * kLP];
    float wt[4 * kLP];
#pragma unroll
    for (int l = 0; l < kL; ++l) {
      const int h = __ldg(a.spatial_shapes + 2 * l);
      const int w = __ldg(a.spatial_shapes + 2 * l + 1);
      const int start = __ldg(a.level_start + l);
      scale[l] = Row::level_scale(a.quad_scales, (long long)b * kL + l);
      float vh = (float)h, vw = (float)w;
      if (a.valid_extents != nullptr) {
        vh = __ldg(a.valid_extents + ((long long)b * kL + l) * 2);
        vw = __ldg(a.valid_extents + ((long long)b * kL + l) * 2 + 1);
      }
#pragma unroll
      for (int p = 0; p < kP; ++p) {
        const int k = l * kP + p;
        const float x = xy[2 * k] * w - 0.5f;
        const float y = xy[2 * k + 1] * h - 0.5f;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          long long cell;
          float wy, wx;
          const bool in = corner_at(c, h, w, x, y, vh, vw, cell, wy, wx);
          wt[4 * k + c] = in ? wy * wx * aw[k] : 0.0f;
          Row::load(src_b + (start + (in ? cell : 0)) * a.C, v[4 * k + c]);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < 4 * kLP; ++k) {
      Row::fma(wt[k] * scale[k / (4 * kP)], v[k], acc);
      wsum += wt[k];
    }
  } else {
    for (int l = 0; l < L; ++l) {
      const int h = __ldg(a.spatial_shapes + 2 * l);
      const int w = __ldg(a.spatial_shapes + 2 * l + 1);
      const int start = __ldg(a.level_start + l);
      const float scale =
          Row::level_scale(a.quad_scales, (long long)b * L + l);
      float vh = (float)h, vw = (float)w;
      if (a.valid_extents != nullptr) {
        vh = __ldg(a.valid_extents + ((long long)b * L + l) * 2);
        vw = __ldg(a.valid_extents + ((long long)b * L + l) * 2 + 1);
      }
      for (int p = 0; p < P; ++p) {
        const long long k = (bqm * L + l) * P + p;
        const float x = __ldg(a.loc + 2 * k) * w - 0.5f;
        const float y = __ldg(a.loc + 2 * k + 1) * h - 0.5f;
        const float aw = __ldg(a.aw + k);
        typename Row::Raw v[4];
        float wt[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          long long cell;
          float wy, wx;
          const bool in = corner_at(c, h, w, x, y, vh, vw, cell, wy, wx);
          wt[c] = in ? wy * wx * aw : 0.0f;
          Row::load(src_b + (start + (in ? cell : 0)) * a.C, v[c]);
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          Row::fma(wt[c] * scale, v[c], acc);
          wsum += wt[c];
        }
      }
    }
  }
  store_channels<TO, V>(pooled + bqm * a.C + (long long)g * V, acc);
  if (g == 0) a.wsum_out[bqm] = wsum;
}

template <typename TS, typename TO, int V>
static cudaError_t launch_v(const TS* src, const RawPoolArgs& a, TO* pooled,
                            cudaStream_t stream) {
  const long long total = (long long)a.B * a.Lq * a.M * (a.C / V);
  const unsigned blocks =
      (unsigned)((total + kDirectThreads - 1) / kDirectThreads);
  // the fixed instances read a (q, m)'s loc/aw as vectors: 16-byte aligned
  const bool vec = (uintptr_t)a.loc % 16 == 0 && (uintptr_t)a.aw % 16 == 0;
  if (vec && a.L == 4 && a.P == 2)
    msda_raw_pool_fwd_kernel<TS, TO, V, 4, 2>
        <<<blocks, kDirectThreads, 0, stream>>>(src, a, pooled);
  else if (vec && a.L == 2 && a.P == 2)
    msda_raw_pool_fwd_kernel<TS, TO, V, 2, 2>
        <<<blocks, kDirectThreads, 0, stream>>>(src, a, pooled);
  else
    msda_raw_pool_fwd_kernel<TS, TO, V, 0, 0>
        <<<blocks, kDirectThreads, 0, stream>>>(src, a, pooled);
  return cudaGetLastError();
}

template <typename TS, typename TO>
static cudaError_t launch(const void* src, void* pooled, const RawPoolArgs& a,
                          cudaStream_t stream) {
  const TS* s = static_cast<const TS*>(src);
  TO* po = static_cast<TO*>(pooled);
  constexpr int kChunk = 16 / sizeof(TS);  // channels of a 16-byte row load
  if ((uintptr_t)src % 16 == 0 && (uintptr_t)pooled % 16 == 0 &&
      a.C % kChunk == 0)
    return launch_v<TS, TO, kChunk>(s, a, po, stream);
  const int v = pick_vec(a.C, src, sizeof(TS), pooled, sizeof(TO));
  if (v == 4) return launch_v<TS, TO, 4>(s, a, po, stream);
  if (v == 2) return launch_v<TS, TO, 2>(s, a, po, stream);
  return launch_v<TS, TO, 1>(s, a, po, stream);
}

}  // namespace kinet

// C entries bound with ctypes. Each returns the launch's CUDA error (0 if
// none).
static kinet::RawPoolArgs raw_pool_args(const void* shapes, const void* starts,
                                        const void* loc, const void* aw,
                                        const void* valid_extents,
                                        const void* quad_scales, void* wsum,
                                        int B, int S, int C, int Lq, int M,
                                        int L, int P) {
  return {static_cast<const int*>(shapes),
          static_cast<const int*>(starts),
          static_cast<const float*>(loc),
          static_cast<const float*>(aw),
          static_cast<const float*>(valid_extents),
          static_cast<const float*>(quad_scales),
          static_cast<float*>(wsum),
          B, S, C, Lq, M, L, P};
}

// src f32 or bf16 (dtype), pooled in the same dtype.
extern "C" int msda_raw_pool_fwd(const void* src, int dtype,
                                 const void* shapes, const void* starts,
                                 const void* loc, const void* aw,
                                 const void* valid_extents, void* pooled,
                                 void* wsum, int B, int S, int C, int Lq,
                                 int M, int L, int P, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const kinet::RawPoolArgs a = raw_pool_args(
      shapes, starts, loc, aw, valid_extents, nullptr, wsum, B, S, C, Lq, M,
      L, P);
  if (dtype == kinet::kBF16)
    return (int)kinet::launch<__nv_bfloat16, __nv_bfloat16>(src, pooled, a, s);
  if (dtype == kinet::kF32)
    return (int)kinet::launch<float, float>(src, pooled, a, s);
  return (int)cudaErrorInvalidValue;
}

// src int8 [B, S, C], quad_scales [B, L] f32, pooled in out_dtype (f32 or
// bf16).
extern "C" int msda_raw_pool_fwd_i8(const void* src, const void* quad_scales,
                                    int out_dtype, const void* shapes,
                                    const void* starts, const void* loc,
                                    const void* aw,
                                    const void* valid_extents, void* pooled,
                                    void* wsum, int B, int S, int C, int Lq,
                                    int M, int L, int P, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const kinet::RawPoolArgs a = raw_pool_args(
      shapes, starts, loc, aw, valid_extents, quad_scales, wsum, B, S, C, Lq,
      M, L, P);
  if (out_dtype == kinet::kBF16)
    return (int)kinet::launch<int8_t, __nv_bfloat16>(src, pooled, a, s);
  if (out_dtype == kinet::kF32)
    return (int)kinet::launch<int8_t, float>(src, pooled, a, s);
  return (int)cudaErrorInvalidValue;
}
