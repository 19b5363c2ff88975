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
// the same function has its own kernel, msda_raw_pool_fwd_i8_kernel: src is
// int8 with one dequantization scale per batch element and level,
// quad_scales [B, L] f32, folded into each corner's pooling weight
// (w * scale), while wsum sums the unscaled w (it restores the projection's
// bias). A row is 288 bytes at C = 288, half the bf16 row, so a launch reads
// half the corner bytes; what bounds it instead is the instruction stream. A
// channel costs an FMA and its conversion without I2F (a quarter-rate
// instruction on the SM): its byte, offset by 128, becomes the low byte of
// the float 2^23 + byte (one PRMT), and one FADD takes the offset off,
// exactly. On an H100 at the served shapes the conversions and FMAs alone
// (every corner an L1 hit) take as long as the whole kernel, the corner
// loads alone 0.6 of it (PERF.md). The design cuts the instructions around
// them:
//   - a block holds whole (b, q, m) pairs and first plans their corners
//     once, a thread a sample, into shared memory: the row, the pooling
//     weight and w of every corner (corner_at's rule: a corner that is not
//     read loads its level's cell 0 with weight 0). The direct kernel's
//     lanes each computed all of their pair's corners again;
//   - then a lane of V channels (16 int8 channels, one 16-byte load: 18
//     lanes a row at C = 288; 8, 4, 2 or 1 where C or the pointers allow no
//     wider) reads the plan as int4 vectors, loads 16 corners, one
//     IMAD.WIDE.U32 an address, and adds them in the plan's order; lane 0
//     sums the weights. The products and the order of the sums are the
//     direct kernel's, so the results are its bits;
//   - blocks of 16 pairs (288 threads) where a launch fills two waves of
//     them, else 8 (i8_pick): the served B = 1 launch is one wave, which
//     blocks of 8 spread more evenly over the SMs.
// ptxas keeps the kernel at 72 registers and ~3 loads in flight a thread
// whatever the grouping. Tried on the served shapes and dropped (PERF.md;
// the direct kernel's 80 registers gave it 3 blocks an SM, so occupancy was
// not what held it back): 8 or 32 corners a group, 8-byte lanes, register
// double buffers, cp.async rings in shared memory (they take L1's room),
// prefetch.global.L1 (2x slower), loads that bypass L1 (1.4x), an f16x2
// conversion and a sign-extending PRMT with I2FP (more instructions).
// pooled is written in f32 or bf16. The direct kernel's int8 instances stay
// as the C entry msda_raw_pool_fwd_i8_direct, the yardstick that
// chip_smoke.py times K1 against on the same calls.
//
// Tried and dropped (PERF.md): one block per query that merges the corner
// pairs its heads and points share and fetches each distinct row once into
// shared memory with cp.async.bulk and mbarriers. On the main path's
// samples it took 1.7x this kernel's time on an H100: it merges almost
// nothing there, and its per-level plan and small bulk copies add latency.
#include <mutex>
#include <vector>

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
    } else if constexpr (V == 8) {
      const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
      w[0] = u.x;
      w[1] = u.y;
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

// ---------------------------------------------------------------------------
// K1: the int8 table's own kernel (msda_raw_pool_fwd_i8_kernel; see the top)

constexpr int kI8MaxThreads = 288;  // a block: whole pairs, at most this many
constexpr int kI8MaxPairs = 32;     // threads and pairs
constexpr int kI8Group = 16;        // corners a lane loads before its FMAs
constexpr size_t kI8MaxPlan = 48 * 1024;

// Corners of a pair in the plan: 4 * L * P rounded up to whole groups (the
// padding reads row 0 with weight 0).
__host__ __device__ __forceinline__ int i8_plan_corners(int L, int P) {
  return (4 * L * P + kI8Group - 1) / kI8Group * kI8Group;
}

// Ints a pair's plan takes in each array: 4 more than its corners, so that
// the int4 reads of neighbouring pairs fall on other banks.
__host__ __device__ __forceinline__ int i8_plan_stride(int L, int P) {
  return i8_plan_corners(L, P) + 4;
}

// The plan: each sample's four corners (corner_at's rule) for the block's
// pairs, a thread a sample, into shared memory: the table row (level start
// + cell, or + 0 where the corner is not read), the pooling weight (w times
// the level's scale, the product the direct kernel forms) and w (for wsum).
template <int kL, int kP>
__device__ __forceinline__ void plan_corners(const RawPoolArgs& a,
                                             long long p0, int pairs,
                                             int* rows, float* wpool,
                                             float* wraw) {
  const int L = kL > 0 ? kL : a.L;
  const int P = kL > 0 ? kP : a.P;
  const int LP = L * P;
  const int stride = i8_plan_stride(L, P);
  const long long total = (long long)a.B * a.Lq * a.M;
  for (int s = threadIdx.x; s < pairs * LP; s += blockDim.x) {
    const int pl = s / LP;
    const int k = s - pl * LP;
    const long long bqm = p0 + pl;
    if (bqm >= total) break;
    const int b = (int)(bqm / ((long long)a.M * a.Lq));
    const int l = k / P;
    const int h = __ldg(a.spatial_shapes + 2 * l);
    const int w = __ldg(a.spatial_shapes + 2 * l + 1);
    const int start = __ldg(a.level_start + l);
    const float scale = __ldg(a.quad_scales + (long long)b * L + l);
    float vh = (float)h, vw = (float)w;
    if (a.valid_extents != nullptr) {
      vh = __ldg(a.valid_extents + ((long long)b * L + l) * 2);
      vw = __ldg(a.valid_extents + ((long long)b * L + l) * 2 + 1);
    }
    const long long i = bqm * LP + k;
    const float x = __ldg(a.loc + 2 * i) * w - 0.5f;
    const float y = __ldg(a.loc + 2 * i + 1) * h - 0.5f;
    const float aw = __ldg(a.aw + i);
    const int e = pl * stride + 4 * k;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      long long cell;
      float wy, wx;
      const bool in = corner_at(c, h, w, x, y, vh, vw, cell, wy, wx);
      const float wt = in ? wy * wx * aw : 0.0f;
      rows[e + c] = start + (in ? (int)cell : 0);
      wpool[e + c] = wt * scale;
      wraw[e + c] = wt;
    }
    if (k == LP - 1) {
      for (int j = pl * stride + 4 * LP; j < pl * stride + stride - 4; ++j) {
        rows[j] = 0;
        wpool[j] = 0.0f;
        wraw[j] = 0.0f;
      }
    }
  }
}

// A lane's loads of kI8Group planned corners: row * C + the lane's offset
// from the batch element's table, one IMAD.WIDE.U32 an address (rows are
// >= 0).
template <int V>
__device__ __forceinline__ void load_group(
    const int8_t* src_b, int C, const int* rows,
    typename RowIO<int8_t, V>::Raw (&v)[kI8Group]) {
  const unsigned c = (unsigned)C;
#pragma unroll
  for (int j = 0; j < kI8Group; j += 4) {
    const int4 r = *reinterpret_cast<const int4*>(rows + j);
    RowIO<int8_t, V>::load(src_b + (unsigned long long)(unsigned)r.x * c, v[j]);
    RowIO<int8_t, V>::load(src_b + (unsigned long long)(unsigned)r.y * c,
                           v[j + 1]);
    RowIO<int8_t, V>::load(src_b + (unsigned long long)(unsigned)r.z * c,
                           v[j + 2]);
    RowIO<int8_t, V>::load(src_b + (unsigned long long)(unsigned)r.w * c,
                           v[j + 3]);
  }
}

// Their FMAs, in the plan's order, with the planned pooling weights.
template <int V>
__device__ __forceinline__ void fma_group(
    const float* wpool, const typename RowIO<int8_t, V>::Raw (&v)[kI8Group],
    float (&acc)[V]) {
#pragma unroll
  for (int j = 0; j < kI8Group; j += 4) {
    const float4 t = *reinterpret_cast<const float4*>(wpool + j);
    RowIO<int8_t, V>::fma(t.x, v[j], acc);
    RowIO<int8_t, V>::fma(t.y, v[j + 1], acc);
    RowIO<int8_t, V>::fma(t.z, v[j + 2], acc);
    RowIO<int8_t, V>::fma(t.w, v[j + 3], acc);
  }
}

// The kernel (see the top): `pairs` pairs a block, V int8 channels a lane;
// kL > 0 fixes L and P at compile time, kL = 0 is the generic instance.
template <typename TO, int V, int kL, int kP>
__global__ void __launch_bounds__(kI8MaxThreads)
    msda_raw_pool_fwd_i8_kernel(const int8_t* __restrict__ src, RawPoolArgs a,
                                TO* __restrict__ pooled, int pairs) {
  extern __shared__ __align__(16) int plan[];
  const int L = kL > 0 ? kL : a.L;
  const int P = kL > 0 ? kP : a.P;
  const int kpad = i8_plan_corners(L, P);
  const int stride = i8_plan_stride(L, P);
  int* rows_s = plan;
  float* wpool_s = reinterpret_cast<float*>(plan + pairs * stride);
  float* wraw_s = wpool_s + pairs * stride;
  const long long p0 = (long long)blockIdx.x * pairs;
  plan_corners<kL, kP>(a, p0, pairs, rows_s, wpool_s, wraw_s);
  __syncthreads();
  const int groups = a.C / V;
  const long long total = (long long)a.B * a.Lq * a.M;
  for (int i = threadIdx.x; i < pairs * groups; i += blockDim.x) {
    const int pl = i / groups;
    const int g = i - pl * groups;
    const long long bqm = p0 + pl;
    if (bqm >= total) break;
    const int b = (int)(bqm / ((long long)a.M * a.Lq));
    const int8_t* src_b = src + (long long)b * a.S * a.C + (long long)g * V;
    const int* rows = rows_s + pl * stride;
    const float* wpool = wpool_s + pl * stride;
    float acc[V];
#pragma unroll
    for (int j = 0; j < V; ++j) acc[j] = 0.0f;
#pragma unroll 1
    for (int k0 = 0; k0 < kpad; k0 += kI8Group) {
      typename RowIO<int8_t, V>::Raw v[kI8Group];
      load_group<V>(src_b, a.C, rows + k0, v);
      fma_group<V>(wpool + k0, v, acc);
    }
    store_channels<TO, V>(pooled + bqm * a.C + (long long)g * V, acc);
    if (g == 0) {  // the unscaled weights, in the same order
      const float* wraw = wraw_s + pl * stride;
      float wsum = 0.0f;
      for (int k = 0; k < 4 * L * P; k += 4) {
        const float4 t = *reinterpret_cast<const float4*>(wraw + k);
        wsum += t.x;
        wsum += t.y;
        wsum += t.z;
        wsum += t.w;
      }
      a.wsum_out[bqm] = wsum;
    }
  }
}

template <typename TO>
using I8Kernel = void (*)(const int8_t*, RawPoolArgs, TO*, int);

// The instance for (L, P): (4, 2) and (2, 2) fixed, else generic.
template <typename TO, int V>
static I8Kernel<TO> i8_kernel(int L, int P) {
  if (L == 4 && P == 2) return msda_raw_pool_fwd_i8_kernel<TO, V, 4, 2>;
  if (L == 2 && P == 2) return msda_raw_pool_fwd_i8_kernel<TO, V, 2, 2>;
  return msda_raw_pool_fwd_i8_kernel<TO, V, 0, 0>;
}

// Blocks of `kernel` with `threads` threads and `smem` shared bytes that fit
// on the card at once, asked of the runtime once per (kernel, device, block
// size) and kept.
static long long i8_slots(const void* kernel, int threads, size_t smem) {
  struct Entry {
    const void* kernel;
    int dev, threads;
    size_t smem;
    long long slots;
  };
  static std::mutex mu;
  static std::vector<Entry> known;
  int dev = 0;
  cudaGetDevice(&dev);
  std::lock_guard<std::mutex> hold(mu);
  for (const Entry& e : known)
    if (e.kernel == kernel && e.dev == dev && e.threads == threads &&
        e.smem == smem)
      return e.slots;
  int sms = 1, per_sm = 1;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                smem);
  const long long slots = (long long)sms * (per_sm > 0 ? per_sm : 1);
  known.push_back({kernel, dev, threads, smem, slots});
  return slots;
}

// One K1 launch's shape.
struct I8Shape {
  int pairs, threads;
  size_t smem;
  long long blocks;
};

inline I8Shape i8_shape(const RawPoolArgs& a, int V, int pairs) {
  const int groups = a.C / V;
  const long long total = (long long)a.B * a.Lq * a.M;
  return {pairs,
          pairs * groups < kI8MaxThreads ? pairs * groups : kI8MaxThreads,
          (size_t)3 * pairs * i8_plan_stride(a.L, a.P) * sizeof(int),
          (total + pairs - 1) / pairs};
}

// The launch: blocks of as many whole pairs as fit in kI8MaxThreads threads
// (16 at C = 288) where they fill at least two waves of the card, else half
// as many, so that a launch of one wave spreads evenly: the served B = 1
// launch takes 600 blocks of 8 pairs, 4-5 an SM (300 of 16 would put 2 or
// 3 on an SM), a B = 4 launch 1200 of 16. Fewer pairs where their plan
// would not fit in kI8MaxPlan bytes.
inline I8Shape i8_pick(const RawPoolArgs& a, int V, const void* kernel) {
  const int groups = a.C / V;
  int full = groups >= kI8MaxThreads ? 1 : kI8MaxThreads / groups;
  if (full > kI8MaxPairs) full = kI8MaxPairs;
  const int fit =
      (int)(kI8MaxPlan / (3 * i8_plan_stride(a.L, a.P) * sizeof(int)));
  if (full > fit) full = fit;
  if (full < 1) return {0, 0, 0, 0};
  const I8Shape big = i8_shape(a, V, full);
  if (full == 1 || big.blocks >= 2 * i8_slots(kernel, big.threads, big.smem))
    return big;
  return i8_shape(a, V, full / 2);
}

template <typename TO, int V>
static cudaError_t launch_i8_v(const int8_t* src, const RawPoolArgs& a,
                               TO* pooled, cudaStream_t stream) {
  const I8Kernel<TO> kernel = i8_kernel<TO, V>(a.L, a.P);
  const I8Shape s = i8_pick(a, V, (const void*)kernel);
  if (s.pairs < 1 || s.blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  kernel<<<(unsigned)s.blocks, s.threads, s.smem, stream>>>(src, a, pooled,
                                                          s.pairs);
  return cudaGetLastError();
}

// K1's lanes: the widest of 16, 8, 4, 2 and 1 int8 channels that C and the
// pointers allow (a lane's pooled store needs min(V, 16 / sizeof(TO))
// channels' alignment).
template <typename TO>
static int i8_vec(const RawPoolArgs& a, const void* src, const void* pooled) {
  const int cands[5] = {16, 8, 4, 2, 1};
  for (int v : cands) {
    const int kw = v < 16 / (int)sizeof(TO) ? v : 16 / (int)sizeof(TO);
    if (a.C % v == 0 && (uintptr_t)src % v == 0 &&
        (uintptr_t)pooled % ((uintptr_t)kw * sizeof(TO)) == 0)
      return v;
  }
  return 1;
}

template <typename TO>
static cudaError_t launch_i8(const void* src, void* pooled,
                             const RawPoolArgs& a, cudaStream_t stream) {
  const int8_t* s = static_cast<const int8_t*>(src);
  TO* po = static_cast<TO*>(pooled);
  const int v = i8_vec<TO>(a, src, pooled);
  if (v == 16) return launch_i8_v<TO, 16>(s, a, po, stream);
  if (v == 8) return launch_i8_v<TO, 8>(s, a, po, stream);
  if (v == 4) return launch_i8_v<TO, 4>(s, a, po, stream);
  if (v == 2) return launch_i8_v<TO, 2>(s, a, po, stream);
  return launch_i8_v<TO, 1>(s, a, po, stream);
}

// What a launch with aligned pointers runs, for chip_smoke.py: out[7] =
// registers, local (spilled) bytes, threads, shared bytes and resident
// blocks an SM of the kernel, pairs a block and blocks of the launch; of
// K1's kernel, or (direct) of the direct kernel's int8 instance.
static void kernel_facts(const void* kernel, int threads, size_t smem,
                         int* out) {
  cudaFuncAttributes attr;
  cudaFuncGetAttributes(&attr, kernel);
  int per_sm = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                smem);
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = threads;
  out[3] = (int)smem;
  out[4] = per_sm;
}

template <typename TO, int V>
static void i8_facts_v(const RawPoolArgs& a, bool direct, int* out) {
  const long long total = (long long)a.B * a.Lq * a.M;
  if (direct) {
    const bool fixed = (a.L == 4 || a.L == 2) && a.P == 2;
    const void* k =
        !fixed ? (const void*)msda_raw_pool_fwd_kernel<int8_t, TO, V, 0, 0>
        : a.L == 4 ? (const void*)msda_raw_pool_fwd_kernel<int8_t, TO, V, 4, 2>
                   : (const void*)msda_raw_pool_fwd_kernel<int8_t, TO, V, 2, 2>;
    kernel_facts(k, kDirectThreads, 0, out);
    out[5] = 0;  // the direct kernel's blocks hold threads, not whole pairs
    out[6] = (int)((total * (a.C / V) + kDirectThreads - 1) / kDirectThreads);
    return;
  }
  const void* kernel = (const void*)i8_kernel<TO, V>(a.L, a.P);
  const I8Shape s = i8_pick(a, V, kernel);
  kernel_facts(kernel, s.threads, s.smem, out);
  out[5] = s.pairs;
  out[6] = (int)s.blocks;
}

template <typename TO>
static void i8_facts(const RawPoolArgs& a, bool direct, int* out) {
  if (a.C % 16 == 0) return i8_facts_v<TO, 16>(a, direct, out);
  return i8_facts_v<TO, 4>(a, direct, out);
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
    return (int)kinet::launch_i8<__nv_bfloat16>(src, pooled, a, s);
  if (out_dtype == kinet::kF32)
    return (int)kinet::launch_i8<float>(src, pooled, a, s);
  return (int)cudaErrorInvalidValue;
}

// The direct kernel's int8 instances (msda_raw_pool_fwd_kernel<int8_t, ..>),
// K1's kernel before it had its own: the same arguments and results.
extern "C" int msda_raw_pool_fwd_i8_direct(
    const void* src, const void* quad_scales, int out_dtype,
    const void* shapes, const void* starts, const void* loc, const void* aw,
    const void* valid_extents, void* pooled, void* wsum, int B, int S, int C,
    int Lq, int M, int L, int P, void* stream) {
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

// out[7]: registers, local (spilled) bytes, threads, shared bytes and
// resident blocks an SM of the kernel that a launch of (B, Lq, M, C, L, P)
// with aligned pointers runs, pairs a block and blocks: K1's own kernel,
// or with `direct` the direct kernel's int8 instance.
extern "C" int msda_raw_pool_fwd_i8_facts(int out_dtype, int direct, int B,
                                          int Lq, int M, int C, int L, int P,
                                          int* out) {
  kinet::RawPoolArgs a{};
  a.B = B;
  a.Lq = Lq;
  a.M = M;
  a.C = C;
  a.L = L;
  a.P = P;
  if (out_dtype == kinet::kBF16)
    kinet::i8_facts<__nv_bfloat16>(a, direct != 0, out);
  else if (out_dtype == kinet::kF32)
    kinet::i8_facts<float>(a, direct != 0, out);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
