// Multi-scale deformable attention forward (the encoder's sampling core),
// with its int8, head-shared and top-k instances.
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
// out [B, Lq, M*D] f32, accumulated in f32. Three more C entries share the
// kernels:
//   - msda_fwd_i8 (enc_msda_int8; X1 with value_scale): value int8 with one
//     dequantization scale per (batch, head), scales [B, M] f32, which
//     multiplies the (q, m)'s attention weights once, so every corner
//     weight; sums in f32 (the JAX package sums in the scale's type);
//   - msda_shared_fwd (enc_msda_shared_locs; replaces
//     kinet_tpu/ops/msda.py::ms_deform_attn_patch_shared): every head
//     samples the query's locations loc [B, Lq, L, P, 2], each with its own
//     weights. A sample's corners are then whole M*D rows (576 bytes in bf16
//     at hidden 288), read by all of a query's heads at once;
//   - msda_topk_fwd (enc_msda_topk; replaces
//     kinet_tpu/ops/msda.py::ms_deform_attn_topk_quad): per (q, m) only the
//     K samples of largest weight, ties to the lower (level, point) index
//     (jax.lax.top_k's order, a stable descending sort: a fresh model's
//     softmax ties every sample). A thread ranks its (q, m)'s weights in
//     registers (a sample's rank is the count of samples with a larger
//     weight, or an equal one at a lower index; it is kept iff rank < K)
//     and reads nothing of a dropped sample: no corner, not cell 0 with
//     weight 0, as saving those bytes is the point of pruning. The kept
//     samples are summed in (level, point, corner) order.
//
// What bounds them on an H100: the corner reads from L2 and their latency,
// not HBM. The flagship's value table (22,500 tokens x 288 channels, 13 MB
// in bf16, 6.5 MB in int8) stays in the 50 MB L2; every corner of every
// sample reads a head slice (72 bytes in bf16, 36 in int8) from it, 2 flops a
// channel: ~71 MB of sectors a bf16 high-lite launch on the main path's
// samples, ~108 MB a low-lite one. A thread that loops over levels and
// points known only at run time, with a branch per corner and three scalar
// loads per sample, has one sample's corners in flight at a time, and narrow
// lanes make a warp ask for a slice in many small pieces.
//
// Design:
//   - for the (L, P) the flagship launches, (2, 2) and (1, 2), L and P are
//     fixed at compile time: a thread reads its (q, m)'s L*P*3 floats of
//     loc/aw as vectors, computes every corner branch-free (a corner that
//     is not read gets cell 0 and weight 0) and has all 4*L*P corner loads
//     in flight before its first FMA;
//   - wide lanes where D is a multiple of 12 (the main path; msda_fwd_wide /
//     msda_shared_fwd_wide): one thread per 12 channels of a head, 3 at
//     D = 36, reading its part of a corner's slice as one 8-channel and one
//     4-channel load, the 8-channel one first where its start is aligned to
//     it, else second: the same two loads on every lane, at other offsets,
//     no branch. In bf16 they are 16 + 8 bytes. In int8 they are 8 + 4
//     bytes, and a corner's raw words stay in registers until its FMAs,
//     where i8_at turns each channel into f32 with a PRMT and an FADD
//     (4-byte lanes would put 9 threads on a 36-byte slice, and I2F is a
//     quarter-rate instruction). The head-shared instance runs the same
//     threads on the query's locations: the 24 threads of a query read a
//     corner's whole row side by side;
//   - otherwise one thread per V channels (msda_fwd_kernel /
//     msda_shared_fwd_kernel: 16-byte lanes in f32, 1-8 bytes where D or the
//     alignment allow no wider), and a generic instance for other (L, P);
//   - the top-k instances (msda_topk_fwd_wide_kernel / msda_topk_fwd_kernel)
//     take the same lanes at (2, 2), (1, 2) and (4, 4) fixed, and a generic
//     instance for any other L*P <= 64. A thread walks only its (q, m)'s
//     kept samples, one at a time, found by the set bits of its mask
//     (topk_walk); three blocks fit an SM. Keeping all of a (q, m)'s kept
//     corners in flight at once, as msda_fwd's code asks, cost ptxas 157
//     registers and the SM two of its three blocks;
//   - a block walks a run of consecutive queries, as many as spread the
//     launch evenly over the blocks that fit on the card at once, rounded
//     up to whole passes of the block: the encoder's queries are
//     raster-ordered tokens whose samples overlap, so the slices a run
//     shares come from the SM's L1 (loads through the read-only path
//     allocate there) rather than L2.
#include <mutex>
#include <type_traits>
#include <vector>

#include "msda_common.cuh"

namespace kinet {

// Only the largest block size bounds ptxas: asked for a minimum of blocks
// an SM as well, it spent more registers (the fixed instances 64-96 instead
// of 48-80) and ran slower.
constexpr int kMaxThreads = 288;

// The int8 instances: each (batch, head)'s dequantization scale multiplies
// the (q, m)'s attention weights, so every corner weight, once.
template <typename T>
constexpr bool kInt8 = std::is_same<T, int8_t>::value;

// A launch's arguments. loc is [B, Lq, M, L, P, 2], or [B, Lq, L, P, 2] for
// the head-shared instances; scales [B, M] for int8 values, else null.
template <typename T>
struct FwdArgs {
  const T* value;
  const float* scales;
  const int* spatial_shapes;
  const int* level_start;
  const float* loc;
  const float* aw;
  float* out;
  int B, S, M, D, Lq, L, P;
  int K;    // top-k instances: samples kept a (q, m), 1 <= K <= L*P
  int run;  // consecutive queries a block walks
};

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

// Launches `kernel` with `threads` threads a block (per_query of them a
// query) on at most as many blocks as fit on the card at once, each walking
// a.run consecutive queries: an even share, rounded up to whole passes of
// the block over its queries where a block holds whole queries. A share
// that ends inside a pass leaves that pass's other threads idle: 3 blocks
// an SM give the (2, 2) wide instances runs of 15 queries, 12 a pass, which
// ran 2-12 % slower on an H100 than runs of 24 (PERF.md).
template <typename T>
static cudaError_t launch_runs(void (*kernel)(FwdArgs<T>), int threads,
                               int per_query, FwdArgs<T> a,
                               cudaStream_t stream) {
  const long long queries = (long long)a.B * a.Lq;
  const long long slots = resident_blocks((const void*)kernel, threads);
  const long long pass = threads % per_query == 0 ? threads / per_query : 1;
  const long long passes = (queries + slots * pass - 1) / (slots * pass);
  a.run = (int)(passes * pass);
  const unsigned blocks = (unsigned)((queries + a.run - 1) / a.run);
  kernel<<<blocks, threads, 0, stream>>>(a);
  return cudaGetLastError();
}

// Where a (q, m)'s samples start in loc (in samples of 2 floats): per
// (q, m), or per query for the head-shared instances.
template <bool kShared>
__device__ __forceinline__ long long loc_index(long long bq, long long bqm) {
  return kShared ? bq : bqm;
}

// One (b, q, m, channel group) with L and P fixed at compile time: the
// (q, m)'s samples read as vectors, then all 4*L*P corner loads issued
// before the first FMA.
template <typename T, int V, int kL, int kP, bool kShared>
__device__ __forceinline__ void sample_fixed(const FwdArgs<T>& a,
                                             long long bq, long long bqm,
                                             int b, int c0, float scale,
                                             float (&acc)[V]) {
  constexpr int kLP = kL * kP;
  float xy[2 * kLP], sw[kLP];
  load_floats<2 * kLP>(a.loc + loc_index<kShared>(bq, bqm) * 2 * kLP, xy);
  load_floats<kLP>(a.aw + bqm * kLP, sw);
  if constexpr (kInt8<T>) {
#pragma unroll
    for (int k = 0; k < kLP; ++k) sw[k] *= scale;
  }
  const long long row_stride = (long long)a.M * a.D;
  float v[4 * kLP][V];
  float wt[4 * kLP];
#pragma unroll
  for (int l = 0; l < kL; ++l) {
    const int h = __ldg(a.spatial_shapes + 2 * l);
    const int w = __ldg(a.spatial_shapes + 2 * l + 1);
    const T* base = a.value +
                    ((long long)b * a.S + __ldg(a.level_start + l)) *
                        row_stride + c0;
#pragma unroll
    for (int p = 0; p < kP; ++p) {
      const int k = l * kP + p;
      const float x = xy[2 * k] * w - 0.5f;
      const float y = xy[2 * k + 1] * h - 0.5f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const long long cell = corner_branch_free(c, h, w, x, y, sw[k],
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

// Top-k: the kept-sample mask of a (q, m) from its kLP weights in
// registers, bit k for sample k.
template <int kLP>
__device__ __forceinline__ unsigned rank_keep(const float (&sw)[kLP], int K) {
  unsigned keep = 0;
#pragma unroll
  for (int j = 0; j < kLP; ++j) {
    int rank = 0;
#pragma unroll
    for (int i = 0; i < kLP; ++i)
      rank += (sw[i] > sw[j]) || (sw[i] == sw[j] && i < j);
    keep |= (unsigned)(rank < K) << j;
  }
  return keep;
}

// The same for L*P <= 64 known only at run time, the weights read from L1.
__device__ __forceinline__ unsigned long long rank_keep_generic(
    const float* __restrict__ sw, int LP, int K) {
  unsigned long long keep = 0;
  for (int j = 0; j < LP; ++j) {
    const float aj = __ldg(sw + j);
    int rank = 0;
    for (int i = 0; i < LP; ++i) {
      const float ai = __ldg(sw + i);
      rank += (ai > aj) || (ai == aj && i < j);
    }
    keep |= (unsigned long long)(rank < K) << j;
  }
  return keep;
}

// The same with L and P known only at run time: one sample's corners in
// flight at a time; with kTopk, only the kept samples'.
template <typename T, int V, bool kShared, bool kTopk = false>
__device__ __forceinline__ void sample_generic(const FwdArgs<T>& a,
                                               long long bq, long long bqm,
                                               int b, int c0, float scale,
                                               float (&acc)[V]) {
  const int L = a.L, P = a.P;
  const long long row_stride = (long long)a.M * a.D;
  const long long s0 = loc_index<kShared>(bq, bqm) * L * P;
  unsigned long long keep = ~0ull;
  if constexpr (kTopk) keep = rank_keep_generic(a.aw + bqm * L * P, L * P, a.K);
  for (int l = 0; l < L; ++l) {
    const int h = __ldg(a.spatial_shapes + 2 * l);
    const int w = __ldg(a.spatial_shapes + 2 * l + 1);
    const T* base = a.value +
                    ((long long)b * a.S + __ldg(a.level_start + l)) *
                        row_stride + c0;
    for (int p = 0; p < P; ++p) {
      if (kTopk && !((keep >> (l * P + p)) & 1ull)) continue;
      const long long s = s0 + l * P + p;
      const float x = __ldg(a.loc + 2 * s) * w - 0.5f;
      const float y = __ldg(a.loc + 2 * s + 1) * h - 0.5f;
      const float wk = __ldg(a.aw + bqm * L * P + l * P + p);
      const float aw = kInt8<T> ? wk * scale : wk;
      float v[4][V], wt[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const long long cell = corner_branch_free(c, h, w, x, y, aw, wt[c]);
        VecIO<T, V>::load(base + cell * row_stride, v[c]);
      }
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int i = 0; i < V; ++i) acc[i] = fmaf(wt[c], v[c][i], acc[i]);
    }
  }
}

// What a top-k thread reads of one corner and adds to its sums: V channels
// converted to f32 at the load (VecLane), or the 12-channel wide lane's
// raw words (WideLane, after Wide12).
template <typename T, int V>
struct VecLane {
  struct Raw {
    float v[V];
  };
  float (&acc)[V];
  __device__ __forceinline__ void load(const T* q, Raw& r) const {
    VecIO<T, V>::load(q, r.v);
  }
  __device__ __forceinline__ void add(float wt, const Raw& r) {
#pragma unroll
    for (int i = 0; i < V; ++i) acc[i] = fmaf(wt, r.v[i], acc[i]);
  }
};

// One (b, q, m, lane) of the top-k instances, L and P fixed at compile
// time: the (q, m)'s kLP weights read as vectors and ranked in registers,
// then the K kept samples in index order, one at a time: the next set bit
// of the mask gives a sample's index, its location and weight are read by
// it (the weight from L1, where the vector read left it), its level's
// shape picked by selects, and its four corners loaded and added. Nothing
// of a dropped sample is read. One sample's corners in flight keep a thread
// at ~72 registers, three blocks of 288 an SM; all of a (q, m)'s kept
// corners in flight took 157 and one block, and ran 1.3x slower (PERF.md).
template <typename T, typename Lane, int kL, int kP>
__device__ __forceinline__ void topk_walk(const FwdArgs<T>& a, long long bqm,
                                          int b, int c0, Lane& lane) {
  constexpr int kLP = kL * kP;
  const long long row_stride = (long long)a.M * a.D;
  const float* loc = a.loc + bqm * 2 * kLP;
  const float* aw = a.aw + bqm * kLP;
  float sw[kLP];
  load_floats<kLP>(aw, sw);
  unsigned keep = rank_keep<kLP>(sw, a.K);
  int hs[kL], ws[kL], starts[kL];
#pragma unroll
  for (int l = 0; l < kL; ++l) {
    hs[l] = __ldg(a.spatial_shapes + 2 * l);
    ws[l] = __ldg(a.spatial_shapes + 2 * l + 1);
    starts[l] = __ldg(a.level_start + l);
  }
  const T* head = a.value + (long long)b * a.S * row_stride + c0;
#pragma unroll
  for (int j = 0; j < kLP; ++j) {
    if (j >= a.K) break;
    const int k = __ffs((int)keep) - 1;
    keep &= keep - 1;
    const int lv = k / kP;
    int h = hs[0], w = ws[0], start = starts[0];
#pragma unroll
    for (int l = 1; l < kL; ++l)
      if (lv == l) h = hs[l], w = ws[l], start = starts[l];
    const float2 xy = __ldg(reinterpret_cast<const float2*>(loc) + k);
    const float x = xy.x * w - 0.5f;
    const float y = xy.y * h - 0.5f;
    typename Lane::Raw r[4];
    float wt[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const long long cell =
          corner_branch_free(c, h, w, x, y, __ldg(aw + k), wt[c]);
      lane.load(head + (start + cell) * row_stride, r[c]);
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) lane.add(wt[c], r[c]);
  }
}

// V-channel lanes: one thread per (b, q, m, V channels). kTopk: the top-k
// instances (kL = 0 the generic one).
template <typename T, int V, int kL, int kP, bool kShared, bool kTopk = false>
__device__ __forceinline__ void fwd_lanes(const FwdArgs<T>& a) {
  const int groups = a.D / V;
  const int per_query = a.M * groups;
  const long long q0 = (long long)blockIdx.x * a.run;
  const long long q_end = min(q0 + a.run, (long long)a.B * a.Lq);
  const long long items = (q_end - q0) * per_query;
  for (long long i = threadIdx.x; i < items; i += blockDim.x) {
    const long long bq = q0 + i / per_query;
    const int r = (int)(i % per_query);
    const int m = r / groups;
    const int c0 = m * a.D + (r - m * groups) * V;  // first channel in the row
    const int b = (int)(bq / a.Lq);
    const long long bqm = bq * a.M + m;
    float scale = 1.0f;
    if constexpr (kInt8<T>) scale = __ldg(a.scales + (long long)b * a.M + m);
    float acc[V];
#pragma unroll
    for (int j = 0; j < V; ++j) acc[j] = 0.0f;
    if constexpr (kTopk && kL > 0) {
      VecLane<T, V> lane{acc};
      topk_walk<T, VecLane<T, V>, kL, kP>(a, bqm, b, c0, lane);
    } else if constexpr (kL > 0) {
      sample_fixed<T, V, kL, kP, kShared>(a, bq, bqm, b, c0, scale, acc);
    } else {
      sample_generic<T, V, kShared, kTopk>(a, bq, bqm, b, c0, scale, acc);
    }
    VecIO<float, V>::store(a.out + bq * a.M * a.D + c0, acc);
  }
}

// 12 channels of a corner's head slice as one 8-channel load (Big) and one
// 4-channel load (Small), kept raw until the FMAs that add them, weighted,
// to 8 and 4 f32 sums.
template <typename T>
struct Wide12;

template <>
struct Wide12<__nv_bfloat16> {
  using Big = uint4;    // 16 bytes
  using Small = uint2;  // 8 bytes
  __device__ __forceinline__ static void fma(float wt, const uint4& u,
                                             float (&acc)[8]) {
    const unsigned int w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const float2 f = bf2_to_f2(w[t]);
      acc[2 * t] = fmaf(wt, f.x, acc[2 * t]);
      acc[2 * t + 1] = fmaf(wt, f.y, acc[2 * t + 1]);
    }
  }
  __device__ __forceinline__ static void fma(float wt, const uint2& u,
                                             float (&acc)[4]) {
    const float2 f0 = bf2_to_f2(u.x), f1 = bf2_to_f2(u.y);
    acc[0] = fmaf(wt, f0.x, acc[0]);
    acc[1] = fmaf(wt, f0.y, acc[1]);
    acc[2] = fmaf(wt, f1.x, acc[2]);
    acc[3] = fmaf(wt, f1.y, acc[3]);
  }
};

template <>
struct Wide12<int8_t> {
  using Big = uint2;           // 8 bytes
  using Small = unsigned int;  // 4 bytes
  __device__ __forceinline__ static void word_fma(float wt, unsigned int word,
                                                  float* acc) {
    const unsigned int f = word ^ 0x80808080u;
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[k] = fmaf(wt, i8_at(f, k), acc[k]);
  }
  __device__ __forceinline__ static void fma(float wt, const uint2& u,
                                             float (&acc)[8]) {
    word_fma(wt, u.x, acc);
    word_fma(wt, u.y, acc + 4);
  }
  __device__ __forceinline__ static void fma(float wt, unsigned int u,
                                             float (&acc)[4]) {
    word_fma(wt, u, acc);
  }
};

// The top-k instances' 12-channel bf16 lane: a corner's two raw loads,
// added weighted to the 8 and 4 f32 sums of fwd_wide.
struct WideLane {
  struct Raw {
    uint4 big;
    uint2 small;
  };
  int off_big, off_small;
  float (&ab)[8];
  float (&as)[4];
  __device__ __forceinline__ void load(const __nv_bfloat16* q, Raw& r) const {
    r.big = __ldg(reinterpret_cast<const uint4*>(q + off_big));
    r.small = __ldg(reinterpret_cast<const uint2*>(q + off_small));
  }
  __device__ __forceinline__ void add(float wt, const Raw& r) {
    Wide12<__nv_bfloat16>::fma(wt, r.big, ab);
    Wide12<__nv_bfloat16>::fma(wt, r.small, as);
  }
};

// 12-channel lanes (D % 12 == 0), L and P fixed: see the top. A lane's
// first channel e0 is a multiple of 4, so its 12 channels start 8-channel
// aligned (e0 % 8 == 0: Big at e0, Small at e0 + 8) or 4 past it (Small at
// e0, Big at e0 + 4). kTopk: the top-k instances (bf16).
template <typename T, int kL, int kP, bool kShared, bool kTopk = false>
__device__ __forceinline__ void fwd_wide(const FwdArgs<T>& a) {
  using W = Wide12<T>;
  constexpr int kLP = kL * kP;
  const int groups = a.D / 12;
  const int per_query = a.M * groups;
  const long long q0 = (long long)blockIdx.x * a.run;
  const long long q_end = min(q0 + a.run, (long long)a.B * a.Lq);
  const long long items = (q_end - q0) * per_query;
  const long long row_stride = (long long)a.M * a.D;
  for (long long i = threadIdx.x; i < items; i += blockDim.x) {
    const long long bq = q0 + i / per_query;
    const int r = (int)(i % per_query);
    const int m = r / groups;
    const int e0 = m * a.D + 12 * (r - m * groups);  // first channel in the row
    const bool odd = (e0 >> 2) & 1;
    const int off_big = odd ? 4 : 0;
    const int off_small = odd ? 0 : 8;
    const int b = (int)(bq / a.Lq);
    const long long bqm = bq * a.M + m;
    float ab[8], as[4];
    if constexpr (kTopk) {
#pragma unroll
      for (int t = 0; t < 8; ++t) ab[t] = 0.0f;
#pragma unroll
      for (int t = 0; t < 4; ++t) as[t] = 0.0f;
      WideLane lane{off_big, off_small, ab, as};
      topk_walk<T, WideLane, kL, kP>(a, bqm, b, e0, lane);
    } else {
      float xy[2 * kLP], sw[kLP];
      load_floats<2 * kLP>(a.loc + loc_index<kShared>(bq, bqm) * 2 * kLP, xy);
      load_floats<kLP>(a.aw + bqm * kLP, sw);
      if constexpr (kInt8<T>) {
        const float scale = __ldg(a.scales + (long long)b * a.M + m);
#pragma unroll
        for (int k = 0; k < kLP; ++k) sw[k] *= scale;
      }
      typename W::Big rb[4 * kLP];
      typename W::Small rs[4 * kLP];
      float wt[4 * kLP];
#pragma unroll
      for (int l = 0; l < kL; ++l) {
        const int h = __ldg(a.spatial_shapes + 2 * l);
        const int w = __ldg(a.spatial_shapes + 2 * l + 1);
        const T* base = a.value +
                        ((long long)b * a.S + __ldg(a.level_start + l)) *
                            row_stride + e0;
#pragma unroll
        for (int p = 0; p < kP; ++p) {
          const int k = l * kP + p;
          const float x = xy[2 * k] * w - 0.5f;
          const float y = xy[2 * k + 1] * h - 0.5f;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const T* q = base + corner_branch_free(c, h, w, x, y, sw[k],
                                                   wt[4 * k + c]) *
                                    row_stride;
            rb[4 * k + c] =
                __ldg(reinterpret_cast<const typename W::Big*>(q + off_big));
            rs[4 * k + c] = __ldg(
                reinterpret_cast<const typename W::Small*>(q + off_small));
          }
        }
      }
#pragma unroll
      for (int t = 0; t < 8; ++t) ab[t] = 0.0f;
#pragma unroll
      for (int t = 0; t < 4; ++t) as[t] = 0.0f;
#pragma unroll
      for (int k = 0; k < 4 * kLP; ++k) {
        W::fma(wt[k], rb[k], ab);
        W::fma(wt[k], rs[k], as);
      }
    }
    float o[12];
#pragma unroll
    for (int t = 0; t < 12; ++t)
      o[t] = odd ? (t < 4 ? as[t] : ab[t - 4]) : (t < 8 ? ab[t] : as[t - 8]);
    float* dst = a.out + bq * row_stride + e0;
#pragma unroll
    for (int t = 0; t < 3; ++t)
      VecIO<float, 4>::store(dst + 4 * t, o + 4 * t);
  }
}

// The kernels: one name per C entry (in profiles, msda_fwd_* over int8 are
// msda_fwd_i8's), kL = 0 for the generic (L, P) instances.
template <typename T, int V, int kL, int kP>
__global__ void __launch_bounds__(kMaxThreads)
    msda_fwd_kernel(FwdArgs<T> a) {
  fwd_lanes<T, V, kL, kP, false>(a);
}

template <typename T, int V, int kL, int kP>
__global__ void __launch_bounds__(kMaxThreads)
    msda_shared_fwd_kernel(FwdArgs<T> a) {
  fwd_lanes<T, V, kL, kP, true>(a);
}

template <typename T, int kL, int kP>
__global__ void __launch_bounds__(kMaxThreads)
    msda_fwd_wide_kernel(FwdArgs<T> a) {
  fwd_wide<T, kL, kP, false>(a);
}

template <int kL, int kP>
__global__ void __launch_bounds__(kMaxThreads)
    msda_shared_fwd_wide_kernel(FwdArgs<__nv_bfloat16> a) {
  fwd_wide<__nv_bfloat16, kL, kP, true>(a);
}

// The top-k kernels (msda_topk_fwd's): kL = 0 for the generic instance.
// Unlike msda_fwd's, they are asked to fit kTopkBlocks blocks an SM: one
// sample's corners at a time fit the 72 registers that leaves without a
// spill, where the 78-86 ptxas picks alone fit two (PERF.md).
constexpr int kTopkBlocks = 3;

template <typename T, int V, int kL, int kP>
__global__ void __launch_bounds__(kMaxThreads, kTopkBlocks)
    msda_topk_fwd_kernel(FwdArgs<T> a) {
  fwd_lanes<T, V, kL, kP, false, true>(a);
}

template <int kL, int kP>
__global__ void __launch_bounds__(kMaxThreads, kTopkBlocks)
    msda_topk_fwd_wide_kernel(FwdArgs<__nv_bfloat16> a) {
  fwd_wide<__nv_bfloat16, kL, kP, false, true>(a);
}

// The V-channel kernel of one entry and (L, P) instance.
template <typename T, int V, int kL, int kP, bool kShared>
static auto lanes_kernel() {
  if constexpr (kShared)
    return msda_shared_fwd_kernel<T, V, kL, kP>;
  else
    return msda_fwd_kernel<T, V, kL, kP>;
}

template <typename T, int V, bool kShared>
static cudaError_t launch_lanes(const FwdArgs<T>& a, bool fixed,
                                cudaStream_t stream) {
  const int per_query = a.M * (a.D / V);
  const int threads = block_threads(per_query);
  if (fixed && a.L == 2)
    return launch_runs(lanes_kernel<T, V, 2, 2, kShared>(), threads,
                       per_query, a, stream);
  if (fixed)
    return launch_runs(lanes_kernel<T, V, 1, 2, kShared>(), threads,
                       per_query, a, stream);
  return launch_runs(lanes_kernel<T, V, 0, 0, kShared>(), threads, per_query,
                     a, stream);
}

// Picks the instance: wide lanes where D % 12 == 0, (L, P) is fixed and
// every wide load is aligned (bf16 and int8), else the widest V-channel
// lanes that D and the pointers allow.
template <typename T, bool kShared>
static cudaError_t launch(FwdArgs<T> a, cudaStream_t stream) {
  // the fixed instances read a (q, m)'s loc/aw as vectors: 16-byte aligned
  const bool fixed = (uintptr_t)a.loc % 16 == 0 && (uintptr_t)a.aw % 16 == 0 &&
                     a.P == 2 && (a.L == 2 || a.L == 1);
  const long long row = (long long)a.M * a.D;
  const bool out_ok = (uintptr_t)a.out % 16 == 0 && row % 8 == 0;
  if constexpr (!std::is_same<T, float>::value) {
    // the 8-channel load's alignment: 16 bytes in bf16, 8 in int8
    if (fixed && out_ok && a.D % 12 == 0 &&
        (uintptr_t)a.value % (8 * sizeof(T)) == 0) {
      const int per_query = a.M * (a.D / 12);
      const int threads = block_threads(per_query);
      if constexpr (kShared && !kInt8<T>)
        return launch_runs(a.L == 2 ? msda_shared_fwd_wide_kernel<2, 2>
                                    : msda_shared_fwd_wide_kernel<1, 2>,
                           threads, per_query, a, stream);
      else
        return launch_runs(a.L == 2 ? msda_fwd_wide_kernel<T, 2, 2>
                                    : msda_fwd_wide_kernel<T, 1, 2>,
                           threads, per_query, a, stream);
    }
  }
  const int v = pick_vec(a.D, a.value, sizeof(T), a.out, sizeof(float));
  if (v == 4) return launch_lanes<T, 4, kShared>(a, fixed, stream);
  if (v == 2) return launch_lanes<T, 2, kShared>(a, fixed, stream);
  return launch_lanes<T, 1, kShared>(a, fixed, stream);
}

// The top-k instances' fixed (L, P): 22 for (2, 2), 12 for (1, 2), 44 for
// (4, 4), where loc / aw are 16-byte aligned (read as vectors), else 0.
template <typename T>
static int topk_fixed(const FwdArgs<T>& a) {
  if ((uintptr_t)a.loc % 16 != 0 || (uintptr_t)a.aw % 16 != 0) return 0;
  if (a.L == 2 && a.P == 2) return 22;
  if (a.L == 1 && a.P == 2) return 12;
  if (a.L == 4 && a.P == 4) return 44;
  return 0;
}

template <typename T, int V>
static cudaError_t launch_topk_lanes(const FwdArgs<T>& a, int fixed,
                                     cudaStream_t stream) {
  const int per_query = a.M * (a.D / V);
  const int threads = block_threads(per_query);
  return launch_runs(fixed == 22   ? msda_topk_fwd_kernel<T, V, 2, 2>
                     : fixed == 12 ? msda_topk_fwd_kernel<T, V, 1, 2>
                     : fixed == 44 ? msda_topk_fwd_kernel<T, V, 4, 4>
                                   : msda_topk_fwd_kernel<T, V, 0, 0>,
                     threads, per_query, a, stream);
}

// Picks the top-k instance: wide lanes for bf16 at a fixed (L, P) where
// D % 12 == 0 and every wide access is aligned, else the widest V-channel
// lanes that D and the pointers allow; any other L*P <= 64 takes the
// generic instance.
template <typename T>
static cudaError_t launch_topk(FwdArgs<T> a, cudaStream_t stream) {
  if (a.L * a.P > 64 || a.K < 1 || a.K > a.L * a.P)
    return cudaErrorInvalidValue;
  const int fixed = topk_fixed(a);
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    const long long row = (long long)a.M * a.D;
    if (fixed && (uintptr_t)a.out % 16 == 0 && row % 8 == 0 &&
        a.D % 12 == 0 && (uintptr_t)a.value % 16 == 0) {
      const int per_query = a.M * (a.D / 12);
      return launch_runs(fixed == 22   ? msda_topk_fwd_wide_kernel<2, 2>
                         : fixed == 12 ? msda_topk_fwd_wide_kernel<1, 2>
                                       : msda_topk_fwd_wide_kernel<4, 4>,
                         block_threads(per_query), per_query, a, stream);
    }
  }
  const int v = pick_vec(a.D, a.value, sizeof(T), a.out, sizeof(float));
  if (v == 4) return launch_topk_lanes<T, 4>(a, fixed, stream);
  if (v == 2) return launch_topk_lanes<T, 2>(a, fixed, stream);
  return launch_topk_lanes<T, 1>(a, fixed, stream);
}

template <typename T>
static FwdArgs<T> fwd_args(const void* value, const void* scales,
                           const void* shapes, const void* starts,
                           const void* loc, const void* aw, void* out, int B,
                           int S, int M, int D, int Lq, int L, int P,
                           int K = 0) {
  return {static_cast<const T*>(value), static_cast<const float*>(scales),
          static_cast<const int*>(shapes), static_cast<const int*>(starts),
          static_cast<const float*>(loc), static_cast<const float*>(aw),
          static_cast<float*>(out), B, S, M, D, Lq, L, P, K, 0};
}

template <bool kShared>
static int launch_float(const void* value, int dtype, const void* shapes,
                        const void* starts, const void* loc, const void* aw,
                        void* out, int B, int S, int M, int D, int Lq, int L,
                        int P, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16)
    return (int)launch<__nv_bfloat16, kShared>(
        fwd_args<__nv_bfloat16>(value, nullptr, shapes, starts, loc, aw, out,
                                B, S, M, D, Lq, L, P),
        s);
  if (dtype == kF32)
    return (int)launch<float, kShared>(
        fwd_args<float>(value, nullptr, shapes, starts, loc, aw, out, B, S,
                        M, D, Lq, L, P),
        s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace kinet

// C entries bound with ctypes. Each returns the launch's CUDA error (0 if
// none).
extern "C" int msda_fwd(const void* value, int dtype, const void* shapes,
                        const void* starts, const void* loc, const void* aw,
                        void* out, int B, int S, int M, int D, int Lq, int L,
                        int P, void* stream) {
  return kinet::launch_float<false>(value, dtype, shapes, starts, loc, aw,
                                    out, B, S, M, D, Lq, L, P, stream);
}

// The int8 instance (enc_msda_int8): value [B, S, M, D] int8, scales [B, M]
// f32, each head's scale folded into its corner weights.
extern "C" int msda_fwd_i8(const void* value, const void* scales,
                           const void* shapes, const void* starts,
                           const void* loc, const void* aw, void* out, int B,
                           int S, int M, int D, int Lq, int L, int P,
                           void* stream) {
  return (int)kinet::launch<int8_t, false>(
      kinet::fwd_args<int8_t>(value, scales, shapes, starts, loc, aw, out, B,
                              S, M, D, Lq, L, P),
      static_cast<cudaStream_t>(stream));
}

// The head-shared instance (enc_msda_shared_locs): value f32 or bf16
// (dtype), loc [B, Lq, L, P, 2], aw [B, Lq, M, L, P].
extern "C" int msda_shared_fwd(const void* value, int dtype,
                               const void* shapes, const void* starts,
                               const void* loc, const void* aw, void* out,
                               int B, int S, int M, int D, int Lq, int L,
                               int P, void* stream) {
  return kinet::launch_float<true>(value, dtype, shapes, starts, loc, aw, out,
                                   B, S, M, D, Lq, L, P, stream);
}

// The top-k instance (enc_msda_topk): per (q, m) only the K samples of
// largest weight, 1 <= K <= L*P <= 64.
extern "C" int msda_topk_fwd(const void* value, int dtype, const void* shapes,
                             const void* starts, const void* loc,
                             const void* aw, void* out, int B, int S, int M,
                             int D, int Lq, int L, int P, int K,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kinet::kBF16)
    return (int)kinet::launch_topk(
        kinet::fwd_args<__nv_bfloat16>(value, nullptr, shapes, starts, loc,
                                       aw, out, B, S, M, D, Lq, L, P, K),
        s);
  if (dtype == kinet::kF32)
    return (int)kinet::launch_topk(
        kinet::fwd_args<float>(value, nullptr, shapes, starts, loc, aw, out,
                               B, S, M, D, Lq, L, P, K),
        s);
  return (int)cudaErrorInvalidValue;
}
