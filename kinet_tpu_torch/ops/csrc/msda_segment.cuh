// Segmented reduction of the MSDA backward kernels' table gradient
// (dvalue of msda_bwd.cu, dsrc of msda_raw_pool_bwd.cu), with no
// floating-point atomics, repeatable bit for bit.
//
// The scatter-add  out[key_c] += w_c * grad[row]  over every in-bounds
// bilinear corner c of every sample becomes a gather per key:
//
//   1. record  (the backward's dots pass, msda_*_bwd.cu): every corner
//      gets an entry at the fixed position e = (sample * 4 + corner): its
//      key (the output row), its weight aw * bil_c and a rank among the
//      entries of that key, the result of an int atomicAdd on counts[key]
//      (issued before the corner's dot product, stored after it); a corner
//      that the forward does not read gets key -1;
//   2. scan    (msda_segment_tile_sums, msda_segment_scan): offsets =
//      exclusive prefix sum of counts, over tiles of kScanTile keys;
//   3. place   (msda_segment_place): placed[offsets[key] + rank] = (e,
//      weight), so the entries of each key lie together, in the order the
//      atomics happened to hand out;
//   4. order   (msda_segment_order, msda_segment_order_long): each
//      segment sorted by e, from placed into slots, so the order of a key's
//      terms no longer depends on the scheduling of the atomics (a thread
//      sorts a key of up to kOrderSmall entries in registers and lists a
//      longer one, which a warp of the second pass ranks);
//   5. sum     (msda_segment_sum): each key's row is the f32 sum of
//      weight * grad[e / (4 * samples a row)] over its segment in that
//      order, as a fixed tree of fan-in kSumFan (BlockedSum): the terms in
//      runs of kSumFan, those runs' sums in runs of kSumFan, then the rest,
//      so a term passes through at most about 2 kSumFan + n / kSumFan^2
//      roundings instead of n; written once in the output's type; a key
//      with an empty segment writes exact zeros.
//
// So the output needs no zero-fill, no f32 buffer and no cast, and the
// same inputs give the same bits on every run. Integer atomics touch only
// the counters.
//
// Scratch: one int32 buffer of segment_scratch_ints() ints, allocated by
// the caller (msda_segment_scratch_ints gives the count); the kernels
// allocate nothing.
#pragma once

#include "msda_common.cuh"

namespace kinet {

constexpr int kScanThreads = 256;
constexpr int kScanItems = 8;
constexpr int kScanTile = kScanThreads * kScanItems;  // keys per scan tile
constexpr int kSumThreads = 256;  // threads of a segment-sum block, at most
constexpr int kSumChunk = 1024;   // (row, weight) pairs staged in shared
constexpr int kSumFan = 32;       // fan-in of the segment sum's tree
constexpr int kOrderSmall = 12;   // the longest segment a thread sorts
constexpr int kOrderRun = 4;      // entries a lane ranks at once (order)
constexpr int kOrderLongWarps = 132 * 32;  // warps of the long-key pass

struct Segments {
  int* counts;     // [n_keys + 1], zeroed by msda_segment_clear; the last
                   // counts the keys listed in long_keys
  int* offsets;    // [n_keys + 1]
  int* tile_sums;  // [scan tiles]
  int* long_keys;  // [n_keys]: the keys of more than kOrderSmall entries
  int4* entries;   // [n_entries]: (key, rank, weight bits, -); key -1:
                   // the corner is not read
  int2* placed;    // [n_entries]: (e, weight bits), by key, by rank
  int2* slots;     // [n_entries]: (e, weight bits), by key, by e
};

inline long long scan_tiles(long long n_keys) {
  return (n_keys + 1 + kScanTile - 1) / kScanTile;
}

// int32 elements of the scratch buffer of one backward call
inline long long segment_scratch_ints(long long n_keys, long long n_entries) {
  long long n = 3 * n_keys + 2 + scan_tiles(n_keys);
  n = (n + 3) & ~3LL;  // entries are 16-byte aligned
  return n + 8 * n_entries;  // entries (4 ints an entry), placed, slots
}

inline Segments carve_segments(void* scratch, long long n_keys,
                               long long n_entries) {
  int* p = static_cast<int*>(scratch);
  Segments sg;
  sg.counts = p;
  p += n_keys + 1;
  sg.offsets = p;
  p += n_keys + 1;
  sg.tile_sums = p;
  p += scan_tiles(n_keys);
  sg.long_keys = p;
  p += n_keys;
  while ((p - static_cast<int*>(scratch)) & 3) ++p;
  sg.entries = reinterpret_cast<int4*>(p);
  sg.placed = reinterpret_cast<int2*>(sg.entries + n_entries);
  sg.slots = sg.placed + n_entries;
  return sg;
}

// One corner's entry: key -1 for a corner that is not read. wy, wx are
// its bilinear factors, for the caller's own sums; they are not stored.
struct CornerEntry {
  int key = -1;
  int rank = 0;
  float weight = 0.0f;
  float wy = 0.0f;
  float wx = 0.0f;
};

// Step 1, for one lane: the entry of corner `corner` of a sample, whose
// key is (key_row0 + cell) * key_mult + key_add, counted into counts[key].
// The lane waits for the atomic's result only where store_entry uses it.
__device__ __forceinline__ CornerEntry count_corner(
    const Segments& sg, int corner, int h, int w, float x, float y,
    float aw, float vh, float vw, long long key_row0, int key_mult,
    int key_add) {
  CornerEntry c;
  long long cell;
  if (corner_at(corner, h, w, x, y, vh, vw, cell, c.wy, c.wx)) {
    c.key = (int)((key_row0 + cell) * key_mult + key_add);
    c.weight = c.wy * c.wx * aw;
    c.rank = atomicAdd(sg.counts + c.key, 1);
  }
  return c;
}

__device__ __forceinline__ void store_entry(const Segments& sg, long long e,
                                            const CornerEntry& c) {
  sg.entries[e] = make_int4(c.key, c.rank, __float_as_int(c.weight), 0);
}

__global__ void __launch_bounds__(256)
    msda_segment_clear(int* __restrict__ counts, long long n) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x)
    counts[i] = 0;
}

// Inclusive prefix sum over a block of kScanThreads threads; `total` gets
// the block's sum. Every thread of the block must call it.
__device__ __forceinline__ int block_inclusive_scan(int v, int& total) {
  constexpr int kWarps = kScanThreads / 32;
  __shared__ int warp_sums[kWarps];
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int n = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += n;
  }
  if (lane == 31) warp_sums[wid] = v;
  __syncthreads();
  if (wid == 0) {
    int t = lane < kWarps ? warp_sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < kWarps; o <<= 1) {
      const int n = __shfl_up_sync(0xffffffffu, t, o);
      if (lane >= o) t += n;
    }
    if (lane < kWarps) warp_sums[lane] = t;
  }
  __syncthreads();
  if (wid > 0) v += warp_sums[wid - 1];
  total = warp_sums[kWarps - 1];
  __syncthreads();  // warp_sums is reused by the next call
  return v;
}

// Step 2a: the sum of counts over each tile of kScanTile keys.
__global__ void __launch_bounds__(kScanThreads)
    msda_segment_tile_sums(const int* __restrict__ counts, long long n_keys,
                           int* __restrict__ tile_sums) {
  const long long t0 = (long long)blockIdx.x * kScanTile;
  int s = 0;
#pragma unroll
  for (int j = 0; j < kScanItems; ++j) {
    const long long i = t0 + j * kScanThreads + threadIdx.x;
    if (i < n_keys) s += counts[i];
  }
  int total;
  block_inclusive_scan(s, total);
  if (threadIdx.x == 0) tile_sums[blockIdx.x] = total;
}

// Step 2b: offsets[i] = sum of counts[0 .. i) for i in [0, n_keys]; each
// block first sums the tiles before its own.
__global__ void __launch_bounds__(kScanThreads)
    msda_segment_scan(const int* __restrict__ counts,
                      const int* __restrict__ tile_sums, long long n_keys,
                      int* __restrict__ offsets) {
  const long long t0 = (long long)blockIdx.x * kScanTile;
  int c[kScanItems];  // all loads in flight before the first scan
#pragma unroll
  for (int j = 0; j < kScanItems; ++j) {
    const long long i = t0 + j * kScanThreads + threadIdx.x;
    c[j] = i < n_keys ? __ldg(counts + i) : 0;
  }
  int before = 0;
  for (int t = threadIdx.x; t < (int)blockIdx.x; t += kScanThreads)
    before += __ldg(tile_sums + t);
  int run;
  block_inclusive_scan(before, run);
#pragma unroll
  for (int j = 0; j < kScanItems; ++j) {
    const long long i = t0 + j * kScanThreads + threadIdx.x;
    int total;
    const int inc = block_inclusive_scan(c[j], total);
    if (i <= n_keys) offsets[i] = run + inc - c[j];
    run += total;
  }
}

// Step 3: each in-bounds entry into its key's segment, at its rank; one
// thread takes the 4 corners of a sample.
__global__ void __launch_bounds__(256)
    msda_segment_place(const int4* __restrict__ entries,
                       const int* __restrict__ offsets,
                       int2* __restrict__ placed, int n_samples) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= n_samples) return;
  int4 en[4];
  int at[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) en[c] = __ldg(entries + 4LL * s + c);
#pragma unroll
  for (int c = 0; c < 4; ++c)
    at[c] = en[c].x < 0 ? -1 : __ldg(offsets + en[c].x) + en[c].y;
#pragma unroll
  for (int c = 0; c < 4; ++c)
    if (at[c] >= 0) placed[at[c]] = make_int2(4 * s + c, en[c].z);
}

constexpr int kNoEntry = 0x7fffffff;  // above every entry index

// One warp sorts the n entries at p by e into out: a lane ranks kOrderRun
// entries at once against all n (the rank of e is the count of smaller e;
// the e of a segment are distinct), read in runs of 32 through shuffles.
__device__ __forceinline__ void warp_order(const int2* __restrict__ p,
                                           int2* __restrict__ out, int n,
                                           int lane) {
  for (int i0 = 0; i0 < n; i0 += 32 * kOrderRun) {
    int2 v[kOrderRun];
    int rank[kOrderRun];
#pragma unroll
    for (int u = 0; u < kOrderRun; ++u) {
      const int i = i0 + u * 32 + lane;
      v[u] = i < n ? __ldg(p + i) : make_int2(kNoEntry, 0);
      rank[u] = 0;
    }
    for (int t0 = 0; t0 < n; t0 += 32) {
      const int t = t0 + lane;
      const int et = t < n ? __ldg(p + t).x : kNoEntry;
      const int m = min(32, n - t0);
      for (int j = 0; j < m; ++j) {
        const int ej = __shfl_sync(0xffffffffu, et, j);
#pragma unroll
        for (int u = 0; u < kOrderRun; ++u) rank[u] += ej < v[u].x;
      }
    }
#pragma unroll
    for (int u = 0; u < kOrderRun; ++u)
      if (i0 + u * 32 + lane < n) out[rank[u]] = v[u];
  }
}

// Step 4: each segment sorted by entry index e, from placed into slots. A
// thread takes a key: up to kOrderSmall entries it ranks in registers; a
// longer key it lists in long_keys, for msda_segment_order_long.
__global__ void __launch_bounds__(256)
    msda_segment_order(const int* __restrict__ offsets,
                       const int2* __restrict__ placed,
                       int2* __restrict__ slots, int* __restrict__ long_keys,
                       int* __restrict__ n_long, long long n_keys) {
  const long long key = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (key >= n_keys) return;
  const int lo = __ldg(offsets + key);
  const int n = __ldg(offsets + key + 1) - lo;
  if (n > kOrderSmall) {
    long_keys[atomicAdd(n_long, 1)] = (int)key;
    return;
  }
  int2 v[kOrderSmall];
#pragma unroll
  for (int i = 0; i < kOrderSmall; ++i)
    v[i] = i < n ? __ldg(placed + lo + i) : make_int2(kNoEntry, 0);
#pragma unroll
  for (int i = 0; i < kOrderSmall; ++i) {
    int r = 0;
#pragma unroll
    for (int j = 0; j < kOrderSmall; ++j) r += v[j].x < v[i].x;
    if (i < n) slots[lo + r] = v[i];
  }
}

// Step 4, the listed keys: a warp each (warp_order), kOrderLongWarps
// warps walking the list. Which warp takes which key does not change the
// result.
__global__ void __launch_bounds__(256)
    msda_segment_order_long(const int* __restrict__ offsets,
                            const int2* __restrict__ placed,
                            int2* __restrict__ slots,
                            const int* __restrict__ long_keys,
                            const int* __restrict__ n_long) {
  const int lane = threadIdx.x & 31;
  const int n_listed = *n_long;
  for (int i = (blockIdx.x * blockDim.x + threadIdx.x) >> 5; i < n_listed;
       i += (gridDim.x * blockDim.x) >> 5) {
    const int key = long_keys[i];
    const int lo = __ldg(offsets + key);
    warp_order(placed + lo, slots + lo, __ldg(offsets + key + 1) - lo, lane);
  }
}

// The f32 sum of one lane's V channels over a segment, as a fixed tree of
// fan-in kSumFan: term t (0-based, in slot order) goes into `run`; after
// each kSumFan terms `run` is added into `mid`, after each kSumFan^2 terms
// `mid` into `top`; the total is top + (mid + run). The shape depends only
// on the segment's length, so equal inputs give equal bits.
template <int V>
struct BlockedSum {
  float run[V], mid[V], top[V];

  __device__ __forceinline__ BlockedSum() {
#pragma unroll
    for (int i = 0; i < V; ++i) run[i] = mid[i] = top[i] = 0.0f;
  }

  __device__ __forceinline__ void add(int t, float w, const float (&g)[V]) {
#pragma unroll
    for (int i = 0; i < V; ++i) run[i] = fmaf(w, g[i], run[i]);
    if ((t & (kSumFan - 1)) == kSumFan - 1) {
#pragma unroll
      for (int i = 0; i < V; ++i) {
        mid[i] += run[i];
        run[i] = 0.0f;
      }
      if ((t & (kSumFan * kSumFan - 1)) == kSumFan * kSumFan - 1) {
#pragma unroll
        for (int i = 0; i < V; ++i) {
          top[i] += mid[i];
          mid[i] = 0.0f;
        }
      }
    }
  }

  __device__ __forceinline__ void total(float (&o)[V]) const {
#pragma unroll
    for (int i = 0; i < V; ++i) o[i] = top[i] + (mid[i] + run[i]);
  }
};

// Step 5: out[key, :] = sum over the key's segment of weight * grad[row, :]
// (rows of `width` channels, f32 sums, V channels a thread; row = e /
// entries_per_row). A block takes keys_per_block consecutive keys, whose
// segments lie together in slots: it stages them through shared memory in
// chunks of kSumChunk pairs, with coalesced loads, and each thread walks
// its key's part of each chunk in slot order, four grad rows in flight,
// into a BlockedSum. A row wider than threads_per_row * V channels is
// walked once per channel block.
template <typename TG, typename TO, int V>
__global__ void __launch_bounds__(kSumThreads)
    msda_segment_sum(const int* __restrict__ offsets,
                     const int2* __restrict__ slots,
                     const TG* __restrict__ grad, TO* __restrict__ out,
                     long long n_keys, int width, int threads_per_row,
                     int entries_per_row) {
  __shared__ int2 pairs[kSumChunk];
  const int lanes = width / V;  // channel groups of a row
  const int keys_per_block = blockDim.x / threads_per_row;
  const int k_local = threadIdx.x / threads_per_row;
  const int cg0 = threadIdx.x % threads_per_row;
  const long long k0 = (long long)blockIdx.x * keys_per_block;
  const long long k1 = min(k0 + keys_per_block, n_keys);
  const long long key = k0 + k_local;
  const bool active = k_local < keys_per_block && key < n_keys;
  const int seg_lo = __ldg(offsets + k0);
  const int seg_hi = __ldg(offsets + k1);
  const int my_lo = active ? __ldg(offsets + key) : 0;
  const int my_hi = active ? __ldg(offsets + key + 1) : 0;
  for (int c0 = 0; c0 < lanes; c0 += threads_per_row) {
    const int cg = c0 + cg0;
    const bool live = active && cg < lanes;
    const TG* gbase = grad + (long long)cg * V;
    BlockedSum<V> acc;
    for (int base = seg_lo; base < seg_hi; base += kSumChunk) {
      const int n = min(kSumChunk, seg_hi - base);
      __syncthreads();  // the previous chunk has been read
      for (int i = threadIdx.x; i < n; i += blockDim.x) {
        const int2 sl = __ldg(slots + base + i);
        pairs[i] = make_int2(sl.x / entries_per_row, sl.y);
      }
      __syncthreads();
      if (!live) continue;
      const int lo = max(my_lo - base, 0);
      const int hi = min(my_hi - base, n);
      const int t0 = base - my_lo;  // term index of pairs[0] in the segment
      int j = lo;
      for (; j + 4 <= hi; j += 4) {
        float v[4][V];
        float wt[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int2 pr = pairs[j + u];
          wt[u] = __int_as_float(pr.y);
          VecIO<TG, V>::load(gbase + (long long)pr.x * width, v[u]);
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) acc.add(t0 + j + u, wt[u], v[u]);
      }
      for (; j < hi; ++j) {
        const int2 pr = pairs[j];
        float v[V];
        VecIO<TG, V>::load(gbase + (long long)pr.x * width, v);
        acc.add(t0 + j, __int_as_float(pr.y), v);
      }
    }
    if (live) {
      float o[V];
      acc.total(o);
      VecIO<TO, V>::store(out + key * width + (long long)cg * V, o);
    }
  }
}

inline unsigned int blocks_for(long long n, int threads) {
  return (unsigned int)((n + threads - 1) / threads);
}

// Before step 1: zeroes the counters.
inline cudaError_t segment_clear(const Segments& sg, long long n_keys,
                                 cudaStream_t stream) {
  if (n_keys == 0) return cudaSuccess;
  const long long cap = 132LL * 8;  // a few waves of the card's 132 SMs
  const long long want = blocks_for(n_keys, 256);
  msda_segment_clear<<<(unsigned int)(want < cap ? want : cap), 256, 0,
                       stream>>>(sg.counts, n_keys + 1);
  return cudaGetLastError();
}

template <typename TG, typename TO, int V>
static cudaError_t launch_segment_sum(const Segments& sg, long long n_keys,
                                      const TG* grad, TO* out, int width,
                                      int entries_per_row,
                                      cudaStream_t stream) {
  const int lanes = width / V;
  const int tpr = lanes < kSumThreads ? lanes : kSumThreads;
  const int kpb = kSumThreads / tpr;
  msda_segment_sum<TG, TO, V>
      <<<blocks_for(n_keys, kpb), kpb * tpr, 0, stream>>>(
          sg.offsets, sg.slots, grad, out, n_keys, width, tpr,
          entries_per_row);
  return cudaGetLastError();
}

// Steps 2-5, after step 1 has recorded every entry: out [n_keys, width] in
// TO from grad [rows, width] in TG, row r holding the gradient of samples
// r * samples_per_row ... (r + 1) * samples_per_row - 1.
template <typename TG, typename TO>
cudaError_t segment_reduce(const Segments& sg, long long n_keys,
                           long long n_entries, int samples_per_row,
                           const TG* grad, TO* out, int width,
                           cudaStream_t stream) {
  if (n_keys == 0) return cudaSuccess;
  const unsigned int tiles = (unsigned int)scan_tiles(n_keys);
  msda_segment_tile_sums<<<tiles, kScanThreads, 0, stream>>>(
      sg.counts, n_keys, sg.tile_sums);
  msda_segment_scan<<<tiles, kScanThreads, 0, stream>>>(
      sg.counts, sg.tile_sums, n_keys, sg.offsets);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (n_entries > 0) {
    msda_segment_place<<<blocks_for(n_entries / 4, 256), 256, 0, stream>>>(
        sg.entries, sg.offsets, sg.placed, (int)(n_entries / 4));
    msda_segment_order<<<blocks_for(n_keys, 256), 256, 0, stream>>>(
        sg.offsets, sg.placed, sg.slots, sg.long_keys, sg.counts + n_keys,
        n_keys);
    msda_segment_order_long<<<kOrderLongWarps / 8, 256, 0, stream>>>(
        sg.offsets, sg.placed, sg.slots, sg.long_keys, sg.counts + n_keys);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const int epr = 4 * samples_per_row;
  // widest channel group (16-byte loads of grad) that divides the row and
  // keeps every access of grad and out aligned
  const int v = pick_vec(width, grad, sizeof(TG), out, sizeof(TO));
  if constexpr (sizeof(TG) == 2) {
    if (v == 4 && width % 8 == 0 &&
        (uintptr_t)grad % (8 * sizeof(TG)) == 0 &&
        (uintptr_t)out % (8 * sizeof(TO)) == 0)
      return launch_segment_sum<TG, TO, 8>(sg, n_keys, grad, out, width,
                                           epr, stream);
  }
  if (v == 4)
    return launch_segment_sum<TG, TO, 4>(sg, n_keys, grad, out, width,
                                         epr, stream);
  if (v == 2)
    return launch_segment_sum<TG, TO, 2>(sg, n_keys, grad, out, width,
                                         epr, stream);
  return launch_segment_sum<TG, TO, 1>(sg, n_keys, grad, out, width, epr,
                                       stream);
}

}  // namespace kinet

// C entry bound with ctypes: the int32 elements of the scratch buffer that
// the backward entry point of this library needs.
extern "C" long long msda_segment_scratch_ints(long long n_keys,
                                               long long n_entries) {
  return kinet::segment_scratch_ints(n_keys, n_entries);
}
