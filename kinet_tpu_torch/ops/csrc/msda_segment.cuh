// Segmented reduction of the MSDA backward kernels' table gradient
// (dvalue of msda_bwd.cu, dsrc of msda_raw_pool_bwd.cu), with no
// floating-point atomics.
//
// The scatter-add  out[key_c] += w_c * grad[row]  over every in-bounds
// bilinear corner c of every sample becomes a gather per key:
//
//   1. record  (the backward's dots pass, msda_*_bwd.cu): every corner
//      gets an entry at the fixed position e = (sample * 4 + corner): its
//      key (the output row), its weight aw * bil_c and its rank among the
//      entries of that key, the result of an int atomicAdd on counts[key]
//      (issued before the corner's dot product, stored after it); a
//      corner that the forward does not read gets key -1;
//   2. scan    (msda_segment_tile_sums, msda_segment_scan): offsets =
//      exclusive prefix sum of counts, over tiles of kScanTile keys;
//   3. place   (msda_segment_place): slots[offsets[key] + rank] = (source
//      row, weight), so that the entries of each key lie together;
//   4. sum     (msda_segment_sum): each key's row is the f32 sum of
//      weight * grad[source row] over its segment, written once in the
//      output's type; a key with an empty segment writes exact zeros.
//
// So the output needs no zero-fill, no f32 buffer and no cast. Integer
// atomics touch only the counters (one per in-bounds corner). The order of
// the entries within a segment follows the atomics, so the last bits of a
// row's f32 sum may change from run to run, as with f32 atomics.
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

struct Segments {
  int* counts;     // [n_keys], zeroed by msda_segment_clear
  int* offsets;    // [n_keys + 1]
  int* tile_sums;  // [scan tiles]
  int4* entries;   // [n_entries]: (key, rank, weight bits, -); key -1:
                   // the corner is not read
  int2* slots;     // [n_entries]: (source row, weight bits), by key
};

inline long long scan_tiles(long long n_keys) {
  return (n_keys + 1 + kScanTile - 1) / kScanTile;
}

// int32 elements of the scratch buffer of one backward call
inline long long segment_scratch_ints(long long n_keys, long long n_entries) {
  long long n = n_keys + (n_keys + 1) + scan_tiles(n_keys);
  n = (n + 3) & ~3LL;  // entries are 16-byte aligned
  return n + 6 * n_entries;
}

inline Segments carve_segments(void* scratch, long long n_keys,
                               long long n_entries) {
  int* p = static_cast<int*>(scratch);
  Segments sg;
  sg.counts = p;
  p += n_keys;
  sg.offsets = p;
  p += n_keys + 1;
  sg.tile_sums = p;
  p += scan_tiles(n_keys);
  while ((p - static_cast<int*>(scratch)) & 3) ++p;
  sg.entries = reinterpret_cast<int4*>(p);
  sg.slots = reinterpret_cast<int2*>(sg.entries + n_entries);
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

// Step 3: each in-bounds entry into its key's segment; one thread takes
// the 4 corners of a sample. The source row of sample s is s / per_row
// (per_row = L * P samples a (b, q, m)).
__global__ void __launch_bounds__(256)
    msda_segment_place(const int4* __restrict__ entries,
                       const int* __restrict__ offsets,
                       int2* __restrict__ slots, int n_samples,
                       int per_row) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= n_samples) return;
  int4 en[4];
  int at[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) en[c] = __ldg(entries + 4LL * s + c);
#pragma unroll
  for (int c = 0; c < 4; ++c)
    at[c] = en[c].x < 0 ? -1 : __ldg(offsets + en[c].x) + en[c].y;
  const int row = s / per_row;
#pragma unroll
  for (int c = 0; c < 4; ++c)
    if (at[c] >= 0) slots[at[c]] = make_int2(row, en[c].z);
}

// Step 4: out[key, :] = sum over the key's segment of weight * grad[row, :]
// (rows of `width` channels, f32 sums, V channels a thread). A block takes
// keys_per_block consecutive keys, whose segments lie together in slots:
// it stages them through shared memory in chunks of kSumChunk pairs, with
// coalesced loads, and each thread walks its key's part of each chunk in
// slot order, four grad rows in flight. A row wider than threads_per_row
// * V channels is walked once per channel block.
template <typename TG, typename TO, int V>
__global__ void __launch_bounds__(kSumThreads)
    msda_segment_sum(const int* __restrict__ offsets,
                     const int2* __restrict__ slots,
                     const TG* __restrict__ grad, TO* __restrict__ out,
                     long long n_keys, int width, int threads_per_row) {
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
    float acc[V];
#pragma unroll
    for (int i = 0; i < V; ++i) acc[i] = 0.0f;
    for (int base = seg_lo; base < seg_hi; base += kSumChunk) {
      const int n = min(kSumChunk, seg_hi - base);
      __syncthreads();  // the previous chunk has been read
      for (int i = threadIdx.x; i < n; i += blockDim.x)
        pairs[i] = slots[base + i];
      __syncthreads();
      if (!live) continue;
      const int lo = max(my_lo - base, 0);
      const int hi = min(my_hi - base, n);
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
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int i = 0; i < V; ++i) acc[i] = fmaf(wt[u], v[u][i], acc[i]);
      }
      for (; j < hi; ++j) {
        const int2 pr = pairs[j];
        float v[V];
        VecIO<TG, V>::load(gbase + (long long)pr.x * width, v);
        const float wt = __int_as_float(pr.y);
#pragma unroll
        for (int i = 0; i < V; ++i) acc[i] = fmaf(wt, v[i], acc[i]);
      }
    }
    if (live) VecIO<TO, V>::store(out + key * width + (long long)cg * V, acc);
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
                       stream>>>(sg.counts, n_keys);
  return cudaGetLastError();
}

template <typename TG, typename TO, int V>
static cudaError_t launch_segment_sum(const Segments& sg, long long n_keys,
                                      const TG* grad, TO* out, int width,
                                      cudaStream_t stream) {
  const int lanes = width / V;
  const int tpr = lanes < kSumThreads ? lanes : kSumThreads;
  const int kpb = kSumThreads / tpr;
  msda_segment_sum<TG, TO, V>
      <<<blocks_for(n_keys, kpb), kpb * tpr, 0, stream>>>(
          sg.offsets, sg.slots, grad, out, n_keys, width, tpr);
  return cudaGetLastError();
}

// Steps 2-4, after step 1 has recorded every entry: out [n_keys, width] in
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
        sg.entries, sg.offsets, sg.slots, (int)(n_entries / 4),
        samples_per_row);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  // widest channel group (16-byte loads of grad) that divides the row and
  // keeps every access of grad and out aligned
  const int v = pick_vec(width, grad, sizeof(TG), out, sizeof(TO));
  if constexpr (sizeof(TG) == 2) {
    if (v == 4 && width % 8 == 0 &&
        (uintptr_t)grad % (8 * sizeof(TG)) == 0 &&
        (uintptr_t)out % (8 * sizeof(TO)) == 0)
      return launch_segment_sum<TG, TO, 8>(sg, n_keys, grad, out, width,
                                           stream);
  }
  if (v == 4)
    return launch_segment_sum<TG, TO, 4>(sg, n_keys, grad, out, width,
                                         stream);
  if (v == 2)
    return launch_segment_sum<TG, TO, 2>(sg, n_keys, grad, out, width,
                                         stream);
  return launch_segment_sum<TG, TO, 1>(sg, n_keys, grad, out, width, stream);
}

}  // namespace kinet

// C entry bound with ctypes: the int32 elements of the scratch buffer that
// the backward entry point of this library needs.
extern "C" long long msda_segment_scratch_ints(long long n_keys,
                                               long long n_entries) {
  return kinet::segment_scratch_ints(n_keys, n_entries);
}
