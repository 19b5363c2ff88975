// Shared device helpers of the multi-scale deformable attention (MSDA)
// kernels: vector loads/stores of f32 or bf16 channel groups, and the
// corner rule of bilinear sampling with grid_sample(align_corners=False,
// padding_mode="zeros") semantics (corner_at), which every MSDA kernel,
// forward and backward, derives its corners from.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace kinet {

// dtype codes shared with the Python wrappers
enum DType { kF32 = 0, kBF16 = 1 };

// V consecutive channels moved as one load or store, converted to f32.
template <typename T, int V>
struct VecIO;

template <>
struct VecIO<float, 1> {
  __device__ __forceinline__ static void load(const float* p, float* o) {
    o[0] = __ldg(p);
  }
  __device__ __forceinline__ static void store(float* p, const float* v) {
    p[0] = v[0];
  }
};

template <>
struct VecIO<float, 2> {
  __device__ __forceinline__ static void load(const float* p, float* o) {
    float2 t = __ldg(reinterpret_cast<const float2*>(p));
    o[0] = t.x;
    o[1] = t.y;
  }
  __device__ __forceinline__ static void store(float* p, const float* v) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  }
};

template <>
struct VecIO<float, 4> {
  __device__ __forceinline__ static void load(const float* p, float* o) {
    float4 t = __ldg(reinterpret_cast<const float4*>(p));
    o[0] = t.x;
    o[1] = t.y;
    o[2] = t.z;
    o[3] = t.w;
  }
  __device__ __forceinline__ static void store(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

__device__ __forceinline__ float2 bf2_to_f2(unsigned int bits) {
  __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&bits);
  return __bfloat1622float2(h);
}

__device__ __forceinline__ unsigned int f2_to_bf2(float a, float b) {
  __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const unsigned int*>(&h);
}

template <>
struct VecIO<__nv_bfloat16, 1> {
  __device__ __forceinline__ static void load(const __nv_bfloat16* p,
                                              float* o) {
    o[0] = __bfloat162float(p[0]);
  }
  __device__ __forceinline__ static void store(__nv_bfloat16* p,
                                               const float* v) {
    p[0] = __float2bfloat16(v[0]);
  }
};

template <>
struct VecIO<__nv_bfloat16, 2> {
  __device__ __forceinline__ static void load(const __nv_bfloat16* p,
                                              float* o) {
    float2 t = bf2_to_f2(__ldg(reinterpret_cast<const unsigned int*>(p)));
    o[0] = t.x;
    o[1] = t.y;
  }
  __device__ __forceinline__ static void store(__nv_bfloat16* p,
                                               const float* v) {
    *reinterpret_cast<unsigned int*>(p) = f2_to_bf2(v[0], v[1]);
  }
};

template <>
struct VecIO<__nv_bfloat16, 4> {
  __device__ __forceinline__ static void load(const __nv_bfloat16* p,
                                              float* o) {
    uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
    float2 a = bf2_to_f2(u.x);
    float2 b = bf2_to_f2(u.y);
    o[0] = a.x;
    o[1] = a.y;
    o[2] = b.x;
    o[3] = b.y;
  }
  __device__ __forceinline__ static void store(__nv_bfloat16* p,
                                               const float* v) {
    uint2 u;
    u.x = f2_to_bf2(v[0], v[1]);
    u.y = f2_to_bf2(v[2], v[3]);
    *reinterpret_cast<uint2*>(p) = u;
  }
};

template <>
struct VecIO<__nv_bfloat16, 8> {
  __device__ __forceinline__ static void load(const __nv_bfloat16* p,
                                              float* o) {
    uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    const unsigned int w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float2 t = bf2_to_f2(w[i]);
      o[2 * i] = t.x;
      o[2 * i + 1] = t.y;
    }
  }
  __device__ __forceinline__ static void store(__nv_bfloat16* p,
                                               const float* v) {
    uint4 u;
    u.x = f2_to_bf2(v[0], v[1]);
    u.y = f2_to_bf2(v[2], v[3]);
    u.z = f2_to_bf2(v[4], v[5]);
    u.w = f2_to_bf2(v[6], v[7]);
    *reinterpret_cast<uint4*>(p) = u;
  }
};

// N consecutive floats from p (p aligned to the widest of 16, 8 and 4
// bytes that divides N * 4): a (q, m)'s sample locations or weights.
template <int N>
__device__ __forceinline__ void load_floats(const float* __restrict__ p,
                                            float (&o)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 t = __ldg(reinterpret_cast<const float4*>(p + i));
      o[i] = t.x;
      o[i + 1] = t.y;
      o[i + 2] = t.z;
      o[i + 3] = t.w;
    }
  } else if constexpr (N % 2 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 2) {
      const float2 t = __ldg(reinterpret_cast<const float2*>(p + i));
      o[i] = t.x;
      o[i + 1] = t.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) o[i] = __ldg(p + i);
  }
}

// Corner `corner` (dy = corner >> 1, dx = corner & 1) of the sample at
// pixel (x, y) = (loc_x * W - 0.5, loc_y * H - 0.5): true if it is read,
// with its cell in the level and its bilinear factors. A corner outside
// [0, W-1] x [0, H-1] (grid_sample's zeros padding), or at row >= vh or
// column >= vw (valid extent of the level; pass H, W for no padding), is
// not read and weighs 0.
__device__ __forceinline__ bool corner_at(int corner, int h, int w, float x,
                                          float y, float vh, float vw,
                                          long long& cell, float& wy,
                                          float& wx) {
  const float x0 = floorf(x);
  const float y0 = floorf(y);
  const float xmax = fminf((float)(w - 1), vw - 1.0f);
  const float ymax = fminf((float)(h - 1), vh - 1.0f);
  const int dy = corner >> 1;
  const int dx = corner & 1;
  const float yi = y0 + dy;
  const float xi = x0 + dx;
  wy = dy ? y - y0 : 1.0f - (y - y0);
  wx = dx ? x - x0 : 1.0f - (x - x0);
  cell = (long long)yi * w + (long long)xi;
  return yi >= 0.0f && yi <= ymax && xi >= 0.0f && xi <= xmax;
}

// Backward of one bilinear sample for one lane's V channels: the partial
// dot products d_c = <go, v_corner>, accumulated as
//   a  += bil_c * d_c,   bx += d bil_c / dx * d_c,   by += d bil_c / dy * d_c
// over the corners that corner_at reads. The table's
// gradient is not formed here: msda_segment.cuh sums it per row from the
// corners that count_corner lists.
template <typename T, int V>
__device__ __forceinline__ void sample_point_bwd(
    const T* __restrict__ base, long long row_stride, int h, int w, float x,
    float y, float vh, float vw, const float (&go)[V], float& a, float& bx,
    float& by) {
#pragma unroll
  for (int corner = 0; corner < 4; ++corner) {
    long long cell;
    float wy, wx;
    if (!corner_at(corner, h, w, x, y, vh, vw, cell, wy, wx)) continue;
    float v[V];
    VecIO<T, V>::load(base + cell * row_stride, v);
    float dot = 0.0f;
#pragma unroll
    for (int i = 0; i < V; ++i) dot = fmaf(go[i], v[i], dot);
    a = fmaf(wy * wx, dot, a);
    bx = fmaf((corner & 1) ? wy : -wy, dot, bx);
    by = fmaf((corner >> 1) ? wx : -wx, dot, by);
  }
}

// Sums over the corners that corner_at reads of the bilinear weight and
// of its derivatives along x and y (the terms that a gradient of the weight
// sum contributes).
__device__ __forceinline__ void corner_weight_sums(int h, int w, float x,
                                                   float y, float vh,
                                                   float vw, float& s,
                                                   float& sx, float& sy) {
  s = sx = sy = 0.0f;
#pragma unroll
  for (int corner = 0; corner < 4; ++corner) {
    long long cell;
    float wy, wx;
    if (!corner_at(corner, h, w, x, y, vh, vw, cell, wy, wx)) continue;
    s += wy * wx;
    sx += (corner & 1) ? wy : -wy;
    sy += (corner >> 1) ? wx : -wx;
  }
}

// Sum over the G lanes of a lane group (G a power of two <= 32, groups
// aligned within the warp). Every lane of the warp must call it.
template <int G>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o, G);
  return v;
}

// Lane-group width of msda_raw_pool_bwd's dots pass: one group of G lanes
// per (batch, query, head, level), each lane taking channel groups lane,
// lane + G, ...
inline int pick_group(int channel_groups) {
  if (channel_groups > 16) return 32;
  if (channel_groups > 8) return 16;
  return 8;
}

// Widest channel group (4, 2 or 1) that divides the channel count and
// keeps every vector access of the input table (in_bytes per element) and
// of the output (out_bytes per element) aligned.
inline int pick_vec(int channels, const void* in, int in_bytes,
                    const void* out, int out_bytes) {
  const int cands[3] = {4, 2, 1};
  for (int v : cands) {
    if (channels % v == 0 && (uintptr_t)in % ((uintptr_t)v * in_bytes) == 0 &&
        (uintptr_t)out % ((uintptr_t)v * out_bytes) == 0)
      return v;
  }
  return 1;
}

}  // namespace kinet
