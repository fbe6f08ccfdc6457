// Building blocks the flash and cache attention kernels share: element
// loads and stores in f32 or bf16, the ex2 unit, bf16 packing, and the
// tensor-core design's block layout and wgmma products over TMA's
// 128-byte-swizzled tiles.  Each kernel keeps its own tile shapes, masking
// and softmax; the CUDA-core design's product loops stay in each kernel,
// where ptxas schedules them with the kernel's own code (the flash
// kernel's SASS is unchanged by the move of these helpers).
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"

namespace attn {

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// N consecutive elements (N = 1, 2 or 4, N-element aligned) as f32
template <int N, typename T>
__device__ __forceinline__ void load_vec(const T* p, float* out) {
  if constexpr (N == 1) {
    if constexpr (sizeof(T) == 4) out[0] = *p;
    else out[0] = __bfloat162float(*p);
  } else if constexpr (N == 4) {
    const float4 x = load4(p);
    out[0] = x.x; out[1] = x.y; out[2] = x.z; out[3] = x.w;
  } else if constexpr (sizeof(T) == 4) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    out[0] = x.x; out[1] = x.y;
  } else {
    const float2 x =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    out[0] = x.x; out[1] = x.y;
  }
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }

__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// 2^x by the special function unit (2 ulp; 2^-inf = +0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&t);
}

// ---------------------------------------------------------------------------
// Tensor cores: a block of two consumer warpgroups of 64 query rows and one
// producer warp; tiles in TMA's 128-byte swizzle, 64 columns an atom (a
// wider head is D / 64 atoms, head_dim 112 two with the last 16 columns
// zero-filled)
// ---------------------------------------------------------------------------

constexpr int kTcRows = 128;                  // query rows per block
constexpr int kTcConsumers = 256;             // two consumer warpgroups
constexpr int kTcThreads = kTcConsumers + 32; // and one producer warp
constexpr int kAtomBytes = 128;               // a swizzle atom's row: 64 bf16

// S = Q K^T of a warpgroup's 64 rows (Qw) over a tile's BK keys (Kst), in
// blocks of 64 keys, both operands K-major in shared memory; D / 16 k16
// steps (7 at head_dim 112: the eighth would multiply the zero padding)
template <int D, int BK>
__device__ __forceinline__ void wgmma_scores(float (&sc)[BK / 64][32],
                                             const uint8_t* Qw,
                                             const uint8_t* Kst) {
  constexpr int Q_ATOM = kTcRows * kAtomBytes, KV_ATOM = BK * kAtomBytes;
  hopper::wgmma_fence();
#pragma unroll
  for (int n = 0; n < BK / 64; ++n)
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int a = kk / 4, off = (kk % 4) * 32;
      hopper::wgmma_m64n64k16_ss(
          sc[n], hopper::desc_sw128(Qw + a * Q_ATOM + off, 16, 1024),
          hopper::desc_sw128(Kst + a * KV_ATOM + n * 64 * kAtomBytes + off,
                             16, 1024),
          kk > 0);
    }
  hopper::wgmma_commit();
}

// O += P V: P from registers (wgmma's k16 A fragments), V MN-major in
// shared memory (16 keys per step, one 64-column atom per product; at
// head_dim 112 the second atom's last 16 columns are zeros and their sums
// are not stored)
template <int D, int BK>
__device__ __forceinline__ void wgmma_pv(float (&acc)[(D + 63) / 64][32],
                                         const uint32_t (&pa)[BK / 16][4],
                                         const uint8_t* Vst) {
  constexpr int KV_ATOM = BK * kAtomBytes;
  hopper::wgmma_fence();
#pragma unroll
  for (int j = 0; j < BK / 16; ++j)
#pragma unroll
    for (int n = 0; n < (D + 63) / 64; ++n)
      hopper::wgmma_m64n64k16_rs_tb(
          acc[n], pa[j],
          hopper::desc_sw128(Vst + n * KV_ATOM + j * 16 * kAtomBytes, 1024,
                             1024));
  hopper::wgmma_commit();
}

}  // namespace attn
