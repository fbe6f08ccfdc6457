// Hopper (sm_90a) kernels for single-token attention over a KV cache.
//
// Replaces the TPU kernel repro/kernels/decode_attention/decode_attention.py
// ::_decode_kernel (its pl.pallas_call in decode_attention, and the GQA
// wrapper ops.py::decode_mha).  It computes the same function: for each
// batch row b and query head h, softmax(q k^T / sqrt(D)) v over the cache
// slots t < lengths[b], in f32, out = acc / max(l, 1e-20).  No arithmetic
// reads a slot at or past lengths[b], so whatever such a slot holds (even
// NaN) has exactly no influence on the output.
//
// Layout: q and o are (B, H, D), the cache k and v (B, T, Hkv, D), all
// contiguous, read in place (T need not be a multiple of the tile).  D is
// 32, 64, 112, 128 or 256: a row is a whole number of 16-byte chunks (at 112,
// 28 in f32 and 14 in bf16, so a group's 8 lanes take 4 or 2 of them, the
// last ones partly idle), and the TMA box is one unswizzled row wide.  Inputs
// are f32 or bf16; the output has the input's type; the arithmetic is f32.
//
// What bounds it on this card: bytes.  One SmolLM-360M decode step at B 8
// reads K and V over ~1040 live slots, 21.3 MB in f32 per layer: 6.4 us at
// 3.35 TB/s (3.2 us in bf16).  The arithmetic, 4 D flops per (slot, query
// head), is far below the FP32 peak.
//
// Design ("split+merge"): B * Hkv rows of work (40 at B 8) cannot fill 132
// SMs, so the cache is split into chunks of a fixed number of slots (a
// multiple of 64, chosen by the caller from T, B and Hkv so that the grid
// has at least two blocks per SM).
//
// Split phase, decode_split_kernel: one block of 128 threads per (chunk, kv
// head, batch row), serving the G = H / Hkv query heads of its kv head, so
// each cache tile is read once for all of them.  The block reads
// lengths[b] on the device (the host never does: a decode step does not
// synchronise); a chunk with no live slot writes m = -inf, l = 0 and loads
// nothing.  Otherwise one thread issues TMA loads of the chunk's live
// 64-slot tiles, K tiles then V tiles, through tensor maps over the cache
// in place, into a ring of 2 to 4 shared-memory stages with a full mbarrier
// each; as soon as a stage has been consumed it is refilled, so a chunk of
// up to 4 tiles is in flight at once.  Tiles keep the cache's type in
// shared memory and are read with 16-byte loads (4 f32 or 8 bf16): a group
// of 8 lanes takes one slot's score (3 shuffles), one warp per head takes
// the chunk's max and sum, and one thread per (head, 16-byte column chunk)
// accumulates P V.  The block stores its partial (m, l, acc) in f32.
//
// Merge phase, decode_merge_kernel: one block per (query head, batch row)
// and one thread per column combines the chunks: m* = max m_i over the
// chunks with l_i > 0, l = sum e^{m_i - m*} l_i, out = sum e^{m_i - m*}
// acc_i / max(l, 1e-20).  A chunk with l_i = 0 adds exactly nothing (its m
// and acc are never read, so -inf - -inf never arises).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kTile = 64;       // cache slots per TMA tile
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
// returned by the entry point for a head_dim or dtype it was not built
// for, for more shared memory than the device allows, or a bad chunk
constexpr int kErrUnsupported = -1;
constexpr int kErrSharedMemory = -2;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// the VE values of a 16-byte chunk as f32
__device__ __forceinline__ void load16(const float* p, float* out) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  out[0] = x.x; out[1] = x.y; out[2] = x.z; out[3] = x.w;
}

__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* out) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <typename T, int D>
struct Shape {
  static constexpr int TILE_BYTES = kTile * D * (int)sizeof(T);
  static constexpr int STAGES = TILE_BYTES <= 16384 ? 4 : 2;
  static constexpr int VE = 16 / (int)sizeof(T);   // values per 16 bytes
  static constexpr int NC = D / VE;                // 16-byte chunks per row
};

struct Layout {
  size_t q, s, acc, m, l, bar, bytes;   // byte offsets
};

template <typename T, int D>
__host__ __device__ inline Layout make_layout(int G, int chunk) {
  using C = Shape<T, D>;
  Layout L;
  size_t off = (size_t)C::STAGES * C::TILE_BYTES;
  L.q = off;   off += sizeof(float) * (size_t)G * D;       // scaled queries
  L.s = off;   off += sizeof(float) * (size_t)G * chunk;   // scores, probs
  L.acc = off; off += sizeof(float) * (size_t)G * D;       // P V
  L.m = off;   off += sizeof(float) * G;
  L.l = off;   off += sizeof(float) * G;
  off = (off + 7) & ~(size_t)7;
  L.bar = off; off += 8 * C::STAGES;
  L.bytes = off + 128;   // slack to align the stages to 128 bytes
  return L;
}

// load i of a chunk (K tiles 0..n_tiles-1, then V tiles) into its stage
template <typename T, int D>
__device__ __forceinline__ void issue_tile(uint8_t* stages, uint64_t* full,
                                           const CUtensorMap* kmap,
                                           const CUtensorMap* vmap, int i,
                                           int n_tiles, int hk, int c0,
                                           int b) {
  using C = Shape<T, D>;
  const int s = i % C::STAGES;
  hopper::mbar_expect_tx(&full[s], C::TILE_BYTES);
  hopper::tma_load_4d(stages + (size_t)s * C::TILE_BYTES,
                      i < n_tiles ? kmap : vmap, &full[s], 0, hk,
                      c0 + (i % n_tiles) * kTile, b);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap vmap,
                    const T* __restrict__ q, const int* __restrict__ lengths,
                    float* __restrict__ part_ml, float* __restrict__ part_acc,
                    int Tlen, int H, int Hkv, int chunk, float scale) {
  using C = Shape<T, D>;
  constexpr int ST = C::STAGES, VE = C::VE, NC = C::NC;
  constexpr int CPL = (NC + 7) / 8;   // 16-byte chunks per lane of a group
  const int split = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int n_split = gridDim.x;
  const int G = H / Hkv;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int len = min(max(lengths[b], 0), Tlen);
  const int c0 = split * chunk;
  const int nv = min(chunk, len - c0);   // live slots of this chunk
  // partials of query head h = hk * G + g: (b, h, split)
  const size_t row0 = ((size_t)b * H + (size_t)hk * G) * n_split + split;

  if (nv <= 0) {
    for (int g = tid; g < G; g += kThreads) {
      part_ml[2 * (row0 + (size_t)g * n_split)] = hopper::neg_inf();
      part_ml[2 * (row0 + (size_t)g * n_split) + 1] = 0.f;
    }
    return;
  }

  const Layout L = make_layout<T, D>(G, chunk);
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 127) & ~uintptr_t(127));
  float* Qs = reinterpret_cast<float*>(smem + L.q);
  float* Ss = reinterpret_cast<float*>(smem + L.s);
  float* Acc = reinterpret_cast<float*>(smem + L.acc);
  float* Ms = reinterpret_cast<float*>(smem + L.m);
  float* Ls = reinterpret_cast<float*>(smem + L.l);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bar);

  const int n_tiles = (nv + kTile - 1) / kTile;
  const int n_loads = 2 * n_tiles;   // K tiles, then V tiles
  if (tid == 0) {
    for (int s = 0; s < ST; ++s) hopper::mbar_init(&full[s], 1);
    hopper::mbar_fence_init();
    for (int i = 0; i < min(ST, n_loads); ++i)
      issue_tile<T, D>(smem, full, &kmap, &vmap, i, n_tiles, hk, c0, b);
  }

  const T* qb = q + ((size_t)b * H + (size_t)hk * G) * D;
  for (int i = tid; i < G * D; i += kThreads) {
    Qs[i] = to_float(qb[i]) * scale;
    Acc[i] = 0.f;
  }
  __syncthreads();

  constexpr int kGroups = kThreads / 8;      // groups of 8 lanes
  const int grp = tid >> 3, l8 = tid & 7;
  for (int i = 0; i < n_loads; ++i) {
    const int s = i % ST;
    hopper::mbar_wait(&full[s], (i / ST) & 1);
    const T* tile = reinterpret_cast<const T*>(smem + (size_t)s *
                                               C::TILE_BYTES);
    const int j0 = (i % n_tiles) * kTile;
    const int nt = min(kTile, nv - j0);
    if (i < n_tiles) {
      // scores: a group of 8 lanes per slot, 16-byte chunks of its row
#pragma unroll
      for (int u = 0; u < kTile / kGroups; ++u) {
        const int j = grp + kGroups * u;
        const bool live = j < nt;
        float kx[CPL][VE];
#pragma unroll
        for (int cc = 0; cc < CPL; ++cc) {
          const int c = l8 + 8 * cc;
          if (live && c < NC) {
            load16(tile + (size_t)j * D + c * VE, kx[cc]);
          } else {
#pragma unroll
            for (int e = 0; e < VE; ++e) kx[cc][e] = 0.f;
          }
        }
        for (int g = 0; g < G; ++g) {
          float acc = 0.f;
#pragma unroll
          for (int cc = 0; cc < CPL; ++cc) {
            const int c = l8 + 8 * cc;
            if (c < NC) {
#pragma unroll
              for (int e = 0; e < VE; ++e)
                acc = fmaf(Qs[g * D + c * VE + e], kx[cc][e], acc);
            }
          }
          acc += __shfl_xor_sync(0xffffffffu, acc, 4);
          acc += __shfl_xor_sync(0xffffffffu, acc, 2);
          acc += __shfl_xor_sync(0xffffffffu, acc, 1);
          if (live && l8 == 0) Ss[g * chunk + j0 + j] = acc;
        }
      }
      if (i == n_tiles - 1) {
        // all of the chunk's scores are in: its max, probabilities, sum
        __syncthreads();
        for (int g = warp; g < G; g += kWarps) {
          float* sg = Ss + g * chunk;
          float mx = hopper::neg_inf();
          for (int j = lane; j < nv; j += 32) mx = fmaxf(mx, sg[j]);
          mx = warp_max(mx);
          float sum = 0.f;
          for (int j = lane; j < nv; j += 32) {
            const float p = expf(sg[j] - mx);
            sg[j] = p;
            sum += p;
          }
          sum = warp_sum(sum);
          if (lane == 0) {
            Ms[g] = mx;
            Ls[g] = sum;
          }
        }
      }
    } else {
      // acc += P V: one thread per (head, 16-byte column chunk)
      for (int a = tid; a < G * NC; a += kThreads) {
        const int g = a / NC, c = a % NC;
        const float* pg = Ss + g * chunk + j0;
        float o[VE];
#pragma unroll
        for (int e = 0; e < VE; ++e) o[e] = 0.f;
        for (int j = 0; j < nt; ++j) {
          float vx[VE];
          load16(tile + (size_t)j * D + c * VE, vx);
          const float p = pg[j];
#pragma unroll
          for (int e = 0; e < VE; ++e) o[e] = fmaf(p, vx[e], o[e]);
        }
        float* ag = Acc + g * D + c * VE;
#pragma unroll
        for (int e = 0; e < VE; ++e) ag[e] += o[e];
      }
    }
    // stage s has been read by every thread: refill it
    __syncthreads();
    if (tid == 0 && i + ST < n_loads)
      issue_tile<T, D>(smem, full, &kmap, &vmap, i + ST, n_tiles, hk, c0,
                       b);
  }

  for (int i = tid; i < G * D; i += kThreads)
    part_acc[(row0 + (size_t)(i / D) * n_split) * D + i % D] = Acc[i];
  for (int g = tid; g < G; g += kThreads) {
    part_ml[2 * (row0 + (size_t)g * n_split)] = Ms[g];
    part_ml[2 * (row0 + (size_t)g * n_split) + 1] = Ls[g];
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(D)
decode_merge_kernel(const float* __restrict__ part_ml,
                    const float* __restrict__ part_acc, T* __restrict__ o,
                    int H, int n_split) {
  const size_t bh = (size_t)blockIdx.y * H + blockIdx.x;
  const int d = threadIdx.x;
  const float* ml = part_ml + 2 * bh * n_split;
  float m = hopper::neg_inf();
  for (int i = 0; i < n_split; ++i)
    if (ml[2 * i + 1] > 0.f) m = fmaxf(m, ml[2 * i]);
  float l = 0.f, acc = 0.f;
  for (int i = 0; i < n_split; ++i) {
    const float li = ml[2 * i + 1];
    if (li > 0.f) {
      const float w = expf(ml[2 * i] - m);
      l = fmaf(w, li, l);
      acc = fmaf(w, part_acc[(bh * n_split + i) * D + d], acc);
    }
  }
  store(o + bh * D + d, acc / fmaxf(l, 1e-20f));
}

template <typename T>
constexpr CUtensorMapDataType map_type() {
  return sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                        : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* lengths,
           void* o, float* partials, int B, int Tlen, int H, int Hkv,
           int chunk, float scale, int device, cudaStream_t stream) {
  if (chunk <= 0 || chunk % kTile) return kErrUnsupported;
  const size_t bytes = make_layout<T, D>(H / Hkv, chunk).bytes;
  if ((long long)bytes > hopper::shared_limit(device))
    return kErrSharedMemory;
  int rc = hopper::allow_shared<decode_split_kernel<T, D>>((int)bytes);
  if (rc != 0) return rc;
  if (B == 0 || Hkv == 0 || Tlen == 0) {
    // no slot to attend to: every output is 0, as acc / max(0, 1e-20)
    if (B && H) return (int)cudaMemsetAsync(o, 0, (size_t)B * H * D *
                                                   sizeof(T), stream);
    return 0;
  }
  CUtensorMap km, vm;
  rc = hopper::encode_4d(&km, map_type<T>(), sizeof(T), k, D, Hkv, Tlen,
                             B, D, 1, kTile, 1, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (rc == 0)
    rc = hopper::encode_4d(&vm, map_type<T>(), sizeof(T), v, D, Hkv, Tlen, B,
                           D, 1, kTile, 1, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (rc != 0) return rc;
  const int n_split = (Tlen + chunk - 1) / chunk;
  float* part_ml = partials;
  float* part_acc = partials + 2 * (size_t)B * H * n_split;
  decode_split_kernel<T, D><<<dim3(n_split, Hkv, B), kThreads, bytes,
                              stream>>>(km, vm, (const T*)q,
                                        (const int*)lengths, part_ml,
                                        part_acc, Tlen, H, Hkv, chunk, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  decode_merge_kernel<T, D><<<dim3(H, B), D, 0, stream>>>(
      part_ml, part_acc, (T*)o, H, n_split);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int D, const void* q, const void* k, const void* v,
             const void* lengths, void* o, float* partials, int B, int Tlen,
             int H, int Hkv, int chunk, float scale, int device,
             cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch<T, 32>(q, k, v, lengths, o, partials, B, Tlen, H, Hkv,
                           chunk, scale, device, stream);
    case 64:
      return launch<T, 64>(q, k, v, lengths, o, partials, B, Tlen, H, Hkv,
                           chunk, scale, device, stream);
    case 112:
      return launch<T, 112>(q, k, v, lengths, o, partials, B, Tlen, H, Hkv,
                            chunk, scale, device, stream);
    case 128:
      return launch<T, 128>(q, k, v, lengths, o, partials, B, Tlen, H, Hkv,
                            chunk, scale, device, stream);
    case 256:
      return launch<T, 256>(q, k, v, lengths, o, partials, B, Tlen, H, Hkv,
                            chunk, scale, device, stream);
    default:
      return kErrUnsupported;
  }
}

template <typename T>
long long shared_bytes(int G, int D, int chunk) {
  switch (D) {
    case 32: return (long long)make_layout<T, 32>(G, chunk).bytes;
    case 64: return (long long)make_layout<T, 64>(G, chunk).bytes;
    case 112: return (long long)make_layout<T, 112>(G, chunk).bytes;
    case 128: return (long long)make_layout<T, 128>(G, chunk).bytes;
    case 256: return (long long)make_layout<T, 256>(G, chunk).bytes;
    default: return -1;
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory one block of the split phase asks for, in bytes.
long long decode_attention_shared_bytes(int G, int D, int chunk,
                                        int dtype) {
  return dtype == 0 ? shared_bytes<float>(G, D, chunk)
                    : shared_bytes<__nv_bfloat16>(G, D, chunk);
}

// Launches the split and merge kernels on `stream`.  dtype 0 is float32, 1
// bfloat16; lengths is int32 on the device; chunk (a multiple of 64) is the
// number of cache slots per split; partials holds B * H * ceil(T / chunk)
// * (D + 2) floats of scratch.  Returns 0, a CUDA error code,
// kErrUnsupported for a head_dim, dtype or chunk without a build,
// kErrSharedMemory, or hopper::kErrTensorMap.  Does not synchronise.
int decode_attention_fwd(const void* q, const void* k, const void* v,
                         const void* lengths, void* o, void* partials, int B,
                         int Tlen, int H, int Hkv, int D, int dtype,
                         int chunk, float scale, int device, void* stream) {
  int err = hopper::use_device(device);
  if (err != 0) return err;
  cudaStream_t s = (cudaStream_t)stream;
  float* part = (float*)partials;
  if (dtype == 0)
    return dispatch<float>(D, q, k, v, lengths, o, part, B, Tlen, H, Hkv,
                           chunk, scale, device, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(D, q, k, v, lengths, o, part, B, Tlen, H,
                                   Hkv, chunk, scale, device, s);
  return kErrUnsupported;
}

}  // extern "C"
