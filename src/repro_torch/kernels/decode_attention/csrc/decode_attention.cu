// Hopper (sm_90a) kernel for single-token attention over a KV cache.
//
// Replaces the TPU kernel repro/kernels/decode_attention/decode_attention.py
// ::_decode_kernel (its pl.pallas_call in decode_attention, and the GQA
// wrapper ops.py::decode_mha).  It computes the same function: for each
// batch row b and query head h, softmax(q k^T / sqrt(D)) v over the cache
// slots t < lengths[b], with an online softmax in f32 and out = acc /
// max(l, 1e-20).  Slots at or past lengths[b] are never read, so whatever
// they hold has exactly no influence on the output.
//
// Layout: q and o are (B, H, D), the cache k and v (B, T, Hkv, D), all
// contiguous, read in place (T need not be a multiple of the tile).  Inputs
// are f32 or bf16; the output has the input's type; the arithmetic is f32.
//
// What bounds it on this card: bytes.  One SmolLM-360M decode step at B 8
// reads K and V over ~1040 live slots, 21.3 MB in f32 per layer: 6.4 us at
// 3.35 TB/s.  The arithmetic, 4 D flops per (slot, query head), is far
// below the FP32 peak.
//
// Design (simple, not yet fast): one block of 256 threads per (kv head,
// batch row), serving the H / Hkv query heads that share the kv head, so
// each cache tile is read once for all of them.  The block walks 64-slot
// tiles up to lengths[b]: it stages K (row stride D + 1, no bank conflicts
// when consecutive threads read consecutive rows) and V in shared memory as
// f32, each thread keeping four 16-byte loads of K and four of V in flight;
// one thread per (head, slot) takes a score; one warp per head updates the
// running max and sum; one thread per (head, column) updates the
// accumulator.  With B * Hkv blocks (40 at B 8) most of the 132 SMs are
// idle: splitting T across blocks with a merge of the partial (m, l, acc)
// statistics, and TMA tiles in a ring, are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kBK = 64;        // cache slots per tile
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;     // 16-byte loads of K (and of V) in flight
constexpr float kNegInf = -1.0e30f;
// returned by the entry point for a head_dim or dtype it was not built
// for, or for more shared memory than the device allows
constexpr int kErrUnsupported = -1;
constexpr int kErrSharedMemory = -2;

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

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
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

struct Layout {
  size_t q, k, v, s, acc, m, l, alpha, bytes;   // offsets in floats
};

__host__ __device__ inline Layout make_layout(int G, int D) {
  Layout L;
  size_t off = 0;
  L.q = off;     off += (size_t)G * D;          // scaled queries
  L.k = off;     off += (size_t)kBK * (D + 1);  // K tile, padded rows
  L.v = off;     off += (size_t)kBK * D;        // V tile
  L.s = off;     off += (size_t)G * kBK;        // scores, then probs
  L.acc = off;   off += (size_t)G * D;          // accumulators
  L.m = off;     off += G;                      // running max
  L.l = off;     off += G;                      // running sum
  L.alpha = off; off += G;                      // this tile's rescale
  L.bytes = off * sizeof(float);
  return L;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const int* __restrict__ lengths,
              T* __restrict__ o, int Tlen, int H, int Hkv, float scale) {
  constexpr int DC = D / 4;   // 4-element chunks of a row
  const int G = H / Hkv;
  const Layout L = make_layout(G, D);
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* Qs = smem + L.q;
  float* Ks = smem + L.k;
  float* Vs = smem + L.v;
  float* Ss = smem + L.s;
  float* Acc = smem + L.acc;
  float* Ms = smem + L.m;
  float* Ls = smem + L.l;
  float* As = smem + L.alpha;

  const int hk = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int len = min(max(lengths[b], 0), Tlen);
  const size_t krow = (size_t)Hkv * D;
  const T* qb = q + ((size_t)b * H + (size_t)hk * G) * D;
  const T* kb = k + (size_t)b * Tlen * krow + (size_t)hk * D;
  const T* vb = v + (size_t)b * Tlen * krow + (size_t)hk * D;

  for (int i = tid; i < G * D; i += kThreads) {
    Qs[i] = to_float(qb[i]) * scale;
    Acc[i] = 0.f;
  }
  for (int g = tid; g < G; g += kThreads) {
    Ms[g] = kNegInf;
    Ls[g] = 0.f;
  }

  for (int k0 = 0; k0 < len; k0 += kBK) {
    const int nv = min(kBK, len - k0);
    const int chunks = nv * DC;
    // the last tile's Ks, Vs and Ss have been read
    __syncthreads();
    for (int base = 0; base < chunks; base += kThreads * kUnroll) {
      float4 kx[kUnroll], vx[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = base + u * kThreads + tid;
        if (i < chunks) {
          const size_t at = (size_t)(k0 + i / DC) * krow + 4 * (i % DC);
          kx[u] = load4(kb + at);
          vx[u] = load4(vb + at);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = base + u * kThreads + tid;
        if (i < chunks) {
          const int j = i / DC, c = 4 * (i % DC);
          float* kr = Ks + j * (D + 1) + c;
          kr[0] = kx[u].x; kr[1] = kx[u].y; kr[2] = kx[u].z; kr[3] = kx[u].w;
          *reinterpret_cast<float4*>(Vs + j * D + c) = vx[u];
        }
      }
    }
    __syncthreads();

    for (int i = tid; i < G * nv; i += kThreads) {
      const int g = i / nv, j = i % nv;
      const float* qg = Qs + g * D;
      const float* kr = Ks + j * (D + 1);
      float s = 0.f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) s = fmaf(qg[d], kr[d], s);
      Ss[g * kBK + j] = s;
    }
    __syncthreads();

    for (int g = warp; g < G; g += kWarps) {
      float* sg = Ss + g * kBK;
      float mx = kNegInf;
      for (int j = lane; j < nv; j += 32) mx = fmaxf(mx, sg[j]);
      mx = warp_max(mx);
      const float m_old = Ms[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int j = lane; j < nv; j += 32) {
        const float p = expf(sg[j] - m_new);
        sg[j] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        As[g] = alpha;
        Ls[g] = alpha * Ls[g] + sum;
        Ms[g] = m_new;
      }
    }
    __syncthreads();

    for (int i = tid; i < G * D; i += kThreads) {
      const int g = i / D, d = i % D;
      const float* pg = Ss + g * kBK;
      float a = Acc[i] * As[g];
      for (int j = 0; j < nv; ++j) a = fmaf(pg[j], Vs[j * D + d], a);
      Acc[i] = a;
    }
  }
  __syncthreads();

  T* ob = o + ((size_t)b * H + (size_t)hk * G) * D;
  for (int i = tid; i < G * D; i += kThreads)
    store(ob + i, Acc[i] / fmaxf(Ls[i / D], 1e-20f));
}

long long shared_limit(int device) {
  int limit = 0;
  if (cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return 0;
  return limit;
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* lengths,
           void* o, int B, int Tlen, int H, int Hkv, float scale, int device,
           cudaStream_t stream) {
  const size_t bytes = make_layout(H / Hkv, D).bytes;
  if ((long long)bytes > shared_limit(device)) return kErrSharedMemory;
  cudaError_t err = cudaFuncSetAttribute(
      decode_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  if (B == 0 || Hkv == 0) return 0;
  const dim3 grid(Hkv, B);
  decode_kernel<T, D><<<grid, kThreads, bytes, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const int*)lengths, (T*)o,
      Tlen, H, Hkv, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int D, const void* q, const void* k, const void* v,
             const void* lengths, void* o, int B, int Tlen, int H, int Hkv,
             float scale, int device, cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch<T, 32>(q, k, v, lengths, o, B, Tlen, H, Hkv, scale,
                           device, stream);
    case 64:
      return launch<T, 64>(q, k, v, lengths, o, B, Tlen, H, Hkv, scale,
                           device, stream);
    case 128:
      return launch<T, 128>(q, k, v, lengths, o, B, Tlen, H, Hkv, scale,
                            device, stream);
    case 256:
      return launch<T, 256>(q, k, v, lengths, o, B, Tlen, H, Hkv, scale,
                            device, stream);
    default:
      return kErrUnsupported;
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory one block asks for, in bytes.
long long decode_attention_shared_bytes(int G, int D) {
  return (long long)make_layout(G, D).bytes;
}

// Launches the kernel on `stream`.  dtype 0 is float32, 1 bfloat16;
// lengths is int32 on the device.  Returns 0, a CUDA error code,
// kErrUnsupported for a head_dim or dtype without a build, or
// kErrSharedMemory.  Does not synchronise.
int decode_attention_fwd(const void* q, const void* k, const void* v,
                         const void* lengths, void* o, int B, int Tlen,
                         int H, int Hkv, int D, int dtype, float scale,
                         int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return dispatch<float>(D, q, k, v, lengths, o, B, Tlen, H, Hkv, scale,
                           device, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(D, q, k, v, lengths, o, B, Tlen, H, Hkv,
                                   scale, device, s);
  return kErrUnsupported;
}

}  // extern "C"
