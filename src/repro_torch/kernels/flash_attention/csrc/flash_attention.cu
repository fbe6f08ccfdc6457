// Hopper (sm_90a) kernel for causal, sliding-window and full attention.
//
// Replaces the TPU kernel repro/kernels/flash_attention/flash_attention.py::
// _flash_kernel (its pl.pallas_call in flash_attention, and the GQA wrapper
// ops.py::flash_mha).  It computes the same function: softmax(q k^T / sqrt(D))
// v over the keys each query may see (causal: key <= query; window w:
// key > query - w), with an online softmax in f32 and out = acc / max(l,
// 1e-20).  Masked scores take -1e30 as there; a masked key adds exactly
// nothing to l or acc here, so a row is exact from its first live key on.
//
// Layout: q and o are (B, S, H, D), k and v (B, S, Hkv, D), all contiguous,
// read in place.  Query head h reads kv head h / (H / Hkv): GQA needs no
// repeat and no transpose copy.  Inputs are f32 or bf16; the output has the
// input's type; scores, probabilities and the accumulator are f32.
//
// What bounds it on this card: operations.  At SmolLM-360M prefill (B 8,
// S 1024, H 15, D 64) one layer is 16.1 GFLOP of causal work against 84 MB
// of q, k, v and o in f32: 0.24 ms at the 67 TFLOP/s FP32 peak, 25 us of
// bytes.  In bf16 the bound is the tensor cores' 989 TFLOP/s (16 us).
//
// Design (simple, not yet fast): one block of 256 threads per (query tile
// of 64 rows, head, batch row); the grid runs the longest causal tiles
// first.  The block stages its query tile (scaled) and then each 64-key
// tile of K and V in shared memory as f32, K and Q transposed so that each
// thread reads four consecutive rows or keys with one 16-byte load.
// Thread (ty, tx) of the 16 x 16 grid owns a 4 x 4 tile of scores (rows
// 4ty.., keys 4tx..) and 4 rows x D/16 columns of the accumulator.  The
// row max and row sum of a tile reduce over the 16 lanes of a row group
// with shuffles; the tile's probabilities go through shared memory to the
// P V product.  Key tiles past the query tile (causal) or before its window
// are skipped; a ragged tail (S not a multiple of 64) is masked.  All
// products run on the CUDA cores in f32, in bf16 too: wgmma, TMA and
// double-buffered tiles are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 256;  // 16 row groups x 16 lanes
constexpr int kPK = kBK + 4;   // row stride of the probability tile
constexpr float kNegInf = -1.0e30f;
// returned by the entry point for a head_dim or dtype it was not built for
constexpr int kErrUnsupported = -1;

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

__device__ __forceinline__ void store(float* p, float x) { *p = x; }

__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <int N>
__device__ __forceinline__ void load_shared(const float* p, float* out);

template <>
__device__ __forceinline__ void load_shared<4>(const float* p, float* out) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  out[0] = x.x; out[1] = x.y; out[2] = x.z; out[3] = x.w;
}

template <>
__device__ __forceinline__ void load_shared<2>(const float* p, float* out) {
  const float2 x = *reinterpret_cast<const float2*>(p);
  out[0] = x.x; out[1] = x.y;
}

__host__ __device__ constexpr size_t shared_bytes(int D) {
  // Qs [D][kBQ], Ks [D][kBK], Vs [kBK][D], Ps [kBQ][kPK]
  return sizeof(float) *
         ((size_t)D * kBQ + (size_t)D * kBK + (size_t)kBK * D +
          (size_t)kBQ * kPK);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, int S, int H,
             int Hkv, int causal, int window, float scale) {
  constexpr int VEC = D >= 64 ? 4 : 2;   // accumulator columns per load
  constexpr int NCH = D / (16 * VEC);    // loads per accumulator row
  constexpr int NACC = NCH * VEC;        // = D / 16
  constexpr int DC = D / 4;              // 4-element chunks of a row
  static_assert(D % 32 == 0 && NCH >= 1, "head_dim must be 32, 64, ...");

  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + D * kBQ;
  float* Vs = Ks + D * kBK;
  float* Ps = Vs + kBK * D;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const size_t qrow = (size_t)H * D, krow = (size_t)Hkv * D;
  const T* qb = q + (size_t)b * S * qrow + (size_t)h * D;
  const T* kb = k + (size_t)b * S * krow + (size_t)hk * D;
  const T* vb = v + (size_t)b * S * krow + (size_t)hk * D;

  for (int i = tid; i < kBQ * DC; i += kThreads) {
    const int r = i % kBQ, c = i / kBQ;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < S) x = load4(qb + (size_t)(q0 + r) * qrow + 4 * c);
    Qs[(4 * c + 0) * kBQ + r] = x.x * scale;
    Qs[(4 * c + 1) * kBQ + r] = x.y * scale;
    Qs[(4 * c + 2) * kBQ + r] = x.z * scale;
    Qs[(4 * c + 3) * kBQ + r] = x.w * scale;
  }

  // key tiles that hold a live key for some row of this query tile
  const int n_tiles = (S + kBK - 1) / kBK;
  int kt_end = n_tiles;
  if (causal) kt_end = min(n_tiles, (min(q0 + kBQ, S) - 1) / kBK + 1);
  int kt_begin = 0;
  if (window > 0) kt_begin = max(0, q0 - window + 1) / kBK;

  float m[4], l[4], acc[4][NACC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NACC; ++c) acc[i][c] = 0.f;
  }

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kBK;
    // the last tile's Ks, Vs and Ps have been read
    __syncthreads();
    for (int i = tid; i < kBK * DC; i += kThreads) {
      const int j = i % kBK, c = i / kBK;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (k0 + j < S) x = load4(kb + (size_t)(k0 + j) * krow + 4 * c);
      Ks[(4 * c + 0) * kBK + j] = x.x;
      Ks[(4 * c + 1) * kBK + j] = x.y;
      Ks[(4 * c + 2) * kBK + j] = x.z;
      Ks[(4 * c + 3) * kBK + j] = x.w;
    }
    for (int i = tid; i < kBK * DC; i += kThreads) {
      const int j = i / DC, c = i % DC;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (k0 + j < S) x = load4(vb + (size_t)(k0 + j) * krow + 4 * c);
      *reinterpret_cast<float4*>(Vs + j * D + 4 * c) = x;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float a[4], kk[4];
      load_shared<4>(Qs + d * kBQ + ty * 4, a);
      load_shared<4>(Ks + d * kBK + tx * 4, kk);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], kk[j], s[i][j]);
    }

    // online softmax, row by row; a row group is 16 lanes of one warp
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      bool live[4];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + tx * 4 + j;
        live[j] = key < S && (!causal || key <= row) &&
                  (window <= 0 || key > row - window);
        if (live[j]) mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float p[4], sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        p[j] = live[j] ? expf(s[i][j] - m_new) : 0.f;
        sum += p[j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = alpha * l[i] + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NACC; ++c) acc[i][c] *= alpha;
      *reinterpret_cast<float4*>(Ps + (ty * 4 + i) * kPK + tx * 4) =
          make_float4(p[0], p[1], p[2], p[3]);
    }
    __syncthreads();

    // acc += P V over the tile's keys
    for (int j = 0; j < kBK; j += 4) {
      float pr[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        load_shared<4>(Ps + (ty * 4 + i) * kPK + j, pr[i]);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        float vv[NACC];
#pragma unroll
        for (int c = 0; c < NCH; ++c)
          load_shared<VEC>(Vs + (j + jj) * D + c * 16 * VEC + tx * VEC,
                           vv + c * VEC);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < NACC; ++c)
            acc[i][c] = fmaf(pr[i][jj], vv[c], acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= S) continue;
    const float den = fmaxf(l[i], 1e-20f);
    T* out = o + ((size_t)b * S + row) * qrow + (size_t)h * D;
#pragma unroll
    for (int c = 0; c < NCH; ++c)
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        store(out + c * 16 * VEC + tx * VEC + e, acc[i][c * VEC + e] / den);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int S, int H, int Hkv, int causal, int window, float scale,
           cudaStream_t stream) {
  const size_t bytes = shared_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  if (B == 0 || S == 0 || H == 0) return 0;
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  flash_kernel<T, D><<<grid, kThreads, bytes, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, S, H, Hkv, causal,
      window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int D, const void* q, const void* k, const void* v, void* o,
             int B, int S, int H, int Hkv, int causal, int window,
             float scale, cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch<T, 32>(q, k, v, o, B, S, H, Hkv, causal, window, scale,
                           stream);
    case 64:
      return launch<T, 64>(q, k, v, o, B, S, H, Hkv, causal, window, scale,
                           stream);
    case 128:
      return launch<T, 128>(q, k, v, o, B, S, H, Hkv, causal, window, scale,
                            stream);
    case 256:
      return launch<T, 256>(q, k, v, o, B, S, H, Hkv, causal, window, scale,
                            stream);
    default:
      return kErrUnsupported;
  }
}

}  // namespace

extern "C" {

// Launches the kernel on `stream`.  dtype 0 is float32, 1 bfloat16;
// window <= 0 means none.  Returns 0, a CUDA error code, or
// kErrUnsupported for a head_dim or dtype without a build.  Does not
// synchronise.
int flash_attention_fwd(const void* q, const void* k, const void* v,
                        void* o, int B, int S, int H, int Hkv, int D,
                        int dtype, int causal, int window, float scale,
                        int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return dispatch<float>(D, q, k, v, o, B, S, H, Hkv, causal, window,
                           scale, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(D, q, k, v, o, B, S, H, Hkv, causal,
                                   window, scale, s);
  return kErrUnsupported;
}

}  // extern "C"
