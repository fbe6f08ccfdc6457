// Hopper (sm_90a) kernels for causal, sliding-window and full attention.
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
// input's type; scores, the softmax statistics and the accumulator are f32.
//
// What bounds it on this card: operations.  At SmolLM-360M prefill (B 8,
// S 1024, H 15, D 64) one layer is 16.1 GFLOP of causal work against 84 MB
// of q, k, v and o in f32: 0.24 ms at the 67 TFLOP/s FP32 peak, 25 us of
// bytes.  In bf16 the bound is the tensor cores' 989 TFLOP/s (16 us).
//
// Two designs, chosen by dtype and head_dim:
//
// bf16, head_dim 64, 128, 256: tensor cores ("wgmma+tma", flash_wgmma_kernel
// below).  A block of 288 threads covers a 128-row query tile of one (head,
// batch row): two consumer warpgroups of 64 rows each and one producer warp;
// the grid runs the longest causal tiles first.  One producer thread loads
// the Q tile and then each K and V tile (64 keys; 128 at head_dim 128) by
// TMA, through tensor maps over the tensors in place, into a ring of 3
// shared-memory stages (2 at head_dim 256); each stage has a full mbarrier
// for K, one for V and an empty mbarrier the 256 consumer threads arrive on.
// Tiles are stored in TMA's 128-byte swizzle, 64 columns per atom, which is
// the layout wgmma reads (a wider head is D / 64 boxes of 64 columns).  A
// consumer warpgroup computes S = Q K^T with wgmma m64n64k16 (both operands
// in shared memory, K-major), runs the online softmax on the f32
// accumulator fragment in registers (a row's max and sum reduce over the 4
// lanes of a quad; 1/sqrt(D) and log2 e folded into one FFMA before ex2;
// index masks only on tiles that cut the diagonal, the window or S), packs
// P to bf16 in the layout of wgmma's register A operand, and accumulates
// O += P V with wgmma (V read MN-major, transposed by the descriptor).
// Rounding P to bf16 is the one step the plain version does not take:
// ref.py's bf16 tolerance covers it.  The row sum l is taken from the f32
// probabilities.  Key tiles past the query tile (causal) or before its
// window are not loaded; rows and keys past S are zero-filled by TMA and
// masked by index.  What holds it back: within a warpgroup the softmax
// (CUDA cores and the ex2 unit) and the two products run one after the
// other; only the two warpgroups overlap each other.  Issuing S_{i+1}
// before P_i V_i and running the softmax under it (FlashAttention-3's
// intra-warpgroup overlap) made ptxas (CUDA 12.9) serialise the products
// (C7514) and ran slower; alternating the two warpgroups' products with
// named barriers (ping-pong) was slower too; setmaxnreg did not lift
// ptxas's 168-register budget, so head_dim 256 spills.
//
// f32 at every head_dim, and bf16 at head_dim 32 (used by tests only; no
// config of the port has it): CUDA cores ("cuda-core", flash_kernel
// below).  TF32 or split-bf16 products would not hold the f32 rule, so f32
// stays here; it reaches 33% of the FP32 bound.  One block of 256 threads
// per (query tile of 64 rows, head, batch row); the grid runs the longest
// causal tiles first.  The block stages its query tile (scaled) and then
// each 64-key tile of K and V in shared memory as f32, K and Q transposed
// so that each thread reads four consecutive rows or keys with one 16-byte
// load.
// Thread (ty, tx) of the 16 x 16 grid owns a 4 x 4 tile of scores (rows
// 4ty.., keys 4tx..) and 4 rows x D/16 columns of the accumulator.  The
// row max and row sum of a tile reduce over the 16 lanes of a row group
// with shuffles; the tile's probabilities go through shared memory to the
// P V product.  Key tiles past the query tile (causal) or before its window
// are skipped; a ragged tail (S not a multiple of 64) is masked.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"

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
  int err = hopper::allow_shared<flash_kernel<T, D>>((int)bytes);
  if (err != 0) return err;
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

// ---------------------------------------------------------------------------
// bf16 on the tensor cores: wgmma fed by TMA through an mbarrier ring
// ---------------------------------------------------------------------------

constexpr int kTcRows = 128;                  // query rows per block
constexpr int kTcConsumers = 256;             // two consumer warpgroups
constexpr int kTcThreads = kTcConsumers + 32; // and one producer warp
constexpr int kAtomBytes = 128;               // a swizzle atom's row: 64 bf16
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct TcShape {
  static constexpr int BK = D == 128 ? 128 : 64;   // keys per tile
  static constexpr int STAGES = D <= 128 ? 3 : 2;
  static constexpr int ATOMS = D / 64;             // 64-column atoms per row
  static constexpr int Q_ATOM = kTcRows * kAtomBytes;
  static constexpr int KV_ATOM = BK * kAtomBytes;
  static constexpr int Q_BYTES = ATOMS * Q_ATOM;
  static constexpr int KV_BYTES = ATOMS * KV_ATOM;
  static constexpr int BAR_BYTES = 8 * (1 + 3 * STAGES);
  // 1024 bytes of slack to align the tiles to the swizzle's 1024 bytes
  static constexpr int SMEM = 1024 + Q_BYTES + 2 * STAGES * KV_BYTES +
                              BAR_BYTES;
};

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

// S = Q K^T of a warpgroup's 64 rows over a tile's BK keys, in blocks of
// 64 keys, both operands K-major in shared memory
template <int D>
__device__ __forceinline__ void issue_scores(float (&sc)[TcShape<D>::BK / 64]
                                                      [32],
                                             const uint8_t* Qw,
                                             const uint8_t* Kst) {
  using C = TcShape<D>;
  hopper::wgmma_fence();
#pragma unroll
  for (int n = 0; n < C::BK / 64; ++n)
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int a = kk / 4, off = (kk % 4) * 32;
      hopper::wgmma_m64n64k16_ss(
          sc[n], hopper::desc_sw128(Qw + a * C::Q_ATOM + off, 16, 1024),
          hopper::desc_sw128(Kst + a * C::KV_ATOM + n * 64 * kAtomBytes + off,
                             16, 1024),
          kk > 0);
    }
  hopper::wgmma_commit();
}

// O += P V: P from registers, V MN-major in shared memory (16 keys per
// step, one 64-column atom per product)
template <int D>
__device__ __forceinline__ void issue_pv(float (&acc)[D / 64][32],
                                         const uint32_t (&pa)[TcShape<D>::BK /
                                                              16][4],
                                         const uint8_t* Vst) {
  using C = TcShape<D>;
  hopper::wgmma_fence();
#pragma unroll
  for (int j = 0; j < C::BK / 16; ++j)
#pragma unroll
    for (int n = 0; n < D / 64; ++n)
      hopper::wgmma_m64n64k16_rs_tb(
          acc[n], pa[j],
          hopper::desc_sw128(Vst + n * C::KV_ATOM + j * 16 * kAtomBytes, 1024,
                             1024));
  hopper::wgmma_commit();
}

// Online softmax of one tile's scores, in the accumulator fragment: thread
// t holds rows r_lo and r_lo + 8, columns 8 i + cq + {0, 1} of each
// 64-key block (register 4 i + 2 e + c).  m is kept in score units and the
// scale folded into one FFMA: p = 2^(s c - m c), c = log2(e) / sqrt(D).  A
// masked key's score becomes -inf, so it adds exactly 0; a tile live for
// every row of the warpgroup skips the index tests.  Updates m and l (this
// thread's part of the row sums), returns the rescale of the accumulator in
// alpha and P, packed to bf16 as wgmma's k16 A fragments, in pa.
template <int NB>
__device__ __forceinline__ void softmax_tile(
    float (&sc)[NB][32], float (&m)[2], float (&l)[2], float (&alpha)[2],
    uint32_t (&pa)[NB * 4][4], int k0, int row0, int r_lo, int cq, int S,
    int causal, int window, float scale_log2) {
  const bool interior = k0 + 64 * NB <= S &&
                        (!causal || k0 + 64 * NB - 1 <= row0) &&
                        (window <= 0 || k0 > row0 + 63 - window);
  if (!interior) {
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int r = 0; r < 32; ++r) {
        const int key = k0 + 64 * n + 8 * (r / 4) + cq + (r & 1);
        const int row = r_lo + 8 * ((r >> 1) & 1);
        const bool live = key < S && (!causal || key <= row) &&
                          (window <= 0 || key > row - window);
        if (!live) sc[n][r] = hopper::neg_inf();
      }
  }
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int n = 0; n < NB; ++n)
#pragma unroll
    for (int r = 0; r < 32; ++r)
      mx[(r >> 1) & 1] = fmaxf(mx[(r >> 1) & 1], sc[n][r]);
  float m_scaled[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    mx[e] = fmaxf(mx[e], __shfl_xor_sync(0xffffffffu, mx[e], 1));
    mx[e] = fmaxf(mx[e], __shfl_xor_sync(0xffffffffu, mx[e], 2));
    const float m_new = fmaxf(m[e], mx[e]);
    alpha[e] = ex2((m[e] - m_new) * scale_log2);
    m[e] = m_new;
    m_scaled[e] = m_new * scale_log2;
    l[e] *= alpha[e];
  }
  // the fragment of 16 keys is the k16 A fragment: two f32 to one bf16x2
#pragma unroll
  for (int j = 0; j < NB * 4; ++j)
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const int r = 8 * (j % 4) + 2 * w, e = w & 1;
      const float p0 = ex2(fmaf(sc[j / 4][r], scale_log2, -m_scaled[e]));
      const float p1 = ex2(fmaf(sc[j / 4][r + 1], scale_log2, -m_scaled[e]));
      l[e] += p0 + p1;
      pa[j][w] = pack_bf16x2(p0, p1);
    }
}

template <int D>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap,
                   __nv_bfloat16* __restrict__ o, int S, int H, int Hkv,
                   int causal, int window, float scale_log2) {
  using C = TcShape<D>;
  constexpr int BK = C::BK, ST = C::STAGES, NB = BK / 64, NO = D / 64;
  constexpr int PSTEPS = BK / 16;

  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* Qs = base;
  uint8_t* Ks = Qs + C::Q_BYTES;
  uint8_t* Vs = Ks + ST * C::KV_BYTES;
  uint64_t* full_q = reinterpret_cast<uint64_t*>(Vs + ST * C::KV_BYTES);
  uint64_t* full_k = full_q + 1;
  uint64_t* full_v = full_k + ST;
  uint64_t* empty = full_v + ST;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTcRows;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  // key tiles that hold a live key for some row of this query tile
  const int n_tiles = (S + BK - 1) / BK;
  int kt_end = n_tiles;
  if (causal) kt_end = min(n_tiles, (min(q0 + kTcRows, S) - 1) / BK + 1);
  int kt_begin = 0;
  if (window > 0) kt_begin = max(0, q0 - window + 1) / BK;
  const int n_kv = kt_end - kt_begin;

  const int tid = threadIdx.x;
  if (tid == 0) {
    hopper::mbar_init(full_q, 1);
    for (int s = 0; s < ST; ++s) {
      hopper::mbar_init(&full_k[s], 1);
      hopper::mbar_init(&full_v[s], 1);
      hopper::mbar_init(&empty[s], kTcConsumers);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (tid >= kTcConsumers) {
    // producer warp: one thread issues every load of the block
    if (tid == kTcConsumers) {
      hopper::tma_prefetch_map(&qmap);
      hopper::tma_prefetch_map(&kmap);
      hopper::tma_prefetch_map(&vmap);
      hopper::mbar_expect_tx(full_q, C::Q_BYTES);
#pragma unroll
      for (int a = 0; a < NO; ++a)
        hopper::tma_load_4d(Qs + a * C::Q_ATOM, &qmap, full_q, 64 * a, h, q0,
                            b);
      for (int i = 0; i < n_kv; ++i) {
        const int s = i % ST, ph = (i / ST) & 1, k0 = (kt_begin + i) * BK;
        hopper::mbar_wait(&empty[s], ph ^ 1);
        hopper::mbar_expect_tx(&full_k[s], C::KV_BYTES);
#pragma unroll
        for (int a = 0; a < NO; ++a)
          hopper::tma_load_4d(Ks + s * C::KV_BYTES + a * C::KV_ATOM, &kmap,
                              &full_k[s], 64 * a, hk, k0, b);
        hopper::mbar_expect_tx(&full_v[s], C::KV_BYTES);
#pragma unroll
        for (int a = 0; a < NO; ++a)
          hopper::tma_load_4d(Vs + s * C::KV_BYTES + a * C::KV_ATOM, &vmap,
                              &full_v[s], 64 * a, hk, k0, b);
      }
    }
  } else {
    // consumer warpgroup wg: query rows q0 + 64 wg .. + 63
    const int wg = tid / 128, t = tid % 128, lane = t % 32;
    const int row0 = q0 + 64 * wg;
    const int r_lo = row0 + 16 * (t / 32) + lane / 4;
    const int cq = 2 * (lane % 4);
    const uint8_t* Qw = Qs + wg * 64 * kAtomBytes;

    float acc[NO][32];
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int r = 0; r < 32; ++r) acc[n][r] = 0.f;
    float m[2] = {kNegInf, kNegInf};
    float l[2] = {0.f, 0.f};   // this thread's part of the row sums
    float sc[NB][32], alpha[2];
    uint32_t pa[PSTEPS][4];

    hopper::mbar_wait(full_q, 0);
    for (int i = 0; i < n_kv; ++i) {
      const int s = i % ST, ph = (i / ST) & 1;
      hopper::mbar_wait(&full_k[s], ph);
      issue_scores<D>(sc, Qw, Ks + s * C::KV_BYTES);
      hopper::wgmma_wait();
#pragma unroll
      for (int n = 0; n < NB; ++n)
#pragma unroll
        for (int r = 0; r < 32; ++r) hopper::fence_operand(sc[n][r]);
      softmax_tile<NB>(sc, m, l, alpha, pa, (kt_begin + i) * BK, row0, r_lo,
                       cq, S, causal, window, scale_log2);
#pragma unroll
      for (int n = 0; n < NO; ++n)
#pragma unroll
        for (int r = 0; r < 32; ++r) acc[n][r] *= alpha[(r >> 1) & 1];
      hopper::mbar_wait(&full_v[s], ph);
      issue_pv<D>(acc, pa, Vs + s * C::KV_BYTES);
      hopper::wgmma_wait();
#pragma unroll
      for (int n = 0; n < NO; ++n)
#pragma unroll
        for (int r = 0; r < 32; ++r) hopper::fence_operand(acc[n][r]);
#pragma unroll
      for (int j = 0; j < PSTEPS; ++j)
#pragma unroll
        for (int w = 0; w < 4; ++w) hopper::fence_operand(pa[j][w]);
      hopper::mbar_arrive(&empty[s]);
    }

#pragma unroll
    for (int e = 0; e < 2; ++e) {
      l[e] += __shfl_xor_sync(0xffffffffu, l[e], 1);
      l[e] += __shfl_xor_sync(0xffffffffu, l[e], 2);
    }
    const size_t orow = (size_t)H * D;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int row = r_lo + 8 * e;
      if (row >= S) continue;
      const float den = fmaxf(l[e], 1e-20f);
      __nv_bfloat16* out = o + ((size_t)b * S + row) * orow + (size_t)h * D;
#pragma unroll
      for (int n = 0; n < NO; ++n)
#pragma unroll
        for (int i = 0; i < 8; ++i)
          *reinterpret_cast<uint32_t*>(out + 64 * n + 8 * i + cq) =
              pack_bf16x2(acc[n][4 * i + 2 * e] / den,
                          acc[n][4 * i + 2 * e + 1] / den);
    }
  }
}

template <int D>
int launch_wgmma(const void* q, const void* k, const void* v, void* o, int B,
                 int S, int H, int Hkv, int causal, int window, float scale,
                 cudaStream_t stream) {
  using C = TcShape<D>;
  int err = hopper::allow_shared<flash_wgmma_kernel<D>>(C::SMEM);
  if (err != 0) return err;
  if (B == 0 || S == 0 || H == 0) return 0;
  CUtensorMap qm, km, vm;
  const CUtensorMapDataType bf16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const CUtensorMapSwizzle sw = CU_TENSOR_MAP_SWIZZLE_128B;
  int rc = hopper::encode_4d(&qm, bf16, 2, q, D, H, S, B, 64, 1, kTcRows, 1,
                             sw);
  if (rc == 0)
    rc = hopper::encode_4d(&km, bf16, 2, k, D, Hkv, S, B, 64, 1, C::BK, 1,
                           sw);
  if (rc == 0)
    rc = hopper::encode_4d(&vm, bf16, 2, v, D, Hkv, S, B, 64, 1, C::BK, 1,
                           sw);
  if (rc != 0) return rc;
  const dim3 grid((S + kTcRows - 1) / kTcRows, H, B);
  flash_wgmma_kernel<D><<<grid, kTcThreads, C::SMEM, stream>>>(
      qm, km, vm, (__nv_bfloat16*)o, S, H, Hkv, causal, window,
      scale * kLog2e);
  return (int)cudaGetLastError();
}

int dispatch_wgmma(int D, const void* q, const void* k, const void* v,
                   void* o, int B, int S, int H, int Hkv, int causal,
                   int window, float scale, cudaStream_t stream) {
  switch (D) {
    case 64:
      return launch_wgmma<64>(q, k, v, o, B, S, H, Hkv, causal, window,
                              scale, stream);
    case 128:
      return launch_wgmma<128>(q, k, v, o, B, S, H, Hkv, causal, window,
                               scale, stream);
    case 256:
      return launch_wgmma<256>(q, k, v, o, B, S, H, Hkv, causal, window,
                               scale, stream);
    default:
      return kErrUnsupported;
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory one block of the design launched for this head_dim
// and dtype asks for, in bytes; -1 for a head_dim without a build.
long long flash_attention_shared_bytes(int D, int dtype) {
  if (dtype == 1 && D == 64) return TcShape<64>::SMEM;
  if (dtype == 1 && D == 128) return TcShape<128>::SMEM;
  if (dtype == 1 && D == 256) return TcShape<256>::SMEM;
  if (D == 32 || D == 64 || D == 128 || D == 256)
    return (long long)shared_bytes(D);
  return -1;
}

// Launches the kernel on `stream`: bf16 at head_dim 64, 128 or 256 on the
// tensor cores, everything else on the CUDA cores.  dtype 0 is float32, 1
// bfloat16; window <= 0 means none.  Returns 0, a CUDA error code,
// kErrUnsupported for a head_dim or dtype without a build, or
// hopper::kErrTensorMap.  Does not synchronise.
int flash_attention_fwd(const void* q, const void* k, const void* v,
                        void* o, int B, int S, int H, int Hkv, int D,
                        int dtype, int causal, int window, float scale,
                        int device, void* stream) {
  int err = hopper::use_device(device);
  if (err != 0) return err;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return dispatch<float>(D, q, k, v, o, B, S, H, Hkv, causal, window,
                           scale, s);
  if (dtype == 1 && D == 32)
    return dispatch<__nv_bfloat16>(D, q, k, v, o, B, S, H, Hkv, causal,
                                   window, scale, s);
  if (dtype == 1)
    return dispatch_wgmma(D, q, k, v, o, B, S, H, Hkv, causal, window, scale,
                          s);
  return kErrUnsupported;
}

}  // extern "C"
