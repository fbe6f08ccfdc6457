// Hopper (sm_90a) kernel for a segment of S queries over a whole KV cache,
// masked by the positions the cache holds.
//
// Replaces no TPU kernel: the JAX package reads a cache this way in plain
// jnp (repro/models/layers.py::attention_apply's cached branch, :284-304,
// through grouped_attention and chunked_grouped_attention, :133-201, with
// _causal_window_mask, :106-112), where a segment continues a non-empty
// cache, writes into a wrapped ring, or is longer than the ring.  The port
// runs its attention through hand-written kernels, so this is one.
//
// It computes the same function: for each batch row b, query i and query
// head h, softmax(q k^T / sqrt(D)) v over all T slots of the cache, where a
// slot t is live for query i iff k_pos[b, t] >= 0 (written), k_pos[b, t] <=
// q_pos[b, i] (causal) and, with a window w > 0, k_pos[b, t] > q_pos[b, i]
// - w.  A masked slot's score is JAX's finite -2e38, never -inf, so a query
// whose every slot is masked gets, as in JAX, the plain mean of V over the
// T slots, with no special case; any live slot makes every masked one add
// exactly 0 (2^(-2e38 - m) underflows).  Slots past T add nothing.
//
// Layout: q and o are (B, S, H, D), the cache k and v (B, T, Hkv, D), q_pos
// (B, S) and k_pos (B, T) int32, all contiguous, read in place.  Query head
// h reads kv head h / (H / Hkv).  D is 32, 64, 112, 128 or 256; a row is a
// whole number of 16-byte chunks.  Inputs are f32 or bf16; the output has
// the input's type; scores, the softmax statistics and the accumulator are
// f32.  Where asked, each row's log-sum-exp of its live scaled scores is
// written too (f32, (B, S, H); -inf for a row with no live slot), which a
// caller needs to merge calls over disjoint slices of one cache (the mesh's
// sequence-sharded cache, models/layers.py).
//
// What bounds it on this card: operations, at the shapes the model runs
// (SmolLM-360M's 256-token segment over a 1,064-slot cache: 4 D T flops per
// (query, head), 0.56 GFLOP a layer at B 8, against 13 MB of q, k, v and o
// in f32).  The design is the simple one, on the CUDA cores.
//
// Design: one block of 128 threads takes 32 rows of one (kv head, batch
// row), a row being one (query, query head of the kv head's group), so each
// cache tile is read once for the whole group; the block walks its slots in
// tiles of 32.  Each tile's K and V are loaded with 16-byte loads, converted
// to f32 and staged in shared memory (K rows padded to an odd number of
// 16-byte chunks, so that the 8 lanes of a load phase reading 8 slots' rows
// hit distinct banks), with the tile's k_pos.  A warp owns 8 rows and a
// lane one slot of the tile: the lane computes the 8 rows' scores against
// its slot (the queries, scaled by log2(e) / sqrt(D) when staged, are read
// as broadcasts), masks them, and the warp runs the online softmax in base
// 2 on the ex2 unit: the row max by shuffles, the running max and the
// rescale factor in registers of every lane, the row sum as a per-lane share
// reduced once at the end.  The probabilities go to shared memory, and for P
// V a lane owns the columns lane + 32 u of its warp's 8 rows, in registers.
// Where B * Hkv * ceil(S G / 32) blocks leave SMs idle (decode-like S, few
// kv heads), the caller splits the slots into chunks: each block then
// stores its partial (m, l, acc) in f32 and a merge kernel, one block per
// (query, head, batch row), combines them: m* = max m_i, l = sum
// 2^(m_i - m*) l_i, out = sum 2^(m_i - m*) acc_i / l.  Every chunk holds at
// least one slot, so every m_i is finite and l >= 1.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kRows = 32;                      // rows (query, head) a block
constexpr int kKeys = 32;                      // cache slots a tile
constexpr int kThreads = 128;
constexpr int kRowsPerWarp = kRows / (kThreads / 32);
// JAX's NEG_INF (repro/models/layers.py:25): a masked slot's score
constexpr float kMasked = -2.0e38f;
// a row max at or under this had no live slot (a live score is finite and
// far above it)
constexpr float kDead = -1.0e38f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
// returned by the entry point for a head_dim or dtype it was not built
// for, a bad chunk, or more shared memory than the device allows
constexpr int kErrUnsupported = -1;
constexpr int kErrSharedMemory = -2;

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// the 16 / sizeof(T) values of a 16-byte chunk as f32
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

// 2^x by the special function unit (2 ulp; 2^-inf = +0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// a row's log-sum-exp in natural units from its base-2 max and sum
__device__ __forceinline__ float row_lse(float m, float l) {
  return m > kDead ? (m + log2f(l)) * kLn2 : hopper::neg_inf();
}

template <int D>
struct Shape {
  static constexpr int LDK = D + 4;            // K row stride, floats
  static constexpr int NU = (D + 31) / 32;     // output columns a lane
  // Q [kRows][D], K [kKeys][LDK], V [kKeys][D], P [kRows][kKeys] f32,
  // then q_pos [kRows] and k_pos [kKeys]
  static constexpr int FLOATS =
      kRows * D + kKeys * LDK + kKeys * D + kRows * kKeys;
  static constexpr int BYTES = 4 * (FLOATS + kRows + kKeys);
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
cache_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v,
                       const int* __restrict__ q_pos,
                       const int* __restrict__ k_pos, T* __restrict__ o,
                       float* __restrict__ lse, float* __restrict__ part_ml,
                       float* __restrict__ part_acc, int S, int Tlen, int H,
                       int Hkv, int window, int chunk, int n_split,
                       float qscale) {
  using C = Shape<D>;
  constexpr int LDK = C::LDK, NU = C::NU;
  constexpr int VE = 16 / (int)sizeof(T);      // values a 16-byte chunk
  constexpr int NC = D / VE;                   // 16-byte chunks a row
  const int hk = blockIdx.y;
  const int b = blockIdx.z / n_split, split = blockIdx.z % n_split;
  const int G = H / Hkv, R = S * G;
  const int r0 = blockIdx.x * kRows;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + kRows * D;
  float* Vs = Ks + kKeys * LDK;
  float* Ps = Vs + kKeys * D;
  int* qp = reinterpret_cast<int*>(Ps + kRows * kKeys);
  int* kp = qp + kRows;

  // the block's rows: row r0 + r is query (r0 + r) / G, head hk G + (r0 +
  // r) % G; rows past R are zeros that nothing stores
  for (int a = tid; a < kRows * NC; a += kThreads) {
    const int r = a / NC, c = a % NC, gr = r0 + r;
    float x[VE];
    if (gr < R) {
      const int i = gr / G, h = hk * G + gr % G;
      load16(q + (((size_t)b * S + i) * H + h) * D + c * VE, x);
    } else {
#pragma unroll
      for (int e = 0; e < VE; ++e) x[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < VE; ++e) Qs[r * D + c * VE + e] = x[e] * qscale;
  }
  for (int r = tid; r < kRows; r += kThreads)
    qp[r] = r0 + r < R ? q_pos[(size_t)b * S + (r0 + r) / G] : -1;

  float m[kRowsPerWarp], lpart[kRowsPerWarp], acc[kRowsPerWarp][NU];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = hopper::neg_inf();
    lpart[r] = 0.f;
#pragma unroll
    for (int u = 0; u < NU; ++u) acc[r][u] = 0.f;
  }
  const int t_lo = split * chunk, t_hi = min(Tlen, t_lo + chunk);
  const float* qrow = Qs + warp * kRowsPerWarp * D;
  float* prow = Ps + warp * kRowsPerWarp * kKeys;

  for (int t0 = t_lo; t0 < t_hi; t0 += kKeys) {
    const int nt = min(kKeys, t_hi - t0);
    __syncthreads();   // the previous tile has been read (Q staged)
    for (int a = tid; a < kKeys * NC; a += kThreads) {
      const int j = a / NC, c = a % NC;
      float kx[VE], vx[VE];
      if (j < nt) {
        const size_t off = (((size_t)b * Tlen + t0 + j) * Hkv + hk) * D
                           + c * VE;
        load16(k + off, kx);
        load16(v + off, vx);
      } else {
#pragma unroll
        for (int e = 0; e < VE; ++e) kx[e] = vx[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < VE; ++e) {
        Ks[j * LDK + c * VE + e] = kx[e];
        Vs[j * D + c * VE + e] = vx[e];
      }
    }
    for (int j = tid; j < kKeys; j += kThreads)
      kp[j] = j < nt ? k_pos[(size_t)b * Tlen + t0 + j] : 0;
    __syncthreads();

    // scores of the warp's rows against slot t0 + lane
    float s[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) s[r] = 0.f;
    const float* krow = Ks + lane * LDK;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      const float4 kx = *reinterpret_cast<const float4*>(krow + d);
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float4 qx = *reinterpret_cast<const float4*>(qrow + r * D + d);
        s[r] = fmaf(qx.x, kx.x, s[r]);
        s[r] = fmaf(qx.y, kx.y, s[r]);
        s[r] = fmaf(qx.z, kx.z, s[r]);
        s[r] = fmaf(qx.w, kx.w, s[r]);
      }
    }
    const int kpos = kp[lane];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int qpos = qp[warp * kRowsPerWarp + r];
      const bool live = kpos >= 0 && kpos <= qpos
                        && (window <= 0 || (long long)kpos
                                           > (long long)qpos - window);
      const float x = lane < nt ? (live ? s[r] : kMasked)
                                : hopper::neg_inf();
      const float mnew = fmaxf(m[r], warp_max(x));   // finite: nt >= 1
      const float alpha = ex2(m[r] - mnew);          // m -inf: 0
      const float p = ex2(x - mnew);
      lpart[r] = fmaf(lpart[r], alpha, p);
#pragma unroll
      for (int u = 0; u < NU; ++u) acc[r][u] *= alpha;
      m[r] = mnew;
      prow[r * kKeys + lane] = p;
    }
    __syncwarp();

    // acc += P V: slots past nt have p = 0 and zero rows of V
    for (int j = 0; j < nt; j += 4) {
      float4 p4[kRowsPerWarp];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r)
        p4[r] = *reinterpret_cast<const float4*>(prow + r * kKeys + j);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
        for (int u = 0; u < NU; ++u) {
          const int col = lane + 32 * u;
          const float vv = col < D ? Vs[(j + jj) * D + col] : 0.f;
#pragma unroll
          for (int r = 0; r < kRowsPerWarp; ++r) {
            const float p = jj == 0 ? p4[r].x : jj == 1 ? p4[r].y
                          : jj == 2 ? p4[r].z : p4[r].w;
            acc[r][u] = fmaf(p, vv, acc[r][u]);
          }
        }
      }
    }
    __syncwarp();
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const float l = warp_sum(lpart[r]);
    const int gr = r0 + warp * kRowsPerWarp + r;
    if (gr >= R) continue;
    const size_t row = ((size_t)b * S + gr / G) * H + hk * G + gr % G;
    if (n_split == 1) {
      const float inv = 1.f / l;
#pragma unroll
      for (int u = 0; u < NU; ++u) {
        const int col = lane + 32 * u;
        if (col < D) store(o + row * D + col, acc[r][u] * inv);
      }
      if (lse != nullptr && lane == 0) lse[row] = row_lse(m[r], l);
    } else {
      const size_t pr = row * n_split + split;
#pragma unroll
      for (int u = 0; u < NU; ++u) {
        const int col = lane + 32 * u;
        if (col < D) part_acc[pr * D + col] = acc[r][u];
      }
      if (lane == 0) {
        part_ml[2 * pr] = m[r];
        part_ml[2 * pr + 1] = l;
      }
    }
  }
}

// one block per (row, batch): row = query * H + head, one thread a column
template <typename T, int D>
__global__ void __launch_bounds__(D)
cache_merge_kernel(const float* __restrict__ part_ml,
                   const float* __restrict__ part_acc, T* __restrict__ o,
                   float* __restrict__ lse, int SH, int n_split) {
  const size_t row = (size_t)blockIdx.y * SH + blockIdx.x;
  const int d = threadIdx.x;
  const float* ml = part_ml + 2 * row * n_split;
  float m = hopper::neg_inf();
  for (int i = 0; i < n_split; ++i) m = fmaxf(m, ml[2 * i]);
  float l = 0.f, acc = 0.f;
  for (int i = 0; i < n_split; ++i) {
    const float w = ex2(ml[2 * i] - m);
    l = fmaf(w, ml[2 * i + 1], l);
    acc = fmaf(w, part_acc[(row * n_split + i) * D + d], acc);
  }
  store(o + row * D + d, acc / l);
  if (lse != nullptr && d == 0) lse[row] = row_lse(m, l);
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* q_pos,
           const void* k_pos, void* o, float* partials, float* lse, int B,
           int S, int Tlen, int H, int Hkv, int window, int chunk,
           int device, cudaStream_t stream) {
  if (chunk <= 0 || chunk % kKeys) return kErrUnsupported;
  const int bytes = Shape<D>::BYTES;
  if ((long long)bytes > hopper::shared_limit(device))
    return kErrSharedMemory;
  int rc = hopper::allow_shared<cache_attention_kernel<T, D>>(bytes);
  if (rc != 0) return rc;
  if (B == 0 || S == 0 || H == 0) return 0;
  const int n_split = (Tlen + chunk - 1) / chunk;
  const int row_tiles = (S * (H / Hkv) + kRows - 1) / kRows;
  float* part_ml = partials;
  float* part_acc = partials + 2 * (size_t)B * S * H * n_split;
  const float qscale = kLog2e / sqrtf((float)D);
  cache_attention_kernel<T, D>
      <<<dim3(row_tiles, Hkv, B * n_split), kThreads, bytes, stream>>>(
          (const T*)q, (const T*)k, (const T*)v, (const int*)q_pos,
          (const int*)k_pos, (T*)o, lse, part_ml, part_acc, S, Tlen, H, Hkv,
          window, chunk, n_split, qscale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return (int)err;
  cache_merge_kernel<T, D><<<dim3(S * H, B), D, 0, stream>>>(
      part_ml, part_acc, (T*)o, lse, S * H, n_split);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int D, const void* q, const void* k, const void* v,
             const void* q_pos, const void* k_pos, void* o, float* partials,
             float* lse, int B, int S, int Tlen, int H, int Hkv, int window,
             int chunk, int device, cudaStream_t stream) {
#define CACHE_ATTENTION_CASE(DIM)                                            \
  case DIM:                                                                  \
    return launch<T, DIM>(q, k, v, q_pos, k_pos, o, partials, lse, B, S,    \
                          Tlen, H, Hkv, window, chunk, device, stream);
  switch (D) {
    CACHE_ATTENTION_CASE(32)
    CACHE_ATTENTION_CASE(64)
    CACHE_ATTENTION_CASE(112)
    CACHE_ATTENTION_CASE(128)
    CACHE_ATTENTION_CASE(256)
    default:
      return kErrUnsupported;
  }
#undef CACHE_ATTENTION_CASE
}

}  // namespace

extern "C" {

// Launches the kernel (and, where the slots are split into chunks, the
// merge) on `stream`.  dtype 0 is float32, 1 bfloat16; q_pos and k_pos are
// int32 on the device; window <= 0 means none; chunk (a multiple of 32,
// T = 0 excepted) is the slots a block takes; partials holds B * S * H *
// ceil(T / chunk) * (D + 2) floats of scratch where ceil(T / chunk) > 1;
// lse, where not null, takes B * S * H floats.  T must be at least 1.
// Returns 0, a CUDA error code, kErrUnsupported for a head_dim, dtype or
// chunk without a build, or kErrSharedMemory.  Does not synchronise.
int cache_attention_fwd(const void* q, const void* k, const void* v,
                        const void* q_pos, const void* k_pos, void* o,
                        void* partials, void* lse, int B, int S, int Tlen,
                        int H, int Hkv, int D, int dtype, int window,
                        int chunk, int device, void* stream) {
  int err = hopper::use_device(device);
  if (err != 0) return err;
  if (Tlen < 1 || Hkv < 1 || H % Hkv) return kErrUnsupported;
  cudaStream_t s = (cudaStream_t)stream;
  float* part = (float*)partials;
  float* l = (float*)lse;
  if (dtype == 0)
    return dispatch<float>(D, q, k, v, q_pos, k_pos, o, part, l, B, S, Tlen,
                           H, Hkv, window, chunk, device, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(D, q, k, v, q_pos, k_pos, o, part, l, B,
                                   S, Tlen, H, Hkv, window, chunk, device, s);
  return kErrUnsupported;
}

}  // extern "C"
