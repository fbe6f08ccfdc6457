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
// bf16, head_dim 64, 112, 128, 256: tensor cores ("wgmma+tma",
// flash_wgmma_kernel below).  A block of 288 threads covers a 128-row query
// tile of one (head, batch row): two consumer warpgroups of 64 rows each and
// one producer warp; the grid runs the longest causal tiles first.  One
// producer thread loads the Q tile and then each K and V tile (64 keys; 128
// at head_dim 112 and 128) by TMA, through tensor maps over the tensors in
// place, into a ring of 3 shared-memory stages (2 at head_dim 256); each
// stage has a full mbarrier for K, one for V and an empty mbarrier the 256
// consumer threads arrive on.  Tiles are stored in TMA's 128-byte swizzle, 64
// columns per atom, which is the layout wgmma reads (a wider head is D / 64
// boxes of 64 columns).  A consumer warpgroup computes S = Q K^T with wgmma
// m64n64k16 (both operands in shared memory, K-major), runs the online
// softmax on the f32 accumulator fragment in registers (a row's max and sum
// reduce over the 4 lanes of a quad; 1/sqrt(D) and log2 e folded into one
// FFMA before ex2; index masks only on tiles that cut the diagonal, the
// window or S), packs P to bf16 in the layout of wgmma's register A operand,
// and accumulates O += P V with wgmma (V read MN-major, transposed by the
// descriptor).  Rounding P to bf16 is the one step the plain version does
// not take: ref.py's bf16 tolerance covers it.  The row sum l is taken from
// the f32 probabilities.  Key tiles past the query tile (causal) or before
// its window are not loaded; rows and keys past S are zero-filled by TMA and
// masked by index.  What holds it back: within a warpgroup the softmax (CUDA
// cores and the ex2 unit) and the two products run one after the other; only
// the two warpgroups overlap each other.  Issuing S_{i+1} before P_i V_i and
// running the softmax under it (FlashAttention-3's intra-warpgroup overlap)
// made ptxas (CUDA 12.9) serialise the products (C7514) and ran slower;
// alternating the two warpgroups' products with named barriers (ping-pong)
// was slower too; setmaxnreg did not lift ptxas's 168-register budget, so
// head_dim 256 spills.
//
// head_dim 112 (zamba2-7b's shared attention) is no whole number of 64-column
// atoms.  Its tiles are 128 columns wide in shared memory (TcShape::DT) while
// the tensor maps span the 112 columns in memory (a 224-byte row stride, a
// multiple of TMA's 16 bytes): the second box's columns 112..127 lie past the
// tensor, so TMA writes zeros there and counts them in the transaction bytes,
// as it does rows past S.  Shared memory then holds what the head-128
// instance reads, in the same swizzle, with no copy and no new layout.  S =
// Q K^T takes 7 k16 steps (the eighth would multiply zeros); O = P V two n64
// products, whose 16 padded columns are not stored (the store keeps the
// 112-column row stride).  At zamba2's shape (B 2, S 256, 32 heads) the bound
// is bytes (4.4 us); the kernel is one wave of 128 blocks of two 128-key
// tiles each, so latency sets its time.  64-key tiles measured the same there
// and slower at S 1024.
//
// f32 at every head_dim, and bf16 at head_dim 32 (used by tests only; no
// config of the port has it): CUDA cores ("cuda-core", flash_kernel below).
// TF32 or split-bf16 products would not hold the f32 rule, so f32 stays on
// the FP32 pipes, and what bounds the kernel is how many FMAs each
// shared-memory load feeds and how much of the time the loads, barriers and
// the softmax leave the FMA pipes idle.  A thread owns an 8 x 4 register tile
// of scores (4 x 4 at head_dim 112 and 256): rows 8ty.., keys tx + 16 j (tx +
// 8 j at head_dim 256), so 8 threads reading 8 keys' rows of K hit distinct
// banks; per 4 columns of the head, 4 16-byte loads of K and 8 of Q feed 128
// FMAs, and every float loaded feeds at least 4.  The same thread owns the
// same 8 rows x D/16 columns of the output: per 4 keys, 8 16-byte loads of P
// and D/16 of V feed 8 x D/16 x 4 FMAs.  At head_dim 64 (the main path) a
// block is 128 threads over a 64-row query tile of one (head, batch row), and
// two blocks share an SM (67.5 KB of shared memory each), so one block's
// softmax and barriers overlap the other's products; head_dim 32 takes
// 128-row tiles and 256 threads, 128 and 256 take 64-row tiles alone on an
// SM.  The grid runs the longest causal tiles first.  The query tile is
// staged once, scaled by 1/sqrt(D) log2(e) and transposed; K and V tiles (64
// keys; 32 at head_dim 256) come by cp.async, 16 bytes a copy, keys past S
// zero-filled, K through a ring of two stages so tile k+1 is in flight while
// tile k is computed.  At head_dim 64 and 112 (the lean layout) V has one
// stage, loaded as the tile begins and waited for only before P V, and P
// takes the K stage its tile has consumed (one more barrier per tile); the
// other head dims keep two V stages and a P buffer.  The online softmax runs
// in base 2 on ex2 (scores already in log2 units); a row's max reduces over
// the 16 lanes of its row group with shuffles, its sum stays a per-lane share
// until the end.  Index masks run only on tiles that cross the causal edge,
// the window's edge or S; whole tiles past the query tile (causal) or before
// its window are not loaded.  What holds it back: the f32 FMA pipes issue at
// about half their rate.  Larger register tiles (8 x 8), a third block per
// SM, full unrolling and 32-key tiles all measured slower at the main path's
// shapes.
//
// At head_dim 112 three things bounded the first build of this design, and
// the instance answers each:
//   - 16 key lanes give a lane 7 output columns, read one scalar load at a
//     time.  A lane now takes two 16-byte chunks of each V row; the 28 chunks
//     of a row leave lanes 12..15 without a second one, which is not loaded
//     and not stored (12.5% more P V FMAs, a quarter of the load
//     instructions).
//   - 162,816 bytes of shared memory held one block of 4 warps an SM.  The
//     lean layout and K rows left unpadded (their 16-byte chunks permuted by
//     an XOR of the row instead, which keeps the banks distinct) take
//     100,352 bytes: two blocks an SM.
//   - At zamba2's S 256 the grid is one wave, and 64-row causal tiles differ
//     4:1 in work, so the SMs that hold two of the longest set the time (the
//     same grid without the mask, 1.6 times the work, took the same time).
//     A block now takes two 32-row query tiles, n - 1 - x and then x, so
//     every block has the same work; 4 x 4 register tiles, and both product
//     loops unrolled by 4.
// Measured slower at zamba2's shape on the H100 (PERF.md section 6): one
// 64-row tile a block (20% slower), with 4 x 4 tiles and 256 threads (31%)
// or with the tiles' order alternating long and short (20%), and the
// products unrolled by 2 (4%).  The pairing is chosen from D alone and costs
// where the work is already even: without the causal mask (19% over one
// 64-row tile a block, 3% over the earlier one-block-an-SM instance), and at
// S 1024 (3%).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "attention.cuh"
#include "hopper.cuh"

namespace {

using namespace attn;

constexpr float kNegInf = -1.0e30f;
constexpr float kLog2e = 1.4426950408889634f;
// returned by the entry point for a head_dim or dtype it was not built for
constexpr int kErrUnsupported = -1;

// ---------------------------------------------------------------------------
// f32 (and bf16 at head_dim 32) on the CUDA cores: register-tiled products
// fed by a cp.async ring
// ---------------------------------------------------------------------------

// Tiles of the CUDA-core kernel at head_dim D: BQ query rows per tile,
// PASSES query tiles per block (PAIRED: two at head_dim 112), BK keys per K/V
// tile, TM rows per thread.  A thread owns TM rows x TN keys of each score
// tile (keys kl + KL j) and the same TM rows x NCOL columns of the output, in
// chunks of VEC consecutive columns (c KL + kl) VEC + e: VEC is 4, or 2 where
// D / KL is 2.  At head_dim 112 (RAGGED) D / KL is 7, so a lane takes two
// 16-byte chunks, c = 0 and c = 1, and the 28 chunks of a row leave lanes
// 12..15 without a second one: it is not loaded (zeros) and not stored.
// Shared memory: Q^T [D][BQ] f32, a ring of two K [BK][LDK] tiles and one
// or two V [BK][D] tiles in the input's type, and P [BQ][LDP] f32, which in
// the lean layout (LEAN: two blocks to an SM at head_dim 64 and 112) takes
// the K stage its tile has consumed.  K rows are padded to an odd number of
// 16-byte chunks (LDK = D + EPC) so that 8 lanes reading 8 keys' rows hit
// distinct banks; at head_dim 112 they are not padded (KSWZ: chunk q of row
// j is stored at q ^ ((j >> 1) & 3)), which keeps the banks distinct in
// less shared memory.
template <typename T, int D>
struct CcShape {
  static constexpr bool PAIRED = D == 112;         // two query tiles a block
  static constexpr int PASSES = PAIRED ? 2 : 1;
  static constexpr int BQ = PAIRED ? 32 : D <= 32 ? 128 : 64;
  static constexpr int BK = D <= 128 ? 64 : 32;
  static constexpr int TM = !PAIRED && D <= 128 ? 8 : 4;
  static constexpr int TN = 4;                     // keys per thread
  static constexpr int UNROLL = PAIRED ? 4 : 2;    // of the product loops
  static constexpr bool LEAN = D == 64 || D == 112;
  static constexpr int MIN_BLOCKS = LEAN ? 2 : 1;  // per SM
  static constexpr int KL = BK / TN;               // key lanes of a row group
  static constexpr int THREADS = KL * (BQ / TM);
  static constexpr bool RAGGED = (D / KL) % 2 != 0;
  static constexpr bool KSWZ = D == 112;
  static constexpr int VEC = RAGGED || (D / KL) % 4 == 0 ? 4 : 2;
  static constexpr int NCH = (D + VEC * KL - 1) / (VEC * KL);
  static constexpr int NCOL = NCH * VEC;           // output columns a thread
  static constexpr int EPC = 16 / sizeof(T);       // elements per 16 bytes
  static constexpr int LDK = KSWZ ? D : D + EPC;   // K's row stride
  static constexpr int LDP = BK + 4;
  static constexpr int CPR = D / EPC;              // 16-byte copies per row
  static constexpr size_t K_OFF = sizeof(float) * D * BQ;
  static constexpr size_t K_STAGE = sizeof(T) * BK * LDK;
  static constexpr size_t V_OFF = K_OFF + 2 * K_STAGE;
  static constexpr size_t V_STAGE = sizeof(T) * BK * D;
  static constexpr size_t P_OFF = V_OFF + (LEAN ? 1 : 2) * V_STAGE;
  static constexpr size_t SMEM =
      P_OFF + (LEAN ? 0 : sizeof(float) * BQ * LDP);
  static_assert(D % EPC == 0 && (RAGGED || NCOL * KL == D) &&
                    TM % 4 == 0,
                "head_dim a multiple of 16 bytes and of the key lanes");
  static_assert(!RAGGED || (KL == 16 && NCH == 2 && sizeof(T) == 4),
                "the ragged chunks are laid out for f32 over 16 key lanes");
  static_assert(!KSWZ || (KL == 16 && CPR % 4 == 0),
                "the K swizzle permutes chunks within groups of 4 and reads "
                "row kl + 16 j's permutation from kl");
  static_assert(!LEAN || sizeof(float) * BQ * LDP <= K_STAGE,
                "P must fit in a K stage");
};

template <typename T, int D>
__global__ void __launch_bounds__(CcShape<T, D>::THREADS,
                                  CcShape<T, D>::MIN_BLOCKS)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, int S, int H,
             int Hkv, int causal, int window, float scale_log2) {
  using C = CcShape<T, D>;
  constexpr int BQ = C::BQ, BK = C::BK, TM = C::TM, TN = C::TN, KL = C::KL;
  constexpr int NCOL = C::NCOL, VEC = C::VEC, EPC = C::EPC;
  constexpr int LDK = C::LDK, LDP = C::LDP, CPR = C::CPR, NT = C::THREADS;
  constexpr bool LEAN = C::LEAN;

  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  float* Qs = reinterpret_cast<float*>(smem);
  T* Ks = reinterpret_cast<T*>(smem + C::K_OFF);
  T* Vs = reinterpret_cast<T*>(smem + C::V_OFF);

  const int n_qt = (S + BQ - 1) / BQ;   // query tiles
  for (int pass = 0; pass < C::PASSES; ++pass) {
    if (C::PAIRED && pass == 1) {
      if (blockIdx.x == n_qt - 1 - blockIdx.x) break;   // the middle tile
      __syncthreads();   // every thread is past the first tile's P V
    }
    // query tile of this pass, longest causal work first; paired, a block
    // takes tile n - 1 - x and then tile x, so that every block has the same
    // causal work and the blocks an SM holds finish together
    const int q0 = (C::PAIRED ? pass == 0 ? n_qt - 1 - blockIdx.x : blockIdx.x
                              : gridDim.x - 1 - blockIdx.x) * BQ;
    const int h = blockIdx.y, b = blockIdx.z;
    const int hk = h / (H / Hkv);
    const int tid = threadIdx.x, kl = tid % KL, r0 = (tid / KL) * TM;
    // K's swizzle of the rows kl + KL j this thread reads, in elements
    const int ksw = 4 * ((kl >> 1) & 3);
    const size_t qrow = (size_t)H * D, krow = (size_t)Hkv * D;
    const T* qb = q + (size_t)b * S * qrow + (size_t)h * D;
    const T* kb = k + (size_t)b * S * krow + (size_t)hk * D;
    const T* vb = v + (size_t)b * S * krow + (size_t)hk * D;

    // key tiles that hold a live key for some row of this query tile
    const int n_tiles = (S + BK - 1) / BK;
    int kt_end = n_tiles;
    if (causal) kt_end = min(n_tiles, (min(q0 + BQ, S) - 1) / BK + 1);
    int kt_begin = 0;
    if (window > 0) kt_begin = max(0, q0 - window + 1) / BK;

    // rows of key tile kt of k or v into dst (row stride ld; swz: K's
    // swizzled chunks); keys past S are zeros
    auto load_tile = [&](const T* src, T* dst, int ld, int kt, bool swz) {
      const int k0 = kt * BK;
      for (int e = tid; e < BK * CPR; e += NT) {
        const int j = e / CPR, c = e % CPR;
        const bool in = k0 + j < S;
        const int cs = swz ? c ^ ((j >> 1) & 3) : c;
        hopper::cp_async16(dst + j * ld + cs * EPC,
                           src + (size_t)(in ? k0 + j : 0) * krow + c * EPC,
                           in ? 16 : 0);
      }
    };
    if (kt_begin < kt_end) {
      load_tile(kb, Ks, LDK, kt_begin, C::KSWZ);
      if (!LEAN) load_tile(vb, Vs, D, kt_begin, false);
    }
    hopper::cp_async_commit();

    // the query tile, scaled by 1/sqrt(D) log2(e) so that the softmax is in
    // base 2, transposed so a thread reads 4 of its rows with one load
    for (int i = tid; i < BQ * (D / 4); i += NT) {
      const int r = i % BQ, c = i / BQ;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (q0 + r < S) x = load4(qb + (size_t)(q0 + r) * qrow + 4 * c);
      Qs[(4 * c + 0) * BQ + r] = x.x * scale_log2;
      Qs[(4 * c + 1) * BQ + r] = x.y * scale_log2;
      Qs[(4 * c + 2) * BQ + r] = x.z * scale_log2;
      Qs[(4 * c + 3) * BQ + r] = x.w * scale_log2;
    }

    float m[TM], l[TM], acc[TM][NCOL];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      m[i] = kNegInf;
      l[i] = 0.f;   // this lane's share of the row sum
#pragma unroll
      for (int c = 0; c < NCOL; ++c) acc[i][c] = 0.f;
    }

    for (int kt = kt_begin; kt < kt_end; ++kt) {
      const int st = (kt - kt_begin) & 1, k0 = kt * BK;
      T* k_st = Ks + st * BK * LDK;
      const T* v_st = Vs + (LEAN ? 0 : st * BK * D);
      float* Ps = reinterpret_cast<float*>(LEAN ? reinterpret_cast<char*>(k_st)
                                                : smem + C::P_OFF);
      hopper::cp_async_wait<0>();
      // tile kt's K (and V) and the query tile are in, and every thread is
      // past the last tile's P V: the other stages may be overwritten
      __syncthreads();
      if (LEAN) {
        load_tile(vb, Vs, D, kt, false);
        hopper::cp_async_commit();
      }
      if (kt + 1 < kt_end) {
        load_tile(kb, Ks + (st ^ 1) * BK * LDK, LDK, kt + 1, C::KSWZ);
        if (!LEAN) load_tile(vb, Vs + (st ^ 1) * BK * D, D, kt + 1, false);
      }
      hopper::cp_async_commit();

      // S = Q K^T: per 4 columns of the head, 4 16-byte loads of K and TM / 4
      // of Q for each column feed TM x 4 x 4 FMAs
      float s[TM][TN];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) s[i][j] = 0.f;
#pragma unroll (C::UNROLL)
      for (int d0 = 0; d0 < D; d0 += 4) {
        float kv[TN][4];
        const int kc = C::KSWZ ? d0 ^ ksw : d0;   // d0's chunk in K's rows
#pragma unroll
        for (int j = 0; j < TN; ++j)
          load_vec<4>(k_st + (kl + KL * j) * LDK + kc, kv[j]);
#pragma unroll
        for (int dd = 0; dd < 4; ++dd) {
          float qv[TM];
#pragma unroll
          for (int i = 0; i < TM; i += 4)
            load_vec<4>(Qs + (d0 + dd) * BQ + r0 + i, qv + i);
#pragma unroll
          for (int i = 0; i < TM; ++i)
#pragma unroll
            for (int j = 0; j < TN; ++j)
              s[i][j] = fmaf(qv[i], kv[j][dd], s[i][j]);
        }
      }

      // online softmax in base 2; index masks only on a tile that crosses the
      // causal edge, the window's edge or S
      const bool edge = k0 + BK > S || (causal && k0 + BK - 1 > q0) ||
                        (window > 0 && k0 <= q0 + BQ - 1 - window);
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const int row = q0 + r0 + i;
        bool live[TN];
        float mx = kNegInf;
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const int key = k0 + kl + KL * j;
          live[j] = !edge || (key < S && (!causal || key <= row) &&
                              (window <= 0 || key > row - window));
          if (live[j]) mx = fmaxf(mx, s[i][j]);
        }
#pragma unroll
        for (int off = KL / 2; off > 0; off >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float m_new = fmaxf(m[i], mx);
        const float alpha = ex2(m[i] - m_new);
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          s[i][j] = live[j] ? ex2(s[i][j] - m_new) : 0.f;
          sum += s[i][j];
        }
        l[i] = l[i] * alpha + sum;
        m[i] = m_new;
#pragma unroll
        for (int c = 0; c < NCOL; ++c) acc[i][c] *= alpha;
      }
      // the lean layout writes P over this tile's K: every thread has read it
      if (LEAN) __syncthreads();
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) Ps[(r0 + i) * LDP + kl + KL * j] = s[i][j];
      // the lean layout's V of this tile has landed (K of the next may not)
      if (LEAN) hopper::cp_async_wait<1>();
      __syncthreads();

      // acc += P V: per 4 keys, TM 16-byte loads of P and 4 x NCOL / VEC of V
      // feed TM x NCOL x 4 FMAs
#pragma unroll (C::UNROLL)
      for (int j0 = 0; j0 < BK; j0 += 4) {
        float pr[TM][4];
#pragma unroll
        for (int i = 0; i < TM; ++i)
          load_vec<4>(Ps + (r0 + i) * LDP + j0, pr[i]);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          float vv[NCOL];
#pragma unroll
          for (int c = 0; c < C::NCH; ++c) {
            if (C::RAGGED && c == C::NCH - 1 && (c * KL + kl) * VEC >= D) {
#pragma unroll
              for (int e = 0; e < VEC; ++e) vv[c * VEC + e] = 0.f;
            } else {
              load_vec<VEC>(v_st + (j0 + jj) * D + (c * KL + kl) * VEC,
                            vv + c * VEC);
            }
          }
#pragma unroll
          for (int i = 0; i < TM; ++i)
#pragma unroll
            for (int c = 0; c < NCOL; ++c)
              acc[i][c] = fmaf(pr[i][jj], vv[c], acc[i][c]);
        }
      }
    }

#pragma unroll
    for (int i = 0; i < TM; ++i) {
#pragma unroll
      for (int off = KL / 2; off > 0; off >>= 1)
        l[i] += __shfl_xor_sync(0xffffffffu, l[i], off);
    }
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int row = q0 + r0 + i;
      if (row >= S) continue;
      const float den = fmaxf(l[i], 1e-20f);
      T* out = o + ((size_t)b * S + row) * qrow + (size_t)h * D;
#pragma unroll
      for (int c = 0; c < C::NCH; ++c) {
        if (C::RAGGED && c == C::NCH - 1 && (c * KL + kl) * VEC >= D) continue;
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          store(out + (c * KL + kl) * VEC + e, acc[i][c * VEC + e] / den);
      }
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int S, int H, int Hkv, int causal, int window, float scale,
           cudaStream_t stream) {
  using C = CcShape<T, D>;
  int err = hopper::allow_shared<flash_kernel<T, D>>((int)C::SMEM);
  if (err != 0) return err;
  if (B == 0 || S == 0 || H == 0) return 0;
  const int n_qt = (S + C::BQ - 1) / C::BQ;
  const dim3 grid((n_qt + C::PASSES - 1) / C::PASSES, H, B);
  flash_kernel<T, D><<<grid, C::THREADS, C::SMEM, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, S, H, Hkv, causal,
      window, scale * kLog2e);
  return (int)cudaGetLastError();
}

int dispatch(int D, const void* q, const void* k, const void* v, void* o,
             int B, int S, int H, int Hkv, int causal, int window,
             float scale, cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch<float, 32>(q, k, v, o, B, S, H, Hkv, causal, window,
                               scale, stream);
    case 64:
      return launch<float, 64>(q, k, v, o, B, S, H, Hkv, causal, window,
                               scale, stream);
    case 112:
      return launch<float, 112>(q, k, v, o, B, S, H, Hkv, causal, window,
                                scale, stream);
    case 128:
      return launch<float, 128>(q, k, v, o, B, S, H, Hkv, causal, window,
                                scale, stream);
    case 256:
      return launch<float, 256>(q, k, v, o, B, S, H, Hkv, causal, window,
                                scale, stream);
    default:
      return kErrUnsupported;
  }
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores: wgmma fed by TMA through an mbarrier ring
// ---------------------------------------------------------------------------

// Tiles of the tensor-core kernel at head_dim D, whose rows are DT columns
// wide in shared memory: D rounded up to whole 64-column swizzle atoms (128 at
// head_dim 112, the last 16 columns zero-filled by TMA past the tensor).
template <int D>
struct TcShape {
  static constexpr int DT = (D + 63) / 64 * 64;    // tile width
  static constexpr int BK = D >= 112 && D <= 128 ? 128 : 64;   // keys per tile
  static constexpr int STAGES = DT <= 128 ? 3 : 2;
  static constexpr int ATOMS = DT / 64;            // 64-column atoms per row
  static constexpr int Q_ATOM = kTcRows * kAtomBytes;
  static constexpr int KV_ATOM = BK * kAtomBytes;
  static constexpr int Q_BYTES = ATOMS * Q_ATOM;
  static constexpr int KV_BYTES = ATOMS * KV_ATOM;
  static constexpr int BAR_BYTES = 8 * (1 + 3 * STAGES);
  // 1024 bytes of slack to align the tiles to the swizzle's 1024 bytes
  static constexpr int SMEM = 1024 + Q_BYTES + 2 * STAGES * KV_BYTES +
                              BAR_BYTES;
  static_assert(D % 16 == 0, "whole k16 steps of the scores");
};

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
  constexpr int BK = C::BK, ST = C::STAGES, NB = BK / 64, NO = C::ATOMS;
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
      wgmma_scores<D, BK>(sc, Qw, Ks + s * C::KV_BYTES);
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
      wgmma_pv<D, BK>(acc, pa, Vs + s * C::KV_BYTES);
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
          if (64 * n + 8 * i < D)   // the padding's columns stay in the tile
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
    case 112:
      return launch_wgmma<112>(q, k, v, o, B, S, H, Hkv, causal, window,
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
  if (dtype == 1 && D == 112) return TcShape<112>::SMEM;
  if (dtype == 1 && D == 128) return TcShape<128>::SMEM;
  if (dtype == 1 && D == 256) return TcShape<256>::SMEM;
  if (dtype == 1 && D == 32) return CcShape<__nv_bfloat16, 32>::SMEM;
  if (dtype != 0) return -1;
  switch (D) {
    case 32: return CcShape<float, 32>::SMEM;
    case 64: return CcShape<float, 64>::SMEM;
    case 112: return CcShape<float, 112>::SMEM;
    case 128: return CcShape<float, 128>::SMEM;
    case 256: return CcShape<float, 256>::SMEM;
    default: return -1;
  }
}

// Launches the kernel on `stream`: bf16 at head_dim 64, 112, 128 or 256 on
// the tensor cores, everything else (f32 at 32, 64, 112, 128, 256; bf16 at
// 32) on the CUDA cores.  dtype 0 is float32, 1
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
    return dispatch(D, q, k, v, o, B, S, H, Hkv, causal, window, scale, s);
  if (dtype == 1 && D == 32)
    return launch<__nv_bfloat16, 32>(q, k, v, o, B, S, H, Hkv, causal,
                                     window, scale, s);
  if (dtype == 1)
    return dispatch_wgmma(D, q, k, v, o, B, S, H, Hkv, causal, window, scale,
                          s);
  return kErrUnsupported;
}

}  // extern "C"
