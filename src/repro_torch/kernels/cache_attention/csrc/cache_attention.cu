// Hopper (sm_90a) kernels for a segment of S queries over a whole KV cache,
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
// (query, head), 8.37 GFLOP a layer at B 8 over every slot, against 13 MB
// of q, k, v and o in f32): the FP32 pipes in f32 (67 TFLOP/s), the tensor
// cores in bf16 (989).  Unlike flash attention, no key tile can be skipped:
// positions are arbitrary (a wrapped ring rotates them), so every tile is
// loaded and masked slot by slot.
//
// Two designs, chosen by dtype and head_dim as the flash kernel chooses
// them:
//
// bf16, head_dim 64, 112, 128, 256: tensor cores ("wgmma+tma",
// cache_wgmma_kernel below), the flash kernel's wgmma design over a cache.
// A block of 288 threads covers a 128-row query tile of one (query head,
// batch row, chunk of slots): two consumer warpgroups of 64 rows each and
// one producer warp.  One producer thread loads the Q tile and each K and V
// tile (64 slots; 128 at head_dim 112 and 128) by TMA, through tensor maps
// over the tensors in place, into a ring of 3 stages (2 at head_dim 256),
// in TMA's 128-byte swizzle (the layout wgmma reads); rows past S and slots
// past T are zero-filled by TMA.  The producer warp's 32 lanes copy the
// tile's k_pos into the stage beside it (kPast for a slot past the chunk),
// with their least and greatest, and arrive on the stage's full barrier, so
// the positions come with the tile.  A consumer warpgroup computes S = Q
// K^T with wgmma m64n64k16 (both operands in shared memory), masks every
// score of the accumulator fragment by its slot's position against its
// row's (a thread skips the mask on a tile whose least and greatest
// positions are live for both its rows: most tiles of a cache written in
// order), runs the online softmax there (a row's max and sum reduce over
// the 4 lanes of a quad), packs P to bf16 as wgmma's register A operand and
// accumulates O += P V (V read MN-major).  Rounding P to bf16 is the one
// step the plain version does not take (ref.py's cache_tolerance adds the
// flash kernel's 2^-7 attn(|v|) for it); l sums the f32 probabilities.
//
// The scores stay unscaled, the mask writes JAX's -2e38 into them, and p =
// 2^(s c - m c) in one FFMA, c = log2(e) / sqrt(D), as in the flash kernel.
// The fold needs care here: on a row with no live slot s = m = -2e38, and
// s c - round(m c) would be m c's rounding error, up to 2^100, so p would
// be 0 or inf and not 1.  Such a row (its max at or under -1e38) takes c =
// 2^-126 instead: m c is then exact (-2e38 2^-126 is a normal float), each
// masked slot gets p = 2^0 = 1 exactly and a slot past the chunk (-inf)
// p = 0, which is the mean of V; no live score exists there to need the
// true scale.  On a row with a live max m, a masked slot gives -2e38 c - m
// c, at most -2e38 c + 1e38 c < 0 and at least -3e38: p = 0, never -inf
// turned into +inf, and no overflow.  The rescale 2^((m_old - m_new) c)
// keeps the true c, so a row's first live slot zeroes what its masked
// slots summed.  (On the H100 the fold ran faster than an FADD and an FMUL
// a score, and the mask skip faster over a cache written in order, the same
// over a shuffled one.)  At head_dim 112 the
// tiles are 128 columns wide with TMA's zero fill, as the flash kernel's.  A
// consumer warpgroup whose 64 rows all lie past S (zamba2's S 64) returns
// at once and the stages' empty barriers count only the others.  What
// holds it back: every slot of every tile is scored, masked and
// exponentiated, so the softmax (CUDA cores and the ex2 unit, one ex2 a
// slot) outweighs the two products, which within a warpgroup run one after
// the other around it.
//
// f32 at every head_dim, and bf16 at head_dim 32 (used by tests only; no
// config of the port has it): CUDA cores ("cuda-core",
// cache_attention_kernel below), the flash kernel's CUDA-core design over a
// cache.  TF32 or split-bf16 products would not hold the f32 rule, so f32
// stays on the FP32 pipes, and what bounds the kernel is how many FMAs each
// shared-memory load feeds and how much of the time the loads, barriers and
// the softmax leave the FMA pipes idle.  A block takes BQ rows of one (kv
// head, batch row, chunk of slots), a row being one (query, query head of
// the kv head's group), so a cache tile is read once for the whole group.
// A thread owns a TM x 4 register tile of scores (8 x 4 at head_dim 32, 64
// and 128; 4 x 4 at 112 and 256): per 4 columns of the head, 4 16-byte
// loads of K and TM / 4 of Q feed TM x 16 FMAs, and every float loaded
// feeds at least 4; for P V the same thread owns the same rows x D / 16
// columns, read from V in 16-byte chunks.  The query tile is staged once,
// scaled by log2(e) / sqrt(D) and transposed; K, V and the tile's k_pos
// come by cp.async (16 bytes a copy for K and V, slots past the chunk
// zero-filled), K through a ring of two stages so tile k+1 is in flight
// while tile k is computed.  At head_dim 64 and 112 (the lean layout: two
// blocks an SM) V has one stage, loaded as the tile begins and waited for
// only before P V, and P takes the K stage its tile has consumed; the other
// head dims keep two V stages and a P buffer.  K's rows are padded to an
// odd number of 16-byte chunks (at head_dim 112 their chunks are permuted
// by an XOR of the row instead), so 8 lanes reading 8 slots' rows hit
// distinct banks.  Scores are in base-2 units; the mask writes -2e38 and
// p = 2^(x - m) on the ex2 unit.  What holds it back is what holds the
// flash kernel's CUDA-core design back (the FP32 pipes issue at about half
// their rate), and the mask, two integer tests a score on every tile.
//
// Both designs: where the grid leaves SMs idle (few heads, few queries),
// the caller cuts the slots into chunks (split_plan in cache_attention.py):
// each block then stores its partial (m, l, acc) in f32 (m in base-2
// units, -2e38 for a chunk with no live slot) and a merge kernel, one block
// per (query, head, batch row), combines them: m* = max m_i, l = sum
// 2^(m_i - m*) l_i, out = sum 2^(m_i - m*) acc_i / l.  Every chunk holds at
// least one slot, so every m_i is finite and l >= 1.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "attention.cuh"
#include "hopper.cuh"

namespace {

using namespace attn;

// JAX's NEG_INF (repro/models/layers.py:25): a masked slot's score
constexpr float kMasked = -2.0e38f;
// a row max at or under this had no live slot (a live score is finite and
// far above it)
constexpr float kDead = -1.0e38f;
// k_pos of a slot past the block's chunk: fails every live test
constexpr int kPast = -2147483647 - 1;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
// returned by the entry point for a head_dim or dtype it was not built
// for, a bad chunk, or more shared memory than the device allows
constexpr int kErrUnsupported = -1;
constexpr int kErrSharedMemory = -2;

// slot at position kpos is live for a query at qpos whose window starts
// after lo (lo = max(-1, qpos - w), or -1 without a window): written,
// inside the window, not after the query
__device__ __forceinline__ bool live_slot(int kpos, int qpos, int lo) {
  return kpos > lo && kpos <= qpos;
}

// the window's lower end of a query at qpos, exclusive, never under -1
__device__ __forceinline__ int window_lo(int qpos, int window) {
  return window > 0
             ? (int)max(-1LL, (long long)qpos - (long long)window)
             : -1;
}

// a row's log-sum-exp in natural units from its base-2 max and sum
__device__ __forceinline__ float row_lse(float m, float l) {
  return m > kDead ? (m + log2f(l)) * kLn2 : hopper::neg_inf();
}

// ---------------------------------------------------------------------------
// f32 (and bf16 at head_dim 32) on the CUDA cores: register-tiled products
// fed by a cp.async ring
// ---------------------------------------------------------------------------

// Tiles of the CUDA-core kernel at head_dim D: BQ rows a block, BK slots a
// K/V tile, TM rows a thread.  A thread owns TM rows x TN slots of each
// score tile (slots kl + KL j) and the same TM rows x NCOL columns of the
// output, in chunks of VEC consecutive columns (c KL + kl) VEC + e: VEC is
// 4, or 2 where D / KL is 2.  At head_dim 112 (RAGGED) D / KL is 7, so a
// lane takes two 16-byte chunks and the 28 chunks of a row leave lanes
// 12..15 without a second one: it is not loaded (zeros) and not stored.
// Shared memory: Q^T [D][BQ] f32, a ring of two K [BK][LDK] tiles and one
// or two V [BK][D] tiles in the input's type, P [BQ][LDP] f32 (in the lean
// layout the K stage its tile has consumed), and two stages of the tiles'
// k_pos [BK].  K rows are padded to an odd number of 16-byte chunks (LDK =
// D + EPC); at head_dim 112 they are not padded (KSWZ: chunk q of row j is
// stored at q ^ ((j >> 1) & 3)).
template <typename T, int D>
struct CcShape {
  static constexpr int BQ = D <= 32 ? 128 : D == 112 ? 32 : 64;
  static constexpr int BK = D <= 128 ? 64 : 32;
  static constexpr int TM = D == 112 || D == 256 ? 4 : 8;
  static constexpr int TN = 4;                     // slots a thread
  static constexpr int UNROLL = D == 112 ? 4 : 2;  // of the product loops
  static constexpr bool LEAN = D == 64 || D == 112;
  static constexpr int MIN_BLOCKS = LEAN ? 2 : 1;  // per SM
  static constexpr int KL = BK / TN;               // slot lanes of a row group
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
  static constexpr size_t KP_OFF =
      P_OFF + (LEAN ? 0 : sizeof(float) * BQ * LDP);
  static constexpr size_t SMEM = KP_OFF + 2 * sizeof(int) * BK;
  static_assert(D % EPC == 0 && (RAGGED || NCOL * KL == D) &&
                    TM % 4 == 0,
                "head_dim a multiple of 16 bytes and of the slot lanes");
  static_assert(!RAGGED || (KL == 16 && NCH == 2 && sizeof(T) == 4),
                "the ragged chunks are laid out for f32 over 16 slot lanes");
  static_assert(!KSWZ || (KL == 16 && CPR % 4 == 0),
                "the K swizzle permutes chunks within groups of 4 and reads "
                "row kl + 16 j's permutation from kl");
  static_assert(!LEAN || sizeof(float) * BQ * LDP <= K_STAGE,
                "P must fit in a K stage");
};

template <typename T, int D>
__global__ void __launch_bounds__(CcShape<T, D>::THREADS,
                                  CcShape<T, D>::MIN_BLOCKS)
cache_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v,
                       const int* __restrict__ q_pos,
                       const int* __restrict__ k_pos, T* __restrict__ o,
                       float* __restrict__ lse, float* __restrict__ part_ml,
                       float* __restrict__ part_acc, int S, int Tlen, int H,
                       int Hkv, int window, int chunk, int n_split,
                       float qscale) {
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
  int* KPs = reinterpret_cast<int*>(smem + C::KP_OFF);

  const int hk = blockIdx.y;
  const int b = blockIdx.z / n_split, split = blockIdx.z % n_split;
  const int G = H / Hkv, R = S * G;
  const int r0 = blockIdx.x * BQ;
  const int tid = threadIdx.x, kl = tid % KL, rt = (tid / KL) * TM;
  // K's swizzle of the rows kl + KL j this thread reads, in elements
  const int ksw = 4 * ((kl >> 1) & 3);
  const size_t krow = (size_t)Hkv * D;
  const T* kb = k + (size_t)b * Tlen * krow + (size_t)hk * D;
  const T* vb = v + (size_t)b * Tlen * krow + (size_t)hk * D;
  const int* kpb = k_pos + (size_t)b * Tlen;
  const int t_lo = split * chunk, t_hi = min(Tlen, t_lo + chunk);
  const int n_kv = (t_hi - t_lo + BK - 1) / BK;

  // rows of slot tile kt of k or v into dst (row stride ld; swz: K's
  // swizzled chunks); slots past the chunk are zeros
  auto load_tile = [&](const T* src, T* dst, int ld, int kt, bool swz) {
    const int t0 = t_lo + kt * BK;
    for (int e = tid; e < BK * CPR; e += NT) {
      const int j = e / CPR, c = e % CPR;
      const bool in = t0 + j < t_hi;
      const int cs = swz ? c ^ ((j >> 1) & 3) : c;
      hopper::cp_async16(dst + j * ld + cs * EPC,
                         src + (size_t)(in ? t0 + j : t_lo) * krow + c * EPC,
                         in ? 16 : 0);
    }
  };
  // the positions of slot tile kt (those past the chunk are not read)
  auto load_pos = [&](int* dst, int kt) {
    const int t0 = t_lo + kt * BK;
    for (int j = tid; j < BK; j += NT)
      if (t0 + j < t_hi) hopper::cp_async4(dst + j, kpb + t0 + j);
  };
  load_tile(kb, Ks, LDK, 0, C::KSWZ);
  load_pos(KPs, 0);
  if (!LEAN) load_tile(vb, Vs, D, 0, false);
  hopper::cp_async_commit();

  // the block's rows: row r0 + r is query (r0 + r) / G, head hk G + (r0 +
  // r) % G; rows past R are zeros that nothing stores.  Scaled by log2(e) /
  // sqrt(D) so that the softmax is in base 2, transposed so a thread reads
  // 4 of its rows with one load
  for (int i = tid; i < BQ * (D / 4); i += NT) {
    const int r = i % BQ, c = i / BQ, gr = r0 + r;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (gr < R)
      x = load4(q + (((size_t)b * S + gr / G) * H + hk * G + gr % G) * D +
                4 * c);
    Qs[(4 * c + 0) * BQ + r] = x.x * qscale;
    Qs[(4 * c + 1) * BQ + r] = x.y * qscale;
    Qs[(4 * c + 2) * BQ + r] = x.z * qscale;
    Qs[(4 * c + 3) * BQ + r] = x.w * qscale;
  }

  // each row's position and window
  int qpos[TM], lo[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gr = r0 + rt + i;
    qpos[i] = gr < R ? q_pos[(size_t)b * S + gr / G] : -1;
    lo[i] = window_lo(qpos[i], window);
  }

  float m[TM], l[TM], acc[TM][NCOL];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    m[i] = hopper::neg_inf();
    l[i] = 0.f;   // this lane's share of the row sum
#pragma unroll
    for (int c = 0; c < NCOL; ++c) acc[i][c] = 0.f;
  }

  for (int kt = 0; kt < n_kv; ++kt) {
    const int st = kt & 1, t0 = t_lo + kt * BK;
    T* k_st = Ks + st * BK * LDK;
    const T* v_st = Vs + (LEAN ? 0 : st * BK * D);
    const int* kp_st = KPs + st * BK;
    float* Ps = reinterpret_cast<float*>(LEAN ? reinterpret_cast<char*>(k_st)
                                              : smem + C::P_OFF);
    hopper::cp_async_wait<0>();
    // tile kt's K, positions (and V) and the query tile are in, and every
    // thread is past the last tile's P V: the other stages may be
    // overwritten
    __syncthreads();
    if (LEAN) {
      load_tile(vb, Vs, D, kt, false);
      hopper::cp_async_commit();
    }
    if (kt + 1 < n_kv) {
      load_tile(kb, Ks + (st ^ 1) * BK * LDK, LDK, kt + 1, C::KSWZ);
      load_pos(KPs + (st ^ 1) * BK, kt + 1);
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
          load_vec<4>(Qs + (d0 + dd) * BQ + rt + i, qv + i);
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j)
            s[i][j] = fmaf(qv[i], kv[j][dd], s[i][j]);
      }
    }

    // every score masked by its slot's position; online softmax in base 2
    int kpos[TN];
    float dead[TN];   // a masked slot's score: -2e38, or -inf past the chunk
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int jj = kl + KL * j;
      const bool in = t0 + jj < t_hi;
      kpos[j] = in ? kp_st[jj] : kPast;
      dead[j] = in ? kMasked : hopper::neg_inf();
    }
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      float mx = hopper::neg_inf();
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        if (!live_slot(kpos[j], qpos[i], lo[i])) s[i][j] = dead[j];
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = KL / 2; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);   // finite: the tile has a slot
      const float alpha = ex2(m[i] - m_new);  // m -inf: 0
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        s[i][j] = ex2(s[i][j] - m_new);
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
      for (int j = 0; j < TN; ++j) Ps[(rt + i) * LDP + kl + KL * j] = s[i][j];
    // the lean layout's V of this tile has landed (K of the next may not)
    if (LEAN) hopper::cp_async_wait<1>();
    __syncthreads();

    // acc += P V: per 4 slots, TM 16-byte loads of P and 4 x NCOL / VEC of
    // V feed TM x NCOL x 4 FMAs; slots past the chunk have p = 0 and zero
    // rows of V
#pragma unroll (C::UNROLL)
    for (int j0 = 0; j0 < BK; j0 += 4) {
      float pr[TM][4];
#pragma unroll
      for (int i = 0; i < TM; ++i)
        load_vec<4>(Ps + (rt + i) * LDP + j0, pr[i]);
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
    const int gr = r0 + rt + i;
    if (gr >= R) continue;
    const size_t row = ((size_t)b * S + gr / G) * H + hk * G + gr % G;
    const size_t pr = row * n_split + split;
    const float inv = 1.f / l[i];
#pragma unroll
    for (int c = 0; c < C::NCH; ++c) {
      if (C::RAGGED && c == C::NCH - 1 && (c * KL + kl) * VEC >= D) continue;
      const int col = (c * KL + kl) * VEC;
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float a = acc[i][c * VEC + e];
        if (n_split == 1) store(o + row * D + col + e, a * inv);
        else part_acc[pr * D + col + e] = a;
      }
    }
    if (kl != 0) continue;
    if (n_split == 1) {
      if (lse != nullptr) lse[row] = row_lse(m[i], l[i]);
    } else {
      part_ml[2 * pr] = m[i];
      part_ml[2 * pr + 1] = l[i];
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores: wgmma fed by TMA through an mbarrier ring
// ---------------------------------------------------------------------------

// Tiles of the tensor-core kernel at head_dim D, whose rows are DT columns
// wide in shared memory: D rounded up to whole 64-column swizzle atoms (128
// at head_dim 112, the last 16 columns zero-filled by TMA past the tensor).
// Each stage holds a K and a V tile, the tile's k_pos and their range.
template <int D>
struct TcShape {
  static constexpr int DT = (D + 63) / 64 * 64;    // tile width
  static constexpr int BK = D >= 112 && D <= 128 ? 128 : 64;   // slots a tile
  static constexpr int STAGES = DT <= 128 ? 3 : 2;
  static constexpr int ATOMS = DT / 64;            // 64-column atoms per row
  static constexpr int Q_ATOM = kTcRows * kAtomBytes;
  static constexpr int KV_ATOM = BK * kAtomBytes;
  static constexpr int Q_BYTES = ATOMS * Q_ATOM;
  static constexpr int KV_BYTES = ATOMS * KV_ATOM;
  static constexpr int KP_STRIDE = BK + 4;         // positions, then range
  static constexpr int KP_BYTES = 4 * KP_STRIDE;
  static constexpr int BAR_BYTES = 8 * (1 + 3 * STAGES);
  // 1024 bytes of slack to align the tiles to the swizzle's 1024 bytes
  static constexpr int SMEM = 1024 + Q_BYTES + 2 * STAGES * KV_BYTES +
                              STAGES * KP_BYTES + BAR_BYTES;
  static_assert(D % 16 == 0, "whole k16 steps of the scores");
};

// Mask and online softmax of one tile's scores, in the accumulator fragment:
// thread t holds rows r_lo and r_lo + 8, slots 8 i + cq + {0, 1} of each
// 64-slot block (register 4 i + 2 e + c), whose positions it reads from
// the stage (kp[0, BK)), beside their least and greatest (kp[BK], kp[BK +
// 1]).  A masked score becomes -2e38 (-inf past the chunk); a tile whose
// every slot is live for both rows is not masked.  m is kept in score units
// and p = 2^(s c_e - m c_e) in one FFMA: c_e = log2(e) / sqrt(D) on a row
// with a live slot, 2^-126 on a row whose max is the mask's -2e38 (see the
// header).  Updates m and l (this thread's part of the row sums), returns
// the rescale of the accumulator in alpha and P, packed to bf16 as wgmma's
// k16 A fragments, in pa.
template <int BK>
__device__ __forceinline__ void cache_softmax_tile(
    float (&sc)[BK / 64][32], float (&m)[2], float (&l)[2],
    float (&alpha)[2], uint32_t (&pa)[BK / 16][4], const int* kp,
    const int (&qpos)[2], const int (&lo)[2], int cq, float scale_log2) {
  constexpr int NB = BK / 64;
  const bool all_live = kp[BK] > max(lo[0], lo[1]) &&
                        kp[BK + 1] <= min(qpos[0], qpos[1]);
  if (!all_live) {
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int2 pos = *reinterpret_cast<const int2*>(kp + 64 * n + 8 * i
                                                        + cq);
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int kpos = c ? pos.y : pos.x;
          const float dead = kpos == kPast ? hopper::neg_inf() : kMasked;
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (!live_slot(kpos, qpos[e], lo[e]))
              sc[n][4 * i + 2 * e + c] = dead;
        }
      }
  }
  float mx[2] = {hopper::neg_inf(), hopper::neg_inf()};
#pragma unroll
  for (int n = 0; n < NB; ++n)
#pragma unroll
    for (int r = 0; r < 32; ++r)
      mx[(r >> 1) & 1] = fmaxf(mx[(r >> 1) & 1], sc[n][r]);
  float ce[2], ms[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    mx[e] = fmaxf(mx[e], __shfl_xor_sync(0xffffffffu, mx[e], 1));
    mx[e] = fmaxf(mx[e], __shfl_xor_sync(0xffffffffu, mx[e], 2));
    const float m_new = fmaxf(m[e], mx[e]);   // finite: the tile has a slot
    alpha[e] = ex2((m[e] - m_new) * scale_log2);   // m -inf: 0
    m[e] = m_new;
    l[e] *= alpha[e];
    ce[e] = m_new > kDead ? scale_log2 : 0x1p-126f;
    ms[e] = m_new * ce[e];
  }
  // the fragment of 16 slots is the k16 A fragment: two f32 to one bf16x2
#pragma unroll
  for (int j = 0; j < NB * 4; ++j)
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const int r = 8 * (j % 4) + 2 * w, e = w & 1;
      const float p0 = ex2(fmaf(sc[j / 4][r], ce[e], -ms[e]));
      const float p1 = ex2(fmaf(sc[j / 4][r + 1], ce[e], -ms[e]));
      l[e] += p0 + p1;
      pa[j][w] = pack_bf16x2(p0, p1);
    }
}

template <int D>
__global__ void __launch_bounds__(kTcThreads, 1)
cache_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap,
                   const int* __restrict__ q_pos,
                   const int* __restrict__ k_pos,
                   __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                   float* __restrict__ part_ml, float* __restrict__ part_acc,
                   int S, int Tlen, int H, int Hkv, int window, int chunk,
                   int n_split, float scale_log2) {
  using C = TcShape<D>;
  constexpr int BK = C::BK, ST = C::STAGES, NB = BK / 64, NO = C::ATOMS;
  constexpr int PSTEPS = BK / 16;

  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* Qs = base;
  uint8_t* Ks = Qs + C::Q_BYTES;
  uint8_t* Vs = Ks + ST * C::KV_BYTES;
  int* KPs = reinterpret_cast<int*>(Vs + ST * C::KV_BYTES);
  uint64_t* full_q = reinterpret_cast<uint64_t*>(KPs + ST * C::KP_STRIDE);
  uint64_t* full_k = full_q + 1;
  uint64_t* full_v = full_k + ST;
  uint64_t* empty = full_v + ST;

  const int q0 = blockIdx.x * kTcRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z / n_split, split = blockIdx.z % n_split;
  const int hk = h / (H / Hkv);
  const int t_lo = split * chunk, t_hi = min(Tlen, t_lo + chunk);
  const int n_kv = (t_hi - t_lo + BK - 1) / BK;
  // consumer warpgroups with a row under S (one at zamba2's S 64)
  const int n_wg = min(2, (S - q0 + 63) / 64);

  const int tid = threadIdx.x;
  if (tid == 0) {
    hopper::mbar_init(full_q, 1);
    for (int s = 0; s < ST; ++s) {
      hopper::mbar_init(&full_k[s], 32);   // the producer warp's lanes
      hopper::mbar_init(&full_v[s], 1);
      hopper::mbar_init(&empty[s], 128 * n_wg);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (tid >= kTcConsumers) {
    // producer warp: one thread issues every TMA load of the block, the 32
    // lanes copy each tile's positions into its stage and their range
    // after them
    const int lane = tid - kTcConsumers;
    if (lane == 0) {
      hopper::tma_prefetch_map(&qmap);
      hopper::tma_prefetch_map(&kmap);
      hopper::tma_prefetch_map(&vmap);
      hopper::mbar_expect_tx(full_q, C::Q_BYTES);
#pragma unroll
      for (int a = 0; a < NO; ++a)
        hopper::tma_load_4d(Qs + a * C::Q_ATOM, &qmap, full_q, 64 * a, h, q0,
                            b);
    }
    const int* kpb = k_pos + (size_t)b * Tlen;
    for (int i = 0; i < n_kv; ++i) {
      const int s = i % ST, ph = (i / ST) & 1, t0 = t_lo + i * BK;
      hopper::mbar_wait(&empty[s], ph ^ 1);
      int* kp = KPs + s * C::KP_STRIDE;
      int least = 0x7fffffff, most = kPast;
      for (int j = lane; j < BK; j += 32) {
        kp[j] = t0 + j < t_hi ? kpb[t0 + j] : kPast;
        least = min(least, kp[j]);
        most = max(most, kp[j]);
      }
      least = __reduce_min_sync(0xffffffffu, least);
      most = __reduce_max_sync(0xffffffffu, most);
      if (lane == 0) {
        kp[BK] = least;
        kp[BK + 1] = most;
        // its arrival, after its own stores, with the tile's bytes
        hopper::mbar_expect_tx(&full_k[s], C::KV_BYTES);
#pragma unroll
        for (int a = 0; a < NO; ++a)
          hopper::tma_load_4d(Ks + s * C::KV_BYTES + a * C::KV_ATOM, &kmap,
                              &full_k[s], 64 * a, hk, t0, b);
        hopper::mbar_expect_tx(&full_v[s], C::KV_BYTES);
#pragma unroll
        for (int a = 0; a < NO; ++a)
          hopper::tma_load_4d(Vs + s * C::KV_BYTES + a * C::KV_ATOM, &vmap,
                              &full_v[s], 64 * a, hk, t0, b);
      } else {
        hopper::mbar_arrive(&full_k[s]);   // releases its position stores
      }
    }
  } else {
    // consumer warpgroup wg: query rows q0 + 64 wg .. + 63
    const int wg = tid / 128;
    if (wg >= n_wg) return;   // every row past S: the empty barriers skip it
    const int t = tid % 128, lane = t % 32;
    const int r_lo = q0 + 64 * wg + 16 * (t / 32) + lane / 4;
    const int cq = 2 * (lane % 4);
    const uint8_t* Qw = Qs + wg * 64 * kAtomBytes;
    int qpos[2], lo[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int row = r_lo + 8 * e;
      qpos[e] = row < S ? q_pos[(size_t)b * S + row] : -1;
      lo[e] = window_lo(qpos[e], window);
    }

    float acc[NO][32];
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int r = 0; r < 32; ++r) acc[n][r] = 0.f;
    float m[2] = {hopper::neg_inf(), hopper::neg_inf()};
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
      cache_softmax_tile<BK>(sc, m, l, alpha, pa, KPs + s * C::KP_STRIDE,
                             qpos, lo, cq, scale_log2);
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
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int row = r_lo + 8 * e;
      if (row >= S) continue;
      const size_t ri = ((size_t)b * S + row) * H + h;
      const size_t pr = ri * n_split + split;
      // the row max in base-2 units, the mask's -2e38 where none is live
      const float m2 = m[e] > kDead ? m[e] * scale_log2 : kMasked;
      const float inv = 1.f / l[e];
#pragma unroll
      for (int n = 0; n < NO; ++n)
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int col = 64 * n + 8 * i + cq;
          if (64 * n + 8 * i >= D) continue;   // the padding's columns
          const float a0 = acc[n][4 * i + 2 * e];
          const float a1 = acc[n][4 * i + 2 * e + 1];
          if (n_split == 1)
            *reinterpret_cast<uint32_t*>(o + ri * D + col) =
                pack_bf16x2(a0 * inv, a1 * inv);
          else
            *reinterpret_cast<float2*>(part_acc + pr * D + col) =
                make_float2(a0, a1);
        }
      if (lane % 4 != 0) continue;
      if (n_split == 1) {
        if (lse != nullptr) lse[ri] = row_lse(m2, l[e]);
      } else {
        part_ml[2 * pr] = m2;
        part_ml[2 * pr + 1] = l[e];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// The merge of split partials, and the launches
// ---------------------------------------------------------------------------

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

// the merge, where the slots were split; 0 or a CUDA error code
template <typename T, int D>
int launch_merge(const float* part_ml, const float* part_acc, void* o,
                 float* lse, int B, int S, int H, int n_split,
                 cudaStream_t stream) {
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return (int)err;
  cache_merge_kernel<T, D><<<dim3(S * H, B), D, 0, stream>>>(
      part_ml, part_acc, (T*)o, lse, S * H, n_split);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* q_pos,
           const void* k_pos, void* o, float* partials, float* lse, int B,
           int S, int Tlen, int H, int Hkv, int window, int chunk,
           int device, cudaStream_t stream) {
  using C = CcShape<T, D>;
  if (chunk <= 0 || chunk % C::BK) return kErrUnsupported;
  if ((long long)C::SMEM > hopper::shared_limit(device))
    return kErrSharedMemory;
  int rc = hopper::allow_shared<cache_attention_kernel<T, D>>((int)C::SMEM);
  if (rc != 0) return rc;
  if (B == 0 || S == 0 || H == 0) return 0;
  const int n_split = (Tlen + chunk - 1) / chunk;
  const int row_tiles = (S * (H / Hkv) + C::BQ - 1) / C::BQ;
  float* part_ml = partials;
  float* part_acc = partials + 2 * (size_t)B * S * H * n_split;
  cache_attention_kernel<T, D>
      <<<dim3(row_tiles, Hkv, B * n_split), C::THREADS, C::SMEM, stream>>>(
          (const T*)q, (const T*)k, (const T*)v, (const int*)q_pos,
          (const int*)k_pos, (T*)o, lse, part_ml, part_acc, S, Tlen, H, Hkv,
          window, chunk, n_split, kLog2e / sqrtf((float)D));
  return launch_merge<T, D>(part_ml, part_acc, o, lse, B, S, H, n_split,
                            stream);
}

template <int D>
int launch_wgmma(const void* q, const void* k, const void* v,
                 const void* q_pos, const void* k_pos, void* o,
                 float* partials, float* lse, int B, int S, int Tlen, int H,
                 int Hkv, int window, int chunk, int device,
                 cudaStream_t stream) {
  using C = TcShape<D>;
  if (chunk <= 0 || chunk % C::BK) return kErrUnsupported;
  if ((long long)C::SMEM > hopper::shared_limit(device))
    return kErrSharedMemory;
  int rc = hopper::allow_shared<cache_wgmma_kernel<D>>(C::SMEM);
  if (rc != 0) return rc;
  if (B == 0 || S == 0 || H == 0) return 0;
  CUtensorMap qm, km, vm;
  const CUtensorMapDataType bf16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const CUtensorMapSwizzle sw = CU_TENSOR_MAP_SWIZZLE_128B;
  rc = hopper::encode_4d(&qm, bf16, 2, q, D, H, S, B, 64, 1, kTcRows, 1, sw);
  if (rc == 0)
    rc = hopper::encode_4d(&km, bf16, 2, k, D, Hkv, Tlen, B, 64, 1, C::BK, 1,
                           sw);
  if (rc == 0)
    rc = hopper::encode_4d(&vm, bf16, 2, v, D, Hkv, Tlen, B, 64, 1, C::BK, 1,
                           sw);
  if (rc != 0) return rc;
  const int n_split = (Tlen + chunk - 1) / chunk;
  float* part_ml = partials;
  float* part_acc = partials + 2 * (size_t)B * S * H * n_split;
  const dim3 grid((S + kTcRows - 1) / kTcRows, H, B * n_split);
  cache_wgmma_kernel<D><<<grid, kTcThreads, C::SMEM, stream>>>(
      qm, km, vm, (const int*)q_pos, (const int*)k_pos, (__nv_bfloat16*)o,
      lse, part_ml, part_acc, S, Tlen, H, Hkv, window, chunk, n_split,
      kLog2e / sqrtf((float)D));
  return launch_merge<__nv_bfloat16, D>(part_ml, part_acc, o, lse, B, S, H,
                                        n_split, stream);
}

#define CACHE_ATTENTION_ARGS                                                 \
  q, k, v, q_pos, k_pos, o, partials, lse, B, S, Tlen, H, Hkv, window,      \
      chunk, device, stream

int dispatch(int D, const void* q, const void* k, const void* v,
             const void* q_pos, const void* k_pos, void* o, float* partials,
             float* lse, int B, int S, int Tlen, int H, int Hkv, int window,
             int chunk, int device, cudaStream_t stream) {
  switch (D) {
    case 32: return launch<float, 32>(CACHE_ATTENTION_ARGS);
    case 64: return launch<float, 64>(CACHE_ATTENTION_ARGS);
    case 112: return launch<float, 112>(CACHE_ATTENTION_ARGS);
    case 128: return launch<float, 128>(CACHE_ATTENTION_ARGS);
    case 256: return launch<float, 256>(CACHE_ATTENTION_ARGS);
    default: return kErrUnsupported;
  }
}

int dispatch_bf16(int D, const void* q, const void* k, const void* v,
                  const void* q_pos, const void* k_pos, void* o,
                  float* partials, float* lse, int B, int S, int Tlen, int H,
                  int Hkv, int window, int chunk, int device,
                  cudaStream_t stream) {
  switch (D) {
    case 32: return launch<__nv_bfloat16, 32>(CACHE_ATTENTION_ARGS);
    case 64: return launch_wgmma<64>(CACHE_ATTENTION_ARGS);
    case 112: return launch_wgmma<112>(CACHE_ATTENTION_ARGS);
    case 128: return launch_wgmma<128>(CACHE_ATTENTION_ARGS);
    case 256: return launch_wgmma<256>(CACHE_ATTENTION_ARGS);
    default: return kErrUnsupported;
  }
}

#undef CACHE_ATTENTION_ARGS

}  // namespace

extern "C" {

// Dynamic shared memory one block of the design launched for this head_dim
// and dtype asks for, in bytes; -1 for a head_dim or dtype without a build.
long long cache_attention_shared_bytes(int D, int dtype) {
  if (dtype == 1) {
    switch (D) {
      case 32: return CcShape<__nv_bfloat16, 32>::SMEM;
      case 64: return TcShape<64>::SMEM;
      case 112: return TcShape<112>::SMEM;
      case 128: return TcShape<128>::SMEM;
      case 256: return TcShape<256>::SMEM;
      default: return -1;
    }
  }
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

// Launches the kernel (and, where the slots are split into chunks, the
// merge) on `stream`: bf16 at head_dim 64, 112, 128 or 256 on the tensor
// cores, everything else (f32 at 32, 64, 112, 128, 256; bf16 at 32) on the
// CUDA cores.  dtype 0 is float32, 1 bfloat16; q_pos and k_pos are int32
// on the device; window <= 0 means none; chunk (a multiple of the design's
// slot tile, split_plan in cache_attention.py) is the slots a block takes;
// partials holds B * S * H * ceil(T / chunk) * (D + 2) floats of scratch
// where ceil(T / chunk) > 1; lse, where not null, takes B * S * H floats.
// T must be at least 1.  Returns 0, a CUDA error code, kErrUnsupported for
// a head_dim, dtype or chunk without a build, kErrSharedMemory, or
// hopper::kErrTensorMap.  Does not synchronise.
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
    return dispatch(D, q, k, v, q_pos, k_pos, o, part, l, B, S, Tlen, H, Hkv,
                    window, chunk, device, s);
  if (dtype == 1)
    return dispatch_bf16(D, q, k, v, q_pos, k_pos, o, part, l, B, S, Tlen, H,
                         Hkv, window, chunk, device, s);
  return kErrUnsupported;
}

}  // extern "C"
