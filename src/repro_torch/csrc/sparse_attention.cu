// Block-sparse masked flash attention (the SVG block mask's executor,
// DESIGN.md §12).
//
// Replaces: src/repro/kernels/sparse/kernel.py::sparse_attention_kernel
//   (body _sparse_kernel, wrapper ops.py::sparse_attention_pallas).
//
// A (BH, nq, nk) int32 block map over the (Nq, Nk) score matrix, tiled by
// (bq, bk) as ref.py::sparse_grid tiles it, gives each tile a state:
//   SKIP (0)    no loads, no math;
//   FULL (1)    a mask-free tile - the bias is never read;
//   PARTIAL (2) the tile's f32 logit bias (bias[b, h, row, key], -inf
//               where the mask drops a key) is added to the scores.
// With f32 running (m, l, acc) states per query row, m starting at the
// finite -1e30 of the JAX kernel (so a row whose keys are all -inf stays
// finite) and rows that end with l == 0 emitting 0.
//
// The ring's carry (DESIGN.md §14; the JAX kernel's `carry` and
// `with_state`): given m_in, l_in ((BH, Nq) f32) and acc_in ((BH, Nq, dv)
// f32), a block starts its rows from that state instead of the fresh one;
// given m_out, l_out and acc_out it stores the f32 state after its last
// tile, beside the normalised output.  m is in logit units (the scaled
// scores) on both paths, so a state stored by one call and loaded by the
// next is the kernel's own register state, and a chain of calls over
// whole key tiles equals one call bit for bit.  Rows past Nq are never
// loaded or stored (they keep the fresh state).  Scores accumulate in
// f32 and are then multiplied by the scale; probabilities are rounded to
// v's dtype before the PV product, as the JAX kernel rounds them.  A
// block walks its map row in ascending key-tile order, the JAX kernel's
// summation order.  Keys past Nk or past their map tile and query rows
// past Nq are masked by index (the JAX wrapper pads with a flag channel
// instead).
//
// Bound on the H100: per non-SKIP tile 4*bq*bk*d flops, per PARTIAL tile
// bq*bk*4 bytes of bias (64 KB at 128x128) on top of q, k, v and the
// output read or written once.  At the served grid a temporal head's map
// is a third PARTIAL, so the dense bias makes such a call bound by bytes;
// a spatial head's map has no PARTIAL tile and is bound by its flops.
//
// Design:
//   * bf16 with d == dv in {32, 40, 64, 80, 128, 160}: wgmma.mma_async
//     (sm_90a), the ripple kernel's machinery (hopper.cuh).  A block owns
//     128 query rows of one map row (a map tile taller than 128 rows takes
//     several blocks; rows past the tile are computed and never stored):
//     consumer warpgroups 0 and 1 hold 64 rows each, a third, producer
//     warpgroup streams key stages through a ring in shared memory.  The
//     producer walks the block's map row and issues nothing for a SKIP
//     tile (the CUDA form of the JAX kernel's k_fetch / bias_fetch copy
//     elision); the consumers walk the same row and do no math there.  A
//     live tile is cut into stages from its first key; keys of a stage
//     past the tile's end or past Nk are masked by index, rows past Nk
//     arrive as zeros (TMA fills them).
//   * Q, K and V arrive by TMA in swizzled channel boxes that the wgmma
//     descriptors read (hopper.cuh, Boxes): 128 B rows of 64 channels (d
//     32: 64 B rows of 32), and at d 40, 80 and 160 one tail box more,
//     with its own tensor map: d 40 is 32 + 16 channels, the map ending
//     at 40 so that TMA zero-fills channels 40-47 (exact zeros in the
//     score product, never stored by the PV product); d 80 64 + 16; d 160
//     64 + 64 + 32.  S = Q K^T is wgmma SS, O += P V wgmma RS with P
//     re-packed from the f32 score accumulators into bf16 registers (the
//     tail box's columns a second product of N = 16 or 32).  mbarriers say
//     when a stage's K, V and bias are full and when both consumers have
//     released it.  Softmax runs online in log2 units, each exponent one
//     FFMA into ex2.approx.ftz.
//   * The ring has slots of 64 KB (3 at d <= 128, beside Q), 80 KB at d
//     160 (2: a stage's K and V take 80 KB there).  Every stage has 128
//     keys, as the ripple kernel's: its K and V take one slot.  A PARTIAL
//     tile's stage in a call with a bias also takes the next slot for its
//     128 x 128 f32 bias, which the whole producer warpgroup copies with
//     cp.async (16-byte copies when every row starts on a 16-byte
//     boundary, 4-byte copies otherwise) into a swizzled layout that the
//     consumers read as float2 without bank conflicts; it arrives on the
//     slot's bias barrier when its copies land.  So FULL and PARTIAL
//     stages run the same wgmma code, with one branch for the bias add; a
//     call without a bias runs an instantiation with no bias code
//     (PARTIAL tiles run as FULL ones there).  Each consumer runs a stage
//     in order (S, softmax, PV) within the 168 registers a thread of the
//     launch bound; the two consumers overlap one another.  At d 160 the
//     O accumulator takes 80 registers a thread, so a stage runs as two
//     halves of 64 keys (S -> softmax -> PV each, over its own 64 V rows
//     and the same 64 columns of the stage's bias slot): 64 x 64 scores
//     live at a time, as in the ripple kernel's d-160 path.
//   * float32 (and other head dims up to 256): CUDA-core FMAs in f32, the
//     tile code of ripple_attention.cu's CUDA-core path: 8 x 4 outputs a
//     lane, 8 x 8 above dv 128.

#include <math.h>
#include <stdint.h>

#include "hopper.cuh"  // TMA, mbarrier, wgmma helpers; pack_bf16, to_f, from_f

namespace {

constexpr int kSkip = 0;
constexpr int kPartial = 2;
constexpr float kMInit = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kMaxDim = 256;  // both paths, as the ripple kernel
constexpr int kChunk = 64;  // keys per shared-memory chunk (CUDA cores)

struct Args {
  const void* q;      // (BH, Nq, d)
  const void* k;      // (BH, Nk, d)
  const void* v;      // (BH, Nk, dv)
  void* out;          // (BH, Nq, dv)
  const float* bias;  // rows of Nk floats at bias + b*bias_sb + h*bias_sh; may be null
  const int* bmap;    // (BH, nq, nk)
  const float* m_in;  // the carry, (BH, Nq), (BH, Nq), (BH, Nq, dv); may be null
  const float* l_in;
  const float* acc_in;
  float* m_out;       // the state after the last tile, same shapes; may be null
  float* l_out;
  float* acc_out;
  int H, Nq, Nk, d, dv, bq, bk, nq, nk, sub;
  long long bias_sb, bias_sh;
  float scale;
};

// A probability as the PV product sees it: rounded to v's dtype.
__device__ __forceinline__ float round_as(float p, float) { return p; }
__device__ __forceinline__ float round_as(float p, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16_rn(p));
}

// ---------------------------------------------------------------------------
// Tensor-core path (bf16): TMA ring, producer warpgroup, wgmma
// ---------------------------------------------------------------------------

constexpr int kWgRows = 64;                   // query rows a consumer owns
constexpr int kConsumers = 2;
constexpr int kBlockRows = kConsumers * kWgRows;
constexpr int kWgmmaThreads = 128 * (kConsumers + 1);  // + the producer
constexpr int kKeys = 128;                          // keys a stage
constexpr int kBiasBytes = kBlockRows * kKeys * 4;  // one stage's f32 bias

__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }

// The ring of key stages at head dim D: STAGES slots, each a stage's K and
// V (128 keys each) or, for a PARTIAL tile's stage in a call with a bias,
// the 128 x 128 f32 bias in the slot after its K and V: 64 KB up to 128
// channels, 80 KB at d 160.
template <int D>
struct Ring : Boxes<D> {
  using B = Boxes<D>;
  static constexpr int Q_BYTES = kWgRows * B::DP * 2;  // one consumer's rows
  static constexpr int KV_BYTES = kKeys * B::DP * 2;
  static constexpr int SLOT = cmax(kBiasBytes, 2 * KV_BYTES);
  // As many slots as 227 KB holds beside Q, the alignment slack and
  // 512 bytes of barriers.
  static constexpr int STAGES =
      (kSmemLimit - 1024 - 512 - kConsumers * Q_BYTES) / SLOT;
  static constexpr int TILE_BYTES = kConsumers * Q_BYTES + STAGES * SLOT;
  static constexpr int BARRIERS = 1 + 4 * STAGES;
  static constexpr int SMEM = 1024 + TILE_BYTES + 8 * BARRIERS;  // + alignment
  // Keys a consumer scores at a time: a stage's 128, or above 128
  // channels two halves of 64 (O's DP / 2 registers a thread leave no
  // room for 64 x 128 scores beside them).
  static constexpr int PASS = B::DP > 128 ? 64 : kKeys;
  static_assert(SLOT % 1024 == 0 && KV_BYTES % 1024 == 0 && Q_BYTES % 1024 == 0,
                "swizzled tiles start on 1024-byte boundaries");
  static_assert(STAGES >= 2 && 8 * BARRIERS <= 512 && SMEM <= kSmemLimit,
                "a ring of 2+ slots fits");
};

// Where bias element (row, key) of a bias slot lies, in floats: rows of
// 128 floats whose 16-byte chunks are XOR-ed with 2 * (row % 4), so the
// float2 reads of one accumulator column pair by a warp's 8 rows fall in
// distinct banks.
__device__ __forceinline__ int bias_at(int row, int key) {
  return row * kKeys + ((((key >> 2) ^ ((row & 3) << 1))) << 2) + (key & 3);
}

// The online-softmax state of one consumer thread: rows r and r + 8 of its
// warp's 16 (wgmma accumulator layout).  s holds a pass's scores, then
// their exponentials; pk the probabilities in bf16; o the output over DP
// columns.
template <int D>
struct RowState {
  static constexpr int NK = Ring<D>::PASS;
  float s[NK / 2];
  uint32_t pk[NK / 16][4];
  float o[Boxes<D>::DP / 2];
  float m[2], l[2];
};

// One pass of NK keys from key K0 of a stage (the whole stage, or a half
// of it) for one consumer warpgroup: S = Q K^T, the bias of a PARTIAL
// tile's stage (BIAS and `bias` non-null, waited on b_bar at b_parity),
// the key mask past key_end (keys of the stage from key0), online softmax,
// then O += P V over the pass's V rows once V has arrived.
template <int D, bool BIAS, int NK, int K0>
__device__ __forceinline__ void consume_keys(
    RowState<D>& st, uint32_t q_tile, uint32_t k_tile, uint32_t v_tile,
    const float* bias, int slot_row, uint32_t v_bar, uint32_t parity,
    uint32_t b_bar, uint32_t b_parity, int key0, int key_end, float scale,
    float scale_log2) {
  using R = Ring<D>;
  constexpr int NS = NK / 2;
  const int lane = threadIdx.x % 32;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < R::KSTEPS; ++kk)
    wgmma_ss<NK>(st.s, kmajor_desc<D, kWgRows>(q_tile, kk),
                 kmajor_desc<D, kKeys>(k_tile, kk, K0), kk > 0);
  wgmma_commit();
  wgmma_wait_all();
  pin<NS>(st.s);

  // Entry i is column K0 + (i / 4) * 8 + (lane % 4) * 2 + (i & 1) of the
  // stage, row slot_row + 8 * ((i >> 1) & 1).  s times scn is a logit,
  // s times sc the logit in log2 units.
  float sc = scale_log2, scn = scale;
  if (BIAS && bias != nullptr) {
    mbar_wait(b_bar, b_parity);
#pragma unroll
    for (int i = 0; i < NS; i += 2) {
      const int row = slot_row + 8 * ((i >> 1) & 1);
      const int col = K0 + (i / 4) * 8 + (lane % 4) * 2;
      const float2 b = *reinterpret_cast<const float2*>(bias + bias_at(row, col));
      st.s[i] = fmaf(st.s[i], scale, b.x);
      st.s[i + 1] = fmaf(st.s[i + 1], scale, b.y);
    }
    sc = kLog2e;
    scn = 1.f;
  }
  if (key0 + K0 + NK > key_end) {
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const int col = K0 + (i / 4) * 8 + (lane % 4) * 2 + (i & 1);
      if (key0 + col >= key_end) st.s[i] = -INFINITY;
    }
  }
  // The running max in logit units: the scale is positive, so the max of
  // the raw scores scales to it.  Exponents are taken in log2 units, the
  // max scaled to them once a row.
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < NS; ++i)
    mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], st.s[i]);
  float alpha[2], neg_m[2], sum[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    const float m_new = fmaxf(st.m[h], mx[h] * scn);
    alpha[h] = exp2_ftz((st.m[h] - m_new) * kLog2e);
    st.m[h] = m_new;
    neg_m[h] = -m_new * kLog2e;
  }
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    st.s[i] = exp2_ftz(fmaf(st.s[i], sc, neg_m[(i >> 1) & 1]));
    sum[(i >> 1) & 1] += st.s[i];
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
    sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
    st.l[h] = alpha[h] * st.l[h] + sum[h];
  }
  // O *= alpha; the exponentials become the bf16 A operand: k-step kk is
  // score columns 16kk..16kk+15 (accumulator chunks 2kk and 2kk + 1).
#pragma unroll
  for (int c = 0; c < R::DP / 8; ++c) {
    st.o[c * 4 + 0] *= alpha[0];
    st.o[c * 4 + 1] *= alpha[0];
    st.o[c * 4 + 2] *= alpha[1];
    st.o[c * 4 + 3] *= alpha[1];
  }
#pragma unroll
  for (int kk = 0; kk < NK / 16; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      st.pk[kk][j] = pack_bf16(st.s[kk * 8 + 2 * j], st.s[kk * 8 + 2 * j + 1]);

  // V rows K0 .. K0 + NK - 1 are the MN-major B operand; the tail box's
  // columns are a second product.
  mbar_wait(v_bar, parity);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < NK / 16; ++kk) {
    const int row = K0 + 16 * kk;
    wgmma_rs<R::MAIN_C>(st.o, st.pk[kk],
                        make_desc(v_tile + row * R::MAIN_SW, kKeys * R::MAIN_SW,
                                  8 * R::MAIN_SW, R::MAIN_MODE));
    if constexpr (R::TAIL_C > 0)
      wgmma_rs<R::TAIL_C>(st.o + R::MAIN_C / 2, st.pk[kk],
                          make_desc(v_tile + R::NMAIN * kKeys * R::MAIN_SW +
                                        row * R::TAIL_SW,
                                    kKeys * R::TAIL_SW, 8 * R::TAIL_SW,
                                    R::TAIL_MODE));
  }
  wgmma_commit();
  wgmma_wait_all();
  pin<R::DP / 2>(st.o);
}

// One key stage: one pass of 128 keys, or two of 64 above 128 channels.
template <int D, bool BIAS>
__device__ __forceinline__ void consume_stage(
    RowState<D>& st, uint32_t q_tile, uint32_t k_tile, uint32_t v_tile,
    const float* bias, int slot_row, uint32_t v_bar, uint32_t parity,
    uint32_t b_bar, uint32_t b_parity, int key0, int key_end, float scale,
    float scale_log2) {
  constexpr int NK = Ring<D>::PASS;
  consume_keys<D, BIAS, NK, 0>(st, q_tile, k_tile, v_tile, bias, slot_row, v_bar,
                               parity, b_bar, b_parity, key0, key_end, scale,
                               scale_log2);
  if constexpr (NK < kKeys)
    consume_keys<D, BIAS, NK, NK>(st, q_tile, k_tile, v_tile, bias, slot_row, v_bar,
                                  parity, b_bar, b_parity, key0, key_end, scale,
                                  scale_log2);
}

// The three operands' tensor maps: main boxes, then the tail boxes.
struct Maps {
  CUtensorMap q, k, v;
  CUtensorMap qt, kt, vt;  // tail boxes (TAIL_C > 0 only)
};

// One tile of `rows` rows from row `row` of head bh: the main boxes, then
// the tail box, into `tile`, completing on `bar`.
template <int D>
__device__ __forceinline__ void load_tile(uint32_t tile, int rows,
                                          const CUtensorMap* mmain,
                                          const CUtensorMap* mtail, uint32_t bar,
                                          int row, int bh) {
  using R = Ring<D>;
  for (int b = 0; b < R::NMAIN; ++b)
    tma_load(tile + b * rows * R::MAIN_SW, mmain, bar, b * R::MAIN_BOXC, row, bh);
  if constexpr (R::TAIL_C > 0)
    tma_load(tile + R::NMAIN * rows * R::MAIN_SW, mtail, bar, R::MAIN_C, row, bh);
}

// BIAS: the call has a bias (PARTIAL tiles add it); without one, PARTIAL
// tiles run as FULL ones and the kernel has no bias code.
template <int D, bool BIAS>
__global__ void __launch_bounds__(kWgmmaThreads, 1)
    sparse_wgmma_kernel(const __grid_constant__ Maps maps, Args a, int vec,
                        float scale_log2) {
  using R = Ring<D>;
  extern __shared__ unsigned char smem_raw[];
  // Swizzled tiles need 1024-byte alignment (the 128 B pattern's period).
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t q_tiles = base;  // [kConsumers][kWgRows rows]
  const uint32_t slots = q_tiles + kConsumers * R::Q_BYTES;
  auto slot = [&](int s) { return slots + s * R::SLOT; };  // K, then V
  const uint32_t bars = base + R::TILE_BYTES;
  const uint32_t q_full = bars;
  auto k_full = [&](int s) { return bars + 8 * (1 + s); };
  auto v_full = [&](int s) { return bars + 8 * (1 + R::STAGES + s); };
  auto b_full = [&](int s) { return bars + 8 * (1 + 2 * R::STAGES + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + 3 * R::STAGES + s); };
  // Ring position: a slot and the parity of its current round, advanced in
  // step by producer and consumers.  Every round of a slot completes each
  // of its four barriers once, whichever use the slot has in the round.
  struct Pos {
    int slot = 0;
    uint32_t phase = 0;
    __device__ void advance() {
      if (++slot == R::STAGES) slot = 0, phase ^= 1;
    }
  };

  const int qi = blockIdx.x / a.sub;
  const int bh = blockIdx.y;
  const int row_lo = qi * a.bq + (blockIdx.x % a.sub) * kBlockRows;
  const int row_hi = min(qi * a.bq + a.bq, a.Nq);
  const int* mrow = a.bmap + ((long)bh * a.nq + qi) * a.nk;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < R::STAGES; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(b_full(s), 128);  // every producer thread arrives
      mbar_init(empty(s), kConsumers * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == kConsumers) {
    // Producer: thread 0 issues the TMA loads; with a bias, the whole
    // warpgroup copies the bias slots and arrives on every slot's bias
    // barrier.
    const int pt = threadIdx.x - kConsumers * 128;
    if (!BIAS && pt != 0) return;
    if (pt == 0) {
      mbar_expect_tx(q_full, kConsumers * R::Q_BYTES);
      for (int c = 0; c < kConsumers; ++c)
        load_tile<D>(q_tiles + c * R::Q_BYTES, kWgRows, &maps.q, &maps.qt, q_full,
                     row_lo + c * kWgRows, bh);
    }
    const float* bias_rows =
        BIAS ? a.bias + (long long)(bh / a.H) * a.bias_sb +
                       (long long)(bh % a.H) * a.bias_sh + (long long)row_lo * a.Nk
                 : nullptr;
    const int nrows = min(kBlockRows, row_hi - row_lo);
    Pos pos;
    for (int kj = 0; kj < a.nk; ++kj) {
      const int state = mrow[kj];
      if (state == kSkip) continue;
      const bool partial = BIAS && state == kPartial;
      const int key_end = min((kj + 1) * a.bk, a.Nk);
      for (int key0 = kj * a.bk; key0 < key_end; key0 += kKeys, pos.advance()) {
        const int s = pos.slot;
        mbar_wait(empty(s), pos.phase ^ 1);
        if (pt == 0) {
          mbar_expect_tx(k_full(s), R::KV_BYTES);
          load_tile<D>(slot(s), kKeys, &maps.k, &maps.kt, k_full(s), key0, bh);
          mbar_expect_tx(v_full(s), R::KV_BYTES);
          load_tile<D>(slot(s) + R::KV_BYTES, kKeys, &maps.v, &maps.vt, v_full(s),
                       key0, bh);
        }
        if (!BIAS) continue;
        mbar_arrive(b_full(s));
        if (!partial) continue;
        // The bias takes the next slot, whose K and V barriers complete
        // empty-handed this round.
        pos.advance();
        const int sb = pos.slot;
        mbar_wait(empty(sb), pos.phase ^ 1);
        if (pt == 0) {
          mbar_arrive(k_full(sb));
          mbar_arrive(v_full(sb));
        }
        const float* src = bias_rows + key0;
        const int nkeys = min(kKeys, key_end - key0);
        if (vec) {  // rows, key0 and nkeys are whole 16-byte chunks
          for (int i = pt; i < kBlockRows * (kKeys / 4); i += 128) {
            const int r = i / (kKeys / 4), ch = i % (kKeys / 4);
            if (r < nrows && 4 * ch < nkeys)
              cp_async16(slot(sb) + 4 * bias_at(r, 4 * ch),
                         src + (long long)r * a.Nk + 4 * ch);
          }
        } else {
          for (int i = pt; i < kBlockRows * kKeys; i += 128) {
            const int r = i / kKeys, j = i % kKeys;
            if (r < nrows && j < nkeys)
              cp_async4(slot(sb) + 4 * bias_at(r, j), src + (long long)r * a.Nk + j);
          }
        }
        cp_async_arrive(b_full(sb));
      }
    }
  } else {
    // Consumers: warpgroup wg owns block rows wg*64 .. wg*64 + 63.
    RowState<D> st;
#pragma unroll
    for (int i = 0; i < R::DP / 2; ++i) st.o[i] = 0.f;
    st.m[0] = st.m[1] = kMInit;
    st.l[0] = st.l[1] = 0.f;
    const uint32_t q_tile = q_tiles + wg * R::Q_BYTES;
    const int t = threadIdx.x % 128;
    // This thread's rows r0 and r0 + 8 of the block (accumulator layout),
    // columns (t % 4) * 2 + {0, 1} of each 8-column chunk.
    const int r0 = wg * kWgRows + (t / 32) * 16 + (t % 32) / 4;
    const int col0 = (t % 4) * 2;
    if (a.m_in != nullptr) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row_lo + r0 + 8 * h;
        if (row >= row_hi) continue;
        const long sr = (long)bh * a.Nq + row;
        st.m[h] = a.m_in[sr];
        st.l[h] = a.l_in[sr];
#pragma unroll
        for (int c = 0; c < R::DP / 8; ++c) {
          if (c * 8 >= D) continue;
          const float2 o = *reinterpret_cast<const float2*>(a.acc_in + sr * D + c * 8 + col0);
          st.o[c * 4 + 2 * h] = o.x;
          st.o[c * 4 + 2 * h + 1] = o.y;
        }
      }
    }
    const unsigned char* slot_mem = smem_raw + (slots - raw);
    mbar_wait(q_full, 0);
    Pos pos;
#pragma unroll 1
    for (int kj = 0; kj < a.nk; ++kj) {
      const int state = mrow[kj];
      if (state == kSkip) continue;
      const bool partial = BIAS && state == kPartial;
      const int key_end = min((kj + 1) * a.bk, a.Nk);
#pragma unroll 1
      for (int key0 = kj * a.bk; key0 < key_end; key0 += kKeys, pos.advance()) {
        const Pos kv = pos;
        mbar_wait(k_full(kv.slot), kv.phase);
        const float* bias = nullptr;
        if (partial) {
          pos.advance();
          bias = reinterpret_cast<const float*>(slot_mem + pos.slot * R::SLOT);
        }
        consume_stage<D, BIAS>(st, q_tile, slot(kv.slot), slot(kv.slot) + R::KV_BYTES,
                         bias, r0, v_full(kv.slot), kv.phase, b_full(pos.slot),
                         pos.phase, key0, key_end, a.scale, scale_log2);
        mbar_arrive(empty(kv.slot));
        if (partial) mbar_arrive(empty(pos.slot));
      }
    }

    __nv_bfloat16* oh = static_cast<__nv_bfloat16*>(a.out) + (long)bh * a.Nq * D;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row_lo + r0 + 8 * h;
      if (row >= row_hi) continue;
      if (a.m_out != nullptr) {
        const long sr = (long)bh * a.Nq + row;
        if (t % 4 == 0) {  // the quad's four threads hold the same m and l
          a.m_out[sr] = st.m[h];
          a.l_out[sr] = st.l[h];
        }
#pragma unroll
        for (int c = 0; c < R::DP / 8; ++c) {
          if (c * 8 >= D) continue;
          *reinterpret_cast<float2*>(a.acc_out + sr * D + c * 8 + col0) =
              make_float2(st.o[c * 4 + 2 * h], st.o[c * 4 + 2 * h + 1]);
        }
      }
      // l == 0: every tile of the row was skipped or fully masked.
      const float inv_l = st.l[h] > 0.f ? 1.f / st.l[h] : 0.f;
      __nv_bfloat16* dst = oh + (long)row * D + col0;
#pragma unroll
      for (int c = 0; c < R::DP / 8; ++c) {
        if (c * 8 >= D) continue;  // padding columns
        *reinterpret_cast<uint32_t*>(dst + c * 8) = pack_bf16(
            st.o[c * 4 + 2 * h] * inv_l, st.o[c * 4 + 2 * h + 1] * inv_l);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// CUDA-core path (f32, and bf16 at other head dims; d, dv <= 256)
// ---------------------------------------------------------------------------

constexpr int kFmaRows = 64;  // query rows per block
constexpr int kFmaThreads = 256;

// NJ: output columns a lane holds (lane + 32 j), 4 up to dv 128, else 8.
// At least one block an SM: without the bound ptxas held the NJ = 8
// instances to 128 registers and spilled; with it they keep their 8 x 8
// accumulators in 167-181.  Their shared memory (up to 210 KB) fits one
// block an SM anyway.
template <typename T, int NJ>
__global__ void __launch_bounds__(kFmaThreads, 1) sparse_fma_kernel(Args a) {
  constexpr int VS = 32 * NJ;  // V row stride
  extern __shared__ float sm[];
  const int d = a.d, dv = a.dv;
  const int dp = d + 1;
  const int sp = kChunk + 1;
  float* Qs = sm;                      // [64][d + 1]
  float* Ks = Qs + kFmaRows * dp;      // [64][d + 1]
  float* Vs = Ks + kChunk * dp;        // [64][VS]
  float* Ss = Vs + kChunk * VS;        // [64][65]
  float* m_s = Ss + kFmaRows * sp;     // [64]
  float* l_s = m_s + kFmaRows;         // [64]
  float* a_s = l_s + kFmaRows;         // [64]

  const int qi = blockIdx.x / a.sub;
  const long bh = blockIdx.y;
  const int row_lo = qi * a.bq + (blockIdx.x % a.sub) * kFmaRows;
  const int row_hi = min(qi * a.bq + a.bq, a.Nq);
  const int tid = threadIdx.x;

  const T* qh = static_cast<const T*>(a.q) + bh * a.Nq * d;
  const T* kh = static_cast<const T*>(a.k) + bh * a.Nk * d;
  const T* vh = static_cast<const T*>(a.v) + bh * a.Nk * dv;
  const int* mrow = a.bmap + (bh * a.nq + qi) * a.nk;
  const float* bh_bias =
      a.bias == nullptr
          ? nullptr
          : a.bias + (bh / a.H) * a.bias_sb + (bh % a.H) * a.bias_sh;

  for (int i = tid; i < kFmaRows * d; i += kFmaThreads) {
    const int r = i / d, c = i % d;
    const int row = row_lo + r;
    Qs[r * dp + c] = row < row_hi ? to_f(qh[(long)row * d + c]) : 0.f;
  }
  for (int i = tid; i < kChunk * VS; i += kFmaThreads) Vs[i] = 0.f;
  for (int r = tid; r < kFmaRows; r += kFmaThreads) {
    const int row = row_lo + r;
    const bool carried = a.m_in != nullptr && row < row_hi;
    m_s[r] = carried ? a.m_in[bh * a.Nq + row] : kMInit;
    l_s[r] = carried ? a.l_in[bh * a.Nq + row] : 0.f;
  }
  // A block whose map row is all SKIP runs no tile (and no barrier in
  // the loop), yet stores m_s and l_s, which other warps wrote.
  __syncthreads();

  // Score micro-tile: rows ty + 16*i, keys tx + 16*j.
  const int ty = tid / 16, tx = tid % 16;
  // PV micro-tile: rows warp + 8*i, output columns lane + 32*j.
  const int warp = tid / 32, lane = tid % 32;
  float acc[8][NJ];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = row_lo + warp + 8 * i;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int col = lane + 32 * j;
      acc[i][j] = a.acc_in != nullptr && row < row_hi && col < dv
                      ? a.acc_in[(bh * a.Nq + row) * dv + col]
                      : 0.f;
    }
  }

  for (int kj = 0; kj < a.nk; ++kj) {
    const int state = mrow[kj];  // uniform over the block
    if (state == kSkip) continue;
    const bool add_bias = state == kPartial && bh_bias != nullptr;
    const int key_hi = min((kj + 1) * a.bk, a.Nk);
    for (int c0 = kj * a.bk; c0 < key_hi; c0 += kChunk) {
      const int nkeys = min(kChunk, key_hi - c0);
      __syncthreads();  // the previous chunk's K, V and S are consumed
      for (int i = tid; i < kChunk * d; i += kFmaThreads) {
        const int j = i / d, c = i % d;
        Ks[j * dp + c] = j < nkeys ? to_f(kh[(long)(c0 + j) * d + c]) : 0.f;
      }
      for (int i = tid; i < kChunk * dv; i += kFmaThreads) {
        const int j = i / dv, c = i % dv;
        Vs[j * VS + c] = j < nkeys ? to_f(vh[(long)(c0 + j) * dv + c]) : 0.f;
      }
      __syncthreads();

      float sc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
      for (int c = 0; c < d; ++c) {
        float qv[4], kv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * dp + c];
#pragma unroll
        for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * dp + c];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i;
        const int row = row_lo + r;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int kk = tx + 16 * j;
          float x = -INFINITY;
          if (kk < nkeys) {
            x = sc[i][j] * a.scale;
            if (add_bias && row < row_hi)
              x = x + bh_bias[(long long)row * a.Nk + c0 + kk];
          }
          Ss[r * sp + kk] = x;
        }
      }
      __syncthreads();

      // Online softmax: four threads per row.
      {
        const int r = tid / 4, part = tid % 4;
        float mx = -INFINITY;
        for (int kk = part; kk < kChunk; kk += 4) mx = fmaxf(mx, Ss[r * sp + kk]);
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_prev = m_s[r];
        const float m_new = fmaxf(m_prev, mx);
        float sum = 0.f;
        for (int kk = part; kk < kChunk; kk += 4) {
          const float p = exp2f((Ss[r * sp + kk] - m_new) * kLog2e);
          Ss[r * sp + kk] = round_as(p, T());
          sum += p;
        }
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        if (part == 0) {
          const float alpha = exp2f((m_prev - m_new) * kLog2e);
          l_s[r] = alpha * l_s[r] + sum;
          m_s[r] = m_new;
          a_s[r] = alpha;
        }
      }
      __syncthreads();

      // acc = alpha * acc + P V.
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float alpha = a_s[warp + 8 * i];
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] *= alpha;
      }
      for (int kk = 0; kk < nkeys; ++kk) {
        float vv[NJ], pv[8];
#pragma unroll
        for (int j = 0; j < NJ; ++j) vv[j] = Vs[kk * VS + lane + 32 * j];
#pragma unroll
        for (int i = 0; i < 8; ++i) pv[i] = Ss[(warp + 8 * i) * sp + kk];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
      }
    }
  }

  T* oh = static_cast<T*>(a.out) + bh * a.Nq * dv;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = warp + 8 * i;
    const int row = row_lo + r;
    if (row >= row_hi) continue;
    // l == 0: every tile of the row was skipped or fully masked.
    const float inv_l = l_s[r] > 0.f ? 1.f / l_s[r] : 0.f;
    const long sr = bh * a.Nq + row;
    if (a.m_out != nullptr && lane == 0) {
      a.m_out[sr] = m_s[r];
      a.l_out[sr] = l_s[r];
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int col = lane + 32 * j;
      if (col >= dv) continue;
      from_f(oh + (long)row * dv + col, acc[i][j] * inv_l);
      if (a.acc_out != nullptr) a.acc_out[sr * dv + col] = acc[i][j];
    }
  }
}

// The (BH, N, d) bf16 operand as a 3-D map (d, N, BH) whose box is
// `box_c` channels of `box_rows` rows of one head, swizzled over `sw`
// bytes as the wgmma descriptors read it.  Rows past N fill with zeros,
// and a box never reads into the next head.
int encode_rows(CUtensorMap* map, const void* ptr, int d, int N, int BH,
                int box_c, int box_rows, int sw) {
  EncodeTiledFn fn = encode_fn();
  if (fn == nullptr) return kEncodeError + (int)CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)N, (cuuint64_t)BH};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2, (cuuint64_t)N * d * 2};
  const cuuint32_t box[3] = {(cuuint32_t)box_c, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult res = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                          const_cast<void*>(ptr), dims, strides, box, elem,
                          CU_TENSOR_MAP_INTERLEAVE_NONE, tma_swizzle(sw),
                          CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : kEncodeError + (int)res;
}

template <int D, bool BIAS>
int launch_wgmma(Args a, int BH, cudaStream_t s) {
  using R = Ring<D>;
  if ((reinterpret_cast<uintptr_t>(a.q) | reinterpret_cast<uintptr_t>(a.k) |
       reinterpret_cast<uintptr_t>(a.v) | reinterpret_cast<uintptr_t>(a.out)) % 16)
    return (int)cudaErrorMisalignedAddress;  // TMA needs 16-byte bases
  Maps maps = {};
  int rc = encode_rows(&maps.q, a.q, D, a.Nq, BH, R::MAIN_BOXC, kWgRows, R::MAIN_SW);
  if (rc == 0) rc = encode_rows(&maps.k, a.k, D, a.Nk, BH, R::MAIN_BOXC, kKeys, R::MAIN_SW);
  if (rc == 0) rc = encode_rows(&maps.v, a.v, D, a.Nk, BH, R::MAIN_BOXC, kKeys, R::MAIN_SW);
  if (R::TAIL_C > 0) {
    if (rc == 0) rc = encode_rows(&maps.qt, a.q, D, a.Nq, BH, R::TAIL_C, kWgRows, R::TAIL_SW);
    if (rc == 0) rc = encode_rows(&maps.kt, a.k, D, a.Nk, BH, R::TAIL_C, kKeys, R::TAIL_SW);
    if (rc == 0) rc = encode_rows(&maps.vt, a.v, D, a.Nk, BH, R::TAIL_C, kKeys, R::TAIL_SW);
  }
  if (rc != 0) return rc;
  // 16-byte bias copies need every copied row to start on a 16-byte
  // boundary: the base, both head strides, the row length and the first
  // key of every stage (a multiple of bk or of 128 past it).
  const int vec = BIAS && reinterpret_cast<uintptr_t>(a.bias) % 16 == 0 &&
                  a.bias_sb % 4 == 0 && a.bias_sh % 4 == 0 && a.Nk % 4 == 0 &&
                  a.bk % 4 == 0;
  a.sub = (a.bq + kBlockRows - 1) / kBlockRows;
  cudaError_t err = cudaFuncSetAttribute(
      sparse_wgmma_kernel<D, BIAS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      R::SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(a.nq * a.sub, BH);
  sparse_wgmma_kernel<D, BIAS><<<grid, kWgmmaThreads, R::SMEM, s>>>(
      maps, a, vec, a.scale * kLog2e);
  return (int)cudaGetLastError();
}

template <int D>
int launch_wgmma_d(Args a, int BH, cudaStream_t s) {
  return a.bias != nullptr ? launch_wgmma<D, true>(a, BH, s)
                           : launch_wgmma<D, false>(a, BH, s);
}

template <typename T, int NJ>
cudaError_t launch_fma_cols(Args a, int BH, cudaStream_t s) {
  a.sub = (a.bq + kFmaRows - 1) / kFmaRows;
  const dim3 grid(a.nq * a.sub, BH);
  // At d = dv = 256: 2 x 64 x 257 + 64 x 256 + 64 x 65 + 192 floats, 210 KB.
  const size_t smem =
      sizeof(float) * ((size_t)(kFmaRows + kChunk) * (a.d + 1) + (size_t)kChunk * 32 * NJ +
                       (size_t)kFmaRows * (kChunk + 1) + 3 * kFmaRows);
  cudaError_t err = cudaFuncSetAttribute(
      sparse_fma_kernel<T, NJ>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  sparse_fma_kernel<T, NJ><<<grid, kFmaThreads, smem, s>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_fma(Args a, int BH, cudaStream_t s) {
  return a.dv > 128 ? launch_fma_cols<T, 8>(a, BH, s) : launch_fma_cols<T, 4>(a, BH, s);
}


bool tensor_cores(int is_bf16, int d, int dv) {
  return is_bf16 && d == dv &&
         (d == 32 || d == 40 || d == 64 || d == 80 || d == 128 || d == 160);
}

}  // namespace

// q: (BH, Nq, d); k: (BH, Nk, d); v: (BH, Nk, dv); out: (BH, Nq, dv); all
// contiguous, float32 (is_bf16 = 0) or bfloat16, 16-byte aligned.
// m_in, l_in, acc_in: null, or the carry to start from (f32, (BH, Nq),
// (BH, Nq), (BH, Nq, dv), contiguous; all three or none); m_out, l_out,
// acc_out: null, or where to store the state after the last tile.
// bmap: (BH, ceil(Nq/bq), ceil(Nk/bk)) int32 states.  bias: null, or f32
// rows of Nk floats, row `row` of head (b, h) = bh / H, bh % H at
// bias + b*bias_sb + h*bias_sh + row*Nk.  Returns the CUDA error of the
// launch (0 on success), or kEncodeError + the CUresult of a failed
// tensor-map encode.
extern "C" int sparse_attention_launch(const void* q, const void* k, const void* v,
                                       void* out, const void* bias, const void* bmap,
                                       const void* m_in, const void* l_in,
                                       const void* acc_in, void* m_out, void* l_out,
                                       void* acc_out, int is_bf16, int BH, int H, int Nq, int Nk,
                                       int d, int dv, int bq, int bk,
                                       long long bias_sb, long long bias_sh,
                                       float scale, void* stream) {
  if (BH < 1 || BH > 65535 || H < 1 || BH % H || Nq < 1 || Nk < 1 || d < 1 ||
      d > kMaxDim || dv < 1 || dv > kMaxDim || bq < 1 || bk < 1 ||
      (m_in == nullptr) != (l_in == nullptr) || (m_in == nullptr) != (acc_in == nullptr) ||
      (m_out == nullptr) != (l_out == nullptr) || (m_out == nullptr) != (acc_out == nullptr))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.out = out;
  a.bias = static_cast<const float*>(bias);
  a.bmap = static_cast<const int*>(bmap);
  a.m_in = static_cast<const float*>(m_in);
  a.l_in = static_cast<const float*>(l_in);
  a.acc_in = static_cast<const float*>(acc_in);
  a.m_out = static_cast<float*>(m_out);
  a.l_out = static_cast<float*>(l_out);
  a.acc_out = static_cast<float*>(acc_out);
  a.H = H;
  a.Nq = Nq;
  a.Nk = Nk;
  a.d = d;
  a.dv = dv;
  a.bq = bq;
  a.bk = bk;
  a.nq = (Nq + bq - 1) / bq;
  a.nk = (Nk + bk - 1) / bk;
  a.sub = 1;
  a.bias_sb = bias_sb;
  a.bias_sh = bias_sh;
  a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tensor_cores(is_bf16, d, dv)) {
    switch (d) {
      case 32: return launch_wgmma_d<32>(a, BH, s);
      case 40: return launch_wgmma_d<40>(a, BH, s);
      case 64: return launch_wgmma_d<64>(a, BH, s);
      case 80: return launch_wgmma_d<80>(a, BH, s);
      case 128: return launch_wgmma_d<128>(a, BH, s);
      default: return launch_wgmma_d<160>(a, BH, s);
    }
  }
  if (is_bf16) return (int)launch_fma<__nv_bfloat16>(a, BH, s);
  return (int)launch_fma<float>(a, BH, s);
}

// Which path a call takes: 1 for the tensor-core kernel (bf16 with d == dv
// in {32, 40, 64, 80, 128, 160}), 0 for CUDA cores.
extern "C" int sparse_uses_tensor_cores(int is_bf16, int d, int dv) {
  return tensor_cores(is_bf16, d, dv);
}
