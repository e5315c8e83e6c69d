// Fused three-axis Δ-check + snap (TimeRipple paper Fig. 6 steps 1-2).
//
// Replaces: src/repro/kernels/reuse_mask/kernel.py::fused_reuse_kernel
//   (body _fused_kernel, wrapper ops.py::fused_reuse_snap).
//
// Computes, for one operand (n0, n1, N, d) read in place through its
// strides (unit channel stride), whose tokens [start, start + T*H*W) are
// grid tokens in (t, y, x) row-major order: the window-2 Δ (Eq. 3) along
// t (frame pairs), x (adjacent tokens of a row) and y (adjacent rows),
// gated per channel or by the mean over the channels of a token against
// θ = (θt, θx, θy); the three masks are OR-aggregated with first-wins copy
// source in priority order, always from the original operand.  Writes the
// full snapped (n0, n1, N, d) operand and a one-byte mask, contiguous:
// grid tokens snapped, the other (text) tokens copied through with mask 0.
// Given a source-map pointer, the same launch also writes the grid
// segment's (n0, n1, T*H*W, d) int32 snap-source map: for each entry the
// grid-local token of the representative of the axis that claimed it
// first, or its own token.  Gathering the segment by it gives the snapped
// segment (the decision cache replays it; the reference's host pipeline
// compute_reuse(want_src=True) is its plain version).
//
// Bound on the H100: device memory.  Each element is read once (2 or 4 B)
// and written twice (value + 1 B mask), plus 4 B of source map a grid
// element when it is asked for.  The bf16 arithmetic that the
// plain version rounds after every op costs some twenty instructions an
// element even so, so the design keeps the instruction count down too:
//
// * 16-byte lanes.  A thread owns one 16-byte channel chunk (8 bf16 or 4
//   f32) of one 2x2(x2) cube (tt, yy, xx): it loads 4 or 8 vectors, which
//   hold every t-, x- and y-partner it needs, and stores 16-byte vectors
//   and 8- or 4-byte mask words.  Consecutive threads take consecutive
//   chunks of a token, then the next cube along x, so a warp's accesses
//   cover whole rows.  A row whose chunks cannot be 16-byte vectors (d not
//   a multiple of 8 in bf16 or 4 in f32, or an unaligned view) runs the
//   scalar instance of the same kernel (one element a chunk).
// * Packed words.  bf16 lanes stay packed two to a 32-bit word; each
//   rounding to bf16 is one cvt.rn.bf16x2.f32 for two channels, and the
//   snap and mask are bit operations on whole words.
// * No square root on the channel gate.  Δ = rn(sqrt(s)) < θ exactly when
//   s < s*(θ), the least value of the working type above b², b the
//   midpoint between θ and its predecessor (see sstar below); each thread
//   derives s* once.  The token gate keeps the square root: it sums Δ.
// * A flat grid-stride loop over (lead, frame pair, row pair, x-pair,
//   chunk), then over the text tokens, with as many blocks as fill the
//   SMs once at the kernel's occupancy and every block taking the same
//   number of passes.
//
// Bit-equality with the plain version (core/reuse.py::compute_reuse):
// every op is an explicitly rounded intrinsic (__fadd_rn, __fmul_rn) so
// nothing contracts into an FMA, and bf16 values are rounded back to bf16
// after each op where the host path rounds.  A mean is a float32 sum
// times the float32 reciprocal of its count, rounded once; the token gate
// sums channels in ascending order (a chain through the chunk owners).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

extern "C" int fused_reuse_vector_path(int is_bf16, int d, const void* x,
                                       long long n0, long long s0,
                                       long long n1, long long s1,
                                       long long sN);

namespace {

constexpr int kThreads = 256;  // most threads a block (whole chunks of tokens)
constexpr int kSlots = 12;     // 4 Δ per axis (t, x, y) in one 2x2x2 cube

__device__ __forceinline__ float mean2(float a, float b) {
  return __fmul_rn(__fadd_rn(a, b), 0.5f);
}

__device__ __forceinline__ float sqr(float a) { return __fmul_rn(a, a); }

// bf16 lanes of a 32-bit word: element 2j in the low half, 2j+1 high.
__device__ __forceinline__ float lo16(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float hi16(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}
__device__ __forceinline__ uint32_t pack_rn(float l, float h) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(h), "f"(l));
  return r;
}

// s* for θ: Δ = rn(sqrt(s)) < θ  <=>  s < s*.  For θ > 0 with predecessor
// θ⁻ (the next smaller value of the working type), rn(sqrt(s)) < θ iff
// sqrt(s) < b = (θ⁻ + θ) / 2: b has one significant bit more than the
// type, so b² is never a value of the type and sqrt(s) never lands within
// a rounding of b (s and b² differ by at least b²'s own last bit, a
// relative 2^-18 in bf16, while float32's sqrt is within 2^-24 of the
// exact root).  So the test is s < b², i.e. s < s* = b² rounded up to the
// type; b and b² are exact in double.  θ = +inf gives s* = +inf; θ ≤ 0,
// -0 or NaN give s* = 0, which nothing lies below (s ≥ +0 or NaN).
struct Bf16Word {
  using Elem = uint16_t;
  static constexpr int kLanes = 2;

  // The mean of squared deviations of the window (a0, a1) per lane (Eq. 3
  // before its root), each op rounded to bf16 as the host path rounds.
  static __device__ __forceinline__ uint32_t sq(uint32_t a0, uint32_t a1) {
    const float x0 = lo16(a0), y0 = hi16(a0), x1 = lo16(a1), y1 = hi16(a1);
    const uint32_t m = pack_rn(mean2(x0, x1), mean2(y0, y1));
    const float mx = lo16(m), my = hi16(m);
    const uint32_t d0 = pack_rn(__fsub_rn(x0, mx), __fsub_rn(y0, my));
    const uint32_t d1 = pack_rn(__fsub_rn(x1, mx), __fsub_rn(y1, my));
    const uint32_t s0 = pack_rn(sqr(lo16(d0)), sqr(hi16(d0)));
    const uint32_t s1 = pack_rn(sqr(lo16(d1)), sqr(hi16(d1)));
    return pack_rn(mean2(lo16(s0), lo16(s1)), mean2(hi16(s0), hi16(s1)));
  }

  // All ones in each lane whose s lies below s* (s* ≤ 0x7f80 in both
  // halves): 0x8000 + s - s* per lane borrows from no neighbour, and its
  // top bit is clear exactly when s < s*.  A NaN s with its sign bit set
  // stays above 0x8000 too.
  static __device__ __forceinline__ uint32_t below(uint32_t s, uint32_t ss) {
    const uint32_t t = (s | 0x80008000u) - ss;
    return ((~t & 0x80008000u) >> 15) * 0xffffu;
  }

  static __device__ uint32_t sstar(float th) {
    const uint32_t raw = __float_as_uint(th) >> 16;  // θ is a bf16 value
    if (raw == 0 || raw > 0x7f80u) return 0;
    const double b = 0.5 * ((double)__uint_as_float((raw - 1) << 16) + (double)th);
    const uint32_t r =
        __bfloat16_as_ushort(__float2bfloat16_ru(__double2float_ru(b * b)));
    return r | (r << 16);
  }

  static __device__ __forceinline__ float lane(uint32_t w, int i) {
    return i ? hi16(w) : lo16(w);
  }
  static __device__ __forceinline__ float rnd(float v) {
    return lo16(pack_rn(v, 0.f));
  }
};

struct F32Word {
  using Elem = uint32_t;
  static constexpr int kLanes = 1;

  static __device__ __forceinline__ uint32_t sq(uint32_t a0, uint32_t a1) {
    const float x0 = __uint_as_float(a0), x1 = __uint_as_float(a1);
    const float m = mean2(x0, x1);
    return __float_as_uint(mean2(sqr(__fsub_rn(x0, m)), sqr(__fsub_rn(x1, m))));
  }
  static __device__ __forceinline__ uint32_t below(uint32_t s, uint32_t ss) {
    return __uint_as_float(s) < __uint_as_float(ss) ? 0xffffffffu : 0u;
  }
  static __device__ uint32_t sstar(float th) {
    const uint32_t u = __float_as_uint(th);
    if (u == 0 || u > 0x7f800000u) return 0;
    const double b = 0.5 * ((double)__uint_as_float(u - 1) + (double)th);
    return __float_as_uint(__double2float_ru(b * b));
  }
  static __device__ __forceinline__ float lane(uint32_t w, int) {
    return __uint_as_float(w);
  }
  static __device__ __forceinline__ float rnd(float v) { return v; }
};

// One chunk of a token: 4 words (16 bytes) in the vector instance, one
// element (in the low lane of a word) in the scalar one.
template <class W, bool VEC>
struct Chunk {
  using Elem = typename W::Elem;
  static constexpr int kWords = VEC ? 4 : 1;
  static constexpr int kLanes = VEC ? W::kLanes : 1;  // elements a word
  static constexpr int kElems = kWords * kLanes;

  static __device__ __forceinline__ void load(const Elem* p,
                                              uint32_t (&w)[kWords]) {
    if constexpr (VEC) {
      const uint4 v = *reinterpret_cast<const uint4*>(p);
      w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w;
    } else {
      w[0] = *p;
    }
  }
  static __device__ __forceinline__ void store(Elem* p,
                                               const uint32_t (&w)[kWords]) {
    if constexpr (VEC)
      *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
    else
      *p = static_cast<Elem>(w[0]);
  }
  // m: all ones in each claimed lane -> one byte 0/1 per element.
  static __device__ __forceinline__ void store_mask(
      uint8_t* p, const uint32_t (&m)[kWords]) {
    if constexpr (!VEC) {
      *p = static_cast<uint8_t>(m[0] & 1u);
    } else if constexpr (W::kLanes == 2) {
      *reinterpret_cast<uint2*>(p) =
          make_uint2(__byte_perm(m[0], m[1], 0x6420) & 0x01010101u,
                     __byte_perm(m[2], m[3], 0x6420) & 0x01010101u);
    } else {
      *reinterpret_cast<uint32_t*>(p) =
          __byte_perm(__byte_perm(m[0], m[1], 0x0040),
                      __byte_perm(m[2], m[3], 0x0040), 0x5410) &
          0x01010101u;
    }
  }
};

struct Args {
  const void* x;
  void* out;
  uint8_t* mask;
  int32_t* src;          // grid segment's source map, or null
  int n_grid;            // T * H * W
  long long s0, s1, sN;  // element strides: lead dims, token
  int n1, N, start;      // inner lead size; tokens; first grid token
  int nG, H, W, d, C;    // frame groups a lead; rows; columns; d; chunks
  int k;                 // cubes (or text tokens) a block pass
  unsigned n_lead, n_cubes, n_text;  // text: tokens in all leads
  int order;  // priority permutation of (t, x, y), see kOrders
  float th[3];
  float inv_d;
};

// Axis ids in priority order (absent axes last, with θ 0: never firing).
__host__ __device__ constexpr int order_axis(int order, int i) {
  constexpr int kOrders[6][3] = {{0, 1, 2}, {0, 2, 1}, {1, 0, 2},
                                 {1, 2, 0}, {2, 0, 1}, {2, 1, 0}};
  return kOrders[order][i];
}

// Snap one cube position (tt, yy, xx) along axis A if it follows there:
// t: the second frame takes the first; x: the odd column the even one;
// y: the odd row the even one.  Lower priorities are applied first.
template <int A, int TT, int NW>
__device__ __forceinline__ void take(uint32_t& val, uint32_t& claimed,
                                     const uint32_t (&v)[TT][2][2][NW],
                                     const uint32_t (&ok)[3][4][NW], int tt,
                                     int yy, int xx, int w) {
  uint32_t m, rep;
  if (A == 0) {
    if (tt != 1) return;
    m = ok[0][yy * 2 + xx][w], rep = v[0][yy][xx][w];
  } else if (A == 1) {
    if (xx != 1) return;
    m = ok[1][tt * 2 + yy][w], rep = v[tt][yy][0][w];
  } else {
    if (yy != 1) return;
    m = ok[2][tt * 2 + xx][w], rep = v[tt][0][xx][w];
  }
  val = (rep & m) | (val & ~m);
  claimed |= m;
}

template <class Ch, int TT, int P0, int P1, int P2>
__device__ __forceinline__ void snap_store(
    const uint32_t (&v)[TT][2][2][Ch::kWords],
    const uint32_t (&ok)[3][4][Ch::kWords], typename Ch::Elem* out,
    uint8_t* mask, long long ob, long long dT, long long dY, long long dX) {
  constexpr int NW = Ch::kWords;
#pragma unroll
  for (int tt = 0; tt < TT; ++tt)
#pragma unroll
    for (int yy = 0; yy < 2; ++yy)
#pragma unroll
      for (int xx = 0; xx < 2; ++xx) {
        uint32_t val[NW], claimed[NW];
#pragma unroll
        for (int w = 0; w < NW; ++w) {
          val[w] = v[tt][yy][xx][w];
          claimed[w] = 0;
          take<P2, TT, NW>(val[w], claimed[w], v, ok, tt, yy, xx, w);
          take<P1, TT, NW>(val[w], claimed[w], v, ok, tt, yy, xx, w);
          take<P0, TT, NW>(val[w], claimed[w], v, ok, tt, yy, xx, w);
        }
        const long long o = ob + tt * dT + yy * dY + xx * dX;
        Ch::store(out + o, val);
        Ch::store_mask(mask + o, claimed);
      }
}

// The source-map counterpart of take(): s becomes the representative's
// grid-local token where lane `shift` of axis A's mask is set.
template <int A, int NW>
__device__ __forceinline__ void src_take(int& s, const uint32_t (&ok)[3][4][NW],
                                         int tt, int yy, int xx, int w,
                                         int shift, int own, int HW, int W) {
  uint32_t m;
  int rep;
  if (A == 0) {
    if (tt != 1) return;
    m = ok[0][yy * 2 + xx][w], rep = own - HW;
  } else if (A == 1) {
    if (xx != 1) return;
    m = ok[1][tt * 2 + yy][w], rep = own - 1;
  } else {
    if (yy != 1) return;
    m = ok[2][tt * 2 + xx][w], rep = own - W;
  }
  if ((m >> shift) & 1u) s = rep;
}

// Writes the cube's source map: int32 per element, 16-byte stores in the
// vector instance.  own0 is the cube origin's grid-local token, sb its
// element offset in the map.
template <class Ch, int TT, int P0, int P1, int P2>
__device__ __forceinline__ void src_store(const uint32_t (&ok)[3][4][Ch::kWords],
                                          int32_t* src, long long sb, int own0,
                                          int HW, int W, int d) {
  constexpr int NW = Ch::kWords, L = Ch::kLanes, V = Ch::kElems;
#pragma unroll
  for (int tt = 0; tt < TT; ++tt)
#pragma unroll
    for (int yy = 0; yy < 2; ++yy)
#pragma unroll
      for (int xx = 0; xx < 2; ++xx) {
        const int pos = tt * HW + yy * W + xx;
        const int own = own0 + pos;
        int s[V];
#pragma unroll
        for (int w = 0; w < NW; ++w)
#pragma unroll
          for (int i = 0; i < L; ++i) {
            int& e = s[w * L + i];
            const int shift = 16 * i;  // bf16 lanes: low half, then high
            e = own;
            src_take<P2, NW>(e, ok, tt, yy, xx, w, shift, own, HW, W);
            src_take<P1, NW>(e, ok, tt, yy, xx, w, shift, own, HW, W);
            src_take<P0, NW>(e, ok, tt, yy, xx, w, shift, own, HW, W);
          }
        int32_t* p = src + sb + (long long)pos * d;
        if constexpr (V % 4 == 0) {
#pragma unroll
          for (int j = 0; j < V / 4; ++j)
            reinterpret_cast<int4*>(p)[j] =
                make_int4(s[4 * j], s[4 * j + 1], s[4 * j + 2], s[4 * j + 3]);
        } else {
          p[0] = s[0];
        }
      }
}

// The mean squared deviation s of each Δ slot's window, per lane: t slot
// k = yy*2+xx; x slot k = tt*2+yy; y slot k = tt*2+xx.  Slots of a
// missing frame (TT = 1) are 0 and unused.
template <class W, int TT, int NW>
__device__ __forceinline__ void cube_sq(const uint32_t (&v)[TT][2][2][NW],
                                        uint32_t (&ok)[3][4][NW]) {
#pragma unroll
  for (int w = 0; w < NW; ++w)
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int hi = k >> 1, lo = k & 1;  // (yy, xx) for t; (tt, ·) for x, y
      const int tt = hi < TT ? hi : 0;
      ok[0][k][w] = TT == 2 ? W::sq(v[0][hi][lo][w], v[TT - 1][hi][lo][w]) : 0;
      ok[1][k][w] = hi < TT ? W::sq(v[tt][lo][0][w], v[tt][lo][1][w]) : 0;
      ok[2][k][w] = hi < TT ? W::sq(v[tt][0][lo][w], v[tt][1][lo][w]) : 0;
    }
}

// The channel gate: s -> all ones in each lane with s < s* of its axis.
template <class W, int NW>
__device__ __forceinline__ void gate(uint32_t (&ok)[3][4][NW],
                                     const uint32_t (&ss)[3]) {
#pragma unroll
  for (int ax = 0; ax < 3; ++ax)
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int w = 0; w < NW; ++w) ok[ax][k][w] = W::below(ok[ax][k][w], ss[ax]);
}

// Writes the snapped cube in the priority order `order` (uniform).
template <class Ch, int TT>
__device__ __forceinline__ void snap_store_order(
    int order, const uint32_t (&v)[TT][2][2][Ch::kWords],
    const uint32_t (&ok)[3][4][Ch::kWords], typename Ch::Elem* out,
    uint8_t* mask, long long ob, long long dT, long long dY, long long dX) {
  switch (order) {
#define SNAP_CASE(o)                                                         \
  case o:                                                                    \
    snap_store<Ch, TT, order_axis(o, 0), order_axis(o, 1), order_axis(o, 2)>( \
        v, ok, out, mask, ob, dT, dY, dX);                                   \
    break;
    SNAP_CASE(0) SNAP_CASE(1) SNAP_CASE(2) SNAP_CASE(3) SNAP_CASE(4)
    SNAP_CASE(5)
#undef SNAP_CASE
  }
}

// Writes the cube's source map in the priority order `order` (uniform).
template <class Ch, int TT>
__device__ __forceinline__ void src_store_order(
    int order, const uint32_t (&ok)[3][4][Ch::kWords], int32_t* src,
    long long sb, int own0, int HW, int W, int d) {
  switch (order) {
#define SRC_CASE(o)                                                          \
  case o:                                                                    \
    src_store<Ch, TT, order_axis(o, 0), order_axis(o, 1), order_axis(o, 2)>( \
        ok, src, sb, own0, HW, W, d);                                        \
    break;
    SRC_CASE(0) SRC_CASE(1) SRC_CASE(2) SRC_CASE(3) SRC_CASE(4) SRC_CASE(5)
#undef SRC_CASE
  }
}

// Text tokens: copied through with mask 0, one chunk an item.
template <class Ch>
__device__ __forceinline__ void copy_text(const Args& a, unsigned first,
                                          unsigned stride) {
  using Elem = typename Ch::Elem;
  constexpr int NW = Ch::kWords, V = Ch::kElems;
  const Elem* __restrict__ x = static_cast<const Elem*>(a.x);
  Elem* __restrict__ out = static_cast<Elem*>(a.out);
  const unsigned n_txt = a.n_text / a.n_lead;  // text tokens a lead
  const unsigned total = a.n_text * a.C;
  for (unsigned i = first; i < total; i += stride) {
    const unsigned u = i / a.C, chunk = i - u * a.C;
    const unsigned l = u / n_txt, j = u - l * n_txt;
    const unsigned tok = j < (unsigned)a.start ? j : j + (a.N - n_txt);
    const unsigned l0 = l / a.n1, l1 = l - l0 * a.n1;
    uint32_t w[NW], zero[NW] = {};
    Ch::load(x + l0 * a.s0 + l1 * a.s1 + tok * a.sN + chunk * V, w);
    const long long o = ((long long)l * a.N + tok) * a.d + chunk * V;
    Ch::store(out + o, w);
    Ch::store_mask(a.mask + o, zero);
  }
}

// TT (frames a cube: 2 with the t check, else 1), the gate and whether
// the source map is written are template parameters so every loop
// unrolls, the cube stays in registers, and a call without a map runs
// the code it ran before the map existed.  blockDim.x = k * C: thread i
// owns chunk i % C of cube (or text token) i / C of each pass.
template <class W, bool VEC, int TT, bool TOKEN, bool SRC>
__global__ void __launch_bounds__(kThreads)
    fused_reuse_kernel(const Args a) {
  using Ch = Chunk<W, VEC>;
  using Elem = typename W::Elem;
  constexpr int NW = Ch::kWords, V = Ch::kElems;
  extern __shared__ float red[];  // [k][kSlots]: the token gate's channel sums
  const Elem* __restrict__ x = static_cast<const Elem*>(a.x);
  Elem* __restrict__ out = static_cast<Elem*>(a.out);
  const int chunk = threadIdx.x % a.C;
  const int slot = threadIdx.x / a.C;
  const unsigned Wp = a.W / 2, Hp = a.H / 2;
  const unsigned step = gridDim.x * a.k;
  const long long sT = (long long)a.H * a.W * a.sN, sY = (long long)a.W * a.sN;
  const long long oT = (long long)a.H * a.W * a.d, oY = (long long)a.W * a.d;
  uint32_t ss[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) ss[i] = TOKEN ? 0 : W::sstar(a.th[i]);

  for (unsigned base = blockIdx.x * a.k; base < a.n_cubes; base += step) {
    const unsigned q = base + slot;
    const bool live = q < a.n_cubes;
    const unsigned p = q % Wp, t1 = q / Wp;
    const unsigned r = t1 % Hp, t2 = t1 / Hp;
    const unsigned g = t2 % a.nG, l = t2 / a.nG;
    const unsigned l0 = l / a.n1, l1 = l - l0 * a.n1;
    const long long tok0 = a.start + ((long long)g * TT * a.H + 2 * r) * a.W + 2 * p;
    const long long ib = l0 * a.s0 + l1 * a.s1 + tok0 * a.sN + chunk * V;
    const long long ob = ((long long)l * a.N + tok0) * a.d + chunk * V;

    uint32_t v[TT][2][2][NW];
#pragma unroll
    for (int tt = 0; tt < TT; ++tt)
#pragma unroll
      for (int yy = 0; yy < 2; ++yy)
#pragma unroll
        for (int xx = 0; xx < 2; ++xx) {
          if (live)
            Ch::load(x + ib + tt * sT + yy * sY + xx * a.sN, v[tt][yy][xx]);
          else
#pragma unroll
            for (int w = 0; w < NW; ++w) v[tt][yy][xx][w] = 0;
        }

    uint32_t ok[3][4][NW];
    cube_sq<W, TT, NW>(v, ok);
    if constexpr (!TOKEN) {
      gate<W, NW>(ok, ss);
    } else {
      // Channel sums in ascending order: the chunk owners of a cube add
      // their Δ in turn to a running float32 sum in shared memory.
      float* acc = red + slot * kSlots;
      for (int j = 0; j < a.C; ++j) {
        if (live && chunk == j) {
#pragma unroll
          for (int s = 0; s < kSlots; ++s) {
            if (s < 4 && TT == 1) continue;  // no t check on one frame
            float sum = j ? acc[s] : 0.f;
#pragma unroll
            for (int w = 0; w < NW; ++w)
#pragma unroll
              for (int i = 0; i < Ch::kLanes; ++i) {
                const float dl = W::rnd(__fsqrt_rn(W::lane(ok[s / 4][s % 4][w], i)));
                sum = (j == 0 && w == 0 && i == 0) ? dl : __fadd_rn(sum, dl);
              }
            acc[s] = sum;
          }
        }
        __syncthreads();
      }
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
        const bool pass = (s >= 4 || TT == 2) &&
                          W::rnd(__fmul_rn(acc[s], a.inv_d)) < a.th[s / 4];
#pragma unroll
        for (int w = 0; w < NW; ++w) ok[s / 4][s % 4][w] = pass ? 0xffffffffu : 0u;
      }
      __syncthreads();  // every sum read before the next pass writes
    }
    if (!live) continue;

    snap_store_order<Ch, TT>(a.order, v, ok, out, a.mask, ob, oT, oY, a.d);
    if constexpr (SRC) {
      const int own0 = (int)(tok0 - a.start);
      const long long sb = ((long long)l * a.n_grid + own0) * a.d + chunk * V;
      src_store_order<Ch, TT>(a.order, ok, a.src, sb, own0, a.H * a.W, a.W, a.d);
    }
  }

  copy_text<Ch>(a, blockIdx.x * blockDim.x + threadIdx.x,
                gridDim.x * blockDim.x);
}

// Blocks of one launch: enough to fill every SM once at the kernel's
// occupancy, and every block the same number of passes.
template <class W, bool VEC, int TT, bool TOKEN, bool SRC>
int launch(Args a, int threads, cudaStream_t s) {
  auto kern = fused_reuse_kernel<W, VEC, TT, TOKEN, SRC>;
  static int cached_threads = -1, per_sm = 1;  // per instantiation
  static size_t cached_smem = 0;
  const size_t smem = TOKEN ? (size_t)a.k * kSlots * sizeof(float) : 0;
  if (cached_threads != threads || cached_smem != smem) {
    int n = 0;
    cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, kern, threads, smem);
    if (e != cudaSuccess) return (int)e;
    per_sm = n > 0 ? n : 1;
    cached_threads = threads, cached_smem = smem;
  }
  static int sms[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!sms[dev]) cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
  const unsigned units = (a.n_cubes > a.n_text ? a.n_cubes : a.n_text);
  const unsigned passes_units = (units + a.k - 1) / a.k;  // block passes in all
  const unsigned most = (unsigned)(sms[dev] > 0 ? sms[dev] : 1) * per_sm;
  const unsigned passes = (passes_units + most - 1) / most;
  const unsigned blocks = passes ? (passes_units + passes - 1) / passes : 1;
  kern<<<blocks ? blocks : 1, threads, smem, s>>>(a);
  return (int)cudaGetLastError();
}

template <class W, bool SRC>
int dispatch_src(Args a, bool vec, int TT, bool token, int threads,
                 cudaStream_t s) {
  if (vec) {
    if (TT == 2)
      return token ? launch<W, true, 2, true, SRC>(a, threads, s)
                   : launch<W, true, 2, false, SRC>(a, threads, s);
    return token ? launch<W, true, 1, true, SRC>(a, threads, s)
                 : launch<W, true, 1, false, SRC>(a, threads, s);
  }
  if (TT == 2)
    return token ? launch<W, false, 2, true, SRC>(a, threads, s)
                 : launch<W, false, 2, false, SRC>(a, threads, s);
  return token ? launch<W, false, 1, true, SRC>(a, threads, s)
               : launch<W, false, 1, false, SRC>(a, threads, s);
}

template <class W>
int dispatch(Args a, bool vec, int TT, bool token, int threads,
             cudaStream_t s) {
  return a.src ? dispatch_src<W, true>(a, vec, TT, token, threads, s)
               : dispatch_src<W, false>(a, vec, TT, token, threads, s);
}

bool aligned(long long v, long long q) { return v % q == 0; }

// Checks a call and fills `a`; returns a CUDA error (0 on success).
// `vec`: the 16-byte instance applies.
int make_args(Args& a, bool& vec, const void* x, void* out, void* mask,
              void* src, int is_bf16, int n0, int n1, long long s0, long long s1,
              long long sN, int N, int start, int T, int TT, int H, int W,
              int d, float th_t, float th_x, float th_y, int order) {
  if (n0 < 1 || n1 < 1 || d < 1 || d > 256 || H < 2 || W < 2 || H % 2 ||
      W % 2 || (TT != 1 && TT != 2) || T < TT || T % TT || order < 0 ||
      order > 5 || start < 0 || N < 1)
    return (int)cudaErrorInvalidValue;
  const long long n_grid = (long long)T * H * W;
  const long long n_lead = (long long)n0 * n1;
  if (start + n_grid > N) return (int)cudaErrorInvalidValue;
  const long long n_cubes = n_lead * (T / TT) * (H / 2) * (W / 2);
  const long long n_text = n_lead * (N - n_grid);
  if (n_cubes >= (1ll << 31) || n_text * d >= (1ll << 31) ||
      n_lead * N >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  vec = fused_reuse_vector_path(is_bf16, d, x, n0, s0, n1, s1, sN) &&
        reinterpret_cast<uintptr_t>(out) % 16 == 0 &&
        reinterpret_cast<uintptr_t>(mask) % 8 == 0 &&
        reinterpret_cast<uintptr_t>(src) % 16 == 0;
  const int V = vec ? (is_bf16 ? 8 : 4) : 1;
  a.x = x, a.out = out, a.mask = static_cast<uint8_t*>(mask);
  a.src = static_cast<int32_t*>(src), a.n_grid = (int)n_grid;
  a.s0 = s0, a.s1 = s1, a.sN = sN;
  a.n1 = n1, a.N = N, a.start = start;
  a.nG = T / TT, a.H = H, a.W = W, a.d = d, a.C = d / V;
  a.k = kThreads / a.C > 0 ? kThreads / a.C : 1;
  a.n_lead = (unsigned)n_lead, a.n_cubes = (unsigned)n_cubes;
  a.n_text = (unsigned)n_text;
  a.order = order;
  a.th[0] = th_t, a.th[1] = th_x, a.th[2] = th_y;
  a.inv_d = 1.0f / (float)d;
  return 0;
}

}  // namespace

// Does the operand take the 16-byte instance?  Channels in whole 16-byte
// chunks and every lead, token and base address on 16 bytes.
extern "C" int fused_reuse_vector_path(int is_bf16, int d, const void* x,
                                       long long n0, long long s0,
                                       long long n1, long long s1,
                                       long long sN) {
  const long long v = is_bf16 ? 8 : 4;
  return d % v == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
         (n0 == 1 || aligned(s0, v)) && (n1 == 1 || aligned(s1, v)) &&
         aligned(sN, v);
}

// x: (n0, n1, N, d), element strides (s0, s1, sN, 1), float32 (is_bf16 =
// 0) or bfloat16; tokens [start, start + T*H*W) are the grid.  out:
// (n0, n1, N, d) contiguous, same dtype; mask: the same shape, one byte
// per element; src: null, or the (n0, n1, T*H*W, d) contiguous int32
// source map of the grid tokens (grid-local token indices).  TT = 2 runs the t check on frame pairs (T even), 1 runs
// frames alone.  order is the priority permutation of (t, x, y) (0..5,
// see order_axis); an absent axis comes last with θ 0.  The thresholds
// are already rounded to the working type.  Returns the CUDA error of
// the launch (0 on success).
extern "C" int fused_reuse_launch(const void* x, void* out, void* mask,
                                  void* src, int is_bf16, int n0, int n1, long long s0,
                                  long long s1, long long sN, int N,
                                  int start, int T, int TT, int H, int W,
                                  int d, float th_t, float th_x, float th_y,
                                  int order, int token, void* stream) {
  Args a;
  bool vec = false;
  const int rc = make_args(a, vec, x, out, mask, src, is_bf16, n0, n1, s0, s1, sN,
                           N, start, T, TT, H, W, d, th_t, th_x, th_y, order);
  if (rc) return rc;
  const int threads = a.k * a.C;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? dispatch<Bf16Word>(a, vec, TT, token, threads, s)
                 : dispatch<F32Word>(a, vec, TT, token, threads, s);
}
