// The forward pass over the CRF scores in the raw layout, one block a chunk
// row, one thread a state, one block-wide barrier a step: the template of K4
// and K8 (crf_fused_forward.cu: alpha, the posterior rows and the Viterbi
// choices, ALPHA) and of K7 (crf_viterbi_forward.cu: the Viterbi choices
// alone, with alpha and the posteriors compiled out). Its design note is
// crf_fused_forward.cu's.
#pragma once

#include <type_traits>

#include "common.cuh"
#include "crf_viterbi.cuh"

namespace crf_forward {

constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned FULL = 0xffffffffu;

// A stream element type: its four-value row vector (loaded as one 8- or
// 16-byte access) and the conversions to and from float32.
template <typename T>
struct Stream;

template <>
struct Stream<__nv_bfloat16> {
  using Vec4 = uint2;
  // a bf16 is the high half of its float32
  static __device__ __forceinline__ void widen(Vec4 v, float x[4]) {
    x[0] = __uint_as_float(v.x << 16);
    x[1] = __uint_as_float(v.x & 0xffff0000u);
    x[2] = __uint_as_float(v.y << 16);
    x[3] = __uint_as_float(v.y & 0xffff0000u);
  }
  static __device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }
  static __device__ __forceinline__ __nv_bfloat16 narrow(float v) { return __float2bfloat16(v); }
};

template <>
struct Stream<float> {
  using Vec4 = float4;
  static __device__ __forceinline__ void widen(Vec4 v, float x[4]) {
    x[0] = v.x;
    x[1] = v.y;
    x[2] = v.z;
    x[3] = v.w;
  }
  static __device__ __forceinline__ float widen(float v) { return v; }
  static __device__ __forceinline__ float narrow(float v) { return v; }
};

// The Viterbi carry of a published (exp(alpha - ..), v) pair or of v alone,
// and the block's maximum of v among a warp's published partials.
__device__ __forceinline__ float carry_v(float2 c) { return c.y; }
__device__ __forceinline__ float carry_v(float c) { return c; }
__device__ __forceinline__ int part_v(int4 p) { return p.y; }
__device__ __forceinline__ int part_v(int p) { return p; }

// ALPHA: K4 and K8 (beta and posts are read and written); without it, K7
// (beta and posts are not touched).
template <int S, typename E, bool ALPHA>
__global__ void __launch_bounds__(S) fused_forward_kernel(
    const E* __restrict__ scores,      // [T, N, 4S]
    const E* __restrict__ beta,        // [T, N, S]: row t is beta[t+1] (bf16: minus its max)
    E* __restrict__ posts,             // [T, N, S]
    int8_t* __restrict__ choices,      // [T, N, S]
    float* __restrict__ final_carry,   // [N, S]
    int T, int N, float stay_score, float stay_factor) {
  constexpr int NW = S / 32, S4 = S / 4;
  // rows of scores and beta in flight, in registers: eight where a block has
  // up to 256 threads, four at 1024 (measured on the card)
  constexpr int RING = S < 1024 ? 8 : 4;
  // the posterior rows come one and two steps late: two steps past the last
  constexpr int TAIL = ALPHA ? 2 : 0;
  using Vec4 = typename Stream<E>::Vec4;
  // the carries by step parity: (exp(alpha - the last step's max), v) of
  // every state, or v alone
  using Carry = std::conditional_t<ALPHA, float2, float>;
  __shared__ __align__(16) Carry carry[2][S];
  // the warps' partials by step parity: the max of exp(alpha - ..) (its
  // bits: the values are not negative), the max of v and of the posterior
  // row's log2 values (ordered), the posterior row's sum (its bits); or the
  // max of v alone
  using Part = std::conditional_t<ALPHA, int4, int>;
  __shared__ __align__(16) Part part[2][NW];

  const int n = blockIdx.x, s = threadIdx.x, lane = s & 31, warp = s >> 5;
  const int p0 = s >> 2;  // pred(s, r) = r * S4 + p0
  const size_t srow = (size_t)N * 4 * S, row = (size_t)N * S, own = (size_t)n * S + s;
  const E* sc = scores + (size_t)n * 4 * S + 4 * s;
  const E* bt = ALPHA ? beta + own : nullptr;

  Vec4 xr[RING];  // the scores and beta of the next RING rows
  E br[RING];
#pragma unroll
  for (int u = 0; u < RING; ++u)
    if (u < T) {
      xr[u] = __ldg(reinterpret_cast<const Vec4*>(sc + (size_t)u * srow));
      if constexpr (ALPHA) br[u] = __ldg(bt + (size_t)u * row);
    }
  sc += (size_t)RING * srow;  // the next row to load
  if constexpr (ALPHA) bt += (size_t)RING * row;
  int8_t* ch_out = choices + own;
  E* post_out = ALPHA ? posts + own : nullptr;

  // ea: exp(alpha - the last step's max); v: the Viterbi carry; es: exp of
  // the next row's scores; pb: the last posterior row's log2 value (log2 ea
  // + beta log2e); ep: the row before it, ex2(pb - its max)
  float ea = 1.f, v = 0.f, pb = 0.f, ep = 0.f, es[4];
  if constexpr (ALPHA) {
    const int none = ordered(__int_as_float(0xff800000));  // the max of no value: -inf
    float x[4];
    Stream<E>::widen(xr[0], x);
#pragma unroll
    for (int r = 0; r < 4; ++r) es[r] = ex2(x[r] * LOG2E);
    carry[0][s] = make_float2(ea, v);
    if (lane == 0) part[0][warp] = make_int4(__float_as_int(1.f), 0, none, 0);
  } else {
    carry[0][s] = v;
    if (lane == 0) part[0][warp] = 0;  // ordered(0.f)
  }

  // Step t computes row t's choices and alpha (t < T), the posterior row t -
  // 1's exponentials and their sum (0 < t <= T) and row t - 2's division (t
  // >= 2). The step is one straight block: what a step does not need is
  // computed and not stored, so the compiler interleaves the chains.
  for (int t0 = 0; t0 < T + TAIL; t0 += RING) {
#pragma unroll
    for (int u = 0; u < RING; ++u) {
      const int t = t0 + u;
      if (t >= T + TAIL) break;
      const int par = t & 1;
      __syncthreads();  // the carries and partials of step t - 1 are published
      // the block's maxima after step t - 1 and the posterior row t - 1's,
      // row t - 2's sum: warp l's partials in lane l (mod the warps)
      const Part p = part[par][lane & (NW - 1)];
      const float mv = unordered(__reduce_max_sync(FULL, part_v(p)));
      float ws = 0.f, scale = 0.f, stay_scale = 0.f;
      if constexpr (ALPHA) {
        const float pm2 = unordered(__reduce_max_sync(FULL, p.z));
        // the posterior row t - 1: the exponential and the warp's sum
        const float epn = ex2(pb - pm2);
        ws = epn;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) ws += __shfl_xor_sync(FULL, ws, o);
        // the posterior row t - 2: the division
        float total = __int_as_float(p.w);
#pragma unroll
        for (int o = 1; o < NW; o <<= 1) total += __shfl_xor_sync(FULL, total, o);
        const E post = Stream<E>::narrow(ep * rcp(total));
        ep = epn;
        if (t >= 2) {
          *post_out = post;
          post_out += row;
        }
        scale = rcp(__int_as_float(__reduce_max_sync(FULL, p.x)));
        stay_scale = scale * stay_factor;
      }

      // row t: exp(alpha - its max) of the predecessors (the published values
      // over their max), alpha, the Viterbi step
      float ed[4], vp[4], x[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const Carry c = carry[par][r * S4 + p0];
        if constexpr (ALPHA) ed[r] = c.x * scale;
        vp[r] = carry_v(c) - mv;
      }
      Stream<E>::widen(xr[u], x);
      float vn = v;
      const int choice = viterbi_update(vp, v - mv, x, stay_score, vn);
      if constexpr (ALPHA) {
        float red = ea * stay_scale;
#pragma unroll
        for (int r = 0; r < 4; ++r) red = fmaf(ed[r], es[r], red);
        pb = fmaf(Stream<E>::widen(br[u]), LOG2E, lg2(red));
        ea = red;
      }
      v = t < T ? vn : v;  // past the last row the final carry stays
      if (t < T) {
        *ch_out = static_cast<int8_t>(choice);
        ch_out += row;
      }
      if constexpr (ALPHA) {
        carry[par ^ 1][s] = make_float2(ea, v);
        // exp of the next row's scores, for step t + 1
        Stream<E>::widen(xr[(u + 1) % RING], x);
#pragma unroll
        for (int r = 0; r < 4; ++r) es[r] = ex2(x[r] * LOG2E);
      } else {
        carry[par ^ 1][s] = v;
      }
      if (t + RING < T) {
        xr[u] = __ldg(reinterpret_cast<const Vec4*>(sc));
        sc += srow;
        if constexpr (ALPHA) {
          br[u] = __ldg(bt);
          bt += row;
        }
      }
      const int qv = __reduce_max_sync(FULL, ordered(v));
      if constexpr (ALPHA) {
        const int qa = __reduce_max_sync(FULL, __float_as_int(fmaxf(0.f, ea)));
        const int qp = __reduce_max_sync(FULL, ordered(pb));
        if (lane == 0) part[par ^ 1][warp] = make_int4(qa, qv, qp, __float_as_int(ws));
      } else {
        if (lane == 0) part[par ^ 1][warp] = qv;
      }
    }
  }
  final_carry[own] = v;
}

template <int S, typename E, bool ALPHA>
int launch(const void* scores, const void* beta, void* posts, void* choices, void* final_carry,
           int T, int N, float stay_score, cudaStream_t stream) {
  fused_forward_kernel<S, E, ALPHA><<<N, S, 0, stream>>>(
      static_cast<const E*>(scores), static_cast<const E*>(beta), static_cast<E*>(posts),
      static_cast<int8_t*>(choices), static_cast<float*>(final_carry), T, N, stay_score,
      (float)exp((double)stay_score));
  return static_cast<int>(cudaGetLastError());
}

// S (states) must be 64, 256 or 1024 (state_len 3, 4 or 5).
template <typename E, bool ALPHA>
int dispatch(const void* scores, const void* beta, void* posts, void* choices, void* final_carry,
             int T, int N, int S, float stay_score, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (T <= 0 || N <= 0) return static_cast<int>(cudaErrorInvalidValue);
  switch (S) {
    case 64:
      return launch<64, E, ALPHA>(scores, beta, posts, choices, final_carry, T, N, stay_score, st);
    case 256:
      return launch<256, E, ALPHA>(scores, beta, posts, choices, final_carry, T, N, stay_score, st);
    case 1024:
      return launch<1024, E, ALPHA>(scores, beta, posts, choices, final_carry, T, N, stay_score,
                                    st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace crf_forward
