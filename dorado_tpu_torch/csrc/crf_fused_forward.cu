// One forward pass over the CRF scores: alpha log-sum-exp, posterior rows and
// Viterbi choices together.
//
// Replaces dorado_tpu/ops/crf_pallas.py::_fused_forward_decode_blk (Pallas
// body _fused_fwd_blk_kernel; bf16 streams, the shifted beta: K4) and
// dorado_tpu/ops/crf_pallas.py::fused_forward_decode_pallas (body
// _fused_fwd_kernel; float32 streams, the unshifted beta history: K8). One
// template serves both: K8 is its float32 instantiation, handed the beta
// history from row 1 on, so that row t of what it reads is beta[t+1]. Per
// step t, in the raw layout c = s*4 + r with predecessors
// pred(s,r) = r*(S/4) + (s>>2):
//   alpha: m = max(a); a[s] = m + log(exp(a[s]-m)*e^stay
//                                     + sum_r exp(a[pred]-m) * exp(score[s*4+r]))
//   posts[t] = softmax(a + beta_row[t]) (bf16 for K4, float32 for K8)
//   Viterbi: v -= max(v); best = max_r v[pred] + score[s*4+r] (lowest r on
//   ties); stay = v[s] + stay_score; choice = stay >= best ? 4 : r_best;
//   v[s] = max(stay, best)  (crf_viterbi.cuh, shared with K7)
// and final = v after the last step. A bf16 beta row is max-normalised
// (row j = beta[j+1] - its max) and a float32 one is not: softmax does not
// see the shift.
//
// What bounds it on the H100: a serial chain of T steps per chunk, each a
// block-wide exchange of carries, and at 1024 states the bytes as well: 3.4
// GB at sup's shape (scores and beta in, posts and choices out), 1.04 ms at
// 3.35 TB/s. The first version (one thread a state, four block-wide
// barriers a step, the score row staged in shared memory raw and
// exponentiated, exact expf, logf and an IEEE divide) took 1.610 ms at hac
// and 5.290 at sup.
//
// Design: one block a chunk row, one thread a state. Per step:
//   - one block-wide barrier. Before it each thread publishes its state's
//     carries into a buffer of the step's parity: v, and alpha as exp(alpha -
//     the last step's max) (the shift lags a step: softmax does not see it),
//     and lane 0 of each warp the warp's partials: the maxima of both, the
//     posterior row's maximum of the step before and its sum of the step
//     before that. After it lane l reads warp l's partials (l mod the warp
//     count); redux.sync gives every thread the block's maxima in one
//     instruction (floats mapped to order-preserving ints) and shuffles the
//     sum. The posterior's max and sum come one and two steps late, so
//     neither waits on the other or on the carries;
//   - the Viterbi step on the raw scores, v[p] - mv taken by the reader:
//     crf_viterbi.cuh's single f32 operations, exact;
//   - alpha: red = ea[s] * (e^stay / m) + sum_r (ea[pred] / m) * exp(score)
//     with m the published maximum, one rcp.approx a step; exp(score) by
//     ex2.approx one step ahead, off the carries' chain; the posterior
//     ex2.approx(lg2.approx(red) + beta log2e - its max) times one
//     reciprocal of the row sum;
//   - the step is one straight block: a first or last step computes what it
//     does not need and does not store it, so that the compiler interleaves
//     the posterior's reductions with the carries' chain (with each part in
//     its own branch the step took longer);
//   - the scores and beta stay in registers, eight rows ahead (four at 1024
//     states, where a thread has fewer registers). Nothing but the carries
//     and the partials goes through shared memory.
// Measured on the card and slower: several states a thread (two or four,
// which share their predecessors: fewer warps, more work each), the Viterbi
// and alpha chains on separate warps with barriers of their own, the rows
// brought in by bulk copies onto an mbarrier ring in shared memory, and bf16
// widened through __nv_bfloat162 rather than by a shift and a mask.
#include "common.cuh"
#include "crf_viterbi.cuh"

namespace {

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

}  // namespace

template <int S, typename E>
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
  using Vec4 = typename Stream<E>::Vec4;
  // (exp(alpha - the last step's max), v) of every state, by step parity
  __shared__ __align__(16) float2 carry[2][S];
  // the warps' partials by step parity: the max of exp(alpha - ..) (its
  // bits: the values are not negative), the max of v and of the posterior
  // row's log2 values (ordered), the posterior row's sum (its bits)
  __shared__ __align__(16) int4 part[2][NW];

  const int n = blockIdx.x, s = threadIdx.x, lane = s & 31, warp = s >> 5;
  const int p0 = s >> 2;  // pred(s, r) = r * S4 + p0
  const size_t srow = (size_t)N * 4 * S, row = (size_t)N * S, own = (size_t)n * S + s;
  const E* sc = scores + (size_t)n * 4 * S + 4 * s;
  const E* bt = beta + own;

  Vec4 xr[RING];  // the scores and beta of the next RING rows
  E br[RING];
#pragma unroll
  for (int u = 0; u < RING; ++u)
    if (u < T) {
      xr[u] = __ldg(reinterpret_cast<const Vec4*>(sc + (size_t)u * srow));
      br[u] = __ldg(bt + (size_t)u * row);
    }
  sc += (size_t)RING * srow;  // the next row to load
  bt += (size_t)RING * row;
  int8_t* ch_out = choices + own;
  E* post_out = posts + own;

  // ea: exp(alpha - the last step's max); v: the Viterbi carry; es: exp of
  // the next row's scores; pb: the last posterior row's log2 value (log2 ea
  // + beta log2e); ep: the row before it, ex2(pb - its max)
  float ea = 1.f, v = 0.f, pb = 0.f, ep = 0.f, es[4];
  {
    float x[4];
    Stream<E>::widen(xr[0], x);
#pragma unroll
    for (int r = 0; r < 4; ++r) es[r] = ex2(x[r] * LOG2E);
  }
  carry[0][s] = make_float2(ea, v);
  const int none = ordered(__int_as_float(0xff800000));  // the max of no value: -inf
  if (lane == 0) part[0][warp] = make_int4(__float_as_int(1.f), 0, none, 0);

  // Step t computes row t's choices and alpha (t < T), the posterior row t -
  // 1's exponentials and their sum (0 < t <= T) and row t - 2's division (t
  // >= 2). The step is one straight block: what a step does not need is
  // computed and not stored, so the compiler interleaves the chains.
  for (int t0 = 0; t0 < T + 2; t0 += RING) {
#pragma unroll
    for (int u = 0; u < RING; ++u) {
      const int t = t0 + u;
      if (t >= T + 2) break;
      const int par = t & 1;
      __syncthreads();  // the carries and partials of step t - 1 are published
      // the block's maxima after step t - 1 and the posterior row t - 1's,
      // row t - 2's sum: warp l's partials in lane l (mod the warps)
      const int4 p = part[par][lane & (NW - 1)];
      const float mv = unordered(__reduce_max_sync(FULL, p.y));
      const float pm2 = unordered(__reduce_max_sync(FULL, p.z));
      // the posterior row t - 1: the exponential and the warp's sum
      const float epn = ex2(pb - pm2);
      float ws = epn;
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

      // row t: exp(alpha - its max) of the predecessors (the published values
      // over their max), alpha, the Viterbi step
      const float scale = rcp(__int_as_float(__reduce_max_sync(FULL, p.x)));
      const float stay_scale = scale * stay_factor;
      float ed[4], vp[4], x[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float2 c = carry[par][r * S4 + p0];
        ed[r] = c.x * scale;
        vp[r] = c.y - mv;
      }
      Stream<E>::widen(xr[u], x);
      float vn = v;
      const int choice = viterbi_update(vp, v - mv, x, stay_score, vn);
      float red = ea * stay_scale;
#pragma unroll
      for (int r = 0; r < 4; ++r) red = fmaf(ed[r], es[r], red);
      pb = fmaf(Stream<E>::widen(br[u]), LOG2E, lg2(red));
      v = t < T ? vn : v;  // past the last row the final carry stays
      ea = red;
      if (t < T) {
        *ch_out = static_cast<int8_t>(choice);
        ch_out += row;
      }
      carry[par ^ 1][s] = make_float2(ea, v);
      // exp of the next row's scores, for step t + 1
      Stream<E>::widen(xr[(u + 1) % RING], x);
#pragma unroll
      for (int r = 0; r < 4; ++r) es[r] = ex2(x[r] * LOG2E);
      if (t + RING < T) {
        xr[u] = __ldg(reinterpret_cast<const Vec4*>(sc));
        br[u] = __ldg(bt);
        sc += srow;
        bt += row;
      }
      const int qa = __reduce_max_sync(FULL, __float_as_int(fmaxf(0.f, ea)));
      const int qv = __reduce_max_sync(FULL, ordered(v));
      const int qp = __reduce_max_sync(FULL, ordered(pb));
      if (lane == 0) part[par ^ 1][warp] = make_int4(qa, qv, qp, __float_as_int(ws));
    }
  }
  final_carry[own] = v;
}

namespace {

template <int S, typename E>
int launch(const void* scores, const void* beta, void* posts, void* choices, void* final_carry,
           int T, int N, float stay_score, cudaStream_t stream) {
  fused_forward_kernel<S, E><<<N, S, 0, stream>>>(
      static_cast<const E*>(scores), static_cast<const E*>(beta), static_cast<E*>(posts),
      static_cast<int8_t*>(choices), static_cast<float*>(final_carry), T, N, stay_score,
      (float)exp((double)stay_score));
  return static_cast<int>(cudaGetLastError());
}

template <typename E>
int dispatch(const void* scores, const void* beta, void* posts, void* choices, void* final_carry,
             int T, int N, int S, float stay_score, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (T <= 0 || N <= 0) return static_cast<int>(cudaErrorInvalidValue);
  switch (S) {
    case 64: return launch<64, E>(scores, beta, posts, choices, final_carry, T, N, stay_score, st);
    case 256:
      return launch<256, E>(scores, beta, posts, choices, final_carry, T, N, stay_score, st);
    case 1024:
      return launch<1024, E>(scores, beta, posts, choices, final_carry, T, N, stay_score, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// K4: bf16 scores [T, N, 4S], the shifted bf16 beta stream [T, N, S] -> bf16
// posts. S (states) must be 64, 256 or 1024 (state_len 3, 4 or 5).
DTT_EXPORT int crf_fused_forward_bf16(const void* scores, const void* beta, void* posts,
                                      void* choices, void* final_carry, int T, int N, int S,
                                      float stay_score, void* stream) {
  return dispatch<__nv_bfloat16>(scores, beta, posts, choices, final_carry, T, N, S, stay_score,
                                 stream);
}

// K8: float32 scores [T, N, 4S], the float32 beta history [T+1, N, S] (read
// from row 1) -> float32 posts. The same states.
DTT_EXPORT int crf_fused_forward_f32(const void* scores, const void* beta_full, void* posts,
                                     void* choices, void* final_carry, int T, int N, int S,
                                     float stay_score, void* stream) {
  const float* beta_rows = static_cast<const float*>(beta_full) + (size_t)N * S;
  return dispatch<float>(scores, beta_rows, posts, choices, final_carry, T, N, S, stay_score,
                         stream);
}
