// Log-sum-exp scans of the CRF lattice on the raw score layout, forward
// (alpha) and backward (beta), with the whole float32 history written out,
// both directions in one launch.
//
// Replaces dorado_tpu/ops/crf_pallas.py::_lse_scan_pallas (Pallas body
// _lse_kernel) at 64 and 256 states, and at sup's 1024 the full-history
// outputs of _lse_scan_pallas_blk (bodies _lse_fwd_blk_kernel and
// _lse_bwd_blk_kernel with shifted=False), which the JAX package takes there
// on the block layout; both are reached through
// forward_scores_pallas/backward_scores_pallas.
// With carry the previous row (zeros at the start) and K any shift:
//   forward,  t = 0..T-1, hist[0] = 0, hist[t+1] = new carry:
//     new[s] = K + log(sum_r exp(carry[pred(s,r)] - K) * exp(score[t][s*4 + r])
//                      + exp(carry[s] - K) * e^stay),  pred(s,r) = r*S/4 + (s >> 2)
//   backward, j = T-1..0, hist[T] = 0, hist[j] = new carry:
//     new[s] = K + log(sum_b exp(carry[succ(s,b)] - K) * exp(score[j][succ(s,b)*4 + q(s)])
//                      + exp(carry[s] - K) * e^stay)
//     succ(s,b) = (s mod S/4)*4 + b,  q(s) = s / (S/4)
//
// Each step's log-sum-exp runs in float64 from the float32 carry and is
// rounded to the float32 carry and history, as the plain version
// (ops/crf_scan.py) does with K the carry's row maximum. The two then agree
// bit for bit but where a float64 result lies within a few float64 rounding
// errors of a float32 rounding boundary. In float32 throughout, their
// different exp, log and summation orders left one float32 step between them
// at values of thousands, and the beam search, which takes this backward
// history as its guide, turned such steps into a different path on the card
// than on the CPU over long stretches of a chunk on many inputs.
//
// The TPU kernel copies states with one-hot matrix products split into
// bf16 halves; here a thread indexes what it needs, which is exact.
// What bounds it on the H100: each direction is a serial chain of T steps
// per chunk row; a step's float64 work is four exps of the scores, one exp
// of the carry, one log and five FMAs a state (the float64 units do 64 FMAs
// a clock on an SM), and its bytes are one read of the float32 scores and one
// write of the history (1.60 ms a direction at sup's shape, 3.35 TB/s). The
// first version (one thread a state, two barriers a step, a shuffle and
// shared-memory maximum on the chain, the backward direction's exp(score)
// staged in shared memory, 64 KB a step at 1024 states, the two directions
// in two launches) took 1.375 and 1.597 ms at hac and 4.065 and 4.985 at sup
// (NVIDIA H100 80GB HBM3, 700 W).
//
// Design: one block a chunk row and direction, one thread a state, both
// directions in one launch (blockIdx.y), so that at 64 and 256 states a
// forward and a backward block share an SM and hide each other's latency.
// A step has one barrier: before it each thread publishes exp(carry - K) in
// float64 with K the previous carry's maximum, and lane 0 of each warp the
// warp's maximum of the carry (redux.sync on order-preserving ints, exact);
// after it each thread gathers its four terms and takes the log, while the
// carry's maximum m is reduced off that chain; the new carry is m + (log +
// (K - m)), rounded, which is the plain version's float64 value to its last
// bits. The scores' float64 exps are taken a step ahead from a register
// ring of raw rows (eight rows, four at 1024 states), off the chain: the
// forward direction reads a thread's own 16 bytes of the row; the backward
// direction gives thread i state (i / 4) + (i % 4) S/4, so that the four
// threads of a quad read the 16 contiguous scores of their common
// successors. Only the carries' exponentials and the warps' maxima go
// through shared memory (the backward direction's by state with 4 doubles
// of padding after each quarter: stores and the quads' 32-byte loads free of
// bank conflicts). The float64 exp and log are the table-driven ones below
// (12 and 14 float64 operations where CUDA's take 17 and 30), accurate to
// about 2 ulp, which leaves the float32 history bit for bit equal to the
// plain version's on every input tried. Both directions in one launch: at
// 64 and 256 states two blocks share an SM (1.50 ms for the pair at hac,
// against 0.83 + 1.12 alone); at 1024 states a block is 1024 threads and an
// SM holds one, so the pair is about the sum of the two (6.26 ms at sup).
// Per state and step the float64 work is 149 operations (a DFMA two, a DADD
// or DMUL one: five exps of 10 DFMA, 1 DADD and 1 DMUL; a log of 12 DFMA, 1
// DMUL and 1 DADD; the sum's four FMAs, the stay's multiply and four adds),
// at 34 TFLOP/s 2.4 ms for the pair at sup's shape, more than its 1.9 ms of
// bytes.
// Measured on the card and slower (NVIDIA H100 80GB HBM3, 700 W, the pair at
// hac and sup): CUDA's exp and log (1.83 and 6.79 ms); two states a thread at
// 1024 states, so that a forward and a backward block of 512 threads share
// an SM (6.96 ms with CUDA's exp and log, against 6.90: its 64 registers a
// thread lose more than the overlap wins); the backward direction's scores
// by one 16-byte load a thread and a quad transpose by four shuffles (1.67
// and 7.22 ms against 1.58 and 6.90), which won for the bf16 scores of
// crf_lse_backward.cu.
#include "common.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;

// Tables of 16 doubles in shared memory (each in its own pair of banks, so
// that a warp's lookups never conflict): 2^(j/16) for exp; 1/c_j and
// -log(1/c_j), c_j = 1 + (j + 1/2)/16, for log.
struct Tables {
  double exp2[16], inv[16], logc[16];
};

__device__ __forceinline__ void fill_tables(Tables& tab) {
  if (threadIdx.x < 16) {
    const int j = threadIdx.x;
    tab.exp2[j] = exp2(j / 16.0);
    const double inv = 1.0 / (1.0 + (j + 0.5) / 16.0);
    tab.inv[j] = inv;
    tab.logc[j] = -log(inv);
  }
}

// exp(x) in float64 to about 2 ulp, for |x| <= 708: x = (16 q + j) ln2/16 + r
// with |r| <= ln2/32, exp(r) by its Taylor series to r^7 (the rest is under
// 2e-18 relative), times 2^(j/16) from the table, times 2^q into the exponent
// field. 12 float64 operations where CUDA's exp takes 17. Below -708 (a state
// more than 708 nats below the carry's maximum, which no score range reaches)
// it gives exp(-708).
__device__ __forceinline__ double exp_f64(double x, const Tables& tab) {
  constexpr double INV_L = 23.083120654223414;  // 16 / ln 2
  constexpr double L_HI = 6.93147180369123816490e-01 / 16, L_LO = 1.90821492927058770002e-10 / 16;
  constexpr double MAGIC = 6755399441055744.0;  // 1.5 * 2^52: rounds to an integer
  x = fmin(fmax(x, -708.0), 708.0);
  const double t = fma(x, INV_L, MAGIC);
  const double k = t - MAGIC;
  const int ki = __double2loint(t);
  double r = fma(k, -L_HI, x);
  r = fma(k, -L_LO, r);
  double p = fma(r, 1.0 / 5040, 1.0 / 720);
  p = fma(p, r, 1.0 / 120);
  p = fma(p, r, 1.0 / 24);
  p = fma(p, r, 1.0 / 6);
  p = fma(p, r, 0.5);
  p = fma(p, r, 1.0);
  p = fma(p, r, 1.0);
  const double y = p * tab.exp2[ki & 15];
  return __hiloint2double(__double2hiint(y) + ((ki >> 4) << 20), __double2loint(y));
}

// log(x) in float64 to about 2 ulp, for x > 0 (clamped to the smallest
// normal): x = 2^e m, m in [1, 2); with j the top four bits of m's fraction,
// r = m / c_j - 1 (|r| <= 1/32) and log(x) = e ln 2 + log(c_j) + log1p(r),
// log1p(r) by its series to r^10 (the rest is under 3e-18). 14 float64
// operations where CUDA's log takes 30.
__device__ __forceinline__ double log_f64(double x, const Tables& tab) {
  constexpr double LN2_HI = 6.93147180369123816490e-01, LN2_LO = 1.90821492927058770002e-10;
  x = fmax(x, 2.2250738585072014e-308);
  const int hi = __double2hiint(x);
  const int j = (hi >> 16) & 15;
  const double m = __hiloint2double((hi & 0x000fffff) | 0x3ff00000, __double2loint(x));
  const double r = fma(m, tab.inv[j], -1.0);
  double p = fma(r, -1.0 / 10, 1.0 / 9);
  p = fma(p, r, -1.0 / 8);
  p = fma(p, r, 1.0 / 7);
  p = fma(p, r, -1.0 / 6);
  p = fma(p, r, 1.0 / 5);
  p = fma(p, r, -1.0 / 4);
  p = fma(p, r, 1.0 / 3);
  p = fma(p, r, -0.5);
  const double log1p_r = fma(p, r * r, r);
  const double e = (double)((hi >> 20) - 1023);
  return fma(e, LN2_HI, tab.logc[j]) + fma(e, LN2_LO, log1p_r);
}

template <int S, bool REV>
__device__ __forceinline__ void scan(const float* __restrict__ scores,  // [T, N, 4S]
                                     float* __restrict__ hist,          // [T+1, N, S]
                                     int T, int N, double stay_factor,
                                     double (&ec)[2][S + 16], int (&part)[2][S / 32],
                                     const Tables& tab) {
  constexpr int S4 = S / 4, NW = S / 32;
  constexpr int RING = S < 1024 ? 8 : 4;
  const int n = blockIdx.x, i = threadIdx.x, lane = i & 31, warp = i >> 5;
  // forward: thread i is state i; backward: state g + k S/4 (g = i / 4, k =
  // i % 4), so that the four threads of a quad share their successors
  const int g = i >> 2, k = i & 3;
  const int s = REV ? g + k * S4 : i;
  const int own = REV ? s + 4 * k : s;        // this state's slot
  const int succ = 4 * g + 4 * (4 * g / S4);  // backward: succ(s, 0)'s slot
  const size_t srow = (size_t)N * 4 * S, hrow = (size_t)N * S;
  const float* sc = scores + (size_t)n * 4 * S + (REV ? 16 * g + k : 4 * i);
  float* out = hist + (size_t)n * S + s;
  auto row_of = [&](int step) { return REV ? T - 1 - step : step; };
  auto load = [&](int step) {
    const float* p = sc + (size_t)row_of(step) * srow;
    return REV ? make_float4(__ldg(p), __ldg(p + 4), __ldg(p + 8), __ldg(p + 12))
               : __ldg(reinterpret_cast<const float4*>(p));
  };

  float4 xr[RING];  // the raw scores of the next RING steps' rows
#pragma unroll
  for (int u = 0; u < RING; ++u)
    if (u < T) xr[u] = load(u);
  out[(REV ? (size_t)T : 0) * hrow] = 0.f;

  // c: the carry; K: the shift of its published exponential e
  float c = 0.f, K = 0.f;
  double e = 1.0, es[4] = {exp_f64(xr[0].x, tab), exp_f64(xr[0].y, tab), exp_f64(xr[0].z, tab),
                           exp_f64(xr[0].w, tab)};
  ec[0][own] = 1.0;
  if (lane == 0) part[0][warp] = ordered(0.f);

  for (int i0 = 0; i0 < T; i0 += RING) {
#pragma unroll
    for (int u = 0; u < RING; ++u) {
      const int step = i0 + u;
      if (step >= T) break;
      const int par = step & 1;
      __syncthreads();  // the exponentials and maxima of step - 1 are published
      const float m = unordered(__reduce_max_sync(FULL, part[par][lane & (NW - 1)]));
      double red = e * stay_factor;
      if (REV) {
        const double2 a = *reinterpret_cast<const double2*>(&ec[par][succ]);
        const double2 b = *reinterpret_cast<const double2*>(&ec[par][succ + 2]);
        red = fma(a.x, es[0], red);
        red = fma(a.y, es[1], red);
        red = fma(b.x, es[2], red);
        red = fma(b.y, es[3], red);
      } else {
#pragma unroll
        for (int r = 0; r < 4; ++r) red = fma(ec[par][r * S4 + (i >> 2)], es[r], red);
      }
      // m + log(sum exp(. - m) ...) as the plain version takes it: red is that
      // sum times exp(m - K), and K - m is exact, so the float64 result is the
      // plain version's but for its last bits, far below the float32 rounding
      c = (float)((double)m + (log_f64(red, tab) + ((double)K - (double)m)));
      out[(size_t)(REV ? row_of(step) : step + 1) * hrow] = c;
      K = m;
      e = exp_f64((double)c - (double)K, tab);
      ec[par ^ 1][own] = e;
      const int q = __reduce_max_sync(FULL, ordered(c));
      if (lane == 0) part[par ^ 1][warp] = q;
      const float4 x = xr[(u + 1) % RING];
      es[0] = exp_f64(x.x, tab);
      es[1] = exp_f64(x.y, tab);
      es[2] = exp_f64(x.z, tab);
      es[3] = exp_f64(x.w, tab);
      if (step + RING < T) xr[u] = load(step + RING);
    }
  }
}

}  // namespace

// blockIdx.y: 0 the forward scan into alpha, 1 the backward scan into beta
template <int S>
__global__ void __launch_bounds__(S) lse_scans_kernel(const float* __restrict__ scores,
                                                      float* __restrict__ alpha,
                                                      float* __restrict__ beta, int T, int N,
                                                      double stay_factor) {
  __shared__ __align__(16) double ec[2][S + 16];
  __shared__ int part[2][S / 32];
  __shared__ Tables tab;
  fill_tables(tab);
  __syncthreads();
  if (blockIdx.y == 0)
    scan<S, false>(scores, alpha, T, N, stay_factor, ec, part, tab);
  else
    scan<S, true>(scores, beta, T, N, stay_factor, ec, part, tab);
}

// Both directions in one launch: float32 scores [T, N, 4S] -> alpha and
// beta [T+1, N, S]. S (states) must be 64, 256 or 1024 (state_len 3, 4 or 5).
DTT_EXPORT int crf_lse_scans_f32(const void* scores, void* alpha, void* beta, int T, int N, int S,
                                 double stay_factor, void* stream) {
  const float* sc = static_cast<const float*>(scores);
  float* a = static_cast<float*>(alpha);
  float* b = static_cast<float*>(beta);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (T <= 0 || N <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(N, 2);
  switch (S) {
    case 64: lse_scans_kernel<64><<<grid, 64, 0, st>>>(sc, a, b, T, N, stay_factor); break;
    case 256: lse_scans_kernel<256><<<grid, 256, 0, st>>>(sc, a, b, T, N, stay_factor); break;
    case 1024: lse_scans_kernel<1024><<<grid, 1024, 0, st>>>(sc, a, b, T, N, stay_factor); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
