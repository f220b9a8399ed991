// Log-sum-exp scan of the CRF lattice on the raw score layout, forward
// (alpha) or backward (beta), with the whole float32 history written out.
//
// Replaces dorado_tpu/ops/crf_pallas.py::_lse_scan_pallas (Pallas body
// _lse_kernel) at 64 and 256 states, and at sup's 1024 the full-history
// outputs of _lse_scan_pallas_blk (bodies _lse_fwd_blk_kernel and
// _lse_bwd_blk_kernel with shifted=False), which the JAX package takes there
// on the block layout; both are reached through
// forward_scores_pallas/backward_scores_pallas.
// With carry the previous row (zeros at the start) and m its row max:
//   forward,  t = 0..T-1, hist[0] = 0, hist[t+1] = new carry:
//     new[s] = m + log(sum_r exp(carry[pred(s,r)] - m) * exp(score[t][s*4 + r])
//                      + exp(carry[s] - m) * e^stay),  pred(s,r) = r*S/4 + (s >> 2)
//   backward, j = T-1..0, hist[T] = 0, hist[j] = new carry:
//     new[s] = m + log(sum_b exp(carry[succ(s,b)] - m) * exp(score[j][succ(s,b)*4 + q(s)])
//                      + exp(carry[s] - m) * e^stay)
//     succ(s,b) = (s mod S/4)*4 + b,  q(s) = s / (S/4)
//
// Each step's log-sum-exp runs in float64 from the float32 carry and is
// rounded to the float32 carry and history: exp of the scores, exp(carry -
// m), the sums and the log, as the plain version (ops/crf_scan.py) does. The
// two then agree bit for bit but where a float64 result lies within a few
// float64 rounding errors of a float32 rounding boundary. In float32
// throughout, their different exp, log and summation orders left one float32
// step between them at values of thousands, and the beam search, which
// takes this backward history as its guide, turned such steps into a
// different path on the card than on the CPU over long stretches of a chunk
// on many inputs.
//
// The TPU kernel copies states with one-hot matrix products split into
// bf16 halves; here a thread indexes what it needs, which is exact.
// What bounds it on the H100: each direction is a serial chain of T steps
// per chunk row, and the bytes (one read of the float32 scores, one write of
// the history) are small beside it; the float64 exp and log now weigh on
// each step too. The structure is that of crf_lse_backward.cu: one block a
// chunk row, one thread a state, the carry in a register, one block max and
// two barriers a step, the next score row loaded into registers while the
// current one is consumed. A thread's four forward terms are its own 16
// bytes of the score row, so the forward direction stages only exp(carry -
// m); the backward direction also stages exp(score) in the block layout
// r*S + s, so that a thread reads its four successors' terms at once. At
// 1024 states a block is 1024 threads and the backward staging 64 KB of
// dynamic shared memory.
#include "common.cuh"

template <int S, bool REV>
__global__ void __launch_bounds__(S) lse_scan_kernel(
    const float* __restrict__ scores,  // [T, N, 4S]
    float* __restrict__ hist,          // [T+1, N, S]
    int T, int N, double stay_factor) {
  constexpr int S4 = S / 4;
  constexpr int NW = S / 32;
  extern __shared__ __align__(16) double smem_d[];
  double* es = smem_d;                          // [2][4S] exp(score), backward only
  double* ec = smem_d + (REV ? 2 * 4 * S : 0);  // [S] exp(carry - m)
  float* wmax = reinterpret_cast<float*>(ec + S);

  const int n = blockIdx.x;
  const int s = threadIdx.x;
  const int warp = s >> 5, lane = s & 31;
  const size_t row = (size_t)N * 4 * S;
  const size_t hrow = (size_t)N * S;
  const float* sc = scores + (size_t)n * 4 * S + 4 * s;
  float* out = hist + (size_t)n * S + s;
  const int q = s / S4;
  const int succ0 = (s % S4) * 4;
  const int pred0 = s >> 2;

  out[(REV ? (size_t)T : 0) * hrow] = 0.f;
  float4 next = *reinterpret_cast<const float4*>(sc + (size_t)(REV ? T - 1 : 0) * row);
  float carry = 0.f;
  for (int i = 0; i < T; ++i) {
    const int t = REV ? T - 1 - i : i;
    const float4 cur = next;
    if (i + 1 < T)
      next = *reinterpret_cast<const float4*>(sc + (size_t)(REV ? t - 1 : t + 1) * row);
    const double x0 = exp((double)cur.x), x1 = exp((double)cur.y), x2 = exp((double)cur.z),
                 x3 = exp((double)cur.w);
    double* e = es + (REV ? (i & 1) * 4 * S : 0);
    if (REV) {
      e[0 * S + s] = x0; e[1 * S + s] = x1; e[2 * S + s] = x2; e[3 * S + s] = x3;
    }

    const float wm = warp_max(carry);
    if (lane == 0) wmax[warp] = wm;
    __syncthreads();
    float m = wmax[0];
#pragma unroll
    for (int w = 1; w < NW; ++w) m = fmaxf(m, wmax[w]);
    const double own = exp((double)carry - (double)m);
    ec[s] = own;
    __syncthreads();

    double red;
    if (REV) {
      const double* eq = e + q * S + succ0;
      red = ec[succ0] * eq[0] + ec[succ0 + 1] * eq[1] + ec[succ0 + 2] * eq[2] +
            ec[succ0 + 3] * eq[3];
    } else {
      red = ec[pred0] * x0 + ec[S4 + pred0] * x1 + ec[2 * S4 + pred0] * x2 +
            ec[3 * S4 + pred0] * x3;
    }
    carry = (float)((double)m + log(red + own * stay_factor));
    out[(size_t)(REV ? t : t + 1) * hrow] = carry;
  }
}

template <int S>
static int launch(const float* scores, float* hist, int T, int N, int reverse,
                  double stay_factor, cudaStream_t stream) {
  const int smem = (int)sizeof(double) * ((reverse ? 2 * 4 * S : 0) + S) + (S / 32) * 4;
  if (reverse) {
    cudaError_t e = cudaFuncSetAttribute(lse_scan_kernel<S, true>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    lse_scan_kernel<S, true><<<N, S, smem, stream>>>(scores, hist, T, N, stay_factor);
  } else {
    lse_scan_kernel<S, false><<<N, S, smem, stream>>>(scores, hist, T, N, stay_factor);
  }
  return static_cast<int>(cudaGetLastError());
}

// S (states) must be 64, 256 or 1024 (state_len 3, 4 or 5).
DTT_EXPORT int crf_lse_scan_f32(const void* scores, void* hist, int T, int N, int S,
                                int reverse, double stay_factor, void* stream) {
  const float* sc = static_cast<const float*>(scores);
  float* h = static_cast<float*>(hist);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (S) {
    case 64: return launch<64>(sc, h, T, N, reverse, stay_factor, st);
    case 256: return launch<256>(sc, h, T, N, reverse, stay_factor, st);
    case 1024: return launch<1024>(sc, h, T, N, reverse, stay_factor, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
