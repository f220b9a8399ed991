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
// The TPU kernel copies states with one-hot matrix products split into
// bf16 halves; here a thread indexes what it needs, which is exact.
// What bounds it on the H100: each direction is a serial chain of T steps
// per chunk row, and the bytes (one read of the float32 scores, one write of
// the history) are small beside it. The structure is that of
// crf_lse_backward.cu: one block a chunk row, one thread a state, the carry
// in a register, one block max and two barriers a step, the next score row
// loaded into registers while the current one is consumed. A thread's four
// forward terms are its own 16 bytes of the score row, so the forward
// direction stages only exp(carry - m); the backward direction also stages
// exp(score) in the block layout r*S + s, so that a thread reads its four
// successors' terms as one 16-byte vector. At 1024 states a block is 1024
// threads and the backward staging 32 KB (36 KB of static shared memory in
// all, under the 48 KB a block may declare statically).
#include "common.cuh"

template <int S, bool REV>
__global__ void __launch_bounds__(S) lse_scan_kernel(
    const float* __restrict__ scores,  // [T, N, 4S]
    float* __restrict__ hist,          // [T+1, N, S]
    int T, int N, float stay_factor) {
  constexpr int S4 = S / 4;
  constexpr int NW = S / 32;
  __shared__ __align__(16) float es[REV ? 2 : 1][REV ? 4 * S : 4];
  __shared__ __align__(16) float ec[S];  // exp(carry - m)
  __shared__ float wmax[NW];

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
    float4 x;
    x.x = expf(cur.x); x.y = expf(cur.y); x.z = expf(cur.z); x.w = expf(cur.w);
    float* e = es[REV ? (i & 1) : 0];
    if (REV) {
      e[0 * S + s] = x.x; e[1 * S + s] = x.y; e[2 * S + s] = x.z; e[3 * S + s] = x.w;
    }

    const float wm = warp_max(carry);
    if (lane == 0) wmax[warp] = wm;
    __syncthreads();
    float m = wmax[0];
#pragma unroll
    for (int w = 1; w < NW; ++w) m = fmaxf(m, wmax[w]);
    const float own = expf(carry - m);
    ec[s] = own;
    __syncthreads();

    float red;
    if (REV) {
      const float4 b = *reinterpret_cast<const float4*>(&ec[succ0]);
      x = *reinterpret_cast<const float4*>(&e[q * S + succ0]);
      red = b.x * x.x + b.y * x.y + b.z * x.z + b.w * x.w;
    } else {
      red = ec[pred0] * x.x + ec[S4 + pred0] * x.y + ec[2 * S4 + pred0] * x.z +
            ec[3 * S4 + pred0] * x.w;
    }
    carry = m + logf(red + own * stay_factor);
    out[(size_t)(REV ? t : t + 1) * hrow] = carry;
  }
}

template <int S>
static int launch(const float* scores, float* hist, int T, int N, int reverse,
                  float stay_factor, cudaStream_t stream) {
  if (reverse)
    lse_scan_kernel<S, true><<<N, S, 0, stream>>>(scores, hist, T, N, stay_factor);
  else
    lse_scan_kernel<S, false><<<N, S, 0, stream>>>(scores, hist, T, N, stay_factor);
  return static_cast<int>(cudaGetLastError());
}

// S (states) must be 64, 256 or 1024 (state_len 3, 4 or 5).
DTT_EXPORT int crf_lse_scan_f32(const void* scores, void* hist, int T, int N, int S,
                                int reverse, float stay_factor, void* stream) {
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
