// Max-plus Viterbi forward pass of the CRF lattice on float32 scores: the
// choices of every step and the final carry, for a traceback (crf_traceback.cu)
// to follow.
//
// Replaces dorado_tpu/ops/crf_pallas.py::_viterbi_fwd_pallas (Pallas body
// _viterbi_kernel; dense raw layout, 64 and 256 states: K7a) and
// dorado_tpu/ops/crf_pallas.py::_viterbi_fwd_pallas_blk (body
// _viterbi_blk_kernel; 1024 states, which the JAX package takes on the block
// layout and permutes to it first: K7b). Here both index the raw layout
// c = s*4 + r, so one template serves both. Per step t, with v the carry
// (zeros at the start):
//   v -= max(v)  (the per-step row-max normalisation of the JAX kernels)
//   best = max_r v[pred(s,r)] + score[t][s*4 + r], lowest r on ties,
//     pred(s,r) = r*(S/4) + (s>>2)
//   stay = v[s] + stay_score; choice[t][s] = stay >= best ? 4 : r_best
//   v[s] = max(stay, best)
// and final = v after the last step. The step is crf_viterbi.cuh's, the one
// the fused forward pass (crf_fused_forward.cu) runs, so the choices equal
// that kernel's bit for bit on the same score values.
//
// What bounds it on the H100: a serial chain of T steps per chunk row whose
// bytes (one read of the float32 scores, one write of the int8 choices) are
// small beside its latency. One block a chunk row and one thread a state
// keep the carry in a register; a thread's four candidates use its own 16
// bytes of the score row, loaded into registers one step ahead, so nothing
// but the normalised carry is staged in shared memory. A step is one
// block-wide max (warp shuffles, then shared memory) and two barriers.
#include "common.cuh"
#include "crf_viterbi.cuh"

template <int S>
__global__ void __launch_bounds__(S) viterbi_forward_kernel(
    const float* __restrict__ scores,  // [T, N, 4S]
    int8_t* __restrict__ choices,      // [T, N, S]
    float* __restrict__ final_carry,   // [N, S]
    int T, int N, float stay_score) {
  constexpr int NW = S / 32;
  __shared__ __align__(16) float vn[S];  // the carry minus its row max
  __shared__ float wmax[NW];

  const int n = blockIdx.x;
  const int s = threadIdx.x;
  const int warp = s >> 5, lane = s & 31;
  const size_t srow = (size_t)N * 4 * S;
  const size_t row = (size_t)N * S;
  const float* sc = scores + (size_t)n * 4 * S + 4 * s;
  const size_t own = (size_t)n * S + s;

  float4 next = *reinterpret_cast<const float4*>(sc);
  float v = 0.f;
  for (int t = 0; t < T; ++t) {
    const float x[4] = {next.x, next.y, next.z, next.w};
    if (t + 1 < T) next = *reinterpret_cast<const float4*>(sc + (size_t)(t + 1) * srow);

    const float wm = warp_max(v);
    if (lane == 0) wmax[warp] = wm;
    __syncthreads();
    float m = wmax[0];
#pragma unroll
    for (int w = 1; w < NW; ++w) m = fmaxf(m, wmax[w]);
    vn[s] = v - m;
    __syncthreads();

    float vp[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) vp[r] = vn[r * (S / 4) + (s >> 2)];
    choices[(size_t)t * row + own] =
        static_cast<int8_t>(viterbi_update(vp, vn[s], x, stay_score, v));
  }
  final_carry[own] = v;
}

template <int S>
static int launch(const float* scores, int8_t* choices, float* final_carry, int T, int N,
                  float stay_score, cudaStream_t stream) {
  viterbi_forward_kernel<S><<<N, S, 0, stream>>>(scores, choices, final_carry, T, N,
                                                 stay_score);
  return static_cast<int>(cudaGetLastError());
}

// S (states) must be 64, 256 or 1024 (state_len 3, 4 or 5).
DTT_EXPORT int crf_viterbi_forward_f32(const void* scores, void* choices, void* final_carry,
                                       int T, int N, int S, float stay_score, void* stream) {
  const float* sc = static_cast<const float*>(scores);
  int8_t* ch = static_cast<int8_t*>(choices);
  float* fc = static_cast<float*>(final_carry);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (S) {
    case 64: return launch<64>(sc, ch, fc, T, N, stay_score, st);
    case 256: return launch<256>(sc, ch, fc, T, N, stay_score, st);
    case 1024: return launch<1024>(sc, ch, fc, T, N, stay_score, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
