// Max-plus Viterbi forward pass of the CRF lattice on float32 scores: the
// choices of every step and the final carry, for a traceback (crf_traceback.cu)
// to follow.
//
// Replaces dorado_tpu/ops/crf_pallas.py::_viterbi_fwd_pallas (Pallas body
// _viterbi_kernel; dense raw layout, 64 and 256 states: K7a) and
// dorado_tpu/ops/crf_pallas.py::_viterbi_fwd_pallas_blk (body
// _viterbi_blk_kernel; 1024 states, which the JAX package takes on the block
// layout and permutes to it first: K7b). Here both index the raw layout
// c = s*4 + r, so one kernel serves both. Per step t, with v the carry
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
// What bounds it on the H100: a serial chain of T steps per chunk row, each
// a block-wide maximum of the carries, and the bytes: one read of the
// float32 scores and one write of the int8 choices, 0.93 GB at hac's shape
// (T = 1666, N = 128, S = 256; 0.277 ms at 3.35 TB/s) and 4.56 GB at sup's
// (T = 2048, S = 1024; 1.36 ms). The first version had two block-wide
// barriers a step, the warp maxima combined through shared memory and one
// row of scores loaded ahead: 0.870 ms at hac and 2.058 at sup.
//
// Design: K4's (crf_fused_forward.cu's note), as the third instantiation of
// its template (crf_forward.cuh) with alpha and the posterior rows compiled
// out: one block a chunk row and one thread a state; one block-wide barrier a
// step, before which each thread publishes its carry into a buffer of the
// step's parity and lane 0 of each warp the warp's maximum as an
// order-preserving int (redux.sync); after it lane l reads warp l's maximum
// and one more redux.sync gives every thread the block's; the reader takes
// v[pred] - max itself. The float4 score rows stay in a register ring eight
// rows ahead (four at 1024 states). With K4's template the Viterbi step and
// its store are those of K4's code, so K7's choices are K4's by
// construction, not by a second copy kept equal.
#include "crf_forward.cuh"

// S (states) must be 64, 256 or 1024 (state_len 3, 4 or 5).
DTT_EXPORT int crf_viterbi_forward_f32(const void* scores, void* choices, void* final_carry,
                                       int T, int N, int S, float stay_score, void* stream) {
  return crf_forward::dispatch<float, false>(scores, nullptr, nullptr, choices, final_carry, T, N,
                                             S, stay_score, stream);
}
