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
// The kernel is crf_forward.cuh's template with ALPHA; K7
// (crf_viterbi_forward.cu) is the same template with alpha and the posterior
// rows compiled out.
#include "crf_forward.cuh"

// K4: bf16 scores [T, N, 4S], the shifted bf16 beta stream [T, N, S] -> bf16
// posts. S (states) must be 64, 256 or 1024 (state_len 3, 4 or 5).
DTT_EXPORT int crf_fused_forward_bf16(const void* scores, const void* beta, void* posts,
                                      void* choices, void* final_carry, int T, int N, int S,
                                      float stay_score, void* stream) {
  return crf_forward::dispatch<__nv_bfloat16, true>(scores, beta, posts, choices, final_carry, T,
                                                    N, S, stay_score, stream);
}

// K8: float32 scores [T, N, 4S], the float32 beta history [T+1, N, S] (read
// from row 1) -> float32 posts. The same states.
DTT_EXPORT int crf_fused_forward_f32(const void* scores, const void* beta_full, void* posts,
                                     void* choices, void* final_carry, int T, int N, int S,
                                     float stay_score, void* stream) {
  const float* beta_rows = static_cast<const float*>(beta_full) + (size_t)N * S;
  return crf_forward::dispatch<float, true>(scores, beta_rows, posts, choices, final_carry, T, N,
                                            S, stay_score, stream);
}
