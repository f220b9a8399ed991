// The Viterbi max-plus step of one state, in the forward pass's template
// (crf_forward.cuh) that the fused forward pass (crf_fused_forward.cu) and the
// standalone Viterbi forward pass (crf_viterbi_forward.cu) instantiate, so
// that the two give the same choices bit for bit on the same score values.
#pragma once

// vp: the normalised carry (the carry minus its row max) of the state's four
// predecessors pred(s,r) = r*(S/4) + (s>>2), r = 0..3; vs: the state's own
// normalised carry; x: its four scores score[s*4 + r]; v: its carry,
// replaced by the new one. The lowest r wins a tie, and the stay wins a tie
// with the best step. Every add is a single f32 operation, in the order of
// the plain version (crf_scan.viterbi_step). Returns the choice: the
// predecessor slot r, or 4 for a stay.
__device__ __forceinline__ int viterbi_update(const float (&vp)[4], float vs,
                                              const float (&x)[4], float stay_score,
                                              float& v) {
  float best = vp[0] + x[0];
  int best_r = 0;
#pragma unroll
  for (int r = 1; r < 4; ++r) {
    const float cand = vp[r] + x[r];
    if (cand > best) {
      best = cand;
      best_r = r;
    }
  }
  const float stay = vs + stay_score;
  const bool is_stay = stay >= best;
  v = is_stay ? stay : best;
  return is_stay ? 4 : best_r;
}
