// Viterbi traceback over the per-step choices of the fused forward kernel.
//
// Replaces dorado_tpu/ops/crf_pallas.py::viterbi_traceback_pallas (Pallas
// body _traceback_body). Per chunk row, walking t from T-1 down to 0 from
// the state last[n]:
//   states[t] = s; ch = choices[t][s]; moves[t] = ch != 4;
//   s = ch == 4 ? s : ch * (S/4) + (s >> 2)
// and moves[0] = 1.
//
// What bounds it on the H100: the T steps of a row form a dependent chain
// (each step's load address is the previous step's state), so the floor is
// T device-memory latencies, not bytes: it reads one choice byte per step
// out of the S a step holds. The TPU kernel carried the state as a one-hot
// plane because its vector unit has no cheap gather; here one thread walks
// one chunk row with a direct byte load per step, and the rows of a batch
// run side by side.
#include "common.cuh"

__global__ void traceback_kernel(const int8_t* __restrict__ choices,  // [T, N, S]
                                 const int32_t* __restrict__ last,    // [N]
                                 int32_t* __restrict__ states,        // [T, N]
                                 uint8_t* __restrict__ moves,         // [T, N]
                                 int T, int N, int S) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const int s4 = S / 4;
  int s = min(max(last[n], 0), S - 1);
  for (int t = T - 1; t >= 0; --t) {
    const int ch = choices[((size_t)t * N + n) * S + s];
    const size_t o = (size_t)t * N + n;
    states[o] = s;
    const bool stay = ch == 4;
    moves[o] = (stay && t > 0) ? 0 : 1;
    if (!stay) s = min(max(ch, 0), 3) * s4 + (s >> 2);
  }
}

DTT_EXPORT int crf_traceback(const void* choices, const void* last, void* states,
                             void* moves, int T, int N, int S, void* stream) {
  const int threads = 64;
  traceback_kernel<<<(N + threads - 1) / threads, threads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(choices), static_cast<const int32_t*>(last),
      static_cast<int32_t*>(states), static_cast<uint8_t*>(moves), T, N, S);
  return static_cast<int>(cudaGetLastError());
}
