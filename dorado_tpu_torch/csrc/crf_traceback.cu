// Viterbi traceback over the per-step choices of the fused forward kernel.
//
// Replaces dorado_tpu/ops/crf_pallas.py::viterbi_traceback_pallas (Pallas
// body _traceback_body). Per chunk row, walking t from T-1 down to 0 from
// the state last[n] (clamped to [0, S)):
//   states[t] = s; ch = choices[t][s]; moves[t] = ch != 4;
//   s = ch == 4 ? s : min(max(ch, 0), 3) * (S/4) + (s >> 2)
// and moves[0] = 1.
//
// What bounds it on the H100: the T steps of a row form a dependent chain
// (each step's address is the previous step's state). The guide's bound
// counts one choice byte a step (0.0004 ms at hac); a step cannot know its
// byte before the step ahead of it, so a kernel either waits one
// device-memory latency a step or brings in every step's whole row of S
// bytes ahead of the chain: 54.6 MB at hac's shape (16 us at 3.35 TB/s),
// 268 MB at sup's (80 us). Beyond the bytes the chain itself is paced by
// on-chip latency, a shared-memory load and a few integer operations a
// step. The TPU kernel carried the state as a one-hot plane because its
// vector unit has no cheap gather. The first version here (one thread a row
// in blocks of 64, a dependent byte load from device memory a step) took
// 0.658 ms at hac and 0.914 at sup (NVIDIA H100 80GB HBM3, 700 W): about
// 395 ns a step, on two SMs at N = 128.
//
// Design: one warp a chunk row, alone in its block, so that N = 128 rows
// fill the card. The row's history streams through a shared-memory ring of
// STAGES stages of 32 steps: chunk c, the steps T-32(c+1) .. T-1-32c, comes
// in as one TMA box of the [T, N, S] choices (a tensor map, 32 steps of one
// row n) onto the stage's mbarrier, STAGES chunks ahead of the chain; the
// box of the last chunk starts below t = 0, where TMA fills zeros. Every
// lane walks the chain of a chunk (the same byte read by all lanes is one
// broadcast) and lane k keeps the state and choice of the chunk's k-th step
// from its top, so the warp writes 32 states and 32 moves as one
// contiguous store each into the [N, T] output (the wrapper returns its
// [T, N] view). The stage is refilled as soon as the chain has left it.
// Steps below t = 0 walk the zeros: the state stays in [0, S) and nothing
// of them is stored. The chain carries the state's offset in the ring, so
// a step is a shared-memory load, a compare, a clamp and a predicated
// multiply-add: 48 cycles at hac's shape; at sup's the ring's bytes set the
// pace. Measured on the card and slower (NVIDIA H100 80GB HBM3, 700 W, hac
// and sup): each lane bringing its step's row by its own cp.async.bulk
// (0.103 and 0.127 ms), and the state carried in place of its offset, seven
// dependent integer operations between two loads (0.068 and 0.096 ms,
// against 0.057 and 0.096).
#include "common.cuh"
#include "tma_map.cuh"

namespace {

constexpr int STEPS = 32;  // steps a stage: one a lane

template <int S>
struct Ring {
  static constexpr int STAGES = S == 1024 ? 3 : 4;
  static constexpr int BYTES = STAGES * STEPS * S;
};

template <int S>
__global__ void __launch_bounds__(32) traceback_kernel(
    const __grid_constant__ CUtensorMap map,  // choices [T, N, S]: 32 steps of a row
    const int32_t* __restrict__ last,         // [N]
    int32_t* __restrict__ states,             // [N, T]
    uint8_t* __restrict__ moves,              // [N, T]
    int T) {
  constexpr int D = Ring<S>::STAGES;
  extern __shared__ __align__(128) int8_t ring[];  // [D][STEPS][S]
  __shared__ __align__(8) uint64_t full[D];
  const int n = blockIdx.x;
  const int lane = threadIdx.x;
  const int chunks = (T + STEPS - 1) / STEPS;

  // lane 0: chunk c into stage c % D, row j the step T-32(c+1)+j
  auto fetch = [&](int c) {
    const int st = c % D;
    const uint32_t mb = smem_u32(&full[st]);
    mbar_expect(mb, STEPS * S);
    tma_load_4d(smem_u32(ring + st * STEPS * S), &map, 0, 0, n, T - STEPS * (c + 1), mb);
  };
  if (lane == 0) {
    for (int st = 0; st < D; ++st) mbar_init(smem_u32(&full[st]), 1);
    mbar_init_fence();
    for (int c = 0; c < D && c < chunks; ++c) fetch(c);
  }
  __syncwarp();

  int s = min(max(last[n], 0), S - 1);
  int32_t* st_row = states + (size_t)n * T;
  uint8_t* mv_row = moves + (size_t)n * T;
  for (int c = 0; c < chunks; ++c) {
    const int st = c % D;
    mbar_wait(smem_u32(&full[st]), (c / D) & 1);
    // a = base + s; base + (s >> 2) comes off the chain
    const int base = st * STEPS * S;
    int a = base + s;
    int my_state = 0, my_choice = 0;
#pragma unroll
    for (int k = 0; k < STEPS; ++k) {
      const int ch = ring[a + (STEPS - 1 - k) * S];
      const int s_k = a - base;
      if (lane == k) {
        my_state = s_k;
        my_choice = ch;
      }
      const int q = base + (s_k >> 2);
      if (ch != 4) a = __vimin_s32_relu(ch, 3) * (S / 4) + q;
    }
    s = a - base;
    __syncwarp();
    if (lane == 0 && c + D < chunks) fetch(c + D);
    const int t = T - 1 - STEPS * c - lane;
    if (t >= 0) {
      st_row[t] = my_state;
      mv_row[t] = (my_choice == 4 && t > 0) ? 0 : 1;
    }
  }
}

template <int S>
int launch(const void* choices, const int32_t* last, int32_t* states, uint8_t* moves, int T,
           int N, cudaStream_t stream) {
  CUtensorMap map;
  if (!make_history_map(&map, choices, 1, T, N, S, STEPS))
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int smem = Ring<S>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(traceback_kernel<S>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  traceback_kernel<S><<<N, 32, smem, stream>>>(map, last, states, moves, T);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// choices [T, N, S] int8, last [N] int32 -> states and moves [N, T]; S is 64,
// 256 or 1024.
DTT_EXPORT int crf_traceback(const void* choices, const void* last, void* states,
                             void* moves, int T, int N, int S, void* stream) {
  if (T <= 0 || N <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int32_t* ls = static_cast<const int32_t*>(last);
  int32_t* st = static_cast<int32_t*>(states);
  uint8_t* mv = static_cast<uint8_t*>(moves);
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  switch (S) {
    case 64: return launch<64>(choices, ls, st, mv, T, N, cs);
    case 256: return launch<256>(choices, ls, st, mv, T, N, cs);
    case 1024: return launch<1024>(choices, ls, st, mv, T, N, cs);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
