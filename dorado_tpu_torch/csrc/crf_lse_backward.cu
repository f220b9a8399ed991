// Backward log-sum-exp scan of the CRF lattice, emitting the shifted,
// max-normalised beta stream that the fused forward kernel consumes.
//
// Replaces dorado_tpu/ops/crf_pallas.py::_lse_scan_pallas_blk with
// reverse=True, shifted=True (Pallas body _lse_bwd_blk_kernel). For j from
// T-1 down to 0, with carry = beta[j+1] (zeros at j = T-1):
//   out[j] = bf16(carry - max(carry))
//   beta[s] = log(sum_b exp(carry[succ(s,b)]) * exp(score[succ(s,b)*4 + q(s)])
//                 + exp(carry[s]) * e^stay)
// with succ(s,b) = (s mod S/4) * 4 + b and q(s) = s / (S/4), the oldest base.
//
// Scores stay in the raw layout c = s*4 + r: direct indexing is cheap here,
// so the TPU's block permutation (baked into the CRF head there) is not
// needed. What bounds it on the H100: the scan is a serial chain of T steps
// per chunk row, each a block-wide exchange of carries, and the bytes (one
// read of the bf16 scores, one write of the bf16 stream: 0.80 ms at sup's
// shape, 3.35 TB/s) are small beside it at hac and close to it at sup. The
// first version (one thread a state, two barriers a step, a shuffle and
// shared-memory maximum on the carries' chain, exact expf and logf, the
// score row staged in shared memory exponentiated, bf16 widened through
// __nv_bfloat162) took 0.852 ms at hac and 2.169 at sup (NVIDIA H100 80GB
// HBM3, 700 W).
//
// Design: K4's (crf_fused_forward.cu) run backwards. One block a chunk row,
// one thread a state. The carry is linear: each thread holds E = exp(beta -
// a shift) and the readers scale the published values by 1 / their maximum,
// so the chain of a step is one barrier, a redux.sync maximum (the values are
// not negative, so their bits order as ints), one rcp.approx, four FMAs and
// a store. The output row, lg2(E / max E) ln 2, hangs off that chain: it is
// staged in shared memory by state and stored one step later, each thread
// its own state, so that a warp writes 64 contiguous bytes. The scores'
// exponentials are taken by ex2.approx a step ahead, from a register ring of
// raw rows (eight rows ahead, four at 1024 states, where a thread has 64
// registers), widened from bf16 by a shift and a mask. The four scores a
// thread needs are at data-independent offsets: with thread i holding state
// (i / 4) + (i % 4) S/4, the four threads of a quad need the 16 contiguous
// scores of their four common successors, so each loads 8 of those bytes and
// two shuffles transpose the quad's 4 x 4 block. Only the carries, the
// warps' maxima and the output row go through shared memory, by state with
// 8 slots of padding after each quarter, so that the stores and the quads'
// 16-byte loads are free of bank conflicts.
// Measured on the card and slower (NVIDIA H100 80GB HBM3, 700 W): each
// thread's four scores as four 2-byte loads (0.990 ms at hac and 2.020 at
// sup, against 0.399 and 1.377 for this form); in that form, the output row
// stored by each thread in its quad order cost 0.100 and 0.385 ms (measured
// by leaving the store out).
//
// A state more than about 87 nats below its row's maximum underflows to E = 0
// and its output to -inf (the plain version gives its finite value); its
// posterior in K4 is 0 either way.
#include "common.cuh"

namespace {

constexpr float LN2 = 0.6931471805599453f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned FULL = 0xffffffffu;

// exp of this thread's four successor scores of one row, from the quad's
// loads. Thread k of a quad (k = lane % 4) loaded row b = k of the 4 x 4 block
// M[b][q] = score[16 g + 4 b + q] (8 bytes, two bf16 a word) and needs column
// q = k: two shuffles transpose it (the first swaps column pairs across
// lanes k and k ^ 2, the second single columns across k and k ^ 1), and a
// swap network puts row b at es[b].
__device__ __forceinline__ void exp_successors(uint2 v, int k, float es[4]) {
  const bool c2 = k & 2, c1 = k & 1;
  const uint32_t keep = c2 ? v.y : v.x;  // row k, columns c, c + 1 (c = k & 2)
  const uint32_t got = __shfl_xor_sync(FULL, c2 ? v.x : v.y, 2);  // row k ^ 2, the same columns
  // column k of rows k and k ^ 2 (a bf16 is the high half of its float32)
  const uint32_t mine = c1 ? keep & 0xffff0000u : keep << 16;
  const uint32_t mine2 = c1 ? got & 0xffff0000u : got << 16;
  // column k ^ 1 of the same rows, for lane k ^ 1; its column k of rows k ^ 1, k ^ 3
  const uint32_t other = __shfl_xor_sync(
      FULL, c1 ? (keep & 0xffffu) | (got << 16) : (keep >> 16) | (got & 0xffff0000u), 1);
  float u[4] = {__uint_as_float(mine), __uint_as_float(other << 16), __uint_as_float(mine2),
                __uint_as_float(other & 0xffff0000u)};  // rows k, k ^ 1, k ^ 2, k ^ 3
  if (c1) {
    const float t0 = u[0], t2 = u[2];
    u[0] = u[1]; u[1] = t0; u[2] = u[3]; u[3] = t2;
  }
  if (c2) {
    const float t0 = u[0], t1 = u[1];
    u[0] = u[2]; u[1] = u[3]; u[2] = t0; u[3] = t1;
  }
#pragma unroll
  for (int b = 0; b < 4; ++b) es[b] = ex2(u[b] * LOG2E);
}

}  // namespace

template <int S>
__global__ void __launch_bounds__(S) lse_backward_kernel(
    const __nv_bfloat16* __restrict__ scores,  // [T, N, 4S]
    __nv_bfloat16* __restrict__ out,           // [T, N, S]
    int T, int N, float stay_factor) {
  constexpr int S4 = S / 4;
  constexpr int NW = S / 32;
  constexpr int RING = S < 1024 ? 8 : 4;
  // E of every state by step parity, at slot s + 8 (s / S4)
  __shared__ __align__(16) float carry[2][S + 32];
  // the warps' maxima of E (its bits) by step parity
  __shared__ int part[2][NW];
  // the output row by step parity, at the same slots
  __shared__ __nv_bfloat16 row_out[2][S + 32];

  const int n = blockIdx.x, i = threadIdx.x, lane = i & 31, warp = i >> 5;
  const int g = i >> 2, k = i & 3;
  const int s = g + k * S4;                   // this thread's state: q(s) = k
  const int own = s + 8 * k;                  // its slot
  const int succ = 4 * g + 8 * (4 * g / S4);  // the slot of succ(s, 0); succ(s, b) follow
  const int mine = i + 8 * (i / S4);          // the slot of state i, which this thread stores
  const size_t srow = (size_t)N * 4 * S, row = (size_t)N * S;
  // this thread's 8 bytes of a score row: score[16 g + 4 k + q], q = 0..3
  const uint2* sc = reinterpret_cast<const uint2*>(scores + (size_t)n * 4 * S + 16 * g + 4 * k);
  __nv_bfloat16* o = out + (size_t)(T - 1) * row + (size_t)n * S + i;

  uint2 xr[RING];  // the next RING rows (rows T-1, T-2, ...)
#pragma unroll
  for (int u = 0; u < RING; ++u)
    if (u < T) xr[u] = __ldg(sc + (size_t)(T - 1 - u) * (srow / 4));

  // ea: E of this state for the current carry; es: exp of this step's scores
  float ea = 1.f, es[4];
  exp_successors(xr[0], k, es);
  carry[0][own] = 1.f;
  if (lane == 0) part[0][warp] = __float_as_int(1.f);

  // Step i reads the carry beta[j+1] (j = T-1-i), stages out[j] and computes
  // beta[j] (unused at the last step); out[j+1], staged at step i - 1, is
  // stored. The step is one straight block.
  for (int i0 = 0; i0 < T; i0 += RING) {
#pragma unroll
    for (int u = 0; u < RING; ++u) {
      const int step = i0 + u;
      if (step >= T) break;
      const int par = step & 1;
      __syncthreads();  // the carries, maxima and output row of step - 1 are published
      const float scale = rcp(__int_as_float(__reduce_max_sync(FULL, part[par][lane & (NW - 1)])));
      const float4 c = *reinterpret_cast<const float4*>(&carry[par][succ]);
      if (step > 0) {
        *o = row_out[par ^ 1][mine];
        o -= row;
      }
      row_out[par][own] = __float2bfloat16(lg2(ea * scale) * LN2);
      float red = ea * stay_factor;
      red = fmaf(c.x, es[0], red);
      red = fmaf(c.y, es[1], red);
      red = fmaf(c.z, es[2], red);
      red = fmaf(c.w, es[3], red);
      ea = red * scale;
      carry[par ^ 1][own] = ea;
      exp_successors(xr[(u + 1) % RING], k, es);
      if (step + RING < T) xr[u] = __ldg(sc + (size_t)(T - 1 - step - RING) * (srow / 4));
      const int q = __reduce_max_sync(FULL, __float_as_int(ea));
      if (lane == 0) part[par ^ 1][warp] = q;
    }
  }
  __syncthreads();
  *o = row_out[(T - 1) & 1][mine];
}

template <int S>
static int launch(const void* scores, void* out, int T, int N, float stay_factor,
                  cudaStream_t stream) {
  lse_backward_kernel<S><<<N, S, 0, stream>>>(static_cast<const __nv_bfloat16*>(scores),
                                              static_cast<__nv_bfloat16*>(out), T, N,
                                              stay_factor);
  return static_cast<int>(cudaGetLastError());
}

// S (states) must be 64, 256 or 1024 (state_len 3, 4 or 5).
DTT_EXPORT int crf_lse_backward_bf16(const void* scores, void* out, int T, int N, int S,
                                     float stay_factor, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (T <= 0 || N <= 0) return static_cast<int>(cudaErrorInvalidValue);
  switch (S) {
    case 64: return launch<64>(scores, out, T, N, stay_factor, st);
    case 256: return launch<256>(scores, out, T, N, stay_factor, st);
    case 1024: return launch<1024>(scores, out, T, N, stay_factor, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
