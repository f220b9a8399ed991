// Backward log-sum-exp scan of the CRF lattice, emitting the shifted,
// max-normalised beta stream that the fused forward kernel consumes.
//
// Replaces dorado_tpu/ops/crf_pallas.py::_lse_scan_pallas_blk with
// reverse=True, shifted=True (Pallas body _lse_bwd_blk_kernel). For j from
// T-1 down to 0, with carry = beta[j+1] (zeros at j = T-1) and m its row max:
//   out[j] = bf16(carry - m)
//   beta[s] = m + log(sum_b exp(carry[succ(s,b)] - m) * exp(score[succ(s,b)*4 + q(s)])
//                     + exp(carry[s] - m) * e^stay)
// with succ(s,b) = (s mod S/4) * 4 + b and q(s) = s / (S/4), the oldest base.
//
// Scores stay in the raw layout c = s*4 + r: direct indexing is cheap here,
// so the TPU's block permutation (baked into the CRF head there) is not
// needed. What bounds it on the H100: the scan is a serial chain of T steps
// per chunk, and the bytes (one read of the bf16 scores, one write of the
// bf16 stream) are small beside it, so each step's latency decides. One
// block per chunk row and one thread per state keep the carry in registers;
// each step is one block-wide max (warp shuffles, then shared memory) and
// two barriers. The next score row is loaded into registers while the
// current one is consumed, and rows are staged in shared memory in the block
// layout r*S + s so that each thread reads its four successors' terms as one
// 16-byte vector without bank conflicts.
#include "common.cuh"

template <int S>
__global__ void __launch_bounds__(S) lse_backward_kernel(
    const __nv_bfloat16* __restrict__ scores,  // [T, N, 4S]
    __nv_bfloat16* __restrict__ out,           // [T, N, S]
    int T, int N, float stay_factor) {
  constexpr int S4 = S / 4;
  constexpr int NW = S / 32;
  __shared__ __align__(16) float es[2][4 * S];  // exp(score), block layout r*S + s
  __shared__ __align__(16) float eb[S];         // exp(carry - m)
  __shared__ float wmax[NW];

  const int n = blockIdx.x;
  const int s = threadIdx.x;
  const int warp = s >> 5, lane = s & 31;
  const size_t row = (size_t)N * 4 * S;
  const __nv_bfloat16* sc = scores + (size_t)n * 4 * S + 4 * s;
  const int q = s / S4;
  const int succ0 = (s % S4) * 4;

  uint2 next = *reinterpret_cast<const uint2*>(sc + (size_t)(T - 1) * row);
  float carry = 0.f;
  for (int i = 0; i < T; ++i) {
    const int j = T - 1 - i;
    float* e = es[i & 1];
    {
      float v[4];
      unpack4(next, v);
#pragma unroll
      for (int r = 0; r < 4; ++r) e[r * S + s] = expf(v[r]);
    }
    if (j > 0) next = *reinterpret_cast<const uint2*>(sc + (size_t)(j - 1) * row);

    const float wm = warp_max(carry);
    if (lane == 0) wmax[warp] = wm;
    __syncthreads();
    float m = wmax[0];
#pragma unroll
    for (int w = 1; w < NW; ++w) m = fmaxf(m, wmax[w]);
    out[((size_t)j * N + n) * S + s] = __float2bfloat16(carry - m);
    const float own = expf(carry - m);
    eb[s] = own;
    __syncthreads();

    const float4 b = *reinterpret_cast<const float4*>(&eb[succ0]);
    const float4 x = *reinterpret_cast<const float4*>(&e[q * S + succ0]);
    const float red = b.x * x.x + b.y * x.y + b.z * x.z + b.w * x.w + own * stay_factor;
    carry = m + logf(red);
  }
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
  switch (S) {
    case 64: return launch<64>(scores, out, T, N, stay_factor, st);
    case 256: return launch<256>(scores, out, T, N, stay_factor, st);
    case 1024: return launch<1024>(scores, out, T, N, stay_factor, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
