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
// What bounds it on the H100: like the backward scan, a serial chain of T
// steps per chunk whose bytes (scores and beta in, posts and choices out)
// are small beside its latency. One block per chunk row and one thread per
// state keep both carries in registers; a step costs three block-wide
// reductions (the two carry maxima share one, then the posterior max and
// sum) and four barriers. The next score and beta rows load into registers
// during the current step, in their stream type, and are widened to float32
// only when consumed; the score row is staged in shared memory in the block
// layout r*S + s, both raw and exponentiated. The Viterbi adds are single f32
// operations in the same order as the plain version, so the choices agree
// exactly, and K8's equal K4's on the same score values.
#include "common.cuh"
#include "crf_viterbi.cuh"

namespace {

// A stream element type: its four-value row vector (loaded as one 8- or
// 16-byte access) and the conversions to and from float32.
template <typename T>
struct Stream;

template <>
struct Stream<__nv_bfloat16> {
  using Vec4 = uint2;
  static __device__ __forceinline__ void widen(Vec4 v, float x[4]) { unpack4(v, x); }
  static __device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }
  static __device__ __forceinline__ __nv_bfloat16 narrow(float v) { return __float2bfloat16(v); }
};

template <>
struct Stream<float> {
  using Vec4 = float4;
  static __device__ __forceinline__ void widen(Vec4 v, float x[4]) {
    x[0] = v.x;
    x[1] = v.y;
    x[2] = v.z;
    x[3] = v.w;
  }
  static __device__ __forceinline__ float widen(float v) { return v; }
  static __device__ __forceinline__ float narrow(float v) { return v; }
};

}  // namespace

template <int S, typename E>
__global__ void __launch_bounds__(S) fused_forward_kernel(
    const E* __restrict__ scores,      // [T, N, 4S]
    const E* __restrict__ beta,        // [T, N, S]: row t is beta[t+1] (bf16: minus its max)
    E* __restrict__ posts,             // [T, N, S]
    int8_t* __restrict__ choices,      // [T, N, S]
    float* __restrict__ final_carry,   // [N, S]
    int T, int N, float stay_score, float stay_factor) {
  constexpr int S4 = S / 4;
  constexpr int NW = S / 32;
  // 18 S floats: 72 KB at S = 1024, over the 48 KB a block may declare
  // statically, so the launch asks for them as dynamic shared memory
  extern __shared__ __align__(16) float dyn[];
  float* sc = dyn;             // [2][4 * S] score, block layout r*S + s
  float* es = dyn + 8 * S;     // [2][4 * S] exp(score), same layout
  float* ec = dyn + 16 * S;    // [S] exp(alpha - m)
  float* vn = dyn + 17 * S;    // [S] Viterbi carry minus its max
  __shared__ float red_carry[2][NW];
  __shared__ float red_pmax[NW];
  __shared__ float red_psum[NW];

  const int n = blockIdx.x;
  const int s = threadIdx.x;
  const int warp = s >> 5, lane = s & 31;
  const size_t srow = (size_t)N * 4 * S;
  const size_t row = (size_t)N * S;
  const E* scn = scores + (size_t)n * 4 * S + 4 * s;
  const size_t own = (size_t)n * S + s;
  const int p0 = s >> 2;

  using Vec4 = typename Stream<E>::Vec4;
  Vec4 next = *reinterpret_cast<const Vec4*>(scn);
  E beta_next = beta[own];
  float a = 0.f, v = 0.f;
  for (int t = 0; t < T; ++t) {
    float* scb = sc + (t & 1) * 4 * S;
    float* esb = es + (t & 1) * 4 * S;
    {
      float x[4];
      Stream<E>::widen(next, x);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        scb[r * S + s] = x[r];
        esb[r * S + s] = expf(x[r]);
      }
    }
    const float beta_t = Stream<E>::widen(beta_next);
    if (t + 1 < T) {
      next = *reinterpret_cast<const Vec4*>(scn + (size_t)(t + 1) * srow);
      beta_next = beta[(size_t)(t + 1) * row + own];
    }

    // A: maxima of both carries
    const float wa = warp_max(a), wv = warp_max(v);
    if (lane == 0) {
      red_carry[0][warp] = wa;
      red_carry[1][warp] = wv;
    }
    __syncthreads();
    float ma = red_carry[0][0], mv = red_carry[1][0];
#pragma unroll
    for (int w = 1; w < NW; ++w) {
      ma = fmaxf(ma, red_carry[0][w]);
      mv = fmaxf(mv, red_carry[1][w]);
    }
    // B: publish the shifted carries
    const float ea = expf(a - ma);
    ec[s] = ea;
    const float vs = v - mv;
    vn[s] = vs;
    __syncthreads();

    // C: alpha step, Viterbi step, posterior row max
    float red = ea * stay_factor;
#pragma unroll
    for (int r = 0; r < 4; ++r) red += ec[r * S4 + p0] * esb[r * S + s];
    a = ma + logf(red);

    float x[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) x[r] = scb[r * S + s];
    choices[(size_t)t * row + own] =
        static_cast<int8_t>(viterbi_update<S>(vn, s, x, stay_score, v));

    const float pb = a + beta_t;
    const float wp = warp_max(pb);
    if (lane == 0) red_pmax[warp] = wp;
    __syncthreads();
    float pm = red_pmax[0];
#pragma unroll
    for (int w = 1; w < NW; ++w) pm = fmaxf(pm, red_pmax[w]);
    // D: posterior row sum
    const float pe = expf(pb - pm);
    const float ws = warp_sum(pe);
    if (lane == 0) red_psum[warp] = ws;
    __syncthreads();
    float total = red_psum[0];
#pragma unroll
    for (int w = 1; w < NW; ++w) total += red_psum[w];
    posts[(size_t)t * row + own] = Stream<E>::narrow(pe / total);
  }
  final_carry[own] = v;
}

template <int S, typename E>
static int launch(const void* scores, const void* beta, void* posts, void* choices,
                  void* final_carry, int T, int N, float stay_score, float stay_factor,
                  cudaStream_t stream) {
  constexpr int smem = 18 * S * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(fused_forward_kernel<S, E>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  fused_forward_kernel<S, E><<<N, S, smem, stream>>>(
      static_cast<const E*>(scores), static_cast<const E*>(beta), static_cast<E*>(posts),
      static_cast<int8_t*>(choices), static_cast<float*>(final_carry), T, N, stay_score,
      stay_factor);
  return static_cast<int>(cudaGetLastError());
}

template <typename E>
static int dispatch(const void* scores, const void* beta, void* posts, void* choices,
                    void* final_carry, int T, int N, int S, float stay_score,
                    float stay_factor, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (S) {
    case 64:
      return launch<64, E>(scores, beta, posts, choices, final_carry, T, N, stay_score,
                           stay_factor, st);
    case 256:
      return launch<256, E>(scores, beta, posts, choices, final_carry, T, N, stay_score,
                            stay_factor, st);
    case 1024:
      return launch<1024, E>(scores, beta, posts, choices, final_carry, T, N, stay_score,
                             stay_factor, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K4: bf16 scores [T, N, 4S], the shifted bf16 beta stream [T, N, S] -> bf16
// posts. S (states) must be 64, 256 or 1024 (state_len 3, 4 or 5).
DTT_EXPORT int crf_fused_forward_bf16(const void* scores, const void* beta, void* posts,
                                      void* choices, void* final_carry, int T, int N,
                                      int S, float stay_score, float stay_factor,
                                      void* stream) {
  return dispatch<__nv_bfloat16>(scores, beta, posts, choices, final_carry, T, N, S,
                                 stay_score, stay_factor, stream);
}

// K8: float32 scores [T, N, 4S], the float32 beta history [T+1, N, S] (read
// from row 1) -> float32 posts. The same states.
DTT_EXPORT int crf_fused_forward_f32(const void* scores, const void* beta_full, void* posts,
                                     void* choices, void* final_carry, int T, int N, int S,
                                     float stay_score, float stay_factor, void* stream) {
  const float* beta_rows = static_cast<const float*>(beta_full) + (size_t)N * S;
  return dispatch<float>(scores, beta_rows, posts, choices, final_carry, T, N, S, stay_score,
                         stay_factor, stream);
}
