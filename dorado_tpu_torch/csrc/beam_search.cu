// CRF beam search: the forward beam over all time steps of a chunk row in
// one launch, and the traceback from the best final element.
//
// Replaces dorado_tpu/ops/beam_pallas.py::beam_forward_pallas (Pallas body
// _beam_kernel) with beam_forward_kernel, which follows the step of
// dorado_tpu/ops/beam.py::beam_search_device that the Pallas kernel
// reproduces; beam_traceback_kernel takes the place of beam.py::_traceback,
// a scan over time there.
//
// One step, for a beam of W = 32 elements (state, sequence hash, score):
//   candidates: for element e, the 4 steps to state ((s << 2) | b) & mask with
//     score + scores[ns*4 + dropped(s)] + beta[ns] and hash crc2(hash, b),
//     and the stay with score + stay + beta[s]; candidate order is the 4
//     steps of element 0, ..., of element 31, then the 32 stays;
//   merge: a stay and a step that spell the same sequence (equal hash, the
//     step's base equal to the stay's last base, both alive) fold into the
//     better of the two by log-sum-exp, and the other dies;
//   cutoff: max - log(beam_cut), raised by at most nine bisection rounds
//     while more than W candidates pass it (and lowered when fewer than
//     0.8 W do);
//   selection: the first W candidates at or above the cutoff, in candidate
//     order; an element's next score is its score minus its beta term.
// Dead slots carry the lowest finite float, not -inf.
//
// The TPU kernel does its lookups, matches and compaction with one-hot and
// rank matrix products, hash halves and a packed score stream, because its
// vector unit has no gather; none of that is needed here.
// What bounds it on the H100: the T steps of a row are a serial chain, and
// the bytes (each score and beta row read once) are small beside it. So one
// warp owns a
// chunk row, a lane owns a beam element with its 4 steps and its stay in
// registers, and the whole time loop runs inside the kernel. The score and
// beta rows of the next step are copied into shared memory with cp.async
// while the current step computes, and read there by direct index. The
// W x 4W match needs no 4W side: a step of element e spells the sequence of
// stay i iff hash[e] is the one hash that stay i's last base takes to its own
// hash (the CRC step is a bijection), so each lane compares one value against
// 32 read from shared memory, four a load, into a bit mask, and evaluates the
// log-sum-exp only for the bits set. Counts are warp reductions and the
// compaction is a warp prefix sum.
#include "common.cuh"

namespace {

constexpr int W = 32;
constexpr float NEG = -3.402823466e38f;  // lowest finite float
constexpr float HALF_NEG = NEG / 2;
constexpr uint32_t FULL = 0xffffffffu;
constexpr uint32_t POLY = 0x82F63B78u;
constexpr uint32_t CRC_SEED = 0x12345678u;

// CRC32C of one more 32-bit word, a bit at a time (run once per element).
__device__ __forceinline__ uint32_t crc32_word(uint32_t crc, uint32_t word) {
  uint32_t c = crc ^ word;
  for (int i = 0; i < 32; ++i) c = (c >> 1) ^ ((c & 1u) ? POLY : 0u);
  return c;
}

// CRC32C table entry of a 2-bit value (two bitwise steps).
__device__ __forceinline__ uint32_t crc2_entry(uint32_t c) {
  c = (c >> 1) ^ ((c & 1u) ? POLY : 0u);
  c = (c >> 1) ^ ((c & 1u) ? POLY : 0u);
  return c;
}

__device__ __forceinline__ uint32_t crc2(uint32_t crc, uint32_t bits) {
  const uint32_t folded = crc ^ (bits & 3u);
  return (folded >> 2) ^ crc2_entry(folded & 3u);
}

// The hash h with crc2(h, bits) == next: the step is a bijection, and the top
// two bits of the table entry of c are c itself.
__device__ __forceinline__ uint32_t crc2_inverse(uint32_t next, uint32_t bits) {
  const uint32_t c = next >> 30;
  return (((next ^ crc2_entry(c)) << 2) | c) ^ (bits & 3u);
}

__device__ __forceinline__ float lse2(float x, float y) {
  const float d = fabsf(__fsub_rn(x, y));
  return __fadd_rn(fmaxf(x, y), d < 17.0f ? log1pf(expf(-d)) : 0.0f);
}

template <int S>
__global__ void __launch_bounds__(W) beam_forward_kernel(
    const float* __restrict__ scores,      // [T, N, 4S]
    const float* __restrict__ beta,       // [T+1, N, S] backward scores; row t+1 steers step t
    const int32_t* __restrict__ init_state,  // [N, W]; hashed from the CRC seed here
    int32_t* __restrict__ hist_state,      // [T, N, W]
    uint8_t* __restrict__ hist_ps,         // [T, N, W]: parent | stay << 7
    float* __restrict__ final_score,       // [N, W]
    int T, int N, float log_beam_cut, float stay) {
  constexpr int C = 4 * S;
  constexpr int BITS = S == 64 ? 6 : S == 256 ? 8 : 10;
  // the staged score and guide rows, two of each: 40 KB at S = 1024, which
  // with the arrays below would sit at the 48 KB a block may declare
  // statically, so the launch asks for them as dynamic shared memory
  extern __shared__ __align__(16) float staged[];
  float* const sc = staged;          // [2][C]
  float* const bt = staged + 2 * C;  // [2][S]
  __shared__ float sh_step[4 * W];
  __shared__ float sh_stay[W];
  __shared__ __align__(16) uint32_t sh_hash[W];
  __shared__ __align__(16) uint32_t sh_parent[W];
  __shared__ int sh_base[W];
  __shared__ int k_state[W];
  __shared__ uint32_t k_hash[W];
  __shared__ float k_score[W];
  __shared__ float k_back[W];
  __shared__ int k_ps[W];

  const int n = blockIdx.x;
  const int lane = threadIdx.x;
  const uint32_t lt_mask = (1u << lane) - 1u;

  auto prefetch = [&](int t, int buf) {
    const float* s_src = scores + ((size_t)t * N + n) * C;
    const float* b_src = beta + ((size_t)(t + 1) * N + n) * S;
    for (int i = lane; i < C / 4; i += W) cp_async16(&sc[buf * C + i * 4], s_src + i * 4);
    for (int i = lane; i < S / 4; i += W) cp_async16(&bt[buf * S + i * 4], b_src + i * 4);
    asm volatile("cp.async.commit_group;\n" ::);
  };

  int state = init_state[n * W + lane];
  uint32_t hash = crc32_word(CRC_SEED, static_cast<uint32_t>(state));
  float score = 0.f;
  float raw = 0.f;

  prefetch(0, 0);
  for (int t = 0; t < T; ++t) {
    const int buf = t & 1;
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncwarp();
    if (t + 1 < T) prefetch(t + 1, buf ^ 1);
    const float* srow = sc + buf * C;
    const float* brow = bt + buf * S;

    // ---- candidates ------------------------------------------------------
    const uint32_t prev = static_cast<uint32_t>(state);
    const uint32_t shifted = (prev << 2) & (S - 1);
    const uint32_t dropped = prev >> (BITS - 2);
    const int my_base = prev & 3;
    float step_score[4], back_step[4];
    uint32_t step_hash[4];
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const uint32_t ns = shifted | b;
      back_step[b] = brow[ns];
      step_score[b] = __fadd_rn(__fadd_rn(score, srow[ns * 4 + dropped]), back_step[b]);
      step_hash[b] = crc2(hash, b);
      sh_step[4 * lane + b] = step_score[b];
    }
    const float stay_back = brow[prev];
    const float stay_score = __fadd_rn(__fadd_rn(score, stay), stay_back);
    // a step of element e spells my stay's sequence iff its base is my last
    // base and hash[e] is the one hash that this base takes to my hash
    const uint32_t parent_hash = crc2_inverse(hash, my_base);
    sh_stay[lane] = stay_score;
    sh_hash[lane] = hash;
    sh_parent[lane] = parent_hash;
    sh_base[lane] = my_base;
    __syncwarp();

    // ---- merge: matches are pairs (stay i, element e) with parent_hash[i]
    // == hash[e]. Each lane scans for them once as an element and once as a
    // stay, four values a shared-memory load, into a bit mask without
    // branching, and then walks over the hits only.
    uint32_t elem_hits = 0, stay_hits = 0;
#pragma unroll
    for (int q = 0; q < W / 4; ++q) {
      const uint4 p = reinterpret_cast<const uint4*>(sh_parent)[q];
      const uint4 h = reinterpret_cast<const uint4*>(sh_hash)[q];
      elem_hits |= (uint32_t)(p.x == hash) << (4 * q) | (uint32_t)(p.y == hash) << (4 * q + 1) |
                   (uint32_t)(p.z == hash) << (4 * q + 2) | (uint32_t)(p.w == hash) << (4 * q + 3);
      stay_hits |= (uint32_t)(h.x == parent_hash) << (4 * q) |
                   (uint32_t)(h.y == parent_hash) << (4 * q + 1) |
                   (uint32_t)(h.z == parent_hash) << (4 * q + 2) |
                   (uint32_t)(h.w == parent_hash) << (4 * q + 3);
    }
    // as an element: my step with base[i] against stay i
    float new_step[4];
    {
      bool killed[4] = {false, false, false, false};
      bool fold[4] = {false, false, false, false};
      float fv[4] = {NEG, NEG, NEG, NEG};
      while (elem_hits) {
        const int i = __ffs(elem_hits) - 1;
        elem_hits &= elem_hits - 1;
        const float st = sh_stay[i];
        const int bi = sh_base[i];
        const float ss = bi == 0 ? step_score[0] : bi == 1 ? step_score[1]
                       : bi == 2 ? step_score[2] : step_score[3];
        if (!(st > HALF_NEG && ss > HALF_NEG)) continue;
        const bool stay_wins = st > ss;
        const float folded = stay_wins ? NEG : lse2(st, ss);
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          if (bi == b) {
            killed[b] |= stay_wins;
            fold[b] |= !stay_wins;
            fv[b] = fmaxf(fv[b], folded);
          }
        }
      }
#pragma unroll
      for (int b = 0; b < 4; ++b)
        new_step[b] = killed[b] ? NEG : (fold[b] ? fv[b] : step_score[b]);
    }
    // as a stay: my stay against the step with my base of element e
    float new_stay = stay_score;
    if (stay_score > HALF_NEG) {
      bool loses = false, folds = false;
      float fv = NEG;
      while (stay_hits) {
        const int e = __ffs(stay_hits) - 1;
        stay_hits &= stay_hits - 1;
        const float ss = sh_step[4 * e + my_base];
        if (!(ss > HALF_NEG)) continue;
        if (stay_score > ss) {
          folds = true;
          fv = fmaxf(fv, lse2(stay_score, ss));
        } else {
          loses = true;
        }
      }
      new_stay = loses ? NEG : (folds ? fv : stay_score);
    }

    // ---- cutoff with bisection width control ----------------------------
    float max_score = fmaxf(fmaxf(fmaxf(new_step[0], new_step[1]),
                                  fmaxf(new_step[2], new_step[3])), new_stay);
    max_score = warp_max(max_score);
    auto count_ge = [&](float cut) {
      const int c = (new_step[0] >= cut) + (new_step[1] >= cut) + (new_step[2] >= cut) +
                    (new_step[3] >= cut) + (new_stay >= cut);
      return __reduce_add_sync(FULL, c);
    };
    float cutoff = __fsub_rn(max_score, log_beam_cut);
    if (count_ge(cutoff) > W) {
      constexpr int MIN_WIDTH = (W * 8) / 10;
      float lo = cutoff, hi = max_score;
      bool done = false;
      for (int round = 0; round < 9 && !done; ++round) {
        const int cnt = count_ge(cutoff);
        const bool too_many = cnt > W;
        if (too_many || cnt < MIN_WIDTH) {
          const float mid = __fmul_rn(__fadd_rn(cutoff, too_many ? hi : lo), 0.5f);
          if (too_many) lo = cutoff; else hi = cutoff;
          cutoff = mid;
        } else {
          done = true;
        }
      }
      if (!done) cutoff = hi;
    }

    // ---- the first W candidates at or above the cutoff, in order ----------
    bool keep[4];
    int cnt = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      keep[b] = new_step[b] >= cutoff;
      cnt += keep[b];
    }
    int incl = cnt;
#pragma unroll
    for (int o = 1; o < W; o <<= 1) {
      const int up = __shfl_up_sync(FULL, incl, o);
      if (lane >= o) incl += up;
    }
    const int total_steps = __shfl_sync(FULL, incl, W - 1);
    const bool keep_stay = new_stay >= cutoff;
    const uint32_t stay_ballot = __ballot_sync(FULL, keep_stay);
    const int n_kept = min(total_steps + __popc(stay_ballot), W);
    int rank = incl - cnt;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      if (keep[b]) {
        if (rank < W) {
          k_state[rank] = static_cast<int>(shifted | b);
          k_hash[rank] = step_hash[b];
          k_score[rank] = new_step[b];
          k_back[rank] = back_step[b];
          k_ps[rank] = lane;
        }
        ++rank;
      }
    }
    if (keep_stay) {
      const int r = total_steps + __popc(stay_ballot & lt_mask);
      if (r < W) {
        k_state[r] = state;
        k_hash[r] = hash;
        k_score[r] = new_stay;
        k_back[r] = stay_back;
        k_ps[r] = lane | 0x80;
      }
    }
    __syncwarp();
    int ps = 0;
    if (lane < n_kept) {
      state = k_state[lane];
      hash = k_hash[lane];
      raw = k_score[lane];
      score = __fsub_rn(raw, k_back[lane]);
      ps = k_ps[lane];
    } else {
      state = 0;
      hash = 0u;
      raw = NEG;
      score = NEG;
    }
    const size_t o = ((size_t)t * N + n) * W + lane;
    hist_state[o] = state;
    hist_ps[o] = static_cast<uint8_t>(ps);
  }
  final_score[n * W + lane] = raw;
}

__global__ void beam_traceback_kernel(const int32_t* __restrict__ hist_state,  // [T, N, W]
                                      const uint8_t* __restrict__ hist_ps,     // [T, N, W]
                                      const float* __restrict__ final_score,   // [N, W]
                                      int32_t* __restrict__ states,            // [N, T]
                                      uint8_t* __restrict__ moves,             // [N, T]
                                      int T, int N) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  int elem = 0;
  float best = final_score[n * W];
  for (int w = 1; w < W; ++w) {
    const float v = final_score[n * W + w];
    if (v > best) {
      best = v;
      elem = w;
    }
  }
  for (int t = T - 1; t >= 0; --t) {
    const size_t o = ((size_t)t * N + n) * W + elem;
    const int ps = hist_ps[o];
    states[(size_t)n * T + t] = hist_state[o];
    moves[(size_t)n * T + t] = ((ps & 0x80) && t > 0) ? 0 : 1;
    elem = ps & 0x7F;
  }
}

template <int S>
int launch_forward(const float* scores, const float* beta, const int32_t* init_state,
                   int32_t* hist_state, uint8_t* hist_ps, float* final_score, int T, int N,
                   float log_beam_cut, float stay, cudaStream_t stream) {
  constexpr int smem = 2 * (4 * S + S) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(beam_forward_kernel<S>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  beam_forward_kernel<S><<<N, W, smem, stream>>>(scores, beta, init_state, hist_state,
                                                 hist_ps, final_score, T, N, log_beam_cut,
                                                 stay);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Beam width 32; S (states) 64, 256 or 1024 (state_len 3, 4 or 5).
DTT_EXPORT int beam_forward_f32(const void* scores, const void* beta, const void* init_state,
                                void* hist_state, void* hist_ps, void* final_score, int T,
                                int N, int S, float log_beam_cut, float stay, void* stream) {
  if (T <= 0 || N <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const float* sc = static_cast<const float*>(scores);
  const float* bt = static_cast<const float*>(beta);
  const int32_t* is = static_cast<const int32_t*>(init_state);
  int32_t* hs = static_cast<int32_t*>(hist_state);
  uint8_t* hp = static_cast<uint8_t*>(hist_ps);
  float* fs = static_cast<float*>(final_score);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (S) {
    case 64: return launch_forward<64>(sc, bt, is, hs, hp, fs, T, N, log_beam_cut, stay, st);
    case 256: return launch_forward<256>(sc, bt, is, hs, hp, fs, T, N, log_beam_cut, stay, st);
    case 1024:
      return launch_forward<1024>(sc, bt, is, hs, hp, fs, T, N, log_beam_cut, stay, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

DTT_EXPORT int beam_traceback(const void* hist_state, const void* hist_ps,
                              const void* final_score, void* states, void* moves, int T, int N,
                              void* stream) {
  if (T <= 0 || N <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = 64;
  beam_traceback_kernel<<<(N + threads - 1) / threads, threads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(hist_state), static_cast<const uint8_t*>(hist_ps),
      static_cast<const float*>(final_score), static_cast<int32_t*>(states),
      static_cast<uint8_t*>(moves), T, N);
  return static_cast<int>(cudaGetLastError());
}
