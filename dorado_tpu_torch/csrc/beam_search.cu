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
// What bounds it on the H100: the T steps of a row are a serial chain of
// warp-wide exchanges, and at 1024 states the bytes as well (each score and
// guide row read once: 5.4 GB at sup's shape, 1.6 ms at 3.35 TB/s). One warp
// owns a chunk row, a lane owns a beam element with its 4 steps and its stay
// in registers, and the whole time loop runs inside the kernel: more warps a
// row would put a barrier on every step. The first version (the next
// step's rows copied into shared memory by each lane's cp.async one step
// ahead, the cutoff's bisection as up to ten dependent warp sums, the
// selection by a shuffle prefix sum into six shared arrays) took 4.701 ms at
// hac and 4.695 at sup (NVIDIA H100 80GB HBM3, 700 W).
//
// Design: lane 0 brings each step's contiguous score and guide rows into
// shared memory by two bulk copies onto an mbarrier ring 16 steps deep (8 at
// 1024 states, 160 KB), refilling a stage as soon as the step has read it, so
// the warp spends no instructions on copies and no step waits for memory.
// The W x 4W match needs no 4W side: a step of element e spells the sequence
// of stay i iff hash[e] is the one hash that stay i's last base takes to its
// own hash (the CRC step is a bijection), so each stay's lane compares one
// value against the 32 hashes, four a shared-memory load, into a bit mask.
// Distinct sequences have distinct hashes, so a live stay hits at most one
// live element: its lane takes that pair's log-sum-exp (symmetric) and writes
// the outcome into the element's slot for its base, and each element reads
// its four slots. A live stay with several hits, or two stays writing one
// slot (a hash collision), send the warp to the general loops (each lane
// walks its hits as an element and as a stay). The step is a lone warp's chain of dependent
// instructions, so what counts is their number: the maximum is one redux.sync
// on order-preserving ints, the ranks come from one ballot a candidate slot,
// and the survivors pass through shared memory as one 16-byte record each.
// Measured on the card and slower (NVIDIA H100 80GB HBM3, 700 W, random
// scores at hac's shape): the bisection's counts at every cutoff the next
// three rounds could reach in two redux.sync a batch, following the
// sequential path through them (3.314 ms against 3.258 sequential: a step
// needs 1.4 rounds on average); each cutoff counted by five ballots instead
// of one redux.sync (2.039 ms, equal); the merge always as two loops over
// every lane's hits with the log-sum-exp on the winner's lane (3.112 ms, and
// 3.973 at sup, against 2.039 and 2.532 for this form); the wait for a stage
// by lane 0 alone and a __syncwarp (3% slower). A spin on
// mbarrier.test_wait in place of try_wait was 2% faster (2.011 against
// 2.051 ms), too little for a second wait helper beside common.cuh's.
#include "common.cuh"
#include "tma_map.cuh"

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

// The ring of steps' rows in shared memory: a stage is one step's score row
// (4S floats) and guide row (S floats), brought by the bulk copy engine.
template <int S>
struct Ring {
  static constexpr int STAGES = S == 1024 ? 8 : 16;
  static constexpr int FLOATS = 5 * S;
  static constexpr int BYTES = STAGES * FLOATS * 4;
};

template <int S>
__global__ void __launch_bounds__(W, 1) beam_forward_kernel(
    const float* __restrict__ scores,      // [T, N, 4S]
    const float* __restrict__ beta,       // [T+1, N, S] backward scores; row t+1 steers step t
    const int32_t* __restrict__ init_state,  // [N, W]; hashed from the CRC seed here
    int32_t* __restrict__ hist_state,      // [T, N, W]
    uint8_t* __restrict__ hist_ps,         // [T, N, W]: parent | stay << 7
    float* __restrict__ final_score,       // [N, W]
    int T, int N, float log_beam_cut, float stay) {
  constexpr int C = 4 * S;
  constexpr int BITS = S == 64 ? 6 : S == 256 ? 8 : 10;
  constexpr int D = Ring<S>::STAGES;
  constexpr int MIN_WIDTH = (W * 8) / 10;
  extern __shared__ __align__(128) float ring[];  // [D][C + S]
  __shared__ __align__(8) uint64_t full[D];
  __shared__ __align__(16) float4 sh_step[W];
  __shared__ float sh_stay[W];
  __shared__ __align__(16) uint32_t sh_hash[W];
  __shared__ __align__(16) uint32_t sh_parent[W];
  __shared__ int sh_base[W];
  // each element's step slots (4 e + base): the outcome a stay wrote there,
  // its lane and the folded score
  __shared__ __align__(4) uint8_t sh_code[4 * W];
  __shared__ uint8_t sh_owner[4 * W];
  __shared__ __align__(16) float4 sh_fold[W];
  // the survivors, by rank: state | ps << 16, hash, raw score, next score
  __shared__ __align__(16) int4 kept[W];

  const int n = blockIdx.x;
  const int lane = threadIdx.x;
  const uint32_t lt_mask = (1u << lane) - 1u;
  const uint32_t ring0 = smem_u32(ring);

  // lane 0: step t's score and guide rows into stage t % D
  auto fetch = [&](int t) {
    const int st = t % D;
    const uint32_t mb = smem_u32(&full[st]);
    const uint32_t dst = ring0 + st * Ring<S>::FLOATS * 4;
    mbar_expect(mb, Ring<S>::FLOATS * 4);
    bulk_load(dst, scores + ((size_t)t * N + n) * C, C * 4, mb);
    bulk_load(dst + C * 4, beta + ((size_t)(t + 1) * N + n) * S, S * 4, mb);
  };
  if (lane == 0) {
    for (int st = 0; st < D; ++st) mbar_init(smem_u32(&full[st]), 1);
    mbar_init_fence();
    for (int t = 0; t < D && t < T; ++t) fetch(t);
  }
  __syncwarp();

  int state = init_state[n * W + lane];
  uint32_t hash = crc32_word(CRC_SEED, static_cast<uint32_t>(state));
  float score = 0.f;
  float raw = 0.f;

  for (int t = 0; t < T; ++t) {
    const int st = t % D;
    mbar_wait(smem_u32(&full[st]), (t / D) & 1);
    const float* srow = ring + st * Ring<S>::FLOATS;
    const float* brow = srow + C;

    // ---- candidates ------------------------------------------------------
    const uint32_t prev = static_cast<uint32_t>(state);
    const uint32_t shifted = (prev << 2) & (S - 1);
    const uint32_t dropped = prev >> (BITS - 2);
    const int my_base = prev & 3;
    const float4 bk = *reinterpret_cast<const float4*>(brow + shifted);
    const float back_step[4] = {bk.x, bk.y, bk.z, bk.w};
    const float* tr = srow + shifted * 4 + dropped;  // scores[(shifted | b) * 4 + dropped]
    float step_score[4];
    uint32_t step_hash[4];
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      step_score[b] = __fadd_rn(__fadd_rn(score, tr[4 * b]), back_step[b]);
      step_hash[b] = crc2(hash, b);
    }
    const float stay_back = brow[prev];
    const float stay_score = __fadd_rn(__fadd_rn(score, stay), stay_back);
    // a step of element e spells my stay's sequence iff its base is my last
    // base and hash[e] is the one hash that this base takes to my hash
    const uint32_t parent_hash = crc2_inverse(hash, my_base);
    sh_step[lane] = make_float4(step_score[0], step_score[1], step_score[2], step_score[3]);
    sh_stay[lane] = stay_score;
    sh_hash[lane] = hash;
    sh_parent[lane] = parent_hash;
    sh_base[lane] = my_base;
    reinterpret_cast<uint32_t*>(sh_code)[lane] = 0u;
    __syncwarp();
    // the stage has been read: refill it with the rows of step t + D
    if (lane == 0 && t + D < T) fetch(t + D);

    // ---- merge: matches are pairs (stay i, element e) with parent_hash[i]
    // == hash[e], scanned four values a shared-memory load into a bit mask.
    // Each stay's lane takes the log-sum-exp of its first pair (it is
    // symmetric) and, if both are alive, writes the outcome into the slot of
    // the element's step with its base: 1 the stay wins, 2 the step wins and
    // takes the folded score. That is the whole merge when no stay hits
    // several elements and no two stays write one slot (distinct sequences
    // have distinct hashes, so only a hash collision does that); otherwise
    // the warp takes the general loops, where each lane walks its hits as an
    // element and as a stay.
    uint32_t stay_hits = 0;
#pragma unroll
    for (int q = 0; q < W / 4; ++q) {
      const uint4 h = reinterpret_cast<const uint4*>(sh_hash)[q];
      stay_hits |= (uint32_t)(h.x == parent_hash) << (4 * q) |
                   (uint32_t)(h.y == parent_hash) << (4 * q + 1) |
                   (uint32_t)(h.z == parent_hash) << (4 * q + 2) |
                   (uint32_t)(h.w == parent_hash) << (4 * q + 3);
    }
    // dead elements' steps are dead, so their hits change nothing (and all
    // dead slots share hash 0, which is a dead stay's parent hash)
    stay_hits &= __ballot_sync(FULL, score > HALF_NEG);
    int code = 0;
    float folded = NEG;
    const int slot = 4 * (__ffs(stay_hits) - 1) + my_base;
    if (stay_hits) {
      const float ss = reinterpret_cast<const float*>(sh_step)[slot];
      if (stay_score > HALF_NEG && ss > HALF_NEG) {
        folded = lse2(stay_score, ss);
        code = stay_score > ss ? 1 : 2;
        sh_code[slot] = static_cast<uint8_t>(code);
        sh_owner[slot] = static_cast<uint8_t>(lane);
        reinterpret_cast<float*>(sh_fold)[slot] = folded;
      }
    }
    __syncwarp();
    const bool general = __any_sync(
        FULL, (stay_score > HALF_NEG && (stay_hits & (stay_hits - 1)) != 0) ||
                  (code != 0 && sh_owner[slot] != lane));
    float new_step[4], new_stay;
    if (!general) {
      new_stay = code == 2 ? NEG : code == 1 ? folded : stay_score;
      const uint32_t codes = reinterpret_cast<const uint32_t*>(sh_code)[lane];
      const float4 fo = sh_fold[lane];
      const float fold4[4] = {fo.x, fo.y, fo.z, fo.w};
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const uint32_t cb = (codes >> (8 * b)) & 255u;
        new_step[b] = cb == 1 ? NEG : cb == 2 ? fold4[b] : step_score[b];
      }
    } else {
      uint32_t elem_hits = 0;
#pragma unroll
      for (int q = 0; q < W / 4; ++q) {
        const uint4 p = reinterpret_cast<const uint4*>(sh_parent)[q];
        elem_hits |= (uint32_t)(p.x == hash) << (4 * q) | (uint32_t)(p.y == hash) << (4 * q + 1) |
                     (uint32_t)(p.z == hash) << (4 * q + 2) | (uint32_t)(p.w == hash) << (4 * q + 3);
      }
      // as an element: my step with base[i] against stay i
      bool killed[4] = {false, false, false, false};
      bool fold[4] = {false, false, false, false};
      float fv[4] = {NEG, NEG, NEG, NEG};
      while (elem_hits) {
        const int i = __ffs(elem_hits) - 1;
        elem_hits &= elem_hits - 1;
        const float st_i = sh_stay[i];
        const int bi = sh_base[i];
        const float ss = bi == 0 ? step_score[0] : bi == 1 ? step_score[1]
                       : bi == 2 ? step_score[2] : step_score[3];
        if (!(st_i > HALF_NEG && ss > HALF_NEG)) continue;
        const bool stay_wins = st_i > ss;
        const float f = stay_wins ? NEG : lse2(st_i, ss);
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          if (bi == b) {
            killed[b] |= stay_wins;
            fold[b] |= !stay_wins;
            fv[b] = fmaxf(fv[b], f);
          }
        }
      }
#pragma unroll
      for (int b = 0; b < 4; ++b)
        new_step[b] = killed[b] ? NEG : (fold[b] ? fv[b] : step_score[b]);
      // as a stay: my stay against the step with my base of element e
      new_stay = stay_score;
      if (stay_score > HALF_NEG) {
        bool loses = false, folds = false;
        float f = NEG;
        uint32_t hits = stay_hits;
        while (hits) {
          const int e = __ffs(hits) - 1;
          hits &= hits - 1;
          const float ss = reinterpret_cast<const float*>(sh_step)[4 * e + my_base];
          if (!(ss > HALF_NEG)) continue;
          if (stay_score > ss) {
            folds = true;
            f = fmaxf(f, lse2(stay_score, ss));
          } else {
            loses = true;
          }
        }
        new_stay = loses ? NEG : (folds ? f : stay_score);
      }
    }

    // ---- cutoff with bisection width control ----------------------------
    const float v[5] = {new_step[0], new_step[1], new_step[2], new_step[3], new_stay};
    const float max_score = unordered(__reduce_max_sync(
        FULL, ordered(fmaxf(fmaxf(fmaxf(v[0], v[1]), fmaxf(v[2], v[3])), v[4]))));
    auto count_ge = [&](float cut) {
      return (int)__reduce_add_sync(FULL, (uint32_t)(v[0] >= cut) + (v[1] >= cut) + (v[2] >= cut) +
                                              (v[3] >= cut) + (v[4] >= cut));
    };
    float cutoff = __fsub_rn(max_score, log_beam_cut);
    int cnt = count_ge(cutoff);
    if (cnt > W) {
      float lo = cutoff, hi = max_score;
      bool done = false;
      for (int round = 0; round < 9 && !done; ++round) {
        if (round > 0) cnt = count_ge(cutoff);  // round 0 counts at the first cutoff again
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
    // ranks from one ballot a slot: the kept steps of lower lanes, then mine
    bool keep[4];
    int before = 0, total_steps = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      keep[b] = new_step[b] >= cutoff;
      const uint32_t bal = __ballot_sync(FULL, keep[b]);
      before += __popc(bal & lt_mask);
      total_steps += __popc(bal);
    }
    const bool keep_stay = new_stay >= cutoff;
    const uint32_t stay_ballot = __ballot_sync(FULL, keep_stay);
    const int n_kept = min(total_steps + __popc(stay_ballot), W);
    int rank = before;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      if (keep[b]) {
        if (rank < W)
          kept[rank] = make_int4(static_cast<int>(shifted | b) | lane << 16,
                                 static_cast<int>(step_hash[b]), __float_as_int(new_step[b]),
                                 __float_as_int(__fsub_rn(new_step[b], back_step[b])));
        ++rank;
      }
    }
    if (keep_stay) {
      const int r = total_steps + __popc(stay_ballot & lt_mask);
      if (r < W)
        kept[r] = make_int4(state | (lane | 0x80) << 16, static_cast<int>(hash),
                            __float_as_int(new_stay), __float_as_int(__fsub_rn(new_stay, stay_back)));
    }
    __syncwarp();
    int ps = 0;
    if (lane < n_kept) {
      const int4 kv = kept[lane];
      state = kv.x & 0xffff;
      ps = kv.x >> 16;
      hash = static_cast<uint32_t>(kv.y);
      raw = __int_as_float(kv.z);
      score = __int_as_float(kv.w);
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

// The traceback: from the best final element (the first of equal maxima),
// walking t from T-1 down to 0:
//   states[t] = hist_state[t][elem]; ps = hist_ps[t][elem];
//   moves[t] = (ps & 0x80) && t > 0 ? 0 : 1; elem = ps & 0x7F
// What bounds it on the H100: as K5's, a chain of T steps whose addresses
// are the previous step's result; the rows that hold the chain's next
// element are 160 bytes a step (34 MB at hac's shape, 10 us at 3.35 TB/s).
// The first version (one thread a row in blocks of 64, two dependent loads
// from device memory a step) took 0.603 ms at hac and 0.766 at sup (NVIDIA
// H100 80GB HBM3, 700 W).
// Design: K5's (crf_traceback.cu). One warp a row, alone in its block;
// chunk c, the steps T-32(c+1) .. T-1-32c, comes in as two TMA boxes (32
// steps of the row's state rows, 128 bytes each, and of its ps rows, 32
// bytes) into a ring of TB_STAGES stages, the box of the last chunk
// starting below t = 0, where TMA fills zeros. Every lane walks the chunk's
// chain, one shared-memory byte a step, and lane k then reads the state of
// the chunk's k-th step from its top beside its element, so the warp stores
// 32 states and 32 moves contiguously into the [N, T] outputs. Parents are
// below W: the element is masked to W - 1, which keeps any byte inside the
// stage. A step of the chain is one shared-memory load and one mask, 30
// cycles. Measured on the card and slower: each lane bringing its step's
// rows by its own two cp.async.bulk (0.125 ms at hac and 0.153 at sup,
// against 0.039 and 0.047).
constexpr int TB_STEPS = 32;
constexpr int TB_STAGES = 4;

__global__ void __launch_bounds__(W) beam_traceback_kernel(
    const __grid_constant__ CUtensorMap map_state,  // hist_state [T, N, W]: 32 steps of a row
    const __grid_constant__ CUtensorMap map_ps,     // hist_ps [T, N, W]: the same
    const float* __restrict__ final_score,          // [N, W]
    int32_t* __restrict__ states,                   // [N, T]
    uint8_t* __restrict__ moves,                    // [N, T]
    int T) {
  __shared__ __align__(128) int32_t ring_state[TB_STAGES][TB_STEPS][W];
  __shared__ __align__(128) uint8_t ring_ps[TB_STAGES][TB_STEPS][W];
  __shared__ __align__(8) uint64_t full[TB_STAGES];
  const int n = blockIdx.x;
  const int lane = threadIdx.x;
  const int chunks = (T + TB_STEPS - 1) / TB_STEPS;

  // lane 0: chunk c into stage c % TB_STAGES, row j the step T-32(c+1)+j
  auto fetch = [&](int c) {
    const int st = c % TB_STAGES;
    const uint32_t mb = smem_u32(&full[st]);
    const int t0 = T - TB_STEPS * (c + 1);
    mbar_expect(mb, TB_STEPS * W * 5);
    tma_load_4d(smem_u32(ring_state[st]), &map_state, 0, 0, n, t0, mb);
    tma_load_4d(smem_u32(ring_ps[st]), &map_ps, 0, 0, n, t0, mb);
  };
  if (lane == 0) {
    for (int st = 0; st < TB_STAGES; ++st) mbar_init(smem_u32(&full[st]), 1);
    mbar_init_fence();
    for (int c = 0; c < TB_STAGES && c < chunks; ++c) fetch(c);
  }
  __syncwarp();

  // the best final element, the first of equal maxima
  const float v = final_score[n * W + lane];
  const uint32_t at_max = __ballot_sync(FULL, v == warp_max(v));
  int elem = at_max ? __ffs(at_max) - 1 : 0;
  int32_t* st_row = states + (size_t)n * T;
  uint8_t* mv_row = moves + (size_t)n * T;
  for (int c = 0; c < chunks; ++c) {
    const int st = c % TB_STAGES;
    mbar_wait(smem_u32(&full[st]), (c / TB_STAGES) & 1);
    int my_elem = 0, my_ps = 0;
#pragma unroll
    for (int k = 0; k < TB_STEPS; ++k) {
      const int ps = ring_ps[st][TB_STEPS - 1 - k][elem];
      if (lane == k) {
        my_elem = elem;
        my_ps = ps;
      }
      elem = ps & (W - 1);
    }
    const int32_t state = ring_state[st][TB_STEPS - 1 - lane][my_elem];
    __syncwarp();
    if (lane == 0 && c + TB_STAGES < chunks) fetch(c + TB_STAGES);
    const int t = T - 1 - TB_STEPS * c - lane;
    if (t >= 0) {
      st_row[t] = state;
      mv_row[t] = ((my_ps & 0x80) && t > 0) ? 0 : 1;
    }
  }
}

template <int S>
int launch_forward(const float* scores, const float* beta, const int32_t* init_state,
                   int32_t* hist_state, uint8_t* hist_ps, float* final_score, int T, int N,
                   float log_beam_cut, float stay, cudaStream_t stream) {
  constexpr int smem = Ring<S>::BYTES;
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
  CUtensorMap map_state, map_ps;
  if (!make_history_map(&map_state, hist_state, 4, T, N, W, TB_STEPS) ||
      !make_history_map(&map_ps, hist_ps, 1, T, N, W, TB_STEPS))
    return static_cast<int>(cudaErrorInvalidValue);
  beam_traceback_kernel<<<N, W, 0, static_cast<cudaStream_t>(stream)>>>(
      map_state, map_ps, static_cast<const float*>(final_score), static_cast<int32_t*>(states),
      static_cast<uint8_t*>(moves), T);
  return static_cast<int>(cudaGetLastError());
}
