// LSTM recurrences, bf16 (or float32) in and out, f32 state.
//
//   lstm_scan_bf16 (K1): gates = xproj[t] + h @ W_hh^T, W_hh bf16;
//   lstm_fused_bf16 (K16): the whole layer, the input projection inside the
//     recurrence, gates = x[t] @ W_ih^T + h @ W_hh^T + bias, on K1's kernel;
//   lstm_scan_int8 (K15): the recurrence with W_hh int8 and h quantised to
//     int8, on K1's kernel with int8 elements;
//   lstm_scan_f32 (K1 float32): K1 with xproj, W_hh, h and out in float32,
//     on K1's kernel with float elements.
//
// K1 first, then K16, K15 and K1 float32 (the same kernel template), each
// with its note.
//
// Replaces dorado_tpu/ops/lstm.py::lstm_scan_time_major (Pallas body
// _lstm_kernel). Per step t (walked backwards when reverse != 0):
//   gates = xproj[t] + h @ W_hh^T      (gate order i, f, g, o)
//   c = sigmoid(f) * c + sigmoid(i) * tanh(g);  h = bf16(sigmoid(o) * tanh(c))
//
// What bounds it on the H100: T dependent steps, each of which needs all of
// W_hh ([H, 4H] bf16, 1.18 MB at hac's H = 384). That does not fit one SM's
// 227 KB of shared memory, and a design that reads it from L2 every step is
// bound by that traffic (the first version: 151 MB of L2 reads a step at
// N = 128, 17 us a step). The floor is the chain of steps: a product of
// [N, H] by [H, 4H], the cell update and the exchange of h, T times over.
//
// Design: W_hh resident in a thread-block cluster's shared memory. A cluster
// of C CTAs owns R batch rows (R = 8 NT: NT n-tiles of 8); CTA `rank` owns
// U hidden units (u0 = rank * U, U a multiple of 16, C * U >= H) with all
// four of their gate columns, so the cell update stays inside the CTA;
// units past H (whole CTAs, at some widths) hold zero weights and stay 0.
// The wrapper lays W_hh out as [C][4U][Kp] (Kp = C * U rounded up to 32,
// two k-tiles; row 4 jl + gate holds W_hh^T's column gate * H + u0 + jl, k
// past H zero), and each CTA copies its slice into shared memory once per
// launch: 147 KB at H = 384, C = 8. Per step:
//   1. the products on the tensor cores (mma.sync m16n8k16, bf16 in, f32
//      sums): the CTA's 4U gate rows are M (U / 4 m-tiles spread over its
//      warps, MTW each), the rows' h the N side, H the depth. A comes from
//      the resident slice, B from the CTA's full copy of h (ldmatrix, a pair
//      of k-tiles at a time, the next pair's fragments loaded before this
//      pair's products). Reading both from shared memory every step bounds
//      the step (24.6 KB a pair at 16 rows), so each warp keeps the A
//      fragments of as many pairs in registers for the whole launch as its
//      accumulators leave room for (reg_pairs: 8 of hac's 12 at 16 rows);
//   2. an m-tile holds the four gates of four units (row 4 jl + gate), so a
//      lane gathers the gates of one (unit, row) from three other lanes
//      with shuffles and updates c (registers) and h;
//   3. the CTA's new h slice is staged in shared memory and copied whole
//      into every peer's other h buffer by the bulk copy engine
//      (cp.async.bulk shared::cta -> shared::cluster, one copy a peer: h is
//      held as C blocks [R][U + 8], one for each CTA's slice, so a slice is
//      contiguous), each copy completing as transaction bytes on that
//      buffer's mbarrier in the peer; the step's output goes to global
//      memory, and the lane's x[t + 1] into registers;
//   4. no barrier: step t + 1 waits on its h buffer's mbarrier for the C
//      slices of its h. h and the staging are double buffered, and the
//      data order the rest: a peer sends step t + 2's h into the buffer step
//      t read only after it has all of step t + 1's h, and this CTA sent its
//      slice of that after its products of step t. A cluster barrier a step
//      would hold every CTA until the slowest arrived; here a CTA waits
//      only for the bytes it needs.
// Shared memory bounds C and R: the wrapper takes the smallest cluster
// whose slice fits (C = 8 at H = 384, 1 at fast's 96, 16 at 512, a
// non-portable size) and R from N over the clusters the card runs at once
// (cudaOccupancyMaxActiveClusters), at most 48 rows.
//
// ---------------------------------------------------------------------------
// K16: the whole layer, on K1's kernel (FUSED).
//
// Replaces dorado_tpu/ops/lstm.py::lstm_fused_time_major (Pallas body
// _lstm_fused_kernel). Per step t (walked backwards when reverse != 0):
//   gates = x[t] @ W_ih^T + h @ W_hh^T + bias      (float32 sums)
//   c = sigmoid(f) * c + sigmoid(i) * tanh(g);  h = bf16(sigmoid(o) * tanh(c))
// The input width is H, so both weights are [H, 4H].
//
// What bounds it on the H100: K1's chain of steps, plus a second product of
// the same size every step, and a second weight of 1.18 MB at H = 384. The
// first version read both weights from L2 every step, a block per batch row
// on the CUDA cores: 2.36 MB a block a step, 302 MB of L2 reads a step at
// N = 128, bound by L2 (35.9 us a step, 59.82 ms at T = 1666).
//
// Design: K1's cluster and W_hh slices, with x[t] in place of xproj[t]. The
// cluster's R rows of x[t] come into shared memory ([R][Kp + 8], double
// buffered, by cp.async two steps ahead: x is H wide, not 4H), and each CTA
// computes the input product of its gate rows, x[t + 1] @ W_ih_slice^T, on
// the tensor cores in the recurrent product's fragments, between sending
// step t's h slice and waiting for its peers' slices: the product does not
// depend on h, so it fills the exchange's latency, off the critical chain.
// Each lane keeps the sums of its own (gate row, batch row) pairs for the
// next step and adds them and the bias (registers, loaded once) to the
// recurrent sums. W_ih stays in L2: every step each CTA reads its slice
// (147 KB at H = 384, C = 8; 9.4 MB a step over the 64 CTAs of N = 128) in
// the order of the mma fragments (the wrapper's w_ih_fragments: a lane's 16
// bytes of an m-tile and k-tile contiguous, a warp's 512 bytes coalesced),
// straight into registers a pair of k-tiles ahead.
// The alternative, W_ih's slice resident beside W_hh's, needs a cluster of
// 16 CTAs of 24 units at H = 384 (6 warps a CTA, 16 peers to exchange with,
// 24 rows a cluster at most) and holds both weights only up to H = 432.
// Both designs were built and run side by side on the card (NVIDIA H100
// 80GB HBM3, 700 W): the resident one was no faster at N = 128 and slower
// at N = 512 (22 clusters of 16, 7 at a time, against 32 of 8 at 16 rows,
// 15 at a time), so it was dropped; nor did the reads of W_ih need chunks
// of several steps to hide at N = 128.
//
// ---------------------------------------------------------------------------
// K15: the recurrence with an int8 W_hh, on K1's kernel (W = int8_t).
//
// Replaces dorado_tpu/ops/lstm.py::lstm_scan_time_major_int8 (Pallas body
// _lstm_int8_kernel). Per step t (walked backwards when reverse != 0):
//   acc = h_i8 @ W_i8           (int32, exact)
//   gates = xproj[t] + acc * scale   (scale [4H]: the weight column's scale
//                                     over 127, the activations' static scale)
//   c = sigmoid(f) * c + sigmoid(i) * tanh(g);  h = sigmoid(o) * tanh(c)
//   out[t] = bf16(h);  h_i8 = round_half_even(h * 127)
//
// What bounds it on the H100: K1's chain of steps, on half the bytes (W_i8
// is 0.59 MB at H = 384). The first version gave each block 1-4 batch rows
// and every unit, read all of W_i8 from L2 every step into __dp4a products
// on the CUDA cores, and passed the partial int32 sums through shared memory
// between two barriers a step: 7.4 us a step, 12.29 ms at T = 1666, N = 128.
//
// Design: K1's kernel with int8 elements. The wrapper slices W_i8 as K1's
// W_hh ([C][4U][Kp], Kp = C * U rounded up to 64: a pair of k-tiles is 64
// bytes in either type), each CTA keeps its slice in shared memory, and the
// products run on mma.sync m16n8k32 (s8 in, s32 sums, exact in any order:
// |acc| <= H * 127^2 < 2^24). In bytes an int8 k-tile of 32 is a bf16
// k-tile of 16, so the ldmatrix addresses (in 16-byte chunks), the m-tiles
// and the accumulators' layout, and with them the cell update's gathering
// by shuffles, are K1's. A pair of k-tiles costs a warp 8 registers an
// m-tile in either type, and int32 sums as many as f32 ones, so reg_pairs
// holds for K15 as it stands; K15 adds only its 4 MTW scale registers
// (K16's bias registers) to K1's. But an int8 pair covers twice the depth,
// so the registers hold twice the slice: 6 pairs cover hac's H = 384, all
// of a warp's A at up to 16 rows with one m-tile a warp. h crosses the
// cluster as int8: each CTA stages round_half_even(h * 127) of its units,
// what the next product takes, and copies it to its peers as K1 copies its
// bf16 h (half of K1's bytes); out[t] = bf16(h) goes from the lane's
// registers to global memory. The cell update is the first version's
// operation for operation: the gate's multiply and add and the cell
// update's products and sum are separately rounded (__fmul_rn, __fadd_rn),
// so that no FMA contraction moves a value across an int8 rounding boundary
// of h, and __float2int_rn rounds h * 127 half to even, as torch.round does.
// The plan is K1's clusters and its rule for rows a cluster, fitted to the
// int8 shared memory (k1_plan with elem_bytes = 1): clusters of 8 at hac's H.
// The int8 slices fit in clusters of 4 too (96 units, two m-tiles a warp,
// 2-4 of 6 pairs in registers); measured on the card (NVIDIA H100 80GB
// HBM3, 700 W) they took 4.094 ms against 4.243 at T = 1666, N = 128 and
// 10.073 against 9.795 at N = 512: within 4% either way, so K15 keeps K1's.
// One template rather than a second copy of the cluster machinery: the
// element type changes the strides, the mma and the cell update's last
// lines, not the exchange, the barriers, the register ring or the plan.
//
// ---------------------------------------------------------------------------
// K1 float32: the recurrence in float32, on K1's kernel (W = float).
//
// Replaces dorado_tpu/ops/lstm.py::lstm_scan_time_major fed float32 xproj
// and W_hh, as the modified-base models run it (dorado_tpu/modbase/model.py
// _lstm, through models/crf_model.py lstm_layer). Per step, K1's, with h and
// out in float32: out[t] = h = sigmoid(o) * tanh(c).
//
// What bounds it on the H100: K1's chain of steps, with twice K1's bytes
// (W_hh is 1 MiB at the modbase models' H = 256) and float32 products. At
// the modbase shapes a launch is short: T = 32 steps (a chunk of 192
// samples at stride 6), so the copy of W's slices into shared memory, once a
// launch, is a large part of it.
//
// Design: K1's kernel with float elements. In bytes a tf32 k-tile of 8 is a
// bf16 k-tile of 16 and its mma fragments are bf16's, so the slices, the
// ldmatrix addresses, the m-tiles, the accumulators' layout and the cell
// update's gathering by shuffles are K1's; a CTA's units are a multiple of 8
// (whole float32 k-tiles). Shared memory doubles: clusters of 8 CTAs of 32
// units at H = 256 (133 KB of W a CTA, at most 32 rows a cluster), of 16
// CTAs of 24 units at hac's 384 (149 KB, at most 16 rows); no cluster of up
// to 16 CTAs holds W above H = 384, where the wrapper refuses.
// The products must be float32 in effect: the JAX package sums float32
// products (its Pallas kernel matches lax.scan at 2e-4), and TF32 alone keeps
// 10 bits of mantissa, about three decimal digits. So each product runs in
// 3xTF32: each operand x is split into hi = tf32(x) and lo = tf32(x - hi),
// and a_lo b_hi + a_hi b_lo + a_hi b_hi go to three mma.sync m16n8k8 tf32
// into the float32 sums; the dropped a_lo b_lo and lo's own rounding leave
// about 2^-21 of each product. FFMA on the CUDA cores would be exact, but
// needs another product loop than K1's fragments; 3xTF32 keeps the template
// whole, at three mma a k-tile and the splits (every step, of W's fragments
// too). The splits' registers come out of those that hold W's fragments:
// with K1's count of register pairs (reg_pairs) its launches spilled and took
// 1.3-2x as long as with what two more n-tiles leave (0.317 against 0.207 ms
// at T = 32, N = 128, H = 256; 38.5 against 28.0 ms at T = 1666, N = 128, H =
// 384; NVIDIA H100 80GB HBM3, 700 W), and holding none in registers was no
// faster than that. h crosses the cluster as float32, twice K1's bytes. No
// int8 or bf16 rounding follows the cell update, so K15's separately rounded
// operations are not needed. chip_smoke.py holds it against the plain
// version within 1e-4 (TOL_LSTM_F32). The plan is K1's rule (k1_plan with
// elem_bytes = 4): the card runs 15 clusters of 8 at H = 256, so N = 128
// takes 8 clusters of 16 rows, one wave, and N = 1024 32 clusters of 32, the
// most shared memory holds, in three waves.
//
// ---------------------------------------------------------------------------
// The wide form: K1 and K1 float32 where no cluster holds W_hh (WIDE).
//
//   lstm_scan_wide_bf16 / lstm_scan_wide_f32: lstm_scan_bf16's and
//   lstm_scan_f32's function at widths where no cluster of up to 16 CTAs holds
//   its W_hh slices (bf16 above H = 512, float32 above 384): the LSTM-sup
//   class, H = 768 (W_hh 4.72 MB in bf16, 9.44 MB in float32), and up to 1024.
//
// What bounds it on the H100: K1's chain of steps, with every step needing
// more of W than the cluster's shared memory holds (16 CTAs hold 3.72 MB).
// All of W fits the 50 MB L2 many times over, so the part that does not stay
// resident is read from L2 every step: its latency is in each step's chain,
// its bytes (times the clusters in flight, which all read the same slices)
// in L2's bandwidth.
//
// Design: K1's kernel, clusters of 16 CTAs of U units (48 at H = 768, 64 at
// 1024), with W's pairs of k-tiles split three ways per CTA: pairs [0, kr)
// held in registers for the whole launch (loaded once from L2), pairs
// [kr, ks) resident in shared memory (as much as is left after h's buffers at
// the plan's rows), pairs [ks, Kp / 2) streamed from L2 every step as mma A
// fragments (the layout of K16's W_ih: a lane's 16 bytes of an m-tile and
// k-tile contiguous, a warp's 512 bytes coalesced). The wrapper hands over
// the resident part [C][4U][2 KT (ks - kr)] and the fragments of the other
// pairs [C][U / 4][k-tiles][32 lanes] x 16 bytes (wide_w_hh). The streamed
// reads do not depend on h: each step issues the first SD of them (a ring of
// SD pairs of registers: 4 with one m-tile a warp, 2 with two) before it
// waits for its peers' h slices, so their latency hides behind the exchange;
// after the wait the streamed pairs come first, each ring slot refilled SD
// pairs ahead, then the resident pairs, then the register pairs. The ring
// takes its registers out of those K1 gives its register pairs (with one
// m-tile a warp, two pairs fewer). h, its exchange, the cell update and the
// plan's rule for rows are K1's; at float32 the products are K1 float32's
// 3xTF32. Nothing is int8: K1's bf16 parity holds. The resident form's
// instantiations compile without any of this (WIDE is a template flag), so
// at the widths a cluster holds nothing changes.
#include <type_traits>

#include "common.cuh"

__device__ __forceinline__ float sigmoidf_(float x) { return 1.f / (1.f + expf(-x)); }

namespace k1 {

constexpr int SMEM_MAX = 232448;  // dynamic shared memory a block can have
constexpr int MAX_WARPS = 12;
constexpr int MAX_NT = 6;
// the launches of the template: K1, K16 (FUSED), K15 (int8), K1 float32 and
// the wide forms of K1 and K1 float32 (WIDE)
constexpr int KIND_K1 = 0, KIND_K16 = 1, KIND_K15 = 2, KIND_K1F = 3, KIND_K1W = 4, KIND_K1FW = 5;

template <typename V>
__device__ __forceinline__ V pick4(V a, V b, V c, V d, int i) {
  return i == 0 ? a : i == 1 ? b : i == 2 ? c : d;
}

// A float split into a tf32 high part and the tf32 rounding of the rest
__device__ __forceinline__ void split_tf32(uint32_t x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(__uint_as_float(x));
  lo = to_tf32(__uint_as_float(x) - __uint_as_float(hi));
}

// c += a . b in 3xTF32 (K1 float32, see its note): a_lo b_hi + a_hi b_lo +
// a_hi b_hi, the small terms first
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                           uint32_t b1) {
  uint32_t ah[4], al[4], bh0, bl0, bh1, bl1;
#pragma unroll
  for (int e = 0; e < 4; ++e) split_tf32(a[e], ah[e], al[e]);
  split_tf32(b0, bh0, bl0);
  split_tf32(b1, bh1, bl1);
  mma_tf32(c, al, bh0, bh1);
  mma_tf32(c, ah, bl0, bl1);
  mma_tf32(c, ah, bh0, bh1);
}

// c += a . b by the sums' and the elements' type: exact int32 sums of int8
// (K15), f32 sums of float32 in 3xTF32 (K1 float32), else of bf16 (K1, K16,
// and K16's input product, which the other kinds compile but never run)
template <typename W, typename Acc>
__device__ __forceinline__ void mma(Acc (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  if constexpr (std::is_same_v<Acc, int>)
    mma_s8(c, a, b0, b1);
  else if constexpr (std::is_same_v<W, float>)
    mma_3xtf32(c, a, b0, b1);
  else
    mma_bf16(c, a, b0, b1);
}

// The type of xproj and out: float32 for K1 float32, else bf16
template <typename W>
using io_t = std::conditional_t<std::is_same_v<W, float>, float, __nv_bfloat16>;

__device__ __forceinline__ float2 to_float2(__nv_bfloat162 v) { return __bfloat1622float2(v); }
__device__ __forceinline__ float2 to_float2(float2 v) { return v; }

template <typename T>
__device__ __forceinline__ T from_float(float v) {
  if constexpr (std::is_same_v<T, float>)
    return v;
  else
    return __float2bfloat16(v);
}

// Sizes in elements of `es` bytes (2: bf16, 1: int8, 4: float32).
// The depth of the products: Hp rounded up to a pair of k-tiles, 64 bytes.
__host__ __device__ constexpr int depth(int hp, int es) { return (hp * es + 63) / 64 * 64 / es; }

// The row stride of h's blocks: U and 16 bytes, or U alone where its 16-byte
// chunks are odd in number, so that ldmatrix's eight rows fall in distinct
// banks.
__host__ __device__ constexpr int h_stride(int units, int es) {
  return (units * es / 16 | 1) * 16 / es;
}

// h as blocks of U units, one for each CTA's slice (and zero ones to the
// depth): [blocks][R][h_stride].
__host__ __device__ constexpr int h_blocks(int units, int cluster, int es) {
  return (depth(cluster * units, es) + units - 1) / units;
}

// Shared memory of one CTA, in bytes: the W slice (rows of depth + 16
// bytes), two h buffers (the cluster's R rows, all units), two stagings of
// the CTA's new h slice, with K16 two x buffers [R][depth + 8], and the two
// h buffers' mbarriers.
__host__ __device__ constexpr int smem_bytes(int units, int cluster, int rows, bool fused,
                                             int es) {
  return es * (4 * units * (depth(cluster * units, es) + 16 / es) +
               2 * (h_blocks(units, cluster, es) + 1) * rows * h_stride(units, es) +
               (fused ? 2 * rows * (depth(cluster * units, es) + 16 / es) : 0)) +
         16;
}

// Pairs of k-tiles whose A fragments (the W_hh slice) a warp keeps in
// registers for the whole launch, by what the accumulators of MTW m-tiles
// and NT n-tiles leave of 168 registers a thread (12 warps); the rest come
// from shared memory every step. K16 also carries the next step's input
// sums: it keeps what one more n-tile would leave. K1 float32 splits every
// fragment into tf32 parts as it uses it: it keeps what two more n-tiles
// would leave (see its note). A pair is 8 registers an m-tile in bf16, in
// int8 (K15: see its note) and in float32.
__host__ __device__ constexpr int reg_pairs(int mtw, int nt) {
  return mtw == 1 ? (nt == 1 ? 12 : nt == 2 ? 8 : nt == 3 ? 4 : nt == 4 ? 2 : 0)
                  : (nt == 1 ? 4 : nt == 2 ? 2 : 0);
}

// The wide form's ring of streamed pairs (see its note): 4 pairs with one
// m-tile a warp where the register pairs leave room, else 2 (the registers
// of the resident loop's two pairs); and the register pairs it keeps.
__host__ __device__ constexpr int ring_depth(int mtw, int rp) {
  return mtw == 1 && rp >= 2 ? 4 : 2;
}
__host__ __device__ constexpr int wide_reg_pairs(int mtw, int rp) {
  return rp - (ring_depth(mtw, rp) - 2);
}

// The wide form's shared memory: `res` resident pairs of k-tiles of each of
// the 4U rows (and 16 bytes), h's buffers and stagings as K1's, mbarriers.
__host__ __device__ constexpr int smem_bytes_wide(int units, int cluster, int rows, int res,
                                                  int es) {
  return es * (4 * units * (res * 64 / es + 16 / es) +
               2 * (h_blocks(units, cluster, es) + 1) * rows * h_stride(units, es)) +
         16;
}

// W: the element of W and h (bf16: K1, K16; int8: K15; float: K1 float32);
// MTW m-tiles a warp, NT n-tiles (R = 8 NT rows a cluster); FUSED: K16;
// WIDE: the wide form (pairs [ks, Kp / 2) streamed from w_frag).
template <typename W, int MTW, int NT, bool FUSED, bool WIDE>
__global__ void __launch_bounds__(MAX_WARPS * 32, 1)
    lstm_cluster_kernel(const io_t<W>* __restrict__ xin,  // xproj [T, N, 4H] or x [T, N, H]
                        const W* __restrict__ w_sl,       // [C][4U][depth] W_hh^T slices (WIDE:
                                                          // the resident pairs' columns)
                        const void* __restrict__ w_frag,  // K16: W_ih^T's fragments; WIDE:
                                                          // W_hh^T's of the other pairs
                        const float* __restrict__ gate_vec,  // [4H]: K16's bias, K15's scale
                        io_t<W>* __restrict__ out,           // [T, N, H]
                        int T, int N, int H, int C, int U, int reverse, int ks) {
  constexpr bool INT8 = std::is_same_v<W, int8_t>;
  constexpr bool F32 = std::is_same_v<W, float>;
  static_assert(!((INT8 || F32) && FUSED), "K16 runs in bf16");
  static_assert(!((INT8 || FUSED) && WIDE), "the wide form is K1's and K1 float32's");
  using IO = io_t<W>;
  // elements of a 16-byte chunk (an ldmatrix row) and of a k-tile (32 bytes)
  constexpr int ES = sizeof(W), CH = 16 / ES, KT = 32 / ES;
  using Acc = std::conditional_t<INT8, int, float>;
  constexpr int R = 8 * NT;
  // pairs of k-tiles of W_hh's A fragments a warp keeps in registers (see
  // reg_pairs), and the wide form's ring of streamed pairs
  constexpr int RP = reg_pairs(MTW, F32 ? NT + 2 : FUSED ? NT + 1 : NT);
  constexpr int KR = WIDE ? wide_reg_pairs(MTW, RP) : RP;
  constexpr int SD = ring_depth(MTW, RP);
  static_assert(KR % 2 == 0, "the register pairs are taken two at a time");
  extern __shared__ __align__(16) unsigned char smem[];
  const int hk = depth(C * U, ES), hs = hk + CH;  // the products' depth; row stride of x
  const int kp_n = hk / (2 * KT);                 // pairs of k-tiles
  const int kr_n = min(KR, kp_n);                 // pairs [0, kr_n) in registers
  // pairs [k_lo, k_hi) resident in shared memory, in rows of ws
  const int k_lo = WIDE ? kr_n : 0, k_hi = WIDE ? ks : kp_n;
  const int wl = (k_hi - k_lo) * 2 * KT, ws = wl + CH;
  const int up = h_stride(U, ES), hb = h_blocks(U, C, ES);  // row stride of h's blocks, blocks
  const int h_elems = hb * R * up;                    // one h buffer
  W* w_s = reinterpret_cast<W*>(smem);                // [4U][ws]
  W* h_s = w_s + 4 * U * ws;                          // [2][hb][R][up]
  W* st_s = h_s + 2 * h_elems;                        // [2][R][up]
  __nv_bfloat16* x_s = reinterpret_cast<__nv_bfloat16*>(st_s + 2 * R * up);  // K16: [2][R][hs]
  const uint32_t mbar0 = smem_u32(x_s + (FUSED ? 2 * R * hs : 0));  // [2] 8-byte mbarriers
  const int slice_bytes = R * up * ES;  // one CTA's h block: what a phase takes from each peer

  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31, nwarps = nthreads >> 5;
  const int g = lane >> 2, t4 = lane & 3, q = g & 3;
  const uint32_t rank = cluster_rank();
  const int u0 = rank * U;
  const int n0 = (blockIdx.x / C) * R;
  const int G = 4 * H;
  auto time_of = [&](int step) { return reverse ? T - 1 - step : step; };

  // ---- once per launch: the W slice, zeroed h (and x) buffers ---------------
  {
    const uint4* src = reinterpret_cast<const uint4*>(w_sl + (size_t)rank * 4 * U * wl);
    const int per_row = wl / CH;
    for (int i = tid; i < 4 * U * per_row; i += nthreads) {
      const int r = i / per_row, c = i % per_row;
      *reinterpret_cast<uint4*>(w_s + r * ws + c * CH) = src[i];
    }
    const uint4 zero = make_uint4(0, 0, 0, 0);
    uint4* hz = reinterpret_cast<uint4*>(h_s);
    for (int i = tid; i < 2 * h_elems / CH; i += nthreads) hz[i] = zero;
    uint4* xz = reinterpret_cast<uint4*>(x_s);
    for (int i = tid; i < (FUSED ? 2 * R * hs / 8 : 0); i += nthreads) xz[i] = zero;
  }
  // h buffer b's mbarrier: h of step j lands in buffer j & 1, phase (j - 1)
  // / 2 there, as C slices. h of step 0 is the zeros above; the phases of
  // steps 1 and 2 are armed here, each later one once its buffer's previous
  // phase has been waited for
  if (tid == 0) {
    mbar_init(mbar0, 1);
    mbar_init(mbar0 + 8, 1);
    mbar_init_fence();
    if (T > 1) mbar_expect(mbar0 + 8, C * slice_bytes);
    if (T > 2) mbar_expect(mbar0, C * slice_bytes);
  }
  // The lane's cell updates: m-tile warp + i * nwarps, n-tile nt; it takes
  // the (unit, row) combination number q of the lane group that shares g / 4
  // and t4 (see step 2). K1, K15: their xproj[t] (gates i | f and g | o) are
  // loaded into registers a step ahead; rows past N and units past H stay
  // zero. K16: their bias, K15: their scale, once.
  std::conditional_t<F32, float2, __nv_bfloat162> x[MTW][NT][2];
  float bg[MTW][4];
  auto unit_of = [&](int i) { return u0 + 4 * (warp + i * nwarps) + (g >> 2) + 2 * (q >> 1); };
  auto load_xproj = [&](int t) {
#pragma unroll
    for (int i = 0; i < MTW; ++i) {
      const int unit = unit_of(i);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int row = n0 + nt * 8 + 2 * t4 + (q & 1);
        const bool ok = row < N && unit < H;
        const IO* src = xin + ((size_t)t * N + (ok ? row : 0)) * G + (ok ? unit : 0);
        const IO zero = from_float<IO>(0.f);
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          x[i][nt][p].x = ok ? src[2 * p * H] : zero;
          x[i][nt][p].y = ok ? src[(2 * p + 1) * H] : zero;
        }
      }
    }
  };
  // K16: the cluster's rows of x[t] into x buffer b, 8 bytes a copy (H is a
  // multiple of 4); k past H and rows past N keep the zeros above
  auto load_x = [&](int t, int b) {
    const int per_row = H / 4;
    __nv_bfloat16* dst = x_s + b * R * hs;
    for (int i = tid; i < R * per_row; i += nthreads) {
      const int r = i / per_row, c = (i - r * per_row) * 4;
      if (n0 + r < N) cp_async8(dst + r * hs + c, xin + ((size_t)t * N + n0 + r) * H + c);
    }
    cp_async_commit();
  };
  if constexpr (FUSED || INT8) {
#pragma unroll
    for (int i = 0; i < MTW; ++i) {
      const int unit = unit_of(i);
#pragma unroll
      for (int gate = 0; gate < 4; ++gate)
        bg[i][gate] = unit < H ? gate_vec[gate * H + unit] : 0.f;
    }
  }
  if constexpr (FUSED) {
    __syncthreads();  // the zeros are written before any copy lands
    load_x(time_of(0), 0);
    if (T > 1) load_x(time_of(1), 1);
    cp_async_wait<0>();
  } else {
    load_xproj(time_of(0));
  }
  cluster_sync();  // every CTA of the cluster has zeroed its h and armed its mbarriers

  float c_state[MTW][NT];
#pragma unroll
  for (int i = 0; i < MTW; ++i)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) c_state[i][nt] = 0.f;
  const int cu = U / CH;           // 16-byte chunks in a row of a block of h
  const float inv_cu = 1.f / cu;
  const W* a_row = w_s + (warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * ws + (lane >> 4) * CH;
  auto load_a = [&](int kp, uint32_t (&a)[MTW][2][4]) {
#pragma unroll
    for (int i = 0; i < MTW; ++i)
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2)
        ldmatrix_x4(a[i][h2], a_row + i * nwarps * 16 * ws + (2 * (kp - k_lo) + h2) * KT);
  };
  // A from L2 as mma fragments, [C][U / 4][k-tiles][32 lanes] x 16 bytes:
  // K16's W_ih (every k-tile), the wide form's W_hh (the k-tiles of the pairs
  // that are not resident, in order)
  const int skip = WIDE ? k_hi - k_lo : 0;  // pairs absent from the fragments
  const int nf = 2 * (kp_n - skip);         // k-tiles an m-tile
  auto load_a_l2 = [&](int kp, uint32_t (&a)[MTW][2][4]) {
    const uint4* frag = reinterpret_cast<const uint4*>(w_frag);
    const int kf = 2 * (kp < k_lo ? kp : kp - skip);
#pragma unroll
    for (int i = 0; i < MTW; ++i)
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const uint4 v = __ldg(
            frag + (((size_t)rank * (U / 4) + warp + i * nwarps) * nf + kf + h2) * 32 + lane);
        a[i][h2][0] = v.x;
        a[i][h2][1] = v.y;
        a[i][h2][2] = v.z;
        a[i][h2][3] = v.w;
      }
  };
  // pairs [0, kr_n) of W_hh's A fragments in registers, read from the slice
  // that the cluster barrier above made visible (the wide form: from L2)
  uint32_t w_reg[KR > 0 ? KR : 1][MTW][2][4];
#pragma unroll
  for (int p = 0; p < KR; ++p) {
    if (p < kr_n) {
      if constexpr (WIDE)
        load_a_l2(p, w_reg[p]);
      else
        load_a(p, w_reg[p]);
    }
  }

  // acc += A . B over a pair of k-tiles. With one m-tile a warp the two
  // accumulators are the pair's two k-tiles, with two they are the two m-tiles
  auto mma_pair = [&](auto& acc, const uint32_t (&a)[MTW][2][4], const uint32_t (&b)[NT][4]) {
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2)
#pragma unroll
      for (int i = 0; i < MTW; ++i)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          mma<W>(acc[MTW == 1 ? h2 : i][nt], a[i][h2], b[nt][2 * h2], b[nt][2 * h2 + 1]);
  };
  // K16: x[t + 1] @ W_ih_slice^T from x buffer xb, as the lane's sums; B as
  // in the recurrent product below, from x's rows
  auto input_product = [&](int xb, float (&xg)[MTW][NT][4]) {
    float xa[2][NT][4];
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) xa[a][nt][e] = 0.f;
    const __nv_bfloat16* xb_base = x_s + xb * R * hs + (lane & 7) * hs + ((lane >> 3) & 1) * 8;
    auto load_bx = [&](int kp, uint32_t (&b)[NT][4]) {
      const __nv_bfloat16* p = xb_base + (2 * kp + (lane >> 4)) * 16;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) ldmatrix_x4(b[nt], p + nt * 8 * hs);
    };
    // the pairs in order, the next pair's fragments loaded before this pair's
    // products (as the recurrent product's loop below)
    uint32_t a0[MTW][2][4], a1[MTW][2][4], b0[NT][4], b1[NT][4];
    load_a_l2(0, a0);
    load_bx(0, b0);
    int kp = 0;
    for (; kp + 2 <= kp_n; kp += 2) {
      load_a_l2(kp + 1, a1);
      load_bx(kp + 1, b1);
      mma_pair(xa, a0, b0);
      if (kp + 2 < kp_n) {
        load_a_l2(kp + 2, a0);
        load_bx(kp + 2, b0);
      }
      mma_pair(xa, a1, b1);
    }
    if (kp < kp_n) mma_pair(xa, a0, b0);
#pragma unroll
    for (int i = 0; i < MTW; ++i)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          xg[i][nt][e] = MTW == 1 ? xa[0][nt][e] + xa[1][nt][e] : xa[i][nt][e];
  };
  float xg[MTW][NT][4];  // K16: the input sums of this step
  if constexpr (FUSED) input_product(0, xg);

  for (int step = 0; step < T; ++step) {
    const int t = time_of(step);
    const int buf = step & 1;
    // the wide form: the first SD streamed pairs' fragments, in flight while
    // the h slices come in (they do not depend on h)
    uint32_t ring[WIDE ? SD : 1][MTW][2][4];
    const int ns = kp_n - k_hi;  // streamed pairs (the wide form)
    if constexpr (WIDE) {
#pragma unroll
      for (int s = 0; s < SD; ++s)
        if (s < ns) load_a_l2(k_hi + s, ring[s]);
    }
    if (step > 0) {
      mbar_wait(mbar0 + 8 * buf, ((step - 1) >> 1) & 1);  // every slice of this step's h
      if (tid == 0 && step + 2 < T) mbar_expect(mbar0 + 8 * buf, C * slice_bytes);
    }

    // 1. acc = W_slice . h, a pair of k-tiles at a time, the next pair's
    //    fragments loaded before this pair's products: first the pairs whose
    //    A comes from shared memory, then those held in registers (the wide
    //    form: the streamed pairs before both, each ring slot refilled SD
    //    pairs ahead)
    Acc acc[2][NT][4];
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[a][nt][e] = 0;
    // B: rows nt * 8 .. + 7 of h, four 16-byte chunks of k a pair (ldmatrix's
    //    matrix lane / 8 takes chunk 4 kp + lane / 8: the halves of the first
    //    k-tile, then of the second), each chunk inside one block of U units:
    //    block c / (U / CH) (a float product, exact at these sizes), chunk
    //    c % (U / CH) there
    const W* b_base = h_s + buf * h_elems + (lane & 7) * up;
    auto load_b = [&](int kp, uint32_t (&b)[NT][4]) {
      const int c = 4 * kp + (lane >> 3);
      const int blk = __float2int_rz((c + 0.5f) * inv_cu);
      const W* p = b_base + blk * R * up + (c - blk * cu) * CH;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) ldmatrix_x4(b[nt], p + nt * 8 * up);
    };
    if constexpr (WIDE) {
      for (int j0 = 0; j0 < ns; j0 += SD) {
#pragma unroll
        for (int s = 0; s < SD; ++s) {
          const int j = j0 + s;
          if (j < ns) {
            uint32_t b[NT][4];
            load_b(k_hi + j, b);
            mma_pair(acc, ring[s], b);
            if (j + SD < ns) load_a_l2(k_hi + j + SD, ring[s]);
          }
        }
      }
    }
    {
      uint32_t a0[MTW][2][4], a1[MTW][2][4], b0[NT][4], b1[NT][4];
      int kp = kr_n;
      if (kp < k_hi) {
        load_a(kp, a0);
        load_b(kp, b0);
      }
      for (; kp + 2 <= k_hi; kp += 2) {
        load_a(kp + 1, a1);
        load_b(kp + 1, b1);
        mma_pair(acc, a0, b0);
        if (kp + 2 < k_hi) {
          load_a(kp + 2, a0);
          load_b(kp + 2, b0);
        }
        mma_pair(acc, a1, b1);
      }
      if (kp < k_hi) mma_pair(acc, a0, b0);
      if (kr_n > 0) load_b(0, b0);
#pragma unroll
      for (int p = 0; p < KR; p += 2) {
        if (p < kr_n) {
          if (p + 1 < kr_n) load_b(p + 1, b1);
          mma_pair(acc, w_reg[p], b0);
          if (p + 2 < kr_n) load_b(p + 2, b0);
          if (p + 1 < kr_n) mma_pair(acc, w_reg[p + 1], b1);
        }
      }
    }

    // 2. cell update: lane (g, t4) holds rows g, g + 8 of an m-tile (units
    //    g / 4 and 2 + g / 4 of its four, gate q = g % 4) at rows 2 t4,
    //    2 t4 + 1; it takes the (unit, row) combination number q and fetches
    //    that combination's other three gates from lanes 4, 8, 12 away
#pragma unroll
    for (int i = 0; i < MTW; ++i) {
      const int mt = warp + i * nwarps;
      const int jl = 4 * mt + (g >> 2) + 2 * (q >> 1);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        Acc v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          v[e] = MTW == 1 ? acc[0][nt][e] + acc[1][nt][e] : acc[i][nt][e];
          if constexpr (FUSED) v[e] += xg[i][nt][e];
        }
        const Acc r0 = pick4(v[0], v[1], v[2], v[3], q);
        const Acc r1 = __shfl_xor_sync(0xffffffffu, pick4(v[0], v[1], v[2], v[3], q ^ 1), 4);
        const Acc r2 = __shfl_xor_sync(0xffffffffu, pick4(v[0], v[1], v[2], v[3], q ^ 2), 8);
        const Acc r3 = __shfl_xor_sync(0xffffffffu, pick4(v[0], v[1], v[2], v[3], q ^ 3), 12);
        const int row = nt * 8 + 2 * t4 + (q & 1);
        // gate k of the combination came from the lane with q ^ k: r[k ^ q]
        const Acc si = pick4(r0, r1, r2, r3, q), sf = pick4(r0, r1, r2, r3, q ^ 1);
        const Acc sg = pick4(r0, r1, r2, r3, q ^ 2), so = pick4(r0, r1, r2, r3, q ^ 3);
        float& c = c_state[i][nt];
        if constexpr (INT8) {
          // separately rounded, as the plain version: gates = x + acc * scale
          const float2 xif = __bfloat1622float2(x[i][nt][0]);
          const float2 xgo = __bfloat1622float2(x[i][nt][1]);
          const float gi = __fadd_rn(xif.x, __fmul_rn((float)si, bg[i][0]));
          const float gf = __fadd_rn(xif.y, __fmul_rn((float)sf, bg[i][1]));
          const float gg = __fadd_rn(xgo.x, __fmul_rn((float)sg, bg[i][2]));
          const float go = __fadd_rn(xgo.y, __fmul_rn((float)so, bg[i][3]));
          c = __fadd_rn(__fmul_rn(sigmoidf_(gf), c), __fmul_rn(sigmoidf_(gi), tanhf(gg)));
          const float h = sigmoidf_(go) * tanhf(c);
          st_s[(buf * R + row) * up + jl] = static_cast<int8_t>(__float2int_rn(h * 127.f));
          if (n0 + row < N && u0 + jl < H)
            out[((size_t)t * N + n0 + row) * H + u0 + jl] = __float2bfloat16(h);
        } else {
          float base[4];  // xproj[t]'s gates (K1) or the bias (K16)
          if constexpr (FUSED) {
#pragma unroll
            for (int gate = 0; gate < 4; ++gate) base[gate] = bg[i][gate];
          } else {
            const float2 xif = to_float2(x[i][nt][0]);
            const float2 xgo = to_float2(x[i][nt][1]);
            base[0] = xif.x;
            base[1] = xif.y;
            base[2] = xgo.x;
            base[3] = xgo.y;
          }
          const float gi = base[0] + si, gf = base[1] + sf, gg = base[2] + sg, go = base[3] + so;
          c = sigmoidf_(gf) * c + sigmoidf_(gi) * tanhf(gg);
          st_s[(buf * R + row) * up + jl] = from_float<W>(sigmoidf_(go) * tanhf(c));
        }
      }
    }
    if constexpr (FUSED) cp_async_wait<0>();  // this thread's copies of x[t + 1]
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // for the bulk copies
    __syncthreads();  // the CTA's new h slice is staged (K16: x[t + 1] is in)

    // 3. the slice's rows into every peer's other h buffer (the bulk copy
    //    engine, completing on the peer's mbarrier), and out[t] (K15 wrote
    //    it above). Nothing else orders the steps: a peer copies step t + 2's
    //    h into the buffer step t read only once it has all of step t + 1's
    //    h, this CTA's slice included, which this CTA copied after its
    //    products of step t; and the staging written at step t + 2 was read
    //    by copies that had to land before any peer could send step t + 2's h
    const W* st = st_s + buf * R * up;
    if (step + 1 < T && tid < C) {
      const uint32_t next = smem_u32(h_s + (buf ^ 1) * h_elems + rank * R * up);
      bulk_copy_cluster(map_rank(next, tid), smem_u32(st), slice_bytes,
                        map_rank(mbar0 + 8 * (buf ^ 1), tid));
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    }
    if constexpr (!INT8) {
      using V4 = std::conditional_t<F32, uint4, uint2>;  // four elements
      const int per_row4 = U / 4;
      for (int i = tid; i < R * per_row4; i += nthreads) {
        const int r = i / per_row4, j4 = (i % per_row4) * 4;
        if (n0 + r < N && u0 + j4 < H)
          *reinterpret_cast<V4*>(out + ((size_t)t * N + n0 + r) * H + u0 + j4) =
              *reinterpret_cast<const V4*>(st + r * up + j4);
      }
    }
    if constexpr (FUSED) {
      // x[t + 2] into the buffer that held x[t], which every warp finished
      // with (last step's input product) before the barrier above; then the
      // input product of step t + 1 while the peers' slices come in
      if (step + 2 < T) load_x(time_of(step + 2), buf);
      if (step + 1 < T) input_product(buf ^ 1, xg);
    } else {
      if (step + 1 < T) load_xproj(time_of(step + 1));
    }
  }
  // every copy out of this CTA has landed; no CTA leaves while a peer may
  // still write into it
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  cluster_sync();
}

template <typename W, int MTW, int NT, bool FUSED, bool WIDE>
int launch_k1(const void* xin, const void* w_sl, const void* w_frag, const void* gate_vec,
              void* out, int T, int N, int H, int C, int U, int reverse, int ks,
              cudaStream_t stream, int* active) {
  auto kernel = lstm_cluster_kernel<W, MTW, NT, FUSED, WIDE>;
  constexpr int ES = sizeof(W);
  constexpr int RP = reg_pairs(MTW, ES == 4 ? NT + 2 : FUSED ? NT + 1 : NT);
  const int kp_n = depth(C * U, ES) * ES / 64;
  const int kr_n = min(WIDE ? wide_reg_pairs(MTW, RP) : RP, kp_n);
  if (WIDE && (ks < kr_n || ks > kp_n)) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = WIDE ? smem_bytes_wide(U, C, 8 * NT, ks - kr_n, ES)
                        : smem_bytes(U, C, 8 * NT, FUSED, ES);
  if (smem > SMEM_MAX) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (C > 8) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int warps = U / 4 / MTW;
  const int clusters = (N + 8 * NT - 1) / (8 * NT);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters * C);
  cfg.blockDim = dim3(warps * 32);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (active != nullptr)
    return static_cast<int>(cudaOccupancyMaxActiveClusters(active, (void*)kernel, &cfg));
  e = cudaLaunchKernelEx(&cfg, kernel, static_cast<const io_t<W>*>(xin),
                         static_cast<const W*>(w_sl), w_frag,
                         static_cast<const float*>(gate_vec), static_cast<io_t<W>*>(out), T, N,
                         H, C, U, reverse, ks);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// One of the twelve instantiations of K1, K16, K15, K1 float32 or the wide
// forms, or the launch's refusal.
template <typename W, bool FUSED, bool WIDE = false>
int dispatch_nt(const void* xin, const void* w_sl, const void* w_frag, const void* gate_vec,
                void* out, int T, int N, int H, int C, int U, int mtw, int nt, int reverse,
                int ks, cudaStream_t s, int* active) {
#define DTT_K1(M, NT_)                                                                  \
  if (mtw == M && nt == NT_)                                                            \
    return launch_k1<W, M, NT_, FUSED, WIDE>(xin, w_sl, w_frag, gate_vec, out, T, N, H, C, \
                                             U, reverse, ks, s, active);
  DTT_K1(1, 1) DTT_K1(1, 2) DTT_K1(1, 3) DTT_K1(1, 4) DTT_K1(1, 5) DTT_K1(1, 6)
  DTT_K1(2, 1) DTT_K1(2, 2) DTT_K1(2, 3) DTT_K1(2, 4) DTT_K1(2, 5) DTT_K1(2, 6)
#undef DTT_K1
  return static_cast<int>(cudaErrorInvalidValue);
}

int dispatch_k1(int kind, const void* xin, const void* w_sl, const void* w_frag,
                const void* gate_vec, void* out, int T, int N, int H, int C, int U, int rows,
                int warps, int reverse, int ks, cudaStream_t s, int* active) {
  const int es = kind == KIND_K15 ? 1 : kind == KIND_K1F || kind == KIND_K1FW ? 4 : 2;
  // U: whole k-tiles of h (16 units; 8 in float32); shared memory is checked
  // where the instantiation is known
  if (kind < KIND_K1 || kind > KIND_K1FW || T < 0 || N <= 0 || H <= 0 || H % 4 ||
      U % (es == 4 ? 8 : 16) ||
      C < 1 || C > 16 || (C & (C - 1)) || C * U < H || rows % 8 || rows < 8 ||
      rows > 8 * MAX_NT || warps < 1 || warps > MAX_WARPS || (U / 4) % warps)
    return static_cast<int>(cudaErrorInvalidValue);
  const int mtw = U / 4 / warps;
  const int nt = rows / 8;
  if (kind == KIND_K16)
    return dispatch_nt<__nv_bfloat16, true>(xin, w_sl, w_frag, gate_vec, out, T, N, H, C, U, mtw,
                                            nt, reverse, ks, s, active);
  if (kind == KIND_K15)
    return dispatch_nt<int8_t, false>(xin, w_sl, w_frag, gate_vec, out, T, N, H, C, U, mtw, nt,
                                      reverse, ks, s, active);
  if (kind == KIND_K1F)
    return dispatch_nt<float, false>(xin, w_sl, w_frag, gate_vec, out, T, N, H, C, U, mtw, nt,
                                     reverse, ks, s, active);
  if (kind == KIND_K1W)
    return dispatch_nt<__nv_bfloat16, false, true>(xin, w_sl, w_frag, gate_vec, out, T, N, H, C,
                                                   U, mtw, nt, reverse, ks, s, active);
  if (kind == KIND_K1FW)
    return dispatch_nt<float, false, true>(xin, w_sl, w_frag, gate_vec, out, T, N, H, C, U, mtw,
                                           nt, reverse, ks, s, active);
  return dispatch_nt<__nv_bfloat16, false>(xin, w_sl, w_frag, gate_vec, out, T, N, H, C, U, mtw,
                                           nt, reverse, ks, s, active);
}

}  // namespace k1

// xproj [T, N, 4H] bf16; w_sl [C][4U][Kp] bf16 (Kp = C * U rounded up to
// 32), the wrapper's slices of W_hh^T (see the note above); out [T, N, H].
// cluster C a power of two up to 16, U a multiple of 16 with H <= C * U,
// rows a multiple of 8 up to 48 a cluster, warps dividing U / 4 into one or
// two m-tiles each; H a multiple of 4; 16-byte aligned pointers.
DTT_EXPORT int lstm_scan_bf16(const void* xproj, const void* w_sl, void* out, int T, int N,
                              int H, int reverse, int cluster, int units, int rows, int warps,
                              void* stream) {
  if (T == 0) return 0;
  return k1::dispatch_k1(k1::KIND_K1, xproj, w_sl, nullptr, nullptr, out, T, N, H, cluster,
                         units, rows, warps, reverse, 0, static_cast<cudaStream_t>(stream),
                         nullptr);
}

// x [T, N, H] bf16; w_hh_sl as lstm_scan_bf16's w_sl; w_ih_frag the mma
// fragments of W_ih^T's slices in the same layout, [C][U / 4][Kp / 16][32]
// x 8 bf16; bias [4H] float32; out [T, N, H]; the limits of lstm_scan_bf16.
DTT_EXPORT int lstm_fused_bf16(const void* x, const void* w_hh_sl, const void* w_ih_frag,
                               const void* bias, void* out, int T, int N, int H, int reverse,
                               int cluster, int units, int rows, int warps, void* stream) {
  if (T == 0) return 0;
  return k1::dispatch_k1(k1::KIND_K16, x, w_hh_sl, w_ih_frag, bias, out, T, N, H, cluster,
                         units, rows, warps, reverse, 0, static_cast<cudaStream_t>(stream),
                         nullptr);
}

// xproj [T, N, 4H] bf16; w_sl [C][4U][Kp] int8 (Kp = C * U rounded up to
// 64), the wrapper's slices of W_i8 in lstm_scan_bf16's layout; scale [4H]
// float32; out [T, N, H]; the limits of lstm_scan_bf16.
DTT_EXPORT int lstm_scan_int8(const void* xproj, const void* w_sl, const void* scale, void* out,
                              int T, int N, int H, int reverse, int cluster, int units, int rows,
                              int warps, void* stream) {
  if (T == 0) return 0;
  return k1::dispatch_k1(k1::KIND_K15, xproj, w_sl, nullptr, scale, out, T, N, H, cluster,
                         units, rows, warps, reverse, 0, static_cast<cudaStream_t>(stream),
                         nullptr);
}

// xproj [T, N, 4H] float32; w_sl [C][4U][Kp] float32 (Kp = C * U rounded up
// to 16), the wrapper's slices of W_hh^T in lstm_scan_bf16's layout; out
// [T, N, H] float32; U a multiple of 8, else the limits of lstm_scan_bf16.
DTT_EXPORT int lstm_scan_f32(const void* xproj, const void* w_sl, void* out, int T, int N, int H,
                             int reverse, int cluster, int units, int rows, int warps,
                             void* stream) {
  if (T == 0) return 0;
  return k1::dispatch_k1(k1::KIND_K1F, xproj, w_sl, nullptr, nullptr, out, T, N, H, cluster,
                         units, rows, warps, reverse, 0, static_cast<cudaStream_t>(stream),
                         nullptr);
}

// The wide forms: xproj [T, N, 4H] and out [T, N, H] in bf16 (float32);
// w_res [C][4U][2 KT (ks - kr)], the columns of the resident pairs [kr, ks)
// of lstm_scan_bf16's (lstm_scan_f32's) slices; w_frag the mma fragments of
// the other pairs' k-tiles in order, [C][U / 4][k-tiles][32] x 16 bytes (the
// wrapper's wide_w_hh); kr the register pairs of the instantiation (see
// wide_reg_pairs), ks the end of the resident pairs; the limits of
// lstm_scan_bf16 (lstm_scan_f32).
DTT_EXPORT int lstm_scan_wide_bf16(const void* xproj, const void* w_res, const void* w_frag,
                                   void* out, int T, int N, int H, int reverse, int cluster,
                                   int units, int rows, int warps, int ks, void* stream) {
  if (T == 0) return 0;
  return k1::dispatch_k1(k1::KIND_K1W, xproj, w_res, w_frag, nullptr, out, T, N, H, cluster,
                         units, rows, warps, reverse, ks, static_cast<cudaStream_t>(stream),
                         nullptr);
}

DTT_EXPORT int lstm_scan_wide_f32(const void* xproj, const void* w_res, const void* w_frag,
                                  void* out, int T, int N, int H, int reverse, int cluster,
                                  int units, int rows, int warps, int ks, void* stream) {
  if (T == 0) return 0;
  return k1::dispatch_k1(k1::KIND_K1FW, xproj, w_res, w_frag, nullptr, out, T, N, H, cluster,
                         units, rows, warps, reverse, ks, static_cast<cudaStream_t>(stream),
                         nullptr);
}

// How many clusters of K1's (kind 0), K16's (1), K15's (2), K1 float32's (3)
// or the wide forms' (4: bf16, 5: float32, with ks the end of the resident
// pairs) launch at this shape the card runs at once.
DTT_EXPORT int lstm_scan_active_clusters(int H, int kind, int cluster, int units, int rows,
                                         int warps, int ks, int* active) {
  *active = 0;
  return k1::dispatch_k1(kind, nullptr, nullptr, nullptr, nullptr, nullptr, 1, rows, H, cluster,
                         units, rows, warps, 0, ks, nullptr, active);
}
