// Helpers shared by the kernels of this directory. Each .cu file is built
// into its own shared library with a plain C interface (see ops/_cuda.py),
// so every library carries its own copy of dtt_error_string.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define DTT_EXPORT extern "C" __attribute__((visibility("default")))

DTT_EXPORT const char* dtt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// cp.async of 16 bytes from global to shared memory (L2 only), its commit
// and its wait for all but the N most recent groups.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(addr), "l"(gmem));
}

// cp.async of 8 bytes (through L1), for rows that are 8-byte aligned only.
__device__ __forceinline__ void cp_async8(void* smem, const void* gmem) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(addr), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Four 8 x 8 b16 matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8 and receives row l / 4, columns 2 (l % 4) and
// 2 (l % 4) + 1 of each (of each transposed matrix with .trans).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* smem) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* smem) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c += a . b on the tensor cores: a 16 x 16 bf16 (row), b 16 x 8 bf16 (col),
// c 16 x 8 float32. Fragments: a[0] row g, k 2t..2t+1; a[1] row g + 8; a[2]
// and a[3] the same rows at k + 8; b0 k 2t..2t+1 of column g, b1 at k + 8;
// c[0..1] row g, columns 2t..2t+1, c[2..3] row g + 8 (g = lane / 4,
// t = lane % 4).
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a . b on the tensor cores: a 16 x 32 int8 (row), b 32 x 8 int8 (col),
// c 16 x 8 int32, exact. In bytes the fragments are mma_bf16's: a[0] row g,
// k 4t..4t+3; a[1] row g + 8; a[2] and a[3] the same rows at k + 16; b0 k
// 4t..4t+3 of column g, b1 at k + 16; c as mma_bf16's.
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a . b on the tensor cores: a 16 x 8 tf32 (row), b 8 x 8 tf32 (col), c
// 16 x 8 float32. In bytes the fragments are mma_bf16's: a[0] row g, k t;
// a[1] row g + 8; a[2] and a[3] the same rows at k + 4; b0 k t of column g,
// b1 at k + 4; c as mma_bf16's. The tensor cores read 10 bits of each
// operand's mantissa (tf32 holds 10).
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A float rounded to tf32 (to nearest, ties away from zero), as its bits.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// A float split for 3xTF32 products: hi = tf32(x) and lo = tf32(x - hi);
// a . b is then a_lo b_hi + a_hi b_lo + a_hi b_hi (mma_tf32 each, the small
// terms first), which leaves about 2^-21 of each product.
__device__ __forceinline__ void tf32_split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// c += a . b in 3xTF32 on operands split already (tf32_split).
__device__ __forceinline__ void mma_3xtf32_split(float (&c)[4], const uint32_t (&ah)[4],
                                                 const uint32_t (&al)[4], uint32_t bh0,
                                                 uint32_t bh1, uint32_t bl0, uint32_t bl1) {
  mma_tf32(c, al, bh0, bh1);
  mma_tf32(c, ah, bl0, bl1);
  mma_tf32(c, ah, bh0, bh1);
}

// The pair (y0, y1), rounded to T (bf16 or float), at the even column col of
// row `row` of a [64][cols] tile held as boxes of 64 rows x 128 bytes in the
// 128-byte swizzle (box col / (128 / sizeof(T)), 16-byte chunk XOR row % 8):
// the output tiles that the wgmma kernels send out by TMA.
template <typename T>
__device__ __forceinline__ void store_pair_swz128(unsigned char* tile, int row, int col, float y0,
                                                  float y1) {
  constexpr int PER = 128 / sizeof(T);  // columns a box
  unsigned char* chunk = tile + ((col / PER) * 64 + row) * 128 +
                         (((((col % PER) * (int)sizeof(T)) >> 4) ^ (row & 7)) << 4) +
                         ((col * (int)sizeof(T)) & 15);
  if constexpr (sizeof(T) == 4)
    *reinterpret_cast<float2*>(chunk) = make_float2(y0, y1);
  else
    *reinterpret_cast<__nv_bfloat162*>(chunk) = __floats2bfloat162_rn(y0, y1);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Four consecutive bf16 values (8 bytes) of one score row, as floats.
__device__ __forceinline__ void unpack4(uint2 v, float out[4]) {
  __nv_bfloat162 lo = *reinterpret_cast<__nv_bfloat162*>(&v.x);
  __nv_bfloat162 hi = *reinterpret_cast<__nv_bfloat162*>(&v.y);
  out[0] = __low2float(lo);
  out[1] = __high2float(lo);
  out[2] = __low2float(hi);
  out[3] = __high2float(hi);
}

// The special-function unit's approximations: 2^x, log2 x and 1 / x (denormal
// inputs and results flushed to zero).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float lg2(float x) {
  float y;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float rcp(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// A float's bits as an int whose signed order is the floats' order
// (negative floats have their magnitude bits flipped), and back: a warp's
// float maximum in one redux.sync.
__device__ __forceinline__ int ordered(float x) {
  const int b = __float_as_int(x);
  return b >= 0 ? b : b ^ 0x7fffffff;
}
__device__ __forceinline__ float unordered(int k) {
  return __int_as_float(k >= 0 ? k : k ^ 0x7fffffff);
}

// rint(x) as an int for |x| < 2^22 (0 for NaN, as the conversion gives), on
// the FMA pipe: in [2^23, 2^24) the floats are the integers, so 1.5 * 2^23 +
// x rounds x to an integer, ties to even, as rint does. rintf and the
// conversion to int run on the quarter-rate pipe that exp2 and the
// reciprocal also need.
__device__ __forceinline__ int rint_small(float x) {
  return x == x ? __float_as_int(__fadd_rn(x, 12582912.0f)) - 0x4B400000 : 0;
}

// ---- thread-block clusters, mbarriers and the bulk copy engine ------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The same shared-memory offset in CTA `rank` of the cluster.
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, uint32_t rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ void mbar_init(uint32_t mbar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(mbar), "r"(count) : "memory");
}

// Makes the initialised mbarriers visible to the cluster (and to the async
// proxy) before any CTA uses them; a cluster barrier follows.
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// This phase's one arrival, with the bytes its copies bring.
__device__ __forceinline__ void mbar_expect(uint32_t mbar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(mbar),
               "r"(bytes)
               : "memory");
}

// One arrival on this CTA's mbarrier.
__device__ __forceinline__ void mbar_arrive_local(uint32_t mbar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(mbar) : "memory");
}

// One arrival on the mbarrier at this offset in CTA `rank` of the cluster
// (this CTA's own included), with the default (CTA-scope) release: a
// cluster-scope release fences every earlier access of the thread, and cost
// K14 much of its time.
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t mbar, uint32_t rank) {
  asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];\n" ::"r"(map_rank(mbar, rank))
               : "memory");
}

// Wait for the phase of parity `parity` to complete (acquire). A phase that
// never completes would hang the card: after about 4 s the kernel traps.
__device__ __forceinline__ void mbar_wait(uint32_t mbar, int parity) {
  for (int i = 0;; ++i) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2, 1000;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(mbar), "r"(parity)
        : "memory");
    if (done) return;
    if (i > (1 << 22)) __trap();
  }
}

// mbar_wait with cluster scope, for data that other CTAs of the cluster
// published (a fence.acq_rel.cluster before their arrivals here): the wait
// acquires it.
__device__ __forceinline__ void mbar_wait_cluster(uint32_t mbar, int parity) {
  for (int i = 0;; ++i) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2, "
        "1000;\n selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(mbar), "r"(parity)
        : "memory");
    if (done) return;
    if (i > (1 << 22)) __trap();
  }
}

// A float at a shared::cluster address (map_rank).
__device__ __forceinline__ float ld_cluster_f32(uint32_t addr) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(addr) : "memory");
  return v;
}

// Orders this thread's generic-proxy writes to shared memory before later
// reads of it by the async proxy (wgmma operands, TMA stores).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// A barrier of `count` threads (a multiple of 32) on named barrier `id` (1-15).
__device__ __forceinline__ void named_bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// The dynamic shared memory rounded up to 1024 bytes, the 128-byte swizzle's
// alignment.
__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(p) + 1023) &
                                          ~uintptr_t(1023));
}

// The bulk copy engine: `bytes` (a multiple of 16) from this CTA's shared
// memory to a CTA of the cluster, completing as transaction bytes on the
// mbarrier `mbar` there (both shared::cluster addresses).
__device__ __forceinline__ void bulk_copy_cluster(uint32_t dst, uint32_t src, int bytes,
                                                  uint32_t mbar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(dst),
      "r"(src), "r"(bytes), "r"(mbar)
      : "memory");
}

// The bulk copy engine: `bytes` (a multiple of 16) of contiguous global memory
// (16-byte aligned) to this CTA's shared memory at `dst`, completing as
// transaction bytes on the mbarrier `mbar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, int bytes,
                                          uint32_t mbar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(dst),
      "l"(src), "r"(bytes), "r"(mbar)
      : "memory");
}

// ---- TMA tensor copies ------------------------------------------------------
// `map` is the generic address of a CUtensorMap kernel parameter
// (__grid_constant__); c0 is the inner (contiguous) coordinate, c1 the row.
// The box lands at `dst` in the map's swizzle and completes as transaction
// bytes on `mbar`; boxes past the tensor's edge are filled with zeros.

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const void* map, int c0, int c1,
                                            uint32_t mbar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, "
      "{%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(mbar)
      : "memory");
}

// A box of a 4-D map (make_history_map's), coordinates inner first.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const void* map, int c0, int c1, int c2,
                                            int c3, uint32_t mbar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, "
      "{%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(mbar)
      : "memory");
}

// The same box into this offset of every CTA in `mask` (bit r: cluster rank
// r), each completing on its own mbarrier at `mbar`'s offset.
__device__ __forceinline__ void tma_load_2d_multicast(uint32_t dst, const void* map, int c0,
                                                      int c1, uint32_t mbar, uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes.multicast::"
      "cluster [%0], [%1, {%2, %3}], [%4], %5;\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(mbar), "h"(mask)
      : "memory");
}

// A box from this CTA's shared memory (in the map's swizzle) to global
// memory; the part past the tensor's edge is not written. Completion is
// tracked by bulk groups: bulk_commit, then bulk_wait_read<N> until the
// source may be overwritten.
__device__ __forceinline__ void tma_store_2d(const void* map, int c0, int c1, uint32_t src) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%1, %2}], [%3];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(c0), "r"(c1), "r"(src)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
// Until this thread's bulk stores are complete (written, not only read).
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// ---- data that streams through once -----------------------------------------
// An L2 policy that evicts the lines it touches first: for inputs read once
// and outputs written once, so that they do not push out of L2 what the
// kernel reads again (its weights).
__device__ __forceinline__ uint64_t l2_evict_first() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(policy));
  return policy;
}

// 16 bytes read once: not kept in L1, first out of L2.
__device__ __forceinline__ uint4 ld_stream16(const void* p, uint64_t policy) {
  uint4 v;
  asm volatile("ld.global.nc.L1::no_allocate.L2::cache_hint.v4.u32 {%0, %1, %2, %3}, [%4], %5;\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p), "l"(policy));
  return v;
}

// tma_load_2d and tma_load_2d_multicast under an L2 policy.
__device__ __forceinline__ void tma_load_2d_hint(uint32_t dst, const void* map, int c0, int c1,
                                                 uint32_t mbar, uint64_t policy) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint "
      "[%0], [%1, {%2, %3}], [%4], %5;\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(mbar), "l"(policy)
      : "memory");
}
__device__ __forceinline__ void tma_load_2d_multicast_hint(uint32_t dst, const void* map, int c0,
                                                           int c1, uint32_t mbar, uint16_t mask,
                                                           uint64_t policy) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes.multicast::"
      "cluster.L2::cache_hint [%0], [%1, {%2, %3}], [%4], %5, %6;\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(mbar), "h"(mask), "l"(policy)
      : "memory");
}

// tma_store_2d under an L2 policy.
__device__ __forceinline__ void tma_store_2d_hint(const void* map, int c0, int c1, uint32_t src,
                                                  uint64_t policy) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group.L2::cache_hint [%0, {%1, %2}], [%3], "
      "%4;\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(c0), "r"(c1), "r"(src), "l"(policy)
      : "memory");
}

// ---- warpgroup matrix multiply (wgmma) ------------------------------------

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of an accumulator register
// across the asynchronous wgmma that writes it.
__device__ __forceinline__ void fence_operand(float& r) { asm volatile("" : "+f"(r)::"memory"); }
__device__ __forceinline__ void fence_operand(int& r) { asm volatile("" : "+r"(r)::"memory"); }

// Shared-memory matrix descriptor of a K-major operand whose rows are one
// swizzle span long (SW = 128 or 64 bytes: 64 or 32 bf16, 128 or 64 int8),
// in the TMA's swizzle of that span: 8-row atoms of 8 SW bytes, aligned to
// their size; start address, stride between 8-row groups 8 SW bytes, layout
// 1 (128-byte swizzle) or 2 (64-byte). A step of 16 bf16 (or 32 int8) along
// K adds 32 bytes to the start.
template <int SW>
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t smem_addr) {
  static_assert(SW == 128 || SW == 64, "a 128- or 64-byte swizzle");
  return (uint64_t)((smem_addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(8 * SW >> 4) << 32) | ((uint64_t)(SW == 128 ? 1 : 2) << 62);
}

// d (+)= A . B^T for a 64 x 256 tile, k = 16: A [64][16] and B [256][16],
// both bf16 and K-major in shared memory (descriptors above), d f32; d is
// overwritten when `accumulate` is 0. Thread t of the warpgroup holds rows
// 16 (t / 32) + (t % 32) / 4 (+ 8), columns 8 j + 2 (t % 4) (+ 1):
// d[4 j + 2 h + e] is row + 8 h, column 8 j + 2 (t % 4) + e.
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t desc_a,
                                                 uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127 "
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d (+)= A . B^T for a 64 x 128 tile, k = 32: A [64][32] and B [128][32],
// both int8 and K-major in shared memory (the same descriptors: a k32 step of
// int8 is the 32 bytes of a k16 step of bf16), d int32 and exact (no
// .satfinite: |d| <= K * 127^2 stays far from 2^31); d is overwritten when
// `accumulate` is 0. The same register layout as the bf16 form: d[4 j + 2 h +
// e] is row 16 (t / 32) + (t % 32) / 4 + 8 h, column 8 j + 2 (t % 4) + e.
__device__ __forceinline__ void wgmma_m64n128k32_s8(int (&d)[64], uint64_t desc_a,
                                                    uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63 "
      "}, %64, %65, p;\n}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// Registers a warpgroup's threads may hold (setmaxnreg): a producer gives
// some back, the consumers take them.
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
