// LSTM recurrences, bf16 in and out, f32 state: three kernels of one design.
//
//   lstm_scan_bf16 (K1): gates = xproj[t] + h @ W_hh^T, W_hh bf16;
//   lstm_scan_int8 (K15): the same with W_hh int8 and h quantised to int8;
//   lstm_fused_bf16 (K16): the input projection inside the recurrence,
//     gates = x[t] @ W_ih^T + h @ W_hh^T + bias.
//
// K1 first, then K15 and K16 below, each with its note.
//
// Replaces dorado_tpu/ops/lstm.py::lstm_scan_time_major (Pallas body
// _lstm_kernel). Per step t (walked backwards when reverse != 0):
//   gates = xproj[t] + h @ W_hh^T      (gate order i, f, g, o)
//   c = sigmoid(f) * c + sigmoid(i) * tanh(g);  h = bf16(sigmoid(o) * tanh(c))
//
// What bounds it on the H100: each step needs all of W_hh^T ([H, 4H] bf16,
// 1.18 MB at hac's H = 384), which does not fit one SM's 227 KB of shared
// memory. This simple design reads W_hh from global memory on every step;
// it stays resident in the 50 MB L2, so a step costs one L2 read of W per
// block plus BN * H * 4H FMAs on the CUDA cores, and the step's latency is
// set by how many W bytes each SM keeps in flight. Each block owns BN batch
// rows and every hidden unit (one launch per layer, the time loop inside, no
// exchange between blocks). A step has two phases:
//   1. thread (q, ks) computes 8 adjacent gate columns 8q .. 8q+7 for the
//      block's rows over the ks-th of KS = 4 slices of k, reading W as
//      16-byte vectors (8 bf16) and h from shared memory, and stores the
//      partial sums in shared memory; the four slices put 2H threads, and so
//      four times the W bytes, in flight on the SM;
//   2. the thread owning hidden unit j adds the KS partial sums of its four
//      gate columns (j, H + j, 2H + j, 3H + j) in order, adds the input
//      projection and updates c (registers) and h (shared memory, output).
// BN > 1 reuses each W element for BN rows, trading the L2 traffic of more
// blocks against FMAs per block. Splitting the gate columns across a
// thread-block cluster (W in distributed shared memory, one cluster barrier
// per step) is the next step.
#include "common.cuh"

constexpr int KS = 4;  // slices of k; the block has KS * H / 2 = 2H threads

__device__ __forceinline__ float sigmoidf_(float x) { return 1.f / (1.f + expf(-x)); }

template <int BN>
__global__ void __launch_bounds__(1024)
    lstm_scan_kernel(const __nv_bfloat16* __restrict__ xproj,  // [T, N, 4H]
                     const __nv_bfloat16* __restrict__ w,      // [H, 4H]
                     __nv_bfloat16* __restrict__ out,          // [T, N, H]
                     int T, int N, int H, int reverse) {
  extern __shared__ __align__(16) float smem[];
  const int G = 4 * H;
  float* h_s = smem;           // [H][BN]: h of the block's rows, k-major
  float* g_s = smem + H * BN;  // [KS][BN][4H]: partial h @ W_hh^T of this step
  const int tid = threadIdx.x;
  const int q = tid % (G / 8);
  const int ks = tid / (G / 8);
  const int k_len = H / KS;
  const int n0 = blockIdx.x * BN;
  const bool owns_unit = tid < H;  // thread tid updates hidden unit j = tid

  for (int i = tid; i < H * BN; i += blockDim.x) h_s[i] = 0.f;
  float c[BN];
#pragma unroll
  for (int r = 0; r < BN; ++r) c[r] = 0.f;
  __syncthreads();

  for (int step = 0; step < T; ++step) {
    const int t = reverse ? T - 1 - step : step;
    // input projection of this thread's unit: loads complete during phase 1
    float x[BN][4];
#pragma unroll
    for (int r = 0; r < BN; ++r) {
      const __nv_bfloat16* xr = xproj + ((size_t)t * N + n0 + r) * G;
#pragma unroll
      for (int g = 0; g < 4; ++g) x[r][g] = owns_unit ? __bfloat162float(xr[g * H + tid]) : 0.f;
    }

    // phase 1: acc[r][i] = sum over this slice of k of h[r][k] * W[k][8q + i]
    float acc[BN][8];
#pragma unroll
    for (int r = 0; r < BN; ++r) {
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[r][i] = 0.f;
    }
    const int k0 = ks * k_len;
    const uint4* wq = reinterpret_cast<const uint4*>(w + (size_t)k0 * G) + q;
    const float* hq = h_s + k0 * BN;
#pragma unroll 8
    for (int k = 0; k < k_len; ++k) {
      const uint4 wv = __ldg(wq + (size_t)k * (G / 8));
      float wf[8];
      const __nv_bfloat162* wp = reinterpret_cast<const __nv_bfloat162*>(&wv);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(wp[i]);
        wf[2 * i] = f.x;
        wf[2 * i + 1] = f.y;
      }
#pragma unroll
      for (int r = 0; r < BN; ++r) {
        const float hk = hq[k * BN + r];
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[r][i] += hk * wf[i];
      }
    }
#pragma unroll
    for (int r = 0; r < BN; ++r) {
      float4* dst = reinterpret_cast<float4*>(g_s + ((size_t)ks * BN + r) * G + 8 * q);
      dst[0] = make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
      dst[1] = make_float4(acc[r][4], acc[r][5], acc[r][6], acc[r][7]);
    }
    __syncthreads();  // gate sums complete; every read of this step's h done

    // phase 2: cell update of the thread's unit j = tid
    if (owns_unit) {
      const int j = tid;
#pragma unroll
      for (int r = 0; r < BN; ++r) {
        float gate[4];
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          float sum = g_s[(size_t)r * G + g * H + j];
#pragma unroll
          for (int s = 1; s < KS; ++s) sum += g_s[((size_t)s * BN + r) * G + g * H + j];
          gate[g] = x[r][g] + sum;
        }
        const float ig = sigmoidf_(gate[0]);
        const float fg = sigmoidf_(gate[1]);
        const float gg = tanhf(gate[2]);
        const float og = sigmoidf_(gate[3]);
        c[r] = fg * c[r] + ig * gg;
        const __nv_bfloat16 hb = __float2bfloat16(og * tanhf(c[r]));
        h_s[j * BN + r] = __bfloat162float(hb);
        out[((size_t)t * N + n0 + r) * H + j] = hb;
      }
    }
    __syncthreads();  // the new h is visible; g_s may be overwritten
  }
}

template <int BN>
static int launch(const void* xproj, const void* w, void* out, int T, int N, int H,
                  int reverse, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)BN * H * (1 + 4 * KS);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        lstm_scan_kernel<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  lstm_scan_kernel<BN><<<N / BN, KS * H / 2, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(xproj), static_cast<const __nv_bfloat16*>(w),
      static_cast<__nv_bfloat16*>(out), T, N, H, reverse);
  return static_cast<int>(cudaGetLastError());
}

// rows_per_block (1, 2 or 4) must divide N; H must be a multiple of 4 (each
// k slice H / 4 long; 16-byte W rows and shared-memory vectors) and at most
// 512 (2H threads a block); w_hh_t must be 16-byte aligned.
DTT_EXPORT int lstm_scan_bf16(const void* xproj, const void* w_hh_t, void* out, int T,
                              int N, int H, int reverse, int rows_per_block, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows_per_block == 1) return launch<1>(xproj, w_hh_t, out, T, N, H, reverse, s);
  if (rows_per_block == 2) return launch<2>(xproj, w_hh_t, out, T, N, H, reverse, s);
  if (rows_per_block == 4) return launch<4>(xproj, w_hh_t, out, T, N, H, reverse, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// ---------------------------------------------------------------------------
// K15: the recurrence with an int8 W_hh.
//
// Replaces dorado_tpu/ops/lstm.py::lstm_scan_time_major_int8 (Pallas body
// _lstm_int8_kernel). Per step t (walked backwards when reverse != 0):
//   acc = h_i8 @ W_i8           (int32, exact)
//   gates = xproj[t] + acc * scale   (scale [4H]: the weight column's scale
//                                     over 127, the activations' static scale)
//   c = sigmoid(f) * c + sigmoid(i) * tanh(g);  h = sigmoid(o) * tanh(c)
//   out[t] = bf16(h);  h_i8 = round_half_even(h * 127)
//
// What bounds it on the H100: as K1, the L2 read of the recurrent weights
// every step, now int8: 0.59 MB a step at hac's H = 384, half of K1's. The
// design is K1's (BN rows a block, thread (q, ks) owns 8 gate columns over
// the ks-th of KS slices of k, the owner of hidden unit j does the cell
// update); the products are __dp4a on four k at once, so the wrapper hands
// W in a k4-packed layout: word (kg, c) holds W[4kg .. 4kg+3][c], and a
// thread's 8 columns of one k group are 32 contiguous bytes. h stays int8
// in shared memory in the same packing (word (kg, r): h[r][4kg .. 4kg+3]),
// rounded half to even by __float2int_rn, as jnp.round and torch.round do.
// The int32 sums are exact (|acc| <= H * 127 * 127 < 2^24), and the float
// arithmetic after them is the plain version's operation for operation:
// the gate's multiply and add and the cell update's products and sum are
// written as separately rounded operations, so that no FMA contraction
// moves a value across an int8 rounding boundary of h.
// ---------------------------------------------------------------------------

template <int BN>
__global__ void __launch_bounds__(1024)
    lstm_scan_int8_kernel(const __nv_bfloat16* __restrict__ xproj,  // [T, N, 4H]
                          const int* __restrict__ w4,               // [H/4, 4H] k4-packed int8
                          const float* __restrict__ scale,          // [4H]
                          __nv_bfloat16* __restrict__ out,          // [T, N, H]
                          int T, int N, int H, int reverse) {
  extern __shared__ __align__(16) int smem_i[];
  const int G = 4 * H;
  int* h_s = smem_i;                  // [H/4][BN]: packed int8 h of the block's rows
  int* g_s = smem_i + (H / 4) * BN;   // [KS][BN][4H]: partial int32 sums of this step
  const int tid = threadIdx.x;
  const int q = tid % (G / 8);
  const int ks = tid / (G / 8);
  const int kg_len = H / (4 * KS);    // k groups of four in a slice
  const int n0 = blockIdx.x * BN;
  const bool owns_unit = tid < H;
  int8_t* h_bytes = reinterpret_cast<int8_t*>(h_s);

  for (int i = tid; i < (H / 4) * BN; i += blockDim.x) h_s[i] = 0;
  float c[BN], sc[4];
#pragma unroll
  for (int r = 0; r < BN; ++r) c[r] = 0.f;
#pragma unroll
  for (int g = 0; g < 4; ++g) sc[g] = owns_unit ? scale[g * H + tid] : 0.f;
  __syncthreads();

  for (int step = 0; step < T; ++step) {
    const int t = reverse ? T - 1 - step : step;
    float x[BN][4];
#pragma unroll
    for (int r = 0; r < BN; ++r) {
      const __nv_bfloat16* xr = xproj + ((size_t)t * N + n0 + r) * G;
#pragma unroll
      for (int g = 0; g < 4; ++g) x[r][g] = owns_unit ? __bfloat162float(xr[g * H + tid]) : 0.f;
    }

    // phase 1: acc[r][i] = sum over this slice of k of h[r][k] * W[k][8q + i]
    int acc[BN][8];
#pragma unroll
    for (int r = 0; r < BN; ++r) {
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[r][i] = 0;
    }
    const int kg0 = ks * kg_len;
    const uint4* wq = reinterpret_cast<const uint4*>(w4) + (size_t)kg0 * H + 2 * q;
    const int* hq = h_s + kg0 * BN;
#pragma unroll 4
    for (int kk = 0; kk < kg_len; ++kk) {
      const uint4 a = __ldg(wq + (size_t)kk * H);
      const uint4 b = __ldg(wq + (size_t)kk * H + 1);
      const int wv[8] = {(int)a.x, (int)a.y, (int)a.z, (int)a.w,
                         (int)b.x, (int)b.y, (int)b.z, (int)b.w};
#pragma unroll
      for (int r = 0; r < BN; ++r) {
        const int h4 = hq[kk * BN + r];
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[r][i] = __dp4a(h4, wv[i], acc[r][i]);
      }
    }
#pragma unroll
    for (int r = 0; r < BN; ++r) {
      int4* dst = reinterpret_cast<int4*>(g_s + ((size_t)ks * BN + r) * G + 8 * q);
      dst[0] = make_int4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
      dst[1] = make_int4(acc[r][4], acc[r][5], acc[r][6], acc[r][7]);
    }
    __syncthreads();  // sums complete; every read of this step's h done

    // phase 2: cell update of the thread's unit j = tid
    if (owns_unit) {
      const int j = tid;
#pragma unroll
      for (int r = 0; r < BN; ++r) {
        float gate[4];
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          int sum = g_s[(size_t)r * G + g * H + j];
#pragma unroll
          for (int s = 1; s < KS; ++s) sum += g_s[((size_t)s * BN + r) * G + g * H + j];
          gate[g] = __fadd_rn(x[r][g], __fmul_rn((float)sum, sc[g]));
        }
        const float ig = sigmoidf_(gate[0]);
        const float fg = sigmoidf_(gate[1]);
        const float gg = tanhf(gate[2]);
        const float og = sigmoidf_(gate[3]);
        c[r] = __fadd_rn(__fmul_rn(fg, c[r]), __fmul_rn(ig, gg));
        const float hn = og * tanhf(c[r]);
        h_bytes[((j >> 2) * BN + r) * 4 + (j & 3)] = (int8_t)__float2int_rn(hn * 127.f);
        out[((size_t)t * N + n0 + r) * H + j] = __float2bfloat16(hn);
      }
    }
    __syncthreads();  // the new h is visible; g_s may be overwritten
  }
}

// ---------------------------------------------------------------------------
// K16: the whole layer, input projection inside the recurrence.
//
// Replaces dorado_tpu/ops/lstm.py::lstm_fused_time_major (Pallas body
// _lstm_fused_kernel). Per step t (walked backwards when reverse != 0):
//   gates = x[t] @ W_ih^T + h @ W_hh^T + bias      (float32 sums)
//   c = sigmoid(f) * c + sigmoid(i) * tanh(g);  h = bf16(sigmoid(o) * tanh(c))
// The input width is H, so both weights are [H, 4H].
//
// What bounds it on the H100: K1's L2 read of W_hh every step plus the
// same for W_ih, 2.4 MB a step at H = 384, and twice K1's FMAs on the CUDA
// cores. Only the H-wide x streams from HBM (not K1's 4H-wide gates). The
// design is K1's; each thread's k slice runs both products into one f32
// sum per column, reading a row of W_hh and the same row of W_ih as 16-byte
// vectors, h and x[t] from shared memory. x[t + 1] is staged into shared
// memory during the cell update of step t, between the step's two
// barriers, so the step needs no third one.
// ---------------------------------------------------------------------------

template <int BN>
__global__ void __launch_bounds__(1024)
    lstm_fused_kernel(const __nv_bfloat16* __restrict__ x,     // [T, N, H]
                      const __nv_bfloat16* __restrict__ w_ih,  // [H, 4H]
                      const __nv_bfloat16* __restrict__ w_hh,  // [H, 4H]
                      const float* __restrict__ bias,          // [4H]
                      __nv_bfloat16* __restrict__ out,         // [T, N, H]
                      int T, int N, int H, int reverse) {
  extern __shared__ __align__(16) float smem[];
  const int G = 4 * H;
  float* h_s = smem;               // [H][BN]: h of the block's rows, k-major
  float* x_s = smem + H * BN;      // [H][BN]: x[t] of the block's rows, k-major
  float* g_s = smem + 2 * H * BN;  // [KS][BN][4H]: partial sums of this step
  const int tid = threadIdx.x;
  const int q = tid % (G / 8);
  const int ks = tid / (G / 8);
  const int k_len = H / KS;
  const int n0 = blockIdx.x * BN;
  const bool owns_unit = tid < H;

  auto stage_x = [&](int t) {
    for (int i = tid; i < H * BN; i += blockDim.x) {
      const int r = i / H, k = i % H;  // neighbouring threads read neighbouring k
      x_s[k * BN + r] = __bfloat162float(x[((size_t)t * N + n0 + r) * H + k]);
    }
  };
  for (int i = tid; i < H * BN; i += blockDim.x) h_s[i] = 0.f;
  stage_x(reverse ? T - 1 : 0);
  float c[BN], b[4];
#pragma unroll
  for (int r = 0; r < BN; ++r) c[r] = 0.f;
#pragma unroll
  for (int g = 0; g < 4; ++g) b[g] = owns_unit ? bias[g * H + tid] : 0.f;
  __syncthreads();

  for (int step = 0; step < T; ++step) {
    const int t = reverse ? T - 1 - step : step;
    float acc[BN][8];
#pragma unroll
    for (int r = 0; r < BN; ++r) {
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[r][i] = 0.f;
    }
    const int k0 = ks * k_len;
    const uint4* whq = reinterpret_cast<const uint4*>(w_hh + (size_t)k0 * G) + q;
    const uint4* wiq = reinterpret_cast<const uint4*>(w_ih + (size_t)k0 * G) + q;
    const float* hq = h_s + k0 * BN;
    const float* xq = x_s + k0 * BN;
#pragma unroll 4
    for (int k = 0; k < k_len; ++k) {
      const uint4 hv = __ldg(whq + (size_t)k * (G / 8));
      const uint4 iv = __ldg(wiq + (size_t)k * (G / 8));
      float wh[8], wi[8];
      const __nv_bfloat162* hp = reinterpret_cast<const __nv_bfloat162*>(&hv);
      const __nv_bfloat162* ip = reinterpret_cast<const __nv_bfloat162*>(&iv);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 fh = __bfloat1622float2(hp[i]);
        const float2 fi = __bfloat1622float2(ip[i]);
        wh[2 * i] = fh.x;
        wh[2 * i + 1] = fh.y;
        wi[2 * i] = fi.x;
        wi[2 * i + 1] = fi.y;
      }
#pragma unroll
      for (int r = 0; r < BN; ++r) {
        const float hk = hq[k * BN + r];
        const float xk = xq[k * BN + r];
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[r][i] += xk * wi[i] + hk * wh[i];
      }
    }
#pragma unroll
    for (int r = 0; r < BN; ++r) {
      float4* dst = reinterpret_cast<float4*>(g_s + ((size_t)ks * BN + r) * G + 8 * q);
      dst[0] = make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
      dst[1] = make_float4(acc[r][4], acc[r][5], acc[r][6], acc[r][7]);
    }
    __syncthreads();  // sums complete; every read of this step's h and x done

    if (step + 1 < T) stage_x(reverse ? t - 1 : t + 1);
    if (owns_unit) {
      const int j = tid;
#pragma unroll
      for (int r = 0; r < BN; ++r) {
        float gate[4];
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          float sum = g_s[(size_t)r * G + g * H + j];
#pragma unroll
          for (int s = 1; s < KS; ++s) sum += g_s[((size_t)s * BN + r) * G + g * H + j];
          gate[g] = sum + b[g];
        }
        const float ig = sigmoidf_(gate[0]);
        const float fg = sigmoidf_(gate[1]);
        const float gg = tanhf(gate[2]);
        const float og = sigmoidf_(gate[3]);
        c[r] = fg * c[r] + ig * gg;
        const __nv_bfloat16 hb = __float2bfloat16(og * tanhf(c[r]));
        h_s[j * BN + r] = __bfloat162float(hb);
        out[((size_t)t * N + n0 + r) * H + j] = hb;
      }
    }
    __syncthreads();  // the new h and x are visible; g_s may be overwritten
  }
}

template <int BN>
static int launch_int8(const void* xproj, const void* w4, const void* scale, void* out, int T,
                       int N, int H, int reverse, cudaStream_t stream) {
  const size_t smem = sizeof(int) * (size_t)BN * (H / 4 + KS * 4 * H);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        lstm_scan_int8_kernel<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  lstm_scan_int8_kernel<BN><<<N / BN, KS * H / 2, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(xproj), static_cast<const int*>(w4),
      static_cast<const float*>(scale), static_cast<__nv_bfloat16*>(out), T, N, H, reverse);
  return static_cast<int>(cudaGetLastError());
}

template <int BN>
static int launch_fused(const void* x, const void* w_ih, const void* w_hh, const void* bias,
                        void* out, int T, int N, int H, int reverse, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)BN * H * (2 + 4 * KS);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        lstm_fused_kernel<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  lstm_fused_kernel<BN><<<N / BN, KS * H / 2, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w_ih),
      static_cast<const __nv_bfloat16*>(w_hh), static_cast<const float*>(bias),
      static_cast<__nv_bfloat16*>(out), T, N, H, reverse);
  return static_cast<int>(cudaGetLastError());
}

// w4 is W_i8 [H, 4H] packed four k to a word ([H/4, 4H] int32, see K15's
// note); H must be a multiple of 16 (each k slice whole k groups) and at most
// 512; rows_per_block (1, 2 or 4) must divide N; all pointers 16-byte aligned.
DTT_EXPORT int lstm_scan_int8(const void* xproj, const void* w4, const void* scale, void* out,
                              int T, int N, int H, int reverse, int rows_per_block,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows_per_block == 1) return launch_int8<1>(xproj, w4, scale, out, T, N, H, reverse, s);
  if (rows_per_block == 2) return launch_int8<2>(xproj, w4, scale, out, T, N, H, reverse, s);
  if (rows_per_block == 4) return launch_int8<4>(xproj, w4, scale, out, T, N, H, reverse, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// x [T, N, H] bf16, w_ih_t and w_hh_t [H, 4H] bf16, bias [4H] float32; the
// limits of lstm_scan_bf16 on H and rows_per_block.
DTT_EXPORT int lstm_fused_bf16(const void* x, const void* w_ih_t, const void* w_hh_t,
                               const void* bias, void* out, int T, int N, int H, int reverse,
                               int rows_per_block, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows_per_block == 1)
    return launch_fused<1>(x, w_ih_t, w_hh_t, bias, out, T, N, H, reverse, s);
  if (rows_per_block == 2)
    return launch_fused<2>(x, w_ih_t, w_hh_t, bias, out, T, N, H, reverse, s);
  if (rows_per_block == 4)
    return launch_fused<4>(x, w_ih_t, w_hh_t, bias, out, T, N, H, reverse, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
