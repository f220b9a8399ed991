// LSTM recurrence over pre-projected gates, bf16 in and out, f32 state.
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
