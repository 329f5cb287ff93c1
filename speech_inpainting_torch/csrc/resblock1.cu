// Fused HiFi-GAN ResBlock1 for Hopper (sm_90a), plain CUDA C++ behind an
// extern "C" entry point; speech_inpainting_torch/kernels/build.py compiles
// it with nvcc and speech_inpainting_torch/ops/resblock.py calls it through
// ctypes.
//
// Replaces both TPU kernels of speech_inpainting_tpu/ops/pallas_resblock.py:
// fused_resblock1 (K1), a whole ResBlock1, and fused_resblock_step (K2), one
// of its residual steps. Both compute, for each step s with dilation d_s,
//     x <- x + conv2_s(lrelu(conv1_s(lrelu(x))))      (lrelu slope 0.1)
// conv1_s dilated by d_s, conv2_s undilated, both with torch "same" padding,
// and zero padding at the SIGNAL edges of every conv's input. One kernel,
// `resblock1_step`, computes one step; `si_resblock1` (K1) enqueues it once
// per step of a block, `si_resblock_step` (K2) once.
//
// Design. The TPU kernel keeps a time tile plus the whole block's halo in
// ~100 MB of VMEM. A Hopper block has 227 KB of shared memory, which at
// C = 256 holds fewer than 32 f32 columns of that trapezoid, so this kernel
// runs one launch per residual step with the step's intermediate in shared
// memory instead:
//   phase 1  h = lrelu(conv1(lrelu(x)) + b1) for all C channels over the
//            tile plus conv2's halo (mid columns), zeroed where its absolute
//            position lies outside [0, T), kept in shared memory;
//   phase 2  y = x + conv2(h) + b2 over the tile, written to device memory.
// Each step reads x once and writes y once; the intermediate never reaches
// device memory. Steps ping-pong between the output and one scratch buffer
// (both allocated by the caller), so no step reads what another block of the
// same step writes. Signal-edge zeroing is by absolute position in both
// phases, so a ragged last tile and odd T need no special case.
//
// Bound. A ResBlock1 does 12·C²·K·T FLOP and each step moves 2·C·T elements
// (x in, y out): hundreds of FLOP per byte at V1's widths, far above the
// card's balance, so arithmetic bounds it. This first version uses direct
// FMA loops in float32 (a 4×4 register tile per thread over operands staged
// in shared memory), not the tensor cores. bf16 operands are widened with
// __bfloat162float, summed in float32 and rounded back with __float2bfloat16
// once per step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;
constexpr int kRC = 4;   // output channels per thread
constexpr int kRT = 4;   // time positions per thread
constexpr int kCIC = 8;  // input channels staged per chunk
constexpr float kSlope = 0.1f;
constexpr int kMaxSmem = 232448;  // a Hopper block's dynamic shared memory

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
__device__ __forceinline__ float lrelu(float v) {
  return v >= 0.f ? v : kSlope * v;
}

// ws[co][ci·K + k] = w[co0+co][ci0+ci][k] as float, zero past C.
template <typename T, int CO_T>
__device__ __forceinline__ void stage_weights(float* ws, const T* w, int C,
                                              int K, int co0, int ci0) {
  const int row = kCIC * K;
  for (int i = threadIdx.x; i < CO_T * row; i += kThreads) {
    const int co = i / row, r = i % row, ci = r / K;
    float v = 0.f;
    if (co0 + co < C && ci0 + ci < C)
      v = to_f32(w[(static_cast<size_t>(co0 + co) * C + ci0) * K + r]);
    ws[i] = v;
  }
}

// One residual step. Grid (time tiles, batch); `tile` outputs per block,
// `midw` = tile + K − 1 intermediate columns, a multiple of the pass width.
template <typename T, int CO_T>
__global__ void __launch_bounds__(kThreads)
    resblock1_step(const T* __restrict__ x, const T* __restrict__ w1,
                   const float* __restrict__ b1, const T* __restrict__ w2,
                   const float* __restrict__ b2, T* __restrict__ y, int C,
                   int T_len, int K, int d, int tile, int midw) {
  constexpr int ROWS = CO_T / kRC;      // thread rows (output channels)
  constexpr int COLS = kThreads / ROWS; // thread columns (time)
  constexpr int TW = COLS * kRT;        // time positions per pass
  extern __shared__ float smem[];
  const int hstride = midw + K - 1;
  const int xw = TW + (K - 1) * d;
  float* hmid = smem;                      // C × hstride
  float* ws = hmid + C * hstride;          // CO_T × kCIC·K
  float* xs = ws + CO_T * kCIC * K;        // kCIC × xw

  const int h1 = d * (K - 1) / 2, h2 = (K - 1) / 2;
  const int t0 = blockIdx.x * tile;
  const size_t boff = static_cast<size_t>(blockIdx.y) * C * T_len;
  const T* xb = x + boff;
  const int tr = threadIdx.x / COLS, tc = threadIdx.x % COLS;

  // columns past midw feed only discarded outputs of phase 2's last pass
  for (int i = threadIdx.x; i < C * (K - 1); i += kThreads)
    hmid[(i / (K - 1)) * hstride + midw + i % (K - 1)] = 0.f;

  // phase 1: mid column m sits at absolute position t0 − h2 + m
  for (int co0 = 0; co0 < C; co0 += CO_T) {
    for (int m0 = 0; m0 < midw; m0 += TW) {
      float acc[kRC][kRT] = {};
      const int base = t0 - h2 + m0 - h1;  // position of xs column 0
      for (int ci0 = 0; ci0 < C; ci0 += kCIC) {
        __syncthreads();
        for (int i = threadIdx.x; i < kCIC * xw; i += kThreads) {
          const int c = ci0 + i / xw, p = base + i % xw;
          float v = 0.f;
          if (c < C && p >= 0 && p < T_len)
            v = lrelu(to_f32(xb[static_cast<size_t>(c) * T_len + p]));
          xs[i] = v;
        }
        stage_weights<T, CO_T>(ws, w1, C, K, co0, ci0);
        __syncthreads();
        const int cin = min(kCIC, C - ci0);
        for (int ci = 0; ci < cin; ++ci) {
          const float* wr = ws + ci * K;
          const float* xr = xs + ci * xw + tc;
          for (int k = 0; k < K; ++k) {
            float wv[kRC], xv[kRT];
#pragma unroll
            for (int i = 0; i < kRC; ++i) wv[i] = wr[(tr + ROWS * i) * kCIC * K + k];
#pragma unroll
            for (int j = 0; j < kRT; ++j) xv[j] = xr[COLS * j + k * d];
#pragma unroll
            for (int i = 0; i < kRC; ++i)
#pragma unroll
              for (int j = 0; j < kRT; ++j) acc[i][j] = fmaf(wv[i], xv[j], acc[i][j]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kRC; ++i) {
        const int co = co0 + tr + ROWS * i;
        if (co >= C) continue;
        const float bias = b1[co];
#pragma unroll
        for (int j = 0; j < kRT; ++j) {
          const int m = m0 + tc + COLS * j;
          const int p = t0 - h2 + m;
          hmid[co * hstride + m] =
              (p >= 0 && p < T_len) ? lrelu(acc[i][j] + bias) : 0.f;
        }
      }
    }
  }

  // phase 2: output column q sits at absolute position t0 + q
  T* yb = y + boff;
  for (int co0 = 0; co0 < C; co0 += CO_T) {
    for (int q0 = 0; q0 < tile; q0 += TW) {
      float acc[kRC][kRT] = {};
      for (int ci0 = 0; ci0 < C; ci0 += kCIC) {
        __syncthreads();
        stage_weights<T, CO_T>(ws, w2, C, K, co0, ci0);
        __syncthreads();
        const int cin = min(kCIC, C - ci0);
        for (int ci = 0; ci < cin; ++ci) {
          const float* wr = ws + ci * K;
          const float* hr = hmid + (ci0 + ci) * hstride + q0 + tc;
          for (int k = 0; k < K; ++k) {
            float wv[kRC], hv[kRT];
#pragma unroll
            for (int i = 0; i < kRC; ++i) wv[i] = wr[(tr + ROWS * i) * kCIC * K + k];
#pragma unroll
            for (int j = 0; j < kRT; ++j) hv[j] = hr[COLS * j + k];
#pragma unroll
            for (int i = 0; i < kRC; ++i)
#pragma unroll
              for (int j = 0; j < kRT; ++j) acc[i][j] = fmaf(wv[i], hv[j], acc[i][j]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kRC; ++i) {
        const int co = co0 + tr + ROWS * i;
        if (co >= C) continue;
        const float bias = b2[co];
#pragma unroll
        for (int j = 0; j < kRT; ++j) {
          const int q = q0 + tc + COLS * j;
          const int p = t0 + q;
          if (q < tile && p < T_len) {
            const size_t idx = static_cast<size_t>(co) * T_len + p;
            yb[idx] = from_f32<T>(to_f32(xb[idx]) + acc[i][j] + bias);
          }
        }
      }
    }
  }
}

template <typename T, int CO_T>
cudaError_t launch_block(const void* x, const void* w1, const float* b1,
                         const void* w2, const float* b2, void* out,
                         void* scratch, int B, int C, int T_len, int K, int S,
                         const int* dilations, cudaStream_t stream) {
  constexpr int TW = (kThreads / (CO_T / kRC)) * kRT;
  // wide blocks take fewer mid columns so that C × midw floats still fit
  const int midw = (C <= 128 || TW > 64) ? 128 : 64;
  const int tile = midw - (K - 1);
  if (tile <= 0 || midw % TW != 0) return cudaErrorInvalidValue;
  auto kernel = resblock1_step<T, CO_T>;
  const size_t wstep = static_cast<size_t>(C) * C * K;
  const T* src = static_cast<const T*>(x);
  for (int s = 0; s < S; ++s) {
    const int d = dilations[s];
    if (d < 1) return cudaErrorInvalidValue;
    const int xw = TW + (K - 1) * d;
    const size_t smem =
        sizeof(float) * (static_cast<size_t>(C) * (midw + K - 1) +
                         static_cast<size_t>(CO_T) * kCIC * K +
                         static_cast<size_t>(kCIC) * xw);
    if (smem > static_cast<size_t>(kMaxSmem)) return cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    // the last step lands in `out`; earlier ones alternate with `scratch`
    T* dst = static_cast<T*>(((S - 1 - s) % 2 == 0) ? out : scratch);
    const dim3 grid((T_len + tile - 1) / tile, B);
    kernel<<<grid, kThreads, smem, stream>>>(
        src, static_cast<const T*>(w1) + s * wstep, b1 + static_cast<size_t>(s) * C,
        static_cast<const T*>(w2) + s * wstep, b2 + static_cast<size_t>(s) * C,
        dst, C, T_len, K, d, tile, midw);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    src = dst;
  }
  return cudaSuccess;
}

template <typename T>
cudaError_t launch_typed(const void* x, const void* w1, const float* b1,
                         const void* w2, const float* b2, void* out,
                         void* scratch, int B, int C, int T_len, int K, int S,
                         const int* dilations, cudaStream_t stream) {
  if (C <= 32)
    return launch_block<T, 32>(x, w1, b1, w2, b2, out, scratch, B, C, T_len,
                               K, S, dilations, stream);
  return launch_block<T, 64>(x, w1, b1, w2, b2, out, scratch, B, C, T_len, K,
                             S, dilations, stream);
}

}  // namespace

extern "C" {

// x, out, scratch: (B, C, T); w1, w2: (S, C, C, K), all of dtype `dtype`
// (0 float32, 1 bfloat16), contiguous; b1, b2: (S, C) float32. K odd.
// scratch may be null when S == 1. Enqueues S launches on `stream`,
// allocates nothing, does not synchronise; returns a cudaError_t.
int si_resblock1(const void* x, const void* w1, const float* b1,
                 const void* w2, const float* b2, void* out, void* scratch,
                 int B, int C, int T_len, int K, int S, const int* dilations,
                 int dtype, int device, void* stream) {
  if (B < 1 || C < 1 || T_len < 1 || K < 1 || K % 2 == 0 || S < 1 ||
      (S > 1 && scratch == nullptr))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_typed<float>(x, w1, b1, w2, b2, out, scratch, B, C, T_len,
                               K, S, dilations, st);
  if (dtype == 1)
    return launch_typed<__nv_bfloat16>(x, w1, b1, w2, b2, out, scratch, B, C,
                                       T_len, K, S, dilations, st);
  return cudaErrorInvalidValue;
}

// One residual step (K2): x, out (B, C, T); w1, w2 (C, C, K) of dtype
// `dtype`, contiguous; b1, b2 (C,) float32; conv1 dilated by `dilation`.
// Enqueues one launch on `stream`; returns a cudaError_t.
int si_resblock_step(const void* x, const void* w1, const float* b1,
                     const void* w2, const float* b2, void* out, int B, int C,
                     int T_len, int K, int dilation, int dtype, int device,
                     void* stream) {
  return si_resblock1(x, w1, b1, w2, b2, out, nullptr, B, C, T_len, K, 1,
                      &dilation, dtype, device, stream);
}

const char* si_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
