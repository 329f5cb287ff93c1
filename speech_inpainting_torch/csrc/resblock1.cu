// HiFi-GAN ResBlock1 steps on Hopper's tensor cores (sm_90a), plain CUDA C++
// behind an extern "C" interface; speech_inpainting_torch/kernels/build.py
// compiles it with nvcc and speech_inpainting_torch/ops/resblock.py calls it
// through ctypes, passing the launch plan (`_plan` there) with each call.
//
// Replaces both TPU kernels of speech_inpainting_tpu/ops/pallas_resblock.py:
// fused_resblock1 (K1), a whole ResBlock1, and fused_resblock_step (K2), one
// of its residual steps. Both compute, for each step s with dilation d_s,
//     x <- x + conv2_s(lrelu(conv1_s(lrelu(x))))      (lrelu slope 0.1)
// conv1_s dilated by d_s, conv2_s undilated, both with torch "same" padding
// and zero padding at the signal edges of every conv's input.
//
// Bound. A step does 4·C²·K·T FLOP per batch row and moves a few C·T
// elements: hundreds of FLOP per byte at every width the repo uses (C = 16
// to 256, K = 3 to 11), far above the card's balance, so the tensor cores'
// rate bounds it: 989 TFLOP/s in bf16, and in f32 the 3×TF32 route below
// runs three TF32 products for each f32 one (495 TFLOP/s).
//
// Two launches per residual step, from one kernel template (implicit GEMM:
// output channels × time, reduced over input channels × taps):
//   A  h = lrelu(conv1_d(lrelu(x)) + b1)   x (B, C, T) → h (B, T, C)
//   B  y = x + conv2(h) + b2               h, x → y (B, C, T)
// One launch would need every channel of h in one block, so splitting the
// output channels over blocks would recompute conv1 once per channel tile.
// h goes through memory once instead, in x's type and channel-contiguous
// (at most 22.5 MB in bf16, so it stays in the 50 MB L2); the Pallas kernels
// also keep h in the input type. K1 enqueues 2·S launches (step 0 writes the
// output, later steps update it in place: launch B reads each residual
// element in the thread that then writes it, and reads nothing else of x),
// K2 two.
//
// The first port (one launch per step, all C outputs per block, f32 FMA
// loops) was held back by three things; what this design does about each:
//  1. No tensor cores. bf16 runs mma.sync m16n8k16 with f32 accumulation.
//     f32 runs m16n8k8 TF32 MMAs as a 3×TF32 split: a = hi + lo with
//     hi = tf32(a), lo = tf32(a − hi), acc += lo·hi' + hi·lo' + hi·hi', which
//     keeps the error near f32 rounding (plain TF32 keeps ~3 digits, far
//     above the f32 gate of atol 3e-5).
//  2. A grid too small at B = 1. Each launch is tiled over (time tile,
//     output-channel tile, batch); the plan picks the largest tile that
//     still gives 132 blocks (one per SM) wherever B·C·T allows. Every
//     block has 256 threads; where a tile is small, warp groups split the
//     taps among them and add their sums at the end, so that small
//     problems still keep 8 warps per block busy:
//        co tile × time tile   warps co × time × tap groups   warp tile
//           64   ×   256              2 × 4 × 1                32 × 64
//           64   ×   128              2 × 4 × 1                32 × 32
//           64   ×    64              2 × 2 × 2                32 × 32
//           32   ×   128              2 × 4 × 1                16 × 32
//           32   ×    64              2 × 2 × 2                16 × 32
//           16   ×   128              1 × 4 × 2                16 × 32
//           32   ×    32              2 × 1 × 4                16 × 32
//  3. Slow staging. Input channels are reduced in chunks of 64 bytes (32
//     bf16 or 16 f32 channels) through a double-buffered ring in shared
//     memory: the next chunk's 16-byte cp.async copies fly while the MMAs
//     of this one run. A chunk holds
//       - the weights of all K taps for the tile's output channels, copied
//         as they lie in (C, C, K) order (each output channel's chunk is one
//         contiguous, 16-byte aligned run of 64·K bytes; rows padded to
//         64·K + 16 bytes so fragment loads hit 32 distinct banks). The
//         MMA's A fragments are read from that layout directly, with no
//         transposing pass: in f32 one 32-bit load per register, in bf16
//         two 16-bit loads (a channel pair lies K elements apart, which
//         rules out ldmatrix for A);
//       - the activation window time-major, one 80-byte row (64 bytes of
//         channels, 16 of padding) per position over the tile plus the taps'
//         halo. A tap k is then a shift of k·d whole rows, which keeps every
//         fragment load aligned, and B fragments come by ldmatrix.x4.
//         Launch B's h is channel-contiguous already and is copied with
//         cp.async; launch A's x needs lrelu and a transpose, so it goes
//         through registers, all of a chunk's loads issued before the
//         MMAs of the chunk before (the halo (K − 1)·d is at most 64).
//     h is no longer held in shared memory, so the tile no longer shrinks
//     with C and nothing of conv1 is recomputed as halo. The kernel takes
//     the kernel sizes of the repo's ResBlock1 configs, K = 3, 7, 11, each
//     a compile-time instantiation, so the tap loop unrolls; the plan and
//     the launcher refuse any other K.
//     The epilogue goes through shared memory, so that the stores of h
//     (16 bytes of channels per thread) and of y (neighbouring positions
//     in neighbouring threads) are coalesced.
// Signal edges: both launches read positions outside [0, T) as zero (zero
// fill of the copies), and h is never written outside [0, T), so a ragged
// last tile, odd T and T shorter than one tile need no special case.
// Rounding follows the plain chain: in bf16, conv outputs are rounded to
// bf16 before the lrelu and before the residual sum, as F.conv1d's are.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr float kSlope = 0.1f;
constexpr int kMaxSmem = 232448;  // a Hopper block's dynamic shared memory
constexpr int kChunkBytes = 64;   // input channels reduced per stage
constexpr int kRowBytes = 80;     // one time-major activation row
constexpr int kHaloMax = 64;      // (K − 1)·d at most (the plan checks)

// per type: input channels per stage, and per MMA (its k depth); whether
// each (chunk, tap) is summed apart and then added to the total in f32
// (the tensor cores' f32 accumulation truncates, and over the ~1 000 TF32
// MMAs of a C = 256, K = 11 conv that bias alone nears the f32 gate)
template <typename T>
struct Route;
template <>
struct Route<__nv_bfloat16> {
  static constexpr int kChunk = 32, kStep = 16;
  static constexpr bool kPartial = false;
};
template <>
struct Route<float> {
  static constexpr int kChunk = 16, kStep = 8;
  static constexpr bool kPartial = true;
};

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
// v rounded to T and back: the rounding of a conv output stored in T
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}
__device__ __forceinline__ float lrelu(float v) {
  return v >= 0.f ? v : kSlope * v;
}
// one 32-bit word of T values, the first in the low bits
template <typename T>
__device__ __forceinline__ uint32_t pack_word(const float* v);
template <>
__device__ __forceinline__ uint32_t pack_word<float>(const float* v) {
  return __float_as_uint(v[0]);
}
template <>
__device__ __forceinline__ uint32_t pack_word<__nv_bfloat16>(const float* v) {
  const __nv_bfloat162 pr = __floats2bfloat162_rn(v[0], v[1]);
  return *reinterpret_cast<const uint32_t*>(&pr);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned addr =
      static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(addr),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ uint32_t tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}
// four 8×8 matrices of 16-bit elements (or 8×4 of 32-bit ones), one row
// address per lane; lane l receives row l/4, 32-bit word l%4 of each
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4],
                                        const unsigned char* p) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2], __nv_bfloat16) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2], float) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// B fragments (input channels × positions) of NT tiles of 8 positions for
// the MMA depth starting `kc_bytes` into a window row: ldmatrix.x4 over two
// tiles at once (matrices: tile 2p channels +0 / +16 bytes, tile 2p + 1 the
// same). `x` is this lane's row address (see resblock_conv).
template <int NT>
__device__ __forceinline__ void load_b(uint32_t (&b)[NT][2],
                                       const unsigned char* x, int kc_bytes) {
#pragma unroll
  for (int p = 0; p < NT / 2; ++p) {
    uint32_t r[4];
    ldsm_x4(r, x + p * 16 * kRowBytes + kc_bytes);
    b[2 * p][0] = r[0];
    b[2 * p][1] = r[1];
    b[2 * p + 1][0] = r[2];
    b[2 * p + 1][1] = r[3];
  }
}

// One MMA depth (kStep input channels from `kc`) of tap k for a warp's
// MT × NT tiles of 16 output channels × 8 positions. `w` points at the
// weight row of this lane's first output channel (warp's first row + g;
// row stride `wrow` bytes, element (ci, k) at (ci·K + k)), `x` at this
// lane's ldmatrix row for this tap. Fragment layouts are PTX's for
// mma.m16n8k16 / m16n8k8: lane = 4·g + q; A (co × ci) rows g and g + 8.
template <int MT, int NT>
__device__ __forceinline__ void mma_depth(float (&acc)[MT][NT][4],
                                          const unsigned char* w, int wrow,
                                          const unsigned char* x, int K,
                                          int k, int kc, int q,
                                          __nv_bfloat16 tag) {
  // two bf16 weights (ci, ci + 1) of one output channel, packed low first
  auto pair = [&](const unsigned char* row, int ci) -> uint32_t {
    const uint32_t lo = *reinterpret_cast<const unsigned short*>(
        row + 2 * (ci * K + k));
    const uint32_t hi = *reinterpret_cast<const unsigned short*>(
        row + 2 * ((ci + 1) * K + k));
    return lo | (hi << 16);
  };
  uint32_t a[MT][4], b[NT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const unsigned char* r0 = w + mt * 16 * wrow;
    const unsigned char* r1 = r0 + 8 * wrow;
    a[mt][0] = pair(r0, kc + 2 * q);
    a[mt][1] = pair(r1, kc + 2 * q);
    a[mt][2] = pair(r0, kc + 2 * q + 8);
    a[mt][3] = pair(r1, kc + 2 * q + 8);
  }
  load_b<NT>(b, x, 2 * kc);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) mma(acc[mt][nt], a[mt], b[nt], tag);
}

template <int MT, int NT>
__device__ __forceinline__ void mma_depth(float (&acc)[MT][NT][4],
                                          const unsigned char* w, int wrow,
                                          const unsigned char* x, int K,
                                          int k, int kc, int q, float tag) {
  auto wv = [&](const unsigned char* row, int ci) {
    return *reinterpret_cast<const float*>(row + 4 * (ci * K + k));
  };
  auto split = [](float v, uint32_t& hi, uint32_t& lo) {
    hi = tf32(v);
    lo = tf32(v - __uint_as_float(hi));
  };
  uint32_t ah[MT][4], al[MT][4], b[NT][2], bh[NT][2], bl[NT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const unsigned char* r0 = w + mt * 16 * wrow;
    const unsigned char* r1 = r0 + 8 * wrow;
    split(wv(r0, kc + q), ah[mt][0], al[mt][0]);
    split(wv(r1, kc + q), ah[mt][1], al[mt][1]);
    split(wv(r0, kc + q + 4), ah[mt][2], al[mt][2]);
    split(wv(r1, kc + q + 4), ah[mt][3], al[mt][3]);
  }
  load_b<NT>(b, x, 4 * kc);
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      split(__uint_as_float(b[nt][j]), bh[nt][j], bl[nt][j]);
  // the small terms first, then the large one
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      mma(acc[mt][nt], al[mt], bh[nt], tag);
      mma(acc[mt][nt], ah[mt], bl[nt], tag);
      mma(acc[mt][nt], ah[mt], bh[nt], tag);
    }
}

// One conv of a residual step over a tile of (16·MT·WM output channels) ×
// (8·NT·WN positions) of one batch row. kConv2 = false is launch A (conv1,
// dilation d, from x to h), true is launch B (conv2, from h and x to y).
// KSPLIT warp groups share the tile: group s runs the taps k ≡ s (mod
// KSPLIT), and their sums meet in shared memory at the end, in group order.
// K is the kernel size, one of the repo's (3, 7, 11), a template argument
// so that the tap loop unrolls and weight offsets are constants.
template <typename T, int WM, int WN, int MT, int NT, int KSPLIT, bool kConv2,
          int K>
__global__ void __launch_bounds__(32 * WM * WN * KSPLIT)
    resblock_conv(const T* __restrict__ src, const T* __restrict__ w,
                  const T* __restrict__ bias, const T* res, T* dst, int C,
                  int T_len, int d) {
  constexpr int kWarps = WM * WN * KSPLIT, kThreads = 32 * kWarps;
  constexpr int CO_T = 16 * MT * WM, TT = 8 * NT * WN;
  constexpr int CI = Route<T>::kChunk, KS = Route<T>::kStep;
  constexpr int EW = 4 / sizeof(T);  // elements per 32-bit word
  extern __shared__ __align__(16) unsigned char smem[];

  const int dil = kConv2 ? 1 : d;
  const int rows = TT + (K - 1) * dil;
  const int wrow = kChunkBytes * K + 16;
  const int stage_bytes = CO_T * wrow + rows * kRowBytes;
  const int t0 = blockIdx.x * TT, co0 = blockIdx.y * CO_T, b = blockIdx.z;
  const int base = t0 - dil * (K - 1) / 2;  // position of window row 0
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp % WM, wn = (warp / WM) % WN, ks = warp / (WM * WN);
  const int g = lane >> 2, q = lane & 3;
  const size_t plane = static_cast<size_t>(C) * T_len;
  const T* srcb = src + b * plane;  // x (B, C, T) or h (B, T, C)
  // this lane's offsets into a ring slot: its first weight row, and its
  // ldmatrix row of the window (position 8·(lane/16) + lane%8 of the
  // warp's first tile, channel bytes +16 for lanes 8-15 and 24-31)
  const int w_off = (wm * 16 * MT + g) * wrow;
  const int x_off = CO_T * wrow +
                    (wn * 8 * NT + ((lane >> 4) << 3) + (lane & 7)) *
                        kRowBytes +
                    ((lane >> 3) & 1) * 16;

  // cp.async copies of chunk c (input channels [c·CI, c·CI + CI)) into
  // ring slot `buf`: the weights, and in launch B the window of h
  auto copy = [&](int c, int buf) {
    unsigned char* ws = smem + buf * stage_bytes;
    unsigned char* xs = ws + CO_T * wrow;
    const int ci0 = c * CI;
    const int valid = min(CI, C - ci0) * K * static_cast<int>(sizeof(T));
    const int pieces = kChunkBytes * K / 16;
    for (int i = tid; i < CO_T * pieces; i += kThreads) {
      const int co = i / pieces, p = i - co * pieces;
      // a piece past the valid channels is zero-filled: nothing is read
      const bool ok = p * 16 < valid;
      const void* gp = w;
      if (ok)
        gp = reinterpret_cast<const unsigned char*>(
                 w + (static_cast<size_t>(co0 + co) * C + ci0) * K) +
             p * 16;
      cp_async16(ws + co * wrow + p * 16, gp, ok ? 16 : 0);
    }
    if constexpr (kConv2) {
      constexpr int per = 16 / sizeof(T);  // channels per 16-byte piece
      for (int i = tid; i < rows * 4; i += kThreads) {
        const int r = i >> 2, ci = ci0 + (i & 3) * per, pos = base + r;
        const bool ok = pos >= 0 && pos < T_len && ci < C;
        const T* gp = ok ? srcb + static_cast<size_t>(pos) * C + ci : srcb;
        cp_async16(xs + r * kRowBytes + (i & 3) * 16, gp, ok ? 16 : 0);
      }
    }
    cp_async_commit();
  };

  // launch A's window of x goes through registers: `fetch` issues all of a
  // chunk's loads at once (they fly while the MMAs of the chunk before
  // run), `put` stores lrelu(x) time-major, one 32-bit word per store.
  // Lane l takes rows l, l + 32, ...; warp v takes words v, v + kWarps, ...
  constexpr int XW = CI / EW;                          // words per row
  constexpr int XWP = (XW + kWarps - 1) / kWarps;      // words per lane
  constexpr int XRP = (TT + kHaloMax + 31) / 32;       // rows per lane
  T xv[kConv2 ? 1 : XWP][kConv2 ? 1 : XRP][EW];
  auto fetch = [&](int c) {
    if constexpr (!kConv2) {
#pragma unroll
      for (int i = 0; i < XWP; ++i) {
        const int ch = c * CI + (warp + i * kWarps) * EW;
#pragma unroll
        for (int j = 0; j < XRP; ++j) {
          const int r = lane + 32 * j, pos = base + r;
          const bool in = r < rows && pos >= 0 && pos < T_len;
#pragma unroll
          for (int e = 0; e < EW; ++e)
            xv[i][j][e] = (in && ch + e < C)
                              ? srcb[static_cast<size_t>(ch + e) * T_len + pos]
                              : T{};
        }
      }
    }
  };
  auto put = [&](int buf) {
    if constexpr (!kConv2) {
      unsigned char* xs = smem + buf * stage_bytes + CO_T * wrow;
#pragma unroll
      for (int i = 0; i < XWP; ++i) {
        const int cw = warp + i * kWarps;
#pragma unroll
        for (int j = 0; j < XRP; ++j) {
          const int r = lane + 32 * j;
          if (cw >= XW || r >= rows) continue;
          float v[EW];
#pragma unroll
          for (int e = 0; e < EW; ++e) v[e] = lrelu(to_f32(xv[i][j][e]));
          *reinterpret_cast<uint32_t*>(xs + r * kRowBytes + cw * 4) =
              pack_word<T>(v);
        }
      }
    }
  };

  float acc[MT][NT][4], part[Route<T>::kPartial ? MT : 1]
                                [Route<T>::kPartial ? NT : 1][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;

  const int nchunks = (C + CI - 1) / CI;
  copy(0, 0);
  fetch(0);
  put(0);
  for (int c = 0; c < nchunks; ++c) {
    const bool more = c + 1 < nchunks;
    if (more) {
      copy(c + 1, (c + 1) & 1);
      fetch(c + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const unsigned char* ws = smem + (c & 1) * stage_bytes + w_off;
    const unsigned char* xs = smem + (c & 1) * stage_bytes + x_off;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (KSPLIT > 1 && k % KSPLIT != ks) continue;
      const unsigned char* xk = xs + k * dil * kRowBytes;
      if constexpr (Route<T>::kPartial) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int i = 0; i < 4; ++i) part[mt][nt][i] = 0.f;
#pragma unroll
        for (int kc = 0; kc < CI; kc += KS)
          mma_depth<MT, NT>(part, ws, wrow, xk, K, k, kc, q, T{});
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[mt][nt][i] += part[mt][nt][i];
      } else {
#pragma unroll
        for (int kc = 0; kc < CI; kc += KS)
          mma_depth<MT, NT>(acc, ws, wrow, xk, K, k, kc, q, T{});
      }
    }
    if (more) put((c + 1) & 1);
    __syncthreads();
  }

  // Epilogue, through shared memory (the ring is free now): the warp
  // groups' sums are added into one f32 tile in group order, then bias,
  // rounding and lrelu (A) or the residual (B) are applied on the way out,
  // with neighbouring threads on neighbouring addresses of h (channels) or
  // y (positions). The tile is [position][channel] for A, [channel]
  // [position] for B, each row padded by one word.
  float* tile = reinterpret_cast<float*>(smem);
  constexpr int kRow = kConv2 ? TT + 1 : CO_T + 1;
#pragma unroll 1
  for (int s = 0; s < KSPLIT; ++s) {
    if (ks == s) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            // c0, c1 at (co g, positions 2q, 2q+1); c2, c3 at co g + 8
            const int co = wm * 16 * MT + mt * 16 + g + (i >= 2 ? 8 : 0);
            const int t = wn * 8 * NT + nt * 8 + 2 * q + (i & 1);
            float& cell = kConv2 ? tile[co * kRow + t] : tile[t * kRow + co];
            cell = s ? cell + acc[mt][nt][i] : acc[mt][nt][i];
          }
    }
    __syncthreads();
  }
  if constexpr (kConv2) {
    // y: thread e of a row takes position e, a row of TT per channel
    constexpr int kIters = CO_T * TT / kThreads;
    static_assert(kIters * kThreads == CO_T * TT, "tile of whole rounds");
#pragma unroll 8
    for (int j = 0; j < kIters; ++j) {
      const int e = tid + j * kThreads, co = e / TT, t = t0 + e % TT;
      if (t >= T_len) continue;
      const float v =
          round_to<T>(tile[co * kRow + e % TT] + to_f32(bias[co0 + co]));
      const size_t idx = b * plane + static_cast<size_t>(co0 + co) * T_len + t;
      dst[idx] = from_f32<T>(to_f32(res[idx]) + v);
    }
  } else {
    // h: 8 channels of one position per thread, one 16-byte store in bf16
    // (two in f32); kThreads is a multiple of CO_T / 8, so each thread
    // keeps its 8 channels and their biases
    constexpr int kGroups = CO_T / 8;
    static_assert(kThreads % kGroups == 0, "threads keep their channels");
    const int cg = (tid % kGroups) * 8;
    float bv[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) bv[i] = to_f32(bias[co0 + cg + i]);
#pragma unroll
    for (int e = tid; e < TT * kGroups; e += kThreads) {
      const int tl = e / kGroups, t = t0 + tl;
      if (t >= T_len) continue;
      uint32_t word[8 / EW];
#pragma unroll
      for (int i = 0; i < 8; i += EW) {
        float v[EW];
#pragma unroll
        for (int e2 = 0; e2 < EW; ++e2)
          v[e2] = lrelu(round_to<T>(tile[tl * kRow + cg + i + e2] +
                                    bv[i + e2]));
        word[i / EW] = pack_word<T>(v);
      }
      uint4* gp = reinterpret_cast<uint4*>(
          dst + b * plane + static_cast<size_t>(t) * C + co0 + cg);
#pragma unroll
      for (int i = 0; i < 8 / EW / 4; ++i)
        gp[i] = make_uint4(word[4 * i], word[4 * i + 1], word[4 * i + 2],
                           word[4 * i + 3]);
    }
  }
}

template <typename T, int WM, int WN, int MT, int NT, int KSPLIT, bool kConv2,
          int K>
cudaError_t launch_k(const T* src, const T* w, const T* bias, const T* res,
                     T* dst, int B, int C, int T_len, int d, int smem,
                     int device, cudaStream_t stream) {
  constexpr int CO_T = 16 * MT * WM, TT = 8 * NT * WN;
  auto kernel = resblock_conv<T, WM, WN, MT, NT, KSPLIT, kConv2, K>;
  // allowed once per device; the launch's own bytes set the occupancy
  static unsigned long long allowed = 0;  // bit i: device i
  if (device < 64 && !(allowed >> device & 1)) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return err;
    allowed |= 1ull << device;
  } else if (device >= 64) {
    return cudaErrorInvalidDevice;
  }
  const dim3 grid((T_len + TT - 1) / TT, C / CO_T, B);
  kernel<<<grid, 32 * WM * WN * KSPLIT, smem, stream>>>(src, w, bias, res,
                                                        dst, C, T_len, d);
  return cudaGetLastError();
}

template <typename T, int WM, int WN, int MT, int NT, int KSPLIT, bool kConv2>
cudaError_t launch_conv(const T* src, const T* w, const T* bias,
                        const T* res, T* dst, int B, int C, int T_len, int K,
                        int d, int smem, int device, cudaStream_t stream) {
  constexpr int CO_T = 16 * MT * WM, TT = 8 * NT * WN;
  const int rows = TT + (K - 1) * (kConv2 ? 1 : d);
  // the plan's bytes must be the kernel's: 2 ring slots of weights + window,
  // or the epilogue's f32 tile where that is larger
  const int need =
      max(2 * (CO_T * (kChunkBytes * K + 16) + rows * kRowBytes),
          4 * (CO_T * TT + max(CO_T, TT)));
  if (smem != need || smem > kMaxSmem || C % CO_T != 0 ||
      (K - 1) * d > kHaloMax)
    return cudaErrorInvalidValue;
#define SI_K(KC)                                                         \
  return launch_k<T, WM, WN, MT, NT, KSPLIT, kConv2, KC>(                  \
      src, w, bias, res, dst, B, C, T_len, d, smem, device, stream);
  switch (K) {
    case 3: SI_K(3)
    case 7: SI_K(7)
    case 11: SI_K(11)
  }
#undef SI_K
  return cudaErrorInvalidValue;  // the plan takes no other K
}

// the tile table of the source note: (co tile, time tile) → instantiation
template <typename T, bool kConv2>
cudaError_t dispatch(int co_tile, int t_tile, const T* src, const T* w,
                     const T* bias, const T* res, T* dst, int B, int C,
                     int T_len, int K, int d, int smem, int device,
                     cudaStream_t st) {
#define SI_TILE(CO, TT, WM, WN, MT, NT, KSPLIT)                        \
  if (co_tile == CO && t_tile == TT)                                   \
    return launch_conv<T, WM, WN, MT, NT, KSPLIT, kConv2>(             \
        src, w, bias, res, dst, B, C, T_len, K, d, smem, device, st);
  SI_TILE(64, 256, 2, 4, 2, 8, 1)
  SI_TILE(64, 128, 2, 4, 2, 4, 1)
  SI_TILE(64, 64, 2, 2, 2, 4, 2)
  SI_TILE(32, 128, 2, 4, 1, 4, 1)
  SI_TILE(32, 64, 2, 2, 1, 4, 2)
  SI_TILE(16, 128, 1, 4, 1, 4, 2)
  SI_TILE(32, 32, 2, 1, 1, 4, 4)
#undef SI_TILE
  return cudaErrorInvalidValue;
}

// plan: 6 ints per step, (co tile, time tile, shared bytes) of launch A and
// then of launch B
template <typename T>
cudaError_t run_steps(const void* x, const void* w1, const void* b1,
                      const void* w2, const void* b2, void* out, void* h,
                      int B, int C, int T_len, int K, int S,
                      const int* dilations, const int* plan, int device,
                      cudaStream_t st) {
  const size_t wstep = static_cast<size_t>(C) * C * K;
  const T* src = static_cast<const T*>(x);
  T* y = static_cast<T*>(out);
  T* hb = static_cast<T*>(h);
  for (int s = 0; s < S; ++s) {
    const int* p = plan + 6 * s;
    if (dilations[s] < 1) return cudaErrorInvalidValue;
    cudaError_t err = dispatch<T, false>(
        p[0], p[1], src, static_cast<const T*>(w1) + s * wstep,
        static_cast<const T*>(b1) + static_cast<size_t>(s) * C, nullptr, hb,
        B, C, T_len, K, dilations[s], p[2], device, st);
    if (err != cudaSuccess) return err;
    err = dispatch<T, true>(
        p[3], p[4], hb, static_cast<const T*>(w2) + s * wstep,
        static_cast<const T*>(b2) + static_cast<size_t>(s) * C, src, y, B, C,
        T_len, K, 1, p[5], device, st);
    if (err != cudaSuccess) return err;
    src = y;  // later steps update the output in place
  }
  return cudaSuccess;
}

// makes `device` current for its lifetime and then restores the caller's
struct DeviceGuard {
  int prev = -1;
  cudaError_t err = cudaSuccess;
  explicit DeviceGuard(int device) {
    err = cudaGetDevice(&prev);
    if (err == cudaSuccess && prev != device) {
      err = cudaSetDevice(device);
    } else {
      prev = -1;  // nothing to restore
    }
  }
  ~DeviceGuard() {
    if (prev >= 0) cudaSetDevice(prev);
  }
};

}  // namespace

extern "C" {

// x, out: (B, C, T); h: (B, T, C) scratch; w1, w2: (S, C, C, K); b1, b2:
// (S, C); all of dtype `dtype` (0 float32, 1 bfloat16), contiguous, the
// weights 16-byte aligned. K 3, 7 or 11, C a multiple of 16. `plan` holds 6
// ints per step (see run_steps). Enqueues 2·S launches on `stream` on
// `device`, allocates nothing, does not synchronise, leaves the caller's
// current device as it was; returns a cudaError_t.
int si_resblock1(const void* x, const void* w1, const void* b1,
                 const void* w2, const void* b2, void* out, void* h, int B,
                 int C, int T_len, int K, int S, const int* dilations,
                 const int* plan, int dtype, int device, void* stream) {
  if (B < 1 || C < 16 || C % 16 != 0 || T_len < 1 ||
      (K != 3 && K != 7 && K != 11) || S < 1 || h == nullptr)
    return cudaErrorInvalidValue;
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return guard.err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return run_steps<float>(x, w1, b1, w2, b2, out, h, B, C, T_len, K, S,
                            dilations, plan, device, st);
  if (dtype == 1)
    return run_steps<__nv_bfloat16>(x, w1, b1, w2, b2, out, h, B, C, T_len,
                                    K, S, dilations, plan, device, st);
  return cudaErrorInvalidValue;
}

// One residual step (K2): as si_resblock1 with S = 1; w1, w2 (C, C, K),
// b1, b2 (C,), conv1 dilated by `dilation`. Enqueues two launches.
int si_resblock_step(const void* x, const void* w1, const void* b1,
                     const void* w2, const void* b2, void* out, void* h,
                     int B, int C, int T_len, int K, int dilation,
                     const int* plan, int dtype, int device, void* stream) {
  return si_resblock1(x, w1, b1, w2, b2, out, h, B, C, T_len, K, 1,
                      &dilation, plan, dtype, device, stream);
}

const char* si_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
