// Separable FIR blur of StyleGAN2 (upfirdn2d with up = down = 1):
//     y[n, i, j, c] = sum_a sum_b kf[a] * kf[b] * xpad[n, i + a, j + b, c]
// where kf are the 1-D taps flipped (a true convolution) and xpad is x
// zero-padded by (pad0, pad1) on both spatial axes; the output has
// h + pad0 + pad1 - taps + 1 rows, and as many columns by the same rule.
// Channels-last (NHWC) float32 or bfloat16 tensors (the model's dtype); 3 or
// 4 taps; any pads (a negative pad crops) and any channel count (the ragged
// channel tile is masked). The sums are float32 in both dtypes, in the same
// order: a bfloat16 input is widened as it is read and the output rounded
// once, as it is stored.
//
// Replaces the Pallas TPU kernel gen_adversarial_tpu/ops/pallas_upfirdn.py
// (`_blur_kernel`, launched by `_pallas_blur_call`). Same math and the same
// summation order: the vertical pass first (taps in order), then the
// horizontal pass over the vertical sums. Not carried over: the TPU's
// 128-lane channel tiles, 8-row alignment, the DMA of the whole padded width
// and the padded copy of x the TPU wrapper makes; zero padding is applied
// here while the tile is loaded.
//
// What bounds it on an H100: memory. Per output element it reads about one
// input and writes one output (8 bytes in float32, 4 in bfloat16) against 2 * taps
// multiply-adds, far below the card's float32 balance point. So the design
// reads x once from device memory and writes y once: a block reads one
// input tile plus its (taps - 1)-pixel halo, and every output is summed
// on chip. Neighbouring blocks re-read the halo, which mostly hits the 50 MB
// L2.
//
// float32 layout (`blur_f32_kernel`). The first float32 design moved
// one 4-byte channel a lane (128 bytes a warp access): a thread issued some
// 27 scalar staging loads, each with its own bounds test and 64-bit offset,
// for a 16 x 8 output tile that staged 1.63 pixels an output, and it reached
// 58 % of its byte bound. This one takes the bfloat16 layout below in
// float32: a lane moves 16 bytes, four channels, in every global access; a
// block owns a 16-row x (33 - taps)-column output tile of 32 channels
// (eight 4-channel vectors; 1.31 staged pixels an output), 256 threads, in
// two passes through the same 64 KB float32 shared tile of vertical sums:
// 1. Vertical. Thread (vector v, staged column c) loads the 16 + taps - 1
//    input pixels of its column (16 bytes each, all issued before the first
//    is used; zeros outside the image) and writes its 16 vertical sums. A
//    warp reads 4 neighbouring pixels' 32 channels: 512 contiguous bytes at
//    C = 32.
// 2. Horizontal. Thread (vector v, output row, column half) slides along its
//    (up to) 16 output columns, keeping the last taps vertical sums in
//    registers, and stores each output's 4 channels as one 16-byte store.
// A quarter-warp's 8 vectors are one pixel's 128 contiguous bytes of the
// shared tile in both passes, so no swizzle is needed. It reaches 87-89 % of
// its byte bound over a decode, as fast as a copy of the same bytes at the
// 1024-px site (PERF.md). Staging by TMA (a 4-D tensor map over x, a ring of
// two tiles in one persistent block an SM, as K1 does) was 3-23 % slower at
// every site of 33 px and up, and was not kept. Where C is not a multiple of
// 4 (or x or y not 16-byte aligned) the same kernel moves each vector as 4
// masked scalars (`kVec` false): the same sums in the same order, so both
// paths, and the first design, give the same bits.
//
// bfloat16 layout (`blur_bf16_kernel`). One channel a lane would move 64
// bytes a warp instruction, and the first float32 layout's time did not fall when
// its bytes halved: the loads and stores a warp issues, not the bytes,
// bound it. So a lane moves 16 bytes, eight channels, in every global
// access: a block owns a 16-row x (33 - taps)-column output tile of 32
// channels (four 8-channel vectors), 256 threads, in two passes through a
// float32 shared-memory tile of the vertical sums:
// 1. Vertical. Thread (vector v, staged column c, row half) loads the
//    8 + taps - 1 input pixels of its column (16 bytes each, all issued
//    before the first is used; zeros outside the image, which is the
//    padding) and writes the vertical sums of its 8 output rows. A warp
//    reads 8 neighbouring pixels' 32 channels: 512 contiguous bytes at C =
//    32. The 32 staged columns cover the output columns plus the halo.
// 2. Horizontal. Thread (vector v, output row, column quarter) slides along
//    its (up to) 8 output columns, keeping the last taps vertical sums in
//    registers, and stores each output's 8 channels rounded to bfloat16 as
//    one 16-byte store.
// The shared tile's 16-byte units are swizzled by the parity of (row +
// column), so both passes' 128-bit accesses are free of bank conflicts.
// Where C is not a multiple of 8 (or x or y not 16-byte aligned) the same
// kernel moves each vector as 8 masked scalars (`kVec` false).
//
// Offsets are 64-bit: at the 1024-px site x holds 64 x 1025 x 1025 x 32 =
// 2.15e9 elements, more than a 32-bit index can address.
//
// Interface: plain C, loaded with ctypes (no PyTorch headers). The launcher
// takes raw device pointers, the sizes, the taps as host floats, the device
// index and the CUDA stream; it launches asynchronously on that stream,
// allocates nothing, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kTileC = 32;  // channels per block
constexpr int kTileH = 16;  // output rows per block
constexpr int kMaxTaps = 4;
constexpr int kMaxDevices = 64;

struct Taps {
  float k[kMaxTaps];  // flipped taps (the correlation taps)
};

// the bfloat16 build: see the header (bfloat16 layout)
constexpr int kVecC = 8;                  // channels a lane moves: 16 bytes
constexpr int kVecs = kTileC / kVecC;     // vectors per block
constexpr int kStagedCols = 32;           // staged columns: output tile + halo
constexpr int kHalfRows = kTileH / 2;     // output rows of a vertical-pass thread
constexpr int kQuarterCols = 8;           // output columns of a horizontal-pass thread
constexpr int kBf16Threads = kVecs * kStagedCols * 2;
// the vertical sums: kTileH x kStagedCols pixels x kTileC float32 channels
constexpr int kSumBytes = kTileH * kStagedCols * kTileC * 4;
static_assert(kBf16Threads == 256, "the vertical pass gives every thread one column and half");
static_assert(kVecs * kTileH * 4 == kBf16Threads, "the horizontal pass: four column quarters");

// 8 bfloat16 (as 4 words) <-> 8 float32: widening is exact, and the
// narrowing rounds to nearest even, as __float2bfloat16_rn does
__device__ __forceinline__ void widen8(const uint4& raw, float f[kVecC]) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    f[2 * q] = __uint_as_float(w[q] << 16);
    f[2 * q + 1] = __uint_as_float(w[q] & 0xffff0000u);
  }
}
__device__ __forceinline__ uint4 narrow8(const float f[kVecC]) {
  uint32_t w[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * q], f[2 * q + 1]);
    w[q] = *reinterpret_cast<const uint32_t*>(&h);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// the 16-byte unit of the vertical sums of (output row i, staged column c,
// vector v, half h of its 8 channels); the swizzle keeps each quarter-warp's
// 128-bit accesses on 8 different unit slots in both passes
__device__ __forceinline__ int sum_unit(int i, int c, int v, int h) {
  return (i * kStagedCols + c) * (2 * kVecs) + ((2 * v + h) ^ ((i + c) & 1));
}

template <int T, bool kVec>
__global__ void __launch_bounds__(kBf16Threads)
blur_bf16_kernel(const __nv_bfloat16* __restrict__ x, __nv_bfloat16* __restrict__ y, int H,
                 int W, int C, int pad0, int h_out, int w_out, int tiles_w, Taps taps) {
  constexpr int kTileWOut = kStagedCols - (T - 1);  // output columns a block
  constexpr int kLoadRows = kHalfRows + T - 1;
  extern __shared__ __align__(16) float4 sums[];

  const int i0 = (blockIdx.x / tiles_w) * kTileH;
  const int j0 = (blockIdx.x % tiles_w) * kTileWOut;
  const int64_t n = blockIdx.z;
  float k[T];
#pragma unroll
  for (int t = 0; t < T; ++t) k[t] = taps.k[t];

  // 1. vertical: (vector v, staged column c, row half)
  {
    const int v = threadIdx.x % kVecs;
    const int c = (threadIdx.x / kVecs) % kStagedCols;
    const int half = threadIdx.x / (kVecs * kStagedCols);
    const int cb = blockIdx.y * kTileC + v * kVecC;  // first channel of the vector
    const int w = j0 - pad0 + c;
    const int h_first = i0 - pad0 + half * kHalfRows;
    const bool col_ok = w >= 0 && w < W && cb < C;
    const __nv_bfloat16* xc = x + ((n * H) * W + w) * (int64_t)C + cb;
    uint4 raw[kLoadRows];
#pragma unroll
    for (int r = 0; r < kLoadRows; ++r) {
      const int h = h_first + r;
      raw[r] = make_uint4(0, 0, 0, 0);
      if (col_ok && h >= 0 && h < H) {
        const __nv_bfloat16* p = xc + (int64_t)h * W * C;
        if (kVec) {
          raw[r] = __ldg(reinterpret_cast<const uint4*>(p));
        } else {
          uint16_t e[kVecC];
#pragma unroll
          for (int q = 0; q < kVecC; ++q)
            e[q] = cb + q < C ? __ldg(reinterpret_cast<const unsigned short*>(p) + q) : 0;
          raw[r] = make_uint4(e[0] | (uint32_t)e[1] << 16, e[2] | (uint32_t)e[3] << 16,
                              e[4] | (uint32_t)e[5] << 16, e[6] | (uint32_t)e[7] << 16);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kHalfRows; ++i) {
      float s[kVecC], f[kVecC];
      widen8(raw[i], f);
#pragma unroll
      for (int q = 0; q < kVecC; ++q) s[q] = f[q] * k[0];
#pragma unroll
      for (int a = 1; a < T; ++a) {
        widen8(raw[i + a], f);
#pragma unroll
        for (int q = 0; q < kVecC; ++q) s[q] = fmaf(f[q], k[a], s[q]);
      }
      const int row = half * kHalfRows + i;
      sums[sum_unit(row, c, v, 0)] = make_float4(s[0], s[1], s[2], s[3]);
      sums[sum_unit(row, c, v, 1)] = make_float4(s[4], s[5], s[6], s[7]);
    }
  }
  __syncthreads();

  // 2. horizontal: (vector v, output row, column quarter)
  const int v = threadIdx.x % kVecs;
  const int row = (threadIdx.x / kVecs) % kTileH;
  const int quarter = threadIdx.x / (kVecs * kTileH);
  const int cb = blockIdx.y * kTileC + v * kVecC;
  const int gi = i0 + row;
  if (gi >= h_out || cb >= C) return;
  const int jl0 = quarter * kQuarterCols;
  __nv_bfloat16* yr = y + ((n * h_out + gi) * w_out) * (int64_t)C + cb;
  float win[T][kVecC];  // the vertical sums of staged columns jl .. jl + T - 1
  auto fetch = [&](int slot, int col) {
    const float4 lo = sums[sum_unit(row, col, v, 0)];
    const float4 hi = sums[sum_unit(row, col, v, 1)];
    win[slot][0] = lo.x; win[slot][1] = lo.y; win[slot][2] = lo.z; win[slot][3] = lo.w;
    win[slot][4] = hi.x; win[slot][5] = hi.y; win[slot][6] = hi.z; win[slot][7] = hi.w;
  };
#pragma unroll
  for (int b = 0; b < T - 1; ++b) fetch(b, jl0 + b);
#pragma unroll
  for (int q = 0; q < kQuarterCols; ++q) {
    const int jl = jl0 + q;
    const int gj = j0 + jl;
    if (jl >= kTileWOut || gj >= w_out) break;
    fetch((q + T - 1) % T, jl + T - 1);
    float out[kVecC];
#pragma unroll
    for (int e = 0; e < kVecC; ++e) out[e] = win[q % T][e] * k[0];
#pragma unroll
    for (int b = 1; b < T; ++b) {
#pragma unroll
      for (int e = 0; e < kVecC; ++e) out[e] = fmaf(win[(q + b) % T][e], k[b], out[e]);
    }
    __nv_bfloat16* p = yr + (int64_t)gj * C;
    const uint4 packed = narrow8(out);
    if (kVec) {
      *reinterpret_cast<uint4*>(p) = packed;
    } else {
      const uint32_t w[4] = {packed.x, packed.y, packed.z, packed.w};
#pragma unroll
      for (int e = 0; e < kVecC; ++e) {
        if (cb + e < C)
          reinterpret_cast<unsigned short*>(p)[e] = (unsigned short)(w[e / 2] >> (16 * (e % 2)));
      }
    }
  }
}

// the float32 build: see the header (float32 layout)
constexpr int kF32Vec = 4;                            // channels a lane moves: 16 bytes
constexpr int kF32Vecs = kTileC / kF32Vec;            // vectors a pixel of the channel tile
constexpr int kF32Threads = kF32Vecs * kStagedCols;   // one (vector, staged column) each
constexpr int kHalfCols = kStagedCols / 2;            // output columns of a horizontal thread
static_assert(kF32Threads == 256, "the vertical pass gives every thread one staged column");
static_assert(kF32Vecs * kTileH * 2 == kF32Threads, "the horizontal pass: two column halves");

// the 16-byte unit of the vertical sums of (output row i, staged column c,
// vector v): a quarter-warp's 8 vectors of one pixel are 128 contiguous
// bytes, so both passes' 128-bit accesses are free of bank conflicts
__device__ __forceinline__ int f32_unit(int i, int c, int v) {
  return (i * kStagedCols + c) * kF32Vecs + v;
}
__device__ __forceinline__ float4 mul4(float4 a, float k) {
  return make_float4(a.x * k, a.y * k, a.z * k, a.w * k);
}
__device__ __forceinline__ float4 fma4(float4 a, float k, float4 s) {
  return make_float4(fmaf(a.x, k, s.x), fmaf(a.y, k, s.y), fmaf(a.z, k, s.z), fmaf(a.w, k, s.w));
}

template <int T, bool kVec>
__global__ void __launch_bounds__(kF32Threads, 2)
blur_f32_kernel(const float* __restrict__ x, float* __restrict__ y, int H, int W, int C,
                int pad0, int h_out, int w_out, int tiles_w, Taps taps) {
  constexpr int kTileWOut = kStagedCols - (T - 1);  // output columns a block
  constexpr int kRows = kTileH + T - 1;             // staged rows
  extern __shared__ __align__(16) float4 f32_sums[];

  const int i0 = (blockIdx.x / tiles_w) * kTileH;
  const int j0 = (blockIdx.x % tiles_w) * kTileWOut;
  const int64_t n = blockIdx.z;
  const int v = threadIdx.x % kF32Vecs;
  const int cb = blockIdx.y * kTileC + v * kF32Vec;  // first channel of the vector
  float k[T];
#pragma unroll
  for (int t = 0; t < T; ++t) k[t] = taps.k[t];

  // 1. vertical: (vector v, staged column c)
  {
    const int c = threadIdx.x / kF32Vecs;
    const int w = j0 - pad0 + c;
    const bool col_ok = w >= 0 && w < W && cb < C;
    const float* xc = x + ((n * H) * W + w) * (int64_t)C + cb;
    float4 raw[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int h = i0 - pad0 + r;
      raw[r] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (col_ok && h >= 0 && h < H) {
        const float* p = xc + (int64_t)h * W * C;
        if (kVec) {
          raw[r] = __ldg(reinterpret_cast<const float4*>(p));
        } else {
          raw[r].x = __ldg(p);
          if (cb + 1 < C) raw[r].y = __ldg(p + 1);
          if (cb + 2 < C) raw[r].z = __ldg(p + 2);
          if (cb + 3 < C) raw[r].w = __ldg(p + 3);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kTileH; ++i) {
      float4 s = mul4(raw[i], k[0]);
#pragma unroll
      for (int a = 1; a < T; ++a) s = fma4(raw[i + a], k[a], s);
      f32_sums[f32_unit(i, c, v)] = s;
    }
  }
  __syncthreads();

  // 2. horizontal: (vector v, output row, column half)
  const int row = (threadIdx.x / kF32Vecs) % kTileH;
  const int half = threadIdx.x / (kF32Vecs * kTileH);
  const int gi = i0 + row;
  if (gi >= h_out || cb >= C) return;
  const int jl0 = half * kHalfCols;
  float* yr = y + ((n * h_out + gi) * w_out) * (int64_t)C + cb;
  float4 win[T];  // the vertical sums of staged columns jl .. jl + T - 1
#pragma unroll
  for (int b = 0; b < T - 1; ++b) win[b] = f32_sums[f32_unit(row, jl0 + b, v)];
#pragma unroll
  for (int q = 0; q < kHalfCols; ++q) {
    const int jl = jl0 + q;
    const int gj = j0 + jl;
    if (jl >= kTileWOut || gj >= w_out) break;
    win[(q + T - 1) % T] = f32_sums[f32_unit(row, jl + T - 1, v)];
    float4 out = mul4(win[q % T], k[0]);
#pragma unroll
    for (int b = 1; b < T; ++b) out = fma4(win[(q + b) % T], k[b], out);
    float* p = yr + (int64_t)gj * C;
    if (kVec) {
      *reinterpret_cast<float4*>(p) = out;
    } else {
      p[0] = out.x;
      if (cb + 1 < C) p[1] = out.y;
      if (cb + 2 < C) p[2] = out.z;
      if (cb + 3 < C) p[3] = out.w;
    }
  }
}

template <int T, bool kVec>
int launch_f32_vec(const float* x, float* y, int n, int h, int w, int c, int pad0, int h_out,
                   int w_out, Taps kf, int device, cudaStream_t stream) {
  // above 48 KB, dynamic shared memory needs the kernel's consent, once per
  // device and instance
  static bool consented[kMaxDevices] = {};
  if (device < 0 || device >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!consented[device]) {
    const cudaError_t err = cudaFuncSetAttribute(
        blur_f32_kernel<T, kVec>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSumBytes);
    if (err != cudaSuccess) return (int)err;
    consented[device] = true;
  }
  constexpr int kTileWOut = kStagedCols - (T - 1);
  const int tiles_w = (w_out + kTileWOut - 1) / kTileWOut;
  const int tiles_h = (h_out + kTileH - 1) / kTileH;
  const dim3 grid(tiles_h * tiles_w, (c + kTileC - 1) / kTileC, n);
  blur_f32_kernel<T, kVec><<<grid, kF32Threads, kSumBytes, stream>>>(
      x, y, h, w, c, pad0, h_out, w_out, tiles_w, kf);
  return (int)cudaGetLastError();
}

template <int T>
int launch_f32(const float* x, float* y, int n, int h, int w, int c, int pad0, int h_out,
               int w_out, Taps kf, int device, cudaStream_t stream) {
  // 16-byte vectors need every pixel's channels 16-byte aligned
  const bool vec = c % kF32Vec == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(y) % 16 == 0;
  auto go = vec ? launch_f32_vec<T, true> : launch_f32_vec<T, false>;
  return go(x, y, n, h, w, c, pad0, h_out, w_out, kf, device, stream);
}

template <int T, bool kVec>
int launch_bf16_vec(const __nv_bfloat16* x, __nv_bfloat16* y, int n, int h, int w, int c,
                    int pad0, int h_out, int w_out, Taps kf, int device, cudaStream_t stream) {
  // above 48 KB, dynamic shared memory needs the kernel's consent, once per
  // device and instance
  static bool consented[kMaxDevices] = {};
  if (device < 0 || device >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!consented[device]) {
    const cudaError_t err = cudaFuncSetAttribute(
        blur_bf16_kernel<T, kVec>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSumBytes);
    if (err != cudaSuccess) return (int)err;
    consented[device] = true;
  }
  constexpr int kTileWOut = kStagedCols - (T - 1);
  const int tiles_w = (w_out + kTileWOut - 1) / kTileWOut;
  const int tiles_h = (h_out + kTileH - 1) / kTileH;
  const dim3 grid(tiles_h * tiles_w, (c + kTileC - 1) / kTileC, n);
  blur_bf16_kernel<T, kVec><<<grid, kBf16Threads, kSumBytes, stream>>>(
      x, y, h, w, c, pad0, h_out, w_out, tiles_w, kf);
  return (int)cudaGetLastError();
}

template <int T>
int launch_bf16(const __nv_bfloat16* x, __nv_bfloat16* y, int n, int h, int w, int c,
                int pad0, int h_out, int w_out, Taps kf, int device, cudaStream_t stream) {
  // 16-byte vectors need every pixel's channels 16-byte aligned
  const bool vec = c % kVecC == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(y) % 16 == 0;
  auto go = vec ? launch_bf16_vec<T, true> : launch_bf16_vec<T, false>;
  return go(x, y, n, h, w, c, pad0, h_out, w_out, kf, device, stream);
}

template <int T>
int launch(bool bf16, const void* x, void* y, int n, int h, int w, int c, int pad0, int pad1,
           const float* taps, int device, cudaStream_t stream) {
  const int h_out = h + pad0 + pad1 - T + 1;
  const int w_out = w + pad0 + pad1 - T + 1;
  Taps kf;
  for (int t = 0; t < T; ++t) kf.k[t] = taps[T - 1 - t];  // flip once
  if (bf16)
    return launch_bf16<T>((const __nv_bfloat16*)x, (__nv_bfloat16*)y, n, h, w, c, pad0, h_out,
                          w_out, kf, device, stream);
  return launch_f32<T>((const float*)x, (float*)y, n, h, w, c, pad0, h_out, w_out, kf, device,
                       stream);
}

int launch_taps(bool bf16, const void* x, void* y, int n, int h, int w, int c, int pad0,
                int pad1, const float* taps, int ntaps, int device, void* stream) {
  // the launch goes to the current device: switch only when it is another
  int current = -1;
  if (cudaGetDevice(&current) != cudaSuccess || current != device) {
    const cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
  }
  const cudaStream_t s = (cudaStream_t)stream;
  switch (ntaps) {
    case 3:
      return launch<3>(bf16, x, y, n, h, w, c, pad0, pad1, taps, device, s);
    case 4:
      return launch<4>(bf16, x, y, n, h, w, c, pad0, pad1, taps, device, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// x and y float32; taps: `ntaps` host floats (3 or 4), in upfirdn order (not
// yet flipped)
extern "C" int gat_upfirdn_blur_f32(const void* x, void* y, int n, int h, int w, int c,
                                    int pad0, int pad1, const float* taps, int ntaps,
                                    int device, void* stream) {
  return launch_taps(false, x, y, n, h, w, c, pad0, pad1, taps, ntaps, device, stream);
}

// x and y bfloat16; the taps as for float32
extern "C" int gat_upfirdn_blur_bf16(const void* x, void* y, int n, int h, int w, int c,
                                     int pad0, int pad1, const float* taps, int ntaps,
                                     int device, void* stream) {
  return launch_taps(true, x, y, n, h, w, c, pad0, pad1, taps, ntaps, device, stream);
}

extern "C" const char* gat_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
