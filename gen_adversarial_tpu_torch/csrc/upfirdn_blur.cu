// Separable FIR blur of StyleGAN2 (upfirdn2d with up = down = 1):
//     y[n, i, j, c] = sum_a sum_b kf[a] * kf[b] * xpad[n, i + a, j + b, c]
// where kf are the 1-D taps flipped (a true convolution) and xpad is x
// zero-padded by (pad0, pad1) on both spatial axes; the output has
// h + pad0 + pad1 - taps + 1 rows, and as many columns by the same rule.
// Channels-last (NHWC) float32 or bfloat16 tensors (the model's dtype); 3 or
// 4 taps; any pads (a negative pad crops) and any channel count (the ragged
// channel tile is masked). The sums are float32 in both: a bfloat16 input is
// widened as it is staged and the output rounded once, as it is stored.
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
// reads x once from device memory and writes y once: a block stages one
// input tile plus its (taps - 1)-pixel halo in shared memory, and every
// output is summed from there. Neighbouring blocks re-read the halo, which
// mostly hits the 50 MB L2.
//
// Layout of the work: a block owns a 16-row x 8-column output tile and one
// 32-channel tile of one image. A warp's 32 lanes cover 32 consecutive
// channels of one pixel, so every load and store is one coalesced 128-byte
// transaction (at C = 32, the 1024-px generator block, exactly one pixel;
// 64 bytes in bfloat16, where pairing channels would restore 128) and every
// shared-memory access is free of bank conflicts. The staged tile is float32
// in both dtypes. Each thread
// first issues all its staging loads into registers (so many loads are in
// flight at once), then writes them to shared memory. After that, warp
// `col` walks down output column `col`: each staged row feeds the vertical
// sums of the taps columns the output column needs, kept in registers, and
// each finished output row is the horizontal sum of those vertical sums.
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

constexpr int kTileC = 32;  // channels per block: one warp's lanes
constexpr int kWarps = 8;   // output columns per block: one per warp
constexpr int kTileW = kWarps;
constexpr int kTileH = 16;  // output rows per block
constexpr int kMaxTaps = 4;

struct Taps {
  float k[kMaxTaps];  // flipped taps (the correlation taps)
};

// conversions between the element type and float32 (round to nearest even)
__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename E>
__device__ __forceinline__ E narrow(float v);
template <>
__device__ __forceinline__ float narrow<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <int T, typename E>
__global__ void __launch_bounds__(kTileC * kWarps)
blur_kernel(const E* __restrict__ x, E* __restrict__ y, int H, int W, int C,
            int pad0, int h_out, int w_out, int tiles_w, Taps taps) {
  constexpr int kRows = kTileH + T - 1;  // staged rows
  constexpr int kCols = kTileW + T - 1;  // staged columns
  constexpr int kPix = kRows * kCols;
  constexpr int kStaged = (kPix + kWarps - 1) / kWarps;  // staged pixels per thread
  __shared__ float tile[kPix][kTileC];

  const int lane = threadIdx.x;  // channel within the tile
  const int col = threadIdx.y;   // output column within the tile
  const int c = blockIdx.y * kTileC + lane;
  const bool c_ok = c < C;
  const int i0 = (blockIdx.x / tiles_w) * kTileH;
  const int j0 = (blockIdx.x % tiles_w) * kTileW;
  const int64_t n = blockIdx.z;
  const E* xn = x + n * H * W * C;

  // stage the tile and its halo; zeros outside the image (the padding)
  float v[kStaged];
#pragma unroll
  for (int s = 0; s < kStaged; ++s) {
    const int p = col + s * kWarps;
    const int h = i0 - pad0 + p / kCols;
    const int w = j0 - pad0 + p % kCols;
    v[s] = (p < kPix && c_ok && h >= 0 && h < H && w >= 0 && w < W)
               ? widen(__ldg(xn + ((int64_t)h * W + w) * C + c))
               : 0.0f;
  }
#pragma unroll
  for (int s = 0; s < kStaged; ++s) {
    const int p = col + s * kWarps;
    if (p < kPix) tile[p][lane] = v[s];
  }
  __syncthreads();

  const int j = j0 + col;
  if (!c_ok || j >= w_out) return;
  float k[T];
#pragma unroll
  for (int t = 0; t < T; ++t) k[t] = taps.k[t];
  E* yn = y + n * h_out * w_out * C;

  // vert[b][i]: the vertical sum for output row i at staged column col + b;
  // staged row r adds tap r - i to rows r - T + 1 .. r, and completes row
  // r - T + 1
  float vert[T][kTileH];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
#pragma unroll
    for (int b = 0; b < T; ++b) {
      const float s = tile[r * kCols + col + b][lane];
#pragma unroll
      for (int a = 0; a < T; ++a) {
        const int i = r - a;
        if (i >= 0 && i < kTileH) vert[b][i] = a == 0 ? s * k[0] : fmaf(s, k[a], vert[b][i]);
      }
    }
    const int i = r - (T - 1);
    if (i >= 0 && i0 + i < h_out) {
      float out = vert[0][i] * k[0];
#pragma unroll
      for (int b = 1; b < T; ++b) out = fmaf(vert[b][i], k[b], out);
      yn[((int64_t)(i0 + i) * w_out + j) * C + c] = narrow<E>(out);
    }
  }
}

template <int T, typename E>
int launch(const E* x, E* y, int n, int h, int w, int c, int pad0, int pad1,
           const float* taps, cudaStream_t stream) {
  const int h_out = h + pad0 + pad1 - T + 1;
  const int w_out = w + pad0 + pad1 - T + 1;
  Taps kf;
  for (int t = 0; t < T; ++t) kf.k[t] = taps[T - 1 - t];  // flip once
  const int tiles_w = (w_out + kTileW - 1) / kTileW;
  const int tiles_h = (h_out + kTileH - 1) / kTileH;
  const dim3 grid(tiles_h * tiles_w, (c + kTileC - 1) / kTileC, n);
  blur_kernel<T, E><<<grid, dim3(kTileC, kWarps), 0, stream>>>(x, y, h, w, c, pad0, h_out,
                                                              w_out, tiles_w, kf);
  return (int)cudaGetLastError();
}

template <typename E>
int launch_taps(const void* x, void* y, int n, int h, int w, int c, int pad0, int pad1,
                const float* taps, int ntaps, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (ntaps) {
    case 3:
      return launch<3, E>((const E*)x, (E*)y, n, h, w, c, pad0, pad1, taps, s);
    case 4:
      return launch<4, E>((const E*)x, (E*)y, n, h, w, c, pad0, pad1, taps, s);
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
  return launch_taps<float>(x, y, n, h, w, c, pad0, pad1, taps, ntaps, device, stream);
}

// x and y bfloat16; the taps as for float32
extern "C" int gat_upfirdn_blur_bf16(const void* x, void* y, int n, int h, int w, int c,
                                     int pad0, int pad1, const float* taps, int ntaps,
                                     int device, void* stream) {
  return launch_taps<__nv_bfloat16>(x, y, n, h, w, c, pad0, pad1, taps, ntaps, device,
                                    stream);
}

extern "C" const char* gat_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
