// Fused decoder-cell segment of the NVAE:
//     y = silu(DW5x5(silu(x * s0 + b0)) * s1 + b1)
// on channels-last (NHWC) tensors, one read of x and one write of y.
//
// Replaces the Pallas TPU kernel gen_adversarial_tpu/ops/pallas_depthwise.py
// (`_kernel`, launched by `_segment_call`). Same math: XLA correlation
// convention (no tap flip), zero "SAME" padding of 2 applied AFTER the first
// SiLU, float32 arithmetic inside, the model dtype at the edges.
//
// What bounds it on an H100: memory. Per output element it reads one input
// and writes one output (8 bytes in float32) and does about 62 floating-point
// operations (25 fused multiply-adds, two affines, two SiLUs), far below the
// ~20 FLOP/byte where float32 arithmetic would be the limit. The design keeps
// the intermediate silu(x*s0+b0) out of device memory: a block stages its
// input tile plus a 2-pixel halo in shared memory, applying the first affine
// and SiLU once per staged element, so device memory sees x once (plus the
// halo re-read, which mostly hits L2) and y once. The SiLUs' exponentials and
// reciprocals (3.25 per output with the halo) load the special-function
// units about as much as the bytes load the memory; overlapping the two is
// what the double buffering below is for.
//
// Layout of the work: a block owns one 8x8 spatial tile and one 32-channel
// tile of 4 consecutive images, and walks over the images with two shared
// memory buffers: while it computes image n, `cp.async` copies image n+1's
// tile (plus halo) into the other buffer, so device memory stays busy during
// the arithmetic. A warp covers 32 consecutive channels of one pixel, so
// every copy and store is one coalesced 128-byte transaction and every
// shared memory access is bank-conflict free. After a tile lands, each
// thread applies silu(x*s0+b0) in place to the elements it copied (zeros
// outside the image), then warp `col` computes output column `col`, sliding
// down it so a staged value is read once per tap column; each thread keeps
// its channel's 25 taps and the column's 8 partial sums in registers and
// sums in float32. Widths that are not multiples of 32 and images that are
// not multiples of 8 are masked at the edges.
//
// Interface: plain C, loaded with ctypes (no PyTorch headers). The launcher
// takes raw device pointers, the sizes, the device index and the CUDA stream,
// launches asynchronously on that stream, allocates nothing, and returns
// cudaGetLastError().

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTaps = 5;
constexpr int kPad = 2;
constexpr int kTile = 8;    // output rows and columns per block; one column per warp
constexpr int kTileC = 32;  // one warp spans the channel tile
constexpr int kHalo = kTile + 2 * kPad;
constexpr int kHaloPix = kHalo * kHalo;
constexpr int kStaged = kHaloPix / kTile;  // staged pixels per thread
constexpr int kImagesPerBlock = 4;
constexpr int kBlocksPerSM = 3;  // caps registers at 80 per thread

// silu(v) = v * sigmoid(v); the reciprocal is correctly rounded, cheaper
// than a full IEEE division
__device__ __forceinline__ float silu(float v) { return v * __frcp_rn(1.0f + expf(-v)); }

// float32 at the edges. A bfloat16 instantiation copies the raw tile into a
// bf16 buffer of the same shape and converts in the activation pass (where
// silu(x*s0+b0) is written into a float buffer), then stores y with
// __float2bfloat16; it needs one more extern "C" launcher.
__global__ void __launch_bounds__(kTileC * kTile, kBlocksPerSM)
segment_kernel(const float* __restrict__ x, const float* __restrict__ taps,
               const float* __restrict__ s0, const float* __restrict__ b0,
               const float* __restrict__ s1, const float* __restrict__ b1,
               float* __restrict__ y, int N, int H, int W, int C, int tiles_w) {
  __shared__ float buf[2][kHaloPix][kTileC];

  const int lane = threadIdx.x;  // channel within the tile
  const int col = threadIdx.y;   // output column within the tile
  const int c = blockIdx.y * kTileC + lane;
  const bool c_ok = c < C;
  const int h0 = (blockIdx.x / tiles_w) * kTile;
  const int w0 = (blockIdx.x % tiles_w) * kTile;
  const size_t image_elems = (size_t)H * W * C;

  // offset of halo pixel p of this thread's channel in an image; -1 outside
  auto offset = [&](int p) {
    const int h = h0 - kPad + p / kHalo;
    const int w = w0 - kPad + p % kHalo;
    return (c_ok && h >= 0 && h < H && w >= 0 && w < W) ? (h * W + w) * C + c : -1;
  };
  // each thread copies (and later activates) halo pixels col, col+8, ...
  auto prefetch = [&](int n, int b) {
    const float* xn = x + (size_t)n * image_elems;
#pragma unroll
    for (int i = 0; i < kStaged; ++i) {
      const int p = col + i * kTile;
      const int off = offset(p);
      if (off >= 0) __pipeline_memcpy_async(&buf[b][p][lane], xn + off, sizeof(float));
    }
    __pipeline_commit();
  };

  const float a0 = c_ok ? s0[c] : 0.0f, z0 = c_ok ? b0[c] : 0.0f;
  const float a1 = c_ok ? s1[c] : 0.0f, z1 = c_ok ? b1[c] : 0.0f;
  float k[kTaps * kTaps];
#pragma unroll
  for (int i = 0; i < kTaps * kTaps; ++i) k[i] = c_ok ? taps[i * C + c] : 0.0f;

  const int n_first = blockIdx.z * kImagesPerBlock;
  const int n_end = min(N, n_first + kImagesPerBlock);
  prefetch(n_first, 0);
  for (int n = n_first, cur = 0; n < n_end; ++n, cur ^= 1) {
    if (n + 1 < n_end) {
      prefetch(n + 1, cur ^ 1);
    } else {
      __pipeline_commit();  // an empty group keeps the wait below uniform
    }
    __pipeline_wait_prior(1);  // this image's tile has landed
#pragma unroll
    for (int i = 0; i < kStaged; ++i) {
      const int p = col + i * kTile;
      float& v = buf[cur][p][lane];
      v = offset(p) >= 0 ? silu(v * a0 + z0) : 0.0f;  // zero padding after the SiLU
    }
    __syncthreads();

    const int w = w0 + col;
    if (c_ok && w < W) {
      // halo row r feeds output rows r-4 .. r with tap row r - oh; every
      // output sums its taps in the order dy, dx
      float acc[kTile];
#pragma unroll
      for (int oh = 0; oh < kTile; ++oh) acc[oh] = 0.0f;
#pragma unroll
      for (int r = 0; r < kHalo; ++r) {
        float v[kTaps];
#pragma unroll
        for (int dx = 0; dx < kTaps; ++dx) v[dx] = buf[cur][r * kHalo + col + dx][lane];
#pragma unroll
        for (int dy = 0; dy < kTaps; ++dy) {
          const int oh = r - dy;
          if (oh >= 0 && oh < kTile) {
#pragma unroll
            for (int dx = 0; dx < kTaps; ++dx) acc[oh] = fmaf(v[dx], k[dy * kTaps + dx], acc[oh]);
          }
        }
      }
      float* yn = y + (size_t)n * image_elems;
#pragma unroll
      for (int oh = 0; oh < kTile; ++oh) {
        const int h = h0 + oh;
        if (h < H) yn[(h * W + w) * C + c] = silu(acc[oh] * a1 + z1);
      }
    }
    __syncthreads();  // buf[cur] is refilled by the next iteration's prefetch
  }
}

int launch_f32(const void* x, const void* taps, const void* s0, const void* b0,
               const void* s1, const void* b1, void* y, int n, int h, int w, int c,
               int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int tiles_w = (w + kTile - 1) / kTile;
  const int tiles_h = (h + kTile - 1) / kTile;
  const dim3 grid(tiles_h * tiles_w, (c + kTileC - 1) / kTileC,
                  (n + kImagesPerBlock - 1) / kImagesPerBlock);
  segment_kernel<<<grid, dim3(kTileC, kTile), 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)taps, (const float*)s0, (const float*)b0,
      (const float*)s1, (const float*)b1, (float*)y, n, h, w, c, tiles_w);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int gat_depthwise_segment_f32(const void* x, const void* taps, const void* s0,
                                         const void* b0, const void* s1, const void* b1,
                                         void* y, int n, int h, int w, int c, int device,
                                         void* stream) {
  return launch_f32(x, taps, s0, b0, s1, b1, y, n, h, w, c, device, stream);
}

extern "C" const char* gat_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
