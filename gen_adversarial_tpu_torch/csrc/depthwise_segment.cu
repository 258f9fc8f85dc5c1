// Fused decoder-cell segment of the NVAE:
//     y = silu(DW5x5(silu(x * s0 + b0)) * s1 + b1)
// on channels-last (NHWC) tensors, one read of x and one write of y; x and y
// are float32 or bfloat16 (the model's dtype), taps and affines float32.
//
// Replaces the Pallas TPU kernel gen_adversarial_tpu/ops/pallas_depthwise.py
// (`_kernel`, launched by `_segment_call`). Same math: XLA correlation
// convention (no tap flip), zero "SAME" padding of 2 applied AFTER the first
// SiLU, float32 arithmetic inside, the model's dtype at the edges: in
// bfloat16 only y is rounded, once, as it is stored.
//
// What bounds it on an H100: instruction issue, before memory. Per output it
// moves 8 bytes in float32 (one read of x, one write of y; 4 in bfloat16):
// 4.03 ms (2.01 ms in bfloat16) for the 1.686e9 outputs of a flagship decode
// at 3.35 TB/s. Its arithmetic floor is the 25 FMAs of the depthwise, but
// what a thread issues around them decides the time. The first design
// (per-element `cp.async` staging of an 8x8 tile with a bounds-checked
// offset per element, accurate SiLUs with their slow-path calls, 1.72
// first SiLUs an output from the 12x12 halo) issues about 150 SASS
// instructions an output (its loop over one image: about 1,460 a thread
// for 8 outputs), which at the card's peak issue rate alone is longer than
// the byte bound. This design issues about 54 an output on 16x16 tiles (1,715
// a thread for 32 outputs: 567 for the activation pass, 1,036 for the
// depthwise, 112 for the epilogue) and 66 on the 8x8 map, through three
// changes:
//
// 1. Staging by TMA. The host encodes a 4-D tensor map over x, dims
//    (C, W, H, N) innermost first, box (32 channels, T+4, T+4, 1). One
//    thread issues `cp.async.bulk.tensor` for a tile plus its 2-pixel halo
//    at signed start (w0-2, h0-2) and arms the stage's mbarrier with the
//    byte count; the hardware computes every address and fills what lies
//    outside the tensor with zeros. No thread spends an instruction on a
//    copy address or a bounds check. A ring of stages walks the block's
//    images, so the next image's load is in flight while this one is
//    computed. The TMA's zero fill pads x, not silu(x*s0+b0): the
//    activation pass keeps the zeros at pixels outside the image by a test
//    of coordinates that is uniform across a warp (a warp holds one pixel's
//    32 channels) and a select, with no branch. The outputs leave the same
//    way: written into the stage's interior, stored by one thread as T
//    row boxes of a second tensor map over y, which drops what falls
//    outside y (ragged channels, columns and rows need no mask).
// 2. A cheaper SiLU: v / (1 + exp(-v)) as the special-function unit's exp2
//    and reciprocal (`ex2.approx.ftz`, `rcp.approx.ftz`): five instructions.
//    That is __fdividef(v, 1 + __expf(-v)) without those intrinsics' range
//    fix-ups. In this file only: the build's flags stay free of
//    --use_fast_math, which would also change K2.
// 3. Larger spatial tiles, a template parameter picked by the launcher: the
//    whole 8x8 map at H = 8, 16x16 tiles above. At the flagship's shapes the
//    first SiLU runs 1.18 times an output instead of 1.72, and the halo bytes
//    a tile re-reads fall with it.
//
// Layout of the work: a block owns one TxT spatial tile and one 32-channel
// tile of a few consecutive images. Warp `w` computes output columns
// w*kCols .. w*kCols+kCols-1 of the tile, sliding down them so a staged row
// of kCols+4 values is read once for all its taps; each thread keeps its
// channel's 25 taps and the columns' T partial sums in registers and sums in
// float32, taps in the order dy, dx. Every shared-memory access of a warp is
// one 128-byte row (bank-conflict free). Per image: wait on the stage's
// mbarrier, activate the stage in place, barrier, depthwise, barrier,
// second affine + SiLU into the stage, proxy fence and barrier, then one
// thread issues the row stores, waits until they have read the stage and
// refills it with the image `kStages` ahead.
//
// bfloat16 (`segment_bf16_kernel`). The float32 layout is bound by what it
// issues, and one channel a lane issues the float32 build's instructions for
// half the bytes (PERF.md). So the bfloat16 build moves two channels
// a lane: a half-warp holds one pixel's 32 channels, a warp two pixels.
// The stages hold the bfloat16 input as the TMA brings it (64-byte rows);
// the activation pass reads a channel pair with one 32-bit load and writes
// its two float32 activations with one 64-bit store into a float32 tile of
// its own, so silu(x*s0+b0) enters the 25-tap sum unrounded, as in the
// Pallas kernel; a warp whose two pixels lie outside the image (the
// padding ring: 36 % of the halo at 16 px) writes their zeros without the
// SiLUs. In the depthwise, half-warp `h` of warp `w` computes
// output column 2w + h for its 16 channel pairs: each 64-bit load of the
// activated tile feeds both channels' taps, the taps and affines are held
// as pairs. The outputs are rounded to bfloat16 pairs into the stage's
// interior and leave by the same TMA row stores. The tile, stages, threads
// and shared memory are the float32 build's: the same blocks an SM.
//
// Channel width: a TMA row pitch (C x 4 bytes in float32, C x 2 in bfloat16)
// must be a multiple of 16, so C must be a multiple of 4 (float32) or 8
// (bfloat16), and x and y 16-byte aligned. Every NVAE width qualifies; the
// wrapper (ops/depthwise.py) refuses other widths on a CUDA tensor rather
// than keep a second staging path.
//
// Sizes: no thread computes a global address. The TMA takes one 32-bit
// coordinate a dimension and 64-bit strides, and the tensor maps' encoder
// refuses what it cannot map (kErrEncode).
//
// kStages, kCols and kImages were chosen by an A/B on the card at the
// flagship's seven shapes, each variant an edited copy of this file timed
// by gen_adversarial_tpu_torch/ab_k1.py (PERF.md): two columns a warp beat
// one (a 64-register cap spills) and four (232 registers, 8 warps an SM);
// two stages beat three (one block an SM); taps in shared memory lost to
// registers by 60 %; the TMA store won 2.6 % over direct coalesced stores.
//
// Interface: plain C, loaded with ctypes (no PyTorch headers). The launcher
// takes raw device pointers, the sizes, the device index and the CUDA stream,
// launches asynchronously on that stream, allocates nothing, and returns
// cudaGetLastError() (or a negative code of its own, see
// gat_cuda_error_string). The tensor maps' encoder is taken from the CUDA
// driver through the runtime's entry-point query, so the library needs no
// -lcuda.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTaps = 5;
constexpr int kPad = 2;
constexpr int kTileC = 32;  // one warp spans the channel tile
// chosen by an A/B on the card (PERF.md)
constexpr int kStages = 2;  // shared-memory stages in the ring
constexpr int kCols = 2;    // output columns per warp
constexpr int kImages = 4;  // images a block walks
// resident threads an SM that __launch_bounds__ plans for (64 registers a
// thread), unless shared memory admits fewer blocks (then more registers)
constexpr int kThreadsPerSM = 1024;

constexpr int kMaxDevices = 64;

constexpr int kErrNoEncoder = -1;  // cuTensorMapEncodeTiled not found
constexpr int kErrEncode = -2;     // the tensor map was refused
constexpr int kErrWidth = -3;      // C not a multiple of 4, or x or y not 16-byte aligned
constexpr int kErrWidthBf16 = -4;  // the same in bfloat16, where C must be a multiple of 8

// the element type of x and y: its tensor-map type
template <typename E>
struct Elem;
template <>
struct Elem<float> {
  static constexpr CUtensorMapDataType kMapType = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
};
template <>
struct Elem<__nv_bfloat16> {
  static constexpr CUtensorMapDataType kMapType = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
};

// silu(v) = v / (1 + exp(-v)), as __fdividef(v, 1 + __expf(-v)) computes it
// (the special-function unit's exp2 and reciprocal) but without those
// intrinsics' range fix-ups, which cost a compare and two predicated
// multiplies each: five instructions. For v far below 0 the denominator
// overflows to inf, its reciprocal is 0 and so is the result.
__device__ __forceinline__ float silu(float v) {
  float e, r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(e) : "f"(v * -1.4426950408889634f));
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(1.0f + e));
  return v * r;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(smem_addr(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

// A load that never lands (a refused copy) traps after some seconds: a
// launch failure the caller sees, not a hung card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  for (uint32_t tries = 0; !mbar_try_wait(bar, parity); ++tries) {
    if (tries > (1u << 26)) __trap();
  }
}

// box (32 channels, T+4 columns, T+4 rows, 1 image) at (c, w, h, n) into dst
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c,
                                         int w, int h, int n) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c), "r"(w), "r"(h), "r"(n)
      : "memory");
}

// row oh of the output tile (32 channels, T columns) from shared memory to
// (c, w, h, n) of y; the TMA drops what falls outside the tensor
__device__ __forceinline__ void tma_store(const CUtensorMap* map, const void* src, int c, int w,
                                          int h, int n) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_addr(src)), "r"(c), "r"(w), "r"(h), "r"(n)
      : "memory");
}

template <int T, typename E>
struct Tile {
  static constexpr int kHalo = T + 2 * kPad;
  static constexpr int kHaloPix = kHalo * kHalo;
  static constexpr int kWarps = T / kCols;
  static constexpr int kThreads = kWarps * 32;
  static constexpr int kStageElems = kHaloPix * kTileC;
  static constexpr uint32_t kStageBytes = kStageElems * sizeof(E);
  // the float32 activated tile: a region of its own unless the stage is float32
  static constexpr bool kInPlace = sizeof(E) == sizeof(float);
  static constexpr uint32_t kActBytes = kInPlace ? 0 : kHaloPix * kTileC * sizeof(float);
  static constexpr size_t kSmemBytes =
      kStages * (kStageBytes + sizeof(uint64_t)) + kActBytes;
  // resident blocks an SM: by threads, and by shared memory (228 KB an SM,
  // 1 KB of it reserved per block)
  static constexpr int kBlocksPerSM = (kThreadsPerSM / kThreads) < (233472 / (kSmemBytes + 1024))
                                          ? (kThreadsPerSM / kThreads)
                                          : (int)(233472 / (kSmemBytes + 1024));
  static_assert(T % kCols == 0, "columns per warp must divide the tile");
  static_assert(kWarps <= kHalo, "the activation pass steps one halo row at most");
  static_assert(kStageBytes % 128 == 0, "each stage starts 128-byte aligned");
  static_assert(kBlocksPerSM >= 1, "the stages do not fit in shared memory");
};

// shared by both builds: the block's tile coordinates, and one thread's
// issue of image i of the block into stage i % kStages
template <int T, typename E>
struct Ring {
  using L = Tile<T, E>;
  E* smem;
  uint64_t* full;
  const CUtensorMap* xmap;
  int c0, h0, w0, n_first;

  __device__ __forceinline__ void issue(int i) const {
    const int s = i % kStages;
    mbar_expect_tx(&full[s], L::kStageBytes);
    tma_load(smem + s * L::kStageElems, xmap, &full[s], c0, w0 - kPad, h0 - kPad, n_first + i);
  }
  // mbarriers initialized, then the first kStages images in flight
  __device__ __forceinline__ void start(int count) const {
    if (threadIdx.x == 0) {
      for (int s = 0; s < kStages; ++s) mbar_init(&full[s], 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int i = 0; i < min(count, kStages); ++i) issue(i);
    }
  }
  // after every thread's writes of the outputs into stage i's interior: one
  // thread stores them row by row (the TMA drops channels, columns and rows
  // outside y), then refills the stage with the image kStages ahead
  __device__ __forceinline__ void finish(int i, int count, int rows, const CUtensorMap* ymap) const {
    // this thread's accesses of the stage, ordered before the TMA store that
    // reads it and the TMA load that refills it (the async proxy)
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (threadIdx.x == 0) {
      const E* buf = smem + (i % kStages) * L::kStageElems;
      for (int oh = 0; oh < rows; ++oh)
        tma_store(ymap, buf + ((oh + kPad) * L::kHalo + kPad) * kTileC, c0, w0, h0 + oh,
                  n_first + i);
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      if (i + kStages < count) {
        // the stores have read the stage before the TMA refills it
        asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
        issue(i + kStages);
      }
    }
  }
};

template <int T>
__global__ void __launch_bounds__(Tile<T, float>::kThreads, Tile<T, float>::kBlocksPerSM)
segment_f32_kernel(const __grid_constant__ CUtensorMap xmap,
                   const __grid_constant__ CUtensorMap ymap, const float* __restrict__ taps,
                   const float* __restrict__ s0, const float* __restrict__ b0,
                   const float* __restrict__ s1, const float* __restrict__ b1, int N, int H,
                   int W, int C, int tiles_w) {
  using L = Tile<T, float>;
  constexpr int kHalo = L::kHalo;
  // the stages, then their mbarriers
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* smem = reinterpret_cast<float*>(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem_raw + kStages * L::kStageBytes);

  const int lane = threadIdx.x & 31;  // channel within the tile
  const int warp = threadIdx.x >> 5;
  const int c0 = blockIdx.y * kTileC;
  const int c = c0 + lane;
  const bool c_ok = c < C;
  const int h0 = (blockIdx.x / tiles_w) * T;
  const int w0 = (blockIdx.x % tiles_w) * T;
  const int n_first = blockIdx.z * kImages;
  const int count = min(N - n_first, kImages);
  const Ring<T, float> ring{smem, full, &xmap, c0, h0, w0, n_first};
  ring.start(count);

  const float a0 = c_ok ? s0[c] : 0.0f, z0 = c_ok ? b0[c] : 0.0f;
  const float a1 = c_ok ? s1[c] : 0.0f, z1 = c_ok ? b1[c] : 0.0f;
  float k[kTaps * kTaps];
#pragma unroll
  for (int i = 0; i < kTaps * kTaps; ++i) k[i] = c_ok ? taps[i * C + c] : 0.0f;

  const int col0 = warp * kCols;  // this warp's first output column
  const int rows = min(T, H - h0);  // output rows of this tile inside the image
  for (int i = 0; i < count; ++i) {
    const int s = i % kStages;
    float* buf = smem + s * L::kStageElems;  // activated in place
    mbar_wait(&full[s], (i / kStages) & 1);

    // the first affine and SiLU at the pixels inside the image; the TMA
    // wrote zeros at those outside, which is the padding after the SiLU.
    // Warp `warp` takes halo pixels warp, warp + kWarps, ... (row hr,
    // column wc); the test is uniform across the warp
    {
      int hr = warp / kHalo, wc = warp % kHalo;
#pragma unroll
      for (int q = 0; q < (L::kHaloPix + L::kWarps - 1) / L::kWarps; ++q) {
        const unsigned h = h0 - kPad + hr, w = w0 - kPad + wc;  // < 0 wraps high
        if (L::kHaloPix % L::kWarps == 0 || q * L::kWarps + warp < L::kHaloPix) {
          const int idx = (q * L::kWarps + warp) * kTileC + lane;
          const float v = buf[idx];
          const float a = silu(fmaf(v, a0, z0));  // computed everywhere: no branch
          buf[idx] = (h < (unsigned)H && w < (unsigned)W) ? a : v;
        }
        wc += L::kWarps;
        if (wc >= kHalo) {
          wc -= kHalo;
          ++hr;
        }
      }
    }
    __syncthreads();

    // halo row r feeds output rows r-4 .. r with tap row r - oh
    float acc[kCols][T];
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
#pragma unroll
      for (int oh = 0; oh < T; ++oh) acc[j][oh] = 0.0f;
    }
#pragma unroll
    for (int r = 0; r < kHalo; ++r) {
      float v[kCols + kTaps - 1];
#pragma unroll
      for (int j = 0; j < kCols + kTaps - 1; ++j)
        v[j] = buf[(r * kHalo + col0 + j) * kTileC + lane];
#pragma unroll
      for (int dy = 0; dy < kTaps; ++dy) {
        const int oh = r - dy;
        if (oh >= 0 && oh < T) {
#pragma unroll
          for (int j = 0; j < kCols; ++j) {
#pragma unroll
            for (int dx = 0; dx < kTaps; ++dx)
              acc[j][oh] = fmaf(v[j + dx], k[dy * kTaps + dx], acc[j][oh]);
          }
        }
      }
    }
    // every warp is done reading the stage: write the outputs into its
    // interior (halo row oh + 2, column col + 2), then store them
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
#pragma unroll
      for (int oh = 0; oh < T; ++oh)
        buf[((oh + kPad) * kHalo + col0 + j + kPad) * kTileC + lane] =
            silu(fmaf(acc[j][oh], a1, z1));
    }
    ring.finish(i, count, rows, &ymap);
  }
  // the last stores have read shared memory before the block exits
  if (threadIdx.x == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// a channel pair's float32 values <-> its two bfloat16 (one 32-bit word);
// widening is exact, narrowing rounds to nearest even
__device__ __forceinline__ float2 widen2(uint32_t w) {
  return make_float2(__uint_as_float(w << 16), __uint_as_float(w & 0xffff0000u));
}
__device__ __forceinline__ __nv_bfloat162 narrow2(float2 v) {
  return __floats2bfloat162_rn(v.x, v.y);
}
__device__ __forceinline__ float2 pair_or_zero(const float* p, bool ok) {
  return ok ? *reinterpret_cast<const float2*>(p) : make_float2(0.0f, 0.0f);
}

// at most 4 blocks an SM (128 registers a thread): the 8x8 map's tile
// would admit 6 by shared memory, and 85 registers do not hold the taps'
// pairs
template <int T>
__global__ void __launch_bounds__(Tile<T, __nv_bfloat16>::kThreads,
                                  Tile<T, __nv_bfloat16>::kBlocksPerSM < 4
                                      ? Tile<T, __nv_bfloat16>::kBlocksPerSM
                                      : 4)
segment_bf16_kernel(const __grid_constant__ CUtensorMap xmap,
                    const __grid_constant__ CUtensorMap ymap, const float* __restrict__ taps,
                    const float* __restrict__ s0, const float* __restrict__ b0,
                    const float* __restrict__ s1, const float* __restrict__ b1, int N, int H,
                    int W, int C, int tiles_w) {
  using L = Tile<T, __nv_bfloat16>;
  constexpr int kHalo = L::kHalo;
  constexpr int kPairs = kTileC / 2;  // channel pairs of the tile: a half-warp
  // pixel pairs of the halo a warp activates (each half-warp one pixel)
  constexpr int kSteps = L::kHaloPix / (2 * L::kWarps);
  static_assert(L::kHaloPix % (2 * L::kWarps) == 0, "the warps split the halo in pixel pairs");
  static_assert(2 * L::kWarps < kHalo, "the activation pass steps one halo row at most");
  static_assert(2 * L::kWarps == T, "one half-warp an output column");
  // the stages, then the float32 activated tile, then the stages' mbarriers
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  float* act = reinterpret_cast<float*>(smem_raw + kStages * L::kStageBytes);
  uint64_t* full =
      reinterpret_cast<uint64_t*>(smem_raw + kStages * L::kStageBytes + L::kActBytes);

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int half = lane / kPairs;        // which of the warp's two pixels / columns
  const int pair = lane % kPairs;        // channel pair within the tile
  const int c0 = blockIdx.y * kTileC;
  const int c = c0 + 2 * pair;           // its first channel; C % 8 == 0, so c + 1 < C
  const bool c_ok = c < C;
  const int h0 = (blockIdx.x / tiles_w) * T;
  const int w0 = (blockIdx.x % tiles_w) * T;
  const int n_first = blockIdx.z * kImages;
  const int count = min(N - n_first, kImages);
  const Ring<T, __nv_bfloat16> ring{smem, full, &xmap, c0, h0, w0, n_first};
  ring.start(count);

  const float2 a0 = pair_or_zero(s0 + c, c_ok), z0 = pair_or_zero(b0 + c, c_ok);
  const float2 a1 = pair_or_zero(s1 + c, c_ok), z1 = pair_or_zero(b1 + c, c_ok);
  float2 k[kTaps * kTaps];
#pragma unroll
  for (int i = 0; i < kTaps * kTaps; ++i) k[i] = pair_or_zero(taps + i * C + c, c_ok);

  const int col = 2 * warp + half;  // this half-warp's output column
  const int rows = min(T, H - h0);  // output rows of this tile inside the image
  for (int i = 0; i < count; ++i) {
    const int s = i % kStages;
    __nv_bfloat16* buf = smem + s * L::kStageElems;
    mbar_wait(&full[s], (i / kStages) & 1);

    // the first affine and SiLU, as in the float32 build, a channel pair a
    // lane: half-warp `half` of warp `warp` takes halo pixels
    // 2 * (warp + q * kWarps) + half; the test is uniform across it, and a
    // warp whose two pixels both lie outside the image skips the SiLUs
    // (4.5 % of the build's time at the flagship's shapes, by ab_k1.py)
    {
      const int p0 = 2 * warp + half;
      int hr = p0 / kHalo, wc = p0 % kHalo;
#pragma unroll
      for (int q = 0; q < kSteps; ++q) {
        const unsigned h = h0 - kPad + hr, w = w0 - kPad + wc;  // < 0 wraps high
        const int idx = (p0 + 2 * q * L::kWarps) * kTileC + 2 * pair;
        const float2 v = widen2(*reinterpret_cast<const uint32_t*>(buf + idx));
        const bool inside = h < (unsigned)H && w < (unsigned)W;
        float2 a = v;
        if (__any_sync(0xffffffffu, inside)) {
          a.x = silu(fmaf(v.x, a0.x, z0.x));
          a.y = silu(fmaf(v.y, a0.y, z0.y));
          a = inside ? a : v;
        }
        *reinterpret_cast<float2*>(act + idx) = a;
        wc += 2 * L::kWarps;
        if (wc >= kHalo) {
          wc -= kHalo;
          ++hr;
        }
      }
    }
    __syncthreads();

    // halo row r feeds output rows r-4 .. r with tap row r - oh; taps in the
    // order dy, dx, as the float32 build
    float2 acc[T];
#pragma unroll
    for (int oh = 0; oh < T; ++oh) acc[oh] = make_float2(0.0f, 0.0f);
#pragma unroll
    for (int r = 0; r < kHalo; ++r) {
      float2 v[kTaps];
#pragma unroll
      for (int dx = 0; dx < kTaps; ++dx)
        v[dx] = *reinterpret_cast<const float2*>(act + (r * kHalo + col + dx) * kTileC + 2 * pair);
#pragma unroll
      for (int dy = 0; dy < kTaps; ++dy) {
        const int oh = r - dy;
        if (oh >= 0 && oh < T) {
#pragma unroll
          for (int dx = 0; dx < kTaps; ++dx) {
            acc[oh].x = fmaf(v[dx].x, k[dy * kTaps + dx].x, acc[oh].x);
            acc[oh].y = fmaf(v[dx].y, k[dy * kTaps + dx].y, acc[oh].y);
          }
        }
      }
    }
    // the outputs, rounded once to bfloat16 pairs, into the stage's interior
    // (the depthwise read only the activated tile: no barrier before)
#pragma unroll
    for (int oh = 0; oh < T; ++oh) {
      float2 y;
      y.x = silu(fmaf(acc[oh].x, a1.x, z1.x));
      y.y = silu(fmaf(acc[oh].y, a1.y, z1.y));
      *reinterpret_cast<__nv_bfloat162*>(
          buf + ((oh + kPad) * kHalo + col + kPad) * kTileC + 2 * pair) = narrow2(y);
    }
    ring.finish(i, count, rows, &ymap);
  }
  // the last stores have read shared memory before the block exits
  if (threadIdx.x == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                              &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = (EncodeTiled)p;
  }
  return fn;
}

template <int T, typename E>
int launch_tiled(const E* x, const float* taps, const float* s0, const float* b0,
                 const float* s1, const float* b1, E* y, int n, int h, int w, int c,
                 int device, cudaStream_t stream) {
  using L = Tile<T, E>;
  EncodeTiled encode = encoder();
  if (encode == nullptr) return kErrNoEncoder;
  // (C, W, H, N) innermost first; boxes of 32 channels
  constexpr cuuint64_t kBytes = sizeof(E);
  const cuuint64_t dims[4] = {(cuuint64_t)c, (cuuint64_t)w, (cuuint64_t)h, (cuuint64_t)n};
  const cuuint64_t strides[3] = {(cuuint64_t)c * kBytes, (cuuint64_t)w * c * kBytes,
                                 (cuuint64_t)h * w * c * kBytes};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  auto make = [&](CUtensorMap* map, const E* base, cuuint32_t box_w, cuuint32_t box_h) {
    const cuuint32_t box[4] = {kTileC, box_w, box_h, 1};
    return encode(map, Elem<E>::kMapType, 4, const_cast<E*>(base), dims, strides, box, unit,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
  };
  CUtensorMap xmap, ymap;  // x: a tile and its halo; y: one output row of a tile
  if (!make(&xmap, x, L::kHalo, L::kHalo) || !make(&ymap, y, T, 1)) return kErrEncode;
  const auto kernel = sizeof(E) == sizeof(float) ? segment_f32_kernel<T>
                                                 : segment_bf16_kernel<T>;
  // above 48 KB, dynamic shared memory needs the kernel's consent, once per
  // device (a host call that is not free: not at every launch)
  static bool consented[kMaxDevices] = {};
  if (device >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!consented[device]) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)L::kSmemBytes);
    if (err != cudaSuccess) return (int)err;
    consented[device] = true;
  }
  const int tiles_w = (w + T - 1) / T;
  const int tiles_h = (h + T - 1) / T;
  const dim3 grid(tiles_h * tiles_w, (c + kTileC - 1) / kTileC, (n + kImages - 1) / kImages);
  kernel<<<grid, L::kThreads, L::kSmemBytes, stream>>>(xmap, ymap, taps, s0, b0, s1, b1, n, h,
                                                       w, c, tiles_w);
  return (int)cudaGetLastError();
}

// the checks and the tile choice of both entry points; `width` is the
// channel multiple that makes a TMA row pitch 16 bytes
template <typename E>
int launch(const void* x, const void* taps, const void* s0, const void* b0, const void* s1,
           const void* b1, void* y, int n, int h, int w, int c, int device, void* stream,
           int width, int width_error) {
  if (c % width != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(y) % 16 != 0)
    return width_error;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  auto tiled = (h <= 8 && w <= 8) ? launch_tiled<8, E> : launch_tiled<16, E>;
  return tiled((const E*)x, (const float*)taps, (const float*)s0, (const float*)b0,
               (const float*)s1, (const float*)b1, (E*)y, n, h, w, c, device,
               (cudaStream_t)stream);
}

}  // namespace

// x and y float32; taps and affines float32
extern "C" int gat_depthwise_segment_f32(const void* x, const void* taps, const void* s0,
                                         const void* b0, const void* s1, const void* b1,
                                         void* y, int n, int h, int w, int c, int device,
                                         void* stream) {
  return launch<float>(x, taps, s0, b0, s1, b1, y, n, h, w, c, device, stream, 4, kErrWidth);
}

// x and y bfloat16; taps and affines float32
extern "C" int gat_depthwise_segment_bf16(const void* x, const void* taps, const void* s0,
                                          const void* b0, const void* s1, const void* b1,
                                          void* y, int n, int h, int w, int c, int device,
                                          void* stream) {
  return launch<__nv_bfloat16>(x, taps, s0, b0, s1, b1, y, n, h, w, c, device, stream, 8,
                               kErrWidthBf16);
}

extern "C" const char* gat_cuda_error_string(int code) {
  switch (code) {
    case kErrNoEncoder:
      return "the CUDA driver has no cuTensorMapEncodeTiled";
    case kErrEncode:
      return "cuTensorMapEncodeTiled refused the tensor map of x";
    case kErrWidth:
      return "the TMA needs C a multiple of 4 and x and y 16-byte aligned";
    case kErrWidthBf16:
      return "the TMA needs C a multiple of 8 in bfloat16 and x and y 16-byte aligned";
    default:
      return cudaGetErrorString((cudaError_t)code);
  }
}
