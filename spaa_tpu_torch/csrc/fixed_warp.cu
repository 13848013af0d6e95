// Fixed-grid bilinear warp for Hopper (sm_90a): banded gathers with the
// taps held in registers and the source window staged in shared memory by
// bulk asynchronous copies (cp.async.bulk, completion on an mbarrier).
//
// Replaces the TPU kernel spaa_tpu/ops/pallas/warp.py::_warp_kernel
// (launched by _run_packed_gather, differentiated by _warp_core's custom
// VJP). The warp samples a CONSTANT grid, so it is a fixed sparse matrix:
// each output pixel takes at most four bilinear taps (out-of-range taps
// dropped, the binary direct-light mask folded into the weights):
//
//   forward   out[n, c, q]  = sum_t w[t] * src[n, col[t], c]   NHWC -> NCHW
//   backward  dsrc[n, p, c] = sum_t w[t] * dout[n, c, col[t]]  NCHW -> NHWC
//
// The backward gathers over the transposed table (one row per source pixel,
// variable fan-in): no atomics, so both passes are bitwise deterministic run
// to run, and every row sums its taps in the CSR tables' request order.
//
// Tables (spaa_tpu_torch/ops/warp.py::_band_table, built on the host). The
// table's rows are cut into BANDS of whole image rows (band_px pixels). A
// band's taps touch a WINDOW: the sorted set of input image rows they read,
// stored as runs of consecutive rows (segments). Each row's taps sit in an
// ELL block of fixed width K (4 forward, 6 backward; padding has weight 0),
// taps past K in a CSR remainder; offsets are pixel indices relative to the
// band's window, or absolute for a band whose window exceeds the staging
// budget. Band modes: 0 empty (writes zeros, stages nothing), 1 staged,
// 2 global (the same kernel gathers straight from device memory).
//
// Bound. Memory: ~2 flops per 12 bytes. At the attack sweep's shapes
// (N = 132, 3 channels, 256x256 source, 240x320 output, the trained
// checkpoint's grid with the fixture mask folded in) the forward must read
// the 65,530 source pixels its taps touch and write every output:
// 227.1 MB, 67.8 us at 3.35 TB/s. The backward must read the 41,612 output
// pixels that carry taps and write every source pixel: 171.3 MB, 51.1 us.
// chip_smoke.py computes both from the run's tables. The backward's staging
// reads whole output row-planes: even with only the 185 of 240 output rows
// that carry taps staged, that is ~198 MB of reads and writes, so full-row
// staging caps it near 85% of the byte bound.
//
// What the design does about what held the first (CSR, one thread per row)
// kernel back:
// 1. Tap tables re-read per image: a block owns one band and loops over a
//    chunk of the batch; its taps are loaded into registers once (8-byte
//    vector loads) and stay there for the block's lifetime, as the TPU
//    kernel kept its tables resident in VMEM across the inner grid axis.
// 2. Dependent scalar loads: one thread issues the window's bulk copies for
//    image n + kStages - 1 while the block computes image n from shared
//    memory; the gathers are ld.shared with no address dependence on a
//    table load, fully unrolled over taps and channels.
// 3. Stride-3 channel access: forward stores are contiguous NCHW planes
//    (coalesced); the backward builds the band's NHWC gradient (contiguous
//    band_px x C floats) in shared memory and writes it with 16-byte
//    vector stores.
// 4. The backward's variable fan-in: K = 6 taps in registers covers every
//    row of a near-affine warp (fan-in <= 5 on the sweep's grid); longer
//    rows (zoom-in grids) loop over the CSR remainder, a per-band flag keeps
//    that loop out of bands that have none.
// Bands whose window exceeds the budget (a 90-degree rotation reads a
// source column per output row) gather from device memory in this same
// kernel, and so does every band of a table whose input rows are not whole
// 16-byte units (bulk copies move 16-byte-aligned multiples of 16 bytes).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxChannels = 4;
// windows in flight per block
constexpr int kStages = 2;
// the grid holds this many rounds of resident blocks (SMs x blocks per SM)
constexpr int kGridWaves = 4;
// forward: 256 threads x 5 output pixels (a band of 4 rows of 320), 4 taps
constexpr int kFwdThreads = 256, kFwdPix = 5, kFwdTaps = 4;
// backward: 512 threads x 2 source pixels (4 rows of 256), 6 taps (at 8
// ptxas spills a quad of them at the 64 registers that keep 2 blocks an SM)
constexpr int kBwdThreads = 512, kBwdPix = 2, kBwdTaps = 6;

enum BandMode { kEmpty = 0, kStaged = 1, kGlobal = 2, kHasRemainder = 4 };

struct Params {
  const float* in;
  float* out;
  const int* band;      // [bands, 4]: mode, first segment, end segment, window px
  const int* seg;       // [segments, 2]: first input pixel, pixel count
  const int* tap_off;   // [bands * band_px, K] window-relative (or absolute) pixel
  const float* tap_w;   // [bands * band_px, K]
  const int* rem_ptr;   // [bands * band_px + 1] remainder CSR
  const int* rem_off;
  const float* rem_w;
  long long in_img, out_img;   // floats per image
  int rows;       // rows of the table (output pixels of this pass)
  int band_px;    // table rows per band
  int n_batch, chunk, channels;
  int plane;      // pixels of one input channel plane (planar input)
  int stage_px;   // pixels of one staged channel plane
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// Wait for the phase of parity `parity` to complete. A copy that never
// lands traps (a launch error the wrapper raises) instead of hanging.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t tries = 0; !done; ++tries) {
    if (tries == (1u << 26)) __trap();
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void bulk_load(float* dst, const float* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Stage one image's window of band `info` into `buf`. Interleaved input
// (NHWC) copies each segment's pixels with all channels; planar input
// (NCHW) copies each segment once per channel plane, plane c landing at
// c * stage_px. Called by one thread; completion on `bar`.
template <bool kPlanar>
__device__ __forceinline__ void stage_window(const Params& P, const int4 info,
                                             const float* img, float* buf,
                                             uint64_t* bar) {
  const int C = P.channels;
  const int mult = kPlanar ? 1 : C;
  const int planes = kPlanar ? C : 1;
  mbar_arrive_expect_tx(bar, static_cast<uint32_t>(info.w) * C * 4u);
  for (int c = 0; c < planes; ++c) {
    const float* src_c = img + (kPlanar ? static_cast<long long>(c) * P.plane : 0);
    float* dst = buf + (kPlanar ? c * P.stage_px : 0);
    for (int s = info.y; s < info.z; ++s) {
      const int2 sg = reinterpret_cast<const int2*>(P.seg)[s];
      const float* src = src_c + static_cast<long long>(sg.x) * mult;
      const int len = sg.y * mult;
      bulk_load(dst, src, static_cast<uint32_t>(len) * 4u, bar);
      dst += len;
    }
  }
}

// One image of one band: each thread sums its pixels' taps from `base`
// (shared window or device memory), channel c at c * cs. The forward
// (interleaved input) writes the NCHW output planes directly; the backward
// (planar input) writes interleaved pixels into `obuf`.
template <bool kGlobalSrc, bool kPlanar, int kThreads, int kPix, int kTaps>
__device__ __forceinline__ void gather_image(
    const Params& P, const float* base, int cs, int p0, int np, bool rem,
    const int (&off)[kPix][kTaps], const float (&wt)[kPix][kTaps],
    float* out_n, float* obuf) {
  const int C = P.channels;
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    const int p = threadIdx.x + k * kThreads;
    if (p < np) {
      float acc[kMaxChannels] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int t = 0; t < kTaps; ++t) {
        if (wt[k][t] != 0.f) {
          const float* s = base + off[k][t];
#pragma unroll
          for (int c = 0; c < kMaxChannels; ++c) {
            if (c < C) {
              const float v = kGlobalSrc ? __ldg(s + c * cs) : s[c * cs];
              acc[c] = fmaf(wt[k][t], v, acc[c]);
            }
          }
        }
      }
      if (rem) {
        const int end = __ldg(P.rem_ptr + p0 + p + 1);
        for (int t = __ldg(P.rem_ptr + p0 + p); t < end; ++t) {
          const float w = __ldg(P.rem_w + t);
          const float* s = base + __ldg(P.rem_off + t) * (kPlanar ? 1 : C);
#pragma unroll
          for (int c = 0; c < kMaxChannels; ++c) {
            if (c < C) {
              const float v = kGlobalSrc ? __ldg(s + c * cs) : s[c * cs];
              acc[c] = fmaf(w, v, acc[c]);
            }
          }
        }
      }
#pragma unroll
      for (int c = 0; c < kMaxChannels; ++c) {
        if (c < C) {
          if (kPlanar) {
            obuf[p * C + c] = acc[c];
          } else {
            out_n[static_cast<long long>(c) * P.rows + p0 + p] = acc[c];
          }
        }
      }
    }
  }
}

// Copy the band's interleaved gradient (np * C contiguous floats) from
// shared memory (16-byte aligned: obuf_stride) to device memory, by
// 16-byte vectors where `dst` is aligned too.
__device__ __forceinline__ void store_band(const float* obuf, float* dst,
                                           int count) {
  int head = 0;
  if ((reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
    const int n4 = count >> 2;
    const float4* s4 = reinterpret_cast<const float4*>(obuf);
    float4* d4 = reinterpret_cast<float4*>(dst);
    for (int j = threadIdx.x; j < n4; j += blockDim.x) d4[j] = s4[j];
    head = n4 << 2;
  }
  for (int j = head + threadIdx.x; j < count; j += blockDim.x) dst[j] = obuf[j];
}

// Floats between the backward's two output buffers: band_px * C rounded up
// to whole 16-byte units, so that both start 16-byte aligned.
__host__ __device__ __forceinline__ int obuf_stride(int band_px,
                                                    int channels) {
  return (band_px * channels + 3) & ~3;
}

// One block: band blockIdx.x, images [blockIdx.y * chunk, + chunk).
// Dynamic shared memory: kStages windows of stage_px * C floats (stage_px
// is a multiple of 4), then (the backward) two output buffers.
template <bool kPlanar, int kThreads, int kPix, int kTaps>
__device__ __forceinline__ void band_gather(const Params& P) {
  extern __shared__ __align__(16) float smem[];
  __shared__ __align__(8) uint64_t bars[kStages];
  const int tid = threadIdx.x;
  const int n0 = blockIdx.y * P.chunk;
  const int cnt = min(P.chunk, P.n_batch - n0);
  if (cnt <= 0) return;
  const int p0 = blockIdx.x * P.band_px;
  const int np = min(P.band_px, P.rows - p0);
  const int C = P.channels;
  const int4 info = reinterpret_cast<const int4*>(P.band)[blockIdx.x];
  const int mode = info.x & 3;
  const bool rem = (info.x & kHasRemainder) != 0;
  const bool staged = mode == kStaged;
  const int stage_floats = P.stage_px * C;
  float* obuf0 = smem + kStages * stage_floats;

  if (staged && tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(&bars[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int s = 0; s < kStages && s < cnt; ++s)
      stage_window<kPlanar>(P, info, P.in + (n0 + s) * P.in_img,
                            smem + s * stage_floats, &bars[s]);
  }

  // the band's taps, once, into registers (offsets scaled to floats)
  int off[kPix][kTaps];
  float wt[kPix][kTaps];
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    const int p = tid + k * kThreads;
    const bool live = mode != kEmpty && p < np;
    const long long row = static_cast<long long>(p0) + (live ? p : 0);
#pragma unroll
    for (int t2 = 0; t2 < kTaps / 2; ++t2) {
      int2 o = make_int2(0, 0);
      float2 w = make_float2(0.f, 0.f);
      if (live) {
        o = __ldg(reinterpret_cast<const int2*>(P.tap_off + row * kTaps) + t2);
        w = __ldg(reinterpret_cast<const float2*>(P.tap_w + row * kTaps) + t2);
      }
      const int m = kPlanar ? 1 : C;
      off[k][2 * t2 + 0] = o.x * m;
      off[k][2 * t2 + 1] = o.y * m;
      wt[k][2 * t2 + 0] = w.x;
      wt[k][2 * t2 + 1] = w.y;
    }
  }
  __syncthreads();   // barriers initialised before anyone waits on them

  for (int i = 0; i < cnt; ++i) {
    const int n = n0 + i;
    const int s = i % kStages;
    float* buf = smem + s * stage_floats;
    float* out_n = P.out + n * P.out_img;
    float* obuf = obuf0 + (i & 1) * obuf_stride(P.band_px, C);
    const float* img = P.in + n * P.in_img;
    if (staged) {
      mbar_wait(&bars[s], (i / kStages) & 1);
      gather_image<false, kPlanar, kThreads, kPix, kTaps>(
          P, buf, kPlanar ? P.stage_px : 1, p0, np, rem, off, wt, out_n, obuf);
    } else {   // global, or empty (all weights 0: writes zeros)
      gather_image<true, kPlanar, kThreads, kPix, kTaps>(
          P, img, kPlanar ? P.plane : 1, p0, np, rem, off, wt, out_n, obuf);
    }
    __syncthreads();   // window s and obuf fully read / written
    if (staged && tid == 0 && i + kStages < cnt)
      stage_window<kPlanar>(P, info, img + kStages * P.in_img, buf, &bars[s]);
    if (kPlanar) store_band(obuf, out_n + static_cast<long long>(p0) * C, np * C);
  }
}

__global__ void __launch_bounds__(kFwdThreads)
    fixed_warp_fwd_kernel(const __grid_constant__ Params P) {
  band_gather<false, kFwdThreads, kFwdPix, kFwdTaps>(P);
}

__global__ void __launch_bounds__(kBwdThreads)
    fixed_warp_bwd_kernel(const __grid_constant__ Params P) {
  band_gather<true, kBwdThreads, kBwdPix, kBwdTaps>(P);
}

size_t smem_bytes(bool backward, int band_px, int stage_px, int channels) {
  size_t b = static_cast<size_t>(kStages) * stage_px * channels * 4;
  if (backward) b += 2ull * obuf_stride(band_px, channels) * 4;
  return b;
}

// Grid: x = band (fastest, so blocks resident together work on the same
// images and neighbouring bands' overlapping rows meet in L2), y = batch
// chunk, sized so the busy bands fill kGridWaves rounds of resident blocks.
template <typename Kernel>
int launch(Kernel kernel, int threads, bool backward, Params P, int n_bands,
           int n_busy, void* stream) {
  const size_t smem = smem_bytes(backward, P.band_px, P.stage_px, P.channels);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0, dev = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                      smem);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long slots = static_cast<long long>(per_sm > 0 ? per_sm : 1) *
                          sms * kGridWaves;
  const int busy = n_busy > 0 ? n_busy : 1;
  long long chunks = (slots + busy - 1) / busy;
  if (chunks > P.n_batch) chunks = P.n_batch;
  if (chunks > 65535) chunks = 65535;
  if (chunks < 1) chunks = 1;
  P.chunk = static_cast<int>((P.n_batch + chunks - 1) / chunks);
  chunks = (P.n_batch + P.chunk - 1) / P.chunk;
  kernel<<<dim3(n_bands, static_cast<unsigned>(chunks)), threads, smem,
           static_cast<cudaStream_t>(stream)>>>(P);
  return static_cast<int>(cudaGetLastError());
}

Params make_params(const float* in, float* out, const int* band,
                   const int* seg, const int* tap_off, const float* tap_w,
                   const int* rem_ptr, const int* rem_off, const float* rem_w,
                   int band_px, int rows, int n_batch, int channels,
                   long long in_img, long long out_img, int plane,
                   int stage_px) {
  Params P;
  P.in = in;
  P.out = out;
  P.band = band;
  P.seg = seg;
  P.tap_off = tap_off;
  P.tap_w = tap_w;
  P.rem_ptr = rem_ptr;
  P.rem_off = rem_off;
  P.rem_w = rem_w;
  P.in_img = in_img;
  P.out_img = out_img;
  P.rows = rows;
  P.band_px = band_px;
  P.n_batch = n_batch;
  P.chunk = n_batch;
  P.channels = channels;
  P.plane = plane;
  P.stage_px = stage_px;
  return P;
}

}  // namespace

extern "C" int fixed_warp_max_channels() { return kMaxChannels; }

// Pixels per band and ELL width each kernel takes (the host tables must
// match): backward = 0 for the forward kernel, 1 for the backward.
extern "C" int fixed_warp_band_capacity(int backward) {
  return backward ? kBwdThreads * kBwdPix : kFwdThreads * kFwdPix;
}

extern "C" int fixed_warp_taps(int backward) {
  return backward ? kBwdTaps : kFwdTaps;
}

extern "C" long long fixed_warp_smem_bytes(int backward, int band_px,
                                           int stage_px, int channels) {
  return static_cast<long long>(
      smem_bytes(backward != 0, band_px, stage_px, channels));
}

// Registers per thread, local (spill) bytes per thread and static shared
// bytes of one kernel, from cudaFuncGetAttributes; returns its error code.
extern "C" int fixed_warp_kernel_attrs(int backward, int* regs,
                                       int* local_bytes, int* static_smem) {
  cudaFuncAttributes a;
  const cudaError_t err =
      backward ? cudaFuncGetAttributes(&a, fixed_warp_bwd_kernel)
               : cudaFuncGetAttributes(&a, fixed_warp_fwd_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  *regs = a.numRegs;
  *local_bytes = static_cast<int>(a.localSizeBytes);
  *static_smem = static_cast<int>(a.sharedSizeBytes);
  return 0;
}

// Both entry points launch on `stream` and return the first CUDA error
// code (0 on success). The caller allocates `out`, checks shapes, dtypes,
// channels <= 4, that the tables match this kernel's capacity and taps,
// and that the input is 16-byte aligned when the tables stage a window.
extern "C" int fixed_warp_fwd(
    const float* src, float* out, const int* band, const int* seg,
    const int* tap_off, const float* tap_w, const int* rem_ptr,
    const int* rem_off, const float* rem_w, int n_bands, int n_busy,
    int band_px, int rows, int n_batch, int channels, long long in_img,
    long long out_img, int plane, int stage_px, void* stream) {
  const Params P = make_params(src, out, band, seg, tap_off, tap_w, rem_ptr,
                               rem_off, rem_w, band_px, rows, n_batch,
                               channels, in_img, out_img, plane, stage_px);
  return launch(fixed_warp_fwd_kernel, kFwdThreads, false, P, n_bands,
                n_busy, stream);
}

extern "C" int fixed_warp_bwd(
    const float* dout, float* out, const int* band, const int* seg,
    const int* tap_off, const float* tap_w, const int* rem_ptr,
    const int* rem_off, const float* rem_w, int n_bands, int n_busy,
    int band_px, int rows, int n_batch, int channels, long long in_img,
    long long out_img, int plane, int stage_px, void* stream) {
  const Params P = make_params(dout, out, band, seg, tap_off, tap_w, rem_ptr,
                               rem_off, rem_w, band_px, rows, n_batch,
                               channels, in_img, out_img, plane, stage_px);
  return launch(fixed_warp_bwd_kernel, kBwdThreads, true, P, n_bands, n_busy,
                stream);
}

extern "C" const char* fixed_warp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
