// K3 deconv_i8: an exact s8 x s8 -> s32 transposed convolution for Hopper
// (sm_90a), the int8 serving trunk's convolution (ganode_tpu_torch/ops/
// quant.py). Plain C interface, built by ganode_tpu_torch/ops/_build.py into
// the same shared library as K1 and K2 and bound with ctypes.
//
// It replaces no TPU kernel. The JAX package's int8 deconv is XLA's
// conv_general_dilated with preferred_element_type=int32
// (ganode_tpu/ops/quant.py:151 `_deconv_i8`), which the TPU runs on its MXU.
// On this card no library call computes it exactly: PyTorch and cuDNN have no
// int8 conv_transpose2d, and a float conv over int8 values is exact only while
// partial sums stay below 2^24, where full-width ConvTranspose_1 of dcgan64
// sums 2,048 products of up to 127^2 (~3.3e7).
//
// What it computes, with torch's (k, s, p) semantics, equal to
// F.conv_transpose2d on the weight permuted back to (Ci, Co, k, k):
//
//   y[b, oy, ox, co] = sum over (ky, kx, ci) with oy = iy*s - p + ky and
//                      ox = ix*s - p + kx in range of x[b, iy, ix, ci] *
//                      w[ky, kx, co, ci]
//
// x (B, Hi, Wi, Ci4) int8 NHWC, Ci zero-padded to Ci4, a multiple of 32;
// w (k, k, Co, Ci4) int8, packed once by quant.py; y (B, Ho, Wo, Co) NHWC,
// Ho = (Hi - 1) s - 2 p + k. Either the int32 sums, or the fused epilogue in
// float32, y * (a_scale * scale[co]) + bias[co] with __fmul_rn / __fadd_rn
// (the plain version's unfused float32 operations, in its order; a_scale
// read from device memory, so the host never syncs), then ReLU if asked.
//
// The tile plan (route, tile and box sizes, the TMA maps' strides and
// swizzle, grid) is computed by the Python wrapper (quant.py::k3_plan,
// checked on the CPU) and passed in as ints; the maps are encoded from it.
//
// Two kernels, by what bounds the layer on this card:
//
// deconv_i8_kernel_tc: operations (every layer with Co >= 8; ~97 % of a
// trunk's products). An implicit GEMM per output parity class (oy % s,
// ox % s) on the int8 tensor cores: M = B Hq Wq output rows ordered
// (b, qy, qx), N = Co, K = taps x Ci4; in a class every output reads the
// taps ky = (ry + p) % s + j s at the input row qy + (ry + p) / s - j. A
// tile is 128 rows = a (boxB, boxH, boxW) block of (b, qy, qx), so each
// tap's A operand is one TMA box of the 4-D tensor (C, W, H, B) at
// (c0, qx0 + dx, qy0 + dy, b0): TMA fills what lies outside the input with
// zeros, which is exactly the transposed conv's padding (coordinates may be
// negative). B is a TMA box of the packed weights (Ci4, Co, k^2) at
// (c0, n0, tap). Both land K-major in shared memory with the 128- or 32-byte
// swizzle of their row width (BK = 128 or 32 channels), as
// wgmma.mma_async m64nNk32.s32.s8.s8 needs them. One producer warp keeps a
// ring of kStages stages in flight (mbarriers: "full" on the TMA bytes,
// "empty" when both consumer warpgroups' wgmma have read a stage); two
// consumer warpgroups each own 64 rows, N = 64 or 128 columns of s32
// accumulators. Blocks are persistent (as many as the card holds, each
// walking tiles, the N tiles and classes of one M tile together so their
// input boxes meet in L2), so the producer loads the next tile while the
// consumers store this one. A tap whose box lies wholly outside the input
// is skipped by both sides. The epilogue converts the accumulators into an
// output tile in shared memory, then stores each output pixel's channel run
// with 16-byte stores, a warp's contiguous along the row. A 1 x 1 input with p = 0 (every trunk's
// ConvTranspose_0) is one plain GEMM (B, Ci4) x (k^2 Co, Ci4)^T whose output
// (B, k^2 Co) already is NHWC (B, k, k, Co): one class, one tap, N = k^2 Co.
//
// deconv_i8_kernel_bytes: bytes (the last layer, Co = 3, and mnist28's
// 1x1 Conv_0, Co = 1: ~3 % of the products, 30-40 % of a trunk's bytes).
// One thread per s x s output quad (every class), for (k, s, p) = (4, 2, 1)
// with Co = 3, or (1, 1, 0) with Co = 1 (other shapes take the tensor
// cores): it reads the 3 x 3 (or 1 x 1) input neighbourhood in 16-byte
// chunks of channels, each chunk once, __dp4a against the whole kernel kept
// in shared memory (read as broadcasts), and writes its s x s pixels, Co
// floats each, so a warp stores a contiguous run along ox.
//
// Sums are exact: |x|, |w| <= 127 and Ci4 k^2 / s^2 <= 2^17 products per
// output keep them below 2^31. The launcher returns 0 or a cudaError_t; plans
// it cannot take return cudaErrorInvalidValue, nothing launched (the Python
// wrapper checks shapes and builds the plan first).

#include <cstdint>
#include <mutex>

#include <cuda.h>
#include <cuda_runtime.h>

namespace {

// ---------------------------------------------------------------------------
// The plan, as the wrapper passes it (quant.py::K3Plan.args, same order).
// ---------------------------------------------------------------------------
enum PlanField {
  kRoute,  // 0: tensor cores, 1: bytes
  kB, kHi, kWi, kCi4,
  kN,      // output channels per pixel (k^2 Co in the one-tap GEMM)
  kHo, kWo, kK, kS, kP,
  kCs,     // channels per scale / bias period (Co)
  kBN, kBK, kBoxW, kBoxH, kBoxB, kTilesW, kTilesH, kTilesN, kGridX, kGridZ,
  kMapRows, kMapTaps,  // the weight map's rows and taps: (Co, k^2) or (k^2 Co, 1)
  kSwizzle,            // both maps' swizzle span in bytes (= BK)
  kXStrideW, kXStrideH, kXStrideB,  // the input map's byte strides
  kWStrideRow, kWStrideTap,         // the weight map's byte strides
  kPlanLen
};

// ---------------------------------------------------------------------------
// PTX helpers: mbarriers, TMA, wgmma.
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(smem_addr(bar))
      : "memory");
}

// A K-major shared-memory operand for wgmma: rows of BK bytes swizzled as TMA
// wrote them (BK = 128, 32 -> layout 1, 3), 8-row groups BK * 8 bytes apart
// (the stride byte offset); the leading offset is unused for K-major
// swizzled layouts. Advancing K by 32 bytes adds 2 to the address field.
template <int BK>
__device__ __forceinline__ uint64_t smem_desc(const void* p) {
  static_assert(BK == 128 || BK == 32, "K3 swizzles 128- or 32-byte rows");
  constexpr uint64_t layout = BK == 128 ? 1 : 3;
  return static_cast<uint64_t>((smem_addr(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>((8 * BK) >> 4) << 32) | (layout << 62);
}

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

// d += A (64 x 32, shared) * B (N x 32, shared)^T, s8 x s8 -> s32.
template <int N>
struct Wgmma;

template <>
struct Wgmma<64> {
  __device__ static void mma(int (&d)[32], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p;\n"
        "}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
          "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
          "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]),
          "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]),
          "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]),
          "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<128> {
  __device__ static void mma(int (&d)[64], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p;\n"
        "}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
          "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
          "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]),
          "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]),
          "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]),
          "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
          "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]),
          "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
          "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]),
          "+r"(d[47]), "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
          "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]), "+r"(d[56]),
          "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]),
          "+r"(d[62]), "+r"(d[63])
        : "l"(a), "l"(b), "r"(1));
  }
};

// The float32 epilogue in the plain version's order, y * (a_scale *
// scale) + bias, from as_sc = a_scale * scale (rounded, as the plain version
// rounds it), ReLU'd if asked.
__device__ __forceinline__ float epilogue(int v, float as_sc, float bi, int relu) {
  const float f = __fadd_rn(__fmul_rn(__int2float_rn(v), as_sc), bi);
  return relu && f < 0.0f ? 0.0f : f;
}

// ---------------------------------------------------------------------------
// The tensor-core kernel.
// ---------------------------------------------------------------------------
constexpr int kBM = 128;                    // rows per tile, 64 per consumer
constexpr int kConsumerWarps = 8;           // two warpgroups
constexpr int kConsumers = 32 * kConsumerWarps;
constexpr int kThreadsTc = kConsumers + 32;  // + the producer warp

// Shared-memory ring depth: 4 stages of 128 + BN rows, 3 at BN = 64 so that
// two blocks fit on an SM with their output tiles.
template <int BN>
__host__ __device__ constexpr int tc_stages() {
  return BN == 64 ? 3 : 4;
}
// The output tile staged in shared memory, rows of BN words padded by 8
// words (a half-warp's float2 writes of 4 rows then fall on distinct banks).
template <int BN>
__host__ __device__ constexpr int tc_cstride() {
  return BN + 8;
}

struct TcGeom {
  int B, Hi, Wi, Ho, Wo, N, Cs, K, s, p;
  int boxW, boxH, boxB, tilesW, tilesH, tilesN, kChunks;
  int classes, tiles;  // tiles = M tiles * tilesN * classes
};

// One output tile: its parity class, origin, and the class's taps ky = ky0 +
// j s at the input row qy + dy0 - j (kx likewise). Tiles run N tile fastest,
// then class, then M tile, so the blocks in flight share their input boxes
// (every class and N tile of one M tile reads the same input) in L2.
struct Tile {
  int ry, rx, qx0, qy0, b0, n0, ky0, kx0, nty, ntx, dy0, dx0;
};

template <int BN>
__device__ __forceinline__ Tile tile_at(const TcGeom& g, int t) {
  Tile T;
  T.n0 = (t % g.tilesN) * BN;
  const int cls = t / g.tilesN % g.classes, m_tile = t / (g.tilesN * g.classes);
  T.ry = cls / g.s;
  T.rx = cls % g.s;
  T.qx0 = (m_tile % g.tilesW) * g.boxW;
  T.qy0 = (m_tile / g.tilesW % g.tilesH) * g.boxH;
  T.b0 = m_tile / (g.tilesW * g.tilesH) * g.boxB;
  T.ky0 = (T.ry + g.p) % g.s;
  T.kx0 = (T.rx + g.p) % g.s;
  T.nty = T.ky0 < g.K ? (g.K - T.ky0 + g.s - 1) / g.s : 0;
  T.ntx = T.kx0 < g.K ? (g.K - T.kx0 + g.s - 1) / g.s : 0;
  T.dy0 = (T.ry + g.p) / g.s;
  T.dx0 = (T.rx + g.p) / g.s;
  return T;
}

// Whether tap (j, i)'s input box lies wholly outside the input (all padding).
__device__ __forceinline__ bool tap_is_padding(const TcGeom& g, const Tile& T,
                                               int j, int i) {
  const int iy0 = T.qy0 + T.dy0 - j, ix0 = T.qx0 + T.dx0 - i;
  return iy0 >= g.Hi || iy0 + g.boxH <= 0 || ix0 >= g.Wi || ix0 + g.boxW <= 0;
}

// Shared memory: the ring, the output tile, per-column scale and bias, per-row
// output offsets, the barriers; + 1024 for the alignment.
template <int BN, int BK>
constexpr int tc_smem_bytes() {
  return tc_stages<BN>() * (kBM + BN) * BK + 4 * kBM * tc_cstride<BN>() + 8 * BN +
         8 * kBM + 16 * tc_stages<BN>() + 1024;
}

// Bar 1 among the consumers only (the producer warp runs on).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

// Persistent: block b takes tiles b, b + gridDim.x, ... The producer walks
// the same tiles and runs up to kStages loads ahead, into the next tile while
// the consumers store this one.
template <int BN, int BK>
__global__ void __launch_bounds__(kThreadsTc, 1)
    deconv_i8_kernel_tc(const __grid_constant__ CUtensorMap xmap,
                        const __grid_constant__ CUtensorMap wmap,
                        int32_t* __restrict__ out_i32, float* __restrict__ out_f32,
                        const float* __restrict__ a_scale,
                        const float* __restrict__ scale,
                        const float* __restrict__ bias, int relu, TcGeom g) {
  constexpr int kStages = tc_stages<BN>(), kCStride = tc_cstride<BN>();
  constexpr int kABytes = kBM * BK, kBBytes = BN * BK;
  extern __shared__ uint8_t smem_raw[];
  // 1024-byte alignment: the swizzle pattern repeats every 8 rows of 128 B
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint8_t* a_tiles = smem;                               // kStages x kABytes
  uint8_t* b_tiles = smem + kStages * kABytes;           // kStages x kBBytes
  uint32_t* ctile = reinterpret_cast<uint32_t*>(b_tiles + kStages * kBBytes);
  float* col_scale = reinterpret_cast<float*>(ctile + kBM * kCStride);
  float* col_bias = col_scale + BN;
  long long* row_base = reinterpret_cast<long long*>(col_bias + BN);
  uint64_t* full = reinterpret_cast<uint64_t*>(row_base + kBM);
  uint64_t* empty = full + kStages;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == kConsumerWarps) {
    // producer: one thread walks the tiles' taps and channel chunks
    if (lane != 0) return;
    int it = 0;
    for (int t = blockIdx.x; t < g.tiles; t += gridDim.x) {
      const Tile T = tile_at<BN>(g, t);
      for (int j = 0; j < T.nty; ++j) {
        for (int i = 0; i < T.ntx; ++i) {
          if (tap_is_padding(g, T, j, i)) continue;
          const int tap = (T.ky0 + j * g.s) * g.K + T.kx0 + i * g.s;
          const int iy0 = T.qy0 + T.dy0 - j, ix0 = T.qx0 + T.dx0 - i;
          for (int c = 0; c < g.kChunks; ++c, ++it) {
            const int st = it % kStages;
            if (it >= kStages) mbar_wait(&empty[st], ((it / kStages) - 1) & 1);
            mbar_expect_tx(&full[st], kABytes + kBBytes);
            tma_load_4d(a_tiles + st * kABytes, &xmap, &full[st], c * BK, ix0, iy0,
                        T.b0);
            tma_load_3d(b_tiles + st * kBBytes, &wmap, &full[st], c * BK, T.n0, tap);
          }
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows 64 wg .. 64 wg + 63 of each tile
  const int wg = warp / 4, ct = threadIdx.x;
  const bool is_float = out_f32 != nullptr;
  const float as = is_float ? *a_scale : 0.0f;
  int it = 0;
  for (int t = blockIdx.x; t < g.tiles; t += gridDim.x) {
    const Tile T = tile_at<BN>(g, t);
    int acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
    const int first = it;
    for (int j = 0; j < T.nty; ++j) {
      for (int i = 0; i < T.ntx; ++i) {
        if (tap_is_padding(g, T, j, i)) continue;
        for (int c = 0; c < g.kChunks; ++c, ++it) {
          const int st = it % kStages;
          mbar_wait(&full[st], (it / kStages) & 1);
          const uint64_t da = smem_desc<BK>(a_tiles + st * kABytes + wg * 64 * BK);
          const uint64_t db = smem_desc<BK>(b_tiles + st * kBBytes);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < BK / 32; ++kk)
            Wgmma<BN>::mma(acc, da + 2 * kk, db + 2 * kk);
          wgmma_commit();
          // the previous stage's products are done: hand it back
          wgmma_wait<1>();
          if (it > first && lane == 0) mbar_arrive(&empty[(it - 1) % kStages]);
        }
      }
    }
    wgmma_wait<0>();
    if (it > first && lane == 0) mbar_arrive(&empty[(it - 1) % kStages]);

    // epilogue, staged: the tile's columns' scale and bias and its rows'
    // output offsets (-1 outside the output), then each thread's
    // accumulators, converted, into the shared output tile (acc[4 j + 2 h +
    // e] is row 16 (warp % 4) + lane / 4 + 8 h of this warpgroup, column
    // 8 j + 2 (lane % 4) + e), then every row's channel run stored with
    // 16-byte stores, contiguous along the row
    consumers_sync();  // the previous tile's stores have read the tile
    const int Hq = (g.Ho - T.ry + g.s - 1) / g.s, Wq = (g.Wo - T.rx + g.s - 1) / g.s;
    if (ct < BN && is_float) {
      const int c = (T.n0 + ct) % g.Cs;
      col_scale[ct] = __fmul_rn(as, scale[c]);
      col_bias[ct] = bias[c];
    }
    if (ct < kBM) {
      const int qx = T.qx0 + ct % g.boxW, qy = T.qy0 + ct / g.boxW % g.boxH;
      const int b = T.b0 + ct / (g.boxW * g.boxH);
      row_base[ct] = (b >= g.B || qy >= Hq || qx >= Wq)
                         ? -1LL
                         : ((static_cast<long long>(b) * g.Ho + qy * g.s + T.ry) * g.Wo +
                            qx * g.s + T.rx) *
                               g.N;
    }
    consumers_sync();
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = wg * 64 + (warp % 4) * 16 + lane / 4 + 8 * h;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int c = 8 * j + 2 * (lane % 4);
        int v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
        if (is_float) {
          v0 = __float_as_int(epilogue(v0, col_scale[c], col_bias[c], relu));
          v1 = __float_as_int(epilogue(v1, col_scale[c + 1], col_bias[c + 1], relu));
        }
        *reinterpret_cast<int2*>(ctile + r * kCStride + c) = make_int2(v0, v1);
      }
    }
    consumers_sync();
    uint32_t* out = is_float ? reinterpret_cast<uint32_t*>(out_f32)
                             : reinterpret_cast<uint32_t*>(out_i32);
    const int ncols = g.N - T.n0 < BN ? g.N - T.n0 : BN;
    const bool vec = g.N % 4 == 0 && ncols == BN;
    for (int v = ct; v < kBM * (BN / 4); v += kConsumers) {
      const int r = v / (BN / 4), c = 4 * (v % (BN / 4));
      const long long base = row_base[r];
      if (base < 0) continue;
      uint32_t* dst = out + base + T.n0 + c;
      const uint32_t* src = ctile + r * kCStride + c;
      if (vec) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
      } else {
        for (int e = 0; e < 4 && c + e < ncols; ++e) dst[e] = src[e];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// The bytes kernel (Co < 8).
// ---------------------------------------------------------------------------
constexpr int kThreadsBytes = 256;

struct BytesGeom {
  int B, Hi, Wi, Ci4, Ho, Wo, Hq, Wq;
};

// The input rows (and columns) a quad reads lie at qy + d, d in [lo, hi].
__host__ __device__ constexpr int window_lo(int K, int S, int P) {
  int m = 1 << 20;
  for (int r = 0; r < S; ++r)
    for (int k = 0; k < K; ++k)
      if ((r + P - k) % S == 0 && (r + P - k) / S < m) m = (r + P - k) / S;
  return m;
}
__host__ __device__ constexpr int window_hi(int K, int S, int P) {
  int m = -(1 << 20);
  for (int r = 0; r < S; ++r)
    for (int k = 0; k < K; ++k)
      if ((r + P - k) % S == 0 && (r + P - k) / S > m) m = (r + P - k) / S;
  return m;
}

__device__ __forceinline__ int dot16(const int4 a, const int4 w, int acc) {
  acc = __dp4a(a.x, w.x, acc);
  acc = __dp4a(a.y, w.y, acc);
  acc = __dp4a(a.z, w.z, acc);
  return __dp4a(a.w, w.w, acc);
}

// (k, s, p) and CO output channels at compile time: every tap, window slot
// and weight offset is a constant.
template <int K, int S, int P, int CO>
__global__ void __launch_bounds__(kThreadsBytes)
    deconv_i8_kernel_bytes(const int8_t* __restrict__ x,
                           const int8_t* __restrict__ w,
                           int32_t* __restrict__ out_i32, float* __restrict__ out_f32,
                           const float* __restrict__ a_scale,
                           const float* __restrict__ scale,
                           const float* __restrict__ bias, int relu, BytesGeom g) {
  constexpr int LO = window_lo(K, S, P);
  constexpr int WD = window_hi(K, S, P) - LO + 1;
  extern __shared__ int4 ws[];  // [chunk][ky][kx][co], 16 channels each
  const int chunks = g.Ci4 / 16;
  const int nw = chunks * K * K * CO;
  for (int i = threadIdx.x; i < nw; i += blockDim.x) {
    const int co = i % CO, t = i / CO % (K * K), c = i / (CO * K * K);
    ws[i] = *reinterpret_cast<const int4*>(w + (t * CO + co) * g.Ci4 + 16 * c);
  }
  __syncthreads();
  const float as = out_f32 != nullptr ? *a_scale : 0.0f;
  float sc[CO], bi[CO];
#pragma unroll
  for (int co = 0; co < CO; ++co) {
    sc[co] = out_f32 != nullptr ? __fmul_rn(as, scale[co]) : 0.0f;
    bi[co] = out_f32 != nullptr ? bias[co] : 0.0f;
  }
  const long long total = static_cast<long long>(g.B) * g.Hq * g.Wq;
  for (long long q = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       q < total; q += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int qx = static_cast<int>(q % g.Wq);
    const int qy = static_cast<int>(q / g.Wq % g.Hq);
    const int b = static_cast<int>(q / (static_cast<long long>(g.Wq) * g.Hq));
    int acc[S][S][CO];
#pragma unroll
    for (int ry = 0; ry < S; ++ry)
#pragma unroll
      for (int rx = 0; rx < S; ++rx)
#pragma unroll
        for (int co = 0; co < CO; ++co) acc[ry][rx][co] = 0;
    for (int c = 0; c < chunks; ++c) {
      int4 win[WD][WD];
#pragma unroll
      for (int wy = 0; wy < WD; ++wy) {
        const int iy = qy + LO + wy;
#pragma unroll
        for (int wx = 0; wx < WD; ++wx) {
          const int ix = qx + LO + wx;
          win[wy][wx] = (iy >= 0 && iy < g.Hi && ix >= 0 && ix < g.Wi)
                            ? __ldg(reinterpret_cast<const int4*>(
                                  x + ((b * g.Hi + iy) * g.Wi + ix) * g.Ci4 + 16 * c))
                            : make_int4(0, 0, 0, 0);
        }
      }
      const int4* wc = ws + c * K * K * CO;
#pragma unroll
      for (int ry = 0; ry < S; ++ry)
#pragma unroll
        for (int ky = 0; ky < K; ++ky) {
          if ((ry + P - ky) % S != 0) continue;
#pragma unroll
          for (int rx = 0; rx < S; ++rx)
#pragma unroll
            for (int kx = 0; kx < K; ++kx) {
              if ((rx + P - kx) % S != 0) continue;
              const int4 a = win[(ry + P - ky) / S - LO][(rx + P - kx) / S - LO];
#pragma unroll
              for (int co = 0; co < CO; ++co)
                acc[ry][rx][co] = dot16(a, wc[(ky * K + kx) * CO + co], acc[ry][rx][co]);
            }
        }
    }
#pragma unroll
    for (int ry = 0; ry < S; ++ry) {
      const int oy = qy * S + ry;
      if (oy >= g.Ho) continue;
#pragma unroll
      for (int rx = 0; rx < S; ++rx) {
        const int ox = qx * S + rx;
        if (ox >= g.Wo) continue;
        const size_t base = ((static_cast<size_t>(b) * g.Ho + oy) * g.Wo + ox) * CO;
#pragma unroll
        for (int co = 0; co < CO; ++co) {
          if (out_f32 == nullptr)
            out_i32[base + co] = acc[ry][rx][co];
          else
            out_f32[base + co] = epilogue(acc[ry][rx][co], sc[co], bi[co], relu);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Host side.
// ---------------------------------------------------------------------------
constexpr int kErrInvalid = static_cast<int>(cudaErrorInvalidValue);

// cuTensorMapEncodeTiled for an int8 tensor: dims innermost first, strides
// in bytes of dims 1.., the box, and the swizzle span in bytes (128 or 32).
int encode(CUtensorMap* map, const void* ptr, int rank, const uint64_t* dims,
           const uint64_t* strides, const uint32_t* box, int span) {
  const uint32_t ones[5] = {1, 1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle =
      span == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult r = cuTensorMapEncodeTiled(
      map, CU_TENSOR_MAP_DATA_TYPE_UINT8, rank, const_cast<void*>(ptr), dims,
      strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrInvalid;
}

// The weights' maps, cached: a serving call runs the same packed tensors at
// the same plans every time. A hit needs every encoded field equal, so it is
// the map that would be encoded.
struct WeightMapEntry {
  const void* ptr;
  int ci4, rows, taps, bk, bn, swizzle, stride_row, stride_tap;
  CUtensorMap map;
};
std::mutex weight_maps_mutex;
WeightMapEntry weight_maps[32];
int weight_maps_next = 0;

int weight_map(CUtensorMap* out, const void* w, const int* plan) {
  const int ci4 = plan[kCi4], rows = plan[kMapRows], taps = plan[kMapTaps];
  const int bk = plan[kBK], bn = plan[kBN], swizzle = plan[kSwizzle];
  const int stride_row = plan[kWStrideRow], stride_tap = plan[kWStrideTap];
  std::lock_guard<std::mutex> lock(weight_maps_mutex);
  for (const WeightMapEntry& e : weight_maps) {
    if (e.ptr == w && e.ci4 == ci4 && e.rows == rows && e.taps == taps &&
        e.bk == bk && e.bn == bn && e.swizzle == swizzle &&
        e.stride_row == stride_row && e.stride_tap == stride_tap) {
      *out = e.map;
      return 0;
    }
  }
  const uint64_t dims[3] = {static_cast<uint64_t>(ci4), static_cast<uint64_t>(rows),
                            static_cast<uint64_t>(taps)};
  const uint64_t strides[2] = {static_cast<uint64_t>(stride_row),
                               static_cast<uint64_t>(stride_tap)};
  const uint32_t box[3] = {static_cast<uint32_t>(bk), static_cast<uint32_t>(bn), 1};
  const int err = encode(out, w, 3, dims, strides, box, swizzle);
  if (err != 0) return err;
  WeightMapEntry& e = weight_maps[weight_maps_next];
  weight_maps_next = (weight_maps_next + 1) % 32;
  e = {w, ci4, rows, taps, bk, bn, swizzle, stride_row, stride_tap, *out};
  return 0;
}

constexpr int kMaxDevices = 64;

// The current device's index, checked against kMaxDevices.
int current_device(int* dev) {
  const cudaError_t e = cudaGetDevice(dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  return *dev < 0 || *dev >= kMaxDevices ? kErrInvalid : 0;
}

// The card's SMs (per device, read once).
int sm_count(int* out) {
  static int sms[kMaxDevices] = {0};
  int dev = 0;
  const int err = current_device(&dev);
  if (err != 0) return err;
  if (sms[dev] == 0) {
    const cudaError_t e =
        cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  *out = sms[dev];
  return 0;
}

template <int BN, int BK>
int launch_tc(const int* plan, const int8_t* x, const int8_t* w, int32_t* oi,
              float* of, const float* fa, const float* fs, const float* fb,
              int relu, cudaStream_t stream) {
  constexpr int smem = tc_smem_bytes<BN, BK>();
  // Resident blocks per SM, per device: the shared-memory attribute is set
  // in each device's context.
  static int per_sm[kMaxDevices] = {0};
  int dev = 0;
  int err = current_device(&dev);
  if (err != 0) return err;
  if (per_sm[dev] == 0) {
    int blocks_per_sm = 0;
    cudaError_t e = cudaFuncSetAttribute(
        deconv_i8_kernel_tc<BN, BK>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks_per_sm, deconv_i8_kernel_tc<BN, BK>, kThreadsTc, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (blocks_per_sm < 1) return kErrInvalid;
    per_sm[dev] = blocks_per_sm;
  }
  int sms = 0;
  err = sm_count(&sms);
  if (err != 0) return err;
  const int ci4 = plan[kCi4];
  CUtensorMap xmap, wmap;
  const uint64_t xdims[4] = {static_cast<uint64_t>(ci4), static_cast<uint64_t>(plan[kWi]),
                             static_cast<uint64_t>(plan[kHi]), static_cast<uint64_t>(plan[kB])};
  const uint64_t xstrides[3] = {static_cast<uint64_t>(plan[kXStrideW]),
                                static_cast<uint64_t>(plan[kXStrideH]),
                                static_cast<uint64_t>(plan[kXStrideB])};
  const uint32_t xbox[4] = {static_cast<uint32_t>(BK), static_cast<uint32_t>(plan[kBoxW]),
                            static_cast<uint32_t>(plan[kBoxH]),
                            static_cast<uint32_t>(plan[kBoxB])};
  err = encode(&xmap, x, 4, xdims, xstrides, xbox, plan[kSwizzle]);
  if (err == 0) err = weight_map(&wmap, w, plan);
  if (err != 0) return err;
  const long long tiles = static_cast<long long>(plan[kGridX]) * plan[kGridZ];
  if (tiles > 0x7fffffffLL) return kErrInvalid;
  const TcGeom g{plan[kB],      plan[kHi],     plan[kWi],     plan[kHo],
                 plan[kWo],     plan[kN],      plan[kCs],     plan[kK],
                 plan[kS],      plan[kP],      plan[kBoxW],   plan[kBoxH],
                 plan[kBoxB],   plan[kTilesW], plan[kTilesH], plan[kTilesN],
                 ci4 / BK,      plan[kGridZ],  static_cast<int>(tiles)};
  const long long resident = static_cast<long long>(sms) * per_sm[dev];
  const int blocks = static_cast<int>(tiles < resident ? tiles : resident);
  deconv_i8_kernel_tc<BN, BK><<<blocks, kThreadsTc, smem, stream>>>(
      xmap, wmap, oi, of, fa, fs, fb, relu, g);
  return static_cast<int>(cudaGetLastError());
}

template <int K, int S, int P, int CO>
int launch_bytes(const int* plan, const int8_t* x, const int8_t* w, int32_t* oi,
                 float* of, const float* fa, const float* fs, const float* fb,
                 int relu, cudaStream_t stream) {
  int sms = 0;  // the grid strides over the quads, 8 blocks per SM at most
  const int err = sm_count(&sms);
  if (err != 0) return err;
  const BytesGeom g{plan[kB],  plan[kHi], plan[kWi], plan[kCi4],
                    plan[kHo], plan[kWo], (plan[kHo] + S - 1) / S,
                    (plan[kWo] + S - 1) / S};
  const long long quads = static_cast<long long>(g.B) * g.Hq * g.Wq;
  const long long want = (quads + kThreadsBytes - 1) / kThreadsBytes;
  const int blocks = static_cast<int>(want < 8LL * sms ? want : 8LL * sms);
  const int smem = K * K * CO * g.Ci4;
  deconv_i8_kernel_bytes<K, S, P, CO><<<blocks, kThreadsBytes, smem, stream>>>(
      x, w, oi, of, fa, fs, fb, relu, g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// K3. x (B, Hi, Wi, Ci4) int8, w (K, K, Co, Ci4) int8 -> out (B, Ho, Wo, Co):
// int32 sums when out_is_float is 0, else the float32 epilogue from a_scale
// (a 0-d float32 on the device), scale (Co) and bias (Co), with ReLU when
// relu is non-zero. plan: kPlanLen ints from quant.py::k3_plan. Contiguous,
// 16-byte aligned, on the current device; every offset below 2^31 (the
// wrapper checks).
int ganode_deconv_i8(const void* x, const void* w, void* out, int out_is_float,
                     const void* a_scale, const void* scale, const void* bias,
                     int relu, const int* plan, void* stream) {
  auto* xi = static_cast<const int8_t*>(x);
  auto* wi = static_cast<const int8_t*>(w);
  auto* oi = out_is_float ? nullptr : static_cast<int32_t*>(out);
  auto* of = out_is_float ? static_cast<float*>(out) : nullptr;
  auto* fa = static_cast<const float*>(a_scale);
  auto* fs = static_cast<const float*>(scale);
  auto* fb = static_cast<const float*>(bias);
  auto st = static_cast<cudaStream_t>(stream);
  if (plan[kB] < 1 || plan[kCi4] < 32 || plan[kCi4] % 32 != 0 || plan[kN] < 1)
    return kErrInvalid;
  if (plan[kRoute] == 1) {
#define GANODE_BYTES(K_, S_, P_, CO_)                                            \
  if (plan[kK] == K_ && plan[kS] == S_ && plan[kP] == P_ && plan[kN] == CO_)     \
    return launch_bytes<K_, S_, P_, CO_>(plan, xi, wi, oi, of, fa, fs, fb, relu, st);
    GANODE_BYTES(4, 2, 1, 3)
    GANODE_BYTES(1, 1, 0, 1)
#undef GANODE_BYTES
    return kErrInvalid;
  }
  // the shared-memory descriptors are compiled for a swizzle span of one
  // BK-byte row
  if (plan[kRoute] != 0 || plan[kCi4] % plan[kBK] != 0 ||
      plan[kSwizzle] != plan[kBK] || plan[kBoxW] * plan[kBoxH] * plan[kBoxB] != kBM)
    return kErrInvalid;
#define GANODE_TC(BN, BK)                                                     \
  if (plan[kBN] == BN && plan[kBK] == BK)                                     \
    return launch_tc<BN, BK>(plan, xi, wi, oi, of, fa, fs, fb, relu, st);
  GANODE_TC(64, 32)
  GANODE_TC(64, 128)
  GANODE_TC(128, 32)
  GANODE_TC(128, 128)
#undef GANODE_TC
  return kErrInvalid;
}

}  // extern "C"
