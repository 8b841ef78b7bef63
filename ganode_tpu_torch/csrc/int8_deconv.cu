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
// x (B, Hi, Wi, Ci4) int8 NHWC, Ci zero-padded to Ci4, a multiple of 4;
// w (k, k, Co, Ci4) int8, packed once by quant.py; y (B, Ho, Wo, Co) NHWC,
// Ho = (Hi - 1) s - 2 p + k. Either the int32 sums, or the fused epilogue in
// float32, y * (a_scale * scale[co]) + bias[co] with __fmul_rn / __fadd_rn
// (the plain version's unfused float32 operations, in its order; a_scale
// read from device memory, so the host never syncs), then ReLU if asked.
//
// Design (simple and right first; no wgmma). An implicit GEMM in gather form
// over one output parity class (oy % s, ox % s) per grid z: in a class the
// taps that reach an output are ky = (ry + p) % s + j s, at a row offset
// iy = qy + (ry + p - ky) / s shared by every output of the class, so a tile
// runs the same taps for all its rows. Rows are m = (qy * Wq + qx) * B + b,
// the batch fastest: at serving batch (B' = 1,024 or 2,048 frames) a tile of
// rows shares (qy, qx), so a tap that reads only padding is skipped by the
// whole block (15 of the 16 taps of the first layer, from 1 x 1). The
// reduction runs over taps and over Ci4 in steps of 8 words (32 channels):
// A (rows x words) and B (channels x words) tiles in shared memory, word
// major, each thread holding RM x RN int32 sums and issuing __dp4a on 4
// packed channels at a time. Two shapes: wide (64 rows x 64 channels, 4 x 4
// per thread) for Co > 4, narrow (512 rows x 4 channels, 2 x 4 per thread)
// for the last layer's 1 or 3 channels, which would leave 61 of 64 wide
// columns idle.
//
// What bounds it on this card: int8 operations, 2 MACs per product at 1,979
// TOPS dense (ucf_ode's sample_videos(64): ~85 GMAC of taps that land in the
// output, ~0.09 ms); the last layer, with its few channels, by bytes. __dp4a
// runs on the integer pipes at a small fraction of that rate, so this kernel
// sits far above its bound; a wgmma s8 kernel is the later step.
//
// Sums are exact: |x|, |w| <= 127 and Ci4 k^2 / s^2 <= 2^17 products per
// output keep them below 2^31. The launcher returns 0 or the cudaError_t of
// the launch; shapes it cannot take return cudaErrorInvalidValue, nothing
// launched (the Python wrapper checks them first).

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWords = 8;  // 32-bit words (4 channels each) per reduction step

template <int N>
struct Vec;
template <>
struct Vec<2> {
  __device__ static void load(const int* p, int (&v)[2]) {
    const int2 t = *reinterpret_cast<const int2*>(p);
    v[0] = t.x;
    v[1] = t.y;
  }
};
template <>
struct Vec<4> {
  __device__ static void load(const int* p, int (&v)[4]) {
    const int4 t = *reinterpret_cast<const int4*>(p);
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  }
};

struct Shape {
  int B, Hi, Wi, Ci4, Ho, Wo, Co, K, s, p;
};

// TN threads across channels, kThreads / TN across rows; each thread RM rows
// by RN channels.
template <int TN, int RM, int RN>
__global__ void __launch_bounds__(kThreads)
    deconv_i8_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                     int32_t* __restrict__ out_i32, float* __restrict__ out_f32,
                     const float* __restrict__ a_scale,
                     const float* __restrict__ scale,
                     const float* __restrict__ bias, int relu, Shape g) {
  constexpr int TM = kThreads / TN;
  constexpr int BM = TM * RM;
  constexpr int BN = TN * RN;
  __shared__ __align__(16) int As[kWords][BM];
  __shared__ __align__(16) int Bs[kWords][BN];
  __shared__ int row_off[BM];  // x offset of the tap's input pixel, or -1

  const int ry = blockIdx.z / g.s, rx = blockIdx.z % g.s;
  const int Hq = (g.Ho - ry + g.s - 1) / g.s;
  const int Wq = (g.Wo - rx + g.s - 1) / g.s;
  const int Mq = g.B * Hq * Wq;  // rows of this parity class
  const int m0 = blockIdx.x * BM;
  if (m0 >= Mq) return;  // uniform across the block
  const int n0 = blockIdx.y * BN;
  const int tid = threadIdx.x;
  const int tx = tid % TN, ty = tid / TN;
  const int words = g.Ci4 / 4;

  int acc[RM][RN];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j) acc[i][j] = 0;

  for (int ky = (ry + g.p) % g.s; ky < g.K; ky += g.s) {
    const int dy = (ry + g.p - ky) / g.s;  // exact: ky = ry + p (mod s)
    for (int kx = (rx + g.p) % g.s; kx < g.K; kx += g.s) {
      const int dx = (rx + g.p - kx) / g.s;
      int any = 0;
      for (int r = tid; r < BM; r += kThreads) {
        const int m = m0 + r;
        int off = -1;
        if (m < Mq) {
          const int b = m % g.B, q = m / g.B;
          const int iy = q / Wq + dy, ix = q % Wq + dx;
          if (iy >= 0 && iy < g.Hi && ix >= 0 && ix < g.Wi)
            off = ((b * g.Hi + iy) * g.Wi + ix) * g.Ci4;
        }
        row_off[r] = off;
        any |= off >= 0;
      }
      // a tap that reads only padding for every row of the tile adds nothing
      if (!__syncthreads_or(any)) continue;
      const int8_t* wt = w + (ky * g.K + kx) * g.Co * g.Ci4;
      for (int k0 = 0; k0 < words; k0 += kWords) {
        for (int idx = tid; idx < BM * kWords; idx += kThreads) {
          const int r = idx / kWords, kw = idx % kWords;
          const int off = row_off[r];
          As[kw][r] = (off >= 0 && k0 + kw < words)
                          ? *reinterpret_cast<const int*>(x + off + 4 * (k0 + kw))
                          : 0;
        }
        for (int idx = tid; idx < BN * kWords; idx += kThreads) {
          const int c = idx / kWords, kw = idx % kWords;
          const int co = n0 + c;
          Bs[kw][c] = (co < g.Co && k0 + kw < words)
                          ? *reinterpret_cast<const int*>(wt + co * g.Ci4 +
                                                          4 * (k0 + kw))
                          : 0;
        }
        __syncthreads();
#pragma unroll
        for (int kw = 0; kw < kWords; ++kw) {
          int a[RM], bv[RN];
          Vec<RM>::load(&As[kw][ty * RM], a);
          Vec<RN>::load(&Bs[kw][tx * RN], bv);
#pragma unroll
          for (int i = 0; i < RM; ++i)
#pragma unroll
            for (int j = 0; j < RN; ++j) acc[i][j] = __dp4a(a[i], bv[j], acc[i][j]);
        }
        __syncthreads();
      }
    }
  }

  const float as = out_f32 != nullptr ? *a_scale : 0.0f;
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int m = m0 + ty * RM + i;
    if (m >= Mq) continue;
    const int b = m % g.B, q = m / g.B;
    const int oy = (q / Wq) * g.s + ry, ox = (q % Wq) * g.s + rx;
    const int base = ((b * g.Ho + oy) * g.Wo + ox) * g.Co;
#pragma unroll
    for (int j = 0; j < RN; ++j) {
      const int co = n0 + tx * RN + j;
      if (co >= g.Co) continue;
      if (out_f32 == nullptr) {
        out_i32[base + co] = acc[i][j];
      } else {
        float v = __fadd_rn(
            __fmul_rn(__int2float_rn(acc[i][j]), __fmul_rn(as, scale[co])),
            bias[co]);
        if (relu && v < 0.0f) v = 0.0f;
        out_f32[base + co] = v;
      }
    }
  }
}

template <int TN, int RM, int RN>
int launch(const int8_t* x, const int8_t* w, int32_t* out_i32, float* out_f32,
           const float* a_scale, const float* scale, const float* bias,
           int relu, const Shape& g, cudaStream_t stream) {
  constexpr int BM = (kThreads / TN) * RM, BN = TN * RN;
  const long long rows =
      static_cast<long long>(g.B) * ((g.Ho + g.s - 1) / g.s) * ((g.Wo + g.s - 1) / g.s);
  const long long bx = (rows + BM - 1) / BM;
  const int by = (g.Co + BN - 1) / BN;
  if (bx > 0x7fffffffLL || by > 65535 || g.s * g.s > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  deconv_i8_kernel<TN, RM, RN>
      <<<dim3(static_cast<unsigned>(bx), by, g.s * g.s), kThreads, 0, stream>>>(
          x, w, out_i32, out_f32, a_scale, scale, bias, relu, g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// K3. x (B, Hi, Wi, Ci4) int8, w (K, K, Co, Ci4) int8 -> out (B, Ho, Wo, Co):
// int32 sums when out_is_float is 0, else the float32 epilogue from a_scale
// (a 0-d float32 on the device), scale (Co) and bias (Co), with ReLU when
// relu is non-zero. Contiguous, on the current device; every offset below
// 2^31 (the wrapper checks).
int ganode_deconv_i8(const void* x, const void* w, void* out, int out_is_float,
                     const void* a_scale, const void* scale, const void* bias,
                     int relu, int B, int Hi, int Wi, int Ci4, int Co, int K,
                     int s, int p, void* stream) {
  const int Ho = (Hi - 1) * s - 2 * p + K, Wo = (Wi - 1) * s - 2 * p + K;
  if (B < 1 || Hi < 1 || Wi < 1 || Ci4 < 4 || Ci4 % 4 != 0 || Co < 1 ||
      K < 1 || s < 1 || p < 0 || Ho < 1 || Wo < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Shape g{B, Hi, Wi, Ci4, Ho, Wo, Co, K, s, p};
  auto* xi = static_cast<const int8_t*>(x);
  auto* wi = static_cast<const int8_t*>(w);
  auto* oi = out_is_float ? nullptr : static_cast<int32_t*>(out);
  auto* of = out_is_float ? static_cast<float*>(out) : nullptr;
  auto* fa = static_cast<const float*>(a_scale);
  auto* fs = static_cast<const float*>(scale);
  auto* fb = static_cast<const float*>(bias);
  auto st = static_cast<cudaStream_t>(stream);
  if (Co <= 4) return launch<1, 2, 4>(xi, wi, oi, of, fa, fs, fb, relu, g, st);
  return launch<16, 4, 4>(xi, wi, oi, of, fa, fs, fb, relu, g, st);
}

}  // extern "C"
