// Motion-latent kernels for Hopper (sm_90a): the port of the JAX package's two
// Pallas TPU kernels. Plain C interface, built by ganode_tpu_torch/ops/_build.py
// with nvcc into a shared library and bound with ctypes; no PyTorch headers.
//
// K1 rk4_motion replaces ganode_tpu/ops/fused_rk4.py `_rk4_kernel`
//    (pl.pallas_call in `_fused_forward`): the whole RK4 trajectory of
//    f(y) = tanh(y @ w1 + b1) @ w2 + b2 over a uniform grid, 4 (T-1) right-hand
//    side evaluations in one launch, out[0] = x.
// K2 gru_motion replaces ganode_tpu/ops/fused_gru.py `_gru_kernel`:
//    T steps of the torch-semantics GRU, gates in [r | z | n] blocks, both the
//    input and the hidden projection computed inside the kernel.
//
// What bounds them on this card. At the serving shape (B=64, D=H=16, T=16) K1
// does ~4 MFLOP and moves ~70 KB, K2 ~3 MFLOP and ~140 KB: the roofline bound
// is tens of nanoseconds either way. Neither bytes nor operations set the time:
// the dependent chain does. K1 is 60 RHS evaluations in a row, K2 16 steps,
// each link a pair of tiny matrix-vector products and a transcendental, and
// the rows are too few (64) to give the card other work while a link waits.
// So each link has to be short.
//
// Each kernel comes in two variants, chosen by the Python wrapper from the
// widths (`_build.choose_variant`):
//
// - warp (max(D, H) <= 32, every config): one batch row per group of W = 16
//   or 32 lanes (a template parameter, W >= every width), one or two rows per
//   warp, one warp per block, so the rows spread over many SMs. Lane j keeps
//   element j of the state and of every stage vector in a register, and its
//   weight columns in registers for the whole solve. A product's inputs reach
//   the lanes by __shfl_sync unrolled over the W lanes, summed in independent
//   partial sums so FMA latency overlaps. The time loop has no block barrier
//   and no shared-memory round trip. Lanes past D or H hold zero weights and
//   zero bias, so they stay zero (tanh(0) = 0; a zero GRU state stays zero);
//   stores are masked to the real rows and columns. K2 loads e four steps
//   ahead and projects it one step ahead, so only the hidden product and the
//   gate math stay on the chain.
// - wide (larger widths): the earlier design, kept for widths the warp variant
//   does not take. One block owns a tile of rows; weights, state and stage vectors
//   sit in shared memory for the whole solve, two block barriers per phase.
//
// Arithmetic is float32 with tanhf/expf (no fast-math): results agree with
// the plain PyTorch versions to ~1e-6, sums running in another order.
//
// Every launcher returns 0, GANODE_ERR_SMEM when the shapes need more shared
// memory than the card allows a block, GANODE_ERR_WIDTH when a warp launcher
// is given widths above its lane count (nothing is launched in either case),
// or the cudaError_t of the launch.

#include <atomic>

#include <cuda_runtime.h>

#define GANODE_ERR_SMEM (-1)
#define GANODE_ERR_WIDTH (-2)

namespace {

constexpr int kThreads = 128;   // wide variants
constexpr int kWarpBlock = 32;  // warp variants: one warp per block
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kMaxDevices = 64;
constexpr int kAhead = 4;  // steps K2's warp variant loads its noise ahead

// Shared memory a block may have on the current device (opt-in maximum),
// queried once per device.
int smem_limit() {
  static std::atomic<int> cached[kMaxDevices];  // 0: not queried yet
  int dev = 0, limit = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (dev >= 0 && dev < kMaxDevices) limit = cached[dev].load();
  if (limit != 0) return limit;
  if (cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return 0;
  if (dev >= 0 && dev < kMaxDevices) cached[dev].store(limit);
  return limit;
}

template <typename Kernel>
int prepare_smem(Kernel kernel, size_t bytes) {
  if (bytes > static_cast<size_t>(smem_limit())) return GANODE_ERR_SMEM;
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

int rows_per_block(int batch, int width) {
  int rows = kThreads / (width > 0 ? width : 1);
  if (rows < 1) rows = 1;
  return rows < batch ? rows : batch;
}

__device__ __forceinline__ float sigmoidf(float v) {
  return 1.0f / (1.0f + expf(-v));
}

// ---------------------------------------------------------------------------
// Warp variants. A group is W consecutive lanes of a warp and owns one batch
// row; `lane` is the thread's index in its group. Every lane of the warp runs
// every __shfl_sync: a group whose row is past B computes on a zero row and
// stores nothing, it does not return early.
// ---------------------------------------------------------------------------

// sum over k < W of v_k * w[k] + bias, where v_k is lane k's v: four
// independent partial sums.
template <int W>
__device__ __forceinline__ float group_dot(float v, const float (&w)[W],
                                           float bias) {
  float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
#pragma unroll
  for (int k = 0; k < W; k += 4) {
    s0 = fmaf(__shfl_sync(kFullMask, v, k, W), w[k], s0);
    s1 = fmaf(__shfl_sync(kFullMask, v, k + 1, W), w[k + 1], s1);
    s2 = fmaf(__shfl_sync(kFullMask, v, k + 2, W), w[k + 2], s2);
    s3 = fmaf(__shfl_sync(kFullMask, v, k + 3, W), w[k + 3], s3);
  }
  return ((s0 + s1) + (s2 + s3)) + bias;
}

// The three gate blocks' products of one broadcast vector: g[i] = sum over
// k < W of v_k * col(i, k) + bias[i], two partial sums each. Col(i, k) is
// column `lane` of gate block i, row k, read by `col`.
template <int W, typename Col>
__device__ __forceinline__ void gate_dots(float v, Col col,
                                          const float (&bias)[3],
                                          float (&g)[3]) {
  float s[3][2] = {{0.f, 0.f}, {0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
  for (int k = 0; k < W; k += 2) {
    const float v0 = __shfl_sync(kFullMask, v, k, W);
    const float v1 = __shfl_sync(kFullMask, v, k + 1, W);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      s[i][0] = fmaf(v0, col(i, k), s[i][0]);
      s[i][1] = fmaf(v1, col(i, k + 1), s[i][1]);
    }
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) g[i] = (s[i][0] + s[i][1]) + bias[i];
}

// K1, warp variant. Lane j holds column j of w1 (hidden unit j) and column j
// of w2 (output j), 2W floats, plus b1[j] and b2[j].
template <int W>
__device__ __forceinline__ float rk4_rhs(float y, const float (&w1c)[W],
                                         float b1c, const float (&w2c)[W],
                                         float b2c) {
  const float a = tanhf(group_dot<W>(y, w1c, b1c));
  return group_dot<W>(a, w2c, b2c);
}

template <int W>
__global__ void __launch_bounds__(kWarpBlock)
    rk4_warp_kernel(const float* __restrict__ x, const float* __restrict__ w1,
                    const float* __restrict__ b1, const float* __restrict__ w2,
                    const float* __restrict__ b2, float* __restrict__ out,
                    int B, int D, int H, int T, float h) {
  const int lane = threadIdx.x % W;
  const int row = blockIdx.x * (kWarpBlock / W) + threadIdx.x / W;
  const bool live = row < B && lane < D;

  float w1c[W], w2c[W];
#pragma unroll
  for (int k = 0; k < W; ++k) {
    w1c[k] = (k < D && lane < H) ? w1[k * H + lane] : 0.f;
    w2c[k] = (k < H && lane < D) ? w2[k * D + lane] : 0.f;
  }
  const float b1c = lane < H ? b1[lane] : 0.f;
  const float b2c = lane < D ? b2[lane] : 0.f;

  const size_t plane = static_cast<size_t>(B) * D;
  const size_t off = static_cast<size_t>(row) * D + lane;
  float y = live ? x[off] : 0.f;
  if (live) out[off] = y;

  const float half_h = 0.5f * h;
  const float sixth_h = h / 6.0f;
  for (int t = 1; t < T; ++t) {
    const float k1 = rk4_rhs<W>(y, w1c, b1c, w2c, b2c);
    const float k2 = rk4_rhs<W>(y + half_h * k1, w1c, b1c, w2c, b2c);
    const float k3 = rk4_rhs<W>(y + half_h * k2, w1c, b1c, w2c, b2c);
    const float k4 = rk4_rhs<W>(y + h * k3, w1c, b1c, w2c, b2c);
    y = y + sixth_h * (((k1 + 2.0f * k2) + 2.0f * k3) + k4);
    if (live) out[t * plane + off] = y;
  }
}

// K2, warp variant. Lane d owns h_d and its three gates: it holds columns d,
// D+d and 2D+d of wh in registers (3W floats), and of wi in registers at
// W = 16 or in shared memory at W = 32 (registers would spill there), laid
// out [k][gate][lane] so a warp's reads of one row are conflict-free.
template <int W>
__global__ void __launch_bounds__(kWarpBlock)
    gru_warp_kernel(const float* __restrict__ h0, const float* __restrict__ e,
                    const float* __restrict__ wi, const float* __restrict__ wh,
                    const float* __restrict__ bi, const float* __restrict__ bh,
                    float* __restrict__ out, int B, int D, int T) {
  constexpr bool kWiInRegisters = W <= 16;
  __shared__ float s_wi[kWiInRegisters ? 1 : W * 3 * W];
  const int lane = threadIdx.x % W;
  const int row = blockIdx.x * (kWarpBlock / W) + threadIdx.x / W;
  const bool live = row < B && lane < D;
  const int G = 3 * D;

  float whc[3][W], wic[3][W];
#pragma unroll
  for (int k = 0; k < W; ++k) {
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const bool in = k < D && lane < D;
      whc[i][k] = in ? wh[k * G + i * D + lane] : 0.f;
      if constexpr (kWiInRegisters)
        wic[i][k] = in ? wi[k * G + i * D + lane] : 0.f;
    }
  }
  if constexpr (!kWiInRegisters) {
    for (int j = threadIdx.x; j < W * 3 * W; j += kWarpBlock) {
      const int k = j / (3 * W), i = (j / W) % 3, l = j % W;
      s_wi[j] = (k < D && l < D) ? wi[k * G + i * D + l] : 0.f;
    }
    __syncthreads();  // once, before the time loop
  }
  float bic[3], bhc[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    bic[i] = lane < D ? bi[i * D + lane] : 0.f;
    bhc[i] = lane < D ? bh[i * D + lane] : 0.f;
  }
  auto wi_col = [&](int i, int k) -> float {
    if constexpr (kWiInRegisters) {
      return wic[i][k];
    } else {  // volatile: read in the loop, not hoisted into registers
      return static_cast<const volatile float*>(s_wi)[(k * 3 + i) * W + lane];
    }
  };
  auto wh_col = [&](int i, int k) { return whc[i][k]; };

  const size_t plane = static_cast<size_t>(B) * D;
  const size_t off = static_cast<size_t>(row) * D + lane;
  auto load_e = [&](int t) {
    return (live && t < T) ? e[t * plane + off] : 0.f;
  };
  float h = live ? h0[off] : 0.f;
  float gi[3];
  gate_dots<W>(load_e(0), wi_col, bic, gi);
  // ahead[i] holds e_{t0+i+1} for the steps t0..t0+kAhead-1 of a round: each
  // slot is refilled as soon as it is projected, kAhead steps before its next
  // use, so no step waits on device memory. The round is unrolled, so the
  // slots stay in place (a register move from a pending load would wait).
  float ahead[kAhead];
#pragma unroll
  for (int i = 0; i < kAhead; ++i) ahead[i] = load_e(i + 1);
  for (int t0 = 0; t0 < T; t0 += kAhead) {
#pragma unroll
    for (int i = 0; i < kAhead; ++i) {
      const int t = t0 + i;
      if (t >= T) break;  // the same for every lane
      // off the chain: e_{t+1} projected, e_{t+1+kAhead} loaded
      float gi_next[3];
      gate_dots<W>(ahead[i], wi_col, bic, gi_next);
      ahead[i] = load_e(t + 1 + kAhead);
      // on the chain: h @ wh + bh, then the gates
      float gh[3];
      gate_dots<W>(h, wh_col, bhc, gh);
      // r -> n is the chain; z is needed only by the update, so it comes
      // last (each IEEE division is a branch region the compiler does not
      // schedule across: z first would hold back r and n)
      const float r = sigmoidf(gi[0] + gh[0]);
      const float n = tanhf(gi[2] + r * gh[2]);
      const float z = sigmoidf(gi[1] + gh[1]);
      h = (1.0f - z) * n + z * h;
      if (live) out[t * plane + off] = h;
#pragma unroll
      for (int g = 0; g < 3; ++g) gi[g] = gi_next[g];
    }
  }
}

template <int W>
int launch_rk4_warp(const float* x, const float* w1, const float* b1,
                    const float* w2, const float* b2, float* out, int B, int D,
                    int H, int T, float h, cudaStream_t stream) {
  constexpr int rows = kWarpBlock / W;
  rk4_warp_kernel<W><<<(B + rows - 1) / rows, kWarpBlock, 0, stream>>>(
      x, w1, b1, w2, b2, out, B, D, H, T, h);
  return static_cast<int>(cudaGetLastError());
}

template <int W>
int launch_gru_warp(const float* h0, const float* e, const float* wi,
                    const float* wh, const float* bi, const float* bh,
                    float* out, int B, int D, int T, cudaStream_t stream) {
  constexpr int rows = kWarpBlock / W;
  gru_warp_kernel<W><<<(B + rows - 1) / rows, kWarpBlock, 0, stream>>>(
      h0, e, wi, wh, bi, bh, out, B, D, T);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// K1, wide variant: fused RK4 motion solve, one block per tile of rows.
// Shared layout (floats): w1 D*H | b1 H | w2 H*D | b2 D |
//                         y R*D | ys R*D | acc R*D | a R*H
// y: the state, ys: the current stage's input, acc: k1 + 2k2 + 2k3 so far,
// a: the hidden activations of the stage being evaluated.
// ---------------------------------------------------------------------------
__global__ void rk4_wide_kernel(const float* __restrict__ x,
                                const float* __restrict__ w1,
                                const float* __restrict__ b1,
                                const float* __restrict__ w2,
                                const float* __restrict__ b2,
                                float* __restrict__ out, int B, int D, int H,
                                int T, int R, float h) {
  extern __shared__ float smem[];
  float* s_w1 = smem;
  float* s_b1 = s_w1 + D * H;
  float* s_w2 = s_b1 + H;
  float* s_b2 = s_w2 + H * D;
  float* s_y = s_b2 + D;
  float* s_ys = s_y + R * D;
  float* s_acc = s_ys + R * D;
  float* s_a = s_acc + R * D;

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * R;
  const size_t plane = static_cast<size_t>(B) * D;

  for (int i = tid; i < D * H; i += blockDim.x) {
    s_w1[i] = w1[i];
    s_w2[i] = w2[i];
  }
  for (int i = tid; i < H; i += blockDim.x) s_b1[i] = b1[i];
  for (int i = tid; i < D; i += blockDim.x) s_b2[i] = b2[i];
  for (int i = tid; i < R * D; i += blockDim.x) {
    const int row = row0 + i / D;
    const float v = row < B ? x[static_cast<size_t>(row) * D + i % D] : 0.f;
    s_y[i] = v;
    s_ys[i] = v;
    if (row < B) out[static_cast<size_t>(row) * D + i % D] = v;
  }
  __syncthreads();

  const float half_h = 0.5f * h;
  const float sixth_h = h / 6.0f;
  for (int t = 1; t < T; ++t) {
    for (int stage = 0; stage < 4; ++stage) {
      // a = tanh(ys @ w1 + b1)
      for (int i = tid; i < R * H; i += blockDim.x) {
        const int r = i / H, j = i % H;
        const float* yr = s_ys + r * D;
        float s = 0.f;
        for (int k = 0; k < D; ++k) s += yr[k] * s_w1[k * H + j];
        s_a[i] = tanhf(s + s_b1[j]);
      }
      __syncthreads();
      // k = a @ w2 + b2, then the stage update of the owned (r, d) element
      for (int i = tid; i < R * D; i += blockDim.x) {
        const int r = i / D, d = i % D;
        const float* ar = s_a + r * H;
        float s = 0.f;
        for (int j = 0; j < H; ++j) s += ar[j] * s_w2[j * D + d];
        const float k = s + s_b2[d];
        const float y = s_y[i];
        if (stage == 0) {
          s_acc[i] = k;
          s_ys[i] = y + half_h * k;
        } else if (stage == 1) {
          s_acc[i] = s_acc[i] + 2.0f * k;
          s_ys[i] = y + half_h * k;
        } else if (stage == 2) {
          s_acc[i] = s_acc[i] + 2.0f * k;
          s_ys[i] = y + h * k;
        } else {
          const float y1 = y + sixth_h * (s_acc[i] + k);
          s_y[i] = y1;
          s_ys[i] = y1;
          const int row = row0 + r;
          if (row < B) out[t * plane + static_cast<size_t>(row) * D + d] = y1;
        }
      }
      __syncthreads();
    }
  }
}

// ---------------------------------------------------------------------------
// K2, wide variant: fused GRU motion recurrence, one block per tile of rows.
// Shared layout (floats): wi D*3D | wh D*3D | bi 3D | bh 3D |
//                         h R*D | e R*D | gi R*3D | gh R*3D
// ---------------------------------------------------------------------------
__global__ void gru_wide_kernel(const float* __restrict__ h0,
                                const float* __restrict__ e,
                                const float* __restrict__ wi,
                                const float* __restrict__ wh,
                                const float* __restrict__ bi,
                                const float* __restrict__ bh,
                                float* __restrict__ out, int B, int D, int T,
                                int R) {
  extern __shared__ float smem[];
  const int G = 3 * D;
  float* s_wi = smem;
  float* s_wh = s_wi + D * G;
  float* s_bi = s_wh + D * G;
  float* s_bh = s_bi + G;
  float* s_h = s_bh + G;
  float* s_e = s_h + R * D;
  float* s_gi = s_e + R * D;
  float* s_gh = s_gi + R * G;

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * R;
  const size_t plane = static_cast<size_t>(B) * D;

  for (int i = tid; i < D * G; i += blockDim.x) {
    s_wi[i] = wi[i];
    s_wh[i] = wh[i];
  }
  for (int i = tid; i < G; i += blockDim.x) {
    s_bi[i] = bi[i];
    s_bh[i] = bh[i];
  }
  for (int i = tid; i < R * D; i += blockDim.x) {
    const int row = row0 + i / D;
    const size_t off = static_cast<size_t>(row) * D + i % D;
    s_h[i] = row < B ? h0[off] : 0.f;
    s_e[i] = row < B ? e[off] : 0.f;
  }
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    // gi = e_t @ wi + bi, gh = h @ wh + bh
    for (int i = tid; i < R * G; i += blockDim.x) {
      const int r = i / G, j = i % G;
      const float* er = s_e + r * D;
      const float* hr = s_h + r * D;
      float si = 0.f, sh = 0.f;
      for (int k = 0; k < D; ++k) {
        si += er[k] * s_wi[k * G + j];
        sh += hr[k] * s_wh[k * G + j];
      }
      s_gi[i] = si + s_bi[j];
      s_gh[i] = sh + s_bh[j];
    }
    __syncthreads();
    // gates of the owned (r, d) element; stage e_{t+1} for the next step
    for (int i = tid; i < R * D; i += blockDim.x) {
      const int r = i / D, d = i % D;
      const float* gir = s_gi + r * G;
      const float* ghr = s_gh + r * G;
      const float rg = sigmoidf(gir[d] + ghr[d]);
      const float zg = sigmoidf(gir[D + d] + ghr[D + d]);
      const float ng = tanhf(gir[2 * D + d] + rg * ghr[2 * D + d]);
      const float h1 = (1.0f - zg) * ng + zg * s_h[i];
      s_h[i] = h1;
      const int row = row0 + r;
      if (row < B) {
        const size_t off = static_cast<size_t>(row) * D + d;
        out[t * plane + off] = h1;
        if (t + 1 < T) s_e[i] = e[(t + 1) * plane + off];
      }
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// K1. x (B,D), w1 (D,H), b1 (H), w2 (H,D), b2 (D) -> out (T,B,D); float32,
// contiguous, on the current device. h is the uniform step ts[1] - ts[0].
// The warp variant takes `lanes` = 16 or 32 >= max(D, H).
int ganode_rk4_motion_warp(const void* x, const void* w1, const void* b1,
                           const void* w2, const void* b2, void* out, int B,
                           int D, int H, int T, float h, int lanes,
                           void* stream) {
  const int widest = D > H ? D : H;
  auto* fx = static_cast<const float*>(x);
  auto* fw1 = static_cast<const float*>(w1);
  auto* fb1 = static_cast<const float*>(b1);
  auto* fw2 = static_cast<const float*>(w2);
  auto* fb2 = static_cast<const float*>(b2);
  auto* fout = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (lanes == 16 && widest <= 16)
    return launch_rk4_warp<16>(fx, fw1, fb1, fw2, fb2, fout, B, D, H, T, h, s);
  if (lanes == 32 && widest <= 32)
    return launch_rk4_warp<32>(fx, fw1, fb1, fw2, fb2, fout, B, D, H, T, h, s);
  return GANODE_ERR_WIDTH;
}

int ganode_rk4_motion_wide(const void* x, const void* w1, const void* b1,
                           const void* w2, const void* b2, void* out, int B,
                           int D, int H, int T, float h, void* stream) {
  const int R = rows_per_block(B, D > H ? D : H);
  const size_t bytes =
      sizeof(float) * (static_cast<size_t>(2) * D * H + D + H +
                       static_cast<size_t>(R) * (3 * D + H));
  int err = prepare_smem(rk4_wide_kernel, bytes);
  if (err != 0) return err;
  const int blocks = (B + R - 1) / R;
  rk4_wide_kernel<<<blocks, kThreads, bytes,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w1),
      static_cast<const float*>(b1), static_cast<const float*>(w2),
      static_cast<const float*>(b2), static_cast<float*>(out), B, D, H, T, R,
      h);
  return static_cast<int>(cudaGetLastError());
}

// K2. h0 (B,D), e (T,B,D), wi (D,3D), wh (D,3D), bi (3D), bh (3D) -> out
// (T,B,D) holding h_1..h_T; float32, contiguous, on the current device. The
// warp variant takes `lanes` = 16 or 32 >= D.
int ganode_gru_motion_warp(const void* h0, const void* e, const void* wi,
                           const void* wh, const void* bi, const void* bh,
                           void* out, int B, int D, int T, int lanes,
                           void* stream) {
  auto* fh0 = static_cast<const float*>(h0);
  auto* fe = static_cast<const float*>(e);
  auto* fwi = static_cast<const float*>(wi);
  auto* fwh = static_cast<const float*>(wh);
  auto* fbi = static_cast<const float*>(bi);
  auto* fbh = static_cast<const float*>(bh);
  auto* fout = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (lanes == 16 && D <= 16)
    return launch_gru_warp<16>(fh0, fe, fwi, fwh, fbi, fbh, fout, B, D, T, s);
  if (lanes == 32 && D <= 32)
    return launch_gru_warp<32>(fh0, fe, fwi, fwh, fbi, fbh, fout, B, D, T, s);
  return GANODE_ERR_WIDTH;
}

int ganode_gru_motion_wide(const void* h0, const void* e, const void* wi,
                           const void* wh, const void* bi, const void* bh,
                           void* out, int B, int D, int T, void* stream) {
  const int R = rows_per_block(B, 3 * D);
  const size_t bytes =
      sizeof(float) * (static_cast<size_t>(6) * D * D + 6 * D +
                       static_cast<size_t>(R) * (2 * D + 6 * D));
  int err = prepare_smem(gru_wide_kernel, bytes);
  if (err != 0) return err;
  const int blocks = (B + R - 1) / R;
  gru_wide_kernel<<<blocks, kThreads, bytes,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(h0), static_cast<const float*>(e),
      static_cast<const float*>(wi), static_cast<const float*>(wh),
      static_cast<const float*>(bi), static_cast<const float*>(bh),
      static_cast<float*>(out), B, D, T, R);
  return static_cast<int>(cudaGetLastError());
}

const char* ganode_error_string(int err) {
  if (err == GANODE_ERR_SMEM)
    return "the shapes need more shared memory than the card allows a block";
  if (err == GANODE_ERR_WIDTH)
    return "the warp variant takes widths up to its lane count (16 or 32)";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
