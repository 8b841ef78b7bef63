// Motion-latent kernels for Hopper (sm_90a): the port of the JAX package's two
// Pallas TPU kernels. Plain C interface, built by ganode_tpu_torch/ops/_build.py
// with nvcc into a shared library and bound with ctypes; no PyTorch headers.
//
// K1 ganode_rk4_motion replaces ganode_tpu/ops/fused_rk4.py `_rk4_kernel`
//    (pl.pallas_call in `_fused_forward`): the whole RK4 trajectory of
//    f(y) = tanh(y @ w1 + b1) @ w2 + b2 over a uniform grid, 4 (T-1) right-hand
//    side evaluations in one launch, out[0] = x.
// K2 ganode_gru_motion replaces ganode_tpu/ops/fused_gru.py `_gru_kernel`:
//    T steps of the torch-semantics GRU, gates in [r | z | n] blocks, both the
//    input and the hidden projection computed inside the kernel.
//
// What bounds them on this card. At the serving shape (B=64, D=H=16, T=16) K1
// does ~4 MFLOP and moves ~70 KB, K2 ~3 MFLOP and ~135 KB: the roofline bound
// is tens of nanoseconds either way. What sets the time is the serial chain of
// dependent steps (60 RHS evaluations for K1, 16 recurrences for K2), each a
// pair of tiny matrix-vector products, plus the launch itself.
//
// What the design does about it. One block owns a tile of batch rows for the
// whole solve: weights, biases, state and stage vectors sit in shared memory
// from the first step to the last, device memory sees one read of the inputs
// and one write of the trajectory, and each step costs two block barriers.
// Tiles are small (one thread per output element of a phase) so the chain runs
// with the least work per link, and ragged B, D and H are masked, not padded.
// The TPU's 128-lane padding and 8-row rounding are not carried over.
//
// Arithmetic is float32 with tanhf/expf (no fast-math). Sums run in the same
// order as the plain PyTorch versions; results agree to ~1e-6.
//
// Every launcher returns 0, GANODE_ERR_SMEM when the shapes need more shared
// memory than the card allows a block (nothing is launched), or the
// cudaError_t of the launch.

#include <cuda_runtime.h>

#define GANODE_ERR_SMEM (-1)

namespace {

constexpr int kThreads = 128;

// Shared memory a block may have on the current device (opt-in maximum).
int smem_limit() {
  int dev = 0, limit = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return 0;
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

// ---------------------------------------------------------------------------
// K1: fused RK4 motion solve.
// Shared layout (floats): w1 D*H | b1 H | w2 H*D | b2 D |
//                         y R*D | ys R*D | acc R*D | a R*H
// y: the state, ys: the current stage's input, acc: k1 + 2k2 + 2k3 so far,
// a: the hidden activations of the stage being evaluated.
// ---------------------------------------------------------------------------
__global__ void rk4_motion_kernel(const float* __restrict__ x,
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
// K2: fused GRU motion recurrence.
// Shared layout (floats): wi D*3D | wh D*3D | bi 3D | bh 3D |
//                         h R*D | e R*D | gi R*3D | gh R*3D
// ---------------------------------------------------------------------------
__device__ __forceinline__ float sigmoidf(float v) {
  return 1.0f / (1.0f + expf(-v));
}

__global__ void gru_motion_kernel(const float* __restrict__ h0,
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

// x (B,D), w1 (D,H), b1 (H), w2 (H,D), b2 (D) -> out (T,B,D); float32,
// contiguous, on the current device. h is the uniform step ts[1] - ts[0].
int ganode_rk4_motion(const void* x, const void* w1, const void* b1,
                      const void* w2, const void* b2, void* out, int B, int D,
                      int H, int T, float h, void* stream) {
  const int R = rows_per_block(B, D > H ? D : H);
  const size_t bytes =
      sizeof(float) * (static_cast<size_t>(2) * D * H + D + H +
                       static_cast<size_t>(R) * (3 * D + H));
  int err = prepare_smem(rk4_motion_kernel, bytes);
  if (err != 0) return err;
  const int blocks = (B + R - 1) / R;
  rk4_motion_kernel<<<blocks, kThreads, bytes,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w1),
      static_cast<const float*>(b1), static_cast<const float*>(w2),
      static_cast<const float*>(b2), static_cast<float*>(out), B, D, H, T, R,
      h);
  return static_cast<int>(cudaGetLastError());
}

// h0 (B,D), e (T,B,D), wi (D,3D), wh (D,3D), bi (3D), bh (3D) -> out (T,B,D)
// holding h_1..h_T; float32, contiguous, on the current device.
int ganode_gru_motion(const void* h0, const void* e, const void* wi,
                      const void* wh, const void* bi, const void* bh,
                      void* out, int B, int D, int T, void* stream) {
  const int R = rows_per_block(B, 3 * D);
  const size_t bytes =
      sizeof(float) * (static_cast<size_t>(6) * D * D + 6 * D +
                       static_cast<size_t>(R) * (2 * D + 6 * D));
  int err = prepare_smem(gru_motion_kernel, bytes);
  if (err != 0) return err;
  const int blocks = (B + R - 1) / R;
  gru_motion_kernel<<<blocks, kThreads, bytes,
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
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
