// K3 on Hopper: multi-scale deformable attention over every camera.
//
// Replaces no Pallas kernel. The JAX package computes this op with XLA
// gathers (thinktwice_tpu/ops/deform_attn.py `ms_deform_attn`), and the
// reference ThinkTwice with mmcv's CUDA op `ms_deform_attn`. The port's
// plain version (ops/deform_attn.py) is a chain of gathers, masks and
// products per camera, level and corner: some 3,000 launches a refine layer
// of the student's look module. This kernel does the whole op of one layer,
// every camera, level, head and point, in one launch, and its backward in
// one more.
//
// Inputs (ops/deform_attn.py `deform_attn_cams_cuda` checks them):
//   value   (N, B, S, C) float32 or bfloat16, S = sum_l H_l * W_l rows, in
//           the layout it has (strides sN, sB, sS; channels contiguous): the
//           student's `value_cams` is a transposed view, read where it lies
//   ref     (B, N, Q, 2) float32 reference points in [0, 1] (x, y)
//   off     (B, N, Q, heads, L, P, 2) raw sampling offsets, in value's type
//   wts     (B, N, Q, heads, L, P) softmaxed attention weights, value's type
//   levels  L (H_l, W_l) pairs as host integers, passed by value: no device
//           table, so the caller makes no host-to-device copy
// Output (B, N, Q, C) in value's type; head h keeps channels
// [h * D, (h + 1) * D), D = C / heads.
//
// Arithmetic, as the plain version's: the location is
// ref + offset / (W_l, H_l) in float32, its pixel x = loc_x * W_l - 0.5
// (align_corners False), and the four bilinear taps read zero outside the
// level. Here the corner weights, the taps' sum and the sum over levels and
// points stay float32 and the output is rounded once; the plain version
// rounds every step to value's type (bfloat16 in the model).
//
// What bounds it on an H100: bytes. At the closed loop's shapes (8 worlds,
// 4 cameras, 120 queries a camera, 8 heads of 32 channels, 4 levels, 8
// points) a layer reads 30,720 heads x 32 points x 4 corners of 64 bytes,
// at most 252 MB, mostly out of L2 (a query's points lie near each other),
// against ~0.1 GFLOP; the least time is that over 3.35 TB/s.
//
// Design: one warp per (world, camera, query, head, 32-channel chunk of the
// head); lane c reads channel c of each tap, so a tap is one coalesced
// 64-byte read (bfloat16). Each lane works out every point's location and
// corner weights itself (the offsets and weights it reads are the same
// address across the warp, one transaction): no shuffles in the forward.
// The backward takes one warp per (world, camera, query, head) and loops
// over the head's channel chunks: it adds each tap's share of grad value
// with float32 atomics into a contiguous (N, B, S, C) buffer (their order
// changes the sums' rounding from run to run), and reduces grad weight and
// grad offset over the channels with warp shuffles, one store a point.
// Built with -Xptxas -v for sm_90a (ops/nvcc.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int MAX_LEVELS = 8;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

struct Levels {
  int h[MAX_LEVELS], w[MAX_LEVELS];
  long long start[MAX_LEVELS];  // first row of each level in value
};

struct Dims {
  int B, N, Q, H, D, L, P;  // heads H of D channels; L levels of P points
  long long sN, sB, sS;     // value's strides in elements
  long long S;              // rows of value
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// One point's footprint on its level: the pixel of its lower-left corner,
// the fractions and which of the four corners lie inside.
struct Tap {
  float x0, y0, fx, fy;
  bool in00, in10, in01, in11;
  long long row;  // value row of corner (x0, y0) when it is inside
};

__device__ __forceinline__ Tap make_tap(float rx, float ry, float ox, float oy, int Hl,
                                        int Wl, long long start) {
  const float W = (float)Wl, Hf = (float)Hl;
  const float lx = rx + ox / W;
  const float ly = ry + oy / Hf;
  const float x = lx * W - 0.5f;
  const float y = ly * Hf - 0.5f;
  Tap t;
  t.x0 = floorf(x);
  t.y0 = floorf(y);
  t.fx = x - t.x0;
  t.fy = y - t.y0;
  // the bounds tests stay in float: a far location never becomes an int
  const bool x0in = t.x0 >= 0.0f && t.x0 < W, x1in = t.x0 + 1.0f >= 0.0f && t.x0 + 1.0f < W;
  const bool y0in = t.y0 >= 0.0f && t.y0 < Hf, y1in = t.y0 + 1.0f >= 0.0f && t.y0 + 1.0f < Hf;
  t.in00 = x0in && y0in;
  t.in10 = x1in && y0in;
  t.in01 = x0in && y1in;
  t.in11 = x1in && y1in;
  // rows of the corners: row, row + 1, row + W, row + W + 1 (each used only
  // when inside, so x0 and y0 are within one pixel of the level there)
  const long long xi = (x0in || x1in) ? (long long)t.x0 : 0;
  const long long yi = (y0in || y1in) ? (long long)t.y0 : 0;
  t.row = start + yi * Wl + xi;
  return t;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    k3_forward(const T* __restrict__ value, const float* __restrict__ ref,
               const T* __restrict__ off, const T* __restrict__ wts, T* __restrict__ out,
               Dims d, Levels lv, long long n_warps, int chunks) {
  const long long warp = (long long)blockIdx.x * WARPS + threadIdx.x / 32;
  if (warp >= n_warps) return;
  const int lane = threadIdx.x & 31;
  const int chunk = (int)(warp % chunks);
  long long r = warp / chunks;
  const int h = (int)(r % d.H);
  const long long bnq = r / d.H;  // (b * N + n) * Q + q
  const int n = (int)((bnq / d.Q) % d.N);
  const int b = (int)(bnq / ((long long)d.Q * d.N));
  const int c = chunk * 32 + lane;
  if (c >= d.D) return;
  const int LP = d.L * d.P;
  const long long tap0 = (bnq * d.H + h) * LP;
  const float rx = ref[2 * bnq], ry = ref[2 * bnq + 1];
  const T* v = value + n * d.sN + b * d.sB + (long long)h * d.D + c;
  float acc = 0.0f;
  for (int i = 0; i < LP; ++i) {
    const int l = i / d.P;
    const int Wl = lv.w[l];
    const Tap t = make_tap(rx, ry, to_f(off[2 * (tap0 + i)]), to_f(off[2 * (tap0 + i) + 1]),
                           lv.h[l], Wl, lv.start[l]);
    const float gx = 1.0f - t.fx, gy = 1.0f - t.fy;
    float s = 0.0f;
    if (t.in00) s += gx * gy * to_f(v[t.row * d.sS]);
    if (t.in10) s += t.fx * gy * to_f(v[(t.row + 1) * d.sS]);
    if (t.in01) s += gx * t.fy * to_f(v[(t.row + Wl) * d.sS]);
    if (t.in11) s += t.fx * t.fy * to_f(v[(t.row + Wl + 1) * d.sS]);
    acc += to_f(wts[tap0 + i]) * s;
  }
  out[bnq * ((long long)d.H * d.D) + (long long)h * d.D + c] = from_f<T>(acc);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    k3_backward(const T* __restrict__ value, const float* __restrict__ ref,
                const T* __restrict__ off, const T* __restrict__ wts,
                const T* __restrict__ grad_out, float* __restrict__ grad_value,
                T* __restrict__ grad_off, T* __restrict__ grad_w, Dims d, Levels lv,
                long long n_warps) {
  const long long warp = (long long)blockIdx.x * WARPS + threadIdx.x / 32;
  if (warp >= n_warps) return;  // the whole warp: every lane below takes part in the shuffles
  const int lane = threadIdx.x & 31;
  const int h = (int)(warp % d.H);
  const long long bnq = warp / d.H;
  const int n = (int)((bnq / d.Q) % d.N);
  const int b = (int)(bnq / ((long long)d.Q * d.N));
  const int LP = d.L * d.P;
  const long long tap0 = (bnq * d.H + h) * LP;
  const float rx = ref[2 * bnq], ry = ref[2 * bnq + 1];
  const T* v = value + n * d.sN + b * d.sB + (long long)h * d.D;
  const T* g_out = grad_out + bnq * ((long long)d.H * d.D) + (long long)h * d.D;
  const long long C = (long long)d.H * d.D;
  float* gv = grad_value == nullptr
                  ? nullptr
                  : grad_value + ((long long)n * d.B + b) * d.S * C + (long long)h * d.D;
  for (int i = 0; i < LP; ++i) {
    const int l = i / d.P;
    const int Wl = lv.w[l], Hl = lv.h[l];
    const Tap t = make_tap(rx, ry, to_f(off[2 * (tap0 + i)]), to_f(off[2 * (tap0 + i) + 1]),
                           Hl, Wl, lv.start[l]);
    const float aw = to_f(wts[tap0 + i]);
    const float gx = 1.0f - t.fx, gy = 1.0f - t.fy;
    const float w00 = gx * gy, w10 = t.fx * gy, w01 = gx * t.fy, w11 = t.fx * t.fy;
    float dw = 0.0f, dx = 0.0f, dy = 0.0f;
    for (int c = lane; c < d.D; c += 32) {
      const float g = to_f(g_out[c]);
      const float v00 = t.in00 ? to_f(v[t.row * d.sS + c]) : 0.0f;
      const float v10 = t.in10 ? to_f(v[(t.row + 1) * d.sS + c]) : 0.0f;
      const float v01 = t.in01 ? to_f(v[(t.row + Wl) * d.sS + c]) : 0.0f;
      const float v11 = t.in11 ? to_f(v[(t.row + Wl + 1) * d.sS + c]) : 0.0f;
      dw += g * (w00 * v00 + w10 * v10 + w01 * v01 + w11 * v11);
      dx += g * (gy * (v10 - v00) + t.fy * (v11 - v01));
      dy += g * (gx * (v01 - v00) + t.fx * (v11 - v10));
      if (gv != nullptr) {
        const float ga = g * aw;
        if (t.in00) atomicAdd(gv + t.row * C + c, ga * w00);
        if (t.in10) atomicAdd(gv + (t.row + 1) * C + c, ga * w10);
        if (t.in01) atomicAdd(gv + (t.row + Wl) * C + c, ga * w01);
        if (t.in11) atomicAdd(gv + (t.row + Wl + 1) * C + c, ga * w11);
      }
    }
    dw = warp_sum(dw);
    dx = warp_sum(dx);
    dy = warp_sum(dy);
    if (lane == 0) {
      // x = (ref + off / W) * W - 0.5: d off = d x * W / W, as autograd takes it
      const float W = (float)Wl, Hf = (float)Hl;
      grad_w[tap0 + i] = from_f<T>(dw);
      grad_off[2 * (tap0 + i)] = from_f<T>((aw * dx) * W / W);
      grad_off[2 * (tap0 + i) + 1] = from_f<T>((aw * dy) * Hf / Hf);
    }
  }
}

bool fill_levels(const int* level_hw, int L, Levels* lv, long long* rows) {
  if (L <= 0 || L > MAX_LEVELS) return false;
  long long start = 0;
  for (int l = 0; l < L; ++l) {
    lv->h[l] = level_hw[2 * l];
    lv->w[l] = level_hw[2 * l + 1];
    if (lv->h[l] <= 0 || lv->w[l] <= 0) return false;
    lv->start[l] = start;
    start += (long long)lv->h[l] * lv->w[l];
  }
  *rows = start;
  return true;
}

Dims make_dims(int B, int N, int Q, int H, int D, int L, int P, long long sN, long long sB,
               long long sS, long long S) {
  Dims d;
  d.B = B; d.N = N; d.Q = Q; d.H = H; d.D = D; d.L = L; d.P = P;
  d.sN = sN; d.sB = sB; d.sS = sS; d.S = S;
  return d;
}

long long blocks_for(long long n_warps) { return (n_warps + WARPS - 1) / WARPS; }

}  // namespace

extern "C" {

// dtype 0: float32, 1: bfloat16 (value, off, wts, out and grad_out). ref
// float32; level_hw L (H, W) pairs on the host; every device array but
// value contiguous. Launches on `stream` and returns cudaGetLastError() of
// the launch (cudaErrorInvalidValue for what it does not take).
int tt_deform_attn_fwd(int dtype, const void* value, long long sN, long long sB, long long sS,
                       const float* ref, const void* off, const void* wts, void* out, int B,
                       int N, int Q, int H, int D, int L, int P, const int* level_hw,
                       void* stream) {
  Levels lv;
  long long S;
  if (!fill_levels(level_hw, L, &lv, &S) || D <= 0 || P <= 0) return cudaErrorInvalidValue;
  const long long heads = (long long)B * N * Q * H;
  if (heads == 0) return 0;
  const int chunks = (D + 31) / 32;
  const long long n_warps = heads * chunks;
  if (blocks_for(n_warps) > 0x7fffffffLL) return cudaErrorInvalidValue;
  const Dims d = make_dims(B, N, Q, H, D, L, P, sN, sB, sS, S);
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    k3_forward<float><<<(unsigned)blocks_for(n_warps), THREADS, 0, s>>>((const float*)value, ref, (const float*)off, (const float*)wts, (float*)out, d, lv, n_warps, chunks);
  } else if (dtype == 1) {
    k3_forward<__nv_bfloat16><<<(unsigned)blocks_for(n_warps), THREADS, 0, s>>>((const __nv_bfloat16*)value, ref, (const __nv_bfloat16*)off, (const __nv_bfloat16*)wts, (__nv_bfloat16*)out, d, lv, n_warps, chunks);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// grad_out (B, N, Q, C) in value's type; grad_value (N, B, S, C) float32,
// zeroed by the caller, or null to skip it; grad_off and grad_w shaped as
// off and wts, in value's type.
int tt_deform_attn_bwd(int dtype, const void* value, long long sN, long long sB, long long sS,
                       const float* ref, const void* off, const void* wts, const void* grad_out,
                       float* grad_value, void* grad_off, void* grad_w, int B, int N, int Q,
                       int H, int D, int L, int P, const int* level_hw, void* stream) {
  Levels lv;
  long long S;
  if (!fill_levels(level_hw, L, &lv, &S) || D <= 0 || P <= 0) return cudaErrorInvalidValue;
  const long long n_warps = (long long)B * N * Q * H;
  if (n_warps == 0) return 0;
  if (blocks_for(n_warps) > 0x7fffffffLL) return cudaErrorInvalidValue;
  const Dims d = make_dims(B, N, Q, H, D, L, P, sN, sB, sS, S);
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    k3_backward<float><<<(unsigned)blocks_for(n_warps), THREADS, 0, s>>>((const float*)value, ref, (const float*)off, (const float*)wts, (const float*)grad_out, grad_value, (float*)grad_off, (float*)grad_w, d, lv, n_warps);
  } else if (dtype == 1) {
    k3_backward<__nv_bfloat16><<<(unsigned)blocks_for(n_warps), THREADS, 0, s>>>((const __nv_bfloat16*)value, ref, (const __nv_bfloat16*)off, (const __nv_bfloat16*)wts, (const __nv_bfloat16*)grad_out, grad_value, (__nv_bfloat16*)grad_off, (__nv_bfloat16*)grad_w, d, lv, n_warps);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

const char* tt_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
