// K4 on Hopper: the look module's point sampler over every camera and FPN
// level.
//
// Replaces no Pallas kernel. The JAX package samples each camera's FPN maps
// at the look points with XLA gathers (thinktwice_tpu/ops/grid_sample.py
// `grid_sample_norm`, once a camera and level). The port's plain version
// (ops/grid_sample.py) is that chain of gathers and masks per camera, level
// and corner. This kernel samples every camera's levels at once: one launch
// a refine layer, and one for its backward.
//
// Inputs (ops/grid_sample.py `sample_levels_cuda` checks them):
//   maps    L levels (B, N, H_l, W_l, C) float32 or bfloat16, each in the
//           layout it has (strides of B, N, y and x; channels contiguous)
//   coords  (B, N, Q, 2) float32 points in [0, 1] of the image (x, y)
// Output (B, N, Q, L * C) float32, level l in channels [l * C, (l + 1) * C).
//
// Arithmetic, the plain version's operation for operation (built with
// --fmad=false, so the two agree bit for bit): the point goes to [-1, 1] as
// c = u * 2 - 1, then to the pixel x = ((c + 1) * 0.5) * W_l - 0.5
// (align_corners False); the corner weights are (1 - fx) * (1 - fy),
// fx * (1 - fy), (1 - fx) * fy and fx * fy; a tap outside the map reads
// zero; the taps in the map's type, their weighted sum float32 in the order
// ((t00 + t10) + t01) + t11.
//
// What bounds it on an H100: bytes. At the closed loop's shapes (8 worlds,
// 4 cameras, 120 points a camera, 4 levels of 256 channels) a layer reads
// 15,360 (point, level) pairs x 4 corners of 512 bytes (bfloat16), 31 MB,
// and writes 15.7 MB of float32; ~0.1 GFLOP.
//
// Design: one warp per (world, camera, point, level); every lane works out
// the point's corners and weights (the same two floats across the warp, one
// transaction), and lane k takes channels k, k + 32, ...: a corner is read
// in coalesced 64-byte runs from channels-last maps (the student's fusion
// makes its levels channels-last once a forward), and the output written in
// 128-byte runs. The backward adds each corner's share of the gradient with
// float32 atomics into contiguous (B, N, H_l, W_l, C) buffers. The points
// carry no gradient (the look module's come from detached waypoints).
// Built with -Xptxas -v for sm_90a (ops/nvcc.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int MAX_LEVELS = 8;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

struct Maps {
  const void* ptr[MAX_LEVELS];
  long long sb[MAX_LEVELS], sn[MAX_LEVELS], sy[MAX_LEVELS], sx[MAX_LEVELS];
  int h[MAX_LEVELS], w[MAX_LEVELS];
};

struct GradMaps {
  float* ptr[MAX_LEVELS];
  int h[MAX_LEVELS], w[MAX_LEVELS];
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

struct Corners {
  float w00, w10, w01, w11;
  bool in00, in10, in01, in11;
  long long x0, y0;  // the lower-left corner, valid where a corner is inside
};

__device__ __forceinline__ Corners corners(float u, float v, int Hl, int Wl) {
  const float W = (float)Wl, Hf = (float)Hl;
  const float cx = u * 2.0f - 1.0f, cy = v * 2.0f - 1.0f;
  const float x = (cx + 1.0f) * 0.5f * W - 0.5f;
  const float y = (cy + 1.0f) * 0.5f * Hf - 0.5f;
  const float x0 = floorf(x), y0 = floorf(y);
  const float fx = x - x0, fy = y - y0;
  Corners k;
  k.w00 = (1.0f - fx) * (1.0f - fy);
  k.w10 = fx * (1.0f - fy);
  k.w01 = (1.0f - fx) * fy;
  k.w11 = fx * fy;
  // the bounds tests stay in float: a far point never becomes an int
  const bool x0in = x0 >= 0.0f && x0 < W, x1in = x0 + 1.0f >= 0.0f && x0 + 1.0f < W;
  const bool y0in = y0 >= 0.0f && y0 < Hf, y1in = y0 + 1.0f >= 0.0f && y0 + 1.0f < Hf;
  k.in00 = x0in && y0in;
  k.in10 = x1in && y0in;
  k.in01 = x0in && y1in;
  k.in11 = x1in && y1in;
  k.x0 = (x0in || x1in) ? (long long)x0 : 0;
  k.y0 = (y0in || y1in) ? (long long)y0 : 0;
  return k;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    k4_forward(Maps m, const float* __restrict__ coords, float* __restrict__ out, int N,
               int Q, int L, int C, long long n_warps) {
  const long long warp = (long long)blockIdx.x * WARPS + threadIdx.x / 32;
  if (warp >= n_warps) return;
  const int lane = threadIdx.x & 31;
  const int l = (int)(warp % L);
  const long long bnq = warp / L;  // (b * N + n) * Q + q
  const long long bn = bnq / Q;
  const int n = (int)(bn % N);
  const long long b = bn / N;
  const Corners k = corners(coords[2 * bnq], coords[2 * bnq + 1], m.h[l], m.w[l]);
  const T* base = (const T*)m.ptr[l] + b * m.sb[l] + n * m.sn[l];
  const T* p00 = base + k.y0 * m.sy[l] + k.x0 * m.sx[l];
  const T* p10 = p00 + m.sx[l];
  const T* p01 = p00 + m.sy[l];
  const T* p11 = p01 + m.sx[l];
  float* o = out + warp * C;  // (bnq * L + l) * C
  for (int c = lane; c < C; c += 32) {
    const float t00 = k.in00 ? to_f(p00[c]) : 0.0f;
    const float t10 = k.in10 ? to_f(p10[c]) : 0.0f;
    const float t01 = k.in01 ? to_f(p01[c]) : 0.0f;
    const float t11 = k.in11 ? to_f(p11[c]) : 0.0f;
    o[c] = t00 * k.w00 + t10 * k.w10 + t01 * k.w01 + t11 * k.w11;
  }
}

__global__ void __launch_bounds__(THREADS)
    k4_backward(GradMaps g, const float* __restrict__ coords,
                const float* __restrict__ grad_out, int N, int Q, int L, int C,
                long long n_warps) {
  const long long warp = (long long)blockIdx.x * WARPS + threadIdx.x / 32;
  if (warp >= n_warps) return;
  const int lane = threadIdx.x & 31;
  const int l = (int)(warp % L);
  const long long bnq = warp / L;
  const long long bn = bnq / Q;
  const int Hl = g.h[l], Wl = g.w[l];
  const Corners k = corners(coords[2 * bnq], coords[2 * bnq + 1], Hl, Wl);
  float* p00 = g.ptr[l] + ((bn * Hl + k.y0) * Wl + k.x0) * C;
  float* p10 = p00 + C;
  float* p01 = p00 + (long long)Wl * C;
  float* p11 = p01 + C;
  const float* go = grad_out + warp * C;
  for (int c = lane; c < C; c += 32) {
    const float gc = go[c];
    if (k.in00) atomicAdd(p00 + c, gc * k.w00);
    if (k.in10) atomicAdd(p10 + c, gc * k.w10);
    if (k.in01) atomicAdd(p01 + c, gc * k.w01);
    if (k.in11) atomicAdd(p11 + c, gc * k.w11);
  }
}

long long blocks_for(long long n_warps) { return (n_warps + WARPS - 1) / WARPS; }

}  // namespace

extern "C" {

// dtype 0: float32, 1: bfloat16 (the maps). maps: L device pointers on the
// host; strides: L x (b, n, y, x) element strides on the host; level_hw:
// L (H, W) pairs on the host; coords (B, N, Q, 2) float32 and out
// (B, N, Q, L * C) float32, contiguous. Launches on `stream` and returns
// cudaGetLastError() of the launch (cudaErrorInvalidValue for what it does
// not take).
int tt_look_sample_fwd(int dtype, const void* const* maps, const long long* strides,
                       const int* level_hw, int L, const float* coords, float* out, int B,
                       int N, int Q, int C, void* stream) {
  if (L <= 0 || L > MAX_LEVELS || C <= 0) return cudaErrorInvalidValue;
  Maps m;
  for (int l = 0; l < L; ++l) {
    m.ptr[l] = maps[l];
    m.sb[l] = strides[4 * l];
    m.sn[l] = strides[4 * l + 1];
    m.sy[l] = strides[4 * l + 2];
    m.sx[l] = strides[4 * l + 3];
    m.h[l] = level_hw[2 * l];
    m.w[l] = level_hw[2 * l + 1];
    if (m.h[l] <= 0 || m.w[l] <= 0) return cudaErrorInvalidValue;
  }
  const long long n_warps = (long long)B * N * Q * L;
  if (n_warps == 0) return 0;
  if (blocks_for(n_warps) > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    k4_forward<float><<<(unsigned)blocks_for(n_warps), THREADS, 0, s>>>(m, coords, out, N, Q, L, C, n_warps);
  } else if (dtype == 1) {
    k4_forward<__nv_bfloat16><<<(unsigned)blocks_for(n_warps), THREADS, 0, s>>>(m, coords, out, N, Q, L, C, n_warps);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// grad_maps: L device pointers on the host, each a contiguous float32
// (B, N, H_l, W_l, C) buffer zeroed by the caller; grad_out (B, N, Q, L * C)
// float32, contiguous.
int tt_look_sample_bwd(float* const* grad_maps, const int* level_hw, int L,
                       const float* coords, const float* grad_out, int B, int N, int Q, int C,
                       void* stream) {
  if (L <= 0 || L > MAX_LEVELS || C <= 0) return cudaErrorInvalidValue;
  GradMaps g;
  for (int l = 0; l < L; ++l) {
    g.ptr[l] = grad_maps[l];
    g.h[l] = level_hw[2 * l];
    g.w[l] = level_hw[2 * l + 1];
    if (g.h[l] <= 0 || g.w[l] <= 0) return cudaErrorInvalidValue;
  }
  const long long n_warps = (long long)B * N * Q * L;
  if (n_warps == 0) return 0;
  if (blocks_for(n_warps) > 0x7fffffffLL) return cudaErrorInvalidValue;
  k4_backward<<<(unsigned)blocks_for(n_warps), THREADS, 0, (cudaStream_t)stream>>>(g, coords, grad_out, N, Q, L, C, n_warps);
  return cudaGetLastError();
}

const char* tt_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
