// K1 on Hopper: the birdview tile rasterizer.
//
// Replaces the Pallas TPU kernel `_kernel` of
// thinktwice_tpu/ops/birdview_pallas.py (driven by `render_birdview_bits`).
// For every world and every output pixel it ORs `1 << bit` of each
// primitive (a thick segment or an oriented box) that covers the pixel into
// an int32 mask; ops/birdview_cuda.py builds the primitive table and
// decodes the mask into the 15-channel stack.
//
// Row of the primitive table (8 floats, built in the wrapper):
//   [kind, bit, q0..q5]    bit < 0 marks an unused row
//   kind 0, thick segment: q = x1, y1, x2 - x1, y2 - y1,
//                              max(|x2 - x1|^2, 1e-9), half_width
//   kind 1, oriented box:  q = cx, cy, cos(yaw), sin(yaw), ext_x, ext_y
// Ego row (4 floats): x, y, cos(yaw), sin(yaw). The cosines and sines are
// taken once in the wrapper, so the kernel and its plain PyTorch version do
// the same float operations in the same order; built with --fmad=false,
// nothing is contracted into an FMA and the two agree bit for bit.
//
// What bounds it on an H100: the output alone is 192*192*4 B = 147 KB a
// world (9.4 MB for 64 worlds, ~3 us at 3.35 TB/s). The work is pixels
// times the primitives near each pixel, about 15 float operations per
// pair. Testing every pixel against every primitive (~1.1k rows a world at
// the bench's capacities) would be ~85 GFLOP for 64 worlds, far above both.
//
// Design: one block of 256 threads per (world, 16x16-pixel tile), one
// thread per pixel. The block culls the world's whole primitive table
// against its tile's world-space bounding box, a chunk of 256 rows at a
// time: each thread tests one row, survivors are compacted into shared
// memory (an atomic counter; OR does not depend on order), and after a
// barrier every thread ORs the coverage of the compacted chunk into its
// register mask. There is no per-tile capacity, so nothing is dropped
// (the TPU kernel's K_CAP = 512 list silently dropped primitives).
// Shared-memory bins and warp-level culls are left for later work.

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 16;
constexpr int THREADS = TILE * TILE;
constexpr int ROW = 8;

struct Tile {
  float x0, x1, y0, y1;
};

__device__ __forceinline__ void pixel_world(int r, int c, int width,
                                            float ev_bottom, float ppm,
                                            float ex, float ey, float cy,
                                            float sy, float* wx, float* wy) {
  // row 0 is ahead of the ego; the ego sits ev_bottom px above the bottom
  const float a = ((float)width - ev_bottom - (float)r) / ppm;
  const float b = ((float)c - 0.5f * (float)width) / ppm;
  *wx = ex + a * cy + b * (-sy);
  *wy = ey + a * sy + b * cy;
}

__device__ __forceinline__ bool overlaps(const float* p, const Tile& t) {
  float x0, x1, y0, y1;
  if (p[0] < 0.5f) {  // segment: endpoints' box grown by the half width
    const float xa = p[2], ya = p[3], xb = p[2] + p[4], yb = p[3] + p[5];
    const float h = p[7];
    x0 = fminf(xa, xb) - h;
    x1 = fmaxf(xa, xb) + h;
    y0 = fminf(ya, yb) - h;
    y1 = fmaxf(ya, yb) + h;
  } else {            // box: the rotated box's axis-aligned bounds
    const float c = fabsf(p[4]), s = fabsf(p[5]);
    const float hx = c * p[6] + s * p[7];
    const float hy = s * p[6] + c * p[7];
    x0 = p[2] - hx;
    x1 = p[2] + hx;
    y0 = p[3] - hy;
    y1 = p[3] + hy;
  }
  return x1 >= t.x0 && x0 <= t.x1 && y1 >= t.y0 && y0 <= t.y1;
}

__device__ __forceinline__ bool covers(const float* p, float wx, float wy) {
  if (p[0] < 0.5f) {
    const float x1 = p[2], y1 = p[3], abx = p[4], aby = p[5];
    float t = ((wx - x1) * abx + (wy - y1) * aby) / p[6];
    t = fminf(fmaxf(t, 0.0f), 1.0f);
    const float dx = wx - (x1 + t * abx);
    const float dy = wy - (y1 + t * aby);
    return dx * dx + dy * dy <= p[7] * p[7];
  }
  const float rx = wx - p[2], ry = wy - p[3];
  const float lx = rx * p[4] + ry * p[5];
  const float ly = -rx * p[5] + ry * p[4];
  return fabsf(lx) <= p[6] && fabsf(ly) <= p[7];
}

__global__ void __launch_bounds__(THREADS)
birdview_bits_kernel(const float* __restrict__ prims, int n_prims,
                     const float* __restrict__ ego, int* __restrict__ out,
                     int width, float ev_bottom, float ppm, float margin) {
  __shared__ __align__(16) float s_prim[THREADS][ROW];
  __shared__ int s_n;

  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int row0 = blockIdx.y * TILE, col0 = blockIdx.x * TILE;
  const int row = row0 + tid / TILE, col = col0 + tid % TILE;
  const float ex = ego[4 * b + 0], ey = ego[4 * b + 1];
  const float cy = ego[4 * b + 2], sy = ego[4 * b + 3];

  // world-space bounds of the tile from its corner pixels, plus a margin
  // far above the rounding of the pixel coordinates
  const int r1 = min(row0 + TILE - 1, width - 1);
  const int c1 = min(col0 + TILE - 1, width - 1);
  Tile tile = {3.0e38f, -3.0e38f, 3.0e38f, -3.0e38f};
  const int rs[2] = {row0, r1}, cs[2] = {col0, c1};
  for (int i = 0; i < 2; ++i) {
    for (int j = 0; j < 2; ++j) {
      float x, y;
      pixel_world(rs[i], cs[j], width, ev_bottom, ppm, ex, ey, cy, sy, &x, &y);
      tile.x0 = fminf(tile.x0, x);
      tile.x1 = fmaxf(tile.x1, x);
      tile.y0 = fminf(tile.y0, y);
      tile.y1 = fmaxf(tile.y1, y);
    }
  }
  tile.x0 -= margin;
  tile.x1 += margin;
  tile.y0 -= margin;
  tile.y1 += margin;

  float wx, wy;
  pixel_world(row, col, width, ev_bottom, ppm, ex, ey, cy, sy, &wx, &wy);

  const float* table = prims + (size_t)b * n_prims * ROW;
  int bits = 0;
  for (int base = 0; base < n_prims; base += THREADS) {
    if (tid == 0) s_n = 0;
    __syncthreads();
    const int k = base + tid;
    if (k < n_prims) {
      const float4* src = reinterpret_cast<const float4*>(table + (size_t)k * ROW);
      const float4 lo = src[0], hi = src[1];
      const float p[ROW] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
      if (p[1] >= 0.0f && overlaps(p, tile)) {
        const int slot = atomicAdd(&s_n, 1);
        float4* dst = reinterpret_cast<float4*>(s_prim[slot]);
        dst[0] = lo;
        dst[1] = hi;
      }
    }
    __syncthreads();
    const int n = s_n;
    for (int j = 0; j < n; ++j) {
      const float* p = s_prim[j];
      if (covers(p, wx, wy)) bits |= 1 << (int)p[1];
    }
    __syncthreads();
  }
  if (row < width && col < width) {
    out[((size_t)b * width + row) * width + col] = bits;
  }
}

}  // namespace

extern "C" {

// prims (B, n_prims, 8) f32, ego (B, 4) f32, out (B, width, width) i32, all
// contiguous on the device. Launches on `stream` and returns
// cudaGetLastError() of the launch.
int tt_birdview_bits(const float* prims, int n_worlds, int n_prims,
                     const float* ego, int* out, int width, float ev_bottom,
                     float ppm, float margin, void* stream) {
  const int tiles = (width + TILE - 1) / TILE;
  dim3 grid(tiles, tiles, n_worlds);
  birdview_bits_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      prims, n_prims, ego, out, width, ev_bottom, ppm, margin);
  return (int)cudaGetLastError();
}

const char* tt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
