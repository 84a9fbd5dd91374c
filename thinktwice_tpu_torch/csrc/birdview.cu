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
// A cull per 16 x 16 tile brings the work near the bound, but a block per
// tile that reads and culls the world's whole table reads ~325 MB of L2 a
// launch for 11.7 MB of real traffic.
//
// Design: one block per (world, SUPER x SUPER-pixel super-tile), SUPER =
// 64: 9 super-tiles a world (32-px super-tiles measured level with it). At the
// bench's capacities about half of a world's 1103 rows are
// in use and only a handful of them reach a super-tile, so the block's time
// is its chain of latencies and its per-pixel instructions, not the tests
// of pairs; the design keeps both short:
//   1. The block copies the world's table into dynamic shared memory with
//      cp.async, every row in flight at once (1103 rows x 32 B = 35 KB;
//      only a table over CAP_ROWS rows is walked in chunks of CAP_ROWS),
//      and lists the rows that reach into the super-tile's world-space
//      bounding box (the corner pixels' box plus a margin far above the
//      rounding of the pixel coordinates) with a shared counter: one
//      barrier for the copy, one for the list. The ~16x fewer blocks than
//      one per 16 x 16 tile read the table ~16x less often.
//   2. Each warp then takes PER_WARP 4 x 8-pixel micro-tiles, one pixel a
//      lane, with no block barrier: a lane tests one listed row against the
//      micro-tile's bounds, the warp's ballot keeps the rows that pass, and
//      every lane ORs the coverage of the kept rows into its pixel's mask.
//      The pixels' offsets ahead of and beside the ego are divided out once
//      a row and a column, not once a pixel.
// There is no per-tile capacity, so nothing is dropped (the TPU kernel's
// K_CAP = 512 list silently dropped primitives), and OR does not depend on
// the order, so the bits equal the plain version's.
// Built with -Xptxas -v for sm_90a: 40 registers at 512 threads, no
// spills; 528 bytes of static shared memory and 34 bytes a table row of
// dynamic (37,502 at the bench).

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int ROW = 8;

struct Tile {
  float x0, x1, y0, y1;
};

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

constexpr int SUPER = 64;       // pixels a side of a block's super-tile
constexpr int PER_WARP = 8;     // 4 x 8-pixel micro-tiles a warp
constexpr int NT = SUPER * SUPER / PER_WARP;  // threads a block: 512
constexpr int CAP_ROWS = 4096;  // table rows staged at a time (136 KB)
constexpr unsigned FULL = 0xffffffffu;

// World-space bounds of the pixels between rows a0, a1 and columns b0, b1
// (their offsets ahead of and beside the ego, in metres), from the four
// corners, grown by margin.
__device__ __forceinline__ Tile corner_bounds(float a0, float a1, float b0,
                                              float b1, float ex, float ey,
                                              float cy, float sy, float margin) {
  Tile tile = {3.0e38f, -3.0e38f, 3.0e38f, -3.0e38f};
  const float as[2] = {a0, a1}, bs[2] = {b0, b1};
  for (int i = 0; i < 2; ++i) {
    for (int j = 0; j < 2; ++j) {
      const float x = ex + as[i] * cy + bs[j] * (-sy);
      const float y = ey + as[i] * sy + bs[j] * cy;
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
  return tile;
}

__global__ void __launch_bounds__(NT)
birdview_bits_kernel(const float* __restrict__ prims, int n_prims,
                     const float* __restrict__ ego, int* __restrict__ out,
                     int width, float ev_bottom, float ppm, float margin,
                     int cap) {
  constexpr int NW = NT / 32;
  constexpr int MICRO_H = 4, MICRO_W = 8;            // a warp's 32 pixels
  constexpr int MICRO_COLS = SUPER / MICRO_W;
  extern __shared__ float4 s_rows[];                 // cap rows, 2 float4 each
  unsigned short* s_list = reinterpret_cast<unsigned short*>(s_rows + 2 * cap);
  __shared__ float s_a[SUPER], s_b[SUPER];           // row and column offsets
  __shared__ int s_n;

  const int b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row0 = blockIdx.y * SUPER, col0 = blockIdx.x * SUPER;
  const int last_r = min(SUPER, width - row0) - 1, last_c = min(SUPER, width - col0) - 1;
  const float ex = ego[4 * b + 0], ey = ego[4 * b + 1];
  const float cy = ego[4 * b + 2], sy = ego[4 * b + 3];
  // pixel (r, c) lies at ego + a_r * forward + b_c * left: row 0 is ahead
  // of the ego, which sits ev_bottom px above the bottom; the offsets are
  // taken once a row and a column, in the plain version's operations
  if (tid < SUPER) {
    s_a[tid] = ((float)width - ev_bottom - (float)(row0 + tid)) / ppm;
  } else if (tid < 2 * SUPER) {
    s_b[tid - SUPER] = ((float)(col0 + tid - SUPER) - 0.5f * (float)width) / ppm;
  }

  const float4* table = reinterpret_cast<const float4*>(prims + (size_t)b * n_prims * ROW);
  for (int base = 0; base < n_prims; base += cap) {
    const int n_chunk = min(cap, n_prims - base);
    // 1. the chunk into shared memory; list its rows in the super-tile
    if (base > 0) __syncthreads();  // the last chunk has been drawn
    for (int i = tid; i < 2 * n_chunk; i += NT) {
      __pipeline_memcpy_async(s_rows + i, table + 2 * (size_t)base + i, sizeof(float4));
    }
    __pipeline_commit();
    if (tid == 0) s_n = 0;
    __pipeline_wait_prior(0);
    __syncthreads();
    const Tile super_tile = corner_bounds(s_a[0], s_a[last_r], s_b[0], s_b[last_c],
                                          ex, ey, cy, sy, margin);
    for (int k = tid; k < n_chunk; k += NT) {
      const float* p = reinterpret_cast<const float*>(s_rows + 2 * k);
      if (p[1] >= 0.0f && overlaps(p, super_tile)) {
        s_list[atomicAdd(&s_n, 1)] = (unsigned short)k;
      }
    }
    __syncthreads();
    const int n = s_n;

    // 2. each warp's micro-tiles, culled by ballot
    for (int m = 0; m < PER_WARP; ++m) {
      const int micro = m * NW + warp;
      const int mr = (micro / MICRO_COLS) * MICRO_H, mc = (micro % MICRO_COLS) * MICRO_W;
      if (mr > last_r || mc > last_c) continue;  // the same for the warp
      const Tile tile = corner_bounds(s_a[mr], s_a[min(mr + MICRO_H - 1, last_r)], s_b[mc],
                                      s_b[min(mc + MICRO_W - 1, last_c)], ex, ey, cy,
                                      sy, margin);
      const int r = mr + lane / MICRO_W, c = mc + lane % MICRO_W;
      const float a_px = s_a[r], b_px = s_b[c];
      const float wx = ex + a_px * cy + b_px * (-sy);
      const float wy = ey + a_px * sy + b_px * cy;
      int bits = 0;
      for (int k = 0; k < n; k += 32) {
        const int mine = k + lane < n ? s_list[k + lane] : 0;
        const bool near = k + lane < n &&
            overlaps(reinterpret_cast<const float*>(s_rows + 2 * mine), tile);
        unsigned kept = __ballot_sync(FULL, near);
        while (kept) {
          const int j = __shfl_sync(FULL, mine, __ffs(kept) - 1);
          kept &= kept - 1;
          const float* p = reinterpret_cast<const float*>(s_rows + 2 * j);
          if (covers(p, wx, wy)) bits |= 1 << (int)p[1];
        }
      }
      if (r <= last_r && c <= last_c) {
        int* dst = out + ((size_t)b * width + row0 + r) * width + col0 + c;
        *dst = base > 0 ? (*dst | bits) : bits;  // only a long table has chunks
      }
    }
  }
  if (n_prims == 0) {
    for (int i = tid; i < SUPER * SUPER; i += NT) {
      const int r = i / SUPER, c = i % SUPER;
      if (r <= last_r && c <= last_c) out[((size_t)b * width + row0 + r) * width + col0 + c] = 0;
    }
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
  if (n_worlds == 0 || width == 0) return 0;
  const int cap = n_prims < 1 ? 1 : (n_prims < CAP_ROWS ? n_prims : CAP_ROWS);
  const size_t smem = (size_t)cap * (ROW * sizeof(float) + sizeof(unsigned short));
  if (smem > 48 * 1024) {  // the default limit of dynamic shared memory
    const cudaError_t err = cudaFuncSetAttribute(
        birdview_bits_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int tiles = (width + SUPER - 1) / SUPER;
  const dim3 grid(tiles, tiles, n_worlds);
  birdview_bits_kernel<<<grid, NT, smem, (cudaStream_t)stream>>>(
      prims, n_prims, ego, out, width, ev_bottom, ppm, margin, cap);
  return (int)cudaGetLastError();
}

const char* tt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
