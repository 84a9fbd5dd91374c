// K2 on Hopper: the ray-vs-box intersector.
//
// Replaces the Pallas TPU kernel `_kernel` of
// thinktwice_tpu/ops/raycast_pallas.py (driven by `ray_boxes_pallas`).
// For every ray of every world it runs the slab test against each upright
// oriented box of that world's table and keeps the nearest hit: t, the
// distance along the ray, and the box's index, or MAX_T and -1 on a miss.
// Every camera pixel and lidar beam of the student's sensors goes through
// it (sensors/raycast.py `cast_scene`).
//
// Box row (9 floats, built in ops/raycast_cuda.py):
//   [x, y, cos(yaw), sin(yaw), ext_x, ext_y, z_top, active, z_base]
// The cosines and sines are taken once in the wrapper, so the kernel and
// its plain PyTorch version do the same float operations in the same
// order; built with --fmad=false, nothing is contracted into an FMA and the
// two agree bit for bit. Directions are guarded (|d| < 1e-9 -> 1e-9) on the
// box-frame x and y and on z. A box is hit when t_near <= t_far, t_far > 0
// and active > 0.5; t = max(t_near, 0). The lowest index wins a tie (the
// running minimum only moves on a strict <).
//
// What bounds it on an H100: testing every ray against every box is ~45
// float operations a pair, six of them IEEE divisions; at the student's
// camera shape (8 worlds x 524,288 rays x 264 boxes) that is ~1.1 G pairs,
// ~50 GFLOP, against ~0.15 GB of rays and results. But a ray's path passes
// near few of the boxes: the work these inputs need is the pairs that a
// cull keeps, a few percent of all pairs.
//
// Design: a block of 256 threads takes a tile of rays that look the same
// way. With a grid (the rays are views x rows x cols in row-major order, as
// a camera's pixels or a lidar's beams are), a block takes a K2_TILE_H x
// K2_TILE_W tile of one view, RPT = 2 rays a thread; without one, 256
// consecutive rays, RPT = 1 (the template argument GRID picks). The block
//   1. reduces its rays to a cone: a ball that holds every origin (the
//      centre and half-diagonal of their bounding box) and an axis and
//      half-angle that hold every unit direction;
//   2. tests each box's bounding sphere against that cone, one row of its
//      world's table a thread (the same active > 0.5 test as the slab test
//      drops inactive rows), and compacts the survivors with their rows
//      into shared memory in ascending index order (warp ballots,
//      popcounts and per-warp offsets), up to CHUNK rows at a time;
//   3. runs the slab test above, unchanged, on the survivors only.
// The cull is conservative: the sphere is grown by K2_CULL_ABS metres plus
// K2_CULL_REL of its distance and the cone widened by K2_CULL_COS, far above
// the rounding of either test, and a block whose cone is wider than
// acos(K2_CULL_MIN_COS) or that holds a ray shorter than K2_CULL_MIN_DIR (where
// the 1e-9 direction guards could bend the slab test's ray) keeps every
// active box. A culled box would have been a miss, and the survivors are
// tested in ascending order with the same strict <, so t and idx are those
// of the all-pairs slab test bit for bit.
// At the student's shapes the cull keeps ~0.2% of the pairs, so the slab
// tests no longer bound the kernel: each block's fixed work does (loading
// its rays and its world's table, two block reductions, the cull). Tiles of
// 16 x 32 rays halve the blocks of 16 x 16 tiles at the cost of a slightly
// wider cone, and measured ~9% faster at the student's shapes (32 x 32
// tiles, 4 rays a thread, measured slower: their registers cut the blocks
// in flight).
//
// The constants that ops/raycast_cuda.py shares with this source (the
// slab test's MAX_T and EPS, the block's threads and tile, the cull's
// slack) are defined there and passed as -D K2_* macros by ops/nvcc.py, so
// the kernel and the plain cull `k2_tile_cull_plain` read the same values.
// Built with -Xptxas -v for sm_90a: 54 registers without a grid and 71
// with one, 20,832 bytes of shared memory, no spills.

#include <cuda_runtime.h>

namespace {

#if !defined(K2_MAX_T) || !defined(K2_EPS) || !defined(K2_THREADS) ||     \
    !defined(K2_TILE_H) || !defined(K2_TILE_W) || !defined(K2_CULL_ABS) || \
    !defined(K2_CULL_REL) || !defined(K2_CULL_COS) ||                      \
    !defined(K2_CULL_MIN_COS) || !defined(K2_CULL_MIN_DIR)
#error "build with the K2_* macros of ops/raycast_cuda.py (ops/nvcc.py passes them)"
#endif

constexpr int THREADS = K2_THREADS;
constexpr int WARPS = THREADS / 32;
constexpr int TILE_H = K2_TILE_H, TILE_W = K2_TILE_W;
constexpr int RPT_GRID = TILE_H * TILE_W / THREADS;  // rays a thread with a grid
static_assert(RPT_GRID * THREADS == TILE_H * TILE_W, "a tile holds whole rays a thread");
constexpr int ROW = 9;
constexpr int CHUNK = 512;              // table rows culled and staged at a time
constexpr float MAX_T = K2_MAX_T;
constexpr float EPS = K2_EPS;
constexpr float BIG = 3.0e38f;         // above any coordinate: the identity of a min
constexpr unsigned FULL = 0xffffffffu;

// the cull's slack (see the note above and k2_tile_cull_plain)
constexpr float CULL_ABS = K2_CULL_ABS;          // metres added to every sphere's radius
constexpr float CULL_REL = K2_CULL_REL;          // of the distance to the sphere's centre
constexpr float CULL_COS = K2_CULL_COS;          // taken off the cone's cos half-angle
constexpr float CULL_MIN_COS = K2_CULL_MIN_COS;  // a wider cone keeps every active box
constexpr float CULL_MIN_DIR = K2_CULL_MIN_DIR;  // so does a block with a shorter ray

__device__ __forceinline__ float guard(float d) {
  return fabsf(d) < EPS ? EPS : d;
}

__device__ __forceinline__ float warp_min(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// The position of this thread's kept item among the block's kept items,
// in thread order; *total is the block's count. Every thread must call it.
__device__ __forceinline__ int block_compact(bool keep, int* s_warp, int* total) {
  const unsigned ballot = __ballot_sync(FULL, keep);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();  // readers of the last call's counts are done
  if (lane == 0) s_warp[warp] = __popc(ballot);
  __syncthreads();
  int before = 0, sum = 0;
  for (int w = 0; w < WARPS; ++w) {
    const int c = s_warp[w];
    before += w < warp ? c : 0;
    sum += c;
  }
  *total = sum;
  return before + __popc(ballot & ((1u << lane) - 1u));
}

struct Cone {
  float cx, cy, cz, r;    // a ball that holds every origin of the block
  float ax, ay, az;       // unit axis
  float cos_t, sin_t;     // half-angle, widened by CULL_COS
  bool all;               // no cull: keep every active box
};

template <int RPT>
__device__ Cone block_cone(const bool* live, const float (*o)[3],
                           const float (*d)[3]) {
  __shared__ float s_red[WARPS][9];
  __shared__ float s_cos[WARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  float v[9] = {BIG, BIG, BIG, BIG, BIG, BIG, 0.0f, 0.0f, 0.0f};
  float u[RPT][3];
  bool use[RPT];
  bool bad = false;
#pragma unroll
  for (int q = 0; q < RPT; ++q) {
    const float dn = sqrtf(d[q][0] * d[q][0] + d[q][1] * d[q][1] + d[q][2] * d[q][2]);
    const bool short_ray = live[q] && !(dn >= CULL_MIN_DIR);
    bad = bad || short_ray;
    use[q] = live[q] && !short_ray;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      u[q][i] = use[q] ? d[q][i] / dn : 0.0f;
      v[i] = fminf(v[i], live[q] ? o[q][i] : BIG);
      v[3 + i] = fminf(v[3 + i], live[q] ? -o[q][i] : BIG);
      v[6 + i] += u[q][i];
    }
  }
#pragma unroll
  for (int k = 0; k < 6; ++k) v[k] = warp_min(v[k]);
#pragma unroll
  for (int k = 6; k < 9; ++k) v[k] = warp_sum(v[k]);
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < 9; ++k) s_red[warp][k] = v[k];
  }
  const bool any_bad = __syncthreads_or(bad);
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    float acc = s_red[0][k];
    for (int w = 1; w < WARPS; ++w) {
      acc = k < 6 ? fminf(acc, s_red[w][k]) : acc + s_red[w][k];
    }
    v[k] = acc;
  }
  Cone c;
  const float hx = -v[3], hy = -v[4], hz = -v[5];
  c.cx = 0.5f * (v[0] + hx);
  c.cy = 0.5f * (v[1] + hy);
  c.cz = 0.5f * (v[2] + hz);
  const float ex = hx - v[0], ey = hy - v[1], ez = hz - v[2];
  c.r = 0.5f * sqrtf(ex * ex + ey * ey + ez * ez);
  const float sn = sqrtf(v[6] * v[6] + v[7] * v[7] + v[8] * v[8]);
  c.ax = v[6] / sn;
  c.ay = v[7] / sn;
  c.az = v[8] / sn;

  float cos_i = BIG;
#pragma unroll
  for (int q = 0; q < RPT; ++q) {
    if (use[q]) cos_i = fminf(cos_i, u[q][0] * c.ax + u[q][1] * c.ay + u[q][2] * c.az);
  }
  cos_i = warp_min(cos_i);
  if (lane == 0) s_cos[warp] = cos_i;
  __syncthreads();
  float cos_min = s_cos[0];
  for (int w = 1; w < WARPS; ++w) cos_min = fminf(cos_min, s_cos[w]);
  c.cos_t = cos_min - CULL_COS;
  c.sin_t = sqrtf(fmaxf(0.0f, 1.0f - c.cos_t * c.cos_t));
  // NaN fails every comparison here and so turns the cull off
  c.all = any_bad || !(sn > 0.0f) || !(c.cos_t > CULL_MIN_COS) || !(c.r <= BIG);
  return c;
}

// Whether a ray of the cone can meet the box of row p: the box's bounding
// sphere, grown by the origins' ball and the slack, meets the cone.
__device__ __forceinline__ bool keep_box(const float* p, const Cone& k) {
  if (!(p[7] > 0.5f)) return false;
  if (k.all) return true;
  const float hz = 0.5f * fabsf(p[6] - p[8]);
  // the box frame's scale is 1 / |(cos, sin)|: the sphere follows it
  const float rad = sqrtf((p[4] * p[4] + p[5] * p[5]) / (p[2] * p[2] + p[3] * p[3])
                          + hz * hz);
  const float vx = p[0] - k.cx, vy = p[1] - k.cy;
  const float vz = 0.5f * (p[6] + p[8]) - k.cz;
  const float v2 = vx * vx + vy * vy + vz * vz;
  const float v = sqrtf(v2);
  const float R = rad + k.r + CULL_ABS + CULL_REL * v;
  if (v <= R) return true;  // the ball of origins reaches into the sphere
  // angle(axis, v) <= half-angle + the sphere's angular radius asin(R / v)
  const float along = vx * k.ax + vy * k.ay + vz * k.az;
  return along >= k.cos_t * sqrtf(v2 - R * R) - k.sin_t * R;
}

// GRID: the rays are views x grid_rows x grid_cols and a block takes a
// TILE_H x TILE_W tile of one view; else a block takes THREADS consecutive rays.
template <bool GRID>
__global__ void __launch_bounds__(THREADS)
ray_boxes_kernel(const float* __restrict__ origins,
                 const float* __restrict__ dirs, int n_rays, int grid_rows,
                 int grid_cols, const float* __restrict__ boxes, int n_boxes,
                 float* __restrict__ t_out, long long* __restrict__ idx_out) {
  constexpr int RPT = GRID ? RPT_GRID : 1;
  __shared__ float s_box[CHUNK * ROW];
  __shared__ int s_idx[CHUNK];
  __shared__ int s_warp[WARPS];

  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const float* table = boxes + (size_t)b * n_boxes * ROW;

  // ray q of this thread is ray tid + q * THREADS of the block's tile
  bool live[RPT];
  size_t ray[RPT];
  float o[RPT][3], d[RPT][3], dzs[RPT];
#pragma unroll
  for (int q = 0; q < RPT; ++q) {
    const int i = tid + q * THREADS;
    int r;
    if (GRID) {  // a tile of one view of the (views, rows, cols) rays
      const int tiles_r = (grid_rows + TILE_H - 1) / TILE_H;
      const int tiles_c = (grid_cols + TILE_W - 1) / TILE_W;
      const int view = blockIdx.x / (tiles_r * tiles_c);
      const int rem = blockIdx.x % (tiles_r * tiles_c);
      const int row = (rem / tiles_c) * TILE_H + i / TILE_W;
      const int col = (rem % tiles_c) * TILE_W + i % TILE_W;
      live[q] = row < grid_rows && col < grid_cols;
      r = (view * grid_rows + row) * grid_cols + col;
    } else {
      r = blockIdx.x * THREADS + i;
      live[q] = r < n_rays;
    }
    ray[q] = (size_t)b * n_rays + (live[q] ? r : 0);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      o[q][k] = origins[3 * ray[q] + k];
      d[q][k] = dirs[3 * ray[q] + k];
    }
    dzs[q] = guard(d[q][2]);
  }
  const Cone cone = block_cone<RPT>(live, o, d);

  float t_best[RPT];
  long long idx_best[RPT];
#pragma unroll
  for (int q = 0; q < RPT; ++q) {
    t_best[q] = MAX_T;
    idx_best[q] = -1;
  }
  for (int base = 0; base < n_boxes; base += CHUNK) {
    const int n_chunk = min(CHUNK, n_boxes - base);
    // the survivors, compacted in place: a row moves only to a lower slot,
    // after the round that read it
    int n = 0;
    for (int k = 0; k < n_chunk; k += THREADS) {
      float p[ROW];
      bool keep = false;
      if (k + tid < n_chunk) {
        const float* src = table + (size_t)(base + k + tid) * ROW;
        for (int i = 0; i < ROW; ++i) p[i] = src[i];
        keep = keep_box(p, cone);
      }
      int total;
      const int pos = n + block_compact(keep, s_warp, &total);
      if (keep) {
        for (int i = 0; i < ROW; ++i) s_box[pos * ROW + i] = p[i];
        s_idx[pos] = base + k + tid;
      }
      n += total;
    }
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      const float* p = s_box + j * ROW;
      const float c = p[2], s = p[3];
#pragma unroll
      for (int q = 0; q < RPT; ++q) {
        const float ox = o[q][0], oy = o[q][1], oz = o[q][2];
        const float dx = d[q][0], dy = d[q][1];
        // the ray in the box frame
        const float rx = ox - p[0], ry = oy - p[1];
        const float lx = rx * c + ry * s;
        const float ly = -rx * s + ry * c;
        const float ldx = guard(dx * c + dy * s);
        const float ldy = guard(-dx * s + dy * c);

        const float tx1 = (-p[4] - lx) / ldx;
        const float tx2 = (p[4] - lx) / ldx;
        const float ty1 = (-p[5] - ly) / ldy;
        const float ty2 = (p[5] - ly) / ldy;
        const float tz1 = (p[8] - oz) / dzs[q];
        const float tz2 = (p[6] - oz) / dzs[q];

        const float t_near = fmaxf(fmaxf(fminf(tx1, tx2), fminf(ty1, ty2)),
                                   fminf(tz1, tz2));
        const float t_far = fminf(fminf(fmaxf(tx1, tx2), fmaxf(ty1, ty2)),
                                  fmaxf(tz1, tz2));
        const bool hit = t_near <= t_far && t_far > 0.0f && p[7] > 0.5f;
        const float t_hit = hit ? fmaxf(t_near, 0.0f) : MAX_T;
        if (t_hit < t_best[q]) {
          t_best[q] = t_hit;
          idx_best[q] = s_idx[j];
        }
      }
    }
  }
#pragma unroll
  for (int q = 0; q < RPT; ++q) {
    if (live[q]) {
      t_out[ray[q]] = t_best[q];
      idx_out[ray[q]] = idx_best[q];
    }
  }
}

template <bool GRID>
cudaError_t launch(dim3 grid, void* stream, const float* origins,
                   const float* dirs, int n_rays, int grid_rows, int grid_cols,
                   const float* boxes, int n_boxes, float* t_out,
                   long long* idx_out) {
  ray_boxes_kernel<GRID><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      origins, dirs, n_rays, grid_rows, grid_cols, boxes, n_boxes, t_out,
      idx_out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// origins, dirs (B, n_rays, 3) f32; boxes (B, n_boxes, 9) f32; t_out
// (B, n_rays) f32; idx_out (B, n_rays) i64; all contiguous on the device.
// With grid_rows, grid_cols > 0 the rays are (n_rays / (rows * cols))
// views of rows x cols and a block takes a K2_TILE_H x K2_TILE_W tile of
// one view; with grid_cols == 0 a block takes K2_THREADS consecutive rays.
// Launches on `stream` and returns cudaGetLastError() of the launch.
int tt_ray_boxes(const float* origins, const float* dirs, int n_worlds,
                 int n_rays, const float* boxes, int n_boxes, float* t_out,
                 long long* idx_out, int grid_rows, int grid_cols, void* stream) {
  if (n_worlds == 0 || n_rays == 0) return 0;
  if (grid_cols > 0) {
    if (grid_rows <= 0 || n_rays % (grid_rows * grid_cols) != 0) {
      return (int)cudaErrorInvalidValue;
    }
    const int views = n_rays / (grid_rows * grid_cols);
    const dim3 grid(views * ((grid_rows + TILE_H - 1) / TILE_H) *
                        ((grid_cols + TILE_W - 1) / TILE_W),
                    n_worlds);
    return (int)launch<true>(grid, stream, origins, dirs, n_rays, grid_rows,
                             grid_cols, boxes, n_boxes, t_out, idx_out);
  }
  const dim3 grid((n_rays + THREADS - 1) / THREADS, n_worlds);
  return (int)launch<false>(grid, stream, origins, dirs, n_rays, 0, 0, boxes,
                            n_boxes, t_out, idx_out);
}

const char* tt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
