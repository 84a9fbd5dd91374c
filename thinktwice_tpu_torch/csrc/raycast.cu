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
// What bounds it on an H100: every ray meets every box, about 45 float
// operations a pair, six of them IEEE divisions. At the student's camera
// shape (8 worlds x 524,288 rays x 264 boxes) that is ~1.1 G pairs, ~50
// GFLOP, against ~0.15 GB of rays and results: arithmetic bounds it.
//
// Design (simple first): one thread per ray, 256 rays a block, a grid of
// (ray blocks, worlds) so one launch covers every world. The block stages
// its world's box table through shared memory, 256 rows at a time; every
// thread then tests its ray against the staged rows, which all threads read
// at the same address (a broadcast). A per-tile box cull, a warp-level
// early out and float4 ray loads are left for later work.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int ROW = 9;
constexpr float MAX_T = 1e6f;
constexpr float EPS = 1e-9f;

__device__ __forceinline__ float guard(float d) {
  return fabsf(d) < EPS ? EPS : d;
}

__global__ void __launch_bounds__(THREADS)
ray_boxes_kernel(const float* __restrict__ origins,
                 const float* __restrict__ dirs, int n_rays,
                 const float* __restrict__ boxes, int n_boxes,
                 float* __restrict__ t_out, long long* __restrict__ idx_out) {
  __shared__ float s_box[THREADS * ROW];

  const int b = blockIdx.y;
  const int r = blockIdx.x * THREADS + threadIdx.x;
  const bool live = r < n_rays;
  const size_t ray = (size_t)b * n_rays + (live ? r : 0);
  const float ox = origins[3 * ray + 0], oy = origins[3 * ray + 1];
  const float oz = origins[3 * ray + 2];
  const float dx = dirs[3 * ray + 0], dy = dirs[3 * ray + 1];
  const float dzs = guard(dirs[3 * ray + 2]);

  const float* table = boxes + (size_t)b * n_boxes * ROW;
  float t_best = MAX_T;
  long long idx_best = -1;
  for (int base = 0; base < n_boxes; base += THREADS) {
    const int n = min(THREADS, n_boxes - base);
    __syncthreads();
    for (int i = threadIdx.x; i < n * ROW; i += THREADS) {
      s_box[i] = table[(size_t)base * ROW + i];
    }
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      const float* p = s_box + j * ROW;
      const float c = p[2], s = p[3];
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
      const float tz1 = (p[8] - oz) / dzs;
      const float tz2 = (p[6] - oz) / dzs;

      const float t_near = fmaxf(fmaxf(fminf(tx1, tx2), fminf(ty1, ty2)),
                                 fminf(tz1, tz2));
      const float t_far = fminf(fminf(fmaxf(tx1, tx2), fmaxf(ty1, ty2)),
                                fmaxf(tz1, tz2));
      const bool hit = t_near <= t_far && t_far > 0.0f && p[7] > 0.5f;
      const float t_hit = hit ? fmaxf(t_near, 0.0f) : MAX_T;
      if (t_hit < t_best) {
        t_best = t_hit;
        idx_best = base + j;
      }
    }
  }
  if (live) {
    t_out[ray] = t_best;
    idx_out[ray] = idx_best;
  }
}

}  // namespace

extern "C" {

// origins, dirs (B, n_rays, 3) f32; boxes (B, n_boxes, 9) f32; t_out
// (B, n_rays) f32; idx_out (B, n_rays) i64; all contiguous on the device.
// Launches on `stream` and returns cudaGetLastError() of the launch.
int tt_ray_boxes(const float* origins, const float* dirs, int n_worlds,
                 int n_rays, const float* boxes, int n_boxes, float* t_out,
                 long long* idx_out, void* stream) {
  if (n_worlds == 0 || n_rays == 0) return 0;
  dim3 grid((n_rays + THREADS - 1) / THREADS, n_worlds);
  ray_boxes_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      origins, dirs, n_rays, boxes, n_boxes, t_out, idx_out);
  return (int)cudaGetLastError();
}

const char* tt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
