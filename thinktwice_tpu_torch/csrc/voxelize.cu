// K5 on Hopper: hard voxelization of a batch of point clouds, with the
// HardSimpleVFE mean.
//
// Replaces no Pallas kernel: the JAX package averages points into a dense
// pillar grid (thinktwice_tpu/models/lidarnet.py), and the reference
// ThinkTwice calls mmdet3d's CUDA `hard_voxelize`. This is mmdet3d's
// sequential definition, per world: points are scanned in their input
// order, masked points and points outside the range are dropped, a voxel
// takes the next id when its first point arrives (until the world's cap),
// and a voxel keeps its first max_points points. mmdet3d's own kernel
// reaches that order with a quadratic scan; here every step is parallel
// and the result is the same bits on every run:
//
//   first   each point's cell (or -1); the least point index of each cell
//           by an integer atomicMin into a dense (B, D, H, W) index grid
//   head    a point is its voxel's head when it is its cell's least index
//   rank    one block a world scans the head flags in point order: a
//           voxel's id is the heads before its own
//   assign  each head kept by the cap takes row offset[b] + id (the worlds
//           one after another), writes its row into the grid (-1 when the
//           cap drops it), its coordinate, and its point as slot 0
//   select  slot j (1 .. max_points - 1) of each voxel is the least point
//           index above slot j - 1's, by an integer atomicMin: one launch
//           a slot, so the kept points are the first ones in input order
//   vfe     each row: the count of its filled slots, the mean of its
//           points' features summed in slot order in float32, its point
//           indices (-1 past the count); rows past the voxels kept are
//           written as empty (coordinate -1, count 0, features 0)
//
// No float atomics, no host synchronisation: the counts (voxels kept,
// voxels the cap dropped) are written to a device array, and every launch
// covers the capacity and reads the counts on the device.
//
// Inputs (ops/voxelize.py `voxelize_cuda` checks them): points (B, P, F)
// float32 contiguous with x, y, z first; mask (B, P) bool; grid (B, D, H,
// W) int32 filled with EMPTY by the caller, D = sparse_shape z (one more
// than the voxel grid's z cells, as mmdet3d's middle encoder takes it).
// Outputs: grid (row of each occupied cell, -1 for a dropped voxel, EMPTY
// elsewhere), coords (cap, 4) int32 (b, z, y, x), point_idx (cap, M)
// int32, counts (cap,) int32, feats (cap, F) float32, n (2,) int32 (kept,
// dropped), cap = B * min(max_voxels, P).
//
// What bounds it on an H100: latency and the index grid. The points and
// outputs are tens of MB; the grid's fill (600 MB at 8 worlds of 41 x 672
// x 672) and its random reads dominate.
// Built with -Xptxas -v for sm_90a (ops/nvcc.py).

#include <cuda_runtime.h>

namespace {

constexpr int EMPTY = 0x7fffffff;
constexpr int THREADS = 256;
constexpr int SCAN_THREADS = 1024;

struct Spec {
  float lo_x, lo_y, lo_z;  // the range's lower corner
  float vx, vy, vz;        // voxel size
  int nx, ny, nz;          // voxel grid cells along x, y, z
  int D, H, W;             // the index grid (D >= nz, H = ny, W = nx)
};

__device__ __forceinline__ long long cells(const Spec& s) {
  return (long long)s.D * s.H * s.W;
}

__global__ void tt_voxelize_first_kernel(const float* __restrict__ pts,
                                         const bool* __restrict__ mask, int B, int P, int F,
                                         Spec s, int* __restrict__ pcell,
                                         int* __restrict__ grid) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)B * P) return;
  const int b = (int)(i / P), p = (int)(i % P);
  const float* q = pts + i * F;
  int cell = -1;
  if (mask[i]) {
    const int cx = (int)floorf((q[0] - s.lo_x) / s.vx);
    const int cy = (int)floorf((q[1] - s.lo_y) / s.vy);
    const int cz = (int)floorf((q[2] - s.lo_z) / s.vz);
    if (cx >= 0 && cx < s.nx && cy >= 0 && cy < s.ny && cz >= 0 && cz < s.nz) {
      cell = (cz * s.H + cy) * s.W + cx;
      atomicMin(grid + b * cells(s) + cell, p);
    }
  }
  pcell[i] = cell;
}

__global__ void tt_voxelize_head_kernel(const int* __restrict__ pcell,
                                        const int* __restrict__ grid, int B, int P, Spec s,
                                        unsigned char* __restrict__ head) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)B * P) return;
  const int b = (int)(i / P), p = (int)(i % P);
  const int cell = pcell[i];
  head[i] = cell >= 0 && grid[b * cells(s) + cell] == p;
}

// One block a world: pvid[b, p] = heads before p (heads only), nraw[b] =
// the world's heads.
__global__ void tt_voxelize_rank_kernel(const unsigned char* __restrict__ head, int P,
                                        int* __restrict__ pvid, int* __restrict__ nraw) {
  __shared__ int part[SCAN_THREADS];
  const int b = blockIdx.x, t = threadIdx.x;
  const int chunk = (P + SCAN_THREADS - 1) / SCAN_THREADS;
  const int p0 = min(P, t * chunk), p1 = min(P, p0 + chunk);
  const unsigned char* h = head + (long long)b * P;
  int sum = 0;
  for (int p = p0; p < p1; ++p) sum += h[p];
  part[t] = sum;
  __syncthreads();
  for (int off = 1; off < SCAN_THREADS; off <<= 1) {  // inclusive scan
    const int v = t >= off ? part[t - off] : 0;
    __syncthreads();
    part[t] += v;
    __syncthreads();
  }
  int run = part[t] - sum;
  int* out = pvid + (long long)b * P;
  for (int p = p0; p < p1; ++p) {
    if (h[p]) out[p] = run++;
  }
  if (t == SCAN_THREADS - 1) nraw[b] = part[t];
}

__global__ void tt_voxelize_assign_kernel(const int* __restrict__ pcell,
                                          const unsigned char* __restrict__ head,
                                          const int* __restrict__ pvid,
                                          const int* __restrict__ nraw, int B, int P, int cap,
                                          int M, Spec s, int* __restrict__ grid,
                                          int* __restrict__ coords, int* __restrict__ slots,
                                          int* __restrict__ n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i == 0) {
    int kept = 0, dropped = 0;
    for (int w = 0; w < B; ++w) {
      kept += min(nraw[w], cap);
      dropped += max(nraw[w] - cap, 0);
    }
    n[0] = kept;
    n[1] = dropped;
  }
  if (i >= (long long)B * P || !head[i]) return;
  const int b = (int)(i / P), p = (int)(i % P);
  const int cell = pcell[i];
  const int vid = pvid[i];
  if (vid >= cap) {
    grid[b * cells(s) + cell] = -1;
    return;
  }
  int row = vid;
  for (int w = 0; w < b; ++w) row += min(nraw[w], cap);
  grid[b * cells(s) + cell] = row;
  const int hw = s.H * s.W;
  int* c = coords + 4LL * row;
  c[0] = b;
  c[1] = cell / hw;
  c[2] = (cell % hw) / s.W;
  c[3] = cell % s.W;
  int* sl = slots + (long long)row * M;
  sl[0] = p;
  for (int j = 1; j < M; ++j) sl[j] = EMPTY;
}

__global__ void tt_voxelize_select_kernel(const int* __restrict__ pcell,
                                          const int* __restrict__ grid, int B, int P, int M,
                                          int j, Spec s, int* __restrict__ slots) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)B * P) return;
  const int cell = pcell[i];
  if (cell < 0) return;
  const int b = (int)(i / P), p = (int)(i % P);
  const int row = grid[b * cells(s) + cell];
  if (row < 0 || row == EMPTY) return;
  int* sl = slots + (long long)row * M;
  const int prev = sl[j - 1];
  if (prev != EMPTY && p > prev) atomicMin(sl + j, p);
}

__global__ void tt_voxelize_vfe_kernel(const float* __restrict__ pts, int P, int F, int M,
                                       int cap_rows, const int* __restrict__ n,
                                       const int* __restrict__ slots,
                                       int* __restrict__ coords, float* __restrict__ feats,
                                       int* __restrict__ point_idx, int* __restrict__ counts) {
  const long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= cap_rows) return;
  int* idx = point_idx + row * M;
  float* f = feats + row * F;
  if (row >= n[0]) {
    for (int k = 0; k < 4; ++k) coords[4 * row + k] = -1;
    for (int j = 0; j < M; ++j) idx[j] = -1;
    for (int k = 0; k < F; ++k) f[k] = 0.0f;
    counts[row] = 0;
    return;
  }
  const int b = coords[4 * row];
  const int* sl = slots + row * M;
  const float* base = pts + (long long)b * P * F;
  int cnt = 0;
  for (int j = 0; j < M; ++j) {
    const int p = sl[j];
    idx[j] = p == EMPTY ? -1 : p;
    cnt += p != EMPTY;
  }
  for (int k = 0; k < F; ++k) {
    float acc = 0.0f;
    for (int j = 0; j < cnt; ++j) acc = acc + base[(long long)sl[j] * F + k];
    f[k] = acc / (float)cnt;
  }
  counts[row] = cnt;
}

unsigned blocks(long long n) { return (unsigned)((n + THREADS - 1) / THREADS); }

}  // namespace

extern "C" {

// lo (3), size (3), voxel grid nxyz (3), index grid dhw (3) on the host.
// grid filled with EMPTY; scratch int32 arrays of B * P: pcell, pvid;
// head B * P bytes; nraw B ints; slots cap * M ints. Launches on `stream`
// and returns cudaGetLastError() (cudaErrorInvalidValue for what it does
// not take).
int tt_voxelize(const float* pts, const bool* mask, int B, int P, int F, const float* lo,
                const float* size, const int* nxyz, const int* dhw, int max_voxels, int M,
                int* grid, int* pcell, unsigned char* head, int* pvid, int* nraw, int* slots,
                int* coords, float* feats, int* point_idx, int* counts, int* n, void* stream) {
  if (B <= 0 || P <= 0 || F < 3 || M <= 0 || max_voxels <= 0) return cudaErrorInvalidValue;
  if (dhw[0] < nxyz[2] || dhw[1] != nxyz[1] || dhw[2] != nxyz[0]) return cudaErrorInvalidValue;
  if ((long long)dhw[0] * dhw[1] * dhw[2] > 0x7fffffffLL) return cudaErrorInvalidValue;
  const Spec s = {lo[0], lo[1], lo[2], size[0], size[1], size[2], nxyz[0], nxyz[1], nxyz[2],
                  dhw[0], dhw[1], dhw[2]};
  const int cap = max_voxels < P ? max_voxels : P;
  const long long pts_n = (long long)B * P;
  const int rows = B * cap;
  cudaStream_t st = (cudaStream_t)stream;
  tt_voxelize_first_kernel<<<blocks(pts_n), THREADS, 0, st>>>(pts, mask, B, P, F, s, pcell,
                                                             grid);
  tt_voxelize_head_kernel<<<blocks(pts_n), THREADS, 0, st>>>(pcell, grid, B, P, s, head);
  tt_voxelize_rank_kernel<<<B, SCAN_THREADS, 0, st>>>(head, P, pvid, nraw);
  tt_voxelize_assign_kernel<<<blocks(pts_n), THREADS, 0, st>>>(pcell, head, pvid, nraw, B, P,
                                                              cap, M, s, grid, coords, slots,
                                                              n);
  for (int j = 1; j < M; ++j) {
    tt_voxelize_select_kernel<<<blocks(pts_n), THREADS, 0, st>>>(pcell, grid, B, P, M, j, s,
                                                                slots);
  }
  tt_voxelize_vfe_kernel<<<blocks(rows), THREADS, 0, st>>>(pts, P, F, M, rows, n, slots,
                                                          coords, feats, point_idx, counts);
  return cudaGetLastError();
}

const char* tt_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
