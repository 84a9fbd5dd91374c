// K6 and K7 on Hopper: sparse 3D convolution over a neighbour table (K6)
// and the rulebooks that build the tables and the output sets (K7).
//
// Replaces no Pallas kernel: the JAX package has no sparse convolution, and
// the reference ThinkTwice calls spconv's SubMConv3d and SparseConv3d in
// mmdet3d's SparseEncoder. Semantics: a sparse tensor is a set of active
// sites (b, z, y, x) with a feature row each. A convolution of kernel k,
// stride s and padding p gives out[o] = sum over offsets kk of
// W[kk] . in[o * s - p + kk], summed over the active inputs only. A
// submanifold convolution (SubM: s = 1, p = k / 2) keeps the input's
// active set; a strided one's outputs are every site some active input
// reaches, ordered by their linear coordinate.
//
// K7, the rulebooks (the tt_rulebook_* kernels):
//   mark     each active input marks every output site it reaches in a
//            dense (B, D, H, W) int32 grid of the output level (a plain
//            store of 1: concurrent stores write the same value)
//   compact  after an inclusive scan of the marks (the caller's), each
//            marked site takes id = scan - 1 (the linear order), its
//            coordinate, and the grid holds its id (-1 elsewhere); the
//            output count is the scan's last value, on the device
//   table    nbr[o, kk] = the input row at o * s - p + kk, or -1: the
//            input level's grid read at each of the K offsets, and the
//            active pairs counted (an integer atomicAdd a block)
// K6, the convolution (tt_sparse_conv_kernel): output-stationary over the
// table. A block takes R output rows and every output channel; thread (row
// group g, channels co .. co + CT - 1) keeps 8 rows x CT channels of sums
// in registers, CT = 1, 2, 4 at 32, 64, 128 output channels, so a row
// group is one warp (R = 8 x 256 / (C_out / CT)) and the rows it skips,
// the warp skips together. For each offset kk in order, the block skips kk
// when none of its rows has an input there, stages its rows' inputs in
// shared memory (a warp a row), and each thread adds in[row] . W[kk][:, co]
// over the input channels in order, with fmaf. So each output is summed in
// one fixed order (kk, then c_in), by one thread, with no atomics: the bits
// are the same on every run. Batch norm (eval: the running statistics),
// the residual and ReLU are fused after the sums. tt_sparse_to_dense_kernel
// scatters the rows into a zeroed (B, C, D, H, W) grid.
//
// No host synchronisation: every count (inputs, outputs, pairs) lives on
// the device, and every launch covers a fixed capacity and reads the count
// there. Rows past the count are neither read nor written.
//
// What bounds K6 on an H100: at the encoder's widths (16-128 channels in
// float32) the gathers of input rows and the float32 FMAs of the active
// pairs, a few GFLOP a forward; the least time is the larger of its bytes
// over 3.35 TB/s and its operations (2 x pairs x C_in x C_out) over the
// float32 peak.
// Built with -Xptxas -v for sm_90a (ops/nvcc.py).

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int ACC = 8;             // output rows a thread keeps

struct Geo {
  int B, D, H, W;
};

struct Conv {
  int kz, ky, kx, sz, sy, sx, pz, py, px;
};

__device__ __forceinline__ long long cells(const Geo& g) {
  return (long long)g.D * g.H * g.W;
}

__global__ void tt_rulebook_mark_kernel(const int* __restrict__ in_coords,
                                        const int* __restrict__ n_in, int cap_in, Geo out,
                                        Conv c, int* __restrict__ mark) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= cap_in || i >= n_in[0]) return;
  const int* q = in_coords + 4LL * i;
  const int b = q[0], z = q[1], y = q[2], x = q[3];
  int* m = mark + b * cells(out);
  for (int dz = 0; dz < c.kz; ++dz) {
    const int nz = z + c.pz - dz;
    if (nz < 0 || nz % c.sz) continue;
    const int oz = nz / c.sz;
    if (oz >= out.D) continue;
    for (int dy = 0; dy < c.ky; ++dy) {
      const int ny = y + c.py - dy;
      if (ny < 0 || ny % c.sy) continue;
      const int oy = ny / c.sy;
      if (oy >= out.H) continue;
      for (int dx = 0; dx < c.kx; ++dx) {
        const int nx = x + c.px - dx;
        if (nx < 0 || nx % c.sx) continue;
        const int ox = nx / c.sx;
        if (ox >= out.W) continue;
        m[((long long)oz * out.H + oy) * out.W + ox] = 1;
      }
    }
  }
}

__global__ void tt_rulebook_compact_kernel(int* __restrict__ grid,
                                           const int* __restrict__ scan, Geo out,
                                           int* __restrict__ out_coords,
                                           int* __restrict__ n_out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long total = out.B * cells(out);
  if (i >= total) return;
  if (i == total - 1) n_out[0] = scan[i];
  if (!grid[i]) {
    grid[i] = -1;
    return;
  }
  const int id = scan[i] - 1;
  grid[i] = id;
  const long long per = cells(out), hw = (long long)out.H * out.W;
  const long long r = i % per;
  int* q = out_coords + 4LL * id;
  q[0] = (int)(i / per);
  q[1] = (int)(r / hw);
  q[2] = (int)((r % hw) / out.W);
  q[3] = (int)(r % out.W);
}

// One thread an (output row, offset); the block's active pairs added to
// *pairs once.
__global__ void tt_rulebook_kernel(const int* __restrict__ out_coords,
                                   const int* __restrict__ n_out, int cap_out,
                                   const int* __restrict__ grid, Geo in, Conv c,
                                   int* __restrict__ nbr, unsigned long long* __restrict__ pairs) {
  const int K = c.kz * c.ky * c.kx;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long o = t / K;
  const int kk = (int)(t % K);
  int found = 0;
  if (o < cap_out && o < n_out[0]) {
    const int* q = out_coords + 4 * o;
    const int dz = kk / (c.ky * c.kx), dy = (kk / c.kx) % c.ky, dx = kk % c.kx;
    const int z = q[1] * c.sz - c.pz + dz, y = q[2] * c.sy - c.py + dy,
              x = q[3] * c.sx - c.px + dx;
    int v = -1;
    if (z >= 0 && z < in.D && y >= 0 && y < in.H && x >= 0 && x < in.W) {
      v = grid[q[0] * cells(in) + ((long long)z * in.H + y) * in.W + x];
      if (v < 0 || v == 0x7fffffff) v = -1;
    }
    nbr[t] = v;
    found = v >= 0;
  }
  const int n = __syncthreads_count(found);
  if (threadIdx.x == 0 && n) atomicAdd(pairs, (unsigned long long)n);
}

template <int CT>
__global__ void __launch_bounds__(THREADS)
    tt_sparse_conv_kernel(const float* __restrict__ x, int cin, const int* __restrict__ nbr,
                          int K, const int* __restrict__ n_out, int cap_out,
                          const float* __restrict__ w, int cout,
                          const float* __restrict__ bn_w, const float* __restrict__ bn_b,
                          const float* __restrict__ bn_mean, const float* __restrict__ bn_var,
                          float eps, const float* __restrict__ res, int relu,
                          float* __restrict__ y) {
  constexpr int CHUNK = 8 / CT;      // input channels a thread reads into registers at once
  extern __shared__ float smem[];
  const int lanes = cout / CT;       // threads of one row group
  const int R = (THREADS / lanes) * ACC;
  int* s_nbr = (int*)smem;           // R
  float* s_in = smem + R;            // R x cin
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int co = (tid % lanes) * CT, g = tid / lanes;
  const int n = min(n_out[0], cap_out);
  const long long row0 = (long long)blockIdx.x * R;
  if (row0 >= n) return;
  float acc[ACC][CT];
#pragma unroll
  for (int j = 0; j < ACC; ++j)
#pragma unroll
    for (int t = 0; t < CT; ++t) acc[j][t] = 0.0f;
  for (int kk = 0; kk < K; ++kk) {
    int mine = -1;
    if (tid < R && row0 + tid < n) mine = nbr[(row0 + tid) * K + kk];
    if (tid < R) s_nbr[tid] = mine;
    if (!__syncthreads_or(mine >= 0)) continue;
    for (int r = warp; r < R; r += THREADS / 32) {   // a warp stages a row at a time
      const int nb = s_nbr[r];
      float* dst = s_in + r * cin;
      if (nb < 0) continue;
      const float* src = x + (long long)nb * cin;
      for (int ch = lane; ch < cin; ch += 32) dst[ch] = src[ch];
    }
    __syncthreads();
    const float* wk = w + (long long)kk * cin * cout + co;
    for (int c0 = 0; c0 < cin; c0 += CHUNK) {
      float wc[CHUNK][CT];
#pragma unroll
      for (int i = 0; i < CHUNK; ++i)
#pragma unroll
        for (int t = 0; t < CT; ++t)
          wc[i][t] = c0 + i < cin ? wk[(long long)(c0 + i) * cout + t] : 0.0f;
#pragma unroll
      for (int j = 0; j < ACC; ++j) {
        const int r = g * ACC + j;
        if (s_nbr[r] < 0) continue;
        const float* a = s_in + r * cin + c0;
#pragma unroll
        for (int i = 0; i < CHUNK; ++i) {
          if (c0 + i < cin) {
            const float v = a[i];
#pragma unroll
            for (int t = 0; t < CT; ++t) acc[j][t] = fmaf(v, wc[i][t], acc[j][t]);
          }
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int t = 0; t < CT; ++t) {
    const int c = co + t;
    const float scale = bn_w[c] / sqrtf(bn_var[c] + eps);
    const float mean = bn_mean[c], shift = bn_b[c];
#pragma unroll
    for (int j = 0; j < ACC; ++j) {
      const long long r = row0 + g * ACC + j;
      if (r >= n) break;
      float v = (acc[j][t] - mean) * scale + shift;
      if (res) v = v + res[r * cout + c];
      if (relu) v = fmaxf(v, 0.0f);
      y[r * cout + c] = v;
    }
  }
}

__global__ void tt_sparse_to_dense_kernel(const float* __restrict__ x, int C,
                                          const int* __restrict__ coords,
                                          const int* __restrict__ n, int cap, Geo g,
                                          float* __restrict__ dense) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long row = t / C;
  const int c = (int)(t % C);
  if (row >= cap || row >= n[0]) return;
  const int* q = coords + 4 * row;
  dense[(((long long)q[0] * C + c) * g.D + q[1]) * g.H * g.W + (long long)q[2] * g.W + q[3]] =
      x[row * C + c];
}

unsigned blocks(long long n, int per) { return (unsigned)((n + per - 1) / per); }

bool conv_ok(const Conv& c) {
  return c.kz > 0 && c.ky > 0 && c.kx > 0 && c.sz > 0 && c.sy > 0 && c.sx > 0 && c.pz >= 0 &&
         c.py >= 0 && c.px >= 0;
}

}  // namespace

extern "C" {

// geo (B, D, H, W) and conv (kz, ky, kx, sz, sy, sx, pz, py, px) on the
// host. Each launches on `stream` and returns cudaGetLastError() of its
// launch (cudaErrorInvalidValue for what it does not take).

// mark: grid_out zeroed by the caller; marks every output site an active
// input reaches.
int tt_rulebook_mark(const int* in_coords, const int* n_in, int cap_in, const int* geo_out,
                     const int* conv, int* mark, void* stream) {
  const Geo g = {geo_out[0], geo_out[1], geo_out[2], geo_out[3]};
  const Conv c = {conv[0], conv[1], conv[2], conv[3], conv[4], conv[5], conv[6], conv[7], conv[8]};
  if (!conv_ok(c) || cap_in < 0) return cudaErrorInvalidValue;
  if (cap_in == 0) return 0;
  tt_rulebook_mark_kernel<<<blocks(cap_in, THREADS), THREADS, 0, (cudaStream_t)stream>>>(
      in_coords, n_in, cap_in, g, c, mark);
  return cudaGetLastError();
}

// compact: grid holds the marks, scan their inclusive int32 scan; writes
// ids into grid (-1 where unmarked), out_coords and n_out[0].
int tt_rulebook_compact(int* grid, const int* scan, const int* geo_out, int* out_coords,
                        int* n_out, void* stream) {
  const Geo g = {geo_out[0], geo_out[1], geo_out[2], geo_out[3]};
  const long long total = (long long)g.B * g.D * g.H * g.W;
  if (total <= 0) return cudaErrorInvalidValue;
  tt_rulebook_compact_kernel<<<blocks(total, THREADS), THREADS, 0, (cudaStream_t)stream>>>(
      grid, scan, g, out_coords, n_out);
  return cudaGetLastError();
}

// table: nbr (cap_out, K) int32, pairs one uint64 zeroed by the caller.
int tt_rulebook_table(const int* out_coords, const int* n_out, int cap_out, const int* grid_in,
                      const int* geo_in, const int* conv, int* nbr, unsigned long long* pairs,
                      void* stream) {
  const Geo g = {geo_in[0], geo_in[1], geo_in[2], geo_in[3]};
  const Conv c = {conv[0], conv[1], conv[2], conv[3], conv[4], conv[5], conv[6], conv[7], conv[8]};
  if (!conv_ok(c) || cap_out < 0) return cudaErrorInvalidValue;
  const long long total = (long long)cap_out * c.kz * c.ky * c.kx;
  if (total == 0) return 0;
  tt_rulebook_kernel<<<blocks(total, THREADS), THREADS, 0, (cudaStream_t)stream>>>(
      out_coords, n_out, cap_out, grid_in, g, c, nbr, pairs);
  return cudaGetLastError();
}

// conv: x (cap_in, cin), nbr (cap_out, K), w (K, cin, cout), the batch
// norm's four (cout,) arrays, res (cap_out, cout) or null, y (cap_out,
// cout); all float32 but nbr. cout / CT must divide 256 and be >= 8, and R
// rows x (cin + 1) floats must fit 48 KB of shared memory.
int tt_sparse_conv(const float* x, int cin, const int* nbr, int K, const int* n_out,
                   int cap_out, const float* w, int cout, const float* bn_w, const float* bn_b,
                   const float* bn_mean, const float* bn_var, float eps, const float* res,
                   int relu, float* y, void* stream) {
  // output channels a thread keeps: as many as make a row group a warp
  const int ct = cout >= 128 ? 4 : cout >= 64 ? 2 : 1;
  if (cin <= 0 || K <= 0 || cap_out < 0 || cout % ct) return cudaErrorInvalidValue;
  const int lanes = cout / ct;
  if (lanes < 8 || lanes > THREADS || THREADS % lanes) return cudaErrorInvalidValue;
  const int R = (THREADS / lanes) * ACC;
  const size_t shared = sizeof(float) * ((size_t)R + (size_t)R * cin);
  if (shared > 48 * 1024) return cudaErrorInvalidValue;
  if (cap_out == 0) return 0;
  const unsigned grid = blocks(cap_out, R);
  cudaStream_t s = (cudaStream_t)stream;
  if (ct == 4) {
    tt_sparse_conv_kernel<4><<<grid, THREADS, shared, s>>>(x, cin, nbr, K, n_out, cap_out, w, cout, bn_w, bn_b, bn_mean, bn_var, eps, res, relu, y);
  } else if (ct == 2) {
    tt_sparse_conv_kernel<2><<<grid, THREADS, shared, s>>>(x, cin, nbr, K, n_out, cap_out, w, cout, bn_w, bn_b, bn_mean, bn_var, eps, res, relu, y);
  } else {
    tt_sparse_conv_kernel<1><<<grid, THREADS, shared, s>>>(x, cin, nbr, K, n_out, cap_out, w, cout, bn_w, bn_b, bn_mean, bn_var, eps, res, relu, y);
  }
  return cudaGetLastError();
}

// dense: x (cap, C) float32, coords (cap, 4); dense (B, C, D, H, W)
// zeroed by the caller.
int tt_sparse_to_dense(const float* x, int C, const int* coords, const int* n, int cap,
                       const int* geo, float* dense, void* stream) {
  const Geo g = {geo[0], geo[1], geo[2], geo[3]};
  if (C <= 0 || cap < 0) return cudaErrorInvalidValue;
  const long long total = (long long)cap * C;
  if (total == 0) return 0;
  tt_sparse_to_dense_kernel<<<blocks(total, THREADS), THREADS, 0, (cudaStream_t)stream>>>(
      x, C, coords, n, cap, g, dense);
  return cudaGetLastError();
}

const char* tt_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
