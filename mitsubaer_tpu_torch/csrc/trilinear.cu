// Kernel A: trilinear density lookup at N world points from a table of
// corner-packed cells.
//
// Replaces mitsubaer_tpu/models/medium.py::DensityBricks.lookup as a whole:
// the gather of 8x4x4 apron bricks plus the Pallas _trilinear_brick_kernel
// (medium.py:118, launched at :167). That design served the TPU's fixed
// per-row gather cost and its VPU.
//
// What bounds it on an H100. The function's own bytes (12 B of point in, 4 B
// out, the grid once) set a bound of ~5 us at 10^6 points. Read from the
// dense (nz, ny, nx) grid, the 8 corners of a point lie in 4 to 8 different
// 32-byte sectors (y-neighbours 4 nx bytes apart, z-neighbours 4 nx ny), and
// at 64^3 the grid is larger than an SM's L1, so those sectors come from L2:
// the gather traffic, not the function's bytes, sets the time.
//
// Design. models/medium.py::cell_table packs, once per grid, each cell's 8
// corner values into one record in the order the lerp reads them ((dz, dy,
// dx) = 000, 001, 010, 011, 100, 101, 110, 111; corner indices clamped to
// res - 1). An f32 record is 32 B, one aligned sector, read with two 16-byte
// loads; a bf16 record (for grids already rounded to bf16, so exact) is 16 B,
// one 16-byte load. A point then costs one sector of L2 traffic. Points
// outside the AABB return 0 without a load. The table holds
// max(nz-1,1) max(ny-1,1) max(nx-1,1) records: about 8x the grid's f32 bytes
// (8.0 MB at 64^3), 4x in bf16 (4.0 MB), both well inside the 50 MB L2.
//
// Arithmetic follows models/medium.py::trilinear_lookup_plain operation for
// operation (cell = clip(floor(x), 0, res-2), t = x - cell, zero outside the
// AABB); it is compiled without fused multiply-add so it rounds the same way,
// and the bf16 values widen to f32 exactly.
//
#include <cuda_runtime.h>

#include <cfloat>
#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ void load_record(const float* cells, long long rec,
                                            float r[8]) {
  const float4* q = reinterpret_cast<const float4*>(cells) + 2 * rec;
  float4 a = __ldg(q), b = __ldg(q + 1);
  r[0] = a.x, r[1] = a.y, r[2] = a.z, r[3] = a.w;
  r[4] = b.x, r[5] = b.y, r[6] = b.z, r[7] = b.w;
}

__device__ __forceinline__ void load_record(const uint16_t* cells,
                                            long long rec, float r[8]) {
  uint4 q = __ldg(reinterpret_cast<const uint4*>(cells) + rec);
  const uint32_t w[4] = {q.x, q.y, q.z, q.w};
  for (int k = 0; k < 4; ++k) {  // little-endian: the lower half comes first
    r[2 * k] = __uint_as_float(w[k] << 16);
    r[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
  }
}

// Kernel A's cell arithmetic for point i: returns false outside the AABB,
// else the cell c (x, y, z) and its fractions t.
__device__ __forceinline__ bool cell_of(const float* __restrict__ p,
                                        const float* __restrict__ aabb6,
                                        int i, const int res_i[3], int c[3],
                                        float t[3]) {
  bool inside = true;
  for (int k = 0; k < 3; ++k) {
    float res = (float)res_i[k];
    float lo = __ldg(aabb6 + k);
    float h = (__ldg(aabb6 + 3 + k) - lo) / fmaxf(res - 1.0f, 1.0f);
    float v = (p[3 * i + k] - lo) / h;
    inside = inside && (v >= 0.0f) && (v <= res - 1.0f);
    v = fminf(fmaxf(v, 0.0f), res - 1.0f);
    float cell = fminf(fmaxf(floorf(v), 0.0f), fmaxf(res - 2.0f, 0.0f));
    c[k] = (int)cell;
    t[k] = v - cell;
  }
  return inside;
}

template <typename Cell>
__global__ void __launch_bounds__(kThreads)
    trilinear_kernel(const float* __restrict__ p,
                     const Cell* __restrict__ cells,
                     const float* __restrict__ aabb6, float* __restrict__ out,
                     int n, int nx, int ny, int nz) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int res_i[3] = {nx, ny, nz};
  float t[3];
  int c[3];
  if (!cell_of(p, aabb6, i, res_i, c, t)) {
    out[i] = 0.0f;
    return;
  }
  const int cx = max(nx - 1, 1), cy = max(ny - 1, 1);
  float r[8];
  load_record(cells, ((long long)c[2] * cy + c[1]) * cx + c[0], r);
  float tx = t[0], ty = t[1], tz = t[2];
  float c00 = r[0] * (1.0f - tx) + r[1] * tx;
  float c01 = r[2] * (1.0f - tx) + r[3] * tx;
  float c10 = r[4] * (1.0f - tx) + r[5] * tx;
  float c11 = r[6] * (1.0f - tx) + r[7] * tx;
  float c0 = c00 * (1.0f - ty) + c01 * ty;
  float c1 = c10 * (1.0f - ty) + c11 * ty;
  out[i] = c0 * (1.0f - tz) + c1 * tz;
}

// Kernel A': the gradient of kernel A's lookups with respect to the
// (nz, ny, nx) grid, for the training path (models/medium.py::
// TrilinearLookup). The JAX package has no backward Pallas kernel: it
// differentiates its unfused lookup with XLA (medium.py:206-252,
// fused=False). Each point inside the AABB adds grad_out * w_k to its 8
// corner voxels; the cell, t, the clamps and the zero outside the AABB are
// kernel A's, and the corner indices are clamped to res - 1, so on a
// one-voxel axis two coinciding corners add both weights to one voxel. The
// weights are formed in the order autograd forms them through the lerps
// ((g (1-tz)) (1-ty)) (1-tx), so each term equals models/medium.py::
// trilinear_lookup_backward_plain's. A zero output gradient adds nothing; a
// NaN or inf one still reaches its 8 voxels.
//
// What bounds it: 4 B of gradient a point, 12 B of position for a point
// whose gradient is not zero, and the grid written once, at 3.35 TB/s
// (~5.3 us at 2^20 spread points on 64^3; ~1.6 us at a training step's
// 2^20-point call, whose gradients are almost all zero). What costs the
// time is the adds: a point's 8 adds go to L2 as reductions, and L2
// retires them at a fixed rate, slower where many hit one address (points
// that cluster in a few cells serialise there).
//
// Determinism. Float adds in the order the atomics happen to land would
// change a voxel's last bits from run to run, and a training step's Adam
// update lr g / (|g| + eps) magnifies those bits where |g| is small, so
// two runs of one step would not update the grid alike. The voxels are
// summed in fixed point instead: integer adds give the same sum in any
// order. A first kernel finds the largest finite |grad_out| (an atomicMax
// on its bits, exact); with n points no voxel's partial sums exceed n
// times it in magnitude, so the scale 2^(62 - e), 2^e > n max |grad_out|,
// keeps every partial sum inside int64 and resolves 2^-62 of that bound
// (2^-41 of the largest gradient at 2^21 points: far below a float's
// rounding of any voxel that holds it). Each value is rounded to the
// nearest integer (symmetrically, so +x and -x cancel exactly). A sum
// that is not finite (a NaN or inf gradient) adds to the float grid
// itself instead, where NaN and +-inf add to the same value in any order.
// A last kernel writes each voxel whose float value is still zero from its
// fixed-point sum. The result is the same bits on every run of the same
// inputs.
//
// Design: fewer L2 reductions, by two means.
// - A block takes kBwdItems points a thread, holds their cells in
//   registers and reduces the box of the voxels they touch. Where that box
//   holds few voxels for its points, the block adds into a shared tile
//   with shared-memory atomics and then adds each non-zero tile voxel to
//   the grid once; else it adds to the grid itself.
// - Before either add, the lanes of a warp that share a cell
//   (__match_any_sync on the cell's index) sum their 8 weighted values
//   with shuffles, in lane order, and the lowest of them alone adds the
//   sums.
// The zeroing is a cudaMemsetAsync on the same stream in the C entry.
// Each mechanism and constant was timed against a copy without it with
// float adds (H100, scripts/compare_kernels_torch.py --old): without the
// warp sums 2.6x slower clustered; without the tile 18x; with no
// voxels-a-point limit on the tile 7-18% slower on a training step's
// sparse calls; 2 points a thread 7-8% slower on the step's mostly-zero
// calls (faster on busy ones), 8 slower everywhere.
constexpr int kBwdItems = 4;                  // points a thread
constexpr int kBwdPoints = kThreads * kBwdItems;
constexpr int kTileVoxelsPerPoint = 2;        // tile if box <= 2 a point
// the largest box the tile takes (16 KB of int64)
constexpr int kTile = kTileVoxelsPerPoint * kBwdPoints;
constexpr int kAmaxBlocks = 1024;

typedef unsigned long long u64;

// The fixed-point scale of a call: 2^(62 - e) with 2^e > n amax (amax the
// bits of the largest finite |grad_out|); 1 where every gradient is 0.
__device__ __forceinline__ double fixed_scale(unsigned amax_bits, int n) {
  const float amax = __uint_as_float(amax_bits);
  if (amax == 0.0f) return 1.0;
  int e;
  frexp((double)amax * (double)n, &e);
  return ldexp(1.0, 62 - e);
}

__global__ void __launch_bounds__(kThreads)
    grad_amax_kernel(const float* __restrict__ grad_out, int n,
                     unsigned* __restrict__ amax) {
  unsigned m = 0;
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < n;
       i += gridDim.x * kThreads) {
    const float a = fabsf(grad_out[i]);
    if (a <= FLT_MAX) m = max(m, __float_as_uint(a));   // NaN fails
  }
  m = __reduce_max_sync(0xffffffffu, m);
  if ((threadIdx.x & 31) == 0 && m) atomicMax(amax, m);
}

// A voxel's value a in fixed point (0 where a is 0); a value that is not
// finite goes to the float grid at f here, and 0 comes back.
__device__ __forceinline__ u64 to_fixed(float* grid, long long f, float a,
                                        double scale) {
  if (a == 0.0f) return 0;
  if (!(fabsf(a) <= FLT_MAX)) {             // NaN or inf
    atomicAdd(grid + f, a);
    return 0;
  }
  return (u64)__double2ll_rn((double)a * scale);
}

__global__ void __launch_bounds__(kThreads)
    trilinear_backward_kernel(const float* __restrict__ p,
                              const float* __restrict__ grad_out,
                              const float* __restrict__ aabb6,
                              float* __restrict__ grad_grid,
                              u64* __restrict__ acc,
                              const unsigned* __restrict__ amax, int n,
                              int nx, int ny, int nz) {
  __shared__ u64 tile[kTile];
  __shared__ int box[6];                      // lower x y z, upper x y z
  __shared__ int adding;
  const unsigned all = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const int res_i[3] = {nx, ny, nz};
  if (threadIdx.x < 6) box[threadIdx.x] = threadIdx.x < 3 ? INT_MAX : -1;
  if (threadIdx.x == 0) adding = 0;

  // the block's points: cells, fractions and output gradients in
  // registers; the gradient is read first, and a point's position only
  // where it is not zero (a training step's calls are mostly zeros)
  int c[kBwdItems][3] = {};
  float t[kBwdItems][3] = {}, g[kBwdItems];
  int lo[3] = {INT_MAX, INT_MAX, INT_MAX}, hi[3] = {-1, -1, -1}, mine = 0;
  const int first = blockIdx.x * kBwdPoints + threadIdx.x;
#pragma unroll
  for (int j = 0; j < kBwdItems; ++j) {
    const int i = first + j * kThreads;
    g[j] = i < n ? grad_out[i] : 0.0f;
    if (g[j] != 0.0f && !cell_of(p, aabb6, i, res_i, c[j], t[j]))
      g[j] = 0.0f;
    if (g[j] != 0.0f) {                       // NaN adds too
      ++mine;
      for (int k = 0; k < 3; ++k) {
        lo[k] = min(lo[k], c[j][k]);
        hi[k] = max(hi[k], min(c[j][k] + 1, res_i[k] - 1));
      }
    }
  }
  __syncthreads();
  for (int k = 0; k < 3; ++k) {
    lo[k] = __reduce_min_sync(all, lo[k]);
    hi[k] = __reduce_max_sync(all, hi[k]);
  }
  mine = __reduce_add_sync(all, mine);
  if (lane == 0 && mine) {
    for (int k = 0; k < 3; ++k) {
      atomicMin(box + k, lo[k]);
      atomicMax(box + 3 + k, hi[k]);
    }
    atomicAdd(&adding, mine);
  }
  __syncthreads();
  if (adding == 0) return;
  const double scale = fixed_scale(*amax, n);
  const int bx = box[0], by = box[1], bz = box[2];
  const int ex = box[3] - bx + 1, ey = box[4] - by + 1, ez = box[5] - bz + 1;
  const long long vol = (long long)ex * ey * ez;
  const bool use_tile = vol <= kTile && vol <= kTileVoxelsPerPoint * adding;
  if (use_tile) {
    for (int v = threadIdx.x; v < vol; v += kThreads) tile[v] = 0;
    __syncthreads();
  }

  const int cx = max(nx - 1, 1), cy = max(ny - 1, 1);
#pragma unroll
  for (int j = 0; j < kBwdItems; ++j) {
    const bool adds = g[j] != 0.0f;
    if (!__any_sync(all, adds)) continue;
    const int key = adds ? (c[j][2] * cy + c[j][1]) * cx + c[j][0] : -1;
    const unsigned peers = __match_any_sync(all, key);
    const float tx = t[j][0], ty = t[j][1], tz = t[j][2];
    float w[8];
    {
      const float gz[2] = {g[j] * (1.0f - tz), g[j] * tz};
      for (int dz = 0; dz < 2; ++dz) {
        const float gzy[2] = {gz[dz] * (1.0f - ty), gz[dz] * ty};
        for (int dy = 0; dy < 2; ++dy) {
          w[4 * dz + 2 * dy] = gzy[dy] * (1.0f - tx);
          w[4 * dz + 2 * dy + 1] = gzy[dy] * tx;
        }
      }
    }
    // the lanes of one cell sum their values in lane order; the lowest
    // lane adds them
    float sum[8];
    for (int k = 0; k < 8; ++k) sum[k] = w[k];
    unsigned rest = adds ? peers & ~(1u << lane) : 0u;
    const int rounds = __reduce_max_sync(all, __popc(rest));
    for (int r = 0; r < rounds; ++r) {
      const int src = rest ? __ffs(rest) - 1 : lane;
      for (int k = 0; k < 8; ++k) {
        const float v = __shfl_sync(all, w[k], src);
        if (rest) sum[k] += v;
      }
      rest &= rest - 1;
    }
    if (!adds || lane != __ffs(peers) - 1) continue;
    const int x[2] = {c[j][0], min(c[j][0] + 1, nx - 1)};
    const int y[2] = {c[j][1], min(c[j][1] + 1, ny - 1)};
    const int z[2] = {c[j][2], min(c[j][2] + 1, nz - 1)};
    for (int dz = 0; dz < 2; ++dz) {
      for (int dy = 0; dy < 2; ++dy) {
        const long long f = ((long long)z[dz] * ny + y[dy]) * nx;
        const int row = ((z[dz] - bz) * ey + (y[dy] - by)) * ex - bx;
        for (int dx = 0; dx < 2; ++dx) {
          const u64 q = to_fixed(grad_grid, f + x[dx],
                                 sum[4 * dz + 2 * dy + dx], scale);
          if (q == 0) continue;
          if (use_tile)
            atomicAdd(&tile[row + x[dx]], q);
          else
            atomicAdd(acc + f + x[dx], q);
        }
      }
    }
  }
  if (!use_tile) return;
  __syncthreads();
  for (int v = threadIdx.x; v < vol; v += kThreads) {
    const u64 a = tile[v];
    if (a != 0) {
      const int x = v % ex, yz = v / ex;
      atomicAdd(acc + ((long long)(bz + yz / ey) * ny + by + yz % ey) * nx
                + bx + x, a);
    }
  }
}

// Each voxel whose float value is still zero (no NaN or inf reached it)
// takes its fixed-point sum.
__global__ void __launch_bounds__(kThreads)
    fixed_to_float_kernel(float* __restrict__ grad_grid,
                          const u64* __restrict__ acc,
                          const unsigned* __restrict__ amax, int n,
                          long long numel) {
  const double unit = 1.0 / fixed_scale(*amax, n);
  for (long long v = (long long)blockIdx.x * kThreads + threadIdx.x;
       v < numel; v += (long long)gridDim.x * kThreads)
    if (grad_grid[v] == 0.0f)
      grad_grid[v] = (float)((double)(long long)acc[v] * unit);
}

}  // namespace

// cells: (max(nz-1,1), max(ny-1,1), max(nx-1,1), 8) records, float32 or
// (bf16 != 0) bfloat16, 16-byte aligned.
extern "C" int mk_trilinear_lookup(const float* p, const void* cells,
                                   const float* aabb6, float* out, int n,
                                   int nx, int ny, int nz, int bf16,
                                   void* stream) {
  const int blocks = (n + kThreads - 1) / kThreads;
  if (bf16)
    trilinear_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        p, (const uint16_t*)cells, aabb6, out, n, nx, ny, nz);
  else
    trilinear_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        p, (const float*)cells, aabb6, out, n, nx, ny, nz);
  return (int)cudaGetLastError();
}

// grad_grid: the (nz, ny, nx) float32 gradient of the grid; acc: nz ny nx
// + 1 int64 of scratch (the fixed-point sums, then the largest |grad_out|'s
// bits). Both are zeroed here on the stream; each point inside the AABB
// then adds grad_out[i] times its 8 trilinear weights.
extern "C" int mk_trilinear_lookup_backward(const float* p,
                                            const float* grad_out,
                                            const float* aabb6,
                                            float* grad_grid, void* acc,
                                            int n, int nx, int ny, int nz,
                                            void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const long long numel = (long long)nz * ny * nx;
  u64* sums = (u64*)acc;
  unsigned* amax = (unsigned*)(sums + numel);
  cudaError_t rc = cudaMemsetAsync(grad_grid, 0, sizeof(float) * numel, s);
  if (rc == cudaSuccess)
    rc = cudaMemsetAsync(sums, 0, sizeof(u64) * (numel + 1), s);
  if (rc != cudaSuccess) return (int)rc;
  const int blocks = (n + kBwdPoints - 1) / kBwdPoints;
  const int amax_blocks = (n + kThreads - 1) / kThreads;
  grad_amax_kernel<<<amax_blocks < kAmaxBlocks ? amax_blocks : kAmaxBlocks,
                     kThreads, 0, s>>>(grad_out, n, amax);
  trilinear_backward_kernel<<<blocks, kThreads, 0, s>>>(
      p, grad_out, aabb6, grad_grid, sums, amax, n, nx, ny, nz);
  const long long fin = (numel + kThreads - 1) / kThreads;
  fixed_to_float_kernel<<<(int)(fin < 4096 ? fin : 4096), kThreads, 0, s>>>(
      grad_grid, sums, amax, n, numel);
  return (int)cudaGetLastError();
}

extern "C" const char* mk_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
