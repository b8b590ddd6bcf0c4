// Kernel C: tracking-to-completion of the wavefront engine.
//
// Replaces mitsubaer_tpu/integrators/megatrack.py::_kernel (megatrack.py:94,
// launched at :239). The TPU kernel loops majorant jumps over a (rows,
// lanes) block until every lane of the block resolves, and fetches each
// tap's voxel by a one-hot (512, R) x (R, B) matrix product on the MXU
// against a VMEM-resident brick table. Here one thread tracks one lane: it
// reads its valid flag, t and counter; an invalid lane writes them through
// and stops; a valid one reads its other 16 used rows once (row-major
// (24, n), so a warp's loads of a row are coalesced), loops until it
// escapes, collides for real or reaches max_trips, and fetches each tap
// with one indexed load of the bf16 table T[j, r] (512 KiB for a 64^3 grid,
// resident in the 50 MB L2). A resolved lane is frozen in the TPU kernel
// too, so per-lane results do not depend on the blocking; `lane` is the
// global lane index, as there. Compiled with --fmad=false, operations in
// the plain version's order (megatrack.run_plain): every output equals it
// bit for bit.
//
// What bounds it on the H100 is the rows' traffic, not issue or the tap
// chain. 20-47% of the lanes have work at the wavefront render's calls,
// scattered, and each reads 4 bytes of 18 rows, but the card moves whole
// 32-byte sectors: at 45% of lanes nearly every sector of those rows moves
// (~28 MB a call). Redesigns that packed the lanes with work into full
// warps measured slower on the card where half the lanes have work and
// faster only where a fifth do: a block listing its tile's lanes in shared
// memory behind a barrier (256 to 2,048 lanes a block), a warp listing its
// 64 to 256 lanes without one, and several taps' loads in flight a lane.
// This one-thread-a-lane kernel stays because it measured fastest over
// the render's calls (PERF.md, section 6).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MT_THREADS = 128;

__device__ __forceinline__ uint32_t lowbias32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ float unif(uint32_t bits) {
  return (float)(int32_t)(bits >> 8) * 5.9604644775390625e-08f;
}

__device__ __forceinline__ float bf16_to_float(uint16_t v) {
  return __uint_as_float(((uint32_t)v) << 16);
}

// corner = min(floor(v) + [u < v - floor(v)], hi), v already clipped
__device__ __forceinline__ int corner(float v, float u, float hi) {
  float base = floorf(v);
  return (int)fminf(base + (u < v - base ? 1.0f : 0.0f), hi);
}

__global__ void __launch_bounds__(MT_THREADS)
megatrack_kernel(const float* __restrict__ rows,
                 const int32_t* __restrict__ ctr,
                 const uint16_t* __restrict__ table, float* __restrict__ out,
                 int32_t* __restrict__ ctr_out, int n, uint32_t seed,
                 int max_trips, int nx, int ny, int nz, int nbx, int nby,
                 int nbz) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  const size_t N = (size_t)n;
  const float* r = rows + lane;
  float* o = out + lane;
  float t = r[6 * N];
  const bool valid = r[17 * N] > 0.5f;
  const uint32_t ctr0 = (uint32_t)ctr[lane];
  if (!valid) {  // no trip: t and the counter pass through, nothing else read
    o[0] = t;
    o[N] = 1.0f;
    o[2 * N] = 1.0f;
    o[3 * N] = 1.0f;
    o[4 * N] = 0.0f;
    o[5 * N] = 0.0f;
    o[6 * N] = 0.0f;
    o[7 * N] = 0.0f;
    ctr_out[lane] = (int32_t)ctr0;
    return;
  }
  const float ox = r[0], oy = r[N], oz = r[2 * N];
  const float dx = r[3 * N], dy = r[4 * N], dz = r[5 * N];
  const float tlim = r[7 * N];
  const float maj = fmaxf(r[8 * N], 1e-12f);
  const float stm = r[9 * N];
  const float stc0 = r[10 * N], stc1 = r[11 * N], stc2 = r[12 * N];
  const float wr0 = r[13 * N], wr1 = r[14 * N], wr2 = r[15 * N];
  const bool is_sh = r[16 * N] > 0.5f;
  const int R = nbx * nby * nbz;
  const float hx = (float)(nx - 1), hy = (float)(ny - 1), hz = (float)(nz - 1);
  const uint32_t lane_x = (uint32_t)lane ^ 0x9E3779B9u;

  float f0 = 1.0f, f1 = 1.0f, f2 = 1.0f, hit = 0.0f, taps = 0.0f;
  bool live = true;
  for (int trip = 0; trip < max_trips && live; ++trip) {
    const uint32_t c = ctr0 + 5u * (uint32_t)(int32_t)taps;
    const uint32_t b0 = lowbias32(lane_x + c * 0x85EBCA6Bu + seed);
    const uint32_t b1 = lowbias32(b0 + 0x68E31DA4u);
    const uint32_t b2 = lowbias32(b1 + 0xB5297A4Du);
    const uint32_t b3 = lowbias32(b2 + 0x1B56C4E9u);
    const uint32_t b4 = lowbias32(b3 + 0x7F4A7C15u);

    const float t_new = t - logf(fmaxf(1.0f - unif(b0), 1e-12f)) / maj;
    const bool esc = t_new >= tlim;
    float px = ox + t_new * dx, py = oy + t_new * dy, pz = oz + t_new * dz;
    const bool inside = px >= 0.0f && px <= hx && py >= 0.0f && py <= hy &&
                        pz >= 0.0f && pz <= hz;
    px = fminf(fmaxf(px, 0.0f), hx);
    py = fminf(fmaxf(py, 0.0f), hy);
    pz = fminf(fmaxf(pz, 0.0f), hz);
    const int cx = corner(px, unif(b1), hx);
    const int cy = corner(py, unif(b2), hy);
    const int cz = corner(pz, unif(b3), hz);
    const int r_idx = ((cz >> 3) * nby + (cy >> 3)) * nbx + (cx >> 3);
    const int j_idx = (((cz & 7) * 8) + (cy & 7)) * 8 + (cx & 7);
    const float S =
        inside ? bf16_to_float(__ldg(table + (size_t)j_idx * R + r_idx)) : 0.0f;

    const float p_real = S * stm / maj;
    const bool real = unif(b4) < p_real && !esc && !is_sh;
    const float g0 = fmaxf(1.0f - S * stc0 / maj, 0.0f);
    const float g1 = fmaxf(1.0f - S * stc1 / maj, 0.0f);
    const float g2 = fmaxf(1.0f - S * stc2 / maj, 0.0f);
    if (real) {
      f0 = f0 * wr0;
      f1 = f1 * wr1;
      f2 = f2 * wr2;
    } else if (!esc && !is_sh) {
      const float pn = fmaxf(1.0f - p_real, 1e-12f);
      f0 = f0 * (g0 / pn);
      f1 = f1 * (g1 / pn);
      f2 = f2 * (g2 / pn);
    } else if (!esc) {
      f0 = f0 * g0;
      f1 = f1 * g1;
      f2 = f2 * g2;
    }
    t = fminf(t_new, tlim);
    if (real) hit = 1.0f;
    taps = taps + 1.0f;
    live = !(esc || real);
  }

  o[0] = t;
  o[N] = f0;
  o[2 * N] = f1;
  o[3 * N] = f2;
  o[4 * N] = hit;
  o[5 * N] = live ? 0.0f : 1.0f;
  o[6 * N] = taps;
  o[7 * N] = 0.0f;
  ctr_out[lane] = (int32_t)(ctr0 + 5u * (uint32_t)(int32_t)taps);
}

}  // namespace

extern "C" int mk_megatrack(const float* rows, const int32_t* ctr,
                            const uint16_t* table, float* out,
                            int32_t* ctr_out, int n, uint32_t seed,
                            int max_trips, int nx, int ny, int nz, int nbx,
                            int nby, int nbz, void* stream) {
  const int blocks = (n + MT_THREADS - 1) / MT_THREADS;
  megatrack_kernel<<<blocks, MT_THREADS, 0, (cudaStream_t)stream>>>(
      rows, ctr, table, out, ctr_out, n, seed, max_trips, nx, ny, nz, nbx, nby,
      nbz);
  return (int)cudaGetLastError();
}
