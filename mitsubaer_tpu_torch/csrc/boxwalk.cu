// Kernel B: the whole per-sample walk of the bounded-scattering-volume scene.
//
// Replaces mitsubaer_tpu/integrators/boxwalk.py::_kernel (boxwalk.py:153,
// launched at :562). The TPU kernel steps a (rows, lanes) state block held
// in VMEM scratch and fetches voxels and beam rows by one-hot matrix
// products on the MXU. Here a thread walks a lane with its state in
// registers, a voxel tap is one indexed load from the (512, R) bf16 brick
// table (L2-resident: 512 KB for a 64^3 grid), and the (8, 256) beam table
// sits in shared memory.
//
// What bounds it on the H100 is issue on divergent warps, not bytes or
// arithmetic. A lane's trip is one of three very unequal pieces of work:
// camera regeneration (integer modulo, divisions, a box entry), a density
// tap (nine hashes, a log, divisions, the voxel load), and at a real
// collision the heavy body (two atans, two sin/cos pairs, three exps,
// roots and a dozen divisions). With one thread walking one lane through
// its own trips, nearly every warp-trip holds a lane of each kind and pays
// for all three; and lanes ran from 10 to over 200 trips, so warps and
// blocks idled behind their longest lane. The design:
//   * persistent threads (Aila & Laine, HPG 2009): the grid fills the card
//     once; a thread whose lane is done writes its counts and takes the
//     next lane from a global counter, one atomic a warp;
//   * stages run warp by warp: regeneration and the collision body are
//     deferred. A lane that needs one waits (`stage`) while the others tap;
//     the warp runs a deferred stage for all its waiting lanes once
//     PARK of them wait, or at least as many as could tap. A waiting
//     lane's trip is already counted, so trip counts stay the plain
//     version's;
//   * a finished sample is stored into its epoch row, not added: each row
//     takes at most one sample of a lane, onto the zero the lane wrote;
//   * the random numbers of a trip are regenerated from the lane's counter
//     where they are used (the tap uses u[2..6], regeneration u[0..1], the
//     collision u[0..1] and u[7..8]): the trip's counter is ctrf - 9;
//   * the continuation of a shadow ray waits in p and d, and the shadow's
//     t and segment length in t and t_end, which mode 2 does not use.
// A finished lane draws no random numbers and `lane` is the global lane
// index, so no per-lane result depends on which thread walks it or when:
// every output equals the plain version's bit for bit (no fused
// multiply-add, the JAX kernel's own minimax atan and tan = sin/cos).
//
// Modes: 0 regenerate a camera sample, 1 extension tracking, 2 shadow ray
// ratio tracking, 3 done (4 resumes the continuation within a trip).
// Output rows (sppc*3 + 4, npix): per-epoch radiance, then per-lane
// segments, taps, trips and the last sample index.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BW_THREADS = 128;
constexpr int BW_MIN_BLOCKS = 6;   // caps registers at 65536 / (128 * 6)
// a deferred stage runs once this many lanes of the warp wait on it, or as
// many as could tap
constexpr int PARK = 8;
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int BEAM_N = 256;
constexpr int NP = 50;
constexpr float INV4PI = 0.07957747154594767f;

enum {
  P_CAMR = 0, P_CAMO = 9, P_TANX = 12, P_TANY = 13, P_BMIN = 14, P_BMAX = 17,
  P_BEAMO = 20, P_BEAMD = 23, P_BEAMP = 26, P_BS0 = 29, P_BS1 = 30, P_G = 31,
  P_SSU = 32, P_STCS = 35, P_STMS = 38, P_MAJ = 39, P_DMIN = 40, P_INVH = 43,
  P_WR = 46, P_EPS = 49
};

// what a lane waits for: nothing (its next trip), the tap of a trip whose
// regeneration ran, or the collision body of a trip whose tap ran
enum { ST_TRIP = 0, ST_TAP = 1, ST_COLLIDE = 2 };
enum { PH_TAP, PH_REGEN, PH_COLLIDE };

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 v3(const float* a) { return {a[0], a[1], a[2]}; }
__device__ __forceinline__ float dot3(V3 a, V3 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}
__device__ __forceinline__ float max3(V3 a) {
  return fmaxf(fmaxf(a.x, a.y), a.z);
}

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

// The trip's hash chain: b_{k} = lowbias32(b_{k-1} + c_k), u[k] from b_k.
// hash_start gives b before the first step; hash_step advances it by step k.
__device__ __forceinline__ uint32_t hash_start(uint32_t laneu, float ctrf,
                                               uint32_t seed) {
  const uint32_t ctr = (uint32_t)(int32_t)(ctrf - 9.0f);   // the trip's
  return laneu + ctr * 0x85EBCA6Bu + seed;
}
__device__ __forceinline__ uint32_t hash_step(uint32_t b, uint32_t k) {
  return lowbias32(b + (uint32_t)(0x68E31DA4u + 0x3504F333u * k));
}

// minimax atan of the JAX kernel (max error ~1e-5 rad)
__device__ __forceinline__ float atan_mm(float x) {
  float ax = fabsf(x);
  bool inv = ax > 1.0f;
  float z = inv ? 1.0f / fmaxf(ax, 1.0f) : ax;
  float z2 = z * z;
  float at = z * (0.9998660f + z2 * (-0.3302995f + z2 * (0.1801410f
                  + z2 * (-0.0851330f + z2 * 0.0208351f))));
  at = inv ? 1.5707963267948966f - at : at;
  return x < 0.0f ? -at : at;
}

__device__ __forceinline__ float bf16_to_float(uint16_t v) {
  return __uint_as_float(((uint32_t)v) << 16);
}

__device__ __forceinline__ void ray_aabb(const float* prm, V3 o, V3 d,
                                         float* t0, float* t1) {
  const float oa[3] = {o.x, o.y, o.z};
  const float da[3] = {d.x, d.y, d.z};
  float lo_max = 0.0f, up_min = 0.0f;
  for (int k = 0; k < 3; ++k) {
    float dk = da[k];
    float safe = fabsf(dk) < 1e-12f ? (dk < 0.0f ? -1e-12f : 1e-12f) : dk;
    float inv = 1.0f / safe;
    float ta = (prm[P_BMIN + k] - oa[k]) * inv;
    float tb = (prm[P_BMAX + k] - oa[k]) * inv;
    float lo = fminf(ta, tb), up = fmaxf(ta, tb);
    lo_max = k == 0 ? lo : fmaxf(lo_max, lo);
    up_min = k == 0 ? up : fminf(up_min, up);
  }
  *t0 = lo_max;
  *t1 = up_min;
}

__device__ __forceinline__ float hg_eval(float g, bool g_iso, float c) {
  float temp = fmaxf(1.0f + g * g - 2.0f * g * c, 1e-12f);
  float v = INV4PI * (1.0f - g * g) / (temp * sqrtf(temp));
  return g_iso ? INV4PI : v;
}

__global__ void __launch_bounds__(BW_THREADS, BW_MIN_BLOCKS)
boxwalk_kernel(const float* __restrict__ params, uint32_t seed,
               const uint16_t* __restrict__ table,
               const float* __restrict__ beam_tab, float* __restrict__ out,
               int npix, int sppc, int max_depth, int rr_depth, int W, int H,
               int stride, int nx, int ny, int nz, int nbx, int nby, int nbz,
               int max_trips, int* __restrict__ next_lane) {
  __shared__ float s_beam[8 * BEAM_N];
  __shared__ float prm[NP];
  for (int i = threadIdx.x; i < 8 * BEAM_N; i += blockDim.x)
    s_beam[i] = beam_tab[i];
  for (int i = threadIdx.x; i < NP; i += blockDim.x) prm[i] = params[i];
  __syncthreads();

  const int R = nbx * nby * nbz;
  const float maj = fmaxf(prm[P_MAJ], 1e-12f);
  const float eps = prm[P_EPS];
  const float hx = (float)(nx - 1), hy = (float)(ny - 1), hz = (float)(nz - 1);
  const int wl = threadIdx.x & 31;
  const unsigned below = (1u << wl) - 1u;
  const int first_dynamic = gridDim.x * blockDim.x;

  // lane state; in mode 2, p and d hold the continuation (x and the new
  // direction) and t and t_end the shadow ray's t and segment length
  int lane = blockIdx.x * blockDim.x + threadIdx.x;
  bool have = lane < npix;
  int m = 0, stage = ST_TRIP, trips = 0;
  bool cont_ok = false;
  float t = 0.0f, t_end = 0.0f, depth = 0.0f, idx = -1.0f;
  float segs = 0.0f, taps = 0.0f, ctrf = 0.0f;
  V3 p = {0.0f, 0.0f, 0.0f}, d = {1.0f, 1.0f, 1.0f};
  V3 tp = {0.0f, 0.0f, 0.0f}, L = {0.0f, 0.0f, 0.0f};
  V3 sh_o = {0.0f, 0.0f, 0.0f}, sh_d = {0.0f, 0.0f, 0.0f};
  V3 sh_tr = {0.0f, 0.0f, 0.0f}, sh_val = {0.0f, 0.0f, 0.0f};
  uint32_t laneu = (uint32_t)lane ^ 0x9E3779B9u;
  auto zero_rows = [&]() {
    for (int r = 0; r < sppc * 3; ++r) out[(size_t)r * npix + lane] = 0.0f;
  };
  if (have) zero_rows();

  for (;;) {
    // a lane that is done writes its counts and takes the next lane
    const bool done = have && stage == ST_TRIP && (m == 3 || trips >= max_trips);
    const unsigned done_mask = __ballot_sync(FULL, done);
    if (done_mask) {
      const int leader = __ffs(done_mask) - 1;
      int base = 0;
      if (wl == leader) base = atomicAdd(next_lane, __popc(done_mask));
      base = __shfl_sync(FULL, base, leader);
      if (done) {
        const size_t row = (size_t)sppc * 3 * npix + lane;
        out[row] = segs;
        out[row + (size_t)npix] = taps;
        out[row + 2 * (size_t)npix] = (float)trips;
        out[row + 3 * (size_t)npix] = idx;
        lane = first_dynamic + base + __popc(done_mask & below);
        have = lane < npix;
        if (have) {
          zero_rows();
          m = 0;
          trips = 0;
          idx = -1.0f;
          segs = 0.0f;
          taps = 0.0f;
          ctrf = 0.0f;
          laneu = (uint32_t)lane ^ 0x9E3779B9u;
        }
      }
    }
    if (!__any_sync(FULL, have)) break;

    // the stage this warp runs now
    const bool can_trip = have && stage == ST_TRIP && trips < max_trips;
    const unsigned col = __ballot_sync(FULL, stage == ST_COLLIDE);
    const unsigned reg = __ballot_sync(FULL, can_trip && m == 0);
    const unsigned tap =
        __ballot_sync(FULL, stage == ST_TAP || (can_trip && m != 0));
    const int n_tap = __popc(tap), n_col = __popc(col), n_reg = __popc(reg);
    int phase = PH_TAP;
    if (n_col && (n_col >= PARK || n_col >= n_tap))
      phase = PH_COLLIDE;
    else if (n_reg && (n_reg >= PARK || n_reg >= n_tap))
      phase = PH_REGEN;

    bool fin = false;
    if (phase == PH_REGEN && can_trip && m == 0) {
      // ---- mode 0: regenerate (the first part of a trip) ----
      ++trips;
      ctrf = ctrf + 9.0f;
      const uint32_t b0 = hash_step(hash_start(laneu, ctrf, seed), 0);
      const uint32_t b1 = hash_step(b0, 1);
      const bool has_more = idx + 1.0f < (float)sppc;
      if (!has_more) m = 3;
      if (has_more) {
        idx = idx + 1.0f;
        const int idxi = (int)idx;
        int pix = (lane + idxi * stride) % npix;
        float fx = (float)(pix % W) + unif(b0);
        float fy = (float)(pix / W) + unif(b1);
        float ndc_x = 2.0f * fx / (float)W - 1.0f;
        float ndc_y = 2.0f * fy / (float)H - 1.0f;
        float dc_x = -ndc_x * prm[P_TANX];
        float dc_y = -ndc_y * prm[P_TANY];
        V3 dw = {prm[P_CAMR + 0] * dc_x + prm[P_CAMR + 1] * dc_y + prm[P_CAMR + 2],
                 prm[P_CAMR + 3] * dc_x + prm[P_CAMR + 4] * dc_y + prm[P_CAMR + 5],
                 prm[P_CAMR + 6] * dc_x + prm[P_CAMR + 7] * dc_y + prm[P_CAMR + 8]};
        float nrm = sqrtf(dot3(dw, dw));
        dw = {dw.x / nrm, dw.y / nrm, dw.z / nrm};
        V3 ow = v3(prm + P_CAMO);
        float t0c, t1c;
        ray_aabb(prm, ow, dw, &t0c, &t1c);
        t0c = fmaxf(t0c, 0.0f);
        bool hitbox = t1c > t0c + 2.0f * eps;
        float s = t0c + eps;
        p = {ow.x + s * dw.x, ow.y + s * dw.y, ow.z + s * dw.z};
        d = dw;
        t = 0.0f;
        t_end = t1c - t0c - 2.0f * eps;
        tp = {1.0f, 1.0f, 1.0f};
        depth = 1.0f;
        L = {0.0f, 0.0f, 0.0f};
        segs = segs + 1.0f + (hitbox ? 1.0f : 0.0f);
        if (hitbox) {
          m = 1;
          stage = ST_TAP;   // the trip's tap follows
        }
      }
    } else if (phase == PH_TAP && (stage == ST_TAP || (can_trip && m != 0))) {
      // ---- one density tap serves the extension or the shadow ray ----
      if (stage == ST_TRIP) {
        ++trips;
        ctrf = ctrf + 9.0f;
      }
      stage = ST_TRIP;
      float u[7];
      {
        uint32_t b = hash_start(laneu, ctrf, seed);
#pragma unroll
        for (int k = 0; k < 7; ++k) {
          b = hash_step(b, (uint32_t)k);
          u[k] = unif(b);
        }
      }
      const bool shd = m == 2;
      const V3 o = shd ? sh_o : p, dd = shd ? sh_d : d;
      const float lg = logf(fmaxf(1.0f - u[2], 1e-12f));
      const float t_new = t - lg / maj;
      const V3 pos = {o.x + t_new * dd.x, o.y + t_new * dd.y,
                      o.z + t_new * dd.z};
      float S;
      {
        float vx = (pos.x - prm[P_DMIN + 0]) * prm[P_INVH + 0];
        float vy = (pos.y - prm[P_DMIN + 1]) * prm[P_INVH + 1];
        float vz = (pos.z - prm[P_DMIN + 2]) * prm[P_INVH + 2];
        bool inside = vx >= 0.0f && vx <= hx && vy >= 0.0f && vy <= hy &&
                      vz >= 0.0f && vz <= hz;
        vx = fminf(fmaxf(vx, 0.0f), hx);
        vy = fminf(fmaxf(vy, 0.0f), hy);
        vz = fminf(fmaxf(vz, 0.0f), hz);
        float bx = floorf(vx), by = floorf(vy), bz = floorf(vz);
        int cx = (int)fminf(bx + (u[3] < vx - bx ? 1.0f : 0.0f), hx);
        int cy = (int)fminf(by + (u[4] < vy - by ? 1.0f : 0.0f), hy);
        int cz = (int)fminf(bz + (u[5] < vz - bz ? 1.0f : 0.0f), hz);
        int r_idx = ((cz >> 3) * nby + (cy >> 3)) * nbx + (cx >> 3);
        int j_idx = (((cz & 7) * 8) + (cy & 7)) * 8 + (cx & 7);
        S = inside ? bf16_to_float(__ldg(table + (size_t)j_idx * R + r_idx))
                   : 0.0f;
      }
      taps = taps + 1.0f;
      const V3 factor = {fmaxf(1.0f - S * prm[P_STCS + 0] / maj, 0.0f),
                         fmaxf(1.0f - S * prm[P_STCS + 1] / maj, 0.0f),
                         fmaxf(1.0f - S * prm[P_STCS + 2] / maj, 0.0f)};
      const bool esc = t_new >= t_end;
      t = fminf(t_new, t_end);
      if (!shd) {
        // ---- mode 1: extension ----
        const float p_real = S * prm[P_STMS] / maj;
        const bool real = (u[6] < p_real) && !esc;
        if (!esc && !real) {
          float pnull = fmaxf(1.0f - p_real, 1e-12f);
          tp = {tp.x * (factor.x / pnull), tp.y * (factor.y / pnull),
                tp.z * (factor.z / pnull)};
        }
        if (esc) {
          segs = segs + 1.0f;   // vacuum exit leg
          fin = true;
        }
        if (real) stage = ST_COLLIDE;
      } else {
        // ---- mode 2: shadow ----
        if (!esc)
          sh_tr = {sh_tr.x * factor.x, sh_tr.y * factor.y, sh_tr.z * factor.z};
        const bool tr_dead = max3(sh_tr) <= 0.0f;
        if (esc || tr_dead) {
          if (!tr_dead)
            L = {L.x + sh_val.x * sh_tr.x, L.y + sh_val.y * sh_tr.y,
                 L.z + sh_val.z * sh_tr.z};
          if (cont_ok)
            m = 4;
          else
            fin = true;
        }
      }
    } else if (phase == PH_COLLIDE && stage == ST_COLLIDE) {
      // ---- the real collision of the tap (the rest of its trip) ----
      stage = ST_TRIP;
      float u0, u1, u7, u8;
      {
        uint32_t b = hash_step(hash_start(laneu, ctrf, seed), 0);
        u0 = unif(b);
        b = hash_step(b, 1);
        u1 = unif(b);
#pragma unroll
        for (int k = 2; k < 7; ++k) b = hash_step(b, (uint32_t)k);
        b = hash_step(b, 7);
        u7 = unif(b);
        b = hash_step(b, 8);
        u8 = unif(b);
      }
      const float g = prm[P_G];
      const bool g_iso = fabsf(g) < 1e-4f;
      const V3 beam_o = v3(prm + P_BEAMO), beam_d = v3(prm + P_BEAMD);
      const float bs0 = prm[P_BS0], bs1 = prm[P_BS1];
      const V3 x = {p.x + t * d.x, p.y + t * d.y, p.z + t * d.z};
      tp = {tp.x * prm[P_WR + 0], tp.y * prm[P_WR + 1], tp.z * prm[P_WR + 2]};
      const bool depth_ok = depth < (float)max_depth;

      // beam NEE (equiangular)
      const float delta = dot3({x.x - beam_o.x, x.y - beam_o.y,
                                x.z - beam_o.z}, beam_d);
      const V3 dc = {x.x - (beam_o.x + delta * beam_d.x),
                     x.y - (beam_o.y + delta * beam_d.y),
                     x.z - (beam_o.z + delta * beam_d.z)};
      const float hdist = sqrtf(fmaxf(dot3(dc, dc), 1e-12f));
      const float th_a = atan_mm((bs0 - delta) / hdist);
      const float th_b = atan_mm((bs1 - delta) / hdist);
      const float th = th_a + u7 * (th_b - th_a);
      const float cth_b = cosf(th);
      const float s_rel = hdist * sinf(th) / fmaxf(fabsf(cth_b), 1e-9f) *
                          (cth_b < 0.0f ? -1.0f : 1.0f);
      const float s_b = delta + s_rel;
      const float pdf_sb =
          hdist / fmaxf((th_b - th_a) * (hdist * hdist + s_rel * s_rel),
                        1e-12f);
      const V3 y = {beam_o.x + s_b * beam_d.x, beam_o.y + s_b * beam_d.y,
                    beam_o.z + s_b * beam_d.z};
      const V3 to_x = {x.x - y.x, x.y - y.y, x.z - y.z};
      const float dist_b = sqrtf(fmaxf(dot3(to_x, to_x), 1e-12f));
      const V3 d_yp = {to_x.x / dist_b, to_x.y / dist_b, to_x.z / dist_b};
      float fb = (s_b - bs0) / fmaxf(bs1 - bs0, 1e-9f) * (float)BEAM_N - 0.5f;
      fb = fminf(fmaxf(fb, 0.0f), (float)(BEAM_N - 1));
      const float ibf = floorf(fb);
      const float frb = fb - ibf;
      const int ib = (int)ibf;
      const bool before = s_b < bs0;
      const float* br = s_beam + ib;
      V3 tr_beam;
      tr_beam.x = expf(-(before ? 0.0f : br[0 * BEAM_N] + br[3 * BEAM_N] * frb));
      tr_beam.y = expf(-(before ? 0.0f : br[1 * BEAM_N] + br[4 * BEAM_N] * frb));
      tr_beam.z = expf(-(before ? 0.0f : br[2 * BEAM_N] + br[5 * BEAM_N] * frb));
      const float dens_y = br[6 * BEAM_N];
      const float rho_y = hg_eval(g, g_iso, dot3(beam_d, d_yp));
      const float denom = fmaxf(pdf_sb * dist_b * dist_b, 1e-12f);
      const float f_x = hg_eval(g, g_iso, dot3(d, {-d_yp.x, -d_yp.y, -d_yp.z}));
      const V3 val = {
          tp.x * f_x * (prm[P_BEAMP + 0] * tr_beam.x * (prm[P_SSU + 0] * dens_y) * rho_y / denom),
          tp.y * f_x * (prm[P_BEAMP + 1] * tr_beam.y * (prm[P_SSU + 1] * dens_y) * rho_y / denom),
          tp.z * f_x * (prm[P_BEAMP + 2] * tr_beam.z * (prm[P_SSU + 2] * dens_y) * rho_y / denom)};
      const bool nee_ok = depth_ok && max3(val) > 0.0f;

      // HG / isotropic continuation direction
      const float g_safe = g_iso ? 1.0f : g;
      const float sqr = (1.0f - g * g) / (1.0f - g + 2.0f * g * u0);
      const float cth = g_iso ? 1.0f - 2.0f * u0
                              : (1.0f + g * g - sqr * sqr) / (2.0f * g_safe);
      const float sth = sqrtf(fmaxf(1.0f - cth * cth, 0.0f));
      const float phi = 6.283185307179586f * u1;
      const float lx = sth * cosf(phi);
      const float ly = sth * sinf(phi);
      const float sgn = d.z >= 0.0f ? 1.0f : -1.0f;
      const float a_f = -1.0f / (sgn + d.z);
      const float b_f = d.x * d.y * a_f;
      const V3 new_d = {
          lx * (1.0f + sgn * d.x * d.x * a_f) + ly * b_f + cth * d.x,
          lx * (sgn * b_f) + ly * (sgn + d.y * d.y * a_f) + cth * d.y,
          lx * (-sgn * d.x) + ly * (-d.y) + cth * d.z};

      // Russian roulette
      const float q = fminf(max3(tp), 0.95f);
      const bool do_rr = depth >= (float)rr_depth;
      const bool survive = !do_rr || (u8 < q);
      if (do_rr) {
        float qd = fmaxf(q, 1e-6f);
        tp = {tp.x / qd, tp.y / qd, tp.z / qd};
      }
      const bool cont_after = depth_ok && survive;
      if (depth_ok) depth = depth + 1.0f;
      cont_ok = cont_after;
      p = x;        // the continuation
      d = new_d;
      if (nee_ok) {
        m = 2;
        sh_o = {y.x + d_yp.x * eps, y.y + d_yp.y * eps, y.z + d_yp.z * eps};
        sh_d = d_yp;
        t_end = dist_b - 2.0f * eps;   // the shadow segment
        t = 0.0f;
        sh_tr = {1.0f, 1.0f, 1.0f};
        sh_val = val;
        segs = segs + 1.0f;
      } else if (cont_after) {
        m = 4;   // resume below
      } else {
        fin = true;
      }
    }

    if (m == 4) {
      // resume the continuation
      p = {p.x + d.x * eps, p.y + d.y * eps, p.z + d.z * eps};
      float t0r, t1r;
      ray_aabb(prm, p, d, &t0r, &t1r);
      t = 0.0f;
      t_end = fmaxf(t1r - eps, 0.0f);
      m = 1;
      segs = segs + 1.0f;
    }
    if (fin) {
      // flush the finished sample into its epoch's rows: each row takes at
      // most one sample, onto the zero the lane's start wrote there
      float* o = out + (size_t)((int)idx * 3) * npix + lane;
      o[0] = 0.0f + L.x;
      o[(size_t)npix] = 0.0f + L.y;
      o[2 * (size_t)npix] = 0.0f + L.z;
      m = 0;
      L = {0.0f, 0.0f, 0.0f};
    }
  }
}

}  // namespace

// resident blocks of boxwalk_kernel a multiprocessor
extern "C" int mk_boxwalk_blocks_per_sm(int* blocks) {
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, boxwalk_kernel, BW_THREADS, 0);
}

extern "C" int mk_boxwalk(const float* params, uint32_t seed,
                          const uint16_t* table, const float* beam_tab,
                          float* out, int npix, int sppc, int max_depth,
                          int rr_depth, int W, int H, int stride, int nx,
                          int ny, int nz, int nbx, int nby, int nbz,
                          int max_trips, int* next_lane, void* stream) {
  // the grid fills the card once: resident blocks a multiprocessor times
  // multiprocessors (looked up once a device)
  static int cached_device = -1, cached_blocks = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev != cached_device) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = (cudaError_t)mk_boxwalk_blocks_per_sm(&per_sm);
    if (err != cudaSuccess) return (int)err;
    cached_blocks = sms * per_sm;
    cached_device = dev;
  }
  const int lane_blocks = (npix + BW_THREADS - 1) / BW_THREADS;
  const int blocks = cached_blocks < lane_blocks ? cached_blocks : lane_blocks;
  err = cudaMemsetAsync(next_lane, 0, sizeof(int), (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  boxwalk_kernel<<<blocks, BW_THREADS, 0, (cudaStream_t)stream>>>(
      params, seed, table, beam_tab, out, npix, sppc, max_depth, rr_depth, W,
      H, stride, nx, ny, nz, nbx, nby, nbz, max_trips, next_lane);
  return (int)cudaGetLastError();
}
