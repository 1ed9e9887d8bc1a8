// The bounce loop's shading for NVIDIA Hopper (sm_90a): one traced
// segment's miss program (receiver capture, Earth-sphere termination) and
// closest-hit program (path record, hit geometry and power leg, shading
// normal, reflection, Doppler, the RCS angles) for every lane, in one
// launch.
//
// Replaces no Pallas kernel: the programs are plain XLA in rts_tpu
// (rts_tpu/engine/wavefront.py: _process_miss, _process_hit), ported
// operation for operation to PyTorch as rts_tpu_torch/engine/wavefront.py:
// _process_miss and _process_hit, which stay as the CPU, float64 and
// parity path and as this kernel's bit-exact oracle.  It was added because
// the card's profile asked for it (PERF.md section 5): the two programs
// issued ~85% of the ~4,300 operators that rts.segment launched a terrain
// pulse, a launch each, most of them on 0-d tensors (the receivers'
// pole-wrapped windows and their sines, recomputed every segment) or
// lane-wide elementwise passes, with the card ~90% idle behind the host.
//
// What it computes, with the plain version's names, one thread a lane:
//   miss (active lanes that found no triangle): for each receiver in turn,
//     the capture-sphere roots t0 <= t1, each root's window test (the
//     sector form of angle_in_range, with the pole-wrapped second region),
//     the capture (end set before the epsilon gates), the direct or
//     indirect power leg, the range, the receiver index and its capture
//     bits; then the Earth sphere's two roots, which end the lane and add
//     to its range;
//   hit (active lanes that found one), unless `flags & kMissOnly`: the
//     gate, the path record and the chain's triangle, the hit point and
//     range, the first or later power leg, the shading normal (the three
//     corner normals interpolated and, on a ClusterScene, rotated by the
//     target's attitude; or the flat normal), the reflection, its power
//     and Doppler, and the reflection's RCS angles.
// A segment that spawns refracted children (the first two with refraction
// on) runs the miss program here and the closest-hit program in PyTorch
// (the spawn is its own layer).
//
// Design.  The segment's work is per lane with no exchange between lanes,
// so a block is 256 lanes and a thread keeps its lane's state in
// registers: read once, written once, in place (the wrapper's LaneState
// and buffers are the outputs; each thread writes only its own lane, so
// in place is race-free).  A dead lane reads its flag, range and Doppler
// and writes the last two (the hit program's +0.0 turns -0.0 into +0.0),
// nothing else.  The receivers' windows are the same for every
// lane: each block's first threads wrap them at the poles and take their
// sines and cosines into shared memory before the lanes start.  The
// scatters into the [rows, lanes] path, tri_seq and RCS buffers write one
// element of the lane's own column.
//
// What bounds it on this card: the lanes' state read and written once,
// 59 bytes read and 26 written a live lane, up to ~150 more on a hit
// (the shade row, the new origin, direction and path record), 17 a dead
// lane (chip_smoke.py: shade_bytes); ~78 MB a terrain pulse of three
// traced segments, ~23 us at 3.35 TB/s.  The sines, cosines and atan2s
// are a few hundred FP32 operations a lane at most.
//
// Numerics: built with --fmad=false (the traversal's flags), IEEE
// division and sqrtf, every product and sum rounded on its own, in the
// plain version's operation order; sinf, cosf and atan2f where it calls
// torch.sin, torch.cos and torch.atan2 (the same CUDA functions).  Python
// scalars arrive as the float32 values PyTorch passes (4 * pi, (4 * pi)^2,
// the epsilons, the Earth radius squared; pi and pi / 2 rounded here from
// the same doubles).  `1.0 / x` is torch's reciprocal, IEEE 1.0f / x.
// torch.clamp(x, min=0) keeps NaN and takes fmaxf otherwise, as here.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // lanes a block
constexpr double kPi = 3.141592653589793;  // math.pi

enum : int {
  kMissOnly = 1,    // the miss program alone (a spawn segment)
  kRcsAngles = 2,   // the reflection's RCS angles
  kSmooth = 4,      // interpolate the three corner normals
  kShadeRows = 8,   // a ClusterScene's shade rows: the target is the table's column 9 (else
                    // tri_target), the interpolated normal is rotated by the target's attitude
  kTabByLane = 16,  // the table's rows are the lanes (emitted shade rows), else triangles
};

struct Rx {        // one receiver: its sphere and the sectors of its two windows
  float cx, cy, cz, cc, r2;
  float sc[4][5];  // (sin a, cos a, sin b, cos b, sin a cos b - cos a sin b): theta1, phi1, theta2, phi2
};

struct Sh {
  // lane state [lanes] / [3, lanes] / [width, lanes], read and written in place
  float *o, *d, *sd, *tmin, *rl, *pw, *dop, *rp;
  const float* rc;
  int* refl;
  const int* refr;
  int* recv;
  float* fh;
  unsigned char *end, *act;
  int *seq, *cb, *cr;
  // hit record [lanes]
  const float *t;
  const int* tri;
  const float *beta, *gamma;
  const unsigned char* found;
  // scene: the normal table (tab[i * tab_ts + k * tab_cs], k = corner * 3 +
  // component, 9 the target) and the per-target tables
  const float* tab;
  const int* tri_target;
  const float *rot, *refl_c, *vel;
  // receivers [num_rx] / [num_rx, 3], the transmitter [3]
  const float *rxc, *rxr, *min_t, *max_t, *min_p, *max_p, *tx;
  // result buffers [depth, rows] and [2, depth, rows], in place
  int* path;
  float* rcs;
  int lanes, rows, width, depth, num_rx, num_tris, num_targets, max_refl, max_refr;
  int tab_ts, tab_cs, flags;
  float eps, eps_r, earth_r2, four_pi, four_pi_sq;
};

__device__ __forceinline__ float dot3(float ax, float ay, float az, float bx, float by, float bz) {
  return ax * bx + ay * by + az * bz;  // dot3c: (a0 b0 + a1 b1) + a2 b2
}

__device__ __forceinline__ float clamp0(float x) {  // torch.clamp(x, min=0.0)
  return isnan(x) ? x : fmaxf(x, 0.0f);
}

__device__ __forceinline__ float finite_or0(float x) {  // torch.where(torch.isfinite(x), x, 0.0)
  return isfinite(x) ? x : 0.0f;
}

__device__ void sector_of(float a, float b, float* sc) {
  const float sa = sinf(a), ca = cosf(a), sb = sinf(b), cb = cosf(b);
  sc[0] = sa;
  sc[1] = ca;
  sc[2] = sb;
  sc[3] = cb;
  sc[4] = sa * cb - ca * sb;
}

// _process_miss's per-receiver constants: the windows wrapped at the poles
// (ray_tracer.cu:342-388) and their sectors
__device__ void receiver(const Sh& p, int r, Rx& q) {
  const float pi = (float)kPi, half_pi = (float)(kPi / 2), neg_half_pi = (float)(-kPi / 2),
              neg_pi = (float)(-kPi);
  q.cx = p.rxc[3 * r];
  q.cy = p.rxc[3 * r + 1];
  q.cz = p.rxc[3 * r + 2];
  q.cc = dot3(q.cx, q.cy, q.cz, q.cx, q.cy, q.cz);
  q.r2 = p.rxr[r] * p.rxr[r];
  float max_t1 = p.max_t[r], min_t1 = p.min_t[r], max_p1 = p.max_p[r], min_p1 = p.min_p[r];
  float max_t2 = max_t1, min_t2 = min_t1, max_p2 = max_p1, min_p2 = min_p1;
  if (min_p1 < neg_half_pi) {
    max_t2 = max_t2 + pi;
    min_t2 = min_t2 + pi;
    max_p2 = neg_pi - min_p1;
    min_p2 = neg_half_pi;
    min_p1 = neg_half_pi;
  }
  if (max_p1 > half_pi) {
    max_t2 = max_t2 + pi;
    min_t2 = min_t2 + pi;
    min_p2 = pi - max_p1;
    max_p2 = half_pi;
    max_p1 = half_pi;
  }
  sector_of(min_t1, max_t1, q.sc[0]);
  sector_of(min_p1, max_p1, q.sc[1]);
  sector_of(min_t2, max_t2, q.sc[2]);
  sector_of(min_p2, max_p2, q.sc[3]);
}

// angle_in_range(atan2(v, u), a, b) without the atan2 (_sector)
__device__ __forceinline__ bool sector(float u, float v, const float* sc) {
  const float wa = u * sc[0] - v * sc[1];
  const float wb = u * sc[2] - v * sc[3];
  return (wa * wb < 0.0f) && (wa * sc[4] > 0.0f);
}

__global__ void __launch_bounds__(kThreads) shade_kernel(Sh p) {
  extern __shared__ Rx rxs[];  // num_rx of them (the wrapper takes at most 31: int32 capture bits)
  for (int r = threadIdx.x; r < p.num_rx; r += blockDim.x) receiver(p, r, rxs[r]);
  __syncthreads();
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= p.lanes) return;
  const int64_t L = p.lanes, R = p.rows;

  const bool act = p.act[l] != 0;
  if (!act) {  // every update is gated on active but the hit's +0.0 to the range and Doppler
    if (!(p.flags & kMissOnly)) {
      p.rl[l] = p.rl[l] + 0.0f;
      p.dop[l] = p.dop[l] + 0.0f;
    }
    return;
  }
  const bool fnd = p.found[l] != 0;
  const bool miss = !fnd;
  const float ox = p.o[l], oy = p.o[L + l], oz = p.o[2 * L + l];
  const float dx = p.d[l], dy = p.d[L + l], dz = p.d[2 * L + l];
  const int refl = p.refl[l], refr = p.refr[l];
  const float rl0 = p.rl[l];
  float rl = rl0, pw = p.pw[l], dop = p.dop[l];
  int recv = p.recv[l], cb = p.cb[l], cr = p.cr[l];
  bool end = p.end[l] != 0;

  // ---- miss program (ray_tracer.cu:260-477)
  const bool m_entry = miss && !end;
  const float a_q = dot3(dx, dy, dz, dx, dy, dz);
  const float oo = dot3(ox, oy, oz, ox, oy, oz);
  for (int r = 0; r < p.num_rx; ++r) {
    const Rx& q = rxs[r];
    const float b_q = 2.0f * dot3(ox - q.cx, oy - q.cy, oz - q.cz, dx, dy, dz);
    const float c_q = ((oo + q.cc) - 2.0f * dot3(ox, oy, oz, q.cx, q.cy, q.cz)) - q.r2;
    const float disc = b_q * b_q - 4.0f * a_q * c_q;
    const bool has = m_entry && disc > 0.0f;
    if (!has) continue;  // every update below is gated on it
    const float sq = sqrtf(clamp0(disc));
    const float t0 = (-b_q - sq) / (2.0f * a_q);
    const float t1 = (-b_q + sq) / (2.0f * a_q);
    bool capk[2];
    const float tk[2] = {t0, t1};
#pragma unroll
    for (int k = 0; k < 2; ++k) {  // _root_captured
      const float ti = tk[k];
      const bool okt = ti >= 0.0f && rl + ti > p.eps && rl + ti > p.eps_r;
      float x = ox + ti * dx - q.cx;
      const float y = oy + ti * dy - q.cy, z = oz + ti * dz - q.cz;
      const float rho = sqrtf(x * x + y * y);
      if (x == 0.0f && y == 0.0f) x = 1.0f;
      const bool in_win = (sector(x, y, q.sc[0]) && sector(rho, z, q.sc[1])) ||
                          (sector(x, y, q.sc[2]) && sector(rho, z, q.sc[3]));
      capk[k] = okt && in_win;
    }
    const bool cap0 = capk[0], cap = cap0 || capk[1];
    const float t_cap = cap0 ? t0 : t1;
    end = end || cap;  // set before the epsilon gates (cu:396)
    const float ex = ox + t_cap * dx, ey = oy + t_cap * dy, ez = oz + t_cap * dz;
    const bool direct = refl == 0 && refr == 0;
    const float rdx = ex - p.tx[0], rdy = ey - p.tx[1], rdz = ez - p.tx[2];
    const float rix = ex - ox, riy = ey - oy, riz = ez - oz;
    const float dd = dot3(rdx, rdy, rdz, rdx, rdy, rdz), di = dot3(rix, riy, riz, rix, riy, riz);
    const bool cap_dir = cap && direct && sqrtf(dd) >= p.eps;
    const bool cap_ind = cap && !direct && sqrtf(di) >= p.eps_r;
    if (cap_dir) {
      pw = 1.0f / (p.four_pi_sq * dd);
      dop = 0.0f;
    }
    if (cap_ind) pw = pw / (di * p.four_pi_sq);
    if (cap_dir || cap_ind) {
      rl = rl + t_cap;
      recv = r;
      cb = cb | (1 << r);
      if (cap0) cr = cr | (1 << r);
    }
  }
  // Earth-sphere termination (cu:438-477)
  if (miss && !end) {
    const float b_q = 2.0f * dot3(ox, oy, oz, dx, dy, dz);
    const float c_q = oo - p.earth_r2;
    const float disc = b_q * b_q - 4.0f * a_q * c_q;
    if (disc > 0.0f) {
      const float sq = sqrtf(clamp0(disc));
      const float te[2] = {(-b_q - sq) / (2.0f * a_q), (-b_q + sq) / (2.0f * a_q)};
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        if (te[k] >= 0.0f && rl0 > 0.0f) {
          rl = rl + te[k];
          end = true;
        }
      }
    }
  }
  p.recv[l] = recv;
  p.cb[l] = cb;
  p.cr[l] = cr;
  if (p.flags & kMissOnly) {
    p.rl[l] = rl;
    p.pw[l] = pw;
    p.dop[l] = dop;
    p.end[l] = end;
    p.act[l] = fnd;  // a miss ends its chain
    return;
  }

  // ---- closest-hit program (normal_shader.cu:128-340), no spawn
  const bool gate = fnd && !end && (refr < p.max_refr || refl < p.max_refl - 1);
  if (!gate) {  // a miss, or a hit past the gate: its range and Doppler take +0.0, and it ends
    p.rl[l] = rl + 0.0f;
    p.pw[l] = pw;
    p.dop[l] = dop + 0.0f;
    p.end[l] = end;
    p.act[l] = false;
    return;
  }
  const int tri_raw = p.tri[l];
  const int tri_c = min(max(tri_raw, 0), p.num_tris - 1);
  const float* tb = p.tab + (int64_t)((p.flags & kTabByLane) ? l : tri_c) * p.tab_ts;
  const int cs = p.tab_cs;
  const int targ = (p.flags & kShadeRows) ? (int)tb[9 * cs] : p.tri_target[tri_c];
  const int targ_s = min(max(targ, 0), p.num_targets - 1);

  // path record (normal_shader.cu:139-146)
  const int col = refl + refr;
  if (refr != 1 && col >= 0 && col < p.depth) p.path[col * R + l] = targ;
  if (col >= 0 && col < p.width) p.seq[col * L + l] = tri_raw;

  // geometry update
  const float hit_t = p.t[l];
  const float hx = ox + hit_t * dx, hy = oy + hit_t * dy, hz = oz + hit_t * dz;
  rl = rl + hit_t;
  const bool first = refl == 0 && refr == 0;
  const float lx = first ? hx - p.tx[0] : hx - ox;
  const float ly = first ? hy - p.tx[1] : hy - oy;
  const float lz = first ? hz - p.tx[2] : hz - oz;
  const float leg_sq = dot3(lx, ly, lz, lx, ly, lz);
  const bool ok_leg = sqrtf(leg_sq) >= (first ? p.eps : p.eps_r);
  if (ok_leg) pw = first ? 1.0f / (leg_sq * p.four_pi) : pw / (leg_sq * p.four_pi);
  end = end || !ok_leg;
  p.o[l] = hx;
  p.o[L + l] = hy;
  p.o[2 * L + l] = hz;
  if (first) {
    p.fh[l] = hx;
    p.fh[L + l] = hy;
    p.fh[2 * L + l] = hz;
  }

  // shading normal (triangle_mesh.cu:174-194)
  float nx, ny, nz;
  if (p.flags & kSmooth) {
    const float b = p.beta[l], g = p.gamma[l];
    const float w = 1.0f - b - g;
    nx = tb[3 * cs] * b + tb[6 * cs] * g + tb[0] * w;
    ny = tb[4 * cs] * b + tb[7 * cs] * g + tb[cs] * w;
    nz = tb[5 * cs] * b + tb[8 * cs] * g + tb[2 * cs] * w;
    if (p.flags & kShadeRows) {
      const float* r9 = p.rot + 9 * targ_s;
      const float rx = r9[0] * nx + r9[1] * ny + r9[2] * nz;
      const float ry = r9[3] * nx + r9[4] * ny + r9[5] * nz;
      const float rz = r9[6] * nx + r9[7] * ny + r9[8] * nz;
      nx = rx;
      ny = ry;
      nz = rz;
    }
  } else {
    nx = tb[0];
    ny = tb[cs];
    nz = tb[2 * cs];
  }
  float len = sqrtf(dot3(nx, ny, nz, nx, ny, nz));
  nx = finite_or0(nx / len);
  ny = finite_or0(ny / len);
  nz = finite_or0(nz / len);

  // reflection (normal_shader.cu:286-333)
  const int refl2 = refl + 1;
  const bool do_refl = refl2 < p.max_refl;
  p.rp[l] = p.rc[l];  // refrIndex.x = old .y; .y stays
  p.refl[l] = refl2;
  if (do_refl) {
    const float sx = p.sd[l], sy = p.sd[L + l], sz = p.sd[2 * L + l];
    const float dn = dot3(sx, sy, sz, nx, ny, nz);
    const float fx = sx - 2.0f * nx * dn, fy = sy - 2.0f * ny * dn, fz = sz - 2.0f * nz * dn;
    pw = pw * p.refl_c[targ_s];
    len = sqrtf(a_q);
    const float k0x = finite_or0(dx / len), k0y = finite_or0(dy / len), k0z = finite_or0(dz / len);
    len = sqrtf(dot3(fx, fy, fz, fx, fy, fz));
    const float kx = finite_or0(fx / len), ky = finite_or0(fy / len), kz = finite_or0(fz / len);
    const float* v = p.vel + 3 * targ_s;
    dop = dop + dot3(v[0], v[1], v[2], kx - k0x, ky - k0y, kz - k0z);
    const int c = (refl2 - 1) + refr;  // reflection RCS angles -> own row (cu:319-326)
    if ((p.flags & kRcsAngles) && c >= 0 && c < p.depth) {
      const float k0_azi = atan2f(k0y, k0x), k0_ele = atan2f(k0z, sqrtf(k0x * k0x + k0y * k0y));
      const float azi = atan2f(-ky, -kx), ele = atan2f(-kz, sqrtf((-kx) * (-kx) + (-ky) * (-ky)));
      p.rcs[c * R + l] = k0_azi + azi;
      p.rcs[(p.depth + c) * R + l] = k0_ele + ele;
    }
    p.d[l] = p.sd[l] = fx;
    p.d[L + l] = p.sd[L + l] = fy;
    p.d[2 * L + l] = p.sd[2 * L + l] = fz;
    p.tmin[l] = p.eps_r;
  } else {
    dop = dop + 0.0f;
  }
  p.rl[l] = rl;
  p.pw[l] = pw;
  p.dop[l] = dop;
  p.end[l] = end;
  p.act[l] = do_refl;
}

}  // namespace

extern "C" int shade_launch(
    float* o, float* d, float* sd, float* tmin, float* rl, float* pw, float* dop, float* rp,
    const float* rc, int* refl, const int* refr, int* recv, float* fh, unsigned char* end,
    unsigned char* act, int* seq, int* cb, int* cr, const float* t, const int* tri, const float* beta,
    const float* gamma, const unsigned char* found, const float* tab, const int* tri_target,
    const float* rot, const float* refl_c, const float* vel, const float* rxc, const float* rxr,
    const float* min_t, const float* max_t, const float* min_p, const float* max_p, const float* tx,
    int* path, float* rcs, int lanes, int rows, int width, int depth, int num_rx, int num_tris,
    int num_targets, int max_refl, int max_refr, int tab_ts, int tab_cs, int miss_only,
    int rcs_angles, int smooth, int shade_rows, int tab_by_lane, float eps, float eps_r,
    float earth_r2, float four_pi, float four_pi_sq, void* stream) {
  const int flags = (miss_only ? kMissOnly : 0) | (rcs_angles ? kRcsAngles : 0) | (smooth ? kSmooth : 0) |
                    (shade_rows ? kShadeRows : 0) | (tab_by_lane ? kTabByLane : 0);
  Sh p{o, d, sd, tmin, rl, pw, dop, rp, rc, refl, refr, recv, fh, end, act, seq, cb, cr,
       t, tri, beta, gamma, found, tab, tri_target, rot, refl_c, vel,
       rxc, rxr, min_t, max_t, min_p, max_p, tx, path, rcs,
       lanes, rows, width, depth, num_rx, num_tris, num_targets, max_refl, max_refr,
       tab_ts, tab_cs, flags, eps, eps_r, earth_r2, four_pi, four_pi_sq};
  shade_kernel<<<(lanes + kThreads - 1) / kThreads, kThreads, num_rx * sizeof(Rx), (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
