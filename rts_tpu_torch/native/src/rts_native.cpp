// rts_native — C++ host-side geometry runtime for rts_tpu_torch (a copy of
// rts_tpu's, so that the port needs nothing of the JAX package).
//
// The reference implements its entire host layer in C++ (mesh generators at
// ray_tracer.cpp:226-504, per-pulse scene assembly at :936-1118).  The port
// keeps the device path in PyTorch/CUDA and provides this native library for
// the host-side hot paths: text mesh loading (fscanf-style parsing is the
// dominant cost for >=1M-triangle file scenes), icosphere subdivision,
// Morton ordering for the cluster builder, and triangle-soup flattening.
//
// Exposed as a plain C ABI consumed via ctypes (no pybind11 in this image).

#include <array>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <map>
#include <unordered_map>
#include <utility>
#include <vector>
#include <algorithm>

namespace {

struct V3 {
  double x, y, z;
};

inline V3 norm3(V3 v) {
  double m = std::sqrt(v.x * v.x + v.y * v.y + v.z * v.z);
  if (m == 0) return v;
  return {v.x / m, v.y / m, v.z / m};
}

// yaw/pitch/roll rotation, Rz*Ry*Rx order, anti-clockwise looking down each
// axis — matches rts_tpu_torch.core.rotation.rot_zyx (ray_tracer.cpp:156-162
// semantics).
struct Rot {
  double m[3][3];
  explicit Rot(double yaw, double pitch, double roll) {
    double cy = std::cos(yaw), sy = std::sin(yaw);
    double cp = std::cos(pitch), sp = std::sin(pitch);
    double cr = std::cos(roll), sr = std::sin(roll);
    double rz[3][3] = {{cy, -sy, 0}, {sy, cy, 0}, {0, 0, 1}};
    double ry[3][3] = {{cp, 0, sp}, {0, 1, 0}, {-sp, 0, cp}};
    double rx[3][3] = {{1, 0, 0}, {0, cr, -sr}, {0, sr, cr}};
    double t[3][3];
    for (int i = 0; i < 3; i++)
      for (int j = 0; j < 3; j++) {
        t[i][j] = 0;
        for (int k = 0; k < 3; k++) t[i][j] += ry[i][k] * rx[k][j];
      }
    for (int i = 0; i < 3; i++)
      for (int j = 0; j < 3; j++) {
        m[i][j] = 0;
        for (int k = 0; k < 3; k++) m[i][j] += rz[i][k] * t[k][j];
      }
  }
  V3 apply(V3 v) const {
    return {m[0][0] * v.x + m[0][1] * v.y + m[0][2] * v.z,
            m[1][0] * v.x + m[1][1] * v.y + m[1][2] * v.z,
            m[2][0] * v.x + m[2][1] * v.y + m[2][2] * v.z};
  }
};

}  // namespace

extern "C" {

// ---------------------------------------------------------------------------
// Icosphere: icosahedron + n 4-way subdivisions, midpoint-deduped.
// verts: 10*4^n + 2, tris: 20*4^n.  Normals = unit vertex directions,
// vertices scaled by radius last, rotated by yaw/pitch/roll
// (ray_tracer.cpp:300-426 behavior).

int rts_icosphere_counts(int subdivs, int64_t* n_verts, int64_t* n_tris) {
  if (subdivs < 0 || subdivs > 10) return -1;
  int64_t f = 1;
  for (int i = 0; i < subdivs; i++) f *= 4;
  *n_verts = 10 * f + 2;
  *n_tris = 20 * f;
  return 0;
}

int rts_icosphere(int subdivs, double radius, double yaw, double pitch,
                  double roll, double* verts_out, int32_t* tris_out,
                  double* normals_out) {
  if (subdivs < 0 || subdivs > 10) return -1;
  const double t = (1.0 + std::sqrt(5.0)) / 2.0;
  std::vector<V3> verts = {
      {-1, t, 0}, {1, t, 0}, {-1, -t, 0}, {1, -t, 0},
      {0, -1, t}, {0, 1, t}, {0, -1, -t}, {0, 1, -t},
      {t, 0, -1}, {t, 0, 1}, {-t, 0, -1}, {-t, 0, 1}};
  for (auto& v : verts) v = norm3(v);
  std::vector<std::array<int64_t, 3>> tris = {
      {0, 11, 5}, {0, 5, 1},  {0, 1, 7},   {0, 7, 10}, {0, 10, 11},
      {1, 5, 9},  {5, 11, 4}, {11, 10, 2}, {10, 7, 6}, {7, 1, 8},
      {3, 9, 4},  {3, 4, 2},  {3, 2, 6},   {3, 6, 8},  {3, 8, 9},
      {4, 9, 5},  {2, 4, 11}, {6, 2, 10},  {8, 6, 7},  {9, 8, 1}};

  std::map<std::pair<int64_t, int64_t>, int64_t> midpoint;
  auto mid = [&](int64_t a, int64_t b) -> int64_t {
    auto key = std::make_pair(std::min(a, b), std::max(a, b));
    auto it = midpoint.find(key);
    if (it != midpoint.end()) return it->second;
    V3 m = norm3({(verts[a].x + verts[b].x) / 2, (verts[a].y + verts[b].y) / 2,
                  (verts[a].z + verts[b].z) / 2});
    verts.push_back(m);
    int64_t idx = (int64_t)verts.size() - 1;
    midpoint.emplace(key, idx);
    return idx;
  };

  for (int s = 0; s < subdivs; s++) {
    std::vector<std::array<int64_t, 3>> next;
    next.reserve(tris.size() * 4);
    for (auto& tr : tris) {
      int64_t a = mid(tr[0], tr[1]);
      int64_t b = mid(tr[1], tr[2]);
      int64_t c = mid(tr[2], tr[0]);
      next.push_back({tr[0], a, c});
      next.push_back({tr[1], b, a});
      next.push_back({tr[2], c, b});
      next.push_back({a, b, c});
    }
    tris.swap(next);
  }

  Rot rot(yaw, pitch, roll);
  for (size_t i = 0; i < verts.size(); i++) {
    V3 n = rot.apply(verts[i]);  // unit normal, rotated
    V3 p = {n.x * radius, n.y * radius, n.z * radius};
    verts_out[3 * i] = p.x;
    verts_out[3 * i + 1] = p.y;
    verts_out[3 * i + 2] = p.z;
    normals_out[3 * i] = n.x;
    normals_out[3 * i + 1] = n.y;
    normals_out[3 * i + 2] = n.z;
  }
  for (size_t i = 0; i < tris.size(); i++) {
    tris_out[3 * i] = (int32_t)tris[i][0];
    tris_out[3 * i + 1] = (int32_t)tris[i][1];
    tris_out[3 * i + 2] = (int32_t)tris[i][2];
  }
  return 0;
}

// ---------------------------------------------------------------------------
// Text mesh loader: whitespace/comma-separated doubles, 3 per line, one
// vertex per line, triangles implicit as consecutive vertex triples
// (file_mesh format, ray_tracer.cpp:429-504).  Two-phase: count, then fill.

// One-pass strtod stream: any run of spaces/commas/newlines separates
// values (tolerates the reference's trailing commas).
static int64_t parse_doubles(const char* path, double* out, int64_t max_vals) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  std::fseek(f, 0, SEEK_END);
  long sz = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  std::vector<char> buf(sz + 1);
  if (sz > 0 && std::fread(buf.data(), 1, sz, f) != (size_t)sz) {
    std::fclose(f);
    return -2;
  }
  std::fclose(f);
  buf[sz] = '\0';
  char* p = buf.data();
  char* end = buf.data() + sz;
  int64_t count = 0;
  while (p < end) {
    while (p < end && (*p == ' ' || *p == ',' || *p == '\t' || *p == '\n' || *p == '\r')) p++;
    if (p >= end) break;
    char* next;
    double v = std::strtod(p, &next);
    if (next == p) break;  // unparseable token — stop
    if (out) {
      if (count >= max_vals) return -3;
      out[count] = v;
    }
    count++;
    p = next;
  }
  return count;
}

int64_t rts_count_triplets(const char* path) {
  int64_t vals = parse_doubles(path, nullptr, 0);
  if (vals < 0) return vals;
  return vals / 3;
}

int rts_load_triplets(const char* path, int64_t n, double* out) {
  int64_t vals = parse_doubles(path, out, 3 * n);
  return (vals == 3 * n) ? 0 : -2;
}

// ---------------------------------------------------------------------------
// Morton order of triangle centroids (30-bit interleave), stable argsort.

static inline uint64_t expand_bits(uint64_t v) {
  v = (v * 0x00010001ULL) & 0xFF0000FFULL;
  v = (v * 0x00000101ULL) & 0x0F00F00FULL;
  v = (v * 0x00000011ULL) & 0xC30C30C3ULL;
  v = (v * 0x00000005ULL) & 0x49249249ULL;
  return v;
}

int rts_morton_order(const double* tri_verts /* [T,3,3] */, int64_t t,
                     int64_t* perm_out) {
  if (t <= 0) return 0;
  std::vector<double> cx(t), cy(t), cz(t);
  double lo[3] = {1e300, 1e300, 1e300}, hi[3] = {-1e300, -1e300, -1e300};
  for (int64_t i = 0; i < t; i++) {
    const double* v = tri_verts + 9 * i;
    cx[i] = (v[0] + v[3] + v[6]) / 3.0;
    cy[i] = (v[1] + v[4] + v[7]) / 3.0;
    cz[i] = (v[2] + v[5] + v[8]) / 3.0;
    lo[0] = std::min(lo[0], cx[i]); hi[0] = std::max(hi[0], cx[i]);
    lo[1] = std::min(lo[1], cy[i]); hi[1] = std::max(hi[1], cy[i]);
    lo[2] = std::min(lo[2], cz[i]); hi[2] = std::max(hi[2], cz[i]);
  }
  double span[3];
  for (int k = 0; k < 3; k++) span[k] = (hi[k] > lo[k]) ? hi[k] - lo[k] : 1.0;
  std::vector<uint64_t> code(t);
  for (int64_t i = 0; i < t; i++) {
    auto q = [&](double c, int k) -> uint64_t {
      double u = (c - lo[k]) / span[k] * 1023.0;
      if (u < 0) u = 0;
      if (u > 1023) u = 1023;
      return (uint64_t)u;
    };
    code[i] = (expand_bits(q(cx[i], 0)) << 2) | (expand_bits(q(cy[i], 1)) << 1) |
              expand_bits(q(cz[i], 2));
  }
  for (int64_t i = 0; i < t; i++) perm_out[i] = i;
  std::stable_sort(perm_out, perm_out + t,
                   [&](int64_t a, int64_t b) { return code[a] < code[b]; });
  return 0;
}

// ---------------------------------------------------------------------------
// Triangle-soup flatten: verts[V,3] + tris[T,3] -> corners[T,3,3], with an
// optional permutation applied (fused gather for the scene compiler).

int rts_flatten(const double* verts, const int32_t* tris, int64_t t,
                const int64_t* perm /* nullable */, double* corners_out) {
  for (int64_t i = 0; i < t; i++) {
    int64_t src = perm ? perm[i] : i;
    for (int c = 0; c < 3; c++) {
      const double* v = verts + 3 * (int64_t)tris[3 * src + c];
      double* o = corners_out + 9 * i + 3 * c;
      o[0] = v[0];
      o[1] = v[1];
      o[2] = v[2];
    }
  }
  return 0;
}

}  // extern "C"
