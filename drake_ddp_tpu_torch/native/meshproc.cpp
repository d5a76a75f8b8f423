// Native mesh preprocessing: OBJ vertex parsing + sphere-cover
// approximation of collision meshes.
//
// This is the host-side native layer of the model-build path — the role
// Drake's C++ geometry/tessellation machinery plays for the reference
// (SURVEY.md D3/D5): turning mesh collision geometry into the
// device-side contact primitives.  Python fallback lives in
// drake_ddp_tpu_torch/io/mesh.py; this library is the fast path for large
// model batches (system-identification sweeps load thousands of OBJs).
//
// Algorithm mirrors io/mesh.py exactly:
//  - principal axis via power iteration on the vertex covariance,
//  - slice count k = clip(ceil(extent / cross_section), 1, max_spheres),
//  - Ritter bounding sphere per slice.
//
// C ABI (ctypes):
//   int meshproc_sphere_cover(const char* obj_path, double scale,
//                             int max_spheres,
//                             double* centers /* 3*max_spheres */,
//                             double* radii   /* max_spheres */);
//   returns the number of spheres written, or -1 on error.

#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

struct V3 {
  double x, y, z;
};

bool load_obj_vertices(const char* path, double scale, std::vector<V3>* out) {
  FILE* f = std::fopen(path, "r");
  if (!f) return false;
  char line[512];
  while (std::fgets(line, sizeof line, f)) {
    if (line[0] == 'v' && (line[1] == ' ' || line[1] == '\t')) {
      double x, y, z;
      if (std::sscanf(line + 2, "%lf %lf %lf", &x, &y, &z) == 3) {
        out->push_back({x * scale, y * scale, z * scale});
      }
    }
  }
  std::fclose(f);
  return !out->empty();
}

V3 sub(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
double dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
double norm(V3 a) { return std::sqrt(dot(a, a)); }

// Ritter's approximate minimal bounding sphere (matches io/mesh.py).
void ritter(const std::vector<V3>& v, const std::vector<int>& idx,
            V3* center, double* radius) {
  const V3& p0 = v[idx[0]];
  int i1 = idx[0];
  double best = -1.0;
  for (int i : idx) {
    double d = norm(sub(v[i], p0));
    if (d > best) { best = d; i1 = i; }
  }
  int i2 = i1;
  best = -1.0;
  for (int i : idx) {
    double d = norm(sub(v[i], v[i1]));
    if (d > best) { best = d; i2 = i; }
  }
  V3 c = {0.5 * (v[i1].x + v[i2].x), 0.5 * (v[i1].y + v[i2].y),
          0.5 * (v[i1].z + v[i2].z)};
  double r = 0.5 * norm(sub(v[i2], v[i1]));
  for (int pass = 0; pass < 2; ++pass) {
    int worst = -1;
    double dmax = r;
    for (int i : idx) {
      double d = norm(sub(v[i], c));
      if (d > dmax + 1e-12) { dmax = d; worst = i; }
    }
    if (worst < 0) break;
    double nr = 0.5 * (r + dmax);
    double f = (dmax - nr) / dmax;
    c.x += f * (v[worst].x - c.x);
    c.y += f * (v[worst].y - c.y);
    c.z += f * (v[worst].z - c.z);
    r = nr;
  }
  *center = c;
  *radius = r;
}

}  // namespace

extern "C" int meshproc_sphere_cover(const char* obj_path, double scale,
                                     int max_spheres, double* centers,
                                     double* radii) {
  std::vector<V3> verts;
  if (!load_obj_vertices(obj_path, scale, &verts)) return -1;
  const size_t n = verts.size();

  V3 mean = {0, 0, 0};
  for (const V3& p : verts) { mean.x += p.x; mean.y += p.y; mean.z += p.z; }
  mean.x /= n; mean.y /= n; mean.z /= n;

  // covariance
  double C[3][3] = {{0}};
  for (const V3& p : verts) {
    const double d[3] = {p.x - mean.x, p.y - mean.y, p.z - mean.z};
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) C[i][j] += d[i] * d[j];
  }
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) C[i][j] /= n;

  // leading eigenvector by power iteration
  double a[3] = {1.0, 1.0, 1.0};
  for (int it = 0; it < 64; ++it) {
    double b[3] = {0, 0, 0};
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) b[i] += C[i][j] * a[j];
    double nb = std::sqrt(b[0] * b[0] + b[1] * b[1] + b[2] * b[2]);
    if (nb < 1e-15) break;
    for (int i = 0; i < 3; ++i) a[i] = b[i] / nb;
  }
  V3 axis = {a[0], a[1], a[2]};

  // axial coordinates + cross-sectional scale
  std::vector<double> t(n);
  double tmin = 1e300, tmax = -1e300, rad2 = 0.0;
  for (size_t i = 0; i < n; ++i) {
    V3 d = sub(verts[i], mean);
    t[i] = dot(d, axis);
    if (t[i] < tmin) tmin = t[i];
    if (t[i] > tmax) tmax = t[i];
    double r2 = dot(d, d) - t[i] * t[i];
    rad2 += (r2 > 0 ? r2 : 0);
  }
  const double extent = tmax - tmin;
  const double cross = 2.0 * (std::sqrt(rad2 / n) + 1e-9);
  int k = (int)std::ceil(extent / (cross > 1e-6 ? cross : 1e-6));
  if (k < 1) k = 1;
  if (k > max_spheres) k = max_spheres;

  int written = 0;
  if (k == 1) {
    std::vector<int> all(n);
    for (size_t i = 0; i < n; ++i) all[i] = (int)i;
    V3 c; double r;
    ritter(verts, all, &c, &r);
    centers[0] = c.x; centers[1] = c.y; centers[2] = c.z;
    radii[0] = r;
    return 1;
  }
  const double lo = tmin - 1e-9, hi = tmax + 1e-9;
  for (int s = 0; s < k; ++s) {
    const double e0 = lo + (hi - lo) * s / k;
    const double e1 = lo + (hi - lo) * (s + 1) / k;
    std::vector<int> sel;
    for (size_t i = 0; i < n; ++i)
      if (t[i] >= e0 && t[i] <= e1) sel.push_back((int)i);
    if (sel.size() < 2) continue;
    V3 c; double r;
    ritter(verts, sel, &c, &r);
    centers[3 * written + 0] = c.x;
    centers[3 * written + 1] = c.y;
    centers[3 * written + 2] = c.z;
    radii[written] = r;
    ++written;
  }
  if (written == 0) {
    std::vector<int> all(n);
    for (size_t i = 0; i < n; ++i) all[i] = (int)i;
    V3 c; double r;
    ritter(verts, all, &c, &r);
    centers[0] = c.x; centers[1] = c.y; centers[2] = c.z;
    radii[0] = r;
    written = 1;
  }
  return written;
}
