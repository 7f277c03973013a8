// Native marching tetrahedra: identical algorithm to the vectorized numpy
// implementation in eval/marching.py (6-tet cube decomposition, global-edge
// vertex dedup, outward orientation), written for the large host-side
// triangulation pass of 512^3-grid mesh extraction where numpy gather
// costs dominate. A copy of mvsdf_tpu/eval/marching_tets.cpp, host code:
// tracing/kernels/build.py compiles it with the system C++ compiler and
// eval/marching_native.py binds it with ctypes.
//
// Vertices are emitted in ascending global-edge-key order (matching
// np.unique's sorted output) so the python fallback and this path produce
// identical vertex arrays.

#include <cstdint>
#include <cstdlib>
#include <cmath>
#include <unordered_map>
#include <vector>
#include <algorithm>

namespace {

// cube corners (x, y, z)
static const int CORNERS[8][3] = {
    {0, 0, 0}, {1, 0, 0}, {0, 1, 0}, {1, 1, 0},
    {0, 0, 1}, {1, 0, 1}, {0, 1, 1}, {1, 1, 1},
};

// 6-tet decomposition around the 0-7 diagonal (same as marching.py _TETS)
static const int TETS[6][4] = {
    {0, 1, 3, 7}, {0, 3, 2, 7}, {0, 2, 6, 7},
    {0, 6, 4, 7}, {0, 4, 5, 7}, {0, 5, 1, 7},
};

struct Tri {
  int64_t a[3];  // inside-endpoint global ids
  int64_t b[3];  // outside-endpoint global ids
};

// per-config triangles as (inside_vertex, outside_vertex) edge pairs,
// mirroring marching.py _tet_tables()
static void tet_tables(std::vector<std::vector<std::pair<int, int>>> tbl[16]) {
  for (int cfg = 0; cfg < 16; ++cfg) {
    int inside[4], outside[4];
    int ni = 0, no = 0;
    for (int i = 0; i < 4; ++i) {
      if ((cfg >> i) & 1)
        inside[ni++] = i;
      else
        outside[no++] = i;
    }
    auto &t = tbl[cfg];
    if (ni == 1) {
      int v = inside[0];
      t.push_back({{v, outside[0]}, {v, outside[1]}, {v, outside[2]}});
    } else if (ni == 3) {
      int v = outside[0];
      t.push_back({{inside[0], v}, {inside[2], v}, {inside[1], v}});
    } else if (ni == 2) {
      int a = inside[0], b = inside[1], c = outside[0], d = outside[1];
      t.push_back({{a, c}, {a, d}, {b, d}});
      t.push_back({{a, c}, {b, d}, {b, c}});
    }
  }
}

}  // namespace

extern "C" {

// vol: nx*ny*nz floats indexed [x][y][z] (C order). Returns number of
// vertices; fills *out_verts (3 floats per vertex in GRID units),
// *out_faces (3 int64 per face), *n_faces. Caller frees via mt_free.
int64_t marching_tets(const float *vol, int64_t nx, int64_t ny, int64_t nz,
                      float level, float **out_verts, int64_t **out_faces,
                      int64_t *n_faces) {
  std::vector<std::vector<std::pair<int, int>>> tbl[16];
  tet_tables(tbl);

  auto gid = [&](int64_t x, int64_t y, int64_t z) {
    return (x * ny + y) * nz + z;
  };

  std::vector<Tri> tris;
  tris.reserve(1 << 20);

  for (int64_t x = 0; x + 1 < nx; ++x) {
    for (int64_t y = 0; y + 1 < ny; ++y) {
      const float *col0 = vol + (x * ny + y) * nz;
      const float *col1 = vol + (x * ny + y + 1) * nz;
      const float *col2 = vol + ((x + 1) * ny + y) * nz;
      const float *col3 = vol + ((x + 1) * ny + y + 1) * nz;
      for (int64_t z = 0; z + 1 < nz; ++z) {
        float v[8];
        int64_t g[8];
        bool any_in = false, any_out = false;
        for (int c = 0; c < 8; ++c) {
          int64_t cx = x + CORNERS[c][0];
          int64_t cy = y + CORNERS[c][1];
          int64_t cz = z + CORNERS[c][2];
          const float *col =
              (CORNERS[c][0] ? (CORNERS[c][1] ? col3 : col2)
                             : (CORNERS[c][1] ? col1 : col0));
          v[c] = col[cz];
          g[c] = gid(cx, cy, cz);
          if (v[c] < level)
            any_in = true;
          else
            any_out = true;
        }
        if (!any_in || !any_out) continue;
        for (int t = 0; t < 6; ++t) {
          int cfg = 0;
          for (int i = 0; i < 4; ++i)
            if (v[TETS[t][i]] < level) cfg |= 1 << i;
          for (auto &tri : tbl[cfg]) {
            Tri out;
            for (int k = 0; k < 3; ++k) {
              out.a[k] = g[TETS[t][tri[k].first]];
              out.b[k] = g[TETS[t][tri[k].second]];
            }
            tris.push_back(out);
          }
        }
      }
    }
  }

  // dedup edge vertices by sorted global key (inside_gid * NV + outside_gid)
  const int64_t NV = nx * ny * nz;
  std::vector<int64_t> keys;
  keys.reserve(tris.size() * 3);
  for (auto &t : tris)
    for (int k = 0; k < 3; ++k) keys.push_back(t.a[k] * NV + t.b[k]);
  std::vector<int64_t> uniq = keys;
  std::sort(uniq.begin(), uniq.end());
  uniq.erase(std::unique(uniq.begin(), uniq.end()), uniq.end());
  std::unordered_map<int64_t, int64_t> idx;
  idx.reserve(uniq.size() * 2);
  for (size_t i = 0; i < uniq.size(); ++i) idx[uniq[i]] = (int64_t)i;

  float *verts = (float *)malloc(uniq.size() * 3 * sizeof(float));
  for (size_t i = 0; i < uniq.size(); ++i) {
    int64_t ka = uniq[i] / NV, kb = uniq[i] % NV;
    float va = vol[ka], vb = vol[kb];
    float denom = vb - va;
    if (std::fabs(denom) < 1e-12f) denom = denom < 0 ? -1e-12f : 1e-12f;
    float tt = (level - va) / denom;
    if (tt < 0.f) tt = 0.f;
    if (tt > 1.f) tt = 1.f;
    // gid -> (x, y, z)
    float pa[3] = {(float)(ka / (ny * nz)), (float)((ka / nz) % ny),
                   (float)(ka % nz)};
    float pb[3] = {(float)(kb / (ny * nz)), (float)((kb / nz) % ny),
                   (float)(kb % nz)};
    for (int d = 0; d < 3; ++d)
      verts[3 * i + d] = pa[d] + tt * (pb[d] - pa[d]);
  }

  // faces with orientation fix (normal . mean(outside - inside) > 0) and
  // degenerate-face removal, matching marching.py
  std::vector<int64_t> faces;
  faces.reserve(tris.size() * 3);
  for (auto &t : tris) {
    int64_t f[3];
    for (int k = 0; k < 3; ++k) f[k] = idx[t.a[k] * NV + t.b[k]];
    if (f[0] == f[1] || f[1] == f[2] || f[0] == f[2]) continue;
    const float *p0 = verts + 3 * f[0];
    const float *p1 = verts + 3 * f[1];
    const float *p2 = verts + 3 * f[2];
    float e1[3], e2[3], n[3], d[3] = {0, 0, 0};
    for (int dd = 0; dd < 3; ++dd) {
      e1[dd] = p1[dd] - p0[dd];
      e2[dd] = p2[dd] - p0[dd];
    }
    n[0] = e1[1] * e2[2] - e1[2] * e2[1];
    n[1] = e1[2] * e2[0] - e1[0] * e2[2];
    n[2] = e1[0] * e2[1] - e1[1] * e2[0];
    for (int k = 0; k < 3; ++k) {
      int64_t ka = t.a[k], kb = t.b[k];
      float pa[3] = {(float)(ka / (ny * nz)), (float)((ka / nz) % ny),
                     (float)(ka % nz)};
      float pb[3] = {(float)(kb / (ny * nz)), (float)((kb / nz) % ny),
                     (float)(kb % nz)};
      for (int dd = 0; dd < 3; ++dd) d[dd] += pb[dd] - pa[dd];
    }
    float dot = n[0] * d[0] + n[1] * d[1] + n[2] * d[2];
    if (dot < 0) std::swap(f[1], f[2]);
    faces.push_back(f[0]);
    faces.push_back(f[1]);
    faces.push_back(f[2]);
  }

  int64_t *faces_out = (int64_t *)malloc(faces.size() * sizeof(int64_t));
  std::copy(faces.begin(), faces.end(), faces_out);
  *out_verts = verts;
  *out_faces = faces_out;
  *n_faces = (int64_t)(faces.size() / 3);
  return (int64_t)uniq.size();
}

void mt_free(void *p) { free(p); }
}
