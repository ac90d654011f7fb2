// Native isosurface mesh extraction for TSDF volumes.
//
// Host-side C++ replacement for the reference's skimage marching_cubes_lewiner
// dependency (ref scenerf/data/utils/fusion.py:341, :368): extracts a
// triangle mesh of the `level` isosurface with per-vertex gradient normals.
// Exposed through a C ABI consumed by ctypes (scenerf_tpu_torch/fusion/meshing.py);
// built by scenerf_tpu_torch/native/build.py.
//
// Two extraction modes:
//   mode 0 (default): true marching cubes. The 256-case triangle table is
//     GENERATED at startup rather than transcribed: for each corner-sign
//     configuration, crossed cube edges are paired per face by the marching-
//     squares rule (ambiguous 4-crossing faces pair the edges around each
//     inside corner -- a function of the face's corner signs only, so the two
//     cells sharing a face always agree => watertight), the pairings are
//     walked into closed edge cycles, and each cycle is fan-triangulated.
//     Triangle counts and vertex placement match classic MC (lewiner-
//     comparable: one vertex per crossed cube edge, ~half the triangles of
//     marching tetrahedra).
//   mode 1: 6-tetrahedra cell decomposition (marching tetrahedra), kept as a
//     table-free cross-check implementation.
//
// Build: scenerf_tpu_torch/native/build.py (g++ -O3 -shared -fPIC -std=c++17).

#include <array>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

namespace {

struct V3 {
  float x, y, z;
};

// Cube corners: index bit0 = x, bit1 = y, bit2 = z.
static const int kCornerOff[8][3] = {
    {0, 0, 0}, {1, 0, 0}, {0, 1, 0}, {1, 1, 0},
    {0, 0, 1}, {1, 0, 1}, {0, 1, 1}, {1, 1, 1},
};

// The 12 cube edges as corner pairs (all pairs differing in one bit).
static const int kEdgeCorners[12][2] = {
    {0, 1}, {2, 3}, {4, 5}, {6, 7},   // x-edges
    {0, 2}, {1, 3}, {4, 6}, {5, 7},   // y-edges
    {0, 4}, {1, 5}, {2, 6}, {3, 7},   // z-edges
};

// The 6 cube faces, corners in cyclic (quad) order.
static const int kFaceCorners[6][4] = {
    {0, 2, 6, 4},  // x = 0
    {1, 3, 7, 5},  // x = 1
    {0, 1, 5, 4},  // y = 0
    {2, 3, 7, 6},  // y = 1
    {0, 1, 3, 2},  // z = 0
    {4, 5, 7, 6},  // z = 1
};

// Per-configuration isosurface polygons, as DIRECTED cycles of edge ids.
// Orientation is fixed at table-generation time from the corner signs alone:
// on every face, walked in outward-CCW corner order, each surface segment is
// directed from its inside->outside crossing to its outside->inside crossing
// (the inside region stays on the segment's left when viewed from outside
// the cube). Chaining those directed segments yields cycles whose winding
// normal points toward the INSIDE (v < level) corners; the emitter reverses
// them so triangle normals point along +gradient (toward v >= level),
// matching the per-vertex gradient normals. Because the direction rule
// depends only on the shared face's corner signs, adjacent cells traverse a
// shared polygon edge in opposite directions -- exact, mesh-consistent
// orientation with no geometric (Newell-vs-gradient) tie-breaks, which the
// old scheme could get wrong on saddle/near-zero-gradient cells.
struct MCTable {
  std::vector<std::vector<int>> cycles[256];

  MCTable() {
    // edge id lookup by corner pair
    int edge_of[8][8];
    std::memset(edge_of, -1, sizeof(edge_of));
    for (int e = 0; e < 12; e++) {
      edge_of[kEdgeCorners[e][0]][kEdgeCorners[e][1]] = e;
      edge_of[kEdgeCorners[e][1]][kEdgeCorners[e][0]] = e;
    }

    // outward-CCW corner order per face: reverse the listed quad when its
    // geometric normal (cross of the first two boundary edges) points into
    // the cube instead of out of it
    int wcorn[6][4];
    for (int f = 0; f < 6; f++) {
      const int* fc = kFaceCorners[f];
      int e1[3], e2[3], nrm[3], out[3] = {0, 0, 0};
      for (int a = 0; a < 3; a++) {
        e1[a] = kCornerOff[fc[1]][a] - kCornerOff[fc[0]][a];
        e2[a] = kCornerOff[fc[2]][a] - kCornerOff[fc[1]][a];
      }
      nrm[0] = e1[1] * e2[2] - e1[2] * e2[1];
      nrm[1] = e1[2] * e2[0] - e1[0] * e2[2];
      nrm[2] = e1[0] * e2[1] - e1[1] * e2[0];
      out[f / 2] = (f % 2) ? 1 : -1;  // face list order: -x,+x,-y,+y,-z,+z
      const bool flip =
          nrm[0] * out[0] + nrm[1] * out[1] + nrm[2] * out[2] < 0;
      for (int j = 0; j < 4; j++) wcorn[f][j] = fc[flip ? 3 - j : j];
    }

    for (int cfg = 0; cfg < 256; cfg++) {
      auto inside = [&](int c) { return (cfg >> c) & 1; };
      bool crossed[12];
      for (int e = 0; e < 12; e++)
        crossed[e] =
            inside(kEdgeCorners[e][0]) != inside(kEdgeCorners[e][1]);

      // directed successor of each crossed edge
      int nxt[12];
      for (int e = 0; e < 12; e++) nxt[e] = -1;
      for (int f = 0; f < 6; f++) {
        const int* w = wcorn[f];
        int fe[4];  // face edge j connects corner w[j] -> w[j+1]
        int k = 0;
        for (int j = 0; j < 4; j++) {
          fe[j] = edge_of[w[j]][w[(j + 1) % 4]];
          if (crossed[fe[j]]) k++;
        }
        if (k == 2) {
          // segment: from the in->out crossing to the out->in crossing
          int from = -1, to = -1;
          for (int j = 0; j < 4; j++) {
            if (!crossed[fe[j]]) continue;
            (inside(w[j]) ? from : to) = fe[j];
          }
          nxt[from] = to;
        } else if (k == 4) {
          // ambiguous face (diagonal corners share sign): one segment hugs
          // each INSIDE corner w[j], directed fe[j] -> fe[j-1] -- the same
          // in->out to out->in rule, resolved by corner signs alone, so
          // neighbor cells always agree.
          for (int j = 0; j < 4; j++)
            if (inside(w[j])) nxt[fe[j]] = fe[(j + 3) % 4];
        }
      }

      // walk directed successors into closed cycles
      bool used[12] = {false};
      for (int e0 = 0; e0 < 12; e0++) {
        if (!crossed[e0] || used[e0]) continue;
        std::vector<int> cyc;
        int cur = e0;
        do {
          cyc.push_back(cur);
          used[cur] = true;
          cur = nxt[cur];
        } while (cur != e0);
        if (cyc.size() >= 3) cycles[cfg].push_back(std::move(cyc));
      }
    }
  }
};

const MCTable& mc_table() {
  static const MCTable table;
  return table;
}

struct MeshBuilder {
  std::vector<float> verts;   // xyz triples (voxel-grid coordinates)
  std::vector<int32_t> faces; // index triples
  std::unordered_map<uint64_t, int32_t> edge_cache;

  const float* vol;
  int nx, ny, nz;
  float level;

  inline float at(int x, int y, int z) const {
    return vol[(static_cast<size_t>(x) * ny + y) * nz + z];
  }

  inline float at_clamped(int x, int y, int z) const {
    x = x < 0 ? 0 : (x >= nx ? nx - 1 : x);
    y = y < 0 ? 0 : (y >= ny ? ny - 1 : y);
    z = z < 0 ? 0 : (z >= nz ? nz - 1 : z);
    return at(x, y, z);
  }

  // Unique id of a lattice point.
  inline uint64_t point_id(int x, int y, int z) const {
    return (static_cast<uint64_t>(x) * (ny + 1) + y) * (nz + 1) + z;
  }

  // Vertex on the edge between lattice corners a and b (interpolated).
  int32_t edge_vertex(const int a[3], const int b[3]) {
    uint64_t ia = point_id(a[0], a[1], a[2]);
    uint64_t ib = point_id(b[0], b[1], b[2]);
    // exact pair packing (point ids bounded by 2^42 for any realistic grid)
    uint64_t key = (ia < ib) ? ((ia << 42) | ib) : ((ib << 42) | ia);
    auto it = edge_cache.find(key);
    if (it != edge_cache.end()) return it->second;

    float va = at(a[0], a[1], a[2]);
    float vb = at(b[0], b[1], b[2]);
    float t = (std::fabs(vb - va) > 1e-12f) ? (level - va) / (vb - va) : 0.5f;
    if (t < 0.f) t = 0.f;
    if (t > 1.f) t = 1.f;
    float px = a[0] + t * (b[0] - a[0]);
    float py = a[1] + t * (b[1] - a[1]);
    float pz = a[2] + t * (b[2] - a[2]);
    int32_t idx = static_cast<int32_t>(verts.size() / 3);
    verts.push_back(px);
    verts.push_back(py);
    verts.push_back(pz);
    edge_cache.emplace(key, idx);
    return idx;
  }

  void emit(int32_t i0, int32_t i1, int32_t i2) {
    if (i0 == i1 || i1 == i2 || i0 == i2) return;
    faces.push_back(i0);
    faces.push_back(i1);
    faces.push_back(i2);
  }

  // Process one tetrahedron given its 4 lattice corners.
  void do_tet(const int c[4][3]) {
    float v[4];
    int mask = 0;
    for (int i = 0; i < 4; i++) {
      v[i] = at(c[i][0], c[i][1], c[i][2]);
      if (v[i] < level) mask |= 1 << i;
    }
    if (mask == 0 || mask == 15) return;

    auto ev = [&](int i, int j) { return edge_vertex(c[i], c[j]); };

    // For a single "inside" corner i, the surface is the triangle on the three
    // edges leaving i; orientation fixed so winding is consistent with the
    // inside corner (then globally re-oriented by gradient normals).
    switch (mask) {
      case 1:  emit(ev(0, 1), ev(0, 2), ev(0, 3)); break;
      case 14: emit(ev(0, 2), ev(0, 1), ev(0, 3)); break;
      case 2:  emit(ev(1, 0), ev(1, 3), ev(1, 2)); break;
      case 13: emit(ev(1, 3), ev(1, 0), ev(1, 2)); break;
      case 4:  emit(ev(2, 0), ev(2, 1), ev(2, 3)); break;
      case 11: emit(ev(2, 1), ev(2, 0), ev(2, 3)); break;
      case 8:  emit(ev(3, 0), ev(3, 2), ev(3, 1)); break;
      case 7:  emit(ev(3, 2), ev(3, 0), ev(3, 1)); break;
      // two-in / two-out: quad split into two triangles
      case 3:  // corners 0,1 inside
        emit(ev(0, 2), ev(1, 2), ev(1, 3));
        emit(ev(0, 2), ev(1, 3), ev(0, 3));
        break;
      case 12:
        emit(ev(1, 2), ev(0, 2), ev(1, 3));
        emit(ev(1, 3), ev(0, 2), ev(0, 3));
        break;
      case 5:  // corners 0,2 inside
        emit(ev(0, 1), ev(2, 3), ev(2, 1));
        emit(ev(0, 1), ev(0, 3), ev(2, 3));
        break;
      case 10:
        emit(ev(2, 3), ev(0, 1), ev(2, 1));
        emit(ev(0, 3), ev(0, 1), ev(2, 3));
        break;
      case 6:  // corners 1,2 inside
        emit(ev(1, 0), ev(2, 0), ev(2, 3));
        emit(ev(1, 0), ev(2, 3), ev(1, 3));
        break;
      case 9:
        emit(ev(2, 0), ev(1, 0), ev(2, 3));
        emit(ev(1, 3), ev(2, 3), ev(1, 0));
        break;
    }
  }

  // -------------------------------------------------- marching cubes (mode 0)
  void do_cube_mc(int x, int y, int z, const float v[8]) {
    int cfg = 0;
    for (int i = 0; i < 8; i++)
      if (v[i] < level) cfg |= 1 << i;
    const auto& cycles = mc_table().cycles[cfg];
    if (cycles.empty()) return;

    for (const auto& cyc : cycles) {
      // vertex index per cycle member
      int32_t idx[12];
      const int n = static_cast<int>(cyc.size());
      for (int i = 0; i < n; i++) {
        const int* ec = kEdgeCorners[cyc[i]];
        int a[3] = {x + kCornerOff[ec[0]][0], y + kCornerOff[ec[0]][1],
                    z + kCornerOff[ec[0]][2]};
        int b[3] = {x + kCornerOff[ec[1]][0], y + kCornerOff[ec[1]][1],
                    z + kCornerOff[ec[1]][2]};
        idx[i] = edge_vertex(a, b);
      }
      // the table's directed cycles wind toward the inside (v < level)
      // region; emit the fan reversed so triangle normals point along
      // +gradient (inside -> outside), matching the per-vertex normals
      for (int i = 1; i + 1 < n; i++) emit(idx[0], idx[i + 1], idx[i]);
    }
  }

  // ---------------------------------------------- marching tetrahedra (mode 1)
  void do_cube_tetra(int x, int y, int z) {
    // 6-tet decomposition of the unit cube around the main diagonal 0-7
    // (corner bits = (x, y, z)): every tet contains both diagonal endpoints,
    // so each cube face is split along the diagonal touching corner 0 or 7 --
    // which is the same split the neighboring cube makes on its shared face
    // (its local corners 0/7 project to the same face diagonal). This makes
    // the tessellation face-compatible, hence the surface watertight.
    static const int tets[6][4] = {
        {0, 1, 3, 7}, {0, 3, 2, 7}, {0, 2, 6, 7},
        {0, 6, 4, 7}, {0, 4, 5, 7}, {0, 5, 1, 7},
    };
    for (int t = 0; t < 6; t++) {
      int c[4][3];
      for (int i = 0; i < 4; i++) {
        int corner = tets[t][i];
        c[i][0] = x + kCornerOff[corner][0];
        c[i][1] = y + kCornerOff[corner][1];
        c[i][2] = z + kCornerOff[corner][2];
      }
      do_tet(c);
    }
  }

  void run(int mode) {
    for (int x = 0; x < nx - 1; x++) {
      for (int y = 0; y < ny - 1; y++) {
        for (int z = 0; z < nz - 1; z++) {
          // fast reject: all 8 corners on one side
          float v[8];
          bool any_lo = false, any_hi = false;
          for (int i = 0; i < 8; i++) {
            v[i] = at(x + kCornerOff[i][0], y + kCornerOff[i][1],
                      z + kCornerOff[i][2]);
            if (v[i] < level) any_lo = true; else any_hi = true;
          }
          if (!(any_lo && any_hi)) continue;
          if (mode == 0)
            do_cube_mc(x, y, z, v);
          else
            do_cube_tetra(x, y, z);
        }
      }
    }
  }

  void normals(float* out) const {
    size_t nv = verts.size() / 3;
    for (size_t i = 0; i < nv; i++) {
      float px = verts[3 * i], py = verts[3 * i + 1], pz = verts[3 * i + 2];
      int x = static_cast<int>(px), y = static_cast<int>(py),
          z = static_cast<int>(pz);
      float gx = at_clamped(x + 1, y, z) - at_clamped(x - 1, y, z);
      float gy = at_clamped(x, y + 1, z) - at_clamped(x, y - 1, z);
      float gz = at_clamped(x, y, z + 1) - at_clamped(x, y, z - 1);
      float n = std::sqrt(gx * gx + gy * gy + gz * gz);
      if (n < 1e-12f) n = 1.f;
      out[3 * i] = gx / n;
      out[3 * i + 1] = gy / n;
      out[3 * i + 2] = gz / n;
    }
  }
};

}  // namespace

extern "C" {

// mode: 0 = marching cubes (default), 1 = marching tetrahedra
void* mc_run2(const float* vol, int nx, int ny, int nz, float level,
              int mode) {
  auto* mb = new MeshBuilder();
  mb->vol = vol;
  mb->nx = nx;
  mb->ny = ny;
  mb->nz = nz;
  mb->level = level;
  mb->run(mode);
  return mb;
}

// Legacy ABI: mc_run predates the mode parameter and always ran marching
// tetrahedra; it keeps that behavior (mode 1) so out-of-tree callers see
// unchanged triangle counts/topology. New callers use mc_run2.
void* mc_run(const float* vol, int nx, int ny, int nz, float level) {
  return mc_run2(vol, nx, ny, nz, level, 1);
}

void mc_counts(void* handle, int64_t* nv, int64_t* nf) {
  auto* mb = static_cast<MeshBuilder*>(handle);
  *nv = static_cast<int64_t>(mb->verts.size() / 3);
  *nf = static_cast<int64_t>(mb->faces.size() / 3);
}

void mc_copy(void* handle, float* verts, int32_t* faces, float* norms) {
  auto* mb = static_cast<MeshBuilder*>(handle);
  std::memcpy(verts, mb->verts.data(), mb->verts.size() * sizeof(float));
  std::memcpy(faces, mb->faces.data(), mb->faces.size() * sizeof(int32_t));
  mb->normals(norms);
}

void mc_free(void* handle) { delete static_cast<MeshBuilder*>(handle); }

}  // extern "C"
