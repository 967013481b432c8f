// meshcore: native mesh/topology routines for pynama_tpu_torch.
//
// A copy of native/meshcore.cpp, the JAX package's. Upstream Pynama
// delegates mesh topology, entity numbering and high-order DoF layout to
// the PETSc DMPlex/Section C library (src/domain/dmplex.py:8-61,
// src/domain/indices.py:22-122). This is the equivalent host component:
// it computes the global Gauss-Lobatto-Legendre node numbering over
// unstructured quad/hex meshes (shared-edge/face deduplication with
// consistent orientation) and structured-box connectivity tables. Exposed
// through a plain C ABI, built with g++ at first use and loaded from
// Python with ctypes; a pure-Python mirror has the same semantics
// (pynama_tpu_torch/mesh/native.py).
//
// Numbering layout (2D quads, ngl = N):
//   [0, nverts)                      corner vertices (input ids)
//   [nverts, nverts + nedges*(N-2))  edge nodes, ordered from the edge's
//                                    lower to higher corner id
//   [... , +ncells*(N-2)^2)          cell-interior nodes, lexicographic
// Local (per-cell) ordering is lexicographic: n = ly*N + lx with corners
// c0=(0,0) c1=(N-1,0) c2=(0,N-1) c3=(N-1,N-1).

#include <algorithm>
#include <array>
#include <cstddef>
#include <cstdint>
#include <map>
#include <unordered_map>
#include <vector>

extern "C" {

// Structured box connectivity: cell2node for an nx x ny element grid.
// out must hold nx*ny*N*N int64.
void box_cell2node_2d(int64_t nx, int64_t ny, int64_t N, int64_t* out) {
  const int64_t Wx = nx * (N - 1) + 1;
  int64_t* p = out;
  for (int64_t ey = 0; ey < ny; ++ey) {
    for (int64_t ex = 0; ex < nx; ++ex) {
      const int64_t origin = ey * (N - 1) * Wx + ex * (N - 1);
      for (int64_t ly = 0; ly < N; ++ly)
        for (int64_t lx = 0; lx < N; ++lx) *p++ = origin + ly * Wx + lx;
    }
  }
}

// High-order numbering for an unstructured 2D quad mesh.
//   cells:      (ncells, 4) corner ids, lexicographic corner order
//   cell2node:  out, (ncells, N*N)
//   edge_pairs: out, (max_edges, 2) corner ids (lower, higher) per edge —
//               used by Python to place edge-node coordinates; pass
//               max_edges >= 4*ncells.
// Returns the total number of global nodes, or -1 on error.
int64_t quad_highorder_numbering(int64_t ncells, int64_t nverts,
                                 const int64_t* cells, int64_t N,
                                 int64_t* cell2node, int64_t* edge_pairs,
                                 int64_t* n_edges_out) {
  if (N < 2) return -1;
  const int64_t ni = N - 2;  // nodes per edge interior
  std::unordered_map<uint64_t, int64_t> edge_ids;
  edge_ids.reserve(static_cast<size_t>(4 * ncells));
  int64_t n_edges = 0;

  // local edges as (corner index a, corner index b, base local (lx,ly),
  // step (dx,dy)) walking a->b excluding endpoints
  struct LocalEdge {
    int a, b, lx, ly, dx, dy;
  };
  const LocalEdge edges[4] = {
      {0, 1, 1, 0, 1, 0},                         // bottom: c0 -> c1
      {2, 3, 1, static_cast<int>(N - 1), 1, 0},   // top:    c2 -> c3
      {0, 2, 0, 1, 0, 1},                         // left:   c0 -> c2
      {1, 3, static_cast<int>(N - 1), 1, 0, 1},   // right:  c1 -> c3
  };

  for (int64_t e = 0; e < ncells; ++e) {
    const int64_t* c = cells + 4 * e;
    int64_t* out = cell2node + e * N * N;
    // corners
    out[0] = c[0];
    out[N - 1] = c[1];
    out[(N - 1) * N] = c[2];
    out[(N - 1) * N + (N - 1)] = c[3];
    // edges
    for (const LocalEdge& le : edges) {
      const int64_t a = c[le.a], b = c[le.b];
      const int64_t lo = a < b ? a : b;
      const int64_t hi = a < b ? b : a;
      const uint64_t key =
          static_cast<uint64_t>(lo) * static_cast<uint64_t>(nverts) +
          static_cast<uint64_t>(hi);
      auto it = edge_ids.find(key);
      int64_t eid;
      if (it == edge_ids.end()) {
        eid = n_edges++;
        edge_ids.emplace(key, eid);
        edge_pairs[2 * eid] = lo;
        edge_pairs[2 * eid + 1] = hi;
      } else {
        eid = it->second;
      }
      const int64_t base = nverts + eid * ni;
      const bool forward = (a == lo);  // local walk matches lo->hi order
      for (int64_t k = 0; k < ni; ++k) {
        const int64_t lx = le.lx + k * le.dx;
        const int64_t ly = le.ly + k * le.dy;
        const int64_t g = forward ? base + k : base + (ni - 1 - k);
        out[ly * N + lx] = g;
      }
    }
    // interior
    const int64_t ibase = nverts + /*placeholder*/ 0;  // fixed after loop
    (void)ibase;
    for (int64_t ly = 1; ly < N - 1; ++ly)
      for (int64_t lx = 1; lx < N - 1; ++lx)
        out[ly * N + lx] = -(e * ni * ni + (ly - 1) * ni + (lx - 1)) - 1;
  }

  // second pass: rebase interior ids now that n_edges is known
  const int64_t interior0 = nverts + n_edges * ni;
  for (int64_t i = 0; i < ncells * N * N; ++i) {
    if (cell2node[i] < 0) cell2node[i] = interior0 + (-cell2node[i] - 1);
  }
  *n_edges_out = n_edges;
  return interior0 + ncells * ni * ni;
}

// High-order numbering for an unstructured 3D hex mesh.
//   cells:      (ncells, 8) corner ids, LEXICOGRAPHIC corner order
//               (bit 0 = x, bit 1 = y, bit 2 = z)
//   cell2node:  out, (ncells, N^3); local id = (lz*N + ly)*N + lx
//   edge_pairs: out, (12*ncells, 2) (lower, higher) per deduplicated edge
//   face_quads: out, (6*ncells, 4) [anchor, u-neighbor, v-neighbor, diag]
//               in the canonical frame: anchor = smallest corner id, u
//               axis toward the smaller in-face neighbor — every incident
//               cell maps onto this frame, so shared faces agree node by
//               node regardless of local orientation (the role of the
//               reference's Section orientation handling, indices.py:66-88).
//   counts_out: out, {n_edges, n_faces}
// Returns the total number of global nodes, or -1 on error.
int64_t hex_highorder_numbering(int64_t ncells, int64_t nverts,
                                const int64_t* cells, int64_t N,
                                int64_t* cell2node, int64_t* edge_pairs,
                                int64_t* face_quads, int64_t* counts_out) {
  if (N < 2) return -1;
  const int64_t ni = N - 2;
  const int64_t nn = N * N * N;
  const int64_t BAND = int64_t(1) << 60;

  std::unordered_map<uint64_t, int64_t> edge_ids;
  edge_ids.reserve(static_cast<size_t>(12 * ncells));
  int64_t n_edges = 0;
  std::map<std::array<int64_t, 4>, int64_t> face_ids;
  int64_t n_faces = 0;

  // 12 edges: (corner a, corner b, axis), a < b along axis
  const int HEX_EDGES[12][3] = {
      {0, 1, 0}, {2, 3, 0}, {4, 5, 0}, {6, 7, 0},
      {0, 2, 1}, {1, 3, 1}, {4, 6, 1}, {5, 7, 1},
      {0, 4, 2}, {1, 5, 2}, {2, 6, 2}, {3, 7, 2}};
  // 6 faces: (fixed axis, side)
  const int HEX_FACES[6][2] = {{0, 0}, {0, 1}, {1, 0},
                               {1, 1}, {2, 0}, {2, 1}};

  auto local_id = [N](int64_t lx, int64_t ly, int64_t lz) {
    return (lz * N + ly) * N + lx;
  };

  for (int64_t e = 0; e < ncells; ++e) {
    const int64_t* c = cells + 8 * e;
    int64_t* out = cell2node + e * nn;
    // corners
    for (int k = 0; k < 8; ++k) {
      const int64_t bx = k & 1, by = (k >> 1) & 1, bz = (k >> 2) & 1;
      out[local_id(bx * (N - 1), by * (N - 1), bz * (N - 1))] = c[k];
    }
    if (ni > 0) {
      // edges
      for (const auto& ed : HEX_EDGES) {
        const int64_t a = c[ed[0]], b = c[ed[1]];
        const int64_t lo = a < b ? a : b;
        const int64_t hi = a < b ? b : a;
        const uint64_t key =
            static_cast<uint64_t>(lo) * static_cast<uint64_t>(nverts) +
            static_cast<uint64_t>(hi);
        auto it = edge_ids.find(key);
        int64_t eid;
        if (it == edge_ids.end()) {
          eid = n_edges++;
          edge_ids.emplace(key, eid);
          edge_pairs[2 * eid] = lo;
          edge_pairs[2 * eid + 1] = hi;
        } else {
          eid = it->second;
        }
        const int64_t base = nverts + eid * ni;
        const bool forward = (a == lo);
        int64_t pos[3];
        const int ka = ed[0];
        pos[0] = (ka & 1) * (N - 1);
        pos[1] = ((ka >> 1) & 1) * (N - 1);
        pos[2] = ((ka >> 2) & 1) * (N - 1);
        for (int64_t k = 0; k < ni; ++k) {
          pos[ed[2]] = k + 1;
          const int64_t g = forward ? base + k : base + (ni - 1 - k);
          out[local_id(pos[0], pos[1], pos[2])] = g;
        }
      }
      // faces
      for (const auto& fc : HEX_FACES) {
        const int fax = fc[0], side = fc[1];
        int tu = -1, tv = -1;
        for (int ax = 0; ax < 3; ++ax)
          if (ax != fax) (tu < 0 ? tu : tv) = ax;
        // corner id at local face position (su, sv)
        auto corner_at = [&](int su, int sv) {
          int bits[3] = {0, 0, 0};
          bits[fax] = side;
          bits[tu] = su;
          bits[tv] = sv;
          return c[bits[0] + 2 * bits[1] + 4 * bits[2]];
        };
        int64_t ids[2][2];
        for (int su = 0; su < 2; ++su)
          for (int sv = 0; sv < 2; ++sv) ids[su][sv] = corner_at(su, sv);
        std::array<int64_t, 4> key = {ids[0][0], ids[0][1], ids[1][0],
                                      ids[1][1]};
        std::sort(key.begin(), key.end());
        auto it = face_ids.find(key);
        int64_t fid;
        if (it == face_ids.end()) {
          fid = n_faces++;
          face_ids.emplace(key, fid);
          // canonical frame: anchor = min id; u toward smaller neighbor
          int au = 0, av = 0;
          for (int su = 0; su < 2; ++su)
            for (int sv = 0; sv < 2; ++sv)
              if (ids[su][sv] < ids[au][av]) { au = su; av = sv; }
          int64_t id_u = ids[1 - au][av], id_v = ids[au][1 - av];
          if (id_u > id_v) std::swap(id_u, id_v);
          face_quads[4 * fid + 0] = ids[au][av];
          face_quads[4 * fid + 1] = id_u;
          face_quads[4 * fid + 2] = id_v;
          face_quads[4 * fid + 3] = ids[1 - au][1 - av];
        } else {
          fid = it->second;
        }
        // map canonical (i, j) onto this cell's local coords
        const int64_t anchor_id = face_quads[4 * fid];
        const int64_t u_id = face_quads[4 * fid + 1];
        int au = 0, av = 0;
        for (int su = 0; su < 2; ++su)
          for (int sv = 0; sv < 2; ++sv)
            if (ids[su][sv] == anchor_id) { au = su; av = sv; }
        const bool swap_uv = (ids[1 - au][av] != u_id);
        const int64_t fbase = fid * ni * ni;
        for (int64_t j = 1; j < N - 1; ++j) {
          for (int64_t i = 1; i < N - 1; ++i) {
            const int64_t ii = swap_uv ? j : i;
            const int64_t jj = swap_uv ? i : j;
            const int64_t pu = au == 0 ? ii : N - 1 - ii;
            const int64_t pv = av == 0 ? jj : N - 1 - jj;
            int64_t pos[3];
            pos[fax] = int64_t(side) * (N - 1);
            pos[tu] = pu;
            pos[tv] = pv;
            out[local_id(pos[0], pos[1], pos[2])] =
                -(fbase + (j - 1) * ni + (i - 1)) - 1;
          }
        }
      }
      // cell interior: provisional band
      for (int64_t lz = 1; lz < N - 1; ++lz)
        for (int64_t ly = 1; ly < N - 1; ++ly)
          for (int64_t lx = 1; lx < N - 1; ++lx)
            out[local_id(lx, ly, lz)] =
                -(e * ni * ni * ni + ((lz - 1) * ni + (ly - 1)) * ni +
                  (lx - 1)) - 1 - BAND;
    }
  }

  const int64_t face0 = nverts + n_edges * ni;
  const int64_t int0 = face0 + n_faces * ni * ni;
  for (int64_t i = 0; i < ncells * nn; ++i) {
    const int64_t v = cell2node[i];
    if (v <= -BAND) {
      cell2node[i] = int0 + (-(v + BAND) - 1);
    } else if (v < 0) {
      cell2node[i] = face0 + (-v - 1);
    }
  }
  counts_out[0] = n_edges;
  counts_out[1] = n_faces;
  return int0 + ncells * ni * ni * ni;
}

}  // extern "C"
