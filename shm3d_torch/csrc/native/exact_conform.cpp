// Exact-predicate conforming surface recovery for the Kuhn-lattice stuffing
// mesher (replaces the tolerance-ladder walk in lattice_tet.cpp's
// recover_edge/recover_face for real scanned inputs).
//
// The reference obtains a surface-conforming tet mesh from TetGen's
// constrained Delaunay with facet preservation
// (reference src/signed_heat_tet_solver.cpp:885-1016, TETFLAGS_PRESERVE
// :967); TetGen's boundary recovery rests on Shewchuk-style exact orientation
// predicates.  The previous walk here classified geometry with a tolerance
// ladder and repaired inconsistencies with snaps/welds/collapses — measured
// on the reference scans, the repairs themselves manufactured micro-geometry
// (plane distances ~1e-13 under a 3.7e-8 tolerance) and every scan failed.
//
// This module removes the possibility of inconsistency instead of repairing
// it:
//   * every vertex coordinate is quantized to an integer lattice with
//     2^24 quanta per cell (delta ~ 6e-8 h, far below the recovery tolerance
//     ladder and far above nothing — positions are exact int64 triples);
//   * the only geometric predicate is orient3d evaluated exactly in
//     __int128 (coordinates <= 2^32 => determinant <= 2^99 < 2^127);
//   * vertices never move after creation: no snapping, no welds, no
//     collapses — the split primitives (1-4, face 2-6, edge ring) each
//     verify their children exactly positive, so the mesh is a valid
//     complex at every step and predicates can never contradict each other;
//   * constraint *classification* (piercing slabs, in-triangle cushions,
//     the extraction certificate) remains double precision with cushions —
//     a misjudged marginal crossing merely splits or skips one edge, and
//     the area certificate arbitrates, exactly as in the tolerance design
//     (shm3d/tet/conforming.py docstring).
//
// Exposed as shm3d_conforming_build_exact with the shared ShmResult handle
// contract (shm3d_common.h); shm3d/tet/native.py prefers it over the legacy
// walk when present.

#include <chrono>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <algorithm>
#include <array>
#include <set>
#include <string>
#include <unordered_map>
#include <unordered_set>
#include <vector>

#include "shm3d_common.h"

namespace exactconf {

using std::int64_t;
using i128 = __int128;

constexpr int QSHIFT = 24;                    // quanta per lattice cell: 2^24
constexpr int64_t QUNIT = int64_t(1) << QSHIFT;
constexpr double SNAP_ALPHA = 0.35;           // source-vertex snap radius / h
// Tolerance ladder (quanta; delta = h / 2^24).  Every inserted recovery
// point keeps DEDUP_Q clearance from all vertices (exact-range vgrid query)
// and CLEAR_Q clearance from the exit face's edges — so the minimum feature
// size the recovery can create is ~64 delta, cascades of ever-thinner
// slivers cannot form, and every classification threshold sits two orders
// of magnitude above the quantization noise.  Chain points may deviate
// laterally from the true constraint by <= CLEAR_Q delta ~ 1.2e-5 h, far
// below the O(h^2) FEM discretization error and inside the piercing slab.
constexpr double DEDUP_Q = 64.0;              // vertex dedup / graze ball
constexpr double CLEAR_Q = 192.0;             // feature clearance for inserts
constexpr double TOL_P = 384.0 / (double)QUNIT;  // piercing slab + corridor / h
constexpr double TOL_E = 2.5e-4;              // on-plane membership / h
// (CERT 2e-3 per-face slack superseded by the two-tier CERT_FACE_HARD/CERT_TOTAL)

constexpr int KUHN[6][4] = {
    {0, 1, 3, 7}, {0, 3, 2, 7}, {0, 2, 6, 7},
    {0, 6, 4, 7}, {0, 4, 5, 7}, {0, 5, 1, 7},
};
// inward-oriented face opposite vertex j: orient(f0,f1,f2,t_j) > 0 for a
// positively oriented tet (t0,t1,t2,t3)
constexpr int OPP_IN[4][3] = {{1, 3, 2}, {0, 2, 3}, {0, 3, 1}, {0, 1, 2}};

struct V3 {
  double x, y, z;
  V3 operator-(const V3& o) const { return {x - o.x, y - o.y, z - o.z}; }
  V3 operator+(const V3& o) const { return {x + o.x, y + o.y, z + o.z}; }
  V3 operator*(double s) const { return {x * s, y * s, z * s}; }
};
inline double dot(const V3& a, const V3& b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
inline V3 cross(const V3& a, const V3& b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
inline double norm(const V3& a) { return std::sqrt(dot(a, a)); }

struct Q3 {
  int64_t x, y, z;
  bool operator==(const Q3& o) const { return x == o.x && y == o.y && z == o.z; }
};
struct QHash {
  size_t operator()(const Q3& q) const {
    // splitmix-style mix of the three coordinates
    uint64_t h = (uint64_t)q.x * 0x9E3779B97F4A7C15ull;
    h ^= (uint64_t)q.y + 0x9E3779B97F4A7C15ull + (h << 6) + (h >> 2);
    h *= 0xBF58476D1CE4E5B9ull;
    h ^= (uint64_t)q.z + 0x94D049BB133111EBull + (h << 6) + (h >> 2);
    return (size_t)(h ^ (h >> 31));
  }
};

inline int sgn(i128 v) { return (v > 0) - (v < 0); }
inline double d128(i128 v) {
  return (double)(long long)(v >> 64) * 18446744073709551616.0 +
         (double)(unsigned long long)(v & ~(uint64_t)0);
}

// exact sign of det[b-a, c-a, d-a] (= 6 * signed volume of (a,b,c,d)).
// |coords| <= 2^32 => cross components <= 2^66, dot <= 2^99: fits __int128.
inline i128 orient(const Q3& a, const Q3& b, const Q3& c, const Q3& d) {
  const int64_t bx = b.x - a.x, by = b.y - a.y, bz = b.z - a.z;
  const int64_t cx = c.x - a.x, cy = c.y - a.y, cz = c.z - a.z;
  const int64_t dx = d.x - a.x, dy = d.y - a.y, dz = d.z - a.z;
  const i128 nx = (i128)by * cz - (i128)bz * cy;
  const i128 ny = (i128)bz * cx - (i128)bx * cz;
  const i128 nz = (i128)bx * cy - (i128)by * cx;
  return nx * dx + ny * dy + nz * dz;
}

struct XFail {
  const char* what;
  explicit XFail(const char* w) : what(w) {}
};

struct Loc {
  int type;   // 0 outside, 1 interior, 2 on face a, 3 on edge (faces a,b), 4 vertex a
  int a, b;
};

struct XMesh {
  int nl, npts;
  double h, delta;
  V3 bmin;
  std::vector<Q3> q;                                   // vertex coords (exact)
  std::unordered_map<Q3, int64_t, QHash> vhash;        // exact position -> vid
  // uniform vertex grid (bucket = 2^VG_SHIFT quanta = h/64) for exact-range
  // proximity queries — the dedup-ball discipline must see EVERY vertex, not
  // just the local star (two chains from different source edges can pass
  // within a few quanta of each other)
  static constexpr int VG_SHIFT = 18;
  std::unordered_map<int64_t, std::vector<int64_t>> vgrid;

  static int64_t vg_key(int64_t bx, int64_t by, int64_t bz) {
    return (bx << 40) | (by << 20) | bz;
  }
  void vg_add(int64_t vid) {
    const Q3& p = q[vid];
    vgrid[vg_key(p.x >> VG_SHIFT, p.y >> VG_SHIFT, p.z >> VG_SHIFT)].push_back(vid);
  }
  void vg_remove(int64_t vid) {
    const Q3& p = q[vid];
    auto it = vgrid.find(vg_key(p.x >> VG_SHIFT, p.y >> VG_SHIFT, p.z >> VG_SHIFT));
    if (it == vgrid.end()) return;
    auto& v = it->second;
    for (size_t i = 0; i < v.size(); ++i)
      if (v[i] == vid) {
        v[i] = v.back();
        v.pop_back();
        break;
      }
  }
  // nearest vertex within rq quanta of x (excluding `exclude`); -1 if none
  int64_t nearest_vert(const Q3& x, double rq, int64_t exclude = -1) const {
    int64_t r = (int64_t)std::ceil(rq);
    int64_t b0x = (x.x - r) >> VG_SHIFT, b1x = (x.x + r) >> VG_SHIFT;
    int64_t b0y = (x.y - r) >> VG_SHIFT, b1y = (x.y + r) >> VG_SHIFT;
    int64_t b0z = (x.z - r) >> VG_SHIFT, b1z = (x.z + r) >> VG_SHIFT;
    int64_t best = -1;
    double best_d2 = rq * rq;
    for (int64_t bx = b0x; bx <= b1x; ++bx)
      for (int64_t by = b0y; by <= b1y; ++by)
        for (int64_t bz = b0z; bz <= b1z; ++bz) {
          auto it = vgrid.find(vg_key(bx, by, bz));
          if (it == vgrid.end()) continue;
          for (int64_t w : it->second) {
            if (w == exclude) continue;
            const Q3& p = q[w];
            double dx = (double)(p.x - x.x), dy = (double)(p.y - x.y),
                   dz = (double)(p.z - x.z);
            double d2 = dx * dx + dy * dy + dz * dz;
            if (d2 < best_d2) {
              best_d2 = d2;
              best = w;
            }
          }
        }
    return best;
  }
  void move_vert(int64_t vid, const Q3& nq) {
    vhash.erase(q[vid]);
    vg_remove(vid);
    q[vid] = nq;
    vhash.emplace(nq, vid);
    vg_add(vid);
  }
  std::vector<std::array<int64_t, 4>> base_tets;
  std::vector<char> base_dead;
  std::vector<std::array<int64_t, 4>> extra_tets;
  std::vector<char> extra_dead;
  std::unordered_map<int64_t, std::vector<int64_t>> cell_extra;
  // graded mode: coarse/transition tets span several fine cells and are
  // bucketed into each (fine band tets stay single-bucket); `multi` marks
  // the multi-bucketed ids so tets_in_cells can dedup only those
  bool graded = false;
  std::vector<char> multi;  // indexed by extra id, only for graded originals
  // vertex -> incident tet ids (lazy: may hold dead tids, filtered and
  // compacted on read, hence mutable).  Tets are immutable after spawn, so
  // an id listed under v always contains v; this makes star() O(degree)
  // instead of a 27-cell scan (measured 30 s of star + 39 s of
  // tets_in_cells on knot@96)
  mutable std::vector<std::vector<int64_t>> inc;

  void inc_add(int64_t tid, const std::array<int64_t, 4>& T) {
    for (int j = 0; j < 4; ++j) {
      if (T[j] >= (int64_t)inc.size()) inc.resize(T[j] + 1);
      inc[T[j]].push_back(tid);
    }
  }
  // vertices recovery must preserve (sources, chain points, tiling corners);
  // everything else — lattice clutter — may be deleted by cavity fans
  std::unordered_set<int64_t> prot;

  void delete_vert(int64_t vid) {
    vg_remove(vid);
    vhash.erase(q[vid]);
  }

  int64_t nbase() const { return (int64_t)base_tets.size(); }

  V3 pos(int64_t vid) const {
    const Q3& p = q[vid];
    return {bmin.x + p.x * delta, bmin.y + p.y * delta, bmin.z + p.z * delta};
  }
  V3 posq(const Q3& p) const {
    return {bmin.x + p.x * delta, bmin.y + p.y * delta, bmin.z + p.z * delta};
  }
  Q3 quantize(const V3& p) const {
    const int64_t hi = (int64_t)nl << QSHIFT;
    auto cl = [&](double v) {
      int64_t r = (int64_t)std::llround(v);
      return std::min(std::max(r, (int64_t)0), hi);
    };
    return {cl((p.x - bmin.x) / delta), cl((p.y - bmin.y) / delta),
            cl((p.z - bmin.z) / delta)};
  }
  int64_t add_vert(const Q3& p) {
    int64_t vid = (int64_t)q.size();
    q.push_back(p);
    vhash.emplace(p, vid);
    vg_add(vid);
    if ((int64_t)inc.size() <= vid) inc.resize(vid + 1);
    return vid;
  }
  std::array<int64_t, 4> tet_verts(int64_t tid) const {
    return tid < nbase() ? base_tets[tid] : extra_tets[tid - nbase()];
  }
  bool live(int64_t tid) const {
    return tid < nbase() ? !base_dead[tid] : !extra_dead[tid - nbase()];
  }
  void cell_of(const V3& p, int64_t& ci, int64_t& cj, int64_t& ck) const {
    ci = std::min<int64_t>(std::max<int64_t>((int64_t)std::floor((p.x - bmin.x) / h), 0), nl - 1);
    cj = std::min<int64_t>(std::max<int64_t>((int64_t)std::floor((p.y - bmin.y) / h), 0), nl - 1);
    ck = std::min<int64_t>(std::max<int64_t>((int64_t)std::floor((p.z - bmin.z) / h), 0), nl - 1);
  }
  int64_t cell_lex(int64_t i, int64_t j, int64_t k) const {
    return i + j * nl + (int64_t)k * nl * nl;
  }
  void kill(int64_t tid) {
    if (tid < nbase()) base_dead[tid] = 1;
    else extra_dead[tid - nbase()] = 1;
  }
  int64_t spawn(const std::array<int64_t, 4>& T) {
    int64_t tid = nbase() + (int64_t)extra_tets.size();
    extra_tets.push_back(T);
    extra_dead.push_back(0);
    // register by centroid cell (children of a Kuhn tet stay inside it, so
    // a ring-1 scan around any of a tet's vertices always finds it)
    V3 c = (pos(T[0]) + pos(T[1]) + pos(T[2]) + pos(T[3])) * 0.25;
    int64_t ci, cj, ck;
    cell_of(c, ci, cj, ck);
    cell_extra[cell_lex(ci, cj, ck)].push_back(tid);
    inc_add(tid, T);
    return tid;
  }

  void tets_in_cells(int64_t ilo, int64_t ihi, int64_t jlo, int64_t jhi,
                     int64_t klo, int64_t khi, std::vector<int64_t>& out) const {
    out.clear();
    const bool have_base = !base_tets.empty();
    bool any_multi = false;
    for (int64_t k = std::max<int64_t>(klo, 0); k <= std::min<int64_t>(khi, nl - 1); ++k)
      for (int64_t j = std::max<int64_t>(jlo, 0); j <= std::min<int64_t>(jhi, nl - 1); ++j)
        for (int64_t i = std::max<int64_t>(ilo, 0); i <= std::min<int64_t>(ihi, nl - 1); ++i) {
          int64_t lex = cell_lex(i, j, k);
          if (have_base)
            for (int64_t t = 6 * lex; t < 6 * lex + 6; ++t)
              if (!base_dead[t]) out.push_back(t);
          auto it = cell_extra.find(lex);
          if (it != cell_extra.end())
            for (int64_t e : it->second)
              if (!extra_dead[e - nbase()]) {
                out.push_back(e);
                int64_t ei = e - nbase();
                if (graded && ei < (int64_t)multi.size() && multi[ei])
                  any_multi = true;
              }
        }
    if (any_multi) {  // multi-bucketed transition tets can appear twice
      std::sort(out.begin(), out.end());
      out.erase(std::unique(out.begin(), out.end()), out.end());
    }
  }

  void star(int64_t v, std::vector<int64_t>& out) const {
    out.clear();
    if (v >= (int64_t)inc.size()) return;
    // filter dead tids and compact the incidence list in place (amortizes
    // the garbage left behind by kill())
    auto& lst = inc[v];
    size_t w = 0;
    for (size_t r = 0; r < lst.size(); ++r)
      if (live(lst[r])) lst[w++] = lst[r];
    lst.resize(w);
    out.assign(lst.begin(), lst.end());
  }

  bool edge_exists(int64_t u, int64_t v) const {
    static thread_local std::vector<int64_t> st;
    star(u, st);
    for (int64_t tid : st) {
      auto T = tet_verts(tid);
      if (T[0] == v || T[1] == v || T[2] == v || T[3] == v) return true;
    }
    return false;
  }

  // exact classification of x against tet tid
  Loc classify(int64_t tid, const Q3& x) const {
    auto T = tet_verts(tid);
    int zi[3], nz = 0;
    int pos_j = -1;
    for (int j = 0; j < 4; ++j) {
      i128 s = orient(q[T[OPP_IN[j][0]]], q[T[OPP_IN[j][1]]], q[T[OPP_IN[j][2]]], x);
      if (s < 0) return {0, -1, -1};
      if (s == 0) {
        if (nz < 3) zi[nz] = j;
        ++nz;
      } else {
        pos_j = j;
      }
    }
    if (nz == 0) return {1, -1, -1};
    if (nz == 1) return {2, zi[0], -1};
    if (nz == 2) return {3, zi[0], zi[1]};
    return {4, pos_j, -1};  // x == vertex T[pos_j]
  }

  // find the live tet sharing face {a,b,c} other than tid (-1 on hull)
  int64_t face_neighbor(int64_t tid, int64_t a, int64_t b, int64_t c) const {
    static thread_local std::vector<int64_t> st;
    star(a, st);
    for (int64_t t2 : st) {
      if (t2 == tid) continue;
      auto T = tet_verts(t2);
      int m = 0;
      for (int j = 0; j < 4; ++j) m += (T[j] == a || T[j] == b || T[j] == c);
      if (m == 3) return t2;
    }
    return -1;
  }

  void check_child(const std::array<int64_t, 4>& T, const char* who) const {
    if (orient(q[T[0]], q[T[1]], q[T[2]], q[T[3]]) <= 0) throw XFail(who);
  }

  void split14(int64_t tid, int64_t vid) {
    auto T = tet_verts(tid);
    kill(tid);
    for (int j = 0; j < 4; ++j) {
      std::array<int64_t, 4> C = {T[OPP_IN[j][0]], T[OPP_IN[j][1]], T[OPP_IN[j][2]], vid};
      check_child(C, "split14 child not positive");
      spawn(C);
    }
  }

  void split_face_one(int64_t tid, int j, int64_t vid) {
    auto T = tet_verts(tid);
    int64_t a = T[OPP_IN[j][0]], b = T[OPP_IN[j][1]], c = T[OPP_IN[j][2]], apex = T[j];
    kill(tid);
    const int64_t e[3][2] = {{a, b}, {b, c}, {c, a}};
    for (int k = 0; k < 3; ++k) {
      std::array<int64_t, 4> C = {e[k][0], e[k][1], vid, apex};
      check_child(C, "face-split child not positive");
      spawn(C);
    }
  }

  void split_face(int64_t tid, int j, int64_t vid) {
    auto T = tet_verts(tid);
    int64_t a = T[OPP_IN[j][0]], b = T[OPP_IN[j][1]], c = T[OPP_IN[j][2]];
    int64_t nb = face_neighbor(tid, a, b, c);
    split_face_one(tid, j, vid);
    if (nb >= 0) {
      auto T2 = tet_verts(nb);
      for (int j2 = 0; j2 < 4; ++j2) {
        int64_t v2 = T2[j2];
        if (v2 != a && v2 != b && v2 != c) {
          split_face_one(nb, j2, vid);
          break;
        }
      }
    }
  }

  void split_edge(int64_t u, int64_t v, int64_t vid) {
    static thread_local std::vector<int64_t> st;
    star(u, st);
    std::vector<int64_t> ring;
    for (int64_t tid : st) {
      auto T = tet_verts(tid);
      if (T[0] == v || T[1] == v || T[2] == v || T[3] == v) ring.push_back(tid);
    }
    if (ring.empty()) throw XFail("edge split: empty ring");
    for (int64_t tid : ring) {
      auto T = tet_verts(tid);
      kill(tid);
      std::array<int64_t, 4> C1 = T, C2 = T;
      for (int j = 0; j < 4; ++j) {
        if (C1[j] == v) C1[j] = vid;  // (u, x) side
        if (C2[j] == u) C2[j] = vid;  // (x, v) side
      }
      check_child(C1, "edge-split child not positive");
      check_child(C2, "edge-split child not positive");
      spawn(C1);
      spawn(C2);
    }
  }

  // Feature-targeted insertions.  A quantized point intended for a face or
  // edge is (almost) never EXACTLY on it, and a naive 1-4 interior split
  // would mint a delta-thin pancake child against that face.  Instead the
  // local region is retetrahedralized around the point as if it were on the
  // feature — valid for any point in the region's kernel, verified exactly —
  // so the feature plane/line disappears and no thin child is created.

  // replace the bipyramid (tid + its neighbor across the face opposite
  // vertex j) by the 6-tet fan around x; returns new vid or -1 (no mutation)
  int64_t split_bipyramid_checked(int64_t tid, int j, const Q3& x) {
    auto T = tet_verts(tid);
    int64_t a = T[OPP_IN[j][0]], b = T[OPP_IN[j][1]], c = T[OPP_IN[j][2]];
    int64_t apex = T[j];
    int64_t nb = face_neighbor(tid, a, b, c);
    std::vector<std::array<int64_t, 4>> C;
    const int64_t e3[3][2] = {{a, b}, {b, c}, {c, a}};
    for (int k = 0; k < 3; ++k) C.push_back({e3[k][0], e3[k][1], -1, apex});
    int64_t d = -1;
    if (nb >= 0) {
      auto T2 = tet_verts(nb);
      for (int j2 = 0; j2 < 4; ++j2)
        if (T2[j2] != a && T2[j2] != b && T2[j2] != c) d = T2[j2];
      for (int k = 0; k < 3; ++k) C.push_back({e3[k][1], e3[k][0], -1, d});
    }
    for (auto& t : C) {
      t[2] = -2;  // placeholder for x
      Q3 p2 = x;
      if (orient(q[t[0]], q[t[1]], p2, q[t[3]]) <= 0) return -1;
    }
    int64_t vid = add_vert(x);
    kill(tid);
    if (nb >= 0) kill(nb);
    for (auto& t : C) {
      t[2] = vid;
      spawn(t);
    }
    return vid;
  }

  // replace the ring of tets around edge (u,v) by the 2-per-tet split at x;
  // valid for x in the ring's kernel (exactly verified); -1 on refusal
  int64_t split_edge_checked(int64_t u, int64_t v, const Q3& x) {
    static thread_local std::vector<int64_t> st;
    star(u, st);
    std::vector<int64_t> ring;
    for (int64_t tid : st) {
      auto T = tet_verts(tid);
      if (T[0] == v || T[1] == v || T[2] == v || T[3] == v) ring.push_back(tid);
    }
    if (ring.empty()) return -1;
    for (int64_t tid : ring) {
      auto T = tet_verts(tid);
      Q3 p[4];
      for (int j = 0; j < 4; ++j) p[j] = q[T[j]];
      Q3 c1[4], c2[4];
      for (int j = 0; j < 4; ++j) {
        c1[j] = T[j] == v ? x : p[j];
        c2[j] = T[j] == u ? x : p[j];
      }
      if (orient(c1[0], c1[1], c1[2], c1[3]) <= 0) return -1;
      if (orient(c2[0], c2[1], c2[2], c2[3]) <= 0) return -1;
    }
    int64_t vid = add_vert(x);
    for (int64_t tid : ring) {
      auto T = tet_verts(tid);
      kill(tid);
      std::array<int64_t, 4> C1 = T, C2 = T;
      for (int j = 0; j < 4; ++j) {
        if (C1[j] == v) C1[j] = vid;
        if (C2[j] == u) C2[j] = vid;
      }
      spawn(C1);
      spawn(C2);
    }
    return vid;
  }

  // generic exact insertion of a fresh point located in/on tet tid
  int64_t insert_located(int64_t tid, const Loc& loc, const Q3& x) {
    if (loc.type == 4) return tet_verts(tid)[loc.a];
    int64_t vid = add_vert(x);
    if (loc.type == 1) {
      split14(tid, vid);
    } else if (loc.type == 2) {
      split_face(tid, loc.a, vid);
    } else {  // on the edge shared by faces loc.a, loc.b: the two vertices
      auto T = tet_verts(tid);
      int64_t eu = -1, ev = -1;
      for (int j = 0; j < 4; ++j) {
        if (j == loc.a || j == loc.b) continue;
        (eu < 0 ? eu : ev) = T[j];
      }
      split_edge(eu, ev, vid);
    }
    return vid;
  }

  // global location: ring 0..2 around x's cell; returns tid or -1
  int64_t locate(const Q3& x, Loc& loc) const {
    V3 p = posq(x);
    int64_t ci, cj, ck;
    cell_of(p, ci, cj, ck);
    static thread_local std::vector<int64_t> cand;
    for (int r = 0; r <= 2; ++r) {
      tets_in_cells(ci - r, ci + r, cj - r, cj + r, ck - r, ck + r, cand);
      for (int64_t tid : cand) {
        Loc l = classify(tid, x);
        if (l.type != 0) {
          loc = l;
          return tid;
        }
      }
    }
    return -1;
  }
};

// ---------------------------------------------------------------------------
// lattice construction + source-vertex insertion

int64_t quality_insert(XMesh& mb, const Q3& x, double min_h, int64_t must_touch,
                       int64_t seed_tet = -1, int64_t* blocker = nullptr);

// graded quality ladder: prefer 16-quanta-thick children, degrade to
// 2 quanta in regions crowded with protected chain points (still exact, and
// vertex spacing stays >= DEDUP_Q regardless)
bool quality_connect(XMesh& mb, int64_t hub, int64_t seed_tet, double min_h,
                     int64_t* blocker = nullptr);

inline int64_t quality_insert_graded(XMesh& mb, const Q3& x, int64_t seed_tet = -1,
                                     int64_t* blocker = nullptr) {
  int64_t vid = quality_insert(mb, x, 16.0, -1, seed_tet, blocker);
  if (vid < 0) vid = quality_insert(mb, x, 2.0, -1, seed_tet, blocker);
  return vid;
}

void build_lattice(XMesh& mb, double cx, double cy, double cz, double half_side,
                   int resolution) {
  mb.nl = resolution;
  mb.npts = resolution + 1;
  mb.h = 2.0 * half_side / resolution;
  mb.delta = mb.h / (double)QUNIT;
  mb.bmin = {cx - half_side, cy - half_side, cz - half_side};

  const int64_t npts = mb.npts;
  mb.q.resize((int64_t)npts * npts * npts);
  for (int64_t k = 0; k < npts; ++k)
    for (int64_t j = 0; j < npts; ++j)
      for (int64_t i = 0; i < npts; ++i)
        mb.q[i + j * npts + k * npts * npts] = {i << QSHIFT, j << QSHIFT, k << QSHIFT};

  const int64_t nl = mb.nl;
  mb.base_tets.resize((int64_t)nl * nl * nl * 6);
  mb.base_dead.assign(mb.base_tets.size(), 0);
  const int64_t dx = 1, dy = npts, dz = (int64_t)npts * npts;
  const int64_t off[8] = {0, dx, dy, dx + dy, dz, dx + dz, dy + dz, dx + dy + dz};
  // orient each Kuhn pattern positively once (patterns are translation-
  // invariant, so one sign per pattern suffices)
  bool swap_pat[6];
  {
    for (int t = 0; t < 6; ++t) {
      Q3 p[4];
      for (int m = 0; m < 4; ++m) {
        int corner = KUHN[t][m];
        p[m] = {(int64_t)(corner & 1) << QSHIFT, (int64_t)((corner >> 1) & 1) << QSHIFT,
                (int64_t)((corner >> 2) & 1) << QSHIFT};
      }
      swap_pat[t] = orient(p[0], p[1], p[2], p[3]) < 0;
    }
  }
  for (int64_t k = 0; k < nl; ++k)
    for (int64_t j = 0; j < nl; ++j)
      for (int64_t i = 0; i < nl; ++i) {
        int64_t lex = i + j * nl + k * nl * nl;
        int64_t c000 = i + j * npts + k * npts * npts;
        for (int t = 0; t < 6; ++t) {
          auto& T = mb.base_tets[6 * lex + t];
          for (int m = 0; m < 4; ++m) T[m] = c000 + off[KUHN[t][m]];
          if (swap_pat[t]) std::swap(T[2], T[3]);
        }
      }
  mb.vhash.reserve(mb.q.size() * 2);
  for (int64_t v = 0; v < (int64_t)mb.q.size(); ++v) {
    mb.vhash.emplace(mb.q[v], v);
    mb.vg_add(v);
  }
  // vertex->tet incidence for the base lattice (counts pass first so every
  // per-vertex list is allocated exactly once)
  mb.inc.resize(mb.q.size());
  {
    std::vector<uint32_t> deg(mb.q.size(), 0);
    for (const auto& T : mb.base_tets)
      for (int m = 0; m < 4; ++m) ++deg[T[m]];
    for (int64_t v = 0; v < (int64_t)mb.q.size(); ++v) mb.inc[v].reserve(deg[v]);
    for (int64_t t = 0; t < (int64_t)mb.base_tets.size(); ++t)
      for (int m = 0; m < 4; ++m) mb.inc[mb.base_tets[t][m]].push_back(t);
  }
}

// ---------------------------------------------------------------------------
// Graded lattice: fine Kuhn cells in a band around the source surface, a
// 2:1-balanced octree elsewhere, tetrahedralized conformingly.
//
// The reference's TetGen produces graded quality meshes (maxvol + q1.414,
// include/signed_heat_tet_solver.h:96-97) — fine only where the surface
// needs it.  The uniform Kuhn lattice pays nl^3 everywhere (knot@96: 5.3M
// base tets, 2.6M for chair@72), which blows up FEM assembly, the device
// solve, and host finalize.  This builder keeps the band the recovery
// machinery touches at the fine resolution — recovery behavior there is
// IDENTICAL to the uniform lattice — and coarsens the far field through a
// balanced octree with conforming transition cells:
//
//   * leaf level per fine cell from the chebyshev distance to the surface
//     cells (triangle-AABB rasterization), block-aligned via a min-pyramid
//     and 2:1-balanced across face/edge/corner adjacency;
//   * leaves with no finer neighbor touching any face or edge emit the
//     plain 6-tet Kuhn decomposition (every cube face split along its
//     lexicographic min->max corner diagonal, which neighboring Kuhn cubes
//     of any size agree on);
//   * transition leaves emit a cone from the cube center: quartered faces
//     (finer neighbor across) as 2 triangles per quarter, plain faces with
//     hanging edge-midpoints as a fan around the face center, plain clean
//     faces as the min->max diagonal pair.  Under full 2:1 balance the
//     quarter squares can carry no hanging vertices, so the two sides of
//     every interface produce the same triangle set and the complex is
//     conforming by construction (exact orient3d verifies every tet).
//
// Only tets overlapping cells within BAND+MARGIN of the surface are
// registered in the spatial buckets: recovery operations are proven local
// to the surface (sources sit in surface cells, locate scans ring <= 2,
// cavity growth is quanta-scale), so far-field tets are never queried.
struct Grade {
  int nl = 0;
  int Lmax = 3;
  std::vector<uint8_t> lev;   // nl^3: leaf level per fine cell
  std::vector<uint8_t> dist;  // nl^3: chebyshev distance to surface (capped)
  int64_t lex(int64_t i, int64_t j, int64_t k) const {
    return i + j * nl + k * (int64_t)nl * nl;
  }
  int lev_at(int64_t i, int64_t j, int64_t k) const {
    if (i < 0 || j < 0 || k < 0 || i >= nl || j >= nl || k >= nl) return 127;
    return lev[lex(i, j, k)];
  }
  // is fine-grid point p (in [0,nl]^3) a corner of some leaf?
  bool vertex_exists(int64_t pi, int64_t pj, int64_t pk) const {
    for (int dk = -1; dk <= 0; ++dk)
      for (int dj = -1; dj <= 0; ++dj)
        for (int di = -1; di <= 0; ++di) {
          int64_t ci = pi + di, cj = pj + dj, ck = pk + dk;
          if (ci < 0 || cj < 0 || ck < 0 || ci >= nl || cj >= nl || ck >= nl)
            continue;
          int64_t s = (int64_t)1 << lev[lex(ci, cj, ck)];
          if ((pi % s) == 0 && (pj % s) == 0 && (pk % s) == 0) return true;
        }
    return false;
  }
};

constexpr int GRADE_BAND = 2;    // fine cells within this chebyshev distance
constexpr int GRADE_MARGIN = 2;  // extra bucketed shell beyond the band

void compute_grade(Grade& g, int nl, const V3& bmin, double h,
                   const double* src_xyz, int64_t V,
                   const int64_t* faces, int64_t F) {
  g.nl = nl;
  const int64_t NC = (int64_t)nl * nl * nl;
  g.dist.assign(NC, 255);

  // surface cells: conservative triangle-AABB rasterization
  auto cell_clamp = [&](double v) {
    int64_t c = (int64_t)std::floor(v);
    return std::min(std::max(c, (int64_t)0), (int64_t)nl - 1);
  };
  std::vector<int64_t> frontier;
  auto mark = [&](int64_t i, int64_t j, int64_t k) {
    int64_t c = g.lex(i, j, k);
    if (g.dist[c] != 0) {
      g.dist[c] = 0;
      frontier.push_back(c);
    }
  };
  for (int64_t f = 0; f < F; ++f) {
    double lo[3], hi[3];
    for (int a = 0; a < 3; ++a) {
      lo[a] = 1e300;
      hi[a] = -1e300;
    }
    for (int m = 0; m < 3; ++m) {
      const double* p = src_xyz + 3 * faces[3 * f + m];
      for (int a = 0; a < 3; ++a) {
        lo[a] = std::min(lo[a], p[a]);
        hi[a] = std::max(hi[a], p[a]);
      }
    }
    int64_t i0 = cell_clamp((lo[0] - bmin.x) / h), i1 = cell_clamp((hi[0] - bmin.x) / h);
    int64_t j0 = cell_clamp((lo[1] - bmin.y) / h), j1 = cell_clamp((hi[1] - bmin.y) / h);
    int64_t k0 = cell_clamp((lo[2] - bmin.z) / h), k1 = cell_clamp((hi[2] - bmin.z) / h);
    for (int64_t k = k0; k <= k1; ++k)
      for (int64_t j = j0; j <= j1; ++j)
        for (int64_t i = i0; i <= i1; ++i) mark(i, j, k);
  }
  // isolated source points (defensive; every vertex is in some face AABB)
  for (int64_t v = 0; v < V; ++v)
    mark(cell_clamp((src_xyz[3 * v] - bmin.x) / h),
         cell_clamp((src_xyz[3 * v + 1] - bmin.y) / h),
         cell_clamp((src_xyz[3 * v + 2] - bmin.z) / h));

  // multi-source chebyshev-distance BFS (26-neighborhood)
  const int64_t nl2 = (int64_t)nl * nl;
  std::vector<int64_t> next;
  while (!frontier.empty()) {
    next.clear();
    for (int64_t c : frontier) {
      int d = g.dist[c];
      if (d >= 254) continue;
      int64_t i = c % nl, j = (c / nl) % nl, k = c / nl2;
      for (int dk = -1; dk <= 1; ++dk)
        for (int dj = -1; dj <= 1; ++dj)
          for (int di = -1; di <= 1; ++di) {
            int64_t ni = i + di, nj = j + dj, nk = k + dk;
            if (ni < 0 || nj < 0 || nk < 0 || ni >= nl || nj >= nl || nk >= nl)
              continue;
            int64_t nc = g.lex(ni, nj, nk);
            if (g.dist[nc] > d + 1) {
              g.dist[nc] = (uint8_t)(d + 1);
              next.push_back(nc);
            }
          }
    }
    frontier.swap(next);
  }

  // desired level from distance (monotone; balance pass fixes the rest)
  std::vector<uint8_t> want(NC);
  for (int64_t c = 0; c < NC; ++c) {
    int d = g.dist[c];
    int w;
    if (d <= GRADE_BAND) w = 0;
    else if (d <= GRADE_BAND + 2) w = 1;
    else if (d <= GRADE_BAND + 6) w = 2;
    else w = 3;
    want[c] = (uint8_t)std::min(w, g.Lmax);
  }

  // leaf levels: block-align via min-pyramid, then enforce 2:1 balance
  // across the full 26-adjacency; wants only decrease, so this terminates
  g.lev.assign(NC, 0);
  for (int iter = 0; iter < 16; ++iter) {
    // leaf level of cell c = max L <= want[c] whose aligned 2^L block is
    // uniformly >= L in want (computed coarse-to-fine via block minima)
    for (int64_t c = 0; c < NC; ++c) g.lev[c] = want[c];
    for (int L = 1; L <= g.Lmax; ++L) {
      int64_t s = (int64_t)1 << L;
      for (int64_t k = 0; k < nl; k += s)
        for (int64_t j = 0; j < nl; j += s)
          for (int64_t i = 0; i < nl; i += s) {
            uint8_t mn = 255;
            for (int64_t dk = 0; dk < s && mn >= L; ++dk)
              for (int64_t dj = 0; dj < s && mn >= L; ++dj)
                for (int64_t di = 0; di < s; ++di) {
                  uint8_t w = want[g.lex(i + di, j + dj, k + dk)];
                  if (w < mn) mn = w;
                  if (mn < L) break;
                }
            if (mn < L) {
              // block not uniform at L: clamp its cells' leaf level to L-1
              for (int64_t dk = 0; dk < s; ++dk)
                for (int64_t dj = 0; dj < s; ++dj)
                  for (int64_t di = 0; di < s; ++di) {
                    uint8_t& lv = g.lev[g.lex(i + di, j + dj, k + dk)];
                    if (lv >= L) lv = (uint8_t)(L - 1);
                  }
            }
          }
    }
    // balance: adjacent leaves may differ by at most one level
    bool changed = false;
    for (int64_t k = 0; k < nl; ++k)
      for (int64_t j = 0; j < nl; ++j)
        for (int64_t i = 0; i < nl; ++i) {
          int64_t c = g.lex(i, j, k);
          int lc = g.lev[c];
          if (lc == 0) continue;
          int mn = 127;
          for (int dk = -1; dk <= 1; ++dk)
            for (int dj = -1; dj <= 1; ++dj)
              for (int di = -1; di <= 1; ++di) {
                int lv = g.lev_at(i + di, j + dj, k + dk);
                if (lv < mn) mn = lv;
              }
          if (lc > mn + 1) {
            want[c] = (uint8_t)(mn + 1);
            changed = true;
          }
        }
    if (!changed) return;
  }
  throw XFail("graded lattice: balance did not converge");
}

// triangulate the axis-aligned square with fine-grid corners c00..c11
// (u/v axes) along its lexicographic min->max diagonal; emits 2 triangles
// of fine-grid points into out
static void square_diag(const std::array<std::array<int64_t, 3>, 4>& cyc,
                        std::vector<std::array<std::array<int64_t, 3>, 3>>& out) {
  // cyc is the cyclic corner order c00, c10, c11, c01; lex-min and lex-max
  // corners are diagonally opposite (indices differing by 2)
  int mn = 0;
  for (int t = 1; t < 4; ++t)
    if (cyc[t] < cyc[mn]) mn = t;
  int mx = (mn + 2) % 4;
  out.push_back({cyc[mn], cyc[(mn + 1) % 4], cyc[mx]});
  out.push_back({cyc[mn], cyc[mx], cyc[(mn + 3) % 4]});
}

void build_lattice_graded(XMesh& mb, double cx, double cy, double cz,
                          double half_side, int resolution,
                          const double* src_xyz, int64_t V,
                          const int64_t* faces, int64_t F) {
  // leaf blocks must tile the cube: round the resolution to the nearest
  // multiple of the coarsest block (the heuristic resolution is
  // approximate anyway; rounding up would double tiny meshes, 9 -> 16)
  int nl = std::max(8, (resolution + 4) / 8 * 8);
  mb.nl = nl;
  mb.npts = nl + 1;
  mb.h = 2.0 * half_side / nl;
  mb.delta = mb.h / (double)QUNIT;
  mb.bmin = {cx - half_side, cy - half_side, cz - half_side};
  mb.graded = true;

  Grade g;
  compute_grade(g, nl, mb.bmin, mb.h, src_xyz, V, faces, F);

  auto gv = [&](int64_t i, int64_t j, int64_t k) {
    Q3 p{i << QSHIFT, j << QSHIFT, k << QSHIFT};
    auto it = mb.vhash.find(p);
    if (it != mb.vhash.end()) return it->second;
    return mb.add_vert(p);
  };
  const int bucket_max = GRADE_BAND + GRADE_MARGIN;
  auto emit = [&](std::array<int64_t, 4> T) {
    if (orient(mb.q[T[0]], mb.q[T[1]], mb.q[T[2]], mb.q[T[3]]) < 0)
      std::swap(T[2], T[3]);
    mb.check_child(T, "graded lattice tet degenerate");
    int64_t tid = (int64_t)mb.extra_tets.size();  // nbase() == 0 in graded mode
    mb.extra_tets.push_back(T);
    mb.extra_dead.push_back(0);
    mb.inc_add(tid, T);
    // bucket into every overlapped cell within the active shell
    int64_t lo[3] = {INT64_MAX, INT64_MAX, INT64_MAX};
    int64_t hi[3] = {INT64_MIN, INT64_MIN, INT64_MIN};
    for (int m = 0; m < 4; ++m) {
      const Q3& p = mb.q[T[m]];
      int64_t pc[3] = {p.x, p.y, p.z};
      for (int a = 0; a < 3; ++a) {
        lo[a] = std::min(lo[a], pc[a]);
        hi[a] = std::max(hi[a], pc[a]);
      }
    }
    int64_t c0[3], c1[3];
    for (int a = 0; a < 3; ++a) {
      c0[a] = std::min(std::max(lo[a] >> QSHIFT, (int64_t)0), (int64_t)nl - 1);
      c1[a] = std::min(std::max((hi[a] - 1) >> QSHIFT, (int64_t)0), (int64_t)nl - 1);
    }
    int nbuckets = 0;
    for (int64_t k = c0[2]; k <= c1[2]; ++k)
      for (int64_t j = c0[1]; j <= c1[1]; ++j)
        for (int64_t i = c0[0]; i <= c1[0]; ++i) {
          int64_t lx = g.lex(i, j, k);
          if (g.dist[lx] > bucket_max) continue;
          mb.cell_extra[lx].push_back(tid);
          ++nbuckets;
        }
    mb.multi.push_back(nbuckets > 1 ? 1 : 0);
  };

  // Kuhn orientation per pattern (scale-invariant)
  bool swap_pat[6];
  for (int t = 0; t < 6; ++t) {
    Q3 p[4];
    for (int m = 0; m < 4; ++m) {
      int corner = KUHN[t][m];
      p[m] = {(int64_t)(corner & 1) << QSHIFT, (int64_t)((corner >> 1) & 1) << QSHIFT,
              (int64_t)((corner >> 2) & 1) << QSHIFT};
    }
    swap_pat[t] = orient(p[0], p[1], p[2], p[3]) < 0;
  }

  // pre-create the fine-band vertices in dense lattice order so the band
  // matches the uniform builder exactly (vertex identity is positional
  // through vhash either way; this just keeps allocation coherent)
  std::vector<std::array<std::array<int64_t, 3>, 3>> ftris;
  for (int64_t k = 0; k < nl; ++k)
    for (int64_t j = 0; j < nl; ++j)
      for (int64_t i = 0; i < nl; ++i) {
        int L = g.lev[g.lex(i, j, k)];
        int64_t s = (int64_t)1 << L;
        if ((i % s) || (j % s) || (k % s)) continue;  // not the leaf origin

        // Kuhn eligibility: no finer leaf across any face, no hanging
        // vertex on any edge midpoint (level 0 is always eligible)
        bool kuhn = true;
        if (L > 0) {
          const int64_t o[3] = {i, j, k};
          for (int axis = 0; axis < 3 && kuhn; ++axis)
            for (int side = 0; side < 2 && kuhn; ++side) {
              // scan the neighbor strip across this face
              int64_t probe[3] = {i, j, k};
              probe[axis] = side ? o[axis] + s : o[axis] - 1;
              for (int64_t b2 = 0; b2 < s && kuhn; ++b2)
                for (int64_t a2 = 0; a2 < s && kuhn; ++a2) {
                  int64_t cc[3] = {probe[0], probe[1], probe[2]};
                  cc[(axis + 1) % 3] = o[(axis + 1) % 3] + a2;
                  cc[(axis + 2) % 3] = o[(axis + 2) % 3] + b2;
                  if (g.lev_at(cc[0], cc[1], cc[2]) < L) kuhn = false;
                }
            }
          // 12 edge midpoints
          for (int axis = 0; axis < 3 && kuhn; ++axis) {
            int a1 = (axis + 1) % 3, a2 = (axis + 2) % 3;
            for (int e1 = 0; e1 < 2 && kuhn; ++e1)
              for (int e2 = 0; e2 < 2 && kuhn; ++e2) {
                int64_t m[3];
                m[axis] = o[axis] + s / 2;
                m[a1] = o[a1] + e1 * s;
                m[a2] = o[a2] + e2 * s;
                if (g.vertex_exists(m[0], m[1], m[2])) kuhn = false;
              }
          }
        }

        if (kuhn) {
          int64_t corner_vid[8];
          for (int c8 = 0; c8 < 8; ++c8)
            corner_vid[c8] = gv(i + (int64_t)(c8 & 1) * s,
                                j + (int64_t)((c8 >> 1) & 1) * s,
                                k + (int64_t)((c8 >> 2) & 1) * s);
          for (int t = 0; t < 6; ++t) {
            std::array<int64_t, 4> T;
            for (int m = 0; m < 4; ++m) T[m] = corner_vid[KUHN[t][m]];
            if (swap_pat[t]) std::swap(T[2], T[3]);
            emit(T);
          }
          continue;
        }

        // transition leaf: cone from the cube center (L >= 1, so the
        // center and all face points are integer fine-grid nodes)
        const int64_t o[3] = {i, j, k};
        int64_t vc = gv(i + s / 2, j + s / 2, k + s / 2);
        for (int axis = 0; axis < 3; ++axis) {
          int a1 = (axis + 1) % 3, a2 = (axis + 2) % 3;
          for (int side = 0; side < 2; ++side) {
            int64_t fo[3] = {o[0], o[1], o[2]};
            fo[axis] += side ? s : 0;
            // finer across? (balance: any strip cell at L-1 quarters it)
            bool finer = false;
            {
              int64_t probe = side ? o[axis] + s : o[axis] - 1;
              for (int64_t b2 = 0; b2 < s && !finer; ++b2)
                for (int64_t a2i = 0; a2i < s && !finer; ++a2i) {
                  int64_t cc[3];
                  cc[axis] = probe;
                  cc[a1] = o[a1] + a2i;
                  cc[a2] = o[a2] + b2;
                  if (g.lev_at(cc[0], cc[1], cc[2]) < L) finer = true;
                }
            }
            ftris.clear();
            auto corner = [&](int64_t du, int64_t dv) {
              std::array<int64_t, 3> p = {fo[0], fo[1], fo[2]};
              p[a1] += du;
              p[a2] += dv;
              return p;
            };
            if (finer) {
              int64_t hs = s / 2;
              for (int qu = 0; qu < 2; ++qu)
                for (int qv = 0; qv < 2; ++qv) {
                  std::array<std::array<int64_t, 3>, 4> cyc = {
                      corner(qu * hs, qv * hs), corner(qu * hs + hs, qv * hs),
                      corner(qu * hs + hs, qv * hs + hs),
                      corner(qu * hs, qv * hs + hs)};
                  square_diag(cyc, ftris);
                }
            } else {
              // plain face: hanging midpoints force a center fan
              std::array<std::array<int64_t, 3>, 4> cyc = {
                  corner(0, 0), corner(s, 0), corner(s, s), corner(0, s)};
              std::array<std::array<int64_t, 3>, 4> mids = {
                  corner(s / 2, 0), corner(s, s / 2), corner(s / 2, s),
                  corner(0, s / 2)};
              bool have[4];
              int nmid = 0;
              for (int e = 0; e < 4; ++e) {
                have[e] = g.vertex_exists(mids[e][0], mids[e][1], mids[e][2]);
                nmid += have[e];
              }
              if (nmid == 0) {
                square_diag(cyc, ftris);
              } else {
                std::array<int64_t, 3> ctr = corner(s / 2, s / 2);
                std::vector<std::array<int64_t, 3>> ring;
                for (int e = 0; e < 4; ++e) {
                  ring.push_back(cyc[e]);
                  if (have[e]) ring.push_back(mids[e]);
                }
                for (size_t t = 0; t < ring.size(); ++t)
                  ftris.push_back({ctr, ring[t], ring[(t + 1) % ring.size()]});
              }
            }
            for (const auto& tr : ftris) {
              std::array<int64_t, 4> T = {gv(tr[0][0], tr[0][1], tr[0][2]),
                                          gv(tr[1][0], tr[1][1], tr[1][2]),
                                          gv(tr[2][0], tr[2][1], tr[2][2]), vc};
              emit(T);
            }
          }
        }
      }
}

void insert_sources(XMesh& mb, ShmResult& res, const double* src_xyz, int64_t V) {
  res.vertex_of.assign(V, -1);
  const int64_t npts = mb.npts;
  std::vector<char> is_source(mb.q.size(), 0);

  // pass 1: snap lattice nodes onto nearby sources (closest-first greedy),
  // exact positivity verification with revert rounds — mirrors
  // lattice_tet.cpp build_core but on integer coordinates.  The nearest
  // lattice node is resolved through vhash (not dense index arithmetic) so
  // the same code serves the uniform and graded lattices; a source always
  // sits in a fine surface cell, whose corners all exist.
  std::vector<int64_t> nearest(V);
  std::vector<double> dist(V);
  std::vector<int64_t> order(V);
  for (int64_t v = 0; v < V; ++v) {
    V3 p = {src_xyz[3 * v], src_xyz[3 * v + 1], src_xyz[3 * v + 2]};
    auto cl = [&](double val, int64_t hi) {
      return std::min(std::max((int64_t)std::nearbyint(val), (int64_t)0), hi);
    };
    int64_t bi = cl((p.x - mb.bmin.x) / mb.h, npts - 1);
    int64_t bj = cl((p.y - mb.bmin.y) / mb.h, npts - 1);
    int64_t bk = cl((p.z - mb.bmin.z) / mb.h, npts - 1);
    Q3 nq = {bi << QSHIFT, bj << QSHIFT, bk << QSHIFT};
    auto it = mb.vhash.find(nq);
    nearest[v] = it == mb.vhash.end() ? -1 : it->second;
    dist[v] = nearest[v] < 0 ? 1e300 : norm(p - mb.pos(nearest[v]));
    order[v] = v;
  }
  std::stable_sort(order.begin(), order.end(),
                   [&](int64_t a, int64_t b) { return dist[a] < dist[b]; });
  std::unordered_map<int64_t, int64_t> claimed;  // node -> source
  std::vector<Q3> saved;
  std::vector<int64_t> snapped_nodes;
  for (int64_t v : order) {
    if (dist[v] > SNAP_ALPHA * mb.h) continue;
    int64_t nid = nearest[v];
    if (claimed.count(nid)) continue;
    Q3 tq = mb.quantize({src_xyz[3 * v], src_xyz[3 * v + 1], src_xyz[3 * v + 2]});
    auto hit = mb.vhash.find(tq);
    if (hit != mb.vhash.end() && hit->second != nid) continue;  // target taken
    claimed[nid] = v;
    saved.push_back(mb.q[nid]);
    snapped_nodes.push_back(nid);
    mb.move_vert(nid, tq);
  }
  std::unordered_set<int64_t> snapset(snapped_nodes.begin(), snapped_nodes.end());
  {
    // inverted tets can only be incident to snapped nodes: check each
    // snapped node's star (vertex->tet incidence), reverting offenders until
    // a fixpoint — a revert can re-invalidate a neighbor checked earlier,
    // hence the worklist
    // termination: a node reverts at most once, and pushes happen only on
    // a revert, so total work is O(#snapped * degree); the guard only
    // backstops a logic error
    std::vector<int64_t> work(snapped_nodes.begin(), snapped_nodes.end());
    std::vector<int64_t> st;
    // each revert pushes <= 4*|star| (~100) re-checks, reverts <= #snapped
    size_t guard = 0, guard_max = snapped_nodes.size() * 200 + 1024;
    while (!work.empty()) {
      if (++guard > guard_max) throw XFail("snap revert did not converge");
      int64_t nid = work.back();
      work.pop_back();
      if (!snapset.count(nid)) continue;
      mb.star(nid, st);
      bool bad = false;
      for (int64_t t : st) {
        auto T = mb.tet_verts(t);
        if (orient(mb.q[T[0]], mb.q[T[1]], mb.q[T[2]], mb.q[T[3]]) <= 0) {
          bad = true;
          break;
        }
      }
      if (!bad) continue;
      for (size_t s = 0; s < snapped_nodes.size(); ++s)
        if (snapped_nodes[s] == nid) {
          mb.move_vert(nid, saved[s]);
          break;
        }
      snapset.erase(nid);
      claimed.erase(nid);
      // re-check snapped neighbors sharing a tet with the reverted node
      for (int64_t t : st) {
        auto T = mb.tet_verts(t);
        for (int m = 0; m < 4; ++m)
          if (T[m] != nid && snapset.count(T[m])) work.push_back(T[m]);
      }
    }
  }
  for (auto& kv : claimed) {
    res.vertex_of[kv.second] = kv.first;
    is_source[kv.first] = 1;
    mb.prot.insert(kv.first);
    res.n_snapped++;
  }

  // pass 2: exact snap-or-split for the rest
  std::vector<int64_t> st;
  for (int64_t v = 0; v < V; ++v) {
    if (res.vertex_of[v] >= 0) continue;
    V3 p = {src_xyz[3 * v], src_xyz[3 * v + 1], src_xyz[3 * v + 2]};
    Q3 x = mb.quantize(p);
    auto hit = mb.vhash.find(x);
    if (hit != mb.vhash.end()) {  // coincident with an existing vertex
      res.vertex_of[v] = hit->second;
      if (hit->second < (int64_t)is_source.size()) is_source[hit->second] = 1;
      mb.prot.insert(hit->second);
      continue;
    }
    Loc loc;
    int64_t tid = mb.locate(x, loc);
    if (tid < 0) throw XFail("source-vertex location failed");
    // try moving the nearest unclaimed vertex of the located tet onto the
    // source (exact star-positivity check); far cheaper mesh than a split
    auto T = mb.tet_verts(tid);
    int64_t best_w = -1;
    double best_d = SNAP_ALPHA * mb.h;
    for (int j = 0; j < 4; ++j) {
      int64_t w = T[j];
      if (w < (int64_t)is_source.size() && is_source[w]) continue;
      if (w >= (int64_t)is_source.size()) continue;  // never move split verts
      double d = norm(mb.pos(w) - p);
      if (d < best_d) {
        best_w = w;
        best_d = d;
      }
    }
    bool moved = false;
    if (best_w >= 0) {
      Q3 old = mb.q[best_w];
      mb.move_vert(best_w, x);
      bool ok = true;
      mb.star(best_w, st);
      for (int64_t t2 : st) {
        auto T2 = mb.tet_verts(t2);
        if (orient(mb.q[T2[0]], mb.q[T2[1]], mb.q[T2[2]], mb.q[T2[3]]) <= 0) {
          ok = false;
          break;
        }
      }
      if (ok) {
        res.vertex_of[v] = best_w;
        is_source[best_w] = 1;
        mb.prot.insert(best_w);
        res.n_snapped++;
        moved = true;
      } else {
        mb.move_vert(best_w, old);
      }
    }
    if (!moved) {
      // quality-only: a source vertex inserted with sub-quanta clearance to
      // a lattice face would poison every edge walk that later starts there
      int64_t vid = quality_insert(mb, x, 16.0, -1);
      if (vid < 0) throw XFail("source-vertex quality insertion failed");
      res.vertex_of[v] = vid;
      mb.prot.insert(vid);
      res.n_split++;
    }
  }
}

// ---------------------------------------------------------------------------
// edge recovery

void tri_bary(const V3& X, const V3& a, const V3& b, const V3& c,
              double& al, double& be, double& ga);

// insert X as a split of a tet containing cur (any such split leaves a child
// with both cur and X, so the chain edge exists by construction); returns
// the new vertex id or -1 when X lies outside cur's star closure
int64_t try_chain_insert(XMesh& mb, int64_t cur, const Q3& x) {
  if (mb.vhash.count(x)) return -1;  // callers handle dedup beforehand
  static thread_local std::vector<int64_t> st;
  mb.star(cur, st);
  for (int64_t tid : st) {
    Loc loc = mb.classify(tid, x);
    if (loc.type == 0) continue;
    return mb.insert_located(tid, loc, x);
  }
  return -1;
}

// exact 2-3 flip across the face (fu,fv,fw) of tet `chosen` (whose fourth
// vertex is cur): connects cur to the neighbor's apex; returns the apex id
// or -1 when the flip union is non-convex (some child not exactly positive)
int64_t flip23_connect(XMesh& mb, int64_t cur, int64_t chosen,
                       int64_t fu, int64_t fv, int64_t fw) {
  int64_t nb = mb.face_neighbor(chosen, fu, fv, fw);
  if (nb < 0) return -1;
  auto T2 = mb.tet_verts(nb);
  int64_t d = -1;
  for (int j = 0; j < 4; ++j)
    if (T2[j] != fu && T2[j] != fv && T2[j] != fw) d = T2[j];
  if (d < 0) return -1;
  const int64_t e3[3][2] = {{fu, fv}, {fv, fw}, {fw, fu}};
  std::array<std::array<int64_t, 4>, 3> C;
  for (int k = 0; k < 3; ++k) {
    C[k] = {cur, d, e3[k][1], e3[k][0]};
    if (orient(mb.q[C[k][0]], mb.q[C[k][1]], mb.q[C[k][2]], mb.q[C[k][3]]) <= 0)
      return -1;
  }
  mb.kill(chosen);
  mb.kill(nb);
  for (int k = 0; k < 3; ++k) mb.spawn(C[k]);
  return d;
}

// Collect the tube of tets traversed by the segment [p0 -> target], starting
// from `start` (which contains p0's side).  Stops when a tet containing
// `target` (exact classification, or hub_vid as a vertex) is reached.
// Returns false on hull exit / cap / cycles.
bool collect_cavity(XMesh& mb, int64_t start, const V3& p0, const Q3& target,
                    int64_t hub_vid, std::vector<int64_t>& cavity) {
  cavity.clear();
  V3 p1 = mb.posq(target);
  int64_t tid = start;
  for (int hop = 0; hop < 12; ++hop) {
    for (int64_t c : cavity)
      if (c == tid) return false;  // cycle (grazing traversal)
    cavity.push_back(tid);
    auto T = mb.tet_verts(tid);
    if (hub_vid >= 0 &&
        (T[0] == hub_vid || T[1] == hub_vid || T[2] == hub_vid || T[3] == hub_vid))
      return true;
    Loc loc = mb.classify(tid, target);
    if (loc.type != 0) return true;
    // exit face: minimal crossing parameter among straddled faces
    double best_t = 2.0;
    int best_j = -1;
    for (int j = 0; j < 4; ++j) {
      const Q3 &fa = mb.q[T[OPP_IN[j][0]]], &fb = mb.q[T[OPP_IN[j][1]]],
               &fc = mb.q[T[OPP_IN[j][2]]];
      i128 s1 = orient(fa, fb, fc, target);
      if (s1 >= 0) continue;  // target not beyond this face
      V3 A = mb.pos(T[OPP_IN[j][0]]);
      V3 n = cross(mb.pos(T[OPP_IN[j][1]]) - A, mb.pos(T[OPP_IN[j][2]]) - A);
      double d0 = dot(p0 - A, n), d1 = dot(p1 - A, n);
      if (d0 == d1) continue;
      double t = d0 / (d0 - d1);
      if (t < best_t) {
        best_t = t;
        best_j = j;
      }
    }
    if (best_j < 0) return false;
    auto Tf = mb.tet_verts(tid);
    int64_t nb = mb.face_neighbor(tid, Tf[OPP_IN[best_j][0]],
                                  Tf[OPP_IN[best_j][1]], Tf[OPP_IN[best_j][2]]);
    if (nb < 0) return false;  // hull
    tid = nb;
  }
  return false;
}

// double-precision magnitude of the cross product of exact edge vectors
// (face area * 2) — used only for quality thresholds, never for predicates
double face_cross_norm(const XMesh& mb, int64_t a, int64_t b, int64_t c) {
  const Q3 &qa = mb.q[a], &qb = mb.q[b], &qc = mb.q[c];
  const int64_t ux = qb.x - qa.x, uy = qb.y - qa.y, uz = qb.z - qa.z;
  const int64_t wx = qc.x - qa.x, wy = qc.y - qa.y, wz = qc.z - qa.z;
  double nx = d128((i128)uy * wz - (i128)uz * wy);
  double ny = d128((i128)uz * wx - (i128)ux * wz);
  double nz = d128((i128)ux * wy - (i128)uy * wx);
  return std::sqrt(nx * nx + ny * ny + nz * nz);
}

// Replace the cavity by the fan from `hub` (a fresh point, or an existing
// boundary vertex when hub_vid >= 0).  Valid iff the cavity is star-shaped
// from the hub (every non-wall boundary face exactly positively oriented
// toward it) and no cavity vertex is swallowed (every vertex of a cavity
// tet appears on the boundary).  Returns the hub vertex id, or -1 with no
// mutation.
int64_t cavity_fan(XMesh& mb, const std::vector<int64_t>& cavity,
                   const Q3& hub, int64_t hub_vid) {
  std::vector<std::array<int64_t, 3>> bfaces;
  std::set<int64_t> cav_verts, bverts;
  for (int64_t tid : cavity) {
    auto T = mb.tet_verts(tid);
    for (int j = 0; j < 4; ++j) cav_verts.insert(T[j]);
    for (int j = 0; j < 4; ++j) {
      int64_t a = T[OPP_IN[j][0]], b = T[OPP_IN[j][1]], c = T[OPP_IN[j][2]];
      int64_t nb = mb.face_neighbor(tid, a, b, c);
      bool internal = false;
      for (int64_t c2 : cavity)
        if (c2 == nb) internal = true;
      if (internal) continue;
      bverts.insert(a);
      bverts.insert(b);
      bverts.insert(c);
      if (hub_vid >= 0 && (a == hub_vid || b == hub_vid || c == hub_vid))
        continue;  // lateral wall of the vertex fan
      if (orient(mb.q[a], mb.q[b], mb.q[c], hub) <= 0) return -1;
      bfaces.push_back({a, b, c});
    }
  }
  if (bfaces.empty()) return -1;
  std::vector<int64_t> orphans;
  for (int64_t v : cav_verts)
    if (!bverts.count(v)) {
      if (mb.prot.count(v)) return -1;  // protected vertex would be orphaned
      orphans.push_back(v);  // unconstrained clutter: delete it
    }
  int64_t vid = hub_vid >= 0 ? hub_vid : mb.add_vert(hub);
  for (int64_t tid : cavity) mb.kill(tid);
  for (const auto& f : bfaces) mb.spawn({f[0], f[1], f[2], vid});
  for (int64_t v : orphans) mb.delete_vert(v);
  return vid;
}

// Bowyer-Watson-style quality insertion: locate x, grow the cavity across
// every boundary face that x does not see with height >= min_h quanta, then
// fan.  Near-face / near-edge points are handled automatically (the shallow
// face's neighbor joins the cavity, so the offending plane disappears) —
// this is THE insertion primitive for all recovery points; it never creates
// a child thinner than min_h.  `must_touch >= 0` additionally requires that
// vertex on the cavity boundary (chain adjacency).  -1 on refusal.
int64_t quality_insert(XMesh& mb, const Q3& x, double min_h, int64_t must_touch,
                       int64_t seed_tet, int64_t* blocker) {
  Loc loc;
  int64_t t0 = mb.locate(x, loc);
  const bool dbg = getenv("SHM3D_DEBUG") != nullptr;
  if (t0 < 0) {
    if (dbg) fprintf(stderr, "QINS locate failed\n");
    return -1;
  }
  if (loc.type == 4) return mb.tet_verts(t0)[loc.a];
  {
    const int tier = 0;
    const double hmin = min_h;
    std::vector<int64_t> cavity{t0};
    if (seed_tet >= 0 && seed_tet != t0 && mb.live(seed_tet)) {
      // include the seed only when it is face-adjacent to the located tet —
      // a disconnected cavity's fan would mint overlapping tets
      auto Ta = mb.tet_verts(t0);
      auto Tb = mb.tet_verts(seed_tet);
      int shared = 0;
      for (int i = 0; i < 4; ++i)
        for (int j = 0; j < 4; ++j)
          if (Ta[i] == Tb[j]) ++shared;
      if (shared == 3) cavity.push_back(seed_tet);
    }
    for (int grow = 0; grow < 48; ++grow) {
      std::vector<int64_t> to_add;
      bool ok = true, hull_blocked = false, touched = must_touch < 0;
      for (int64_t tid : cavity) {
        auto T = mb.tet_verts(tid);
        for (int j = 0; j < 4; ++j) {
          int64_t a = T[OPP_IN[j][0]], b = T[OPP_IN[j][1]], c = T[OPP_IN[j][2]];
          int64_t nb = mb.face_neighbor(tid, a, b, c);
          bool internal = false;
          for (int64_t c2 : cavity)
            if (c2 == nb) internal = true;
          if (internal) continue;
          if (a == must_touch || b == must_touch || c == must_touch) touched = true;
          i128 s = orient(mb.q[a], mb.q[b], mb.q[c], x);
          bool bad = s <= 0;
          double hh = -1.0;
          if (!bad && hmin > 0) {
            double cn = face_cross_norm(mb, a, b, c);
            hh = cn <= 0 ? -1.0 : d128(s) / cn;
            if (hh < hmin) bad = true;
          }
          if (bad) {
            ok = false;
            if (dbg && grow > 40 && hmin < 10.0)
              fprintf(stderr, "QBAD grow=%d tid=%lld s=%s h=%.2f nb=%lld\n", grow,
                      (long long)tid, s <= 0 ? (s == 0 ? "0" : "-") : "+", hh,
                      (long long)nb);
            if (nb >= 0) to_add.push_back(nb);
            else hull_blocked = true;
          }
        }
      }
      if (ok && touched) {
        // swallow check: a vertex whose entire star fell inside the cavity
        // would be orphaned by the fan — absorb its remaining tets and keep
        // growing instead
        std::set<int64_t> cav_verts, bverts;
        for (int64_t tid : cavity) {
          auto T = mb.tet_verts(tid);
          for (int j = 0; j < 4; ++j) cav_verts.insert(T[j]);
          for (int j = 0; j < 4; ++j) {
            int64_t a = T[OPP_IN[j][0]], b = T[OPP_IN[j][1]], c = T[OPP_IN[j][2]];
            int64_t nb = mb.face_neighbor(tid, a, b, c);
            bool internal = false;
            for (int64_t c2 : cavity)
              if (c2 == nb) internal = true;
            if (internal) continue;
            bverts.insert(a);
            bverts.insert(b);
            bverts.insert(c);
          }
        }
        bool prot_swallowed = false;
        for (int64_t v : cav_verts) {
          if (bverts.count(v) || !mb.prot.count(v)) continue;
          prot_swallowed = true;
          if (blocker) *blocker = v;
          break;
        }
        if (prot_swallowed) {
          // a protected vertex (source / chain point) would be orphaned; no
          // growth can fix that — refuse this insertion
          if (dbg) fprintf(stderr, "QINS tier=%d grow=%d protected swallow (%zu)\n",
                           tier, grow, cavity.size());
          break;
        }
        int64_t vid = cavity_fan(mb, cavity, x, -1);
        if (vid >= 0) return vid;
        if (dbg) fprintf(stderr, "QINS tier=%d grow=%d fan refused (%zu tets)\n",
                         tier, grow, cavity.size());
        break;  // fan refused: retry laxer tier
      }
      if (ok && !touched) {
        if (dbg) fprintf(stderr, "QINS tier=%d grow=%d untouched (%zu tets)\n",
                         tier, grow, cavity.size());
        break;  // grew away from the required vertex
      }
      if (hull_blocked || to_add.empty()) {
        if (dbg) fprintf(stderr, "QINS tier=%d grow=%d %s (%zu tets)\n", tier, grow,
                         hull_blocked ? "hull" : "no-growth", cavity.size());
        break;
      }
      for (int64_t nb : to_add) {
        bool have = false;
        for (int64_t c2 : cavity)
          if (c2 == nb) have = true;
        if (!have) cavity.push_back(nb);
      }
      if (cavity.size() > 48) {
        if (dbg) fprintf(stderr, "QINS grow cap (%zu tets)\n", cavity.size());
        break;
      }
    }
    (void)tier;
    if (dbg) fprintf(stderr, "QINS exhausted (%zu tets)\n", cavity.size());
  }
  return -1;
}

// Adaptive vertex-connect: grow a cavity from seed_tet (a tet at the far
// vertex u) until it is star-shaped from the existing vertex `hub`, then fan
// from hub — creating edges from hub to every cavity-boundary vertex
// (including u).  The quality_insert of connections.
bool quality_connect(XMesh& mb, int64_t hub, int64_t seed_tet, double min_h,
                     int64_t* blocker) {
  const Q3 x = mb.q[hub];
  const bool dbg = getenv("SHM3D_DEBUG") != nullptr;
  std::vector<int64_t> cavity{seed_tet};
  for (int grow = 0; grow < 48; ++grow) {
    std::vector<int64_t> to_add;
    bool ok = true, hull_blocked = false;
    std::set<int64_t> cav_verts, bverts;
    for (int64_t tid : cavity) {
      auto T = mb.tet_verts(tid);
      for (int j = 0; j < 4; ++j) cav_verts.insert(T[j]);
      for (int j = 0; j < 4; ++j) {
        int64_t a = T[OPP_IN[j][0]], b = T[OPP_IN[j][1]], c = T[OPP_IN[j][2]];
        int64_t nb = mb.face_neighbor(tid, a, b, c);
        bool internal = false;
        for (int64_t c2 : cavity)
          if (c2 == nb) internal = true;
        if (internal) continue;
        bverts.insert(a);
        bverts.insert(b);
        bverts.insert(c);
        if (a == hub || b == hub || c == hub) continue;  // lateral wall
        i128 s = orient(mb.q[a], mb.q[b], mb.q[c], x);
        bool bad = s <= 0;
        if (!bad && min_h > 0) {
          double cn = face_cross_norm(mb, a, b, c);
          if (cn <= 0 || d128(s) / cn < min_h) bad = true;
        }
        if (bad) {
          ok = false;
          if (nb >= 0) to_add.push_back(nb);
          else hull_blocked = true;
        }
      }
    }
    if (ok) {
      for (int64_t v2 : cav_verts)
        if (!bverts.count(v2) && mb.prot.count(v2)) {
          if (dbg) fprintf(stderr, "QCON protected swallow (%zu)\n", cavity.size());
          if (blocker) *blocker = v2;
          return false;
        }
      if (cavity_fan(mb, cavity, x, hub) >= 0) return true;
      if (dbg) fprintf(stderr, "QCON fan refused (%zu)\n", cavity.size());
      return false;
    }
    if (hull_blocked || to_add.empty()) {
      if (dbg) fprintf(stderr, "QCON %s (%zu)\n",
                       hull_blocked ? "hull" : "no-growth", cavity.size());
      return false;
    }
    for (int64_t nb : to_add) {
      bool have = false;
      for (int64_t c2 : cavity)
        if (c2 == nb) have = true;
      if (!have) cavity.push_back(nb);
    }
    if (cavity.size() > 48) {
      if (dbg) fprintf(stderr, "QCON grow cap (%zu)\n", cavity.size());
      return false;
    }
  }
  return false;
}

// Segment recovery by divide and conquer: find a well-placed point on (or
// quanta-near) the open segment, insert it with quality_insert (no adjacency
// requirement), and recurse on the two sub-segments; chain adjacency emerges
// at the leaves, where the sub-segment endpoints share a tet.  Every
// strategy either resolves a segment, routes it through a nearby existing
// vertex (once, per the visited set), or strictly shortens it by at least
// the dedup radius — so the per-edge budget is only a backstop.
void recover_edge(XMesh& mb, int64_t va, int64_t vb) {
  std::vector<std::pair<int64_t, int64_t>> stack;
  stack.emplace_back(va, vb);
  std::unordered_set<int64_t> visited;
  visited.insert(va);
  visited.insert(vb);
  mb.prot.insert(va);
  mb.prot.insert(vb);
  std::vector<int64_t> st;
  int budget = 20000;
  const bool dbg = getenv("SHM3D_DEBUG") != nullptr;

  while (!stack.empty()) {
    auto [u, v] = stack.back();
    stack.pop_back();
    if (u == v || mb.edge_exists(u, v)) continue;
    if (--budget < 0) throw XFail("edge recovery budget exhausted (exact)");
    {
      // a sub-slab chain gap is within the lateral-deviation budget the
      // piercing/extraction tolerances already absorb; no insertion can
      // land in it anyway (the dedup balls of u and v cover it)
      const Q3 &qu2 = mb.q[u], &qv2 = mb.q[v];
      double dx = (double)(qv2.x - qu2.x), dy = (double)(qv2.y - qu2.y),
             dz = (double)(qv2.z - qu2.z);
      if (dx * dx + dy * dy + dz * dz <
          (TOL_P * (double)QUNIT) * (TOL_P * (double)QUNIT))
        continue;
    }

    // cone selection at u toward v
    const Q3 B = mb.q[v];
    mb.star(u, st);
    int64_t chosen = -1, fu = -1, fv = -1, fw = -1;
    i128 oc = 0, ob = 0;
    for (int64_t tid : st) {
      auto T = mb.tet_verts(tid);
      int ic = 0;
      for (int j = 0; j < 4; ++j)
        if (T[j] == u) { ic = j; break; }
      int64_t tu = T[OPP_IN[ic][0]], tv = T[OPP_IN[ic][2]], tw = T[OPP_IN[ic][1]];
      const Q3 &qc = mb.q[u], &qu = mb.q[tu], &qv = mb.q[tv], &qw = mb.q[tw];
      if (orient(qc, qu, qv, B) < 0) continue;
      if (orient(qc, qv, qw, B) < 0) continue;
      if (orient(qc, qw, qu, B) < 0) continue;
      i128 o_cur = orient(qu, qv, qw, qc);
      i128 o_b = orient(qu, qv, qw, B);
      if (sgn(o_b) == sgn(o_cur) || o_b == 0) continue;
      chosen = tid;
      fu = tu; fv = tv; fw = tw; oc = o_cur; ob = o_b;
      break;
    }
    if (chosen < 0) throw XFail("edge walk: no cone tet (exact)");
    double t = d128(oc) / (d128(oc) - d128(ob));
    t = std::min(std::max(t, 0.0), 1.0);
    const V3 pu = mb.pos(u), pv = mb.pos(v);
    V3 e = pu + (pv - pu) * t;

    // 1. route through a grazed existing vertex (once)
    const Q3 Xc = mb.quantize(e);
    int64_t w_near = mb.nearest_vert(Xc, DEDUP_Q);
    if (w_near >= 0) {
      if (w_near != u && w_near != v && !visited.count(w_near)) {
        visited.insert(w_near);
        mb.prot.insert(w_near);
        stack.emplace_back(w_near, v);
        stack.emplace_back(u, w_near);
        continue;
      }
    } else {
      // 2. quality insertion at the crossing; a protected blocker in the
      // corridor becomes a routing waypoint instead
      int64_t blk = -1;
      int64_t x = quality_insert_graded(mb, Xc, chosen, &blk);
      if (x >= 0) {
        visited.insert(x);
        mb.prot.insert(x);
        stack.emplace_back(x, v);
        stack.emplace_back(u, x);
        continue;
      }
      if (blk >= 0 && blk != u && blk != v && !visited.count(blk)) {
        visited.insert(blk);
        stack.emplace_back(blk, v);
        stack.emplace_back(u, blk);
        continue;
      }
    }

    // 3. corridor hop: an adjacent unvisited vertex near the segment line
    {
      V3 useg = pv - pu;
      double L = norm(useg);
      if (L <= 0) continue;
      useg = useg * (1.0 / L);
      const double crad = TOL_P * mb.h;
      int64_t best_w = -1;
      double best_p = 1e-12 * mb.h;
      for (int64_t tid : st) {
        auto T = mb.tet_verts(tid);
        for (int j = 0; j < 4; ++j) {
          int64_t w = T[j];
          if (w == u || visited.count(w)) continue;
          V3 d = mb.pos(w) - pu;
          double t_along = dot(d, useg);
          if (t_along <= best_p || t_along > L * (1.0 + 1e-12)) continue;
          double perp2 = dot(d, d) - t_along * t_along;
          if (perp2 > crad * crad) continue;
          best_p = t_along;
          best_w = w;
        }
      }
      if (best_w >= 0) {
        visited.insert(best_w);
        mb.prot.insert(best_w);
        stack.emplace_back(best_w, v);  // (u, best_w) is already a mesh edge
        continue;
      }
    }

    // 4. cavity carve: advance to a dedup-clear point and fan the tube
    {
      V3 useg = pv - pu;
      double ul = norm(useg);
      useg = ul > 0 ? useg * (1.0 / ul) : useg;
      std::vector<int64_t> cavity;
      int64_t nxt = -1;
      for (int k = 1; k <= 16 && nxt < 0; ++k) {
        double adv = (double)k * 1.5 * DEDUP_Q * mb.delta;
        if (t * ul + adv > ul - DEDUP_Q * mb.delta) break;
        V3 tgt = e + useg * adv;
        Q3 Xq = mb.quantize(tgt);
        if (mb.vhash.count(Xq) || mb.nearest_vert(Xq, DEDUP_Q) >= 0) {
          if (dbg) fprintf(stderr, "CARVE k=%d near-vert\n", k);
          continue;
        }
        nxt = quality_insert_graded(mb, Xq, chosen);
        if (dbg && nxt < 0) fprintf(stderr, "CARVE k=%d qinsert refused\n", k);
      }
      if (nxt >= 0) {
        visited.insert(nxt);
        mb.prot.insert(nxt);
        stack.emplace_back(nxt, v);
        stack.emplace_back(u, nxt);
        continue;
      }
      // close to v: grow an adaptive cavity from u's cone tet and fan from v
      if (ul < 2.0 * mb.h) {
        int64_t blk = -1;
        if (quality_connect(mb, v, chosen, 2.0, &blk))
          continue;  // edge (u,v) now exists via the fan
        if (blk >= 0 && blk != u && blk != v && !visited.count(blk)) {
          visited.insert(blk);
          stack.emplace_back(blk, v);
          stack.emplace_back(u, blk);
          continue;
        }
      }
    }

    // 5. exact 2-3 flip across the exit face, then retry this segment
    if (flip23_connect(mb, u, chosen, fu, fv, fw) >= 0) {
      stack.emplace_back(u, v);
      continue;
    }

    if (dbg)
      fprintf(stderr,
              "XBLOCK u=%lld v=%lld t=%.3e rem=%.3e w_near=%lld budget=%d\n",
              (long long)u, (long long)v, t, norm(pv - pu) / mb.h,
              (long long)w_near, budget);
    throw XFail("edge walk blocked (exact)");
  }
}

// ---------------------------------------------------------------------------
// face recovery

void tri_bary(const V3& X, const V3& a, const V3& b, const V3& c,
              double& al, double& be, double& ga) {
  V3 v0 = b - a, v1 = c - a, v2 = X - a;
  double d00 = dot(v0, v0), d01 = dot(v0, v1), d11 = dot(v1, v1);
  double den = d00 * d11 - d01 * d01;
  if (den <= 0.0) {
    al = be = ga = -1.0;
    return;
  }
  double d20 = dot(v2, v0), d21 = dot(v2, v1);
  be = (d11 * d20 - d01 * d21) / den;
  ga = (d00 * d21 - d01 * d20) / den;
  al = 1.0 - be - ga;
}

void face_candidate_tets(const XMesh& mb, const V3& a, const V3& b, const V3& c,
                         std::vector<int64_t>& out) {
  V3 lo = {std::min({a.x, b.x, c.x}), std::min({a.y, b.y, c.y}), std::min({a.z, b.z, c.z})};
  V3 hi = {std::max({a.x, b.x, c.x}), std::max({a.y, b.y, c.y}), std::max({a.z, b.z, c.z})};
  int64_t i0, j0, k0, i1, j1, k1;
  mb.cell_of(lo, i0, j0, k0);
  mb.cell_of(hi, i1, j1, k1);
  mb.tets_in_cells(i0 - 1, i1 + 1, j0 - 1, j1 + 1, k0 - 1, k1 + 1, out);
}

constexpr int EDGE_IDX[6][2] = {{0, 1}, {0, 2}, {0, 3}, {1, 2}, {1, 3}, {2, 3}};

static long g_dbg_graze = 0, g_dbg_refused = 0;

void recover_face(XMesh& mb, int64_t v0, int64_t v1, int64_t v2) {
  if (getenv("SHM3D_DEBUG")) { g_dbg_graze = 0; g_dbg_refused = 0; }
  const Q3 A0 = mb.q[v0], A1 = mb.q[v1], A2 = mb.q[v2];
  // exact integer plane normal (components <= 2^66)
  const int64_t ux = A1.x - A0.x, uy = A1.y - A0.y, uz = A1.z - A0.z;
  const int64_t wx = A2.x - A0.x, wy = A2.y - A0.y, wz = A2.z - A0.z;
  const i128 nx = (i128)uy * wz - (i128)uz * wy;
  const i128 ny = (i128)uz * wx - (i128)ux * wz;
  const i128 nz = (i128)ux * wy - (i128)uy * wx;
  const double nlen = std::sqrt(d128(nx) * d128(nx) + d128(ny) * d128(ny) +
                                d128(nz) * d128(nz));
  if (nlen <= 0.0) return;  // degenerate face
  const V3 a = mb.pos(v0), b = mb.pos(v1), c = mb.pos(v2);
  // slab half-width in the integer plane functional: dist = f / (nlen*delta)
  const double slab = TOL_P * mb.h * nlen / mb.delta;

  // packed-key resolved set (vertex ids < 2^32 by construction)
  std::unordered_set<uint64_t> resolved;
  auto ekey = [](int64_t p, int64_t q2) {
    return ((uint64_t)p << 32) | (uint64_t)q2;
  };
  std::vector<int64_t> tids;
  // One pass collects EVERY piercing candidate edge (straddle test inline —
  // the former per-pass std::set of all candidate edges cost 727M red-black
  // tree inserts on knot@96 = 37 s; a straddle test is two exact plane
  // functionals) and processes them in one sweep, re-validating liveness
  // per edge since earlier insertions mutate the mesh.  Later passes only
  // catch edges newly created by those insertions.
  for (int pass = 0; pass < 128; ++pass) {
    face_candidate_tets(mb, a, b, c, tids);
    std::vector<std::pair<int64_t, int64_t>> cand;
    for (int64_t tid : tids) {
      auto T = mb.tet_verts(tid);
      for (const auto& e : EDGE_IDX) {
        int64_t p = T[e[0]], q2 = T[e[1]];
        if (p > q2) std::swap(p, q2);
        const Q3 &P = mb.q[p], &Q = mb.q[q2];
        i128 fp = nx * (P.x - A0.x) + ny * (P.y - A0.y) + nz * (P.z - A0.z);
        i128 fq = nx * (Q.x - A0.x) + ny * (Q.y - A0.y) + nz * (Q.z - A0.z);
        double dp = d128(fp), dq = d128(fq);
        // pierce: strictly outside the slab on opposite sides
        if (!((dp > slab && dq < -slab) || (dp < -slab && dq > slab))) continue;
        cand.emplace_back(p, q2);
      }
    }
    std::sort(cand.begin(), cand.end());
    cand.erase(std::unique(cand.begin(), cand.end()), cand.end());
    int inserted = 0;
    for (const auto& e : cand) {
      if (resolved.count(ekey(e.first, e.second))) continue;
      // an earlier insertion this pass may have destroyed the edge
      if (!mb.edge_exists(e.first, e.second)) continue;
      const Q3 &P = mb.q[e.first], &Q = mb.q[e.second];
      // exact signed plane functionals (<= 2^99)
      i128 fp = nx * (P.x - A0.x) + ny * (P.y - A0.y) + nz * (P.z - A0.z);
      i128 fq = nx * (Q.x - A0.x) + ny * (Q.y - A0.y) + nz * (Q.z - A0.z);
      double dp = d128(fp), dq = d128(fq);
      double t = dp / (dp - dq);
      V3 Pp = mb.pos(e.first), Qp = mb.pos(e.second);
      V3 X = Pp + (Qp - Pp) * t;
      double al, be, ga;
      tri_bary(X, a, b, c, al, be, ga);
      if (al < -1e-7 || be < -1e-7 || ga < -1e-7) continue;  // outside the face
      Q3 xq = mb.quantize(X);
      // the crossing lies on edge e: its ring tets contain it — locate there
      static thread_local std::vector<int64_t> st;
      mb.star(e.first, st);
      // dedup ball: reuse nearby vertices instead of minting delta-thin
      // slivers (same discipline as the edge walk; certificate arbitrates)
      int64_t graze = mb.nearest_vert(xq, DEDUP_Q);
      if (mb.vhash.count(xq) || graze >= 0) {
        // A grazed crossing left unresolved is a HOLE: edge e still pierces
        // the face but its crossing point was never materialized (measured
        // on bunny_small: 6 grazes -> 6 area-certificate failures, each a
        // single missing sliver).  The slab admits a whole segment of e
        // (half-width TOL_P plane distance = 384 quanta >> the 64-quanta
        // dedup ball), so slide the insertion along e, staying inside the
        // slab and the face, until it exits every dedup ball.
        bool placed = false;
        double elen = norm(Qp - Pp);
        if (elen > 0.0) {
          for (double mult : {2.0, -2.0, 3.0, -3.0, 4.5, -4.5, 6.0, -6.0}) {
            double t2 = t + mult * DEDUP_Q * mb.delta / elen;
            if (t2 <= 1e-6 || t2 >= 1.0 - 1e-6) continue;
            double f2 = dp + t2 * (dq - dp);
            if (std::abs(f2) > slab) continue;  // left the on-plane slab
            V3 X2 = Pp + (Qp - Pp) * t2;
            double al2, be2, ga2;
            tri_bary(X2, a, b, c, al2, be2, ga2);
            if (al2 < -1e-7 || be2 < -1e-7 || ga2 < -1e-7) continue;
            Q3 xq2 = mb.quantize(X2);
            if (mb.vhash.count(xq2) || mb.nearest_vert(xq2, DEDUP_Q) >= 0)
              continue;
            int64_t xin = quality_insert_graded(mb, xq2);
            if (xin >= 0) {
              mb.prot.insert(xin);
              ++inserted;
              placed = true;
              break;
            }
          }
        }
        if (placed) continue;
        // last resort: force the crossing in with NO quality floor (exact
        // positivity is still verified by the split primitive).  A hole is
        // strictly worse than a sliver — the FEM operators carry sliver
        // caps (shm3d/tet/fem.py) precisely so recovery can afford this.
        // At most one forced insertion per pierced edge (resolved either
        // way), so cascades stay bounded.
        if (!mb.vhash.count(xq)) {
          int64_t xin = quality_insert(mb, xq, 0.0, -1);
          if (xin >= 0) {
            mb.prot.insert(xin);
            ++inserted;
            continue;
          }
        }
        if (graze >= 0) mb.prot.insert(graze);  // de-facto tiling corner
        resolved.insert(ekey(e.first, e.second));
        if (getenv("SHM3D_DEBUG")) g_dbg_graze++;
        continue;
      }
      int64_t xin = quality_insert_graded(mb, xq);
      if (xin < 0) xin = quality_insert(mb, xq, 0.0, -1);  // sliver over hole
      if (xin >= 0) {
        mb.prot.insert(xin);
        ++inserted;
      } else {
        resolved.insert(ekey(e.first, e.second));  // locally refused: the certificate arbitrates
        if (getenv("SHM3D_DEBUG")) g_dbg_refused++;
      }
    }
    if (inserted == 0) return;
  }
  throw XFail("face recovery exceeded pass guard (exact)");
}

// ---------------------------------------------------------------------------
// extraction (double precision, certificate-arbitrated — mirrors
// lattice_tet.cpp extract_subfaces / conforming._extract_subfaces)

// Hard per-face floor for the two-tier certificate: a face tiling less
// than this fraction of its area fails outright; smaller holes are
// tolerated when the TOTAL deficit over the whole surface stays under
// CERT_TOTAL (the caller's check) — the unpinned slack is then comparable to the
// grid path's subsampled pinning (~1e-3 relative), far better than losing
// the whole CR path to the vertex fallback over one sliver.
constexpr double CERT_FACE_HARD = 5e-2;
constexpr double CERT_TOTAL = 3e-3;

void extract_subfaces(const XMesh& mb, int64_t v0, int64_t v1, int64_t v2,
                      int64_t fi, std::vector<std::array<int64_t, 3>>& tris,
                      std::vector<int64_t>& parents,
                      double* area_out, double* deficit_out) {
  V3 a = mb.pos(v0), b = mb.pos(v1), c = mb.pos(v2);
  V3 nr = cross(b - a, c - a);
  double area = 0.5 * norm(nr);
  if (area <= 0.0) return;
  *area_out += area;
  nr = nr * (1.0 / (2.0 * area));
  const double tole = TOL_E * mb.h;

  std::vector<int64_t> tids;
  face_candidate_tets(mb, a, b, c, tids);
  std::set<std::array<int64_t, 3>> seen;
  std::vector<std::array<int64_t, 3>> cand;
  std::vector<double> cand_off;
  for (int64_t tid : tids) {
    auto T = mb.tet_verts(tid);
    double d[4];
    for (int j = 0; j < 4; ++j) d[j] = dot(mb.pos(T[j]) - a, nr);
    for (int j = 0; j < 4; ++j) {
      // face opposite vertex j
      int64_t f0 = T[OPP_IN[j][0]], f1 = T[OPP_IN[j][1]], f2 = T[OPP_IN[j][2]];
      double off = std::max({std::abs(d[OPP_IN[j][0]]), std::abs(d[OPP_IN[j][1]]),
                             std::abs(d[OPP_IN[j][2]])});
      if (off > tole) continue;
      V3 ctr = (mb.pos(f0) + mb.pos(f1) + mb.pos(f2)) * (1.0 / 3.0);
      double al, be, ga;
      tri_bary(ctr, a, b, c, al, be, ga);
      if (al < -1e-7 || be < -1e-7 || ga < -1e-7) continue;
      std::array<int64_t, 3> key = {f0, f1, f2};
      std::sort(key.begin(), key.end());
      if (!seen.insert(key).second) continue;
      cand.push_back({f0, f1, f2});
      cand_off.push_back(off);
    }
  }
  if (cand.empty()) throw XFail("extract: no on-plane tet faces (exact)");
  // The recovery leaves several delta-separated near-plane sheets (fan faces
  // around chain vertices); the tiling is ONE sheet.  Greedy selection by
  // off-plane distance, rejecting faces whose barycenter projects inside an
  // already-accepted face, picks a single non-overlapping cover.
  std::vector<size_t> order(cand.size());
  for (size_t i = 0; i < order.size(); ++i) order[i] = i;
  std::stable_sort(order.begin(), order.end(),
                   [&](size_t x, size_t y) { return cand_off[x] < cand_off[y]; });
  std::vector<std::array<int64_t, 3>> local;
  double sub_area = 0.0;
  for (size_t oi : order) {
    const auto& t = cand[oi];
    V3 p0 = mb.pos(t[0]), p1 = mb.pos(t[1]), p2 = mb.pos(t[2]);
    V3 ctr = (p0 + p1 + p2) * (1.0 / 3.0);
    bool dup = false;
    for (const auto& s : local) {
      V3 s0 = mb.pos(s[0]), s1 = mb.pos(s[1]), s2 = mb.pos(s[2]);
      double al, be, ga;
      tri_bary(ctr, s0, s1, s2, al, be, ga);
      if (al > 1e-9 && be > 1e-9 && ga > 1e-9) {
        dup = true;
        break;
      }
    }
    if (dup) continue;
    local.push_back(t);
    sub_area += 0.5 * norm(cross(p1 - p0, p2 - p0));
  }
  // asymmetric certificate: deficit = tiling hole (hard fail below the
  // per-face floor; small holes accumulate into the total-deficit check);
  // bounded excess = double-claimed coplanar neighbors (tolerated)
  if (sub_area < area) *deficit_out += area - sub_area;
  if (sub_area < (1.0 - CERT_FACE_HARD) * area || sub_area > 2.0 * area) {
    if (getenv("SHM3D_DEBUG")) {
      fprintf(stderr, "XCERT face=%lld area=%.6e sub=%.6e ratio=%.4f ntris=%zu\n",
              (long long)fi, area, sub_area, sub_area / area, local.size());
      // dump every candidate's classification to identify the hole
      for (int64_t tid : tids) {
        auto T = mb.tet_verts(tid);
        double d[4];
        for (int j = 0; j < 4; ++j) d[j] = dot(mb.pos(T[j]) - a, nr);
        for (int j = 0; j < 4; ++j) {
          int64_t f0 = T[OPP_IN[j][0]], f1 = T[OPP_IN[j][1]], f2 = T[OPP_IN[j][2]];
          double off = std::max({std::abs(d[OPP_IN[j][0]]),
                                 std::abs(d[OPP_IN[j][1]]),
                                 std::abs(d[OPP_IN[j][2]])});
          if (off > 20.0 * tole) continue;
          V3 ctr = (mb.pos(f0) + mb.pos(f1) + mb.pos(f2)) * (1.0 / 3.0);
          double al, be, ga;
          tri_bary(ctr, a, b, c, al, be, ga);
          V3 p0 = mb.pos(f0), p1 = mb.pos(f1), p2 = mb.pos(f2);
          double ar = 0.5 * norm(cross(p1 - p0, p2 - p0));
          fprintf(stderr,
                  "  cand f=(%lld,%lld,%lld) off/tole=%.3f bary=(%.2e,%.2e,%.2e)"
                  " area/face=%.4f\n",
                  (long long)f0, (long long)f1, (long long)f2, off / tole,
                  al, be, ga, ar / area);
        }
      }
    }
    throw XFail("extract: sub-face area certificate failed (exact)");
  }
  for (const auto& t : local) {
    tris.push_back(t);
    parents.push_back(fi);
  }
}

void pack_result(const XMesh& mb, ShmResult& res) {
  int64_t NV = (int64_t)mb.q.size();
  res.vertices.resize(NV * 3);
  for (int64_t i = 0; i < NV; ++i) {
    V3 p = mb.pos(i);
    res.vertices[3 * i] = p.x;
    res.vertices[3 * i + 1] = p.y;
    res.vertices[3 * i + 2] = p.z;
  }
  res.tets.clear();
  for (int64_t t = 0; t < mb.nbase(); ++t)
    if (!mb.base_dead[t])
      for (int m = 0; m < 4; ++m) res.tets.push_back(mb.base_tets[t][m]);
  for (size_t t = 0; t < mb.extra_tets.size(); ++t)
    if (!mb.extra_dead[t])
      for (int m = 0; m < 4; ++m) res.tets.push_back(mb.extra_tets[t][m]);
}

}  // namespace exactconf

extern "C" {

// Exact conforming build.  Same handle contract as shm3d_conforming_build:
// on recovery failure the handle carries the (valid, non-conforming) mesh
// with surf_tris empty and fail_reason set.
void* shm3d_conforming_build_exact(const double* src_xyz, int64_t V,
                                   const int64_t* faces, int64_t F,
                                   double cx, double cy, double cz,
                                   double half_side, int resolution) {
  using namespace exactconf;
  XMesh mb;
  auto* res = new ShmResult();
  const bool timing = getenv("SHM3D_TIMING") != nullptr;
  auto t0 = std::chrono::steady_clock::now();
  auto lap = [&](const char* phase) {
    if (!timing) return;
    auto t1 = std::chrono::steady_clock::now();
    fprintf(stderr, "XTIME %-8s %8.2f s  (nv=%zu nt=%zu+%zu)\n", phase,
            std::chrono::duration<double>(t1 - t0).count(), mb.q.size(),
            mb.base_tets.size(), mb.extra_tets.size());
    t0 = t1;
  };
  try {
    const char* gr = getenv("SHM3D_GRADED");
    if (F > 0 && !(gr && gr[0] == '0'))
      build_lattice_graded(mb, cx, cy, cz, half_side, resolution,
                           src_xyz, V, faces, F);
    else
      build_lattice(mb, cx, cy, cz, half_side, resolution);
    lap("lattice");
    insert_sources(mb, *res, src_xyz, V);
    lap("sources");
  } catch (XFail& e) {
    delete res;
    return nullptr;
  }
  // Wall-clock budget: recovery cost is input-dependent (scans whose
  // features fall below the lattice scale blow up in Steiner insertions —
  // knot/rocker/chair exceed 20+ minutes), and the caller has a documented
  // fallback (the reference's own non-conforming vertex path,
  // signed_heat_tet_solver.cpp:24-33).  Checked per edge/face (a check is a
  // ~20 ns clock read; a single constraint's walk can take minutes on
  // pathological inputs, so coarser check spacing let runs far exceed the
  // budget), so the bound is budget + one constraint's worst case.
  double budget_s = 300.0;
  if (const char* b = getenv("SHM3D_RECOVERY_BUDGET_S")) {
    double v = atof(b);
    if (v > 0.0) budget_s = v;
  }
  const auto t_start = std::chrono::steady_clock::now();
  auto over_budget = [&]() {
    return std::chrono::duration<double>(std::chrono::steady_clock::now() -
                                         t_start).count() > budget_s;
  };
  try {
    if (F == 0) throw XFail("no source faces");
    std::vector<std::pair<int64_t, int64_t>> E;
    E.reserve(F * 3);
    for (int64_t f = 0; f < F; ++f) {
      int64_t m[3] = {res->vertex_of[faces[3 * f]], res->vertex_of[faces[3 * f + 1]],
                      res->vertex_of[faces[3 * f + 2]]};
      const int eidx[3][2] = {{0, 1}, {1, 2}, {2, 0}};
      for (const auto& e : eidx) {
        int64_t u = m[e[0]], v = m[e[1]];
        if (u > v) std::swap(u, v);
        if (u != v) E.emplace_back(u, v);
      }
    }
    std::sort(E.begin(), E.end());
    E.erase(std::unique(E.begin(), E.end()), E.end());
    const bool dbg = getenv("SHM3D_DEBUG") != nullptr;
    for (size_t ei = 0; ei < E.size(); ++ei) {
      if (dbg && ei % 5000 == 0)
        fprintf(stderr, "XPROG edge %zu/%zu nv=%zu\n", ei, E.size(), mb.q.size());
      if (over_budget())
        throw XFail("recovery time budget exceeded (exact)");
      recover_edge(mb, E[ei].first, E[ei].second);
    }
    if (dbg) fprintf(stderr, "XPROG edges done nv=%zu\n", mb.q.size());
    lap("edges");

    for (int64_t f = 0; f < F; ++f) {
      int64_t v0 = res->vertex_of[faces[3 * f]], v1 = res->vertex_of[faces[3 * f + 1]],
              v2 = res->vertex_of[faces[3 * f + 2]];
      if (v0 == v1 || v1 == v2 || v0 == v2) continue;
      if (getenv("SHM3D_DEBUG") && f % 2000 == 0)
        fprintf(stderr, "XPROG face %lld/%lld nv=%zu\n", (long long)f,
                (long long)F, mb.q.size());
      if (over_budget())
        throw XFail("recovery time budget exceeded (exact)");
      recover_face(mb, v0, v1, v2);
      if (getenv("SHM3D_DEBUG") && (g_dbg_graze || g_dbg_refused))
        fprintf(stderr, "XFACE f=%lld graze=%ld refused=%ld\n",
                (long long)f, g_dbg_graze, g_dbg_refused);
    }
    lap("faces");

    std::vector<std::array<int64_t, 3>> tris;
    std::vector<int64_t> parents;
    double cert_area = 0.0, cert_deficit = 0.0;
    for (int64_t f = 0; f < F; ++f) {
      int64_t v0 = res->vertex_of[faces[3 * f]], v1 = res->vertex_of[faces[3 * f + 1]],
              v2 = res->vertex_of[faces[3 * f + 2]];
      if (v0 == v1 || v1 == v2 || v0 == v2) continue;
      extract_subfaces(mb, v0, v1, v2, f, tris, parents,
                       &cert_area, &cert_deficit);
    }
    if (tris.empty()) throw XFail("no recoverable faces");
    if (cert_deficit > CERT_TOTAL * cert_area) {
      if (getenv("SHM3D_DEBUG"))
        fprintf(stderr, "XCERT total deficit %.3e of area %.3e (%.4f%%)\n",
                cert_deficit, cert_area, 100.0 * cert_deficit / cert_area);
      throw XFail("extract: total area-deficit certificate failed (exact)");
    }
    res->surf_tris.reserve(tris.size() * 3);
    for (const auto& t : tris) {
      res->surf_tris.push_back(t[0]);
      res->surf_tris.push_back(t[1]);
      res->surf_tris.push_back(t[2]);
    }
    res->surf_parent = std::move(parents);
    lap("extract");
  } catch (XFail& e) {
    res->surf_tris.clear();
    res->surf_parent.clear();
    res->fail_reason = e.what;
    lap("FAILED");
  }
  exactconf::pack_result(mb, *res);
  lap("pack");
  return res;
}

}  // extern "C"
