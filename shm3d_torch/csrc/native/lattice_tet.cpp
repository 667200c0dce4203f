// Native core of the Kuhn-lattice stuffing tet mesher (shm3d/tet/mesher.py)
// including conforming surface recovery (shm3d/tet/conforming.py).
//
// The reference uses TetGen (C++) for its tet meshing, including the
// surface-conforming constrained Delaunay path
// (reference src/signed_heat_tet_solver.cpp:885-1241).  This module is
// the native equivalent for the TPU-era mesher: it runs the sequential parts
// of the algorithm — greedy node snapping, split insertion of source
// vertices, and Steiner-insertion edge/face recovery — which dominate host
// precompute time in the Python implementation.  Vectorizable finalization
// (faces, adjacency, reordering) stays in NumPy.
//
// Exposed as a plain C ABI consumed via ctypes (no pybind11 in this image).
// Algorithm, data layout, iteration order, and tolerances mirror
// shm3d/tet/mesher.py + shm3d/tet/conforming.py exactly; the Python
// implementation remains as the correctness oracle (tests compare both).

#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <cstdint>
#include <cstring>
#include <algorithm>
#include <array>
#include <unordered_map>
#include <set>
#include <string>
#include <unordered_set>
#include <vector>

#include "shm3d_common.h"

namespace {

using std::int64_t;

constexpr int KUHN[6][4] = {
    {0, 1, 3, 7}, {0, 3, 2, 7}, {0, 2, 6, 7},
    {0, 6, 4, 7}, {0, 4, 5, 7}, {0, 5, 1, 7},
};
constexpr double SNAP_ALPHA = 0.35;   // source-vertex snap (pass 1)
// Recovery tolerance ladder (mirrors shm3d/tet/conforming.py):
// delta_p (~1e-7 h, projection) < DEDUP (1e-9 h)... see the Python module
constexpr double INSERT_EPS = 1e-7;   // recovery-insert classification
constexpr double DEDUP_REC = 1e-9;    // recovery dedup, fraction of cell
constexpr double TOL_P = 1e-6;        // piercing threshold, fraction of cell
constexpr double TOL_E = 1e-5;        // on-plane membership, fraction of cell
constexpr double CERT = 1e-4;         // relative area-certificate slack
constexpr double SNAP_FRAC = 0.15;    // recovery warp, fraction of cell

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

struct ConformFail {  // recovery failure -> caller falls back (Python warns)
  const char* what;
  explicit ConformFail(const char* w) : what(w) {}
};

struct Builder {
  int nl, npts;
  V3 bmin;
  double h;
  std::vector<V3> positions;             // lattice nodes (mutated by snaps)
  std::vector<V3> extra_verts;
  std::vector<std::array<int64_t, 4>> base_tets;
  std::vector<char> base_dead;
  std::vector<std::array<int64_t, 4>> extra_tets;
  std::vector<char> extra_dead;
  std::unordered_map<int64_t, std::vector<int64_t>> cell_extra;
  std::unordered_set<int64_t> constrained;

  int64_t n_nodes() const { return (int64_t)positions.size(); }

  V3 vert(int64_t vid) const {
    return vid < n_nodes() ? positions[vid] : extra_verts[vid - n_nodes()];
  }
  void set_vert(int64_t vid, const V3& p) {
    if (vid < n_nodes()) positions[vid] = p;
    else extra_verts[vid - n_nodes()] = p;
  }
  int64_t add_vert(const V3& p) {
    extra_verts.push_back(p);
    return n_nodes() + (int64_t)extra_verts.size() - 1;
  }
  void cell_of(const V3& p, int64_t& ci, int64_t& cj, int64_t& ck) const {
    ci = std::min<int64_t>(std::max<int64_t>((int64_t)std::floor((p.x - bmin.x) / h), 0), nl - 1);
    cj = std::min<int64_t>(std::max<int64_t>((int64_t)std::floor((p.y - bmin.y) / h), 0), nl - 1);
    ck = std::min<int64_t>(std::max<int64_t>((int64_t)std::floor((p.z - bmin.z) / h), 0), nl - 1);
  }
  int64_t cell_lex(int64_t i, int64_t j, int64_t k) const {
    return i + j * nl + (int64_t)k * nl * nl;
  }
  std::array<int64_t, 4> tet_verts(int64_t tid) const {
    return tid < (int64_t)base_tets.size() ? base_tets[tid]
                                           : extra_tets[tid - base_tets.size()];
  }

  // mirrors mesher.live_tets_in_cells: k outer, j, i; per cell base tets
  // ascending then extras in bucket order, extras deduplicated
  void live_tets_in_cells(int64_t ilo, int64_t ihi, int64_t jlo, int64_t jhi,
                          int64_t klo, int64_t khi, std::vector<int64_t>& out) const {
    out.clear();
    const int64_t nbase = (int64_t)base_tets.size();
    std::unordered_set<int64_t> seen_extra;
    for (int64_t k = klo; k <= khi; ++k)
      for (int64_t j = jlo; j <= jhi; ++j)
        for (int64_t i = ilo; i <= ihi; ++i) {
          int64_t lex = cell_lex(i, j, k);
          for (int64_t t = 6 * lex; t < 6 * lex + 6; ++t)
            if (!base_dead[t]) out.push_back(t);
          auto it = cell_extra.find(lex);
          if (it != cell_extra.end())
            for (int64_t e : it->second)
              if (!extra_dead[e] && !seen_extra.count(e)) {
                seen_extra.insert(e);
                out.push_back(nbase + e);
              }
        }
  }

  void nearby_tets(const V3& p, int rings, std::vector<int64_t>& out) const {
    int64_t ci, cj, ck;
    cell_of(p, ci, cj, ck);
    auto lo = [&](int64_t c) { return std::max<int64_t>(c - rings, 0); };
    auto hi = [&](int64_t c) { return std::min<int64_t>(c + rings, nl - 1); };
    live_tets_in_cells(lo(ci), hi(ci), lo(cj), hi(cj), lo(ck), hi(ck), out);
  }

  void vert_tets(int64_t vid, std::vector<int64_t>& out) const {
    std::vector<int64_t> near;
    nearby_tets(vert(vid), 1, near);
    out.clear();
    for (int64_t tid : near) {
      auto t = tet_verts(tid);
      if (t[0] == vid || t[1] == vid || t[2] == vid || t[3] == vid)
        out.push_back(tid);
    }
  }

  bool edge_exists(int64_t u, int64_t v) const {
    std::vector<int64_t> vt;
    vert_tets(u, vt);
    for (int64_t tid : vt) {
      auto t = tet_verts(tid);
      if (t[0] == v || t[1] == v || t[2] == v || t[3] == v) return true;
    }
    return false;
  }

  // barycentric coordinates of p in tet tid (Cramer); min coordinate
  bool bary(int64_t tid, const V3& p, double out[4]) const {
    auto t = tet_verts(tid);
    V3 a = vert(t[0]);
    V3 u = vert(t[1]) - a, v = vert(t[2]) - a, w = vert(t[3]) - a, r = p - a;
    double det = dot(u, cross(v, w));
    if (std::fabs(det) < 1e-300) {
      out[0] = out[1] = out[2] = out[3] = -1.0;
      return false;
    }
    double b1 = dot(r, cross(v, w)) / det;
    double b2 = dot(u, cross(r, w)) / det;
    double b3 = dot(u, cross(v, r)) / det;
    out[0] = 1.0 - b1 - b2 - b3;
    out[1] = b1; out[2] = b2; out[3] = b3;
    return true;
  }

  void replace(int64_t tid, const std::vector<std::array<int64_t, 4>>& news) {
    if (tid < (int64_t)base_tets.size()) base_dead[tid] = 1;
    else extra_dead[tid - base_tets.size()] = 1;
    for (const auto& nt : news) {
      int64_t eid = (int64_t)extra_tets.size();
      extra_tets.push_back(nt);
      extra_dead.push_back(0);
      V3 b = (vert(nt[0]) + vert(nt[1]) + vert(nt[2]) + vert(nt[3])) * 0.25;
      int64_t ci, cj, ck;
      cell_of(b, ci, cj, ck);
      cell_extra[cell_lex(ci, cj, ck)].push_back(eid);
    }
  }

  bool try_move(int64_t vid, const V3& p) {
    std::vector<int64_t> inc;
    vert_tets(vid, inc);
    if (inc.empty()) return false;
    V3 old = vert(vid);
    set_vert(vid, p);
    const double floor_v = 1e-12 * h * h * h;
    for (int64_t tid : inc) {
      auto t = tet_verts(tid);
      V3 a = vert(t[0]);
      double vol = dot(cross(vert(t[1]) - a, vert(t[2]) - a), vert(t[3]) - a) / 6.0;
      if (vol <= floor_v) {
        set_vert(vid, old);
        return false;
      }
    }
    const int64_t nbase = (int64_t)base_tets.size();
    for (int64_t tid : inc) {
      if (tid >= nbase) {
        int64_t eid = tid - nbase;
        auto t = tet_verts(tid);
        V3 b = (vert(t[0]) + vert(t[1]) + vert(t[2]) + vert(t[3])) * 0.25;
        int64_t ci, cj, ck;
        cell_of(b, ci, cj, ck);
        auto& lst = cell_extra[cell_lex(ci, cj, ck)];
        if (std::find(lst.begin(), lst.end(), eid) == lst.end())
          lst.push_back(eid);
      }
    }
    return true;
  }

  V3 feature_point(const V3& p, const std::array<int64_t, 4>& tet,
                   const std::vector<int>& zero, bool project) const {
    if (!project || zero.empty()) return p;
    if (zero.size() == 1) {
      V3 f[3];
      int m = 0;
      for (int j = 0; j < 4; ++j)
        if (j != zero[0]) f[m++] = vert(tet[j]);
      V3 nf = cross(f[1] - f[0], f[2] - f[0]);
      double denom = nf.x * nf.x + nf.y * nf.y + nf.z * nf.z;
      if (denom <= 0.0) return p;
      double k = (nf.x * (p.x - f[0].x) + nf.y * (p.y - f[0].y)
                  + nf.z * (p.z - f[0].z)) / denom;
      return p - nf * k;
    }
    V3 U = {0, 0, 0}, Vv = {0, 0, 0};
    bool first = true;
    for (int j = 0; j < 4; ++j) {
      bool in_zero = false;
      for (int z : zero) in_zero |= (z == j);
      if (in_zero) continue;
      if (first) { U = vert(tet[j]); first = false; }
      else Vv = vert(tet[j]);
    }
    V3 d = Vv - U;
    double dd = d.x * d.x + d.y * d.y + d.z * d.z;
    if (dd <= 0.0) return p;
    double t = (d.x * (p.x - U.x) + d.y * (p.y - U.y) + d.z * (p.z - U.z)) / dd;
    return U + d * t;
  }

  // children use -1 as the placeholder for the new vertex
  using Plan = std::vector<std::pair<int64_t, std::vector<std::array<int64_t, 4>>>>;

  bool split_plan(int64_t tid, const std::array<int64_t, 4>& tet,
                  const std::vector<int>& zero, const V3& q,
                  Plan& plan, int& how_kind) const {
    plan.clear();
    if (zero.empty()) {  // interior: 1 -> 4
      auto [a, b, c, d] = tet;
      plan.push_back({tid, {{-1, b, c, d}, {a, -1, c, d}, {a, b, -1, d}, {a, b, c, -1}}});
      how_kind = 1;
      return true;
    }
    if (zero.size() == 1) {  // on the face opposite corner zero[0]
      int jz = zero[0];
      std::unordered_set<int64_t> fset;
      for (int j = 0; j < 4; ++j)
        if (j != jz) fset.insert(tet[j]);
      std::vector<int64_t> split_tids = {tid};
      std::vector<int64_t> near;
      nearby_tets(q, 1, near);
      for (int64_t other : near) {
        if (other == tid) continue;
        auto ot = tet_verts(other);
        int cnt = 0;
        for (int j = 0; j < 4; ++j) cnt += fset.count(ot[j]);
        if (cnt == 3) { split_tids.push_back(other); break; }
      }
      for (int64_t st : split_tids) {
        auto t = tet_verts(st);
        std::vector<std::array<int64_t, 4>> chs;
        for (int j = 0; j < 4; ++j)
          if (fset.count(t[j])) {
            auto nt = t;
            nt[j] = -1;
            chs.push_back(nt);
          }
        plan.push_back({st, chs});
      }
      how_kind = 1;
      return true;
    }
    if (zero.size() == 2) {  // on the edge between the two live corners
      int64_t u = -2, v = -2;
      for (int j = 0; j < 4; ++j) {
        bool in_zero = false;
        for (int z : zero) in_zero |= (z == j);
        if (in_zero) continue;
        (u == -2 ? u : v) = tet[j];
      }
      std::vector<int64_t> near;
      nearby_tets(q, 1, near);
      std::vector<int64_t> ring;
      for (int64_t tid2 : near) {
        auto t = tet_verts(tid2);
        bool hu = false, hv = false;
        for (int j = 0; j < 4; ++j) { hu |= t[j] == u; hv |= t[j] == v; }
        if (hu && hv) ring.push_back(tid2);
      }
      if (ring.empty()) return false;
      for (int64_t st : ring) {
        auto t = tet_verts(st);
        auto t1 = t, t2 = t;
        for (int j = 0; j < 4; ++j) {
          if (t1[j] == v) t1[j] = -1;
          if (t2[j] == u) t2[j] = -1;
        }
        plan.push_back({st, {t1, t2}});
      }
      how_kind = 1;
      return true;
    }
    return false;
  }

  double face_plane_dist(const std::array<int64_t, 4>& tet, int jz, const V3& p) const {
    V3 f[3];
    int m = 0;
    for (int j = 0; j < 4; ++j)
      if (j != jz) f[m++] = vert(tet[j]);
    V3 n = cross(f[1] - f[0], f[2] - f[0]);
    double nn = norm(n);
    if (nn <= 1e-300) return 0.0;
    return std::fabs(n.x * (p.x - f[0].x) + n.y * (p.y - f[0].y)
                     + n.z * (p.z - f[0].z)) / nn;
  }

  double child_vol(const std::array<int64_t, 4>& child, const V3& q) const {
    V3 vv[4];
    for (int j = 0; j < 4; ++j) vv[j] = child[j] == -1 ? q : vert(child[j]);
    const V3 &va = vv[0], &vb = vv[1], &vc = vv[2], &vd = vv[3];
    double ux = vb.x - va.x, uy = vb.y - va.y, uz = vb.z - va.z;
    double vx = vc.x - va.x, vy = vc.y - va.y, vz = vc.z - va.z;
    double wx = vd.x - va.x, wy = vd.y - va.y, wz = vd.z - va.z;
    return ((uy * vz - uz * vy) * wx + (uz * vx - ux * vz) * wy
            + (ux * vy - uy * vx) * wz) / 6.0;
  }

  // vertex-face weld (mirrors mesher.weld_vertex_face): remove the minimal
  // pancake tid whose face opposite cur grazes cur; retile the neighbor
  // across that face into 3 tets through cur
  bool weld_vertex_face(int64_t cur, int64_t tid) {
    auto t = tet_verts(tid);
    bool has = false;
    for (int j = 0; j < 4; ++j) has |= (t[j] == cur);
    if (!has) return false;
    int64_t f[3];
    int m = 0;
    for (int j = 0; j < 4; ++j)
      if (t[j] != cur) f[m++] = t[j];
    // welds run only during edge recovery (no face tiling exists yet) and
    // never remove a mesh EDGE, so constrained faces are fair game
    std::unordered_set<int64_t> fset = {f[0], f[1], f[2]};
    int64_t neighbor = -1;
    std::vector<int64_t> near;
    nearby_tets(vert(cur), 1, near);
    for (int64_t other : near) {
      if (other == tid) continue;
      auto ot = tet_verts(other);
      int cnt = 0;
      for (int j = 0; j < 4; ++j) cnt += fset.count(ot[j]);
      if (cnt == 3) { neighbor = other; break; }
    }
    if (neighbor < 0) {
      if (getenv("SHM3D_DEBUG")) fprintf(stderr, "WELD refuse: no neighbor\n");
      return false;
    }
    auto to = tet_verts(neighbor);
    std::vector<std::array<int64_t, 4>> children;
    for (int j = 0; j < 4; ++j)
      if (fset.count(to[j])) {
        auto nt = to;
        nt[j] = cur;
        children.push_back(nt);
      }
    const double tiny = 1e-11 * h * h * h;
    V3 q = vert(cur);
    double new_sum = 0.0;
    for (const auto& ch : children) {
      auto probe_ch = ch;
      for (int j = 0; j < 4; ++j)
        if (probe_ch[j] == cur) probe_ch[j] = -1;
      double v = child_vol(probe_ch, q);
      if (v <= tiny) return false;
      new_sum += v;
    }
    double old_sum = child_vol(t, q) + child_vol(to, q);
    // volume conservation: a folded retiling double-counts volume
    if (std::fabs(new_sum - old_sum) > 1e-9 * old_sum + tiny) return false;
    replace(tid, {});
    replace(neighbor, children);
    return true;
  }

  // edge collapse (mirrors mesher.collapse_into): merge unconstrained w
  // into keep; refuse on any resulting degenerate tet
  bool collapse_into(int64_t w, int64_t keep) {
    if (constrained.count(w) || w == keep) return false;
    std::vector<int64_t> star;
    vert_tets(w, star);
    if (star.empty()) return false;
    const double tiny = 1e-11 * h * h * h;
    V3 q = vert(keep);
    std::vector<std::pair<int64_t, std::array<int64_t, 4>>> plans;
    std::vector<char> dies;
    double old_sum = 0.0, new_sum = 0.0;
    for (int64_t tid : star) {
      auto t = tet_verts(tid);
      old_sum += child_vol(t, q);
      bool haskeep = false;
      for (int j = 0; j < 4; ++j) haskeep |= (t[j] == keep);
      if (haskeep) {
        plans.push_back({tid, t});
        dies.push_back(1);
        continue;
      }
      auto nt = t;
      for (int j = 0; j < 4; ++j)
        if (nt[j] == w) nt[j] = keep;
      auto probe = nt;
      for (int j = 0; j < 4; ++j)
        if (probe[j] == keep) probe[j] = -1;
      double v = child_vol(probe, q);
      if (v <= tiny) return false;
      new_sum += v;
      plans.push_back({tid, nt});
      dies.push_back(0);
    }
    // volume conservation: a folded star double-counts volume
    if (std::fabs(new_sum - old_sum) > 1e-9 * old_sum + tiny) return false;
    for (size_t i = 0; i < plans.size(); ++i) {
      if (dies[i]) replace(plans[i].first, {});
      else replace(plans[i].first, {plans[i].second});
    }
    return true;
  }

  // returns vertex id; how: 0=dedup 1=split 2=snap, -1=failure
  // dedup_tol < 0 -> default (1e-12 h); project: move the point exactly
  // onto its classified face plane / edge line before splitting.  Splits
  // are committed only when every child volume exceeds an absolute floor,
  // escalating the classification (interior -> face -> edge -> dedup)
  // otherwise (mirrors mesher.insert_point).
  int64_t insert_point(V3 p, double eps, double snap_tol, int& how,
                       double dedup_tol = -1.0, bool project = false) {
    // locate: widen the search while the best candidate is not clearly
    // interior (mirrors mesher.insert_point)
    int64_t best_tid = -1;
    double best_bary[4], best_min = -1e300;
    std::vector<int64_t> cand;
    for (int rings = 0; rings <= 2; ++rings) {
      nearby_tets(p, rings, cand);
      for (int64_t tid : cand) {
        double bc[4];
        bary(tid, p, bc);
        double mn = *std::min_element(bc, bc + 4);
        if (mn > best_min) {
          best_min = mn;
          best_tid = tid;
          std::memcpy(best_bary, bc, sizeof bc);
        }
        if (mn > eps) break;
      }
      if (best_min > -eps) break;
    }
    if (best_tid < 0 || best_min < -1e-5) { how = -1; return -1; }
    auto tet = tet_verts(best_tid);

    // distance-based dedup (barycentrics unreliable in slivers)
    if (dedup_tol < 0.0) dedup_tol = 1e-12 * h + 1e-12;
    double vdist[4];
    int jmin = 0;
    for (int j = 0; j < 4; ++j) {
      vdist[j] = norm(vert(tet[j]) - p);
      if (vdist[j] < vdist[jmin]) jmin = j;
    }
    if (vdist[jmin] <= dedup_tol) { how = 0; return tet[jmin]; }

    if (snap_tol > 0.0) {
      int order[4] = {0, 1, 2, 3};
      std::stable_sort(order, order + 4,
                       [&](int a, int b) { return vdist[a] < vdist[b]; });
      for (int oi = 0; oi < 4; ++oi) {
        int j = order[oi];
        if (vdist[j] > snap_tol) break;
        int64_t w = tet[j];
        if (constrained.count(w)) continue;
        if (try_move(w, p)) { how = 2; return w; }
      }
    }

    // classify by ABSOLUTE distance to the located tet's face planes;
    // try zero-set sizes in order (natural classification first, then the
    // alternatives) and commit the first plan whose children clear the
    // relative volume floor (mirrors mesher.insert_point)
    const double d_tol = eps * h;
    double dists[4];
    for (int j = 0; j < 4; ++j) dists[j] = face_plane_dist(tet, j, p);
    int order_d[4] = {0, 1, 2, 3};
    std::stable_sort(order_d, order_d + 4,
                     [&](int a2, int b2) { return dists[a2] < dists[b2]; });
    int n_zero = 0;
    for (int j = 0; j < 4; ++j)
      if (dists[j] <= d_tol) ++n_zero;
    if (n_zero > 2) n_zero = 2;

    const double tiny = 1e-11 * h * h * h;  // above double-precision volume noise
    int sizes[3];
    int ns = 0;
    sizes[ns++] = n_zero;
    for (int k = 2; k >= 0; --k)
      if (k != n_zero) sizes[ns++] = k;
    Plan plan;
    for (int si = 0; si < ns; ++si) {
      int k = sizes[si];
      std::vector<int> zero(order_d, order_d + k);
      std::sort(zero.begin(), zero.end());
      V3 q = feature_point(p, tet, zero, project);
      int how_kind = 0;
      if (!split_plan(best_tid, tet, zero, q, plan, how_kind)) continue;
      bool ok = true;
      for (const auto& pr : plan) {
        double floor_v = std::max(1e-9 * child_vol(tet_verts(pr.first), q), tiny);
        for (const auto& ch : pr.second)
          if (child_vol(ch, q) <= floor_v) { ok = false; break; }
        if (!ok) break;
      }
      if (ok) {
        int64_t pid = add_vert(q);
        for (const auto& pr : plan) {
          std::vector<std::array<int64_t, 4>> chs = pr.second;
          for (auto& ch : chs)
            for (int j = 0; j < 4; ++j)
              if (ch[j] == -1) ch[j] = pid;
          replace(pr.first, chs);
        }
        how = 1;
        return pid;
      }
    }
    // no floor-valid split: dedup only within the tolerance scale; else
    // force-commit the natural plan (mirrors mesher.insert_point)
    if (vdist[jmin] <= 10.0 * d_tol) { how = 0; return tet[jmin]; }
    {
      std::vector<int> zero(order_d, order_d + n_zero);
      std::sort(zero.begin(), zero.end());
      V3 q = feature_point(p, tet, zero, project);
      int how_kind = 0;
      if (!split_plan(best_tid, tet, zero, q, plan, how_kind)) {
        how = 0;
        return tet[jmin];
      }
      int64_t pid = add_vert(q);
      for (const auto& pr : plan) {
        std::vector<std::array<int64_t, 4>> chs = pr.second;
        for (auto& ch : chs)
          for (int j = 0; j < 4; ++j)
            if (ch[j] == -1) ch[j] = pid;
        replace(pr.first, chs);
      }
      how = 1;
      return pid;
    }
  }
};

double tet_vol(const V3& a, const V3& b, const V3& c, const V3& d) {
  return dot(cross(b - a, c - a), d - a) / 6.0;
}

// ---------------------------------------------------------------------------
// conforming surface recovery (mirrors shm3d/tet/conforming.py)

// 2-3 bistellar flip creating edge (cur, vb): tets (F, cur) and (F, vb)
// sharing face F are replaced by the three tets around the new edge.  This
// is the classical edge-recovery primitive for configurations at dedup
// scale, where inserting a crossing point is impossible (it would snap back
// onto an existing vertex).  Valid only when the union of the two tets is
// convex across F (all three new volumes share a sign).
bool try_flip23_connect(Builder& mb, int64_t cur, int64_t vb) {
  std::vector<int64_t> vt1, vt2;
  mb.vert_tets(cur, vt1);
  mb.vert_tets(vb, vt2);
  for (int64_t t1 : vt1) {
    auto a = mb.tet_verts(t1);
    int64_t F[3];
    int k = 0;
    bool bad = false;
    for (int j = 0; j < 4; ++j) {
      if (a[j] == cur) continue;
      if (a[j] == vb) { bad = true; break; }
      F[k++] = a[j];
    }
    if (bad || k != 3) continue;
    for (int64_t t2 : vt2) {
      if (t2 == t1) continue;
      auto b = mb.tet_verts(t2);
      bool hasvb = false;
      int match = 0;
      for (int j = 0; j < 4; ++j) {
        if (b[j] == vb) hasvb = true;
        else if (b[j] == F[0] || b[j] == F[1] || b[j] == F[2]) match++;
      }
      if (!hasvb || match != 3) continue;
      V3 pc = mb.vert(cur), pb = mb.vert(vb);
      double vol[3];
      for (int e = 0; e < 3; ++e)
        vol[e] = tet_vol(pc, pb, mb.vert(F[e]), mb.vert(F[(e + 1) % 3]));
      const double fv = 1e-18 * mb.h * mb.h * mb.h;
      bool allpos = vol[0] > fv && vol[1] > fv && vol[2] > fv;
      bool allneg = vol[0] < -fv && vol[1] < -fv && vol[2] < -fv;
      if (!allpos && !allneg) continue;  // reflex/degenerate union
      std::vector<std::array<int64_t, 4>> nts;
      for (int e = 0; e < 3; ++e) {
        int64_t u = F[e], v = F[(e + 1) % 3];
        if (allpos) nts.push_back({cur, vb, u, v});
        else nts.push_back({cur, vb, v, u});
      }
      mb.replace(t1, nts);
      mb.replace(t2, {});
      return true;
    }
  }
  return false;
}

void recover_edge(Builder& mb, int64_t va, int64_t vb, double snap_tol) {
  V3 pb = mb.vert(vb);
  int64_t cur = va;
  std::vector<int64_t> vt;
  for (int step = 0; step < 4096; ++step) {
    if (cur == vb || mb.edge_exists(cur, vb)) return;
    V3 pc = mb.vert(cur);
    V3 seg = pb - pc;
    double seg_len = norm(seg);
    if (seg_len <= 1e-14 * mb.h) return;
    V3 probe = pc + seg * (mb.h / seg_len);
    double best_s = -1.0;
    int64_t best_tid = -1;
    bool found = false;
    const double tols[3] = {1e-9, 1e-6, 1e-4};
    for (int ti = 0; ti < 3 && !found; ++ti) {
      double tol = tols[ti];
      mb.vert_tets(cur, vt);
      for (int64_t tid : vt) {
        auto t = mb.tet_verts(tid);
        int li = 0;
        for (int j = 0; j < 4; ++j)
          if (t[j] == cur) { li = j; break; }
        double bet[4];
        mb.bary(tid, probe, bet);
        bool reject = false;
        for (int j = 0; j < 4; ++j)
          if (j != li && bet[j] < -tol) { reject = true; break; }
        if (reject) continue;
        if (bet[li] >= 1.0 - 1e-15) continue;
        double sigma = 1.0 / (1.0 - bet[li]);
        double s = sigma * mb.h / seg_len;
        if (!found || s > best_s) { best_s = s; best_tid = tid; found = true; }
      }
    }
    if (!found || best_s <= 1e-12) {
      if (getenv("SHM3D_DEBUG")) {
        fprintf(stderr, "STUCK cur=%lld vb=%lld seg_len=%g h=%g step=%d\n",
                (long long)cur, (long long)vb, seg_len, mb.h, step);
        mb.vert_tets(cur, vt);
        fprintf(stderr, " star size %zu\n", vt.size());
        for (int64_t tid : vt) {
          auto t = mb.tet_verts(tid);
          double bet[4];
          mb.bary(tid, probe, bet);
          V3 A = mb.vert(t[0]);
          double vol = dot(cross(mb.vert(t[1]) - A, mb.vert(t[2]) - A), mb.vert(t[3]) - A) / 6.0;
          fprintf(stderr, " tet %lld [%lld %lld %lld %lld] vol=%.3e bary %.3e %.3e %.3e %.3e\n",
                  (long long)tid, (long long)t[0], (long long)t[1], (long long)t[2],
                  (long long)t[3], vol, bet[0], bet[1], bet[2], bet[3]);
        }
      }
      throw ConformFail("edge walk stuck");
    }
    double s = std::min(best_s, 1.0);
    V3 q = pc + seg * s;
    int how = 0;
    int64_t vid = mb.insert_point(q, INSERT_EPS, snap_tol, how,
                                  DEDUP_REC * mb.h, true);
    if (how < 0) throw ConformFail("edge walk: point location failed");
    if (vid == cur) {
      // hop through an existing vertex in the segment corridor (adjacent
      // chains leave reusable Steiner points there)
      {
        const double radius = 0.5 * TOL_E * mb.h;
        int64_t best_w = -1;
        double best_t = 0.0;
        mb.vert_tets(cur, vt);
        for (int64_t tid : vt) {
          auto t = mb.tet_verts(tid);
          for (int j = 0; j < 4; ++j) {
            int64_t w = t[j];
            if (w == cur) continue;
            V3 d = mb.vert(w) - pc;
            double t_along = (d.x * seg.x + d.y * seg.y + d.z * seg.z) / seg_len;
            if (t_along <= 1e-12 * mb.h || t_along > seg_len * (1.0 + 1e-12)) continue;
            double dd = d.x * d.x + d.y * d.y + d.z * d.z;
            double perp2 = dd - t_along * t_along;
            if (perp2 > radius * radius) continue;
            if (t_along > best_t) { best_w = w; best_t = t_along; }
          }
        }
        if (best_w >= 0) {
          mb.constrained.insert(best_w);
          cur = best_w;
          continue;
        }
      }
      // exit within dedup range of cur: a minimal pancake's far face grazes
      // cur — weld cur across it and retry the step
      if (mb.weld_vertex_face(cur, best_tid)) continue;
      // or a needle tet blocks: collapse its short edge and retry
      {
        V3 pcv = mb.vert(cur);
        int64_t best_w = -1;
        double best_d = 1e-3 * mb.h;
        mb.vert_tets(cur, vt);
        for (int64_t tid : vt) {
          auto t = mb.tet_verts(tid);
          for (int j = 0; j < 4; ++j) {
            int64_t v = t[j];
            if (v == cur || mb.constrained.count(v)) continue;
            double d = norm(mb.vert(v) - pcv);
            if (d < best_d) { best_w = v; best_d = d; }
          }
        }
        if (best_w >= 0 && mb.collapse_into(best_w, cur)) continue;
      }
      // one-face separation: create the edge directly with a 2-3 flip
      if (try_flip23_connect(mb, cur, vb)) return;
      vid = mb.insert_point(q, INSERT_EPS, 0.0, how, 0.0, true);
      if (how < 0) throw ConformFail("edge walk: point location failed");
    }
    if (vid == cur) {
      // degenerate-exit escape: the crossing at parameter s hit a
      // configuration insert_point could not split (zero-volume children /
      // grazing plane) and fell back to the nearest vertex.  Any interior
      // point of the constrained segment is a valid Steiner point, so nudge
      // the parameter past the degeneracy — accepting only landings that
      // stay edge-connected to cur (the recovered chain must remain a union
      // of mesh edges).
      const double nudges[5] = {1e-3, 3e-3, 1e-2, 3e-2, 0.1};
      for (int ni = 0; ni < 5 && vid == cur; ++ni) {
        double s2 = std::min(s + nudges[ni], 1.0);
        V3 q2 = pc + seg * s2;
        int how2 = 0;
        int64_t vid2 = mb.insert_point(q2, INSERT_EPS, snap_tol, how2,
                                       DEDUP_REC * mb.h, true);
        if (how2 < 0) continue;
        if (vid2 != cur && (mb.edge_exists(cur, vid2) || vid2 == vb)) vid = vid2;
        if (s2 >= 1.0) break;
      }
    }
    mb.constrained.insert(vid);
    if (vid == cur && seg_len < 0.1 * mb.h) {
      // landing repair: the walk has essentially arrived (remaining segment
      // far below cell scale) but vb is separated from cur by micro-sliver
      // tets whose vertices dedup any inserted crossing back onto cur.
      // Collapse unconstrained vertices inside the landing ball into cur
      // until vb joins cur's star.
      bool progressed = true;
      int guard = 0;
      while (progressed && !(cur == vb || mb.edge_exists(cur, vb)) && guard++ < 64) {
        progressed = false;
        V3 pcv = mb.vert(cur);
        double rad = 2.0 * norm(mb.vert(vb) - pcv) + 1e-9 * mb.h;
        mb.vert_tets(cur, vt);
        for (int64_t tid : vt) {
          auto t = mb.tet_verts(tid);
          for (int j = 0; j < 4 && !progressed; ++j) {
            int64_t w = t[j];
            if (w == cur || w == vb || mb.constrained.count(w)) continue;
            if (norm(mb.vert(w) - pcv) <= rad && mb.collapse_into(w, cur))
              progressed = true;
          }
          if (progressed) break;
        }
      }
      if (cur == vb || mb.edge_exists(cur, vb)) return;
    }
    if (vid == cur) {
      if (getenv("SHM3D_DEBUG")) {
        fprintf(stderr, "NOPROG cur=%lld vb=%lld best_s=%g seg_len=%g h=%g step=%d\n",
                (long long)cur, (long long)vb, best_s, seg_len, mb.h, step);
        {
          std::vector<int64_t> vtc, vtb;
          mb.vert_tets(cur, vtc);
          mb.vert_tets(vb, vtb);
          std::set<int64_t> sc, sb;
          for (int64_t t : vtc) { auto a = mb.tet_verts(t); for (int j=0;j<4;++j) sc.insert(a[j]); }
          for (int64_t t : vtb) { auto a = mb.tet_verts(t); for (int j=0;j<4;++j) sb.insert(a[j]); }
          int shared = 0, shared_con = 0;
          for (int64_t w : sc) if (w != cur && w != vb && sb.count(w)) {
            shared++; if (mb.constrained.count(w)) shared_con++;
          }
          int near_uncon = 0, near_con = 0;
          V3 pcv = mb.vert(cur);
          double rad = 2.0 * norm(mb.vert(vb) - pcv) + 1e-9 * mb.h;
          for (int64_t w : sc) {
            if (w == cur || w == vb) continue;
            if (norm(mb.vert(w) - pcv) <= rad) {
              if (mb.constrained.count(w)) near_con++; else near_uncon++;
            }
          }
          fprintf(stderr, " stars: |cur|=%zu |vb|=%zu shared=%d (%d constrained); "
                  "landing ball: %d uncon %d con\n",
                  sc.size(), sb.size(), shared, shared_con, near_uncon, near_con);
        }
        // re-run the location to dump classification state
        double bc[4];
        std::vector<int64_t> cand2;
        mb.nearby_tets(q, 0, cand2);
        int64_t bt = -1; double bm = -1e300;
        for (int rings = 0; rings <= 2 && bt < 0; ++rings) {
          mb.nearby_tets(q, rings, cand2);
          for (int64_t tid2 : cand2) {
            mb.bary(tid2, q, bc);
            double mn = *std::min_element(bc, bc + 4);
            if (mn > bm) { bm = mn; bt = tid2; }
          }
          if (bm > -INSERT_EPS) break;
        }
        auto t = mb.tet_verts(bt);
        fprintf(stderr, " located tet %lld [%lld %lld %lld %lld] min_bary=%g\n",
                (long long)bt, (long long)t[0], (long long)t[1], (long long)t[2],
                (long long)t[3], bm);
        for (int j = 0; j < 4; ++j)
          fprintf(stderr, " dist[%d]=%g (d_tol=%g) vdist=%g\n", j,
                  mb.face_plane_dist(t, j, q), INSERT_EPS * mb.h,
                  norm(mb.vert(t[j]) - q));
      }
      throw ConformFail("edge walk made no progress");
    }
    cur = vid;
  }
  throw ConformFail("edge walk exceeded step guard");
}

void face_candidate_tets(const Builder& mb, const V3& a, const V3& b, const V3& c,
                         std::vector<int64_t>& out) {
  V3 lo = {std::min({a.x, b.x, c.x}), std::min({a.y, b.y, c.y}), std::min({a.z, b.z, c.z})};
  V3 hi = {std::max({a.x, b.x, c.x}), std::max({a.y, b.y, c.y}), std::max({a.z, b.z, c.z})};
  auto cl = [&](double x) {
    return std::min<int64_t>(std::max<int64_t>((int64_t)std::floor(x), 0), mb.nl - 1);
  };
  int64_t ilo = cl((lo.x - mb.bmin.x) / mb.h - 1), ihi = cl((hi.x - mb.bmin.x) / mb.h + 1);
  int64_t jlo = cl((lo.y - mb.bmin.y) / mb.h - 1), jhi = cl((hi.y - mb.bmin.y) / mb.h + 1);
  int64_t klo = cl((lo.z - mb.bmin.z) / mb.h - 1), khi = cl((hi.z - mb.bmin.z) / mb.h + 1);
  mb.live_tets_in_cells(ilo, ihi, jlo, jhi, klo, khi, out);
}

// barycentric of X in triangle (a,b,c); implicit plane projection
inline void tri_bary(const V3& x, const V3& a, const V3& b, const V3& c,
                     double& al, double& be, double& ga) {
  V3 v0 = b - a, v1 = c - a, v2 = x - a;
  double d00 = dot(v0, v0), d01 = dot(v0, v1), d11 = dot(v1, v1);
  double den = d00 * d11 - d01 * d01;
  if (den <= 0.0) { al = be = ga = -1.0; return; }
  double d20 = dot(v2, v0), d21 = dot(v2, v1);
  be = (d11 * d20 - d01 * d21) / den;
  ga = (d00 * d21 - d01 * d20) / den;
  al = 1.0 - be - ga;
}

constexpr int EDGE_IDX[6][2] = {{0, 1}, {0, 2}, {0, 3}, {1, 2}, {1, 3}, {2, 3}};

void sorted_unique_edges(const Builder& mb, const std::vector<int64_t>& tids,
                         std::vector<std::pair<int64_t, int64_t>>& E) {
  E.clear();
  E.reserve(tids.size() * 6);
  for (int64_t tid : tids) {
    auto t = mb.tet_verts(tid);
    for (const auto& e : EDGE_IDX) {
      int64_t u = t[e[0]], v = t[e[1]];
      if (u > v) std::swap(u, v);
      E.emplace_back(u, v);
    }
  }
  std::sort(E.begin(), E.end());
  E.erase(std::unique(E.begin(), E.end()), E.end());
}

// collapse the shortest collapsible edge among tets near x (mirrors
// conforming._collapse_micro)
bool collapse_micro(Builder& mb, const V3& x) {
  const double cap = 1e-3 * mb.h;
  std::vector<int64_t> tids;
  mb.nearby_tets(x, 0, tids);
  if (tids.empty()) mb.nearby_tets(x, 1, tids);
  int64_t bw = -1, bk = -1;
  double best_d = cap;
  for (int64_t tid : tids) {
    auto t = mb.tet_verts(tid);
    for (int i = 0; i < 4; ++i)
      for (int j = i + 1; j < 4; ++j) {
        int64_t u = t[i], v = t[j];
        double d = norm(mb.vert(u) - mb.vert(v));
        if (d >= best_d) continue;
        if (!mb.constrained.count(u)) { bw = u; bk = v; best_d = d; }
        else if (!mb.constrained.count(v)) { bw = v; bk = u; best_d = d; }
      }
  }
  return bw >= 0 && mb.collapse_into(bw, bk);
}

void recover_face(Builder& mb, int64_t v0, int64_t v1, int64_t v2, double snap_tol) {
  V3 a = mb.vert(v0), b = mb.vert(v1), c = mb.vert(v2);
  V3 nrm = cross(b - a, c - a);
  double nn = norm(nrm);
  if (nn <= 1e-300) return;
  nrm = {nrm.x / nn, nrm.y / nn, nrm.z / nn};  // np-division-matching
  const double tolp = TOL_P * mb.h;
  const double tole = TOL_E * mb.h;

  std::vector<int64_t> tids;
  std::vector<std::pair<int64_t, int64_t>> E;
  std::set<std::pair<int64_t, int64_t>> resolved;  // graze-resolved edges
  bool done = false;
  for (int pass = 0; pass < 64; ++pass) {
    face_candidate_tets(mb, a, b, c, tids);
    sorted_unique_edges(mb, tids, E);
    std::vector<V3> X;
    std::vector<std::pair<int64_t, int64_t>> XE;
    for (const auto& e : E) {
      V3 p0 = mb.vert(e.first), p1 = mb.vert(e.second);
      double d0 = dot(p0 - a, nrm), d1 = dot(p1 - a, nrm);
      bool crossing = (d0 > tolp && d1 < -tolp) || (d0 < -tolp && d1 > tolp);
      if (!crossing) continue;
      double t = d0 / (d0 - d1);
      V3 x = p0 + (p1 - p0) * t;
      double al, be, ga;
      tri_bary(x, a, b, c, al, be, ga);
      if (al >= -1e-7 && be >= -1e-7 && ga >= -1e-7) {
        X.push_back(x);
        XE.push_back(e);
      }
    }
    if (X.empty()) { done = true; break; }
    int progressed = 0;
    int pending = 0;
    for (size_t xi = 0; xi < X.size(); ++xi) {
      if (resolved.count(XE[xi])) continue;
      ++pending;
      int how = 0;
      int64_t vid = mb.insert_point(X[xi], INSERT_EPS, snap_tol, how,
                                    DEDUP_REC * mb.h, true);
      if (how < 0) throw ConformFail("face recovery: point location failed");
      if (how == 0 && norm(mb.vert(vid) - X[xi]) > TOL_E * mb.h) {
        // blocked by micro-geometry: collapse the local micro-edge, retry
        if (collapse_micro(mb, X[xi])) {
          vid = mb.insert_point(X[xi], INSERT_EPS, snap_tol, how,
                                DEDUP_REC * mb.h, true);
          if (how < 0) throw ConformFail("face recovery: point location failed");
        }
      }
      mb.constrained.insert(vid);
      if (how != 0) {
        ++progressed;
      } else {
        // grazing or blocked-in-micro-geometry: mark the edge resolved and
        // let the area certificate arbitrate (material holes fail it)
        resolved.insert(XE[xi]);
        ++progressed;
      }
    }
    if (pending == 0) { done = true; break; }
    if (progressed == 0) throw ConformFail("face recovery stalled on a grazing edge");
  }
  if (!done) throw ConformFail("face recovery exceeded pass guard");

  // mark tiling vertices constrained (later snaps must not move them)
  face_candidate_tets(mb, a, b, c, tids);
  std::unordered_set<int64_t> vs;
  for (int64_t tid : tids) {
    auto t = mb.tet_verts(tid);
    for (int j = 0; j < 4; ++j) vs.insert(t[j]);
  }
  for (int64_t v : vs) {
    V3 p = mb.vert(v);
    if (std::fabs(dot(p - a, nrm)) > TOL_E * mb.h) continue;
    double al, be, ga;
    tri_bary(p, a, b, c, al, be, ga);
    if (al >= -1e-6 && be >= -1e-6 && ga >= -1e-6) mb.constrained.insert(v);
  }
}

// sub-faces tiling input face fi; appends (v0,v1,v2,parent) rows
void extract_subfaces(Builder& mb, int64_t v0, int64_t v1, int64_t v2, int64_t fi,
                      std::vector<std::array<int64_t, 3>>& out_tris,
                      std::vector<int64_t>& out_parent) {
  V3 a = mb.vert(v0), b = mb.vert(v1), c = mb.vert(v2);
  V3 nrm = cross(b - a, c - a);
  double area = 0.5 * norm(nrm);
  if (area <= 0.0) return;
  double nn2 = 2.0 * area;
  nrm = {nrm.x / nn2, nrm.y / nn2, nrm.z / nn2};
  const double tole = TOL_E * mb.h;

  std::vector<int64_t> tids;
  face_candidate_tets(mb, a, b, c, tids);
  std::unordered_map<int64_t, bool> onp;
  std::vector<std::array<int64_t, 3>> tris;
  // jz outer, tids inner (mirrors conforming._extract_subfaces tri_list order)
  for (int jz = 0; jz < 4; ++jz) {
    for (int64_t tid : tids) {
      auto t = mb.tet_verts(tid);
      std::array<int64_t, 3> f;
      int m = 0;
      bool all_on = true;
      for (int j = 0; j < 4; ++j) {
        if (j == jz) continue;
        int64_t v = t[j];
        auto it = onp.find(v);
        bool on;
        if (it == onp.end()) {
          on = std::fabs(dot(mb.vert(v) - a, nrm)) <= tole;
          onp[v] = on;
        } else {
          on = it->second;
        }
        if (!on) { all_on = false; break; }
        f[m++] = v;
      }
      if (all_on) tris.push_back(f);
    }
  }
  if (tris.empty()) throw ConformFail("extract: no on-plane tet faces");
  // barycenter-inside filter
  std::vector<std::array<int64_t, 3>> kept;
  for (const auto& f : tris) {
    V3 s3 = mb.vert(f[0]) + mb.vert(f[1]) + mb.vert(f[2]);
    V3 ctr = {s3.x / 3.0, s3.y / 3.0, s3.z / 3.0};  // np.mean-matching order
    double al, be, ga;
    tri_bary(ctr, a, b, c, al, be, ga);
    if (al >= -1e-7 && be >= -1e-7 && ga >= -1e-7) kept.push_back(f);
  }
  if (kept.empty()) throw ConformFail("extract: no sub-faces inside the face");
  // dedup by sorted-triple key, first occurrence, output sorted by key
  // (mirrors np.unique(key, return_index=True))
  std::unordered_map<int64_t, int64_t> first;
  for (int64_t i = 0; i < (int64_t)kept.size(); ++i) {
    std::array<int64_t, 3> s = kept[i];
    std::sort(s.begin(), s.end());
    int64_t key = (s[0] << 42) | (s[1] << 21) | s[2];
    if (!first.count(key)) first[key] = i;
  }
  std::vector<std::pair<int64_t, int64_t>> order(first.begin(), first.end());
  std::sort(order.begin(), order.end());
  double sub_area = 0.0;
  for (const auto& kv : order) {
    const auto& f = kept[kv.second];
    V3 p0 = mb.vert(f[0]), p1 = mb.vert(f[1]), p2 = mb.vert(f[2]);
    sub_area += 0.5 * norm(cross(p1 - p0, p2 - p0));
    out_tris.push_back(f);
    out_parent.push_back(fi);
  }
  // asymmetric certificate (see conforming._extract_subfaces): deficits are
  // tiling holes (hard fail); excess is double-claiming by near-coplanar
  // neighbors (tolerated; 2x sanity cap)
  if (sub_area < (1.0 - CERT) * area || sub_area > 2.0 * area) {
    if (getenv("SHM3D_DEBUG")) {
      fprintf(stderr, "CERT fail face %lld: sub %.9g vs %.9g (rel %.2e)\n",
              (long long)fi, sub_area, area, std::fabs(sub_area - area) / area);
      // dump tets whose edges strictly pierce this face's plane inside it
      for (int64_t tid : tids) {
        auto t = mb.tet_verts(tid);
        for (const auto& e : EDGE_IDX) {
          V3 p0 = mb.vert(t[e[0]]), p1 = mb.vert(t[e[1]]);
          double d0 = dot(p0 - a, nrm), d1 = dot(p1 - a, nrm);
          if (!((d0 > 0 && d1 < 0) || (d0 < 0 && d1 > 0))) continue;
          double tt = d0 / (d0 - d1);
          V3 x = p0 + (p1 - p0) * tt;
          double al, be, ga;
          tri_bary(x, a, b, c, al, be, ga);
          if (al >= -1e-7 && be >= -1e-7 && ga >= -1e-7)
            fprintf(stderr, "  pierce: tet %lld edge (%lld,%lld) d0=%.3e d1=%.3e bary %.3f %.3f %.3f\n",
                    (long long)tid, (long long)t[e[0]], (long long)t[e[1]], d0, d1, al, be, ga);
        }
      }
    }
    throw ConformFail("extract: sub-face area certificate failed");
  }
}

using Result = ShmResult;  // shared handle layout (shm3d_common.h)

// lattice + source-vertex insertion (mirrors mesher._python_build); returns
// the live Builder for optional recovery
bool build_core(Builder& mb, Result& res, const double* src_xyz, int64_t V,
                double cx, double cy, double cz, double half_side, int resolution,
                bool conforming) {
  mb.nl = resolution;
  mb.npts = resolution + 1;
  mb.h = 2.0 * half_side / resolution;
  mb.bmin = {cx - half_side, cy - half_side, cz - half_side};

  const int64_t npts = mb.npts;
  mb.positions.resize((int64_t)npts * npts * npts);
  for (int64_t k = 0; k < npts; ++k)
    for (int64_t j = 0; j < npts; ++j)
      for (int64_t i = 0; i < npts; ++i)
        mb.positions[i + j * npts + k * npts * npts] =
            {mb.bmin.x + i * mb.h, mb.bmin.y + j * mb.h, mb.bmin.z + k * mb.h};

  const int64_t nl = mb.nl;
  const int64_t ncells = (int64_t)nl * nl * nl;
  mb.base_tets.resize(ncells * 6);
  mb.base_dead.assign(ncells * 6, 0);
  const int64_t dx = 1, dy = npts, dz = (int64_t)npts * npts;
  const int64_t off[8] = {0, dx, dy, dx + dy, dz, dx + dz, dy + dz, dx + dy + dz};
  for (int64_t k = 0; k < nl; ++k)
    for (int64_t j = 0; j < nl; ++j)
      for (int64_t i = 0; i < nl; ++i) {
        int64_t lex = i + j * nl + k * nl * nl;
        int64_t c000 = i + j * npts + k * npts * npts;
        for (int t = 0; t < 6; ++t) {
          auto& T = mb.base_tets[6 * lex + t];
          for (int m = 0; m < 4; ++m) T[m] = c000 + off[KUHN[t][m]];
        }
      }

  res.vertex_of.assign(V, -1);

  // pass 1: snap (closest-first greedy claims)
  std::vector<int64_t> nearest(V);
  std::vector<double> dist(V);
  std::vector<int64_t> order(V);
  for (int64_t v = 0; v < V; ++v) {
    V3 p = {src_xyz[3 * v], src_xyz[3 * v + 1], src_xyz[3 * v + 2]};
    // np.rint-matching rounding (half to even)
    int64_t bi = std::min<int64_t>(std::max<int64_t>((int64_t)std::nearbyint((p.x - mb.bmin.x) / mb.h), 0), npts - 1);
    int64_t bj = std::min<int64_t>(std::max<int64_t>((int64_t)std::nearbyint((p.y - mb.bmin.y) / mb.h), 0), npts - 1);
    int64_t bk = std::min<int64_t>(std::max<int64_t>((int64_t)std::nearbyint((p.z - mb.bmin.z) / mb.h), 0), npts - 1);
    nearest[v] = bi + bj * npts + bk * npts * npts;
    dist[v] = norm(p - mb.positions[nearest[v]]);
    order[v] = v;
  }
  std::stable_sort(order.begin(), order.end(),
                   [&](int64_t a, int64_t b) { return dist[a] < dist[b]; });
  std::unordered_map<int64_t, int64_t> claimed;
  std::vector<int64_t> snapped_nodes, snapped_srcs;
  for (int64_t v : order) {
    if (dist[v] > SNAP_ALPHA * mb.h) continue;
    int64_t nid = nearest[v];
    if (claimed.count(nid)) continue;
    claimed[nid] = v;
    snapped_nodes.push_back(nid);
    snapped_srcs.push_back(v);
  }
  std::vector<V3> saved(snapped_nodes.size());
  for (size_t s = 0; s < snapped_nodes.size(); ++s) {
    saved[s] = mb.positions[snapped_nodes[s]];
    int64_t v = snapped_srcs[s];
    mb.positions[snapped_nodes[s]] = {src_xyz[3 * v], src_xyz[3 * v + 1], src_xyz[3 * v + 2]};
  }
  // revert snaps that invert incident tets (rounds)
  std::unordered_set<int64_t> snapset(snapped_nodes.begin(), snapped_nodes.end());
  for (int round = 0; round < 6 && !snapset.empty(); ++round) {
    std::unordered_set<int64_t> revert;
    for (int64_t t = 0; t < (int64_t)mb.base_tets.size(); ++t) {
      const auto& T = mb.base_tets[t];
      bool touched = snapset.count(T[0]) || snapset.count(T[1]) ||
                     snapset.count(T[2]) || snapset.count(T[3]);
      if (!touched) continue;
      if (tet_vol(mb.vert(T[0]), mb.vert(T[1]), mb.vert(T[2]), mb.vert(T[3]))
          <= 1e-12 * mb.h * mb.h * mb.h)
        for (int m = 0; m < 4; ++m)
          if (snapset.count(T[m])) revert.insert(T[m]);
    }
    if (revert.empty()) break;
    for (int64_t nid : revert) {
      for (size_t s = 0; s < snapped_nodes.size(); ++s)
        if (snapped_nodes[s] == nid) { mb.positions[nid] = saved[s]; break; }
      snapset.erase(nid);
      claimed.erase(nid);
    }
  }
  for (size_t s = 0; s < snapped_nodes.size(); ++s)
    if (snapset.count(snapped_nodes[s])) {
      res.vertex_of[snapped_srcs[s]] = snapped_nodes[s];
      // constrain NOW: later pass-2 snaps must never move a source
      mb.constrained.insert(snapped_nodes[s]);
      res.n_snapped++;
    }

  // pass 2: split-insert the rest (conforming builds use the recovery
  // tolerance ladder: snap first, then classify/project at 1e-5 cell —
  // mirrors mesher._python_build)
  for (int64_t v = 0; v < V; ++v) {
    if (res.vertex_of[v] >= 0) continue;
    V3 p = {src_xyz[3 * v], src_xyz[3 * v + 1], src_xyz[3 * v + 2]};
    int how = 0;
    int64_t pid = conforming
        ? mb.insert_point(p, 1e-5, SNAP_ALPHA * mb.h, how, -1.0, true)
        : mb.insert_point(p, 1e-9, 0.0, how);
    if (how < 0) return false;
    res.vertex_of[v] = pid;
    mb.constrained.insert(pid);  // immediately: never snap-move a source
    if (how == 1) res.n_split++;
  }
  for (int64_t v = 0; v < V; ++v) mb.constrained.insert(res.vertex_of[v]);
  return true;
}

void pack_result(const Builder& mb, Result& res) {
  int64_t NV = mb.n_nodes() + (int64_t)mb.extra_verts.size();
  res.vertices.resize(NV * 3);
  for (int64_t i = 0; i < mb.n_nodes(); ++i) {
    res.vertices[3 * i] = mb.positions[i].x;
    res.vertices[3 * i + 1] = mb.positions[i].y;
    res.vertices[3 * i + 2] = mb.positions[i].z;
  }
  for (size_t i = 0; i < mb.extra_verts.size(); ++i) {
    int64_t o = mb.n_nodes() + (int64_t)i;
    res.vertices[3 * o] = mb.extra_verts[i].x;
    res.vertices[3 * o + 1] = mb.extra_verts[i].y;
    res.vertices[3 * o + 2] = mb.extra_verts[i].z;
  }
  for (int64_t t = 0; t < (int64_t)mb.base_tets.size(); ++t)
    if (!mb.base_dead[t])
      for (int m = 0; m < 4; ++m) res.tets.push_back(mb.base_tets[t][m]);
  for (size_t t = 0; t < mb.extra_tets.size(); ++t)
    if (!mb.extra_dead[t])
      for (int m = 0; m < 4; ++m) res.tets.push_back(mb.extra_tets[t][m]);
}

}  // namespace

extern "C" {

// Builds the mesh; returns an opaque handle (heap Result*), or null.
void* shm3d_lattice_build(const double* src_xyz, int64_t V, double cx, double cy,
                          double cz, double half_side, int resolution) {
  Builder mb;
  auto res = new Result();
  if (!build_core(mb, *res, src_xyz, V, cx, cy, cz, half_side, resolution, false)) {
    delete res;
    return nullptr;
  }
  pack_result(mb, *res);
  return res;
}

// Conforming build: vertex insertion + edge/face recovery + extraction.
// On recovery failure, returns the handle with surf_tris empty (the Python
// wrapper warns and finalizes the mesh as non-conforming).
void* shm3d_conforming_build(const double* src_xyz, int64_t V,
                             const int64_t* faces, int64_t F,
                             double cx, double cy, double cz,
                             double half_side, int resolution) {
  Builder mb;
  auto res = new Result();
  if (!build_core(mb, *res, src_xyz, V, cx, cy, cz, half_side, resolution, true)) {
    delete res;
    return nullptr;
  }
  const double snap_tol = SNAP_FRAC * mb.h;
  try {
    if (F == 0) throw ConformFail("no source faces");
    // edges: unique sorted (mesh-id) pairs, mirrors conforming.recover_surface
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
    for (const auto& e : E) recover_edge(mb, e.first, e.second, snap_tol);

    for (int64_t f = 0; f < F; ++f) {
      int64_t v0 = res->vertex_of[faces[3 * f]], v1 = res->vertex_of[faces[3 * f + 1]],
              v2 = res->vertex_of[faces[3 * f + 2]];
      if (v0 == v1 || v1 == v2 || v0 == v2) continue;
      recover_face(mb, v0, v1, v2, snap_tol);
    }

    std::vector<std::array<int64_t, 3>> tris;
    std::vector<int64_t> parents;
    for (int64_t f = 0; f < F; ++f) {
      int64_t v0 = res->vertex_of[faces[3 * f]], v1 = res->vertex_of[faces[3 * f + 1]],
              v2 = res->vertex_of[faces[3 * f + 2]];
      if (v0 == v1 || v1 == v2 || v0 == v2) continue;
      extract_subfaces(mb, v0, v1, v2, f, tris, parents);
    }
    if (tris.empty()) throw ConformFail("no recoverable faces");
    res->surf_tris.reserve(tris.size() * 3);
    for (const auto& t : tris) {
      res->surf_tris.push_back(t[0]);
      res->surf_tris.push_back(t[1]);
      res->surf_tris.push_back(t[2]);
    }
    res->surf_parent = std::move(parents);
  } catch (ConformFail& e) {
    res->surf_tris.clear();
    res->surf_parent.clear();
    res->fail_reason = e.what;
  }
  pack_result(mb, *res);
  return res;
}

int64_t shm3d_lattice_nv(void* handle) { return (int64_t)((Result*)handle)->vertices.size() / 3; }
int64_t shm3d_lattice_nt(void* handle) { return (int64_t)((Result*)handle)->tets.size() / 4; }
int64_t shm3d_lattice_nsnapped(void* handle) { return ((Result*)handle)->n_snapped; }
int64_t shm3d_lattice_nsplit(void* handle) { return ((Result*)handle)->n_split; }
int64_t shm3d_lattice_nsurf(void* handle) { return (int64_t)((Result*)handle)->surf_tris.size() / 3; }
const char* shm3d_lattice_fail_reason(void* handle) { return ((Result*)handle)->fail_reason.c_str(); }

void shm3d_lattice_copy(void* handle, double* vertices, int64_t* tets, int64_t* vertex_of) {
  auto* r = (Result*)handle;
  std::memcpy(vertices, r->vertices.data(), r->vertices.size() * sizeof(double));
  std::memcpy(tets, r->tets.data(), r->tets.size() * sizeof(int64_t));
  std::memcpy(vertex_of, r->vertex_of.data(), r->vertex_of.size() * sizeof(int64_t));
}

void shm3d_lattice_copy_surf(void* handle, int64_t* tris, int64_t* parents) {
  auto* r = (Result*)handle;
  std::memcpy(tris, r->surf_tris.data(), r->surf_tris.size() * sizeof(int64_t));
  std::memcpy(parents, r->surf_parent.data(), r->surf_parent.size() * sizeof(int64_t));
}

void shm3d_lattice_free(void* handle) { delete (Result*)handle; }

}  // extern "C"
