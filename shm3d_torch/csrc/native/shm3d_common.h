// Shared result contract between the native mesher TUs (lattice_tet.cpp,
// exact_conform.cpp).  The Python side (shm3d/tet/native.py) reads handles
// through the shm3d_lattice_* accessors defined in lattice_tet.cpp, so every
// TU producing a handle must heap-allocate this exact struct.
#pragma once

#include <cstdint>
#include <string>
#include <vector>

struct ShmResult {
  std::string fail_reason;           // nonempty when conforming recovery failed
  std::vector<double> vertices;      // (NV, 3)
  std::vector<std::int64_t> tets;    // (NT, 4)
  std::vector<std::int64_t> vertex_of;  // (V,) source vertex -> mesh vertex id
  std::vector<std::int64_t> surf_tris;  // (S, 3) mesh vertex ids tiling the surface
  std::vector<std::int64_t> surf_parent;  // (S,) input face index per sub-face
  std::int64_t n_snapped = 0, n_split = 0;
};
