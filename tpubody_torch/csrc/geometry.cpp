// Native host-geometry helper of tpubody_torch (a copy of
// tpubody/native/geometry.cpp; the functions and their arithmetic are
// unchanged, apart from trace_boundary's stop test, which now agrees with
// the Python tracer on two-pixel regions).
//
// The device path is PyTorch and the CUDA kernels of csrc/*.cu; this
// library covers the *inherently sequential host-side* pieces of the
// pipeline that Python loops handle slowly:
//
//   * Moore-neighbor silhouette boundary tracing
//     (tpubody_torch/image/contours.py trace_boundary; the reference leans
//     on cv2.findContours, lib/Warp.py:55,78),
//   * once-only edges of a triangle mesh and the ordered boundary-ring
//     walk over them (tpubody_torch/mesh/grid_mesh.py boundary_edges,
//     boundary_ring; the reference's O(n^2) np.delete walk,
//     lib/Depth2Mesh_Bspline.py:196-234),
//   * grid triangulation of a depth map with its attribute gather
//     (grid_mesh.py depth_to_mesh),
//   * monotone-DP backtracking for boundary matching
//     (tpubody_torch/image/boundary_match.py).
//
// Exposed as a plain C ABI for ctypes.  Built with g++ (host code, not
// nvcc) at first use by tpubody_torch/geometry.py.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Moore-neighbor boundary tracing on a binary mask (row-major, H x W).
// Writes up to max_pts (x, y) pairs into out_xy; returns the count
// (0 if the mask is empty, -1 if out_xy is too small).
// ---------------------------------------------------------------------------
int64_t trace_boundary(const uint8_t* mask, int64_t H, int64_t W,
                       int64_t* out_xy, int64_t max_pts) {
  const int64_t PH = H + 2, PW = W + 2;
  std::vector<uint8_t> pad(static_cast<size_t>(PH * PW), 0);
  for (int64_t y = 0; y < H; ++y)
    for (int64_t x = 0; x < W; ++x)
      pad[(y + 1) * PW + (x + 1)] = mask[y * W + x] ? 1 : 0;

  // First foreground pixel in scan order.
  int64_t sy = -1, sx = -1;
  for (int64_t i = 0; i < PH * PW; ++i) {
    if (pad[i]) { sy = i / PW; sx = i % PW; break; }
  }
  if (sy < 0) return 0;

  // Clockwise Moore neighborhood starting W (must match contours.py's
  // plain version).
  static const int dx[8] = {-1, -1, 0, 1, 1, 1, 0, -1};
  static const int dy[8] = {0, -1, -1, -1, 0, 1, 1, 1};

  int64_t count = 0;
  auto emit = [&](int64_t y, int64_t x) -> bool {
    if (count >= max_pts) return false;
    out_xy[2 * count] = x - 1;
    out_xy[2 * count + 1] = y - 1;
    ++count;
    return true;
  };
  if (!emit(sy, sx)) return -1;

  int prev_dir = 0;
  int64_t cy = sy, cx = sx;
  const int64_t limit = 8 * H * W;
  for (int64_t it = 0; it < limit; ++it) {
    bool found = false;
    for (int d = 0; d < 8; ++d) {
      int k = (prev_dir + 1 + d) % 8;
      int64_t ny = cy + dy[k], nx = cx + dx[k];
      if (pad[ny * PW + nx]) {
        // Back at the start after at least two points: the Python tracer's
        // stop (it appends the start's repeat, sees more than two points
        // and drops the repeat).  tpubody's copy tests count > 2 and so
        // lists a two-pixel region twice over.
        if (ny == sy && nx == sx && count > 1) return count;
        if (!emit(ny, nx)) return -1;
        prev_dir = (k + 4) % 8;
        cy = ny; cx = nx;
        found = true;
        break;
      }
    }
    if (!found) break;  // isolated pixel
  }
  return count;
}

// ---------------------------------------------------------------------------
// Once-only (boundary) edges of a triangle mesh (grid_mesh.py
// boundary_edges; reference get_bound_verts_index scans an O(n^2) edge
// list, lib/Depth2Mesh_Bspline.py:196-234).  Sort-based: the 3F undirected
// edge codes (lo * V + hi) are sorted and runs of length 1 emitted — the
// numpy np.unique(return_inverse+counts) equivalent without its three
// full-size temporaries (measured 2-4 s at 1024^2 grid meshes; this is
// ~0.3 s).  Returns the boundary-edge count, or -1 if out_edges is small.
// ---------------------------------------------------------------------------
int64_t boundary_edges_from_faces(const int64_t* faces, int64_t F,
                                  int64_t* out_edges, int64_t max_edges) {
  if (F == 0) return 0;
  int64_t V = 0;
  for (int64_t i = 0; i < 3 * F; ++i) V = faces[i] > V ? faces[i] : V;
  V += 1;
  std::vector<uint64_t> codes(static_cast<size_t>(3 * F));
  for (int64_t f = 0; f < F; ++f) {
    const int64_t a = faces[3 * f], b = faces[3 * f + 1], c = faces[3 * f + 2];
    auto code = [V](int64_t u, int64_t v) {
      const uint64_t lo = static_cast<uint64_t>(u < v ? u : v);
      const uint64_t hi = static_cast<uint64_t>(u < v ? v : u);
      return lo * static_cast<uint64_t>(V) + hi;
    };
    codes[3 * f] = code(a, b);
    codes[3 * f + 1] = code(b, c);
    codes[3 * f + 2] = code(c, a);
  }
  std::sort(codes.begin(), codes.end());
  int64_t count = 0;
  const size_t n = codes.size();
  for (size_t i = 0; i < n;) {
    size_t j = i + 1;
    while (j < n && codes[j] == codes[i]) ++j;
    if (j - i == 1) {
      if (count >= max_edges) return -1;
      out_edges[2 * count] = static_cast<int64_t>(
          codes[i] / static_cast<uint64_t>(V));
      out_edges[2 * count + 1] = static_cast<int64_t>(
          codes[i] % static_cast<uint64_t>(V));
      ++count;
    }
    i = j;
  }
  return count;
}

// ---------------------------------------------------------------------------
// Ordered boundary-ring walk over once-only (boundary) edges.
// edges: (E, 2) int64 pairs. Writes the ordered vertex loop into out
// (max_out entries); returns its length.
// ---------------------------------------------------------------------------
int64_t boundary_ring_walk(const int64_t* edges, int64_t E,
                           int64_t* out, int64_t max_out) {
  if (E == 0) return 0;
  std::unordered_map<int64_t, std::vector<int64_t>> succ;
  succ.reserve(static_cast<size_t>(E) * 2);
  for (int64_t i = 0; i < E; ++i) {
    int64_t a = edges[2 * i], b = edges[2 * i + 1];
    succ[a].push_back(b);
    succ[b].push_back(a);
  }
  int64_t start = edges[0];
  int64_t count = 0;
  if (count < max_out) out[count++] = start;
  int64_t prev = -1, cur = start;
  for (int64_t it = 0; it <= E; ++it) {
    const auto& ns = succ[cur];
    int64_t nxt = -1;
    for (int64_t v : ns) {
      if (v != prev) { nxt = v; break; }
    }
    if (nxt < 0 || nxt == start) break;
    if (count >= max_out) return -1;
    out[count++] = nxt;
    prev = cur;
    cur = nxt;
  }
  return count;
}

// ---------------------------------------------------------------------------
// Grid-triangulate the valid region of a depth map with attribute gather
// (grid_mesh.py depth_to_mesh; reference depth2trimesh,
// lib/Depth2Mesh_Bspline.py:33-108).  One pass, no HW-sized float
// temporaries — the numpy version's fancy-indexed gathers and face
// concatenations were the stitch stage's residual hotspot at 1024^2.
//
// Semantics identical to the numpy path: a face is kept iff its three
// corner pixels are valid AND none is flat index 0 (background sentinel);
// face order is all first-diagonal triangles then all second-diagonal
// ones; vertices are the used pixels in ascending flat order; the point
// row layout is [x, y, depth, color[3], weights[K]].
// Returns the face count, or -1 if a capacity is exceeded.
// ---------------------------------------------------------------------------
int64_t grid_mesh_build(const uint8_t* mask, const float* depth,
                        const float* color, const float* weights,
                        int64_t H, int64_t W, int64_t K, int64_t is_back,
                        int64_t* faces_out, int64_t faces_cap,
                        float* points_out, int64_t points_cap_rows,
                        int64_t* n_verts_out) {
  const int64_t HW = H * W;
  std::vector<int64_t> remap(static_cast<size_t>(HW), -1);
  auto valid = [&](int64_t i) -> bool { return i > 0 && mask[i]; };

  int64_t nf = 0;
  // Two sweeps reproduce the numpy concatenation order exactly:
  // sweep 0 emits the (p00, p10, p01)/(p00, p01, p10) triangles, sweep 1
  // the (p01, p10, p11)/(p01, p11, p10) ones.
  for (int t = 0; t < 2; ++t) {
    for (int64_t r = 0; r + 1 < H; ++r) {
      for (int64_t c = 0; c + 1 < W; ++c) {
        const int64_t p00 = r * W + c, p10 = p00 + W;
        const int64_t p01 = p00 + 1, p11 = p10 + 1;
        int64_t a, b, d;
        if (t == 0) {
          a = p00; b = is_back ? p01 : p10; d = is_back ? p10 : p01;
        } else {
          a = p01; b = is_back ? p11 : p10; d = is_back ? p10 : p11;
        }
        if (!valid(a) || !valid(b) || !valid(d)) continue;
        if (nf >= faces_cap) return -1;
        faces_out[3 * nf] = a;
        faces_out[3 * nf + 1] = b;
        faces_out[3 * nf + 2] = d;
        remap[a] = 0; remap[b] = 0; remap[d] = 0;
        ++nf;
      }
    }
  }

  const int64_t row_w = 6 + K;
  int64_t nv = 0;
  for (int64_t i = 0; i < HW; ++i) {
    if (remap[i] < 0) continue;
    if (nv >= points_cap_rows) return -1;
    remap[i] = nv;
    float* row = points_out + nv * row_w;
    row[0] = static_cast<float>(i % W);
    row[1] = static_cast<float>(i / W);
    row[2] = depth[i];
    std::memcpy(row + 3, color + 3 * i, 3 * sizeof(float));
    std::memcpy(row + 6, weights + K * i, K * sizeof(float));
    ++nv;
  }
  for (int64_t j = 0; j < 3 * nf; ++j) faces_out[j] = remap[faces_out[j]];
  *n_verts_out = nv;
  return nf;
}

// ---------------------------------------------------------------------------
// Monotone-DP backtrack (image/boundary_match.py): given the
// (m-1, n) argmin table and the final-row argmin j, walk back to produce
// the (m,) match. args is row-major (m-1, n).
// ---------------------------------------------------------------------------
void dp_backtrack(const int64_t* args, int64_t m, int64_t n,
                  int64_t j_final, int64_t* out_match) {
  int64_t j = j_final;
  out_match[m - 1] = j;
  for (int64_t i = m - 2; i >= 0; --i) {
    j = args[i * n + j];
    if (j < 0) j = 0;
    if (j >= n) j = n - 1;
    out_match[i] = j;
  }
}

}  // extern "C"
