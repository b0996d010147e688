"""Mean-value coordinates of 2D points w.r.t. a closed polygon, batched
(port of ``tpubody.image.mvc``).

Capability parity with the reference's vectorized MVC
(lib/Warp.py:477-548 get_one/get_mult_mv_coordinate, and the scalar
lib/reconstruct/meanvaluecoordinates.py F): Floater's tan(alpha/2) weights

    w_i = (tan(a_{i-1}/2) + tan(a_i/2)) / |v_i - p|,
    tan(a_i/2) = cross(d_i, d_{i+1}) / (|d_i||d_{i+1}| + dot(d_i, d_{i+1}))

with the two degenerate cases (p exactly on a vertex; p on an edge) folded
in branch-free with ``torch.where``.  One (m, n) broadcast + row-normalize;
the warp displacement is a float32 weighted sum over the polygon.
"""
from __future__ import annotations

import torch

_EPS = 1e-12


def mean_value_coordinates(pts: torch.Tensor, poly: torch.Tensor
                           ) -> torch.Tensor:
    """MVC weights of each point w.r.t. the polygon.

    Args:
      pts: (m, 2) query points.
      poly: (n, 2) closed polygon vertices (ordered; wrap-around implied).

    Returns:
      (m, n) weights, rows summing to 1.
    """
    pts = pts.to(torch.float32)
    poly = poly.to(torch.float32)
    d = poly[None, :, :] - pts[:, None, :]          # (m, n, 2)
    dn = torch.roll(d, -1, dims=1)                  # next vertex
    r = torch.linalg.norm(d, dim=2)                 # (m, n)
    rn = torch.roll(r, -1, dims=1)

    det = d[..., 0] * dn[..., 1] - d[..., 1] * dn[..., 0]   # cross
    dot = (d * dn).sum(dim=2)

    # General case: Floater weights.
    denom = r * rn + dot
    tan_half = det / torch.where(denom.abs() < _EPS,
                                 torch.full_like(denom, _EPS), denom)
    w = (torch.roll(tan_half, 1, dims=1) + tan_half) / torch.clamp(r, min=_EPS)
    wsum = w.sum(dim=1, keepdim=True)
    w = w / torch.where(wsum.abs() < _EPS, torch.full_like(wsum, _EPS), wsum)

    # Case: p coincides with a vertex -> delta weights.
    on_vertex = r < 1e-6                            # (m, n)
    any_vertex = on_vertex.any(dim=1, keepdim=True)
    w_vertex = on_vertex.to(w.dtype)
    w_vertex = w_vertex / torch.clamp(w_vertex.sum(dim=1, keepdim=True),
                                      min=_EPS)

    # Case: p on an edge (colinear between v_i, v_{i+1}: det==0, dot<0)
    # -> linear interpolation between that edge's endpoints.
    on_edge = (det.abs() < 1e-9) & (dot < 0)
    any_edge = on_edge.any(dim=1, keepdim=True)
    zero = torch.zeros_like(r)
    edge_w_i = rn / torch.clamp(r + rn, min=_EPS)   # weight for v_i
    edge_w_n = r / torch.clamp(r + rn, min=_EPS)    # weight for v_{i+1}
    w_edge = torch.where(on_edge, edge_w_i, zero)
    w_edge = w_edge + torch.roll(torch.where(on_edge, edge_w_n, zero), 1,
                                 dims=1)
    w_edge = w_edge / torch.clamp(w_edge.sum(dim=1, keepdim=True), min=_EPS)

    w = torch.where(any_edge, w_edge, w)
    w = torch.where(any_vertex, w_vertex, w)
    return w


def warp_points(pts: torch.Tensor, src_poly: torch.Tensor,
                dst_poly: torch.Tensor) -> torch.Tensor:
    """Transport points from the source polygon's frame to the target's:
    weights = MVC(pts, src_poly); out = weights @ dst_poly
    (reference get_corres, lib/Warp.py:199-218).

    The product is taken as two float32 weighted sums, one per coordinate,
    so that no matmul precision flag can lower it to TF32."""
    w = mean_value_coordinates(pts, src_poly)
    dst = dst_poly.to(torch.float32)
    return torch.stack([(w * dst[:, 0]).sum(dim=1),
                        (w * dst[:, 1]).sum(dim=1)], dim=1)


def warp_points_chunked(pts: torch.Tensor, src_poly: torch.Tensor,
                        dst_poly: torch.Tensor,
                        chunk: int = 16384) -> torch.Tensor:
    """Memory-bounded warp for full-resolution images.

    At 1024^2 the (m, n) MVC broadcast is ~250k x boundary-length, several
    GB of intermediates.  This transports fixed-size chunks of points one
    after another, so peak memory is O(chunk * n) (the reference
    hand-chunks at 100k points on host, lib/Warp.py:209-214).
    """
    out = [warp_points(pts[s:s + chunk], src_poly, dst_poly)
           for s in range(0, pts.shape[0], chunk)]
    return torch.cat(out) if out else pts.new_zeros((0, 2),
                                                    dtype=torch.float32)
