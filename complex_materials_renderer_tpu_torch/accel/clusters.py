"""Spatially clustered triangle grid — the acceleration structure for the
path-tracing kernel. Host numpy, a byte-equal copy of
complex_materials_renderer_tpu/accel/clusters.py (the design notes below
describe why the structure was shaped for the TPU; the CUDA kernel walks
the same grid one lane per thread).

Rationale (why not the BVH on TPU): XLA per-lane gathers execute at about
one element per cycle on TPU, so a pointer-chasing BVH walk — even a
threaded, stack-free one — is catastrophically memory-serial (measured
~0.002 Mpaths/s). The VPU wants dense vector work and the Mosaic compiler
wants dynamic indexing only on non-lane dimensions. This structure is
shaped for exactly that:

- triangles are ordered by a longest-axis median-split tree and packed
  into clusters of 128 (one full lane vector each);
- each cluster carries an AABB; traversal is: cull cluster (scalar test,
  real branch via pl.when), then test the cluster's 128 triangles against
  8 rays at a time as dense (8, 128) VPU ops.

Worst case equals brute force at full VPU rate; coherent rays skip most
clusters. This replaces the same vendor-built BVH the threaded-BVH backend
replaces (reference main.cpp:176-203) — two backends, one contract.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

CLUSTER_SIZE = 128  # one lane vector of triangles (default; tests use less)


class ClusterGrid(NamedTuple):
    # (C, 128) per-component PRIMITIVE data, cluster-major, zero-padded
    # (degenerate zero triangles never intersect: det == 0). Edges are
    # precomputed (e1 = v1-v0, e2 = v2-v0) — Moller-Trumbore consumes
    # edges directly, saving six subtractions per triangle test.
    #
    # A slot holds either one triangle or one PLANAR CONVEX QUAD (two
    # coplanar shared-edge triangles merged by pair_quads): the MT basis
    # (v0, e1, e2) spans the quad's plane and the per-slot (qa, qb)
    # coefficients encode the far corner v3 = v0 + qa*e1 + qb*e2, so the
    # hit test's barycentric acceptance region generalizes from
    # {u+v<=1} to the quad's two far edges (a triangle is qa=qb=0.5).
    # One slot then covers two triangles for +2 scalar extracts and ~4
    # vector ops — a near-2x slot-count cut on quad-tessellated meshes
    # (cup 92%, vessel 85%, gem_corner 81% pairable; tools/study_quads).
    v0x: np.ndarray
    v0y: np.ndarray
    v0z: np.ndarray
    e1x: np.ndarray
    e1y: np.ndarray
    e1z: np.ndarray
    e2x: np.ndarray
    e2y: np.ndarray
    e2z: np.ndarray
    bounds: np.ndarray  # (C, 8): min xyz, max xyz, pad, pad
    super_bounds: np.ndarray  # (S, 8) AABBs over groups of SUPER_FACTOR clusters
    tri_index: np.ndarray  # (C*128,) original triangle id per slot; -1 = pad
    mat_id: np.ndarray  # (C, 128) per-slot material id; -1 on pad slots
    # Opaque/media segregation (0 when unpartitioned): clusters/supers
    # [0, num_opaque_*) hold only medium-less triangles, the rest only
    # medium-bearing ones. The NEE shadow sweep then runs a cheap
    # closest-hit occlusion walk over the opaque range and the K-list
    # boundary collection over the media range only.
    num_opaque_clusters: int = 0
    num_opaque_supers: int = 0
    # Clusters per super (second culling level). Parameterized so the
    # hierarchy fan-out can ride cluster-width sweeps: at cluster_size 32
    # a fixed fan-out of 16 quadruples the super count (and the linear
    # walk's per-super slab gates) versus width 128.
    super_factor: int = 16
    # (C, 128) quad far-corner coefficients (see class docstring); None
    # means every slot is a triangle (device_cluster_grid fills 0.5).
    qa: np.ndarray | None = None
    qb: np.ndarray | None = None

    @property
    def num_clusters(self) -> int:
        return self.bounds.shape[0]


SUPER_FACTOR = 16  # default clusters per super-cluster
SUB_SIZE = 16  # triangles per sub-group (third, in-cluster culling level)


def _median_split_order(centroids: np.ndarray, cluster_size: int) -> np.ndarray:
    """Triangle order from a longest-axis median-split tree (leaves =
    clusters, emitted depth-first).

    Replaces plain Morton-code sorting: Morton runs of 128 triangles can
    straddle cell boundaries and produce heavily overlapping cluster
    AABBs; recursive median splits partition space so sibling clusters
    overlap minimally and the depth-first leaf order keeps the
    super-cluster grouping spatially tight. O(n log^2 n) in numpy."""
    n = centroids.shape[0]
    out = np.empty(n, np.int32)
    pos = 0
    stack = [np.arange(n, dtype=np.int32)]
    while stack:
        idx = stack.pop()
        if len(idx) <= cluster_size:
            out[pos : pos + len(idx)] = idx
            pos += len(idx)
            continue
        c = centroids[idx]
        axis = int(np.argmax(c.max(axis=0) - c.min(axis=0)))
        # Split at a cluster-size multiple so every leaf except the last
        # fills a whole cluster (no half-empty 128-wide unrolls).
        half = len(idx) // 2
        mid = max(cluster_size, (half // cluster_size) * cluster_size)
        part = np.argsort(c[:, axis], kind="stable")
        stack.append(idx[part[mid:]])
        stack.append(idx[part[:mid]])
    assert pos == n
    return out


def _split_oversized(
    tris: np.ndarray, index: np.ndarray, frac: float, max_factor: float
):
    """Longest-edge bisection of triangles whose longest edge exceeds
    ``frac`` of the scene extent.

    Scene-spanning triangles (the showcase floor is two 20-unit quads)
    poison Morton clustering: any cluster containing one gets a
    scene-sized AABB that every traversal must visit. Splitting changes
    no geometry — children lie exactly in the parent's plane with the
    same winding, so normals, materials and hit distances are preserved
    (hit positions differ only by float rounding). ``index`` maps each
    output triangle to its original id. Growth is capped at
    ``max_factor``x the input count.
    """
    lo = tris.min(axis=(0, 1))
    hi = tris.max(axis=(0, 1))
    limit = float(np.max(hi - lo)) * frac
    if limit <= 0.0:
        return tris, index
    budget = int(max_factor * len(tris))
    out_t = list(tris)
    out_i = list(index)
    work = list(range(len(out_t)))
    while work and len(out_t) < budget:
        ti = work.pop()
        t = out_t[ti]
        e = ((np.roll(t, -1, axis=0) - t) ** 2).sum(axis=1)  # edge^2 ab,bc,ca
        k = int(np.argmax(e))
        if e[k] <= limit * limit:
            continue
        a, b, c = t[k], t[(k + 1) % 3], t[(k + 2) % 3]
        m = 0.5 * (a + b)
        out_t[ti] = np.stack([a, m, c])
        out_t.append(np.stack([m, b, c]))
        out_i.append(out_i[ti])
        work.append(ti)
        work.append(len(out_t) - 1)
    return np.asarray(out_t, np.float32), np.asarray(out_i, np.int32)


def pair_quads(
    tris: np.ndarray,
    mats: np.ndarray,
    rel_tol: float = 1e-5,
):
    """Merge coplanar shared-edge triangle pairs into planar convex quads.

    Returns ``(prims, ab, pmats, ptri, centroids)`` where ``prims`` is
    (P, 4, 3) — corners [v0, v1, v2, far] with the MT basis v0/e1=v1-v0/
    e2=v2-v0 — ``ab`` is (P, 2) far-corner coefficients (far = v0 +
    a*e1 + b*e2; triangles carry (0.5, 0.5) and duplicate v0 as ``far``),
    ``pmats``/``ptri`` the per-primitive material / primary original
    triangle id, and ``centroids`` the true primitive centroids.

    A pair merges only when: the edge is shared by exactly two same-
    material triangles, the opposite vertex lies in the first triangle's
    plane within ``rel_tol`` * scene extent, the quad is convex
    (a, b > 0, a + b > 1), and the windings are consistent. The merged
    quad's acceptance region is EXACTLY the union of the two triangles
    (planar within tolerance), its plane/normal is the first triangle's,
    and unpaired triangles keep their original vertex order so their MT
    arithmetic is bit-identical to an unpaired build.
    """
    n = len(tris)
    tris = np.asarray(tris, np.float32)
    mats = np.asarray(mats, np.int32)
    if n == 0:
        # tris.max() below raises on an empty array; an empty scene pairs
        # to an empty primitive set.
        empty3 = np.zeros((0, 4, 3), np.float32)
        return (
            empty3,
            np.zeros((0, 2), np.float32),
            np.zeros((0,), np.int32),
            np.zeros((0,), np.int32),
            np.zeros((0, 3), np.float32),
        )

    # --- candidate edges: (3n, ...) with a canonical endpoint order ---
    va = tris  # (n, 3, 3): edge k runs v[k] -> v[(k+1)%3]
    ea = va.reshape(-1, 3)  # 3n edge starts in (tri, k) order
    eb = np.roll(va, -1, axis=1).reshape(-1, 3)
    swap = (
        (ea[:, 0] > eb[:, 0])
        | ((ea[:, 0] == eb[:, 0]) & (ea[:, 1] > eb[:, 1]))
        | ((ea[:, 0] == eb[:, 0]) & (ea[:, 1] == eb[:, 1])
           & (ea[:, 2] > eb[:, 2]))
    )
    lo = np.where(swap[:, None], eb, ea)
    hi = np.where(swap[:, None], ea, eb)
    keys = np.concatenate([lo, hi], axis=1)  # (3n, 6)
    tri_of = np.repeat(np.arange(n, dtype=np.int32), 3)
    opp_of = np.tile(np.array([2, 0, 1], np.int32), n)  # vertex not on edge k

    _, inv, counts = np.unique(
        keys, axis=0, return_inverse=True, return_counts=True
    )
    shared = counts[inv] == 2  # edge rows belonging to 2-triangle edges
    order = np.argsort(inv[shared], kind="stable")
    rows = np.nonzero(shared)[0][order]  # paired rows adjacent
    r_i, r_j = rows[0::2], rows[1::2]
    ti, tj = tri_of[r_i], tri_of[r_j]
    oi, oj = opp_of[r_i], opp_of[r_j]

    ok = (ti != tj) & (mats[ti] == mats[tj])
    ti, tj, oi, oj = ti[ok], tj[ok], oi[ok], oj[ok]

    # --- quad basis at tri i's opposite vertex (winding-preserving
    # cyclic order: A = ti[oi], then the shared edge endpoints) ---
    idx = np.arange(len(ti))
    A = tris[ti, oi]
    p = tris[ti, (oi + 1) % 3]
    q = tris[ti, (oi + 2) % 3]
    w = tris[tj, oj] - A  # far corner relative to A
    e1 = p - A
    e2 = q - A

    # least-squares (a, b) with w = a*e1 + b*e2 via 2x2 normal equations
    g11 = np.einsum("ij,ij->i", e1, e1)
    g12 = np.einsum("ij,ij->i", e1, e2)
    g22 = np.einsum("ij,ij->i", e2, e2)
    b1 = np.einsum("ij,ij->i", e1, w)
    b2 = np.einsum("ij,ij->i", e2, w)
    det = g11 * g22 - g12 * g12
    safe = np.abs(det) > 1e-30
    inv_det = np.where(safe, 1.0 / np.where(safe, det, 1.0), 0.0)
    a = (g22 * b1 - g12 * b2) * inv_det
    b = (g11 * b2 - g12 * b1) * inv_det

    # Planarity tolerance: hits on the second triangle of a merged pair
    # are snapped to the FIRST triangle's plane, so rel_tol bounds the
    # worst-case hit-position perturbation at rel_tol * extent — kept at
    # 1e-5 (on the shipped scenes: <= ~1e-4 world units, the same order
    # as the integrator's T_MIN=1e-4 surface epsilon, and two orders
    # below any media mean free path). Slightly-bent "quads" beyond the
    # tolerance stay as two exact triangles.
    extent = float(np.max(tris.max(axis=(0, 1)) - tris.min(axis=(0, 1))))
    tol = rel_tol * max(extent, 1e-20)
    resid = w - a[:, None] * e1 - b[:, None] * e2
    planar = np.einsum("ij,ij->i", resid, resid) <= tol * tol

    nq = np.cross(e1, e2)
    nj = np.cross(tris[tj, 1] - tris[tj, 0], tris[tj, 2] - tris[tj, 0])
    consistent = np.einsum("ij,ij->i", nq, nj) > 0.0

    good = (
        safe & planar & consistent
        & (a > 1e-6) & (b > 1e-6) & (a + b > 1.0 + 1e-6)
    )

    # --- greedy matching (a triangle joins at most one pair) ---
    used = np.zeros(n, bool)
    take = np.zeros(len(ti), bool)
    for k in np.nonzero(good)[0]:
        if used[ti[k]] or used[tj[k]]:
            continue
        used[ti[k]] = used[tj[k]] = True
        take[k] = True
    idx = np.nonzero(take)[0]

    # --- emit primitives: quads first, then leftover triangles ---
    far = A[idx] + a[idx, None] * e1[idx] + b[idx, None] * e2[idx]
    quad_v = np.stack([A[idx], p[idx], q[idx], far], axis=1)
    quad_ab = np.stack([a[idx], b[idx]], axis=1).astype(np.float32)
    quad_mat = mats[ti[idx]]
    quad_tri = ti[idx]
    quad_cent = (A[idx] + p[idx] + q[idx] + tris[tj[idx], oj[idx]]) / 4.0

    rest = np.nonzero(~used)[0].astype(np.int32)
    tri_v = np.concatenate(
        [tris[rest], tris[rest, :1]], axis=1
    )  # 4th corner = v0 duplicate (AABB-neutral)
    tri_ab = np.full((len(rest), 2), 0.5, np.float32)
    tri_cent = tris[rest].mean(axis=1)

    prims = np.concatenate([quad_v, tri_v]).astype(np.float32)
    ab = np.concatenate([quad_ab, tri_ab])
    pmats = np.concatenate([quad_mat, mats[rest]]).astype(np.int32)
    ptri = np.concatenate([quad_tri, rest]).astype(np.int32)
    cents = np.concatenate([quad_cent, tri_cent]).astype(np.float32)
    return prims, ab, pmats, ptri, cents


def build_clusters(
    triangles: np.ndarray,
    mat_ids: np.ndarray | None = None,
    cluster_size: int = CLUSTER_SIZE,
    split_frac: float = 0.0,
    media_mats=None,
    super_factor: int = SUPER_FACTOR,
    quads: bool = False,
) -> ClusterGrid:
    """Build a ClusterGrid over ``triangles`` of shape (T, 3, 3).

    ``mat_ids`` (T,) lets the tracer return the hit material directly
    (saving the integrator a per-lane gather); defaults to zeros.
    ``cluster_size`` is the tracer's statically-unrolled inner width —
    128 (a full lane vector) in production; tests shrink it so the Pallas
    interpreter stays fast. ``split_frac`` bisects triangles longer than
    that fraction of the scene extent before clustering (0 disables; see
    _split_oversized). Splitting remaps u/v to the sub-triangle, so the
    renderer enables it for beauty passes only (hit positions, normals,
    materials and distances are plane-exact either way).

    ``media_mats`` (iterable of mat ids bearing media) partitions the
    grid: opaque-only clusters first (super-aligned), media-bearing ones
    after, so the NEE sweep can run a cheap occlusion walk over the
    opaque range and boundary collection over the media range only.

    ``quads=True`` merges coplanar shared-edge triangle pairs into
    planar-quad slots before clustering (see pair_quads / the ClusterGrid
    docstring) — near-2x fewer slots on quad-tessellated meshes for the
    same acceptance geometry.
    """
    tris = np.asarray(triangles, np.float32)
    num_tris = tris.shape[0]
    if num_tris == 0:
        raise ValueError("cannot build clusters over zero triangles")

    orig_index = np.arange(num_tris, dtype=np.int32)
    if split_frac > 0.0:
        tris, orig_index = _split_oversized(tris, orig_index, split_frac, 4.0)
        num_tris = tris.shape[0]

    tri_mats = (
        np.asarray(mat_ids, np.int32)[orig_index]
        if mat_ids is not None
        else np.zeros(num_tris, np.int32)
    )

    if quads:
        prims, prim_ab, prim_mats, ptri, centroids = pair_quads(
            tris, tri_mats
        )
    else:
        prims = np.concatenate([tris, tris[:, :1]], axis=1)
        prim_ab = np.full((num_tris, 2), 0.5, np.float32)
        prim_mats = tri_mats
        ptri = np.arange(num_tris, dtype=np.int32)
        centroids = tris.mean(axis=1)
    num_prims = prims.shape[0]

    media_list = sorted(set(int(m) for m in media_mats)) if media_mats else []
    if media_list:
        is_med = np.isin(prim_mats, np.asarray(media_list, np.int32))
        group_idx = [
            np.where(~is_med)[0].astype(np.int32),
            np.where(is_med)[0].astype(np.int32),
        ]
    else:
        group_idx = [np.arange(num_prims, dtype=np.int32)]

    partitioned = len(group_idx) == 2 and all(len(g) for g in group_idx)
    streams = []
    cluster_counts = []
    for gi, idx in enumerate(group_idx):
        if len(idx) == 0:
            cluster_counts.append(0)
            continue
        order_g = _median_split_order(centroids[idx], cluster_size)
        ids = idx[order_g]
        cg = -(-len(ids) // cluster_size)
        if partitioned and gi == 0:
            # Pad the opaque range to a whole number of super-clusters so
            # the media range starts on a super boundary.
            cg = -(-cg // super_factor) * super_factor
        stream = np.full(cg * cluster_size, -1, np.int32)
        stream[: len(ids)] = ids
        streams.append(stream)
        cluster_counts.append(cg)
    slot_ids = np.concatenate(streams)
    num_clusters = sum(cluster_counts)
    slots = num_clusters * cluster_size
    num_opaque_clusters = cluster_counts[0] if partitioned else 0
    num_opaque_supers = (
        num_opaque_clusters // super_factor if partitioned else 0
    )

    valid = slot_ids >= 0
    safe = np.maximum(slot_ids, 0)
    tri_index = np.where(valid, orig_index[ptri[safe]], -1).astype(np.int32)
    mats = np.where(valid, prim_mats[safe], -1).astype(np.int32)

    packed = np.zeros((slots, 4, 3), np.float32)
    packed[valid] = prims[slot_ids[valid]]
    packed_ab = np.full((slots, 2), 0.5, np.float32)
    packed_ab[valid] = prim_ab[slot_ids[valid]]

    comp = packed.reshape(num_clusters, cluster_size, 4, 3)

    # Empty pad clusters get a FAR-AWAY POINT box (lo = hi = 1e30): the
    # kernel's slab test then yields tn > TMAX for any ray. (An inverted
    # lo=+inf/hi=-inf box would NOT cull: slab_entry takes per-axis
    # min/max of the two plane distances, so it degenerates to
    # (-inf, +inf) and always intersects.)
    bounds = np.zeros((num_clusters, 8), np.float32)
    bounds[:, 0:6] = np.float32(1e30)
    cluster_empty = np.ones(num_clusters, bool)
    for c in range(num_clusters):
        real = tri_index[c * cluster_size : (c + 1) * cluster_size] >= 0
        if not np.any(real):
            continue
        member = comp[c][real]  # (n, 3, 3)
        bounds[c, 0:3] = member.min(axis=(0, 1))
        bounds[c, 3:6] = member.max(axis=(0, 1))
        cluster_empty[c] = False

    # Second culling level: AABBs over groups of SUPER_FACTOR consecutive
    # (Morton-adjacent, hence spatially tight) clusters. Empty member
    # clusters are excluded so their far-box sentinel doesn't inflate the
    # super's AABB to [real_lo, 1e30].
    num_supers = -(-num_clusters // super_factor)
    super_bounds = np.zeros((num_supers, 8), np.float32)
    super_bounds[:, 0:6] = np.float32(1e30)
    for s in range(num_supers):
        grp = bounds[s * super_factor : (s + 1) * super_factor]
        live = ~cluster_empty[s * super_factor : (s + 1) * super_factor]
        if not np.any(live):
            continue
        super_bounds[s, 0:3] = grp[live, 0:3].min(axis=0)
        super_bounds[s, 3:6] = grp[live, 3:6].max(axis=0)

    # (A third, sub-run culling level was built here through round 3 and
    # removed: per-run AABB gating measured slower than straight-line
    # triangle arithmetic at every granularity — see NOTES.md round-3.)

    def field(vi, ci):
        return np.ascontiguousarray(comp[:, :, vi, ci])

    def edge(vi, ci):
        return np.ascontiguousarray(comp[:, :, vi, ci] - comp[:, :, 0, ci])

    ab2 = packed_ab.reshape(num_clusters, cluster_size, 2)
    return ClusterGrid(
        v0x=field(0, 0), v0y=field(0, 1), v0z=field(0, 2),
        e1x=edge(1, 0), e1y=edge(1, 1), e1z=edge(1, 2),
        e2x=edge(2, 0), e2y=edge(2, 1), e2z=edge(2, 2),
        bounds=bounds,
        super_bounds=super_bounds,
        tri_index=tri_index,
        mat_id=mats.reshape(num_clusters, cluster_size),
        num_opaque_clusters=num_opaque_clusters,
        num_opaque_supers=num_opaque_supers,
        super_factor=super_factor,
        qa=np.ascontiguousarray(ab2[:, :, 0]),
        qb=np.ascontiguousarray(ab2[:, :, 1]),
    )
