"""Binned-SAH BVH build + threaded flattening (host numpy).

Counterpart of complex_materials_renderer_tpu/accel/bvh.py: the same
layout, for the threaded-BVH walk of ``kernels/traverse.py``:

- depth-first preorder node array (an interior node's first child is
  ``node + 1``);
- every node carries a *miss link*, the node to visit after skipping or
  finishing its subtree, so a walk needs one cursor per ray and no stack;
- leaf triangles are re-ordered contiguously, so a leaf is (first, count)
  into the permuted triangle stream.

``build_bvh`` builds with the host library's C++ builder (native.py), as
the JAX package does with its own, so both walk the same tree;
``_build_bvh_python`` is the JAX package's numpy builder, whose tree
differs from the C++ one: C++ bins a centroid by ``(c - min) * (16 /
extent)`` and splits at the chosen bin's plane with ``std::partition``,
which reorders the triangles; numpy bins by ``(c - min) / extent * 16`` and
splits by bin, keeping their order. It runs under ``CMR_NO_NATIVE``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from .. import native

_NUM_BINS = 16


class FlatBVH(NamedTuple):
    bmin: np.ndarray  # (N, 3) float32 node AABB min
    bmax: np.ndarray  # (N, 3) float32 node AABB max
    left: np.ndarray  # (N,) int32: first child (interior) or first triangle (leaf)
    count: np.ndarray  # (N,) int32: 0 for interior, #triangles for leaf
    miss: np.ndarray  # (N,) int32: skip link; -1 terminates traversal
    tri_order: np.ndarray  # (T,) int32 permutation of input triangles

    @property
    def num_nodes(self) -> int:
        return self.bmin.shape[0]


class _Node:
    __slots__ = ("bmin", "bmax", "first", "count", "child_a", "child_b")

    def __init__(self, bmin, bmax, first=-1, count=0):
        self.bmin = bmin
        self.bmax = bmax
        self.first = first
        self.count = count
        self.child_a = None
        self.child_b = None


def build_bvh(triangles: np.ndarray, leaf_size: int = 4) -> FlatBVH:
    """Build a threaded BVH over ``triangles`` of shape (T, 3, 3): binned
    SAH on the widest centroid axis, median split when all centroids
    coincide. The host library's C++ builder, whose arrays equal those of
    the JAX package's native ``build_bvh`` byte for byte; under
    ``CMR_NO_NATIVE``, ``_build_bvh_python``."""
    tris = np.asarray(triangles, np.float32)
    if tris.shape[0] == 0:
        raise ValueError("cannot build a BVH over zero triangles")
    if native.disabled():
        return _build_bvh_python(tris, leaf_size)
    bmin, bmax, left, count, miss, order = native.build_bvh(tris, leaf_size)
    return FlatBVH(bmin=bmin, bmax=bmax, left=left, count=count, miss=miss, tri_order=order)


def _build_bvh_python(triangles: np.ndarray, leaf_size: int = 4) -> FlatBVH:
    """The numpy builder ``_build_bvh_python`` of the JAX package
    (bvh.py:73), whose arrays it reproduces byte for byte."""
    tris = np.asarray(triangles, np.float32)
    num_tris = tris.shape[0]
    if num_tris == 0:
        raise ValueError("cannot build a BVH over zero triangles")

    tri_min = tris.min(axis=1)  # (T, 3)
    tri_max = tris.max(axis=1)
    centroids = 0.5 * (tri_min + tri_max)

    order = np.arange(num_tris, dtype=np.int64)
    out_order = np.empty(num_tris, dtype=np.int32)
    out_cursor = 0

    def node_bounds(idx):
        return tri_min[idx].min(axis=0), tri_max[idx].max(axis=0)

    root_bmin, root_bmax = node_bounds(order)
    root = _Node(root_bmin, root_bmax)

    # Explicit-stack build (scene sizes make recursion depth a non-issue,
    # but an explicit stack avoids Python's recursion limit regardless).
    stack = [(root, order)]
    while stack:
        node, idx = stack.pop()
        n = idx.shape[0]
        if n <= leaf_size:
            node.first = out_cursor
            node.count = n
            out_order[out_cursor : out_cursor + n] = idx
            out_cursor += n
            continue

        cents = centroids[idx]
        c_min = cents.min(axis=0)
        c_max = cents.max(axis=0)
        extent = c_max - c_min
        axis = int(np.argmax(extent))

        if extent[axis] <= 1e-12:
            # Degenerate: all centroids identical — split in half.
            half = n // 2
            left_idx, right_idx = idx[:half], idx[half:]
        else:
            # Binned SAH.
            rel = (cents[:, axis] - c_min[axis]) / extent[axis]
            bins = np.minimum((rel * _NUM_BINS).astype(np.int32), _NUM_BINS - 1)
            bin_counts = np.bincount(bins, minlength=_NUM_BINS)

            bin_bmin = np.full((_NUM_BINS, 3), np.inf, np.float32)
            bin_bmax = np.full((_NUM_BINS, 3), -np.inf, np.float32)
            for a in range(3):
                np.minimum.at(bin_bmin[:, a], bins, tri_min[idx][:, a])
                np.maximum.at(bin_bmax[:, a], bins, tri_max[idx][:, a])

            # Prefix/suffix sweeps for SAH.
            lmin = np.minimum.accumulate(bin_bmin, axis=0)
            lmax = np.maximum.accumulate(bin_bmax, axis=0)
            rmin = np.minimum.accumulate(bin_bmin[::-1], axis=0)[::-1]
            rmax = np.maximum.accumulate(bin_bmax[::-1], axis=0)[::-1]
            lcount = np.cumsum(bin_counts)
            rcount = np.cumsum(bin_counts[::-1])[::-1]

            def area(mn, mx):
                d = np.maximum(mx - mn, 0.0)
                return d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2] + d[:, 2] * d[:, 0]

            # Split after bin k: left = bins [0..k], right = [k+1..].
            cost = area(lmin[:-1], lmax[:-1]) * lcount[:-1] + area(
                rmin[1:], rmax[1:]
            ) * rcount[1:]
            cost = np.where((lcount[:-1] == 0) | (rcount[1:] == 0), np.inf, cost)
            k = int(np.argmin(cost))
            if not np.isfinite(cost[k]):
                half = n // 2
                part = np.argsort(cents[:, axis], kind="stable")
                left_idx, right_idx = idx[part[:half]], idx[part[half:]]
            else:
                go_left = bins <= k
                left_idx, right_idx = idx[go_left], idx[~go_left]

        la_min, la_max = node_bounds(left_idx)
        rb_min, rb_max = node_bounds(right_idx)
        node.child_a = _Node(la_min, la_max)
        node.child_b = _Node(rb_min, rb_max)
        # Push right first so the left subtree is processed (and its leaf
        # triangles emitted) first — matching preorder flattening below.
        stack.append((node.child_b, right_idx))
        stack.append((node.child_a, left_idx))

    # Preorder flatten with miss links. The right child's index is the left
    # child's index plus the left subtree size, so precompute subtree sizes
    # iteratively (postorder) first.
    bmin_l, bmax_l, left_l, count_l, miss_l = [], [], [], [], []
    sizes = {}
    post = [(root, False)]
    while post:
        node, processed = post.pop()
        if node.child_a is None:
            sizes[id(node)] = 1
            continue
        if processed:
            sizes[id(node)] = 1 + sizes[id(node.child_a)] + sizes[id(node.child_b)]
        else:
            post.append((node, True))
            post.append((node.child_a, False))
            post.append((node.child_b, False))

    emit_stack = [(root, -1)]
    while emit_stack:
        node, miss = emit_stack.pop()
        index = len(bmin_l)
        bmin_l.append(node.bmin)
        bmax_l.append(node.bmax)
        miss_l.append(miss)
        if node.child_a is None:
            left_l.append(node.first)
            count_l.append(node.count)
        else:
            left_index = index + 1
            right_index = left_index + sizes[id(node.child_a)]
            left_l.append(left_index)
            count_l.append(0)
            # Preorder: emit left next (its miss link is the right child),
            # then right (its miss link is this node's miss link).
            emit_stack.append((node.child_b, miss))
            emit_stack.append((node.child_a, right_index))

    return FlatBVH(
        bmin=np.asarray(bmin_l, np.float32),
        bmax=np.asarray(bmax_l, np.float32),
        left=np.asarray(left_l, np.int32),
        count=np.asarray(count_l, np.int32),
        miss=np.asarray(miss_l, np.int32),
        tri_order=out_order.astype(np.int32),
    )
