"""KD-tree construction over triangle AABBs (host-side, vectorized numpy).

Re-implements the reference's n·log n median-split build
(``TEST_Dungeonrun/Trixel.h:135-385`` ``create_kd`` +
``Trixel.h:386-473`` ``set_sorted_voxels``) with the same splitting rules:

- Six sort orders over the per-triangle AABB scalars x0/y0/z0/x1/y1/z1
  (the reference's 6 merge-sorted leaf lists, sort.h:33-52). We use numpy
  stable argsort instead of explicit merge sort + cross-index tables —
  the cross-index bookkeeping (Trixel.h:214-327) exists only because the C++
  partitions structs in place; with id permutations a boolean membership
  partition is equivalent and vectorized.
- Cut axis = the (axis, bound) pair with maximum spread among the six
  candidates, ties resolved in the reference's probe order x1,x0,y1,y0,z1,z0
  with strictly-greater updates (Trixel.h:172-193).
- Split at the median rank m = (r-l)/2 + l of the cut order; ranks <= m go
  left (Trixel.h:259: "ele at m goes right" comment notwithstanding, the
  code sends index <= m left and children are [l,m],[m+1,r]).
- Child bounds read off the sorted orders at the new endpoints
  (Trixel.h:345-350); split planes s1 = left child's max on the cut axis,
  s2 = right child's min (Trixel.h:354-376).
- Leaf when the range has <= min_node_size triangles. The reference fixes
  min_node_size=1 (Trixel.h:80); we generalize: with wide leaves (e.g. 128)
  each leaf becomes a dense, contiguous triangle block intersected as one
  batch (see accel/traverse.py).

Output is a flat struct-of-arrays `KDTree` — the analogue of the device
tables ``Camera::voxel_memory`` is built from (Camera.h:69-84) — plus a
triangle permutation that makes every leaf's triangles contiguous, which the
reference achieves implicitly by reading ``tri_list_index`` out of the final
x1 order (Trixel.h:202).
"""

from __future__ import annotations

import dataclasses

import numpy as np

# Probe order and cut codes per Trixel.h:172-193: code 0=x1, 1=y1, 2=z1,
# 3=x0, 4=y0, 5=z0. Axis = code % 3.
_PROBE_ORDER = (0, 3, 1, 4, 2, 5)  # x1, x0, y1, y0, z1, z0


@dataclasses.dataclass
class KDTree:
    """Flattened KD tree, numpy host-side.

    Node 0 is the root. Internal nodes have left/right >= 0; leaves have
    left = right = -1 and cover triangles [leaf_start, leaf_start+leaf_count)
    of the *permuted* triangle array (perm maps new position -> original
    triangle index).
    """

    bounds_min: np.ndarray   # (N, 3) float32
    bounds_max: np.ndarray   # (N, 3) float32
    cut_code: np.ndarray     # (N,) int8, 0..5 (x1,y1,z1,x0,y0,z0); axis=code%3
    s1: np.ndarray           # (N,) float32 — left child's max on cut axis
    s2: np.ndarray           # (N,) float32 — right child's min on cut axis
    left: np.ndarray         # (N,) int32, -1 at leaves
    right: np.ndarray        # (N,) int32, -1 at leaves
    parent: np.ndarray       # (N,) int32, 0 at root
    leaf_start: np.ndarray   # (N,) int32 (valid at leaves)
    leaf_count: np.ndarray   # (N,) int32 (valid at leaves)
    perm: np.ndarray         # (T,) int64 — new position -> original tri id
    min_node_size: int

    @property
    def num_nodes(self) -> int:
        return int(self.left.shape[0])

    @property
    def is_leaf(self) -> np.ndarray:
        return self.left < 0

    @property
    def num_leaves(self) -> int:
        return int(self.is_leaf.sum())

    @property
    def max_depth(self) -> int:
        depth = np.zeros(self.num_nodes, np.int32)
        for i in range(1, self.num_nodes):
            depth[i] = depth[self.parent[i]] + 1
        return int(depth.max())


def build_kd(aabb_min: np.ndarray, aabb_max: np.ndarray,
             min_node_size: int = 1) -> KDTree:
    """Median-split KD build. O(n log n): each level partitions all six
    orders once, via boolean membership (stable) instead of rank tables."""
    n = aabb_min.shape[0]
    if n == 0:
        raise ValueError("cannot build a KD tree over zero triangles")
    aabb_min = np.asarray(aabb_min, np.float64)
    aabb_max = np.asarray(aabb_max, np.float64)
    # keys[c]: c in 0..5 -> x1,y1,z1,x0,y0,z0 (cut-code order)
    keys = [aabb_max[:, 0], aabb_max[:, 1], aabb_max[:, 2],
            aabb_min[:, 0], aabb_min[:, 1], aabb_min[:, 2]]
    orders = [np.argsort(k, kind="stable") for k in keys]

    cap = 2 * n  # <= 2*ceil(n/min_node_size) - 1 nodes, padded headroom
    bmin = np.zeros((cap, 3), np.float64)
    bmax = np.zeros((cap, 3), np.float64)
    cut_code = np.zeros(cap, np.int8)
    s1 = np.zeros(cap, np.float64)
    s2 = np.zeros(cap, np.float64)
    left = np.full(cap, -1, np.int32)
    right = np.full(cap, -1, np.int32)
    parent = np.zeros(cap, np.int32)
    leaf_start = np.full(cap, -1, np.int32)
    leaf_count = np.zeros(cap, np.int32)

    in_left = np.zeros(n, bool)

    def node_bounds(l: int, r: int) -> tuple[np.ndarray, np.ndarray]:
        return (
            np.array([keys[3][orders[3][l]], keys[4][orders[4][l]],
                      keys[5][orders[5][l]]]),
            np.array([keys[0][orders[0][r]], keys[1][orders[1][r]],
                      keys[2][orders[2][r]]]),
        )

    # BFS over (node_index, l, r) ranges — the reference's read/write index
    # walk over a preallocated array (Trixel.h:143-167).
    ranges = {0: (0, n - 1)}
    bmin[0], bmax[0] = node_bounds(0, n - 1)
    write_index = 1
    read_index = 0
    while read_index < write_index:
        l, r = ranges.pop(read_index)
        count = r - l + 1
        if count <= min_node_size:
            leaf_start[read_index] = l
            leaf_count[read_index] = count
            cut_code[read_index] = cut_code[parent[read_index]]
            read_index += 1
            continue

        # pick the (axis, bound) with max spread (strict-greater updates in
        # probe order, Trixel.h:172-193)
        best_code, best_spread = 0, keys[0][orders[0][r]] - keys[0][orders[0][l]]
        for code in _PROBE_ORDER[1:]:
            spread = keys[code][orders[code][r]] - keys[code][orders[code][l]]
            if spread > best_spread:
                best_spread, best_code = spread, code
        cut_code[read_index] = best_code

        m = (r - l) // 2 + l
        left_ids = orders[best_code][l:m + 1]
        in_left[left_ids] = True
        for code in range(6):
            if code == best_code:
                continue
            seg = orders[code][l:r + 1]
            mask = in_left[seg]
            orders[code][l:r + 1] = np.concatenate([seg[mask], seg[~mask]])
        in_left[left_ids] = False

        li, ri = write_index, write_index + 1
        left[read_index], right[read_index] = li, ri
        parent[li] = parent[ri] = read_index
        bmin[li], bmax[li] = node_bounds(l, m)
        bmin[ri], bmax[ri] = node_bounds(m + 1, r)
        ranges[li] = (l, m)
        ranges[ri] = (m + 1, r)
        axis = best_code % 3
        s1[read_index] = bmax[li][axis]   # left child's max (Trixel.h:354-376)
        s2[read_index] = bmin[ri][axis]   # right child's min
        write_index += 2
        read_index += 1

    num_nodes = write_index
    return KDTree(
        bounds_min=bmin[:num_nodes].astype(np.float32),
        bounds_max=bmax[:num_nodes].astype(np.float32),
        cut_code=cut_code[:num_nodes],
        s1=s1[:num_nodes].astype(np.float32),
        s2=s2[:num_nodes].astype(np.float32),
        left=left[:num_nodes], right=right[:num_nodes],
        parent=parent[:num_nodes],
        leaf_start=leaf_start[:num_nodes],
        leaf_count=leaf_count[:num_nodes],
        perm=orders[0].copy(),
        min_node_size=min_node_size,
    )


def validate_kd(tree: KDTree, aabb_min: np.ndarray, aabb_max: np.ndarray
                ) -> None:
    """Structural invariants (the tests the reference never had, SURVEY §4):
    full coverage, bounds nesting, disjoint leaf ranges, split-plane
    consistency. Raises AssertionError on violation."""
    n = aabb_min.shape[0]
    is_leaf = tree.is_leaf
    # every triangle appears exactly once across leaf ranges
    seen = np.zeros(n, np.int32)
    for i in np.nonzero(is_leaf)[0]:
        s, c = tree.leaf_start[i], tree.leaf_count[i]
        seen[tree.perm[s:s + c]] += 1
    assert (seen == 1).all(), "leaf ranges must partition the triangles"
    # bounds nest and contain their triangles
    for i in range(tree.num_nodes):
        p = tree.parent[i]
        assert (tree.bounds_min[i] >= tree.bounds_min[p] - 1e-5).all()
        assert (tree.bounds_max[i] <= tree.bounds_max[p] + 1e-5).all()
        if is_leaf[i]:
            s, c = tree.leaf_start[i], tree.leaf_count[i]
            ids = tree.perm[s:s + c]
            assert (aabb_min[ids] >= tree.bounds_min[i] - 1e-5).all()
            assert (aabb_max[ids] <= tree.bounds_max[i] + 1e-5).all()
        else:
            li, ri = tree.left[i], tree.right[i]
            axis = tree.cut_code[i] % 3
            assert abs(tree.s1[i] - tree.bounds_max[li][axis]) <= 1e-6
            assert abs(tree.s2[i] - tree.bounds_min[ri][axis]) <= 1e-6
