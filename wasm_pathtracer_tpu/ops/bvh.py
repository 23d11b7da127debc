"""BVH construction (host) and flat-array layout (device).

The reference builds a binned-SAH BVH2 (``src/graphics/bvh.rs``:
16-bin SAH sweep over the longest axis, split accepted only when
cheaper than the parent leaf) and optionally collapses it into a
cache-aligned 4-wide BVH by dynamic programming on tree cuts
(``src/graphics/bvh4.rs``, Pinto's adaptive collapsing).  Traversal is
recursive with SIMD 4-box tests (``src/graphics/scene.rs:292-342``,
``aabb.rs:252-300``).

The array design keeps the *algorithms* (binned SAH, 2->4
collapse, ordered near-to-far descent) but changes every layout
decision:

- build runs on the host in NumPy (optionally the C++ builder in
  ``csrc/``, loaded via ctypes, for large meshes);
- the device sees two flat arrays — ``child_bounds (M, 4, 6)`` f32 and
  ``children (M, 4)`` int32 — the 4-wide analog of the reference's
  32-byte ``BVHNode`` / 128-byte ``BVHNode4`` records;
- leaves pack (first, count) into negative int32s, like the
  reference's sign-bit encoding (``scene.rs:301-309``), here
  ``-(first * 64 + count + 1)``;
- recursion becomes an iterative short-stack loop (``ops.traverse``).

The BVH covers the scene's triangle soup (meshes are where primitive
counts explode); the handful of other finite primitives stay in the
dense path (``ops.trace``).

``verify`` promotes the reference's production-time verifier
(``bvh.rs:128-194``, ``bvh4.rs:300-376``) to a test utility: bounds
containment + exact leaf coverage.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import jax.numpy as jnp

LEAF_MAX = 4          # max triangles per leaf
EMPTY = -1            # empty child slot == leaf with count 0
_COUNT_BITS = 64


def encode_leaf(first: int, count: int) -> int:
    return -(first * _COUNT_BITS + count + 1)


def decode_leaf(v):
    """Works for ints and arrays.  Returns (first, count)."""
    u = -v - 1
    return u // _COUNT_BITS, u % _COUNT_BITS


@dataclasses.dataclass
class BVH2Node:
    lo: np.ndarray
    hi: np.ndarray
    left: int = -1      # child index (internal) ...
    first: int = -1     # ... or triangle range (leaf)
    count: int = 0

    @property
    def is_leaf(self):
        return self.count > 0


def build_bvh2(lo: np.ndarray, hi: np.ndarray, num_bins: int = 16,
               leaf_max: int = LEAF_MAX):
    """Binned-SAH BVH2 over primitive AABBs.

    Re-derivation of ``BVHNode::build`` (``bvh.rs:99-370``): longest-axis
    uniform binning of centroids, O(bins) sweep minimizing
    ``SA_L*n_L + SA_R*n_R``, split accepted only if it beats the leaf
    cost — but a split is forced above ``leaf_max`` so device leaves
    stay fixed-size.

    Returns (nodes: list[BVH2Node], order: (T,) permutation of input
    primitive ids in leaf-contiguous order).
    """
    n = lo.shape[0]
    cent = (lo + hi) * 0.5
    order = np.arange(n)
    nodes: list[BVH2Node] = []

    def node_of(ids):
        return BVH2Node(lo=lo[ids].min(0), hi=hi[ids].max(0))

    def sa(l, h):
        d = np.maximum(h - l, 0.0)
        return 2.0 * (d[0] * d[1] + d[1] * d[2] + d[2] * d[0])

    # iterative top-down with explicit stack; children at adjacent slots
    root_ids = order.copy()
    nodes.append(node_of(root_ids))
    out_order = []
    stack = [(0, root_ids)]
    while stack:
        ni, ids = stack.pop()
        node = nodes[ni]
        m = len(ids)
        if m <= leaf_max:
            node.first = len(out_order)
            node.count = m
            out_order.extend(ids.tolist())
            continue

        c = cent[ids]
        cmin, cmax = c.min(0), c.max(0)
        axis = int(np.argmax(cmax - cmin))
        ext = cmax[axis] - cmin[axis]

        split_done = False
        if ext > 1e-12:
            # uniform binning (``bvh.rs:412-437``)
            b = np.minimum(((c[:, axis] - cmin[axis]) / ext * num_bins)
                           .astype(np.int64), num_bins - 1)
            counts = np.bincount(b, minlength=num_bins)
            # per-bin AABBs
            bin_lo = np.full((num_bins, 3), np.inf)
            bin_hi = np.full((num_bins, 3), -np.inf)
            for k in range(num_bins):
                sel = b == k
                if sel.any():
                    bin_lo[k] = lo[ids[sel]].min(0)
                    bin_hi[k] = hi[ids[sel]].max(0)
            # prefix/suffix sweeps
            lft_lo = np.minimum.accumulate(bin_lo, 0)
            lft_hi = np.maximum.accumulate(bin_hi, 0)
            rgt_lo = np.minimum.accumulate(bin_lo[::-1], 0)[::-1]
            rgt_hi = np.maximum.accumulate(bin_hi[::-1], 0)[::-1]
            nl = np.cumsum(counts)
            best_cost, best_k = np.inf, -1
            for k in range(num_bins - 1):
                n_l, n_r = nl[k], m - nl[k]
                if n_l == 0 or n_r == 0:
                    continue
                cost = (sa(lft_lo[k], lft_hi[k]) * n_l
                        + sa(rgt_lo[k + 1], rgt_hi[k + 1]) * n_r)
                if cost < best_cost:
                    best_cost, best_k = cost, k
            # accept only if better than the parent-as-leaf utility
            # (``bvh.rs:254-277``) unless the leaf would be oversized
            leaf_cost = sa(node.lo, node.hi) * m
            if best_k >= 0 and (best_cost < leaf_cost or m > leaf_max):
                sel = b <= best_k
                ids_l, ids_r = ids[sel], ids[~sel]
                split_done = len(ids_l) > 0 and len(ids_r) > 0

        if not split_done:
            # degenerate centroids: median split keeps leaves bounded
            perm = np.argsort(c[:, axis], kind="stable")
            half = m // 2
            ids_l, ids_r = ids[perm[:half]], ids[perm[half:]]

        li = len(nodes)
        node.left = li
        nodes.append(node_of(ids_l))
        nodes.append(node_of(ids_r))
        stack.append((li + 1, ids_r))
        stack.append((li, ids_l))

    return nodes, np.array(out_order, np.int64)


def _rcost_memo(nodes: list[BVH2Node]):
    """Pinto's adaptive-collapse DP table (``bvh4.rs:244-281``).

    For every internal BVH2 node ``n``, ``memo[n, t-1]`` is the minimal
    traversal cost of replacing ``n``'s subtree with a tree-cut of
    exactly ``t`` roots (t = 2..4), and ``memo[n, 0]`` is the cost of
    keeping ``n`` as one 4-wide node (one AABB test + its best <=4-cut
    of children).  ``F[n, c-1] = min(memo[n, :c])`` is the reference's
    ``node_flat_cost`` / ``r_cost(n, c)``; leaves cost 1 for every cut
    size (``bvh4.rs:246-252``).

    Computed with an iterative post-order walk (the reference recurses;
    meshes here can be deep enough to blow Python's stack).
    """
    N = len(nodes)
    memo = np.full((N, 4), np.inf, np.float64)
    F = np.ones((N, 4), np.float64)          # leaf default: cost 1 at any cut
    stack = [(0, False)]
    while stack:
        n, ready = stack.pop()
        nd = nodes[n]
        if nd.is_leaf:
            continue
        l, r = nd.left, nd.left + 1
        if not ready:
            stack.append((n, True))
            stack.append((l, False))
            stack.append((r, False))
            continue
        m = memo[n]
        for t in range(2, 5):
            best = np.inf
            for i in range(1, t):
                v = F[l, i - 1] + F[r, t - i - 1]
                if v < best:
                    best = v
            m[t - 1] = best
        m[0] = 1.0 + m[1:].min()
        F[n] = np.minimum.accumulate(m)
    return memo, F


def collapse_bvh4(nodes: list[BVH2Node]):
    """Collapse BVH2 -> 4-wide flat arrays, DP-optimally.

    Pinto's "Adaptive Collapsing" exactly as the reference implements it
    (``bvh4.rs:244-281`` cost DP, ``bvh4.rs:127-185`` backtracking):
    each internal node either *keeps* itself (one 4-wide AABB test, its
    children taken from the best <=4 tree-cut below it) or *dissolves*
    into a cut of 2..4 subtree roots hoisted into its parent.  The DP
    minimizes total AABB tests over the whole tree; ties break toward
    the smallest cut, matching the reference's strict-< argmin
    (``bvh4.rs:192-201``).

    Returns (child_bounds (M, 4, 6) f32, children (M, 4) int32).
    """
    if nodes[0].is_leaf:
        # tiny scene: one pseudo-root whose single child is the leaf
        b = np.zeros((1, 4, 6), np.float32)
        ch = np.full((1, 4), EMPTY, np.int32)
        b[0, 0, 0:3] = nodes[0].lo
        b[0, 0, 3:6] = nodes[0].hi
        ch[0, 0] = encode_leaf(nodes[0].first, nodes[0].count)
        return b, ch

    memo, F = _rcost_memo(nodes)
    out_bounds: list[np.ndarray] = []
    out_child: list[np.ndarray] = []

    def find_t(n: int, cutsize: int) -> int:
        # ``bvh4.rs:189-204``: smallest t minimizing memo[n, :cutsize]
        if nodes[n].is_leaf:
            return 1
        return int(np.argmin(memo[n, :cutsize])) + 1

    def flat_cost(n: int, c: int) -> float:
        return 1.0 if nodes[n].is_leaf else F[n, c - 1]

    def find_i(l: int, r: int, t: int) -> int:
        # ``bvh4.rs:207-224``: split the cut between the two children
        best_i, best = 1, flat_cost(l, 1) + flat_cost(r, t - 1)
        for i in range(2, t):
            v = flat_cost(l, i) + flat_cost(r, t - i)
            if v < best:
                best, best_i = v, i
        return best_i

    def fill(slot: int, kids: list) -> tuple[np.ndarray, np.ndarray]:
        for j, (klo, khi, ent) in enumerate(kids):
            out_bounds[slot][j, 0:3] = klo
            out_bounds[slot][j, 3:6] = khi
            out_child[slot][j] = ent
        hull_lo = np.min([k[0] for k in kids], axis=0)
        hull_hi = np.max([k[1] for k in kids], axis=0)
        return hull_lo, hull_hi

    def collapse(n: int, cutsize: int) -> list:
        """Returns the cut as [(lo, hi, child_entry)] — the BVH4
        replacement of BVH2 node ``n`` (``bvh4.rs:127-185``)."""
        nd = nodes[n]
        if nd.is_leaf:
            return [(nd.lo, nd.hi, encode_leaf(nd.first, nd.count))]
        l, r = nd.left, nd.left + 1
        t = find_t(n, cutsize)
        if t == 1:
            # keep the node: allocate a BVH4 slot, give it the best 4-cut
            slot = len(out_bounds)
            out_bounds.append(np.zeros((4, 6), np.float32))
            out_child.append(np.full((4,), EMPTY, np.int32))
            i = find_i(l, r, 4)
            kids = collapse(l, i) + collapse(r, 4 - i)
            hull_lo, hull_hi = fill(slot, kids)
            return [(hull_lo, hull_hi, slot)]
        # dissolve the node into its t-cut
        i = find_i(l, r, t)
        return collapse(l, i) + collapse(r, t - i)

    import sys
    old = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old, 10000 + len(nodes)))
    try:
        # slot 0 is always the root node; when the root's optimal choice
        # is to dissolve, its cut becomes the root's children (the
        # reference's placeholder rebuild, ``bvh4.rs:48-66``)
        out_bounds.append(np.zeros((4, 6), np.float32))
        out_child.append(np.full((4,), EMPTY, np.int32))
        l, r = nodes[0].left, nodes[0].left + 1
        t = find_t(0, 4)
        tt = 4 if t == 1 else t
        i = find_i(l, r, tt)
        kids = collapse(l, i) + collapse(r, tt - i)
        fill(0, kids)
    finally:
        sys.setrecursionlimit(old)
    return np.stack(out_bounds), np.stack(out_child)


def collapse_bvh4_greedy(nodes: list[BVH2Node]):
    """Greedy 2->4 collapse (largest-surface-area expansion) — kept as
    the comparison baseline for the DP collapse and as the algorithm
    mirrored by the native builder's fast path.

    Returns (child_bounds (M, 4, 6) f32, children (M, 4) int32).
    """

    def sa(nd):
        d = np.maximum(nd.hi - nd.lo, 0.0)
        return 2.0 * (d[0] * d[1] + d[1] * d[2] + d[2] * d[0])

    out_bounds: list[np.ndarray] = []
    out_child: list[np.ndarray] = []

    # map BVH2 index -> BVH4 slot, built on demand
    remap: dict[int, int] = {}

    def emit(ni: int) -> int:
        if ni in remap:
            return remap[ni]
        slot = len(out_bounds)
        remap[ni] = slot
        out_bounds.append(np.zeros((4, 6), np.float32))
        out_child.append(np.full((4,), EMPTY, np.int32))

        # gather up to 4 children of the BVH2 node
        kids = [nodes[ni].left, nodes[ni].left + 1]
        while len(kids) < 4:
            # expand the internal child with largest surface area
            cand = [(sa(nodes[k]), i) for i, k in enumerate(kids)
                    if not nodes[k].is_leaf]
            if not cand:
                break
            _, i = max(cand)
            k = kids.pop(i)
            kids.extend([nodes[k].left, nodes[k].left + 1])

        for i, k in enumerate(kids):
            kn = nodes[k]
            out_bounds[slot][i, 0:3] = kn.lo
            out_bounds[slot][i, 3:6] = kn.hi
            if kn.is_leaf:
                out_child[slot][i] = encode_leaf(kn.first, kn.count)
            else:
                out_child[slot][i] = emit(k)
        return slot

    if nodes[0].is_leaf:
        # tiny scene: one pseudo-root whose single child is the leaf
        b = np.zeros((1, 4, 6), np.float32)
        ch = np.full((1, 4), EMPTY, np.int32)
        b[0, 0, 0:3] = nodes[0].lo
        b[0, 0, 3:6] = nodes[0].hi
        ch[0, 0] = encode_leaf(nodes[0].first, nodes[0].count)
        return b, ch

    import sys
    old = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old, 10000 + len(nodes)))
    try:
        emit(0)
    finally:
        sys.setrecursionlimit(old)
    return np.stack(out_bounds), np.stack(out_child)


def build(tri_lo: np.ndarray, tri_hi: np.ndarray, num_bins: int = 16):
    """Full pipeline: AABBs -> BVH2 -> flat BVH4 + primitive order."""
    nodes2, order = build_bvh2(tri_lo, tri_hi, num_bins)
    bounds4, child4 = collapse_bvh4(nodes2)
    return bounds4, child4, order


def verify(bounds4: np.ndarray, child4: np.ndarray, order: np.ndarray,
           tri_lo: np.ndarray, tri_hi: np.ndarray) -> bool:
    """Structural verifier (the reference runs its analog on every
    production build, ``scene.rs:84-87``): every child AABB contains its
    primitives' AABBs, every internal child's subtree stays inside its
    stored bounds, and every primitive is referenced exactly once."""
    seen = np.zeros(order.shape[0], np.int64)
    eps = 1e-4

    def rec(ni) -> bool:
        ok = True
        for i in range(4):
            c = int(child4[ni, i])
            blo = bounds4[ni, i, 0:3]
            bhi = bounds4[ni, i, 3:6]
            if c == EMPTY:
                continue
            if c < 0:
                first, count = decode_leaf(c)
                for t in range(first, first + count):
                    p = order[t]
                    seen[t] += 1
                    if (tri_lo[p] < blo - eps).any() or \
                       (tri_hi[p] > bhi + eps).any():
                        return False
            else:
                for j in range(4):
                    if child4[c, j] != EMPTY:
                        if (bounds4[c, j, 0:3] < blo - eps).any() or \
                           (bounds4[c, j, 3:6] > bhi + eps).any():
                            return False
                ok = ok and rec(c)
        return ok

    import sys
    old = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old, 10000 + bounds4.shape[0]))
    try:
        ok = rec(0)
    finally:
        sys.setrecursionlimit(old)
    return bool(ok and (seen == 1).all())


def node_count(child4: np.ndarray) -> int:
    return child4.shape[0]


def depth(bounds4, child4, ni=0) -> int:
    best = 1
    for i in range(4):
        c = int(child4[ni, i])
        if c >= 0:
            best = max(best, 1 + depth(bounds4, child4, c))
    return best


def attach_bvh(prep, scene, num_bins: int = 16):
    """Build a BVH over the scene's triangles and attach it to the prep.

    The leaf order array maps leaf-contiguous triangle slots to global
    shape ids, so traversal gathers primitive rows straight from the
    unified shape table.
    """
    from wasm_pathtracer_tpu.models.scene import prim_aabb, PrimType

    tri_ids = np.asarray(prep.idx_triangle)
    params = np.asarray(scene.params)
    v = params[tri_ids][:, :9].reshape(-1, 3, 3)
    pad = np.float32(0.1 * 2e-4)
    lo = v.min(1) - pad
    hi = v.max(1) + pad

    # prefer the native C++ builder when available
    try:
        from wasm_pathtracer_tpu.ops import bvh_native
        bounds4, child4, order = bvh_native.build(lo, hi, num_bins)
    except Exception:
        bounds4, child4, order = build(lo, hi, num_bins)

    prim_index = tri_ids[order].astype(np.int32)
    # leaf-ordered triangle rows: contiguous fetches for the fast paths
    tri_rows = params[prim_index][:, :9].astype(np.float32)
    return dataclasses.replace(
        prep,
        bvh_bounds=jnp.asarray(bounds4),
        bvh_children=jnp.asarray(child4),
        bvh_prim_index=jnp.asarray(prim_index),
        bvh_tri_rows=jnp.asarray(tri_rows),
    )


def attach_clusters(prep, scene, num_bins: int = 16,
                    group: int | None = None,
                    min_count: int = 512,
                    families: list | None = None,
                    exclude_lights: bool = False):
    """Build the cluster-dense structure (``ops.cluster``) over the
    scene's finite primitives: a BVH build supplies the
    spatially-coherent leaf order, then contiguous runs become
    fixed-size clusters.  This is the default mesh path (see
    ops.cluster for why it is not a classic BVH walk).

    Like the reference's generic ``ShapeRep`` BVH over every finite
    shape (``bvh.rs:84-103``), the structure accepts ANY finite
    primitive type.  By default each family joins the structure when
    its count reaches ``min_count``; smaller families stay in the
    dense/fused path where brute force beats probing.  Clustered
    families are removed from the prep's dense index sets.
    """
    from wasm_pathtracer_tpu.models.scene import PrimType
    from wasm_pathtracer_tpu.ops import cluster as cl

    fam_attr = {
        int(PrimType.SPHERE): "idx_sphere",
        int(PrimType.TRIANGLE): "idx_triangle",
        int(PrimType.TORUS): "idx_torus",
        int(PrimType.AARECT): "idx_aarect",
        int(PrimType.SQUARE): "idx_square",
    }
    if families is None:
        families = [f for f, a in fam_attr.items()
                    if getattr(prep, a).shape[0] >= min_count]
    families = [int(f) for f in families
                if getattr(prep, fam_attr[int(f)]).shape[0] > 0]
    if not families:
        return prep

    ids = np.concatenate([np.asarray(getattr(prep, fam_attr[f]))
                          for f in sorted(families)])
    light_sids = np.asarray(scene.light_shape)
    kept_dense = {}
    if exclude_lights and light_sids.size:
        # Keep emissive shapes OUT of the baked structure: the dense
        # remainder reads scene.params live, so light-GEOMETRY training
        # (``parallel.shard.make_train_step(train_lights=True)``) stays
        # exact — moved lights are traced at their updated rows and
        # their gradients flow through the live dense gathers, while
        # the frozen mesh keeps its baked blocks.  Mirrors the
        # reference's bunny scene, where the two light triangles are
        # ordinary scene shapes beside the mesh (``scenes.rs:71-111``).
        is_light = np.isin(ids, light_sids)
        for f in families:
            fam_ids = np.asarray(getattr(prep, fam_attr[f]))
            kept = fam_ids[np.isin(fam_ids, light_sids)]
            kept_dense[fam_attr[f]] = jnp.asarray(kept.astype(np.int32))
        ids = ids[~is_light]
        if ids.size == 0:
            return prep
    params = np.asarray(scene.params)
    ptypes = np.asarray(scene.ptype)[ids]
    rows = params[ids][:, :9].astype(np.float32)
    lo, hi = cl.prim_aabbs(rows, ptypes)

    try:
        from wasm_pathtracer_tpu.ops import bvh_native
        _, _, order = bvh_native.build(lo, hi, num_bins)
    except Exception:
        _, _, order = build(lo, hi, num_bins)

    prim_index = ids[order].astype(np.int32)
    cs = cl.build_clusters(rows[order], ptypes[order], prim_index,
                           group or cl.CLUSTER_SIZE)
    baked_lights = bool(light_sids.size and
                        np.isin(light_sids, prim_index).any())
    cs = dataclasses.replace(cs, has_baked_lights=baked_lights)
    empty = jnp.zeros((0,), jnp.int32)
    repl = {fam_attr[f]: kept_dense.get(fam_attr[f], empty)
            for f in families}
    return dataclasses.replace(prep, cluster=cs, **repl)
