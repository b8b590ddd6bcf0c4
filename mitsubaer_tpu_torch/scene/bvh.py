"""Flattened BVH for triangle meshes (port of mitsubaer_tpu/scene/bvh.py).

The tree is built on the host in numpy (a median split on the centroids'
widest axis), flattened depth first with skip links, and traversed without
a stack: every lane carries one node cursor; a box hit on an interior node
moves to node + 1 (its left subtree), anything else follows the skip link.
A leaf holds up to LEAF_MAX triangles packed in one row each
([v0, e1, e2, pad]). The build is the JAX package's, so the arrays are
equal to its own.

`intersect_bvh` drives that traversal from the host, one trip of every
lane a loop iteration with a sync to count the lanes that still walk;
lanes that finished are dropped from the working set once they are half of
it (each lane's walk is its own, so that changes no result).
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils import stats
from .types import Bvh

LEAF_MAX = 4
INF = 3.0e38


def build_bvh(v0: np.ndarray, e1: np.ndarray, e2: np.ndarray) -> Bvh:
    """Median-split build over T triangles; returns the flat arrays."""
    v0 = np.asarray(v0, np.float32)
    e1 = np.asarray(e1, np.float32)
    e2 = np.asarray(e2, np.float32)
    T = v0.shape[0]
    p1 = v0 + e1
    p2 = v0 + e2
    tmin = np.minimum(np.minimum(v0, p1), p2)
    tmax = np.maximum(np.maximum(v0, p1), p2)
    cent = 0.5 * (tmin + tmax)

    order = []           # packed triangle order
    nodes = []           # [min3, max3, skip, leaf_first (0=interior), count]
    _emit(np.arange(T), tmin, tmax, cent, nodes, order)

    N = len(nodes)
    arr = np.asarray(nodes, np.float64)
    counts = arr[:, 8].astype(np.int32)
    skips = _subtree_spans(counts)
    nodes_f = np.zeros((N, 8), np.float32)
    nodes_f[:, :6] = arr[:, :6].astype(np.float32)
    nodes_f[:, 6] = skips.astype(np.int32).view(np.float32)
    nodes_f[:, 7] = arr[:, 7].astype(np.int32).view(np.float32)

    order = np.asarray(order, np.int32)
    tris = np.zeros((max(T, 1), 12), np.float32)
    tris[:T, 0:3] = v0[order]
    tris[:T, 3:6] = e1[order]
    tris[:T, 6:9] = e2[order]
    return Bvh(nodes=torch.from_numpy(nodes_f),
               counts=torch.from_numpy(counts),
               tris=torch.from_numpy(tris), tri_id=torch.from_numpy(order))


def _emit(all_idx, tmin, tmax, cent, nodes, order):
    """Depth-first emission with an explicit stack."""
    stack = [all_idx]
    while stack:
        idx = stack.pop()
        nid = len(nodes)
        bmin = tmin[idx].min(axis=0)
        bmax = tmax[idx].max(axis=0)
        nodes.append([*bmin, *bmax, -1, 0, len(idx) if len(idx) <= LEAF_MAX
                      else 0])
        if len(idx) <= LEAF_MAX:
            nodes[nid][7] = len(order) + 1
            order.extend(idx.tolist())
            continue
        axis = int(np.argmax(bmax - bmin))
        mid = np.argsort(cent[idx, axis], kind="stable")
        half = len(idx) // 2
        # push right first so the left child lands at nid + 1
        stack.append(idx[mid[half:]])
        stack.append(idx[mid[:half]])


def _subtree_spans(counts):
    """End of each node's subtree (its skip link) in the depth-first
    layout: a leaf's span is i + 1."""
    N = counts.shape[0]
    spans = np.full((N,), N, np.int32)
    st = []  # (node id, children still open)
    for i in range(N):
        if counts[i] > 0:
            spans[i] = i + 1
            j = i + 1
            while st:
                node, remaining = st[-1]
                remaining -= 1
                st[-1] = (node, remaining)
                if remaining == 0:
                    spans[node] = j
                    st.pop()
                else:
                    break
        else:
            st.append((i, 2))
    return spans


def _trip(bvh: Bvh, o, d, inv_d, t_min, t_max, node, t_best, prim, uu, vv):
    """One traversal step of every lane given (bvh.py:130-176)."""
    NN = bvh.nodes.shape[0]
    Tt = bvh.tris.shape[0]
    nc = torch.clamp(node, 0, NN - 1)
    row = bvh.nodes[nc]                                   # (n, 8)
    cnt = bvh.counts[nc]
    bits = row[:, 6:8].contiguous().view(torch.int32)
    skip = bits[:, 0].to(torch.int64)
    first = bits[:, 1].to(torch.int64) - 1
    active = node < NN
    t0 = (row[:, 0:3] - o) * inv_d
    t1 = (row[:, 3:6] - o) * inv_d
    tn = torch.amax(torch.minimum(t0, t1), dim=-1)
    tf = torch.amin(torch.maximum(t0, t1), dim=-1)
    lim = torch.minimum(t_max, t_best)
    hit_box = active & (tn <= tf) & (tf >= t_min) & (tn <= lim)
    is_leaf = cnt > 0
    do_leaf = hit_box & is_leaf
    dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]
    for i in range(LEAF_MAX):
        pi = torch.clamp(first + i, 0, Tt - 1)
        tri = bvh.tris[pi]                                 # (n, 12)
        e1x, e1y, e1z = tri[:, 3], tri[:, 4], tri[:, 5]
        e2x, e2y, e2z = tri[:, 6], tri[:, 7], tri[:, 8]
        px = dy * e2z - dz * e2y
        py = dz * e2x - dx * e2z
        pz = dx * e2y - dy * e2x
        det = px * e1x + py * e1y + pz * e1z
        ok_det = torch.abs(det) > 1e-12
        inv_det = torch.where(ok_det, 1.0 / torch.where(ok_det, det, 1.0),
                              0.0)
        tx = o[:, 0] - tri[:, 0]
        ty = o[:, 1] - tri[:, 1]
        tz = o[:, 2] - tri[:, 2]
        u = (tx * px + ty * py + tz * pz) * inv_det
        qx = ty * e1z - tz * e1y
        qy = tz * e1x - tx * e1z
        qz = tx * e1y - ty * e1x
        v = (dx * qx + dy * qy + dz * qz) * inv_det
        t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
        ok = (do_leaf & (i < cnt) & ok_det & (u >= 0) & (v >= 0)
              & (u + v <= 1.0) & (t >= t_min) & (t <= t_max) & (t < t_best))
        t_best = torch.where(ok, t, t_best)
        prim = torch.where(ok, pi, prim)
        uu = torch.where(ok, u, uu)
        vv = torch.where(ok, v, vv)
    nxt = torch.where(hit_box & ~is_leaf, node + 1, skip)
    return torch.where(active, nxt, node), t_best, prim, uu, vv


def intersect_bvh(bvh: Bvh, o, d, t_min, t_max):
    """Closest hit over the BVH for (n, 3) rays and (n,) t ranges: returns
    (t, packed_prim, u, v) with t = INF on a miss; packed_prim indexes
    bvh.tri_id. The walk is the span "bvh.walk", which counts its "trips"
    (loop iterations) and "lane_trips" (lanes stepped, summed over the
    trips). Each trip reads the walking lanes' count (host read
    "bvh.walk"); where at most half the lanes still walk, the finished and
    the walking lanes' indices are read (two host reads "bvh.compact") and
    the walk goes on with the walking ones."""
    n = o.shape[0]
    dev = o.device
    NN = bvh.nodes.shape[0]
    tiny = torch.where(d >= 0, 1e-20, -1e-20)
    inv_d = 1.0 / torch.where(torch.abs(d) < 1e-20, tiny, d)
    t_out = torch.full((n,), INF, device=dev)
    prim_out = torch.zeros((n,), dtype=torch.int64, device=dev)
    u_out = torch.zeros((n,), device=dev)
    v_out = torch.zeros((n,), device=dev)
    lanes = torch.arange(n, device=dev)
    st = (o, d, inv_d, t_min, t_max)
    node = torch.zeros((n,), dtype=torch.int64, device=dev)
    best = (t_out.clone(), prim_out.clone(), u_out.clone(), v_out.clone())
    trips = lane_trips = 0
    with stats.span("bvh.walk") as sp:
        while lanes.numel() > 0:
            node, *best = _trip(bvh, *st, node, *best)
            trips += 1
            lane_trips += lanes.numel()
            walking = node < NN
            n_walk = stats.host_read("bvh.walk", stats.count_of, walking)
            if 2 * n_walk > lanes.numel():
                continue
            gone = stats.host_read("bvh.compact", stats.indices_of, ~walking)
            keep = stats.host_read("bvh.compact", stats.indices_of, walking)
            idx = lanes[gone]
            t_out[idx], prim_out[idx], u_out[idx], v_out[idx] = (
                b[gone] for b in best)
            lanes = lanes[keep]
            st = tuple(a[keep] for a in st)
            node = node[keep]
            best = [b[keep] for b in best]
        sp.add(trips=trips, lane_trips=lane_trips)
    return t_out, prim_out, u_out, v_out

