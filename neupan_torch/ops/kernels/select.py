"""Exact-distance top-k selection: two kernels over one ranking.

``neupan_torch/csrc/select.cu`` holds both, sharing the device code of
``csrc/select.cuh`` as the two TPU kernels share ``_rank_and_extract``:

* ``select_topk_flow`` replaces ``neupan_tpu/ops/pallas/select.py:
  select_topk_flow_pallas`` (``_select_flow_kernel``): the point flow is
  built in the kernel from the raw points, velocities and frame transforms.
* ``select_topk`` replaces ``select_topk_pallas`` (``_select_kernel``): the
  same ranking on a point flow that is already in device memory.

What both compute, per scenario and horizon frame t, from the robot-frame
coordinates of every point (``R_t'(p + t dt v - trans_t)``): a sqrt-free
ranking key (squared distance to the nearest polygon edge segment outside,
the largest normalized face margin inside, 1e9 for masked points), which
orders points exactly like the signed polygon distance; and the K smallest
keys with their indices, ties to the lower index as ``lax.top_k``.

Bounds on the H100. ``select_topk_flow``: operations. Per point and frame
the key is ~90 float operations (flow ~10, four edges ~56, four faces ~16,
K=10 compares in the extraction), against 17 bytes of input per point that
every frame shares: at B=512, P=2048, T+1=11 that is ~1 GFLOP against
~18 MB. ``select_topk``: bytes, narrowly. It reads 8 bytes per point and
frame (~92 MB at the same shape, 0.028 ms at the card's memory rate)
against ~80 operations (~0.9 GFLOP, 0.014 ms). The key's products and sums
stay unfused (an FMA could flip a near-tie), so the card issues them at
half its FMA rate: the flow kernel's floor is about twice its bound.

Design (``csrc/select.cu``, ``select.cuh``): 256-thread blocks, each
ranking the frames of one scenario; thread t owns points t + 256 i.

* Keys: in registers, 1 per thread up to P = 256 (faster than 8 at the
  facade's B=1, P=100; ``PERF.md`` section 6) and 8 up to P = 2048, in
  shared memory above (up to ``SMEM_LIMIT / 4`` points). The polygon's 32 numbers
  sit in registers for the four-sided robots (V = E = 4); any other
  polygon is read through the read-only cache. The flow kernel builds each
  point's coordinates in registers, so the point flow never reaches device
  memory; the materialized kernel streams its frame's two rows once.
* Extraction: each thread keeps the best (key, index) of its own points,
  the float key mapped to an unsigned int of the same order. A round is
  two ``__reduce_min_sync`` per warp (the smallest key, then the lowest
  index holding it), the 8 warp winners into a double-buffered shared slot
  with one barrier, and the same two reductions over the 8 in every warp:
  no serial thread, no second barrier. Only the thread that owned the
  winner refills it with 1e9 and finds its best again, by a tree over its
  8 keys.
* Frames per block: the flow kernel ranks two frames of a scenario per
  block from about two waves of blocks on (B=512 at T+1=11): each point is
  loaded once for both, and one round's latency yields both frames'
  winners. At a small batch (the facade's B=1) one frame per block keeps
  twice the blocks in flight; the materialized kernel always ranks one.

The key arithmetic uses round-to-nearest intrinsics in the reference's
expression order, so the kernels and the plain versions below agree bit
for bit and select identical indices. The transform table and the
per-edge reciprocals are computed here in correctly rounded float32, as
the TPU wrappers do.
"""

from __future__ import annotations

import torch

from neupan_torch.ops.kernels import _build

_INF = 1e9


def flow_tables(R_all: torch.Tensor, trans: torch.Tensor, dt: float,
                vertices: torch.Tensor, G: torch.Tensor, h: torch.Tensor):
    """Per-frame transforms and polygon tables fed to the kernel.

    Returns tf (B, 5, T+1) rows [c, s, tx, ty, step], verts (2, V),
    edges (3, V) rows [ex, ey, 1/|e|^2], Gn (E, 2), hn (E, 1).
    """
    B, Tp1 = R_all.shape[:2]
    steps = torch.arange(Tp1, dtype=torch.float32, device=R_all.device) * dt
    tf = torch.stack([R_all[:, :, 0, 0], R_all[:, :, 1, 0], trans[:, :, 0],
                      trans[:, :, 1], steps.expand(B, Tp1)], dim=1)
    return (tf, *polygon_tables(vertices, G, h))


def polygon_tables(vertices: torch.Tensor, G: torch.Tensor, h: torch.Tensor):
    """The polygon as the kernels read it: verts (2, V), edges (3, V) rows
    [ex, ey, 1/|e|^2], Gn (E, 2) and hn (E, 1) normalized by |G_e|."""
    verts = vertices.contiguous()
    e_xy = torch.roll(verts, -1, dims=1) - verts
    inv_ee = 1.0 / torch.clamp(torch.sum(e_xy * e_xy, dim=0), min=1e-12)
    edges = torch.cat([e_xy, inv_ee[None, :]], dim=0)
    g_norm = torch.sqrt(torch.sum(G * G, dim=1, keepdim=True))
    return verts, edges, (G / g_norm).contiguous(), (h / g_norm).contiguous()


def _check_inputs(points, velocities, mask, R_all, trans, vertices, G, h, k):
    dev = _build.dispatch_device(points)
    B, _, P = points.shape if points.dim() == 3 else (None, None, None)
    if B is None or B < 1 or P < 1:
        raise ValueError(f"points must be (B>=1, 2, P>=1), got {tuple(points.shape)}")
    Tp1 = R_all.shape[1]
    _build.check(points, "points", (B, 2, P), device=dev)
    _build.check(velocities, "velocities", (B, 2, P), device=dev)
    _build.check(mask, "mask", (B, P), dtype=torch.bool, device=dev)
    # the tables are built from these in PyTorch, so any strides will do
    V = vertices.shape[-1]
    E = G.shape[0]
    for name, t, shape in (("R_all", R_all, (B, Tp1, 2, 2)), ("trans", trans, (B, Tp1, 2)),
                           ("vertices", vertices, (2, V)), ("G", G, (E, 2)), ("h", h, (E, 1))):
        _build.check(t, name, shape, device=dev, contiguous=False)
    if not 1 <= k <= P:
        raise ValueError(f"k must be in [1, P={P}], got {k}")
    if P * 4 > _build.SMEM_LIMIT:
        raise ValueError(f"P={P} keys do not fit in one block's shared memory")
    return dev, B, Tp1, P, V, E


def flow_from_tables(points, velocities, tf):
    """Robot-frame coordinates x, y (B, T+1, P) of every point in every
    frame, in the flow kernel's expression order (each operation rounded)."""
    px, py = points[:, 0:1, :], points[:, 1:2, :]          # (B, 1, P)
    vx, vy = velocities[:, 0:1, :], velocities[:, 1:2, :]
    c, s = tf[:, 0, :, None], tf[:, 1, :, None]            # (B, T+1, 1)
    tx, ty, step = tf[:, 2, :, None], tf[:, 3, :, None], tf[:, 4, :, None]
    dx = (px + step * vx) - tx
    dy = (py + step * vy) - ty
    return c * dx + s * dy, c * dy - s * dx


def select_from_tables_plain(points, velocities, mask, tf, verts, edges, Gn, hn, k):
    """The same function as ``select_from_tables`` in plain PyTorch."""
    x, y = flow_from_tables(points, velocities, tf)
    return _rank_and_extract_plain(x, y, mask, verts, edges, Gn, hn, k)


def _rank_and_extract_plain(x, y, mask, verts, edges, Gn, hn, k):
    """Ranking key of robot-frame coordinates x, y (B, T+1, P) and the k
    smallest per frame, in the kernels' expression order."""
    d_out_sq = torch.full_like(x, _INF)
    for j in range(verts.shape[1]):
        ax, ay = verts[0, j], verts[1, j]
        ex, ey, inv_ee = edges[0, j], edges[1, j], edges[2, j]
        t = torch.clamp(((x - ax) * ex + (y - ay) * ey) * inv_ee, 0.0, 1.0)
        ddx = x - (ax + ex * t)
        ddy = y - (ay + ey * t)
        d_out_sq = torch.minimum(d_out_sq, ddx * ddx + ddy * ddy)
    d_in = torch.full_like(x, -_INF)
    for e in range(Gn.shape[0]):
        d_in = torch.maximum(d_in, Gn[e, 0] * x + Gn[e, 1] * y - hn[e, 0])
    key = torch.where(d_in <= 0.0, d_in, d_out_sq)
    key = torch.where(mask[:, None, :], key, torch.full_like(key, _INF))

    keys, idxs = [], []
    for _ in range(k):
        am = torch.argmin(key, dim=-1, keepdim=True)         # first minimum
        keys.append(torch.gather(key, -1, am))
        idxs.append(am)
        key = key.scatter(-1, am, _INF)                      # winner leaves the race
    return torch.cat(keys, dim=-1), torch.cat(idxs, dim=-1).to(torch.int32)


def select_topk_flow_plain(points, velocities, mask, R_all, trans, dt, vertices, G, h, k):
    """The same function as ``select_topk_flow`` in plain PyTorch."""
    _check_inputs(points, velocities, mask, R_all, trans, vertices, G, h, k)
    tables = flow_tables(R_all, trans, dt, vertices, G, h)
    return select_from_tables_plain(points, velocities, mask, *tables, k)


def select_topk_flow(points: torch.Tensor, velocities: torch.Tensor,
                     mask: torch.Tensor, R_all: torch.Tensor, trans: torch.Tensor,
                     dt: float, vertices: torch.Tensor, G: torch.Tensor,
                     h: torch.Tensor, k: int):
    """Exact-distance-ranked top-k of every horizon frame, batched.

    Args:
        points, velocities: (B, 2, P) float32 world-frame points and
            velocities; mask: (B, P) bool.
        R_all: (B, T+1, 2, 2) world-from-robot rotations; trans: (B, T+1, 2).
        dt: step time (frame t advances points by t*dt*velocity).
        vertices (2, V), G (E, 2), h (E, 1): the robot polygon.
        k: points kept per frame.
    Returns:
        keys (B, T+1, k) float32 ascending ranking keys (1e9 marks a masked
        slot) and idx (B, T+1, k) int32 indices into P.
    """
    _check_inputs(points, velocities, mask, R_all, trans, vertices, G, h, k)
    tables = flow_tables(R_all, trans, dt, vertices, G, h)
    return select_from_tables(points, velocities, mask, *tables, k)


def select_from_tables(points, velocities, mask, tf, verts, edges, Gn, hn, k):
    """The kernel alone, on checked inputs and the tables of ``flow_tables``."""
    dev = _build.dispatch_device(points)
    if dev.type == "cpu":
        return select_from_tables_plain(points, velocities, mask, tf, verts, edges, Gn, hn, k)
    (B, _, P), Tp1, V, E = points.shape, tf.shape[-1], verts.shape[-1], Gn.shape[0]
    keys = torch.empty((B, Tp1, k), dtype=torch.float32, device=dev)
    idx = torch.empty((B, Tp1, k), dtype=torch.int32, device=dev)
    P_, I_ = _build.PTR, _build.INT
    fn = _build.function("select_topk_flow_launch", [P_] * 10 + [I_] * 6 + [P_])
    _build.launch(fn, dev, _build.ptr(points), _build.ptr(velocities),
                  _build.ptr(mask), *(_build.ptr(t) for t in (tf, verts, edges, Gn, hn)),
                  _build.ptr(keys), _build.ptr(idx), B, Tp1, P, V, E, k)
    select_topk_flow.launches += 1
    return keys, idx


select_topk_flow.launches = 0


# -- the same ranking on a point flow that is already in memory ------------------

def _check_flow_inputs(point_flow, mask, vertices, G, h, k):
    dev = _build.dispatch_device(point_flow)
    if point_flow.dim() != 4 or min(point_flow.shape) < 1 or point_flow.shape[2] != 2:
        raise ValueError(
            f"point_flow must be (B>=1, T+1>=1, 2, P>=1), got {tuple(point_flow.shape)}")
    B, Tp1, _, P = point_flow.shape
    _build.check(point_flow, "point_flow", (B, Tp1, 2, P), device=dev)
    _build.check(mask, "mask", (B, P), dtype=torch.bool, device=dev)
    V, E = vertices.shape[-1], G.shape[0]
    for name, t, shape in (("vertices", vertices, (2, V)), ("G", G, (E, 2)), ("h", h, (E, 1))):
        _build.check(t, name, shape, device=dev, contiguous=False)
    if not 1 <= k <= P:
        raise ValueError(f"k must be in [1, P={P}], got {k}")
    if P * 4 > _build.SMEM_LIMIT:
        raise ValueError(f"P={P} keys do not fit in one block's shared memory")


def select_topk_from_tables_plain(point_flow, mask, verts, edges, Gn, hn, k):
    """The same function as ``select_topk_from_tables`` in plain PyTorch."""
    return _rank_and_extract_plain(point_flow[:, :, 0, :], point_flow[:, :, 1, :], mask,
                                   verts, edges, Gn, hn, k)


def select_topk_plain(point_flow, mask, vertices, G, h, k):
    """The same function as ``select_topk`` in plain PyTorch."""
    _check_flow_inputs(point_flow, mask, vertices, G, h, k)
    return select_topk_from_tables_plain(point_flow, mask, *polygon_tables(vertices, G, h), k)


def select_topk(point_flow: torch.Tensor, mask: torch.Tensor, vertices: torch.Tensor,
                G: torch.Tensor, h: torch.Tensor, k: int):
    """Exact-distance-ranked top-k of every frame of a materialized point flow.

    Args:
        point_flow: (B, T+1, 2, P) float32 robot-frame points of each frame;
            mask: (B, P) bool.
        vertices (2, V), G (E, 2), h (E, 1): the robot polygon.
        k: points kept per frame.
    Returns:
        keys (B, T+1, k) float32 ascending ranking keys (1e9 marks a masked
        slot) and idx (B, T+1, k) int32 indices into P: what
        ``select_topk_flow`` returns for the points and transforms that
        this flow was built from.
    """
    _check_flow_inputs(point_flow, mask, vertices, G, h, k)
    return select_topk_from_tables(point_flow, mask, *polygon_tables(vertices, G, h), k)


def select_topk_from_tables(point_flow, mask, verts, edges, Gn, hn, k):
    """The kernel alone, on checked inputs and the tables of ``polygon_tables``."""
    dev = _build.dispatch_device(point_flow)
    if dev.type == "cpu":
        return select_topk_from_tables_plain(point_flow, mask, verts, edges, Gn, hn, k)
    (B, Tp1, _, P), V, E = point_flow.shape, verts.shape[-1], Gn.shape[0]
    keys = torch.empty((B, Tp1, k), dtype=torch.float32, device=dev)
    idx = torch.empty((B, Tp1, k), dtype=torch.int32, device=dev)
    P_, I_ = _build.PTR, _build.INT
    fn = _build.function("select_topk_launch", [P_] * 8 + [I_] * 6 + [P_])
    _build.launch(fn, dev, _build.ptr(point_flow), _build.ptr(mask),
                  *(_build.ptr(t) for t in (verts, edges, Gn, hn)),
                  _build.ptr(keys), _build.ptr(idx), B, Tp1, P, V, E, k)
    select_topk.launches += 1
    return keys, idx


select_topk.launches = 0
