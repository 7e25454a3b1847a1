"""g2o-format 2D pose-graph IO and the Manhattan-world generator.

Port of ``ndtpu/data/g2o.py``: parsing, writing and generation are host
numpy, as in the reference, and ``manhattan_world`` draws from its
generator in the same order, so its arrays equal the reference's for the
same arguments. ``to_graph`` builds the port's ``PoseGraph`` (a prior on
pose 0, sqrt-information ``cholesky(info).T``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

__all__ = ["PoseGraphData", "read_g2o", "read_toro", "write_g2o",
           "manhattan_world", "to_graph"]


class PoseGraphData(NamedTuple):
    """Host-side pose-graph arrays (numpy)."""

    poses: np.ndarray      # [V, 3] initial estimates
    edges_ij: np.ndarray   # [E, 2] int
    edges_z: np.ndarray    # [E, 3]
    edges_info: np.ndarray  # [E, 3, 3] information matrices


def _assemble(path, verts, edges) -> PoseGraphData:
    if not verts:
        raise ValueError(f"no vertex lines parsed from {path!r}")
    if not edges:
        raise ValueError(f"no edge lines parsed from {path!r}")
    n = max(verts) + 1
    poses = np.zeros((n, 3))
    for k, v in verts.items():
        poses[k] = v
    ij = np.array([[e[0], e[1]] for e in edges], np.int32)
    zz = np.array([e[2] for e in edges])
    ii = np.stack([e[3] for e in edges])
    return PoseGraphData(poses=poses, edges_ij=ij, edges_z=zz, edges_info=ii)


def _read(path: str, vertex: str, edge: str, info_of) -> PoseGraphData:
    verts, edges = {}, []
    with open(path) as f:
        for line in f:
            tok = line.split()
            if not tok:
                continue
            if tok[0] == vertex:
                verts[int(tok[1])] = [float(tok[2]), float(tok[3]),
                                      float(tok[4])]
            elif tok[0] == edge:
                z = [float(tok[3]), float(tok[4]), float(tok[5])]
                u = [float(t) for t in tok[6:12]]
                edges.append((int(tok[1]), int(tok[2]), z, info_of(u)))
    return _assemble(path, verts, edges)


def read_g2o(path: str) -> PoseGraphData:
    """Parse VERTEX_SE2 / EDGE_SE2 lines (the standard 2D g2o dialect; the
    six information entries are the upper triangle by rows)."""
    return _read(path, "VERTEX_SE2", "EDGE_SE2",
                 lambda u: np.array([[u[0], u[1], u[2]],
                                     [u[1], u[3], u[4]],
                                     [u[2], u[4], u[5]]]))


def read_toro(path: str) -> PoseGraphData:
    """Parse TORO 2D graphs (``VERTEX2`` / ``EDGE2`` lines), whose six
    information entries are ordered ``I00 I01 I11 I22 I02 I12``."""
    return _read(path, "VERTEX2", "EDGE2",
                 lambda u: np.array([[u[0], u[1], u[4]],
                                     [u[1], u[2], u[5]],
                                     [u[4], u[5], u[3]]]))


def write_g2o(path: str, data: PoseGraphData) -> None:
    with open(path, "w") as f:
        for k, p in enumerate(data.poses):
            f.write(f"VERTEX_SE2 {k} {p[0]:.9g} {p[1]:.9g} {p[2]:.9g}\n")
        for (i, j), z, info in zip(data.edges_ij, data.edges_z,
                                   data.edges_info):
            u = [info[0, 0], info[0, 1], info[0, 2],
                 info[1, 1], info[1, 2], info[2, 2]]
            f.write(f"EDGE_SE2 {i} {j} {z[0]:.9g} {z[1]:.9g} {z[2]:.9g} "
                    + " ".join(f"{x:.9g}" for x in u) + "\n")


def _wrap(t):
    return (t + np.pi) % (2 * np.pi) - np.pi


def _compose_np(a, b):
    c, s = np.cos(a[2]), np.sin(a[2])
    return np.array([a[0] + c * b[0] - s * b[1],
                     a[1] + s * b[0] + c * b[1],
                     _wrap(a[2] + b[2])])


def _between_np(a, b):
    c, s = np.cos(a[2]), np.sin(a[2])
    dx, dy = b[0] - a[0], b[1] - a[1]
    return np.array([c * dx + s * dy, -s * dx + c * dy, _wrap(b[2] - a[2])])


def _noisy(rng, z, trans_noise, rot_noise):
    z = z + np.concatenate([rng.normal(0, trans_noise, 2),
                            rng.normal(0, rot_noise, 1)])
    z[2] = _wrap(z[2])
    return z


def manhattan_world(n_poses: int, seed: int = 0, step: float = 1.0,
                    trans_noise: float = 0.05, rot_noise: float = 0.01,
                    loop_prob: float = 0.1, loop_radius: float = 2.0,
                    min_gap: int = 20) -> PoseGraphData:
    """Olson-style Manhattan world: a grid random walk (mostly straight,
    +-90 degree turns) with noisy odometry edges and proximity loop
    closures. Returns the dead-reckoned (noisy) initial poses."""
    rng = np.random.default_rng(seed)
    gt = np.zeros((n_poses, 3))
    for t in range(1, n_poses):
        turn = rng.choice([0.0, np.pi / 2, -np.pi / 2], p=[0.8, 0.1, 0.1])
        gt[t] = _compose_np(gt[t - 1], np.array([step, 0.0, turn]))

    info = np.diag([1.0 / trans_noise**2, 1.0 / trans_noise**2,
                    1.0 / rot_noise**2])
    edges = []
    est = np.zeros_like(gt)
    for t in range(1, n_poses):
        z = _noisy(rng, _between_np(gt[t - 1], gt[t]), trans_noise,
                   rot_noise)
        edges.append((t - 1, t, z))
        est[t] = _compose_np(est[t - 1], z)

    xy = gt[:, :2]
    for t in range(min_gap, n_poses):
        if rng.random() > loop_prob:
            continue
        d = np.linalg.norm(xy[: t - min_gap] - xy[t], axis=1)
        close = np.nonzero(d < loop_radius)[0]
        if close.size == 0:
            continue
        j = int(rng.choice(close))
        edges.append((j, t, _noisy(rng, _between_np(gt[j], gt[t]),
                                   trans_noise, rot_noise)))

    ij = np.array([[e[0], e[1]] for e in edges], np.int32)
    zz = np.array([e[2] for e in edges])
    ii = np.broadcast_to(info, (len(edges), 3, 3)).copy()
    return PoseGraphData(poses=est, edges_ij=ij, edges_z=zz, edges_info=ii)


def to_graph(data: PoseGraphData, dtype=torch.float32, device="cpu",
             prior_on_first: bool = True):
    """The port's ``PoseGraph`` of exact capacity from host arrays, with a
    prior (sqrt-information 100 I) on pose 0."""
    from ndtpu_torch.graph import factors as fct

    v = data.poses.shape[0]
    e = data.edges_ij.shape[0]
    sqrt_infos = np.linalg.cholesky(data.edges_info).transpose(0, 2, 1)
    f = dict(dtype=dtype, device=device)
    i = dict(dtype=torch.long, device=device)
    g = fct.empty_graph(v, 1, e, dtype, device)._replace(
        poses=torch.as_tensor(data.poses, **f),
        pose_mask=torch.ones(v, dtype=torch.bool, device=device),
        bet_i=torch.as_tensor(data.edges_ij[:, 0], **i),
        bet_j=torch.as_tensor(data.edges_ij[:, 1], **i),
        bet_z=torch.as_tensor(data.edges_z, **f),
        bet_sqrt_info=torch.as_tensor(np.ascontiguousarray(sqrt_infos), **f),
        bet_mask=torch.ones(e, dtype=torch.bool, device=device),
        n_poses=torch.tensor(v, **i), n_between=torch.tensor(e, **i))
    if prior_on_first:
        g = fct.add_prior(g, 0, torch.as_tensor(data.poses[0], **f),
                          torch.diag(torch.full((3,), 100.0, **f)))
    return g
