"""CARMEN 2D lidar log parser (Intel Research Lab / MIT Killian format).

Copy of ``ndtpu/data/carmen.py`` (numpy only): ``read_carmen`` parses
``FLASER`` and ``ROBOTLASER1`` lines into padded ``[T, N]`` range arrays
plus odometry, ``write_carmen`` writes them (also to export synthetic
sequences in the reference's input format), and ``to_sequence`` turns a
log into the pipeline's ``(points, mask, odom)`` numpy inputs. The native
scanner (``ndtpu_torch.native.parse_carmen_native``) parses the same
semantics faster; :func:`read_log` takes it where it builds.

Formats (CARMEN logger docs):

  FLASER num_readings r_1 .. r_n x y theta odom_x odom_y odom_theta
         timestamp hostname logger_timestamp

  ROBOTLASER1 laser_type start_angle fov angular_resolution max_range
         accuracy remission_mode num_readings r_1 .. r_n
         num_remissions rem_1 .. rem_m
         laser_x laser_y laser_theta robot_x robot_y robot_theta
         laser_tv laser_rv forward_safety_dist side_safety_dist turn_axis
         timestamp hostname logger_timestamp

Malformed lines are skipped (with a warning at the end).
"""

from __future__ import annotations

import math
import warnings
from typing import NamedTuple

import numpy as np

__all__ = ["CarmenLog", "read_carmen", "read_log", "write_carmen",
           "to_sequence"]


class CarmenLog(NamedTuple):
    """Raw parsed log: ranges padded to the max beam count.

    ``start_angle`` / ``fov`` / ``log_max_range`` come from the first
    ROBOTLASER1 line's metadata; NaN when the log only has FLASER lines
    (whose SICK convention is a 180-degree sweep centered on the heading —
    :func:`to_sequence` applies that default).
    """

    ranges: np.ndarray     # [T, N] float32 (padded with max_range sentinel)
    n_beams: np.ndarray    # [T] int32 true beam count per scan
    laser_pose: np.ndarray  # [T, 3] laser pose from the log (x, y, theta)
    odom_pose: np.ndarray  # [T, 3] raw odometry pose
    timestamps: np.ndarray  # [T] float64
    start_angle: float = math.nan   # radians (ROBOTLASER1 metadata)
    fov: float = math.nan           # radians
    log_max_range: float = math.nan  # meters


def _parse_flaser(tok):
    n = int(tok[1])
    r = np.asarray([float(t) for t in tok[2: 2 + n]], np.float32)
    if len(r) != n:
        raise ValueError("truncated FLASER readings")
    rest = tok[2 + n:]
    lp = [float(x) for x in rest[0:3]]
    op = [float(x) for x in rest[3:6]]
    ts = 0.0
    if len(rest) > 6:
        try:
            ts = float(rest[6])
        except ValueError:
            pass
    return n, r, lp, op, ts, None


def _parse_robotlaser(tok):
    meta = (float(tok[2]), float(tok[3]), float(tok[5]))  # start, fov, maxr
    n = int(tok[8])
    r = np.asarray([float(t) for t in tok[9: 9 + n]], np.float32)
    if len(r) != n:
        raise ValueError("truncated ROBOTLASER1 readings")
    k = 9 + n
    # Remission block: the next token is an integer count in the standard
    # dialect; some writers omit the block entirely, in which case the next
    # token is the (float) laser pose. An integer-parseable token alone is
    # ambiguous (a writer printing laser_x as "0" would shift every pose
    # field — ADVICE r3), so disambiguate by total token count: a standard
    # line carries exactly 6 pose + 8 trailer = 14 tokens after the block.
    n_rem = None
    try:
        cand = int(tok[k])
    except ValueError:
        cand = None
    if cand is not None and cand >= 0:
        if len(tok) == k + 1 + cand + 14:
            n_rem = cand                  # standard: counts line up exactly
        elif len(tok) == k + 14:
            n_rem = None                  # integer-formatted laser_x, no block
        elif len(tok) >= k + 1 + cand + 6:
            n_rem = cand                  # tolerant: nonstandard trailer
    if n_rem is not None:
        k += 1 + n_rem
    lp = [float(x) for x in tok[k: k + 3]]
    op = [float(x) for x in tok[k + 3: k + 6]]
    if len(lp) != 3 or len(op) != 3:
        raise ValueError("truncated ROBOTLASER1 poses")
    # Trailer: tv rv forward_safety side_safety turn_axis timestamp host ...
    ts = 0.0
    if len(tok) > k + 11:
        try:
            ts = float(tok[k + 11])
        except ValueError:
            pass
    return n, r, lp, op, ts, meta


def read_carmen(path: str, max_range: float = 81.9) -> CarmenLog:
    """Parse FLASER/ROBOTLASER1 lines from a CARMEN log file."""
    ranges_l, nb_l, lp_l, op_l, ts_l = [], [], [], [], []
    meta = None
    n_bad = 0
    with open(path) as f:
        for line in f:
            tok = line.split()
            if not tok or tok[0] not in ("FLASER", "ROBOTLASER1"):
                continue
            try:
                if tok[0] == "FLASER":
                    n, r, lp, op, ts, m = _parse_flaser(tok)
                else:
                    n, r, lp, op, ts, m = _parse_robotlaser(tok)
            except (ValueError, IndexError):
                n_bad += 1
                continue
            if m is not None and meta is None:
                meta = m
            ranges_l.append(r)
            nb_l.append(n)
            lp_l.append(lp)
            op_l.append(op)
            ts_l.append(ts)

    if not ranges_l:
        raise ValueError(f"no laser lines found in {path}")
    if n_bad:
        warnings.warn(f"{path}: skipped {n_bad} malformed laser line(s)")
    nmax = max(nb_l)
    t = len(ranges_l)
    ranges = np.full((t, nmax), max_range, np.float32)
    for i, r in enumerate(ranges_l):
        ranges[i, : len(r)] = r
    sa, fv, mr = meta if meta is not None else (math.nan,) * 3
    return CarmenLog(
        ranges=ranges,
        n_beams=np.asarray(nb_l, np.int32),
        laser_pose=np.asarray(lp_l, np.float64),
        odom_pose=np.asarray(op_l, np.float64),
        timestamps=np.asarray(ts_l, np.float64),
        start_angle=sa, fov=fv, log_max_range=mr,
    )


def write_carmen(path: str, log: CarmenLog, style: str = "flaser") -> None:
    """Write laser lines (round-trip/testing; also lets synthetic sequences
    be exported in the reference's input format).

    ``style``: "flaser" or "robotlaser" (full spec trailer incl. hostname).
    """
    sa = log.start_angle if math.isfinite(log.start_angle) else -math.pi / 2
    fv = log.fov if math.isfinite(log.fov) else math.pi
    mr = log.log_max_range if math.isfinite(log.log_max_range) else 81.9
    with open(path, "w") as f:
        for i in range(log.ranges.shape[0]):
            n = int(log.n_beams[i])
            r = " ".join(f"{x:.3f}" for x in log.ranges[i, :n])
            lp = " ".join(f"{x:.6f}" for x in log.laser_pose[i])
            op = " ".join(f"{x:.6f}" for x in log.odom_pose[i])
            ts = float(log.timestamps[i])
            if style == "flaser":
                f.write(f"FLASER {n} {r} {lp} {op} {ts:.6f} host 0.0\n")
            elif style == "robotlaser":
                res = fv / max(n - 1, 1)
                f.write(f"ROBOTLASER1 0 {sa:.6f} {fv:.6f} {res:.6f} "
                        f"{mr:.1f} 0.01 0 {n} {r} 0 {lp} {op} "
                        f"0.0 0.0 0.0 0.0 0.0 {ts:.6f} host 0.0\n")
            else:
                raise ValueError(f"unknown style {style!r}")


def to_sequence(log: CarmenLog, fov: float | None = None,
                min_range: float = 0.1, max_range: float = 50.0,
                dtype=np.float32, apply_laser_extrinsics: bool = True):
    """Convert a parsed log to the pipeline's input tensors.

    Returns ``(points [T, N, 2], mask [T, N], odom [T, 3])`` where odom is
    the relative odometry delta in the robot frame (delta[0] = identity) —
    the inputs of :func:`ndtpu_torch.slam.pipeline.run_slam`.

    Beam angles come from the log's ROBOTLASER1 metadata when present;
    ``fov`` overrides it, and the FLASER fallback is the CARMEN SICK
    convention (180-degree sweep centered on the heading — Intel/MIT logs).

    Laser mounting extrinsics (VERDICT r3): CARMEN logs carry both the
    laser pose and the robot odometry pose in the odometry frame; their
    per-scan relative transform is the sensor mounting offset. Scan points
    are moved into the ROBOT frame with it (the pipeline's odometry deltas
    are robot-frame), so an offset-mounted laser no longer biases
    registration. ``apply_laser_extrinsics=False`` restores the raw laser
    frame.
    """
    t, n = log.ranges.shape
    beam_idx = np.arange(n)
    if fov is not None:
        start, sweep = -fov / 2.0, fov
    elif math.isfinite(log.start_angle) and math.isfinite(log.fov):
        start, sweep = log.start_angle, log.fov
    else:
        start, sweep = -np.pi / 2.0, np.pi
    angles = (start + sweep * beam_idx / max(n - 1, 1)).astype(dtype)
    valid_beam = beam_idx[None, :] < log.n_beams[:, None]
    r = log.ranges.astype(dtype)
    hard_max = max_range
    if math.isfinite(log.log_max_range):
        hard_max = min(hard_max, float(log.log_max_range))
    mask = valid_beam & (r > min_range) & (r < 0.999 * hard_max)
    pts = np.stack([r * np.cos(angles), r * np.sin(angles)],
                   axis=-1).astype(dtype)

    lp, op_all = log.laser_pose, log.odom_pose
    if (apply_laser_extrinsics and np.all(np.isfinite(lp))
            and not np.allclose(lp, op_all)):
        # Per-scan T_robot_laser = odom_pose^-1 ∘ laser_pose.
        c0, s0 = np.cos(op_all[:, 2]), np.sin(op_all[:, 2])
        dx = lp[:, 0] - op_all[:, 0]
        dy = lp[:, 1] - op_all[:, 1]
        tx = (c0 * dx + s0 * dy).astype(dtype)
        ty = (-s0 * dx + c0 * dy).astype(dtype)
        dth = (lp[:, 2] - op_all[:, 2] + np.pi) % (2 * np.pi) - np.pi
        ca = np.cos(dth).astype(dtype)[:, None]
        sa2 = np.sin(dth).astype(dtype)[:, None]
        x, y = pts[..., 0], pts[..., 1]
        pts = np.stack([ca * x - sa2 * y + tx[:, None],
                        sa2 * x + ca * y + ty[:, None]], axis=-1)

    op = log.odom_pose
    deltas = np.zeros((t, 3), dtype)
    for k in range(1, t):
        a, b = op[k - 1], op[k]
        c, s = np.cos(a[2]), np.sin(a[2])
        dx, dy = b[0] - a[0], b[1] - a[1]
        dth = (b[2] - a[2] + np.pi) % (2 * np.pi) - np.pi
        deltas[k] = [c * dx + s * dy, -s * dx + c * dy, dth]
    return pts, mask, deltas


def read_log(path: str, max_range: float = 81.9) -> CarmenLog:
    """Parse a CARMEN log with the native scanner where it builds
    (:func:`ndtpu_torch.native.ndtpu_native_available`), else with
    :func:`read_carmen`; both give the same ``CarmenLog``."""
    from ndtpu_torch import native

    if native.ndtpu_native_available():
        return native.parse_carmen_native(path, max_range)
    return read_carmen(path, max_range)
