"""Vectorized skeletal kinematics — the XLA re-design of the reference's
three-stage offline feature pipeline (SURVEY.md §3.4):

  stage 1  hand velocities + rest-position distance
           (/root/reference/skeletal_network/velocity.py:7-27,
            r_position.py:8-46)
  stage 3  velocities/accelerations/distances/angles
           (/root/reference/skeletal_network/skeletal_feature_extraction.py:25-215)

All functions are jit-able jnp transforms over (T, 2) joint tracks (or
batches thereof via vmap). Frame-zeroing conventions preserved exactly:
stage-3 velocities/accelerations zero the first 5 frames
(skeletal_feature_extraction.py:96-97,121-122); stage-1 hand velocity
and rest-pose distance zero the first 4 (velocity.py:12-14,
r_position.py:34-36). The reference's int() truncations on stage-1
outputs are reproduced via ``floor`` so golden CSVs match.
"""

from __future__ import annotations

from typing import Dict

import jax.numpy as jnp

Joint = jnp.ndarray  # (T, 2) x/y track


def previous(x: jnp.ndarray) -> jnp.ndarray:
    """Shift one frame forward; frame 0 becomes zeros
    (get_previous_pos, skeletal_feature_extraction.py:25-42)."""
    return jnp.concatenate([jnp.zeros_like(x[:1]), x[:-1]], axis=0)


def velocity(pos: Joint, zero_first: int = 5) -> jnp.ndarray:
    """Inter-frame Euclidean displacement, first ``zero_first`` frames
    zeroed (calculate_velocities, skeletal_feature_extraction.py:69-101).
    Note the reference compares against the previous-position array whose
    frame 0 is zeros — reproduced via :func:`previous`."""
    d = jnp.linalg.norm(pos - previous(pos), axis=-1)
    t = jnp.arange(pos.shape[0])
    return jnp.where(t < zero_first, 0.0, d)


def acceleration(vel: jnp.ndarray, zero_first: int = 5) -> jnp.ndarray:
    """Velocity delta, first frames zeroed
    (calculate_accelerations, skeletal_feature_extraction.py:105-126)."""
    dv = vel - previous(vel)
    t = jnp.arange(vel.shape[0])
    return jnp.where(t < zero_first, 0.0, dv)


def distance(a: Joint, b: Joint) -> jnp.ndarray:
    """Per-frame Euclidean distance between two joint tracks
    (calculate_distances, skeletal_feature_extraction.py:131-183)."""
    return jnp.linalg.norm(a - b, axis=-1)


def angle(a: Joint, b: Joint) -> jnp.ndarray:
    """arctan2(dy, dx) of (a - b)
    (calculate_angles, skeletal_feature_extraction.py:188-215)."""
    d = a - b
    return jnp.arctan2(d[..., 1], d[..., 0])


def hand_velocity_stage1(pos: Joint) -> jnp.ndarray:
    """Stage-1 hand velocity: int-truncated inter-frame distance, first
    4 frames zeroed (velocity.py:7-27)."""
    d = jnp.linalg.norm(pos - previous(pos), axis=-1)
    t = jnp.arange(pos.shape[0])
    return jnp.where(t < 4, 0.0, jnp.floor(d))


def rest_position(
    joints: Dict[str, Joint], lh_v: jnp.ndarray, rh_v: jnp.ndarray
) -> Dict[str, jnp.ndarray]:
    """Median pose over low-velocity frames (both hand velocities below
    their means), per joint (estimate_rest_position, r_position.py:8-21).
    Returns {joint: (2,) int-truncated medians}.

    Static shapes: the data-dependent row filter becomes a masked median —
    out-of-mask frames are set to NaN and ``nanmedian`` reduces; shapes
    stay static."""
    low = (lh_v < lh_v.mean()) & (rh_v < rh_v.mean())
    out = {}
    for name, track in joints.items():
        masked = jnp.where(low[:, None], track, jnp.nan)
        out[name] = jnp.trunc(jnp.nanmedian(masked, axis=0))
    return out


def distance_from_rest(pos: Joint, rest: jnp.ndarray) -> jnp.ndarray:
    """Int-truncated distance of a hand from its rest position, first 4
    frames zeroed (calc_distance_from_rp, r_position.py:27-46)."""
    d = jnp.linalg.norm(pos - rest[None, :], axis=-1)
    t = jnp.arange(pos.shape[0])
    return jnp.where(t < 4, 0.0, jnp.floor(d))


def skeletal_features(joints: Dict[str, Joint]) -> jnp.ndarray:
    """Full per-frame feature matrix in the model's 20-column order
    (mgr_tpu.data.formats.SKELETAL_FEATURES, selected at
    skeletal_lstm_ctc.py:74-77).

    ``joints`` needs keys: lh, rh, le, re, hip, shc (each (T, 2))."""
    lh, rh, le, re = joints["lh"], joints["rh"], joints["le"], joints["re"]
    hip, shc = joints["hip"], joints["shc"]

    lh_v, rh_v = velocity(lh), velocity(rh)
    le_v, re_v = velocity(le), velocity(re)

    s1_lh_v, s1_rh_v = hand_velocity_stage1(lh), hand_velocity_stage1(rh)
    rp = rest_position({"lh": lh, "rh": rh}, s1_lh_v, s1_rh_v)
    lh_dist_rp = distance_from_rest(lh, rp["lh"])
    rh_dist_rp = distance_from_rest(rh, rp["rh"])

    cols = [
        lh_v, rh_v, le_v, re_v,
        lh_dist_rp, rh_dist_rp,
        distance(lh, hip), distance(rh, hip),
        distance(le, hip), distance(re, hip),
        distance(lh, shc), distance(rh, shc),
        distance(le, shc), distance(re, shc),
        angle(lh, hip), angle(rh, hip),
        angle(lh, shc), angle(rh, shc),
        angle(lh, le), angle(rh, re),
    ]
    return jnp.stack(cols, axis=-1)


def extra_features(joints: Dict[str, Joint]) -> Dict[str, jnp.ndarray]:
    """Stage-3 columns computed but not selected by the model (inter-hand
    distance, accelerations) — provided for full CSV parity."""
    lh, rh, le, re = joints["lh"], joints["rh"], joints["le"], joints["re"]
    out = {"hands_d": distance(lh, rh)}
    for name, track in (("lh", lh), ("rh", rh), ("le", le), ("re", re)):
        out[f"{name}_a"] = acceleration(velocity(track))
    return out


def clip_kinect_range(
    xy: jnp.ndarray, width: int = 640, height: int = 480
) -> jnp.ndarray:
    """Out-of-range Kinect coords snap to frame center
    (load_skeleton.py:13-14: x>=640 -> 320, y>=480 -> 240)."""
    x = jnp.where(xy[..., 0] >= width, width // 2, xy[..., 0])
    y = jnp.where(xy[..., 1] >= height, height // 2, xy[..., 1])
    return jnp.stack([x, y], axis=-1)
