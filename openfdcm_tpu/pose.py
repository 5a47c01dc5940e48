"""6-DOF pose recovery from FDCM match candidates (multiview + plane paths).

The reference stops at in-plane matches and defers pose recovery to "a
future open-source library" (``/root/reference/README.md:84-98``); only the
procedure is documented there:

1. sample templates in a 2-DOF viewpoint space,
2. match every view with FDCM,
3. triangulate + vote across views,
4. compose template viewpoint x in-plane rotation x triangulated position
   into the full 6-DOF pose — or, single-view, intersect with a known
   support plane.

This module implements that stage for the accelerator: per-view matching
batches
through :func:`openfdcm_tpu.match_many` (one dispatch for all views), and
the cross-view candidate voting — every (view-pair, candidate, candidate)
triangulation plus reprojection scoring — runs as one jitted tensor
program instead of nested Python loops.

Conventions: world-to-camera extrinsics ``x_cam = R @ x_w + t``; pixels
``u = K @ x_cam`` (perspective divide); image lines are ``(N, 4)`` f32
``[x1, y1, x2, y2]`` rows like the rest of the package.
"""
from __future__ import annotations

import dataclasses
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

__all__ = [
    "Camera", "project_points", "project_lines", "backproject_rays",
    "intersect_plane", "triangulate", "match_centers",
    "multiview_vote", "MultiviewDetection", "multiview_detections",
    "six_dof_pose", "plane_pose",
]


@dataclasses.dataclass(frozen=True)
class Camera:
    """Calibrated pinhole camera: ``k`` 3x3 intrinsics, ``r`` 3x3 / ``t``
    (3,) world-to-camera extrinsics."""
    k: np.ndarray
    r: np.ndarray
    t: np.ndarray

    @property
    def center(self) -> np.ndarray:
        """World-space camera center ``-R^T t``."""
        return -np.asarray(self.r).T @ np.asarray(self.t)


def _cam_arrays(cameras):
    k = jnp.asarray(np.stack([np.asarray(c.k, np.float32) for c in cameras]))
    r = jnp.asarray(np.stack([np.asarray(c.r, np.float32) for c in cameras]))
    t = jnp.asarray(np.stack([np.asarray(c.t, np.float32) for c in cameras]))
    return k, r, t


@jax.jit
def project_points(pts3d, k, r, t):
    """Project world points ``(..., 3)`` through ``(K, R, t)`` -> ``(..., 2)``
    pixels."""
    hi = jax.lax.Precision.HIGHEST
    cam = jnp.matmul(pts3d, r.T, precision=hi) + t
    uvw = jnp.matmul(cam, k.T, precision=hi)
    return uvw[..., :2] / jnp.maximum(uvw[..., 2:3], 1e-9)


def project_lines(lines3d, camera: Camera) -> np.ndarray:
    """Project 3D segments ``(N, 6)`` ``[p1 p2]`` into image lines
    ``(N, 4)``."""
    k, r, t = (jnp.asarray(np.asarray(a, np.float32))
               for a in (camera.k, camera.r, camera.t))
    l3 = jnp.asarray(np.asarray(lines3d, np.float32))
    a = project_points(l3[:, 0:3], k, r, t)
    b = project_points(l3[:, 3:6], k, r, t)
    return np.asarray(jnp.concatenate([a, b], axis=1))


@jax.jit
def backproject_rays(pix, k, r, t):
    """Pixels ``(..., 2)`` -> world rays ``(origin (3,), dirs (..., 3))``
    (directions unit-normalized)."""
    hi = jax.lax.Precision.HIGHEST
    ones = jnp.ones(pix.shape[:-1] + (1,), pix.dtype)
    d_cam = jnp.matmul(jnp.concatenate([pix, ones], axis=-1),
                       jnp.linalg.inv(k).T, precision=hi)
    d_w = jnp.matmul(d_cam, r, precision=hi)     # R^T @ d, batched
    d_w = d_w / jnp.linalg.norm(d_w, axis=-1, keepdims=True)
    origin = -jnp.matmul(r.T, t, precision=hi)
    return origin, d_w


@jax.jit
def intersect_plane(origin, dirs, plane):
    """Ray-plane intersection: ``plane`` = (nx, ny, nz, d) with
    ``n . x + d = 0``.  Returns ``(..., 3)`` world points (NaN where the ray
    is parallel)."""
    hi = jax.lax.Precision.HIGHEST
    n, d = plane[:3], plane[3]
    denom = jnp.matmul(dirs, n, precision=hi)
    s = -(jnp.matmul(origin, n, precision=hi) + d) / jnp.where(jnp.abs(denom) < 1e-9, jnp.nan, denom)
    return origin + s[..., None] * dirs


@jax.jit
def triangulate(origins, dirs):
    """Least-squares point closest to ``V`` rays (batched over leading axes
    of ``dirs``): ``origins (V, 3)``, ``dirs (V, ..., 3)`` ->
    ``(..., 3)``.  Solves ``sum_v (I - d d^T) (x - o_v) = 0``."""
    eye = jnp.eye(3, dtype=dirs.dtype)
    proj = eye - dirs[..., :, None] * dirs[..., None, :]   # (V, ..., 3, 3)
    a = jnp.sum(proj, axis=0)
    o = origins.reshape((-1,) + (1,) * (dirs.ndim - 2) + (3,))
    b = jnp.sum(jnp.einsum("v...ij,v...j->v...i", proj, o,
                           precision=jax.lax.Precision.HIGHEST), axis=0)
    return jnp.linalg.solve(a, b[..., None])[..., 0]


def match_centers(matches, templates) -> np.ndarray:
    """Image-space object centers of matches: each match's transform applied
    to its template's line centroid.  ``(M, 2)`` f32 (empty -> (0, 2))."""
    out = np.zeros((len(matches), 2), np.float32)
    for i, m in enumerate(matches):
        t = np.asarray(templates[m.tmpl_idx], np.float32)
        if t.shape[0] == 0:
            continue
        c = (t[:, 0:2] + t[:, 2:4]).sum(axis=0) / (2.0 * t.shape[0])
        out[i] = np.asarray(m.transform)[:2, :2] @ c + np.asarray(m.transform)[:2, 2]
    return out


@partial(jax.jit, static_argnames=("eps_px",))
def multiview_vote(centers, tmpl_idx, valid, k, r, t, *, eps_px: float = 8.0):
    """Cross-view triangulation + voting over match candidates.

    ``centers (V, K, 2)``: per-view candidate image centers (top-k matches);
    ``tmpl_idx (V, K)`` their template ids; ``valid (V, K)``.  Every
    cross-view candidate pair (same template) is triangulated; each
    hypothesis is reprojected into every view and earns one *vote* per view
    with a same-template candidate within ``eps_px``.  Returns
    ``(points (P, 3), votes (P,), rms (P,), pair_idx (P, 4))`` over all
    hypotheses ``P = V*(V-1)/2 * K * K``, invalid ones with votes 0 —
    a single fused tensor program (no per-candidate Python).
    """
    v, kk = centers.shape[0], centers.shape[1]
    origins, dirs = jax.vmap(backproject_rays)(centers, k, r, t)  # (V,3),(V,K,3)

    ia, ib = jnp.triu_indices(v, 1)                       # view pairs (Q,)
    ca, cb = centers[ia], centers[ib]                     # (Q, K, 2)

    def pair_tri(oa, da, ob, db):
        # all K x K candidate combinations of one view pair
        o2 = jnp.stack([oa, ob])                          # (2, 3)
        d2 = jnp.stack([jnp.broadcast_to(da[:, None], (kk, kk, 3)),
                        jnp.broadcast_to(db[None, :], (kk, kk, 3))])
        return triangulate(o2, d2)                        # (K, K, 3)

    pts = jax.vmap(pair_tri)(origins[ia], dirs[ia], origins[ib], dirs[ib])
    same = tmpl_idx[ia][:, :, None] == tmpl_idx[ib][:, None, :]
    ok = same & valid[ia][:, :, None] & valid[ib][:, None, :]
    tid = jnp.broadcast_to(tmpl_idx[ia][:, :, None], same.shape)

    flat_pts = pts.reshape(-1, 3)                         # (P, 3)
    flat_ok = ok.reshape(-1)
    flat_tid = tid.reshape(-1)

    # reproject every hypothesis into every view
    reproj = jax.vmap(lambda kk_, rr, tt: project_points(flat_pts, kk_, rr, tt)
                      )(k, r, t)                          # (V, P, 2)
    d2 = jnp.sum((reproj[:, :, None, :] - centers[:, None, :, :]) ** 2,
                 axis=-1)                                 # (V, P, K)
    cand_ok = valid[:, None, :] & (tmpl_idx[:, None, :] == flat_tid[None, :, None])
    d2 = jnp.where(cand_ok, d2, jnp.inf)
    best = jnp.min(d2, axis=-1)                           # (V, P)
    hit = best < eps_px ** 2
    votes = jnp.where(flat_ok, jnp.sum(hit, axis=0), 0)
    rms = jnp.sqrt(jnp.sum(jnp.where(hit, best, 0.0), axis=0)
                   / jnp.maximum(jnp.sum(hit, axis=0), 1))

    qi = jnp.arange(ia.shape[0])
    grid = jnp.stack(jnp.meshgrid(qi, jnp.arange(kk), jnp.arange(kk),
                                  indexing="ij"), axis=-1).reshape(-1, 3)
    pair_idx = jnp.concatenate(
        [ia[grid[:, 0], None], grid[:, 1:2], ib[grid[:, 0], None],
         grid[:, 2:3]], axis=1)                           # (P, 4) v0,k0,v1,k1
    return flat_pts, votes, rms, pair_idx


@dataclasses.dataclass
class MultiviewDetection:
    """A voted cross-view detection: triangulated position, supporting-view
    count, reprojection RMS, the anchor (view, candidate) pair, template."""
    point: np.ndarray       # (3,)
    votes: int
    rms: float
    tmpl_idx: int
    view_cand: tuple        # (v0, k0, v1, k1)


def multiview_detections(matches_per_view, templates, cameras, *, k: int = 10,
                         eps_px: float = 8.0, min_votes: int = 2) -> list:
    """Full multiview stage: per-view top-k match candidates -> voting ->
    ranked :class:`MultiviewDetection` list (votes desc, rms asc).

    ``matches_per_view``: ``list[list[Match]]`` (e.g. from ``match_many`` on
    the per-view scenes — one batched dispatch for all views).
    """
    v = len(matches_per_view)
    host_templates = [np.asarray(t, np.float32) for t in templates]
    centers = np.zeros((v, k, 2), np.float32)
    tidx = np.full((v, k), -1, np.int32)
    valid = np.zeros((v, k), bool)
    for vi, ms in enumerate(matches_per_view):
        ms = ms[:k]
        c = match_centers(ms, host_templates)
        centers[vi, : len(ms)] = c
        tidx[vi, : len(ms)] = [m.tmpl_idx for m in ms]
        valid[vi, : len(ms)] = True
    kk_, rr, tt = _cam_arrays(cameras)
    pts, votes, rms, pair_idx = multiview_vote(
        jnp.asarray(centers), jnp.asarray(tidx), jnp.asarray(valid),
        kk_, rr, tt, eps_px=float(eps_px))
    pts, votes, rms, pair_idx = (np.asarray(x) for x in
                                 (pts, votes, rms, pair_idx))
    order = np.lexsort((rms, -votes))
    out = []
    seen = set()
    for i in order:
        if votes[i] < min_votes:
            break
        v0, k0, v1, k1 = (int(x) for x in pair_idx[i])
        anchor = (v0, k0)
        if anchor in seen:       # keep the best hypothesis per anchor cand
            continue
        seen.add(anchor)
        out.append(MultiviewDetection(
            point=pts[i].copy(), votes=int(votes[i]), rms=float(rms[i]),
            tmpl_idx=int(tidx[v0, k0]), view_cand=(v0, k0, v1, k1)))
    return out


def _in_plane_angle(transform) -> float:
    m = np.asarray(transform)
    return float(np.arctan2(m[1, 0], m[0, 0]))


def six_dof_pose(detection: MultiviewDetection, matches_per_view,
                 template_rotations, cameras) -> np.ndarray:
    """Compose the full 6-DOF pose ``(4, 4)`` world-from-object:
    ``R = R_wc @ Rz(theta_inplane) @ R_view(tmpl)``, ``t`` = triangulated
    point (README.md:98 step 5).  ``template_rotations``: per-template 3x3
    viewpoint rotation from the sampling stage (object-from-canonical)."""
    v0, k0 = detection.view_cand[:2]
    m = matches_per_view[v0][k0]
    theta = _in_plane_angle(m.transform)
    c, s = np.cos(theta), np.sin(theta)
    rz = np.asarray([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]], np.float64)
    r_view = np.asarray(template_rotations[m.tmpl_idx], np.float64)
    r_wc = np.asarray(cameras[v0].r, np.float64).T
    pose = np.eye(4)
    pose[:3, :3] = r_wc @ rz @ r_view
    pose[:3, 3] = detection.point
    return pose


def plane_pose(match, templates, template_rotations, camera: Camera,
               plane) -> np.ndarray:
    """Single-view 6-DOF under the known-support-plane hypothesis
    (README.md:91): back-project the match center onto ``plane`` for T(3),
    compose R like :func:`six_dof_pose`."""
    c = match_centers([match], [np.asarray(t, np.float32) for t in templates])
    k, r, t = (jnp.asarray(np.asarray(a, np.float32))
               for a in (camera.k, camera.r, camera.t))
    origin, dirs = backproject_rays(jnp.asarray(c), k, r, t)
    pt = np.asarray(intersect_plane(origin, dirs,
                                    jnp.asarray(plane, jnp.float32)))[0]
    theta = _in_plane_angle(match.transform)
    cth, sth = np.cos(theta), np.sin(theta)
    rz = np.asarray([[cth, -sth, 0.0], [sth, cth, 0.0], [0.0, 0.0, 1.0]])
    pose = np.eye(4)
    pose[:3, :3] = np.asarray(camera.r, np.float64).T @ rz \
        @ np.asarray(template_rotations[match.tmpl_idx], np.float64)
    pose[:3, 3] = pt
    return pose
