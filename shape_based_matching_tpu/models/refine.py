"""Subpixel / ICP pose refinement (similarity and affine models).

The reference README advertises icp2D / subpixel / sim3 refinement branches
(README.md:8-10) that are absent from the mounted tree; upstream's "sim3"
branch is the 2D similarity group with scale ("deal with scale error" —
their earlier branch was rotation-only). This module provides the
capability on the device and goes one model further:

* model="sim2" (default): scale + rotation + translation (4 DOF) — the
  upstream sim3 branch's capability;
* model="affine": full 2D affine (6 DOF) — adds shear/aspect, for
  out-of-plane-tilted or anamorphic parts.

An iterative closest-edge-point refinement upgrades a discrete LINE-2D
match (pixel-grid position, enumerated angle) to a continuous pose.

Algorithm (all candidates refined in one batched jit):
  1. Place the template's edge features at the match hypothesis.
  2. For each feature, search a (2R+1)² window in the test image for the
     best edge pixel: strong magnitude and orientation agreement with the
     feature's stored raw angle (theta).
  3. Solve the weighted least-squares 2D similarity transform from feature
     points to matched edge points in closed form (complex-number Procrustes/
     Umeyama: a = Σ w·conj(p')·q' / Σ w·|p'|²).
  4. Apply, repeat. Returns per-match (x, y) at subpixel precision, the
     residual angle delta in degrees, scale factor, and mean residual.

Accuracy (tests/test_refine.py): recovers sub-degree rotations and subpixel
translations on synthetic scenes, matching the reference branches' claimed
0.1–0.5° envelope. For the tighter "subpixel" tier (0.1 deg / 0.5% scale,
point-to-plane + subpixel edge localization + jump-flood correspondences)
see models/icp.py:refine_matches_icp.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.gradients import quantized_orientations

# Normal equations in full float32: a GPU would otherwise run float32
# matmuls and einsums in TF32 (about three decimal digits).
_HI = jax.lax.Precision.HIGHEST


class RefinedPose(NamedTuple):
    x: jnp.ndarray          # [C] float32 refined match origin
    y: jnp.ndarray          # [C]
    angle_delta: jnp.ndarray  # [C] degrees (residual rotation vs template)
    scale: jnp.ndarray      # [C] residual scale factor
    residual: jnp.ndarray   # [C] mean feature->edge distance (px)
    valid: jnp.ndarray      # [C] bool
    affine: jnp.ndarray     # [C, 2, 2] linear part (sim2: rot*scale matrix)


def _angle_diff_deg(a, b):
    """Smallest difference between gradient orientations (180°-symmetric)."""
    d = jnp.abs(jnp.mod(a - b, 180.0))
    return jnp.minimum(d, 180.0 - d)


@partial(jax.jit, static_argnames=("radius", "iterations", "model"))
def refine_matches(magnitude: jnp.ndarray, angle_deg: jnp.ndarray,
                   fx: jnp.ndarray, fy: jnp.ndarray, ftheta: jnp.ndarray,
                   fvalid: jnp.ndarray, mx: jnp.ndarray, my: jnp.ndarray,
                   mvalid: jnp.ndarray, mag_threshold,
                   radius: int = 3, iterations: int = 5,
                   model: str = "sim2") -> RefinedPose:
    """Batched point-to-plane ICP (Gauss-Newton over sim2 or affine).

    Point-to-point ICP on dense edges is tangentially ambiguous (every
    feature's nearest edge pixel is usually its own rounded position), so
    small rotations/scales are invisible to it. Instead each correspondence
    contributes its distance along the local edge NORMAL (the gradient
    direction at the matched edge pixel), with the edge localized to
    subpixel precision by a parabola fit of |grad| along the normal.

    magnitude/angle_deg: [H, W] test-image gradient maps (squared magnitude
    and raw fastAtan2 angle, as produced by quantized_orientations).
    fx/fy/ftheta/fvalid: [C, N] per-match template features (template frame).
    mx/my: [C] integer match origins; mvalid: [C].
    """
    h, w = magnitude.shape
    C, N = fx.shape

    n_taps = 2 * radius + 1
    ts = jnp.arange(-radius, radius + 1,
                    dtype=jnp.float32)  # ray offsets along the normal

    def signed_diff_deg(a, b):
        d = jnp.abs(jnp.mod(a - b, 360.0))
        return jnp.minimum(d, 360.0 - d)

    def correspondences(px, py, theta_cur):
        """Search along each feature's own normal ray for the edge crest.

        The gradient direction is SIGNED (dark-to-light); matching it in
        360° space rejects the opposite flank of thin structures, which the
        180°-symmetric bin test would accept (and which otherwise cancels
        the rotation signal). -> (t_signed residual along normal, nx, ny,
        found)."""
        ang_f = ftheta + jnp.degrees(theta_cur)[:, None]  # [C, N]
        rad = jnp.radians(ang_f)
        nx = jnp.cos(rad)
        ny = jnp.sin(rad)
        sx = jnp.clip(jnp.round(px[..., None] + ts * nx[..., None])
                      .astype(jnp.int32), 0, w - 1)   # [C, N, taps]
        sy = jnp.clip(jnp.round(py[..., None] + ts * ny[..., None])
                      .astype(jnp.int32), 0, h - 1)
        mag = magnitude[sy, sx]
        ang = angle_deg[sy, sx]
        good = ((mag > mag_threshold)
                & (signed_diff_deg(ang, ang_f[..., None]) < 45.0))
        # The blurred edge is a several-px-wide BAND above the threshold;
        # the correspondence is the magnitude CREST along the ray (the
        # nearest-band-pixel would always be the feature itself). Small
        # |t| penalty picks the nearest crest on ties.
        score = jnp.where(good, jnp.sqrt(mag) - 5.0 * jnp.abs(ts), -jnp.inf)
        best = jnp.argmax(score, axis=-1)  # [C, N]
        found = jnp.isfinite(
            jnp.take_along_axis(score, best[..., None], axis=-1)[..., 0])

        def tap(idx):
            idx = jnp.clip(idx, 0, n_taps - 1)
            return jnp.sqrt(jnp.take_along_axis(mag, idx[..., None],
                                                axis=-1)[..., 0])

        m0 = tap(best)
        mp = tap(best + 1)
        mm = tap(best - 1)
        d2 = mm - 2 * m0 + mp  # concave (<0) at a magnitude crest
        safe = jnp.where(jnp.abs(d2) > 1e-6, d2, -1e-6)
        delta = jnp.clip(0.5 * (mm - mp) / safe, -0.5, 0.5)
        delta = jnp.where(m0 >= jnp.maximum(mm, mp), delta, 0.0)
        t_found = ts[best] + delta  # signed distance p -> edge crest
        return t_found, nx, ny, found

    fxf = fx.astype(jnp.float32)
    fyf = fy.astype(jnp.float32)
    tx = mx.astype(jnp.float32)
    ty = my.astype(jnp.float32)
    resid = jnp.zeros((C,), jnp.float32)
    nfound = jnp.zeros((C,), jnp.float32)

    if model == "sim2":
        theta = jnp.zeros((C,), jnp.float32)
        scale = jnp.ones((C,), jnp.float32)
        for _ in range(iterations):
            ar = scale * jnp.cos(theta)
            ai = scale * jnp.sin(theta)
            vx = ar[:, None] * fxf - ai[:, None] * fyf
            vy = ai[:, None] * fxf + ar[:, None] * fyf
            px = vx + tx[:, None]
            py = vy + ty[:, None]
            t_found, nx, ny, found = correspondences(px, py, theta)
            wgt = (found & fvalid).astype(jnp.float32)
            nfound = jnp.sum(wgt, axis=1)

            # point-to-plane residual, Jacobian rows [tx, ty, dtheta, ds]
            # r = (p - q)·n where q = p + t_found·n  =>  r = -t_found
            r = -t_found
            j_t = (-vy) * nx + vx * ny                       # d/dtheta
            j_s = (vx * nx + vy * ny) / scale[:, None]       # d/dscale
            J = jnp.stack([nx, ny, j_t, j_s], axis=-1)       # [C, N, 4]
            Wj = J * wgt[..., None]
            A = jnp.einsum("cni,cnj->cij", Wj, J, precision=_HI)
            A = A + jnp.eye(4, dtype=jnp.float32)[None] * 1e-3
            b = -jnp.einsum("cni,cn->ci", Wj, r, precision=_HI)
            delta = jnp.linalg.solve(A, b[..., None])[..., 0]  # [C, 4]
            tx = tx + delta[:, 0]
            ty = ty + delta[:, 1]
            theta = theta + delta[:, 2]
            scale = jnp.clip(scale + delta[:, 3], 0.5, 2.0)
            resid = (jnp.sum(wgt * jnp.abs(r), axis=1)
                     / jnp.maximum(nfound, 1.0))
        ar = scale * jnp.cos(theta)
        ai = scale * jnp.sin(theta)
        lin = jnp.stack(
            [jnp.stack([ar, -ai], -1), jnp.stack([ai, ar], -1)], -2)
        angle_out = jnp.degrees(theta)
        scale_out = scale
    elif model == "affine":
        # full 2D affine (the upstream sim3 branch handles scale; this
        # additionally absorbs shear/aspect from out-of-plane tilt).
        # p = (a*fx + b*fy + tx, c*fx + d*fy + ty)
        a = jnp.ones((C,), jnp.float32)
        bb = jnp.zeros((C,), jnp.float32)
        c = jnp.zeros((C,), jnp.float32)
        d = jnp.ones((C,), jnp.float32)
        for _ in range(iterations):
            vx = a[:, None] * fxf + bb[:, None] * fyf
            vy = c[:, None] * fxf + d[:, None] * fyf
            px = vx + tx[:, None]
            py = vy + ty[:, None]
            theta_cur = jnp.arctan2(c, a)  # rotation estimate for normals
            t_found, nx, ny, found = correspondences(px, py, theta_cur)
            wgt = (found & fvalid).astype(jnp.float32)
            nfound = jnp.sum(wgt, axis=1)

            r = -t_found
            # params [tx, ty, a, b, c, d]; dr/dparam = n·dp/dparam
            J = jnp.stack([nx, ny, fxf * nx, fyf * nx,
                           fxf * ny, fyf * ny], axis=-1)  # [C, N, 6]
            Wj = J * wgt[..., None]
            A = jnp.einsum("cni,cnj->cij", Wj, J, precision=_HI)
            A = A + jnp.eye(6, dtype=jnp.float32)[None] * 1e-3
            bvec = -jnp.einsum("cni,cn->ci", Wj, r, precision=_HI)
            delta = jnp.linalg.solve(A, bvec[..., None])[..., 0]
            tx = tx + delta[:, 0]
            ty = ty + delta[:, 1]
            a = a + delta[:, 2]
            bb = bb + delta[:, 3]
            c = c + delta[:, 4]
            d = d + delta[:, 5]
            resid = (jnp.sum(wgt * jnp.abs(r), axis=1)
                     / jnp.maximum(nfound, 1.0))
        lin = jnp.stack(
            [jnp.stack([a, bb], -1), jnp.stack([c, d], -1)], -2)
        angle_out = jnp.degrees(jnp.arctan2(c, a))
        det = a * d - bb * c
        scale_out = jnp.sqrt(jnp.abs(det))
    else:
        raise ValueError(f"unknown refine model: {model!r}")

    ok = mvalid & (nfound >= jnp.maximum(3.0, 0.3 * jnp.sum(
        fvalid.astype(jnp.float32), axis=1)))
    return RefinedPose(tx, ty, angle_out, scale_out, resid, ok, lin)


def refine_detections(detector, image: np.ndarray, matches,
                      radius: int = 3, iterations: int = 3,
                      model: str = "sim2"):
    """Host-facing wrapper: refine a Detector.match() result list.

    `model`: "sim2" (scale+rotation+translation — the upstream sim3
    branch's capability) or "affine" (adds shear/aspect).
    Returns a list of dicts ({x, y, angle_delta, scale, residual, affine,
    match}) for matches that refined successfully.
    """
    if not matches:
        return []
    grads = quantized_orientations(np.asarray(image),
                                   detector.weak_threshold,
                                   detector.num_orientations)
    N = max(len(detector.get_templates(m.class_id, m.template_id)[0].features)
            for m in matches)
    C = len(matches)
    fx = np.zeros((C, N), np.int32)
    fy = np.zeros((C, N), np.int32)
    th = np.zeros((C, N), np.float32)
    fv = np.zeros((C, N), bool)
    mx = np.zeros((C,), np.int32)
    my = np.zeros((C,), np.int32)
    for i, m in enumerate(matches):
        t0 = detector.get_templates(m.class_id, m.template_id)[0]
        for n, f in enumerate(t0.features):
            fx[i, n], fy[i, n], th[i, n] = f.x, f.y, f.theta
            fv[i, n] = True
        mx[i], my[i] = m.x, m.y

    pose = refine_matches(
        grads.magnitude, grads.angle_ori,
        jnp.asarray(fx), jnp.asarray(fy), jnp.asarray(th), jnp.asarray(fv),
        jnp.asarray(mx), jnp.asarray(my), jnp.ones((C,), bool),
        jnp.float32(detector.weak_threshold) ** 2,
        radius=radius, iterations=iterations, model=model)

    out = []
    for i, m in enumerate(matches):
        if bool(pose.valid[i]):
            out.append({
                "match": m,
                "x": float(pose.x[i]),
                "y": float(pose.y[i]),
                "angle_delta": float(pose.angle_delta[i]),
                "scale": float(pose.scale[i]),
                "residual": float(pose.residual[i]),
                "affine": np.asarray(pose.affine[i]),
            })
    return out
