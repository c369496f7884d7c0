"""Template training: feature extraction from an image + mask.

Split device-first: the dense work (gradients, quantization, 5×5 local-max map)
runs as fused JAX on device; the tiny order-dependent greedy passes (NMS
acceptance scan, scattered-feature selection; line2Dup.cpp:452-539,163-212)
run on host over the short candidate list, where their sequential semantics
are exact and cheap.

The reference's greedy magnitude NMS (line2Dup.cpp:466-511) scans row-major
with a `magnitude_valid` bitmap. Its exact semantics reduce to:

  * a pixel is an *accepted max* iff it is mask-eligible, a ties-allowed 5×5
    local max of magnitude, and no previously accepted max lies within
    Chebyshev distance 2 (suppression only ever comes from accepted maxes);
  * candidates are accepted maxes with magnitude > strong² and a nonzero
    quantized orientation.

We compute the ties-allowed local-max map on device and replay the row-major
acceptance with an O(25)-per-pixel occupancy grid on host — bit-identical to
the C++ including tie chains.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.filters import erode3_u8
from ..ops.gradients import QuantizedGradients
from .template import Feature, Template


@partial(jax.jit, static_argnames=())
def local_max_map(magnitude: jnp.ndarray) -> jnp.ndarray:
    """Ties-allowed 5×5 local-max map, interior only (k=2 border margin)."""
    h, w = magnitude.shape
    neg_inf = jnp.float32(-jnp.inf)
    p = jnp.pad(magnitude, 2, constant_values=neg_inf)
    neigh_max = neg_inf
    for i in range(5):
        for j in range(5):
            if i == 2 and j == 2:
                continue
            neigh_max = jnp.maximum(neigh_max, p[i : i + h, j : j + w])
    is_max = magnitude >= neigh_max
    interior = (
        (jnp.arange(h)[:, None] >= 2) & (jnp.arange(h)[:, None] < h - 2)
        & (jnp.arange(w)[None, :] >= 2) & (jnp.arange(w)[None, :] < w - 2)
    )
    return is_max & interior


def extract_template(grads: QuantizedGradients, mask: np.ndarray | None,
                     num_features: int, strong_threshold: float,
                     pyramid_level: int) -> Template | None:
    """ColorGradientPyramid::extractTemplate (line2Dup.cpp:452-539).

    Returns None when too few candidates (<=4) — the reference aborts and
    addTemplate returns -1 (line2Dup.cpp:513-517,1342).
    """
    magnitude = np.asarray(grads.magnitude)
    quantized = np.asarray(grads.angle)
    angle_ori = np.asarray(grads.angle_ori)
    h, w = magnitude.shape

    local_mask = None
    if mask is not None and mask.size:
        local_mask = np.asarray(erode3_u8(jnp.asarray(mask)))

    lmax = np.asarray(local_max_map(grads.magnitude))
    if local_mask is not None:
        eligible = lmax & (local_mask > 0)
    else:
        eligible = lmax

    ys, xs = np.nonzero(eligible)
    return extract_template_host(
        h, w, ys, xs, magnitude[ys, xs], quantized[ys, xs],
        angle_ori[ys, xs], num_features, strong_threshold, pyramid_level)


def greedy_accept(h: int, w: int, ys, xs) -> np.ndarray:
    """Row-major greedy acceptance flags (bool [n]) over the ROW-MAJOR
    eligible pixel list — exact C++ semantics (line2Dup.cpp:466-511): a
    pixel is accepted iff no previously accepted pixel lies within
    Chebyshev distance 2. Native C++ fast path; identical pure-Python
    fallback."""
    from ..native import load as _load_native

    n = len(ys)
    if n == 0:
        return np.zeros(0, bool)
    lib = _load_native()
    if lib is not None:
        import ctypes

        ys32 = np.ascontiguousarray(ys, np.int32)
        xs32 = np.ascontiguousarray(xs, np.int32)
        flags = np.zeros(n, np.uint8)
        lib.sbm_greedy_accept(
            h, w, n,
            ys32.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            xs32.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            flags.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
        return flags.astype(bool)
    accepted = np.zeros((h, w), dtype=bool)
    flags = np.zeros(n, bool)
    for i, (r, c) in enumerate(zip(np.asarray(ys).tolist(),
                                   np.asarray(xs).tolist())):
        r0, r1 = max(0, r - 2), min(h, r + 3)
        c0, c1 = max(0, c - 2), min(w, c + 3)
        if accepted[r0:r1, c0:c1].any():
            continue
        accepted[r, c] = True
        flags[i] = True
    return flags


def template_from_strong(xs, ys, mag_v, quant_v, theta_v,
                         num_features: int, strong_threshold: float,
                         pyramid_level: int) -> Template | None:
    """Tail of extractTemplate given the ACCEPTED pixels in row-major
    order: exact float strong-threshold filter, stable score sort,
    scattered selection (line2Dup.cpp:513-539)."""
    threshold_sq = float(strong_threshold) ** 2
    candidates = []  # row-major acceptance order (pre-sort tie order)
    for x, y, s, q, t in zip(np.asarray(xs).tolist(),
                             np.asarray(ys).tolist(),
                             np.asarray(mag_v).tolist(),
                             np.asarray(quant_v).tolist(),
                             np.asarray(theta_v).tolist()):
        q = int(q)
        if s > threshold_sq and q > 0:
            candidates.append(
                Candidate(x=int(x), y=int(y), label=q.bit_length() - 1,
                          score=float(s), theta=float(t)))

    if len(candidates) < num_features and len(candidates) <= 4:
        return None

    candidates.sort(key=lambda cd: -cd.score)  # stable (line2Dup.cpp:522)
    distance = float(len(candidates) // num_features + 1)
    feats = select_scattered_features(candidates, num_features, distance)

    templ = Template(width=-1, height=-1, pyramid_level=pyramid_level)
    templ.features = [Feature(c.x, c.y, c.label, c.theta) for c in feats]
    return templ


def extract_template_host(h: int, w: int, ys, xs, mag_v, quant_v, theta_v,
                          num_features: int, strong_threshold: float,
                          pyramid_level: int) -> Template | None:
    """Host half of extract_template: row-major greedy acceptance +
    candidate filter + stable sort + scattered selection, given the
    ROW-MAJOR-ordered eligible pixel list and the magnitude/quantized/
    theta values at those pixels (the device half's outputs)."""
    ys = np.asarray(ys)
    xs = np.asarray(xs)
    sel = np.nonzero(greedy_accept(h, w, ys, xs))[0]
    return template_from_strong(
        xs[sel], ys[sel], np.asarray(mag_v)[sel], np.asarray(quant_v)[sel],
        np.asarray(theta_v)[sel], num_features, strong_threshold,
        pyramid_level)


class Candidate:
    __slots__ = ("x", "y", "label", "score", "theta")

    def __init__(self, x, y, label, score, theta):
        self.x, self.y, self.label = x, y, label
        self.score, self.theta = score, theta


def select_scattered_features(candidates, num_features: int,
                              distance: float):
    """Greedy spatially-scattered subset (line2Dup.cpp:163-212), exact.
    Native C++ fast path when available."""
    from ..native import load as _load_native

    lib = _load_native()
    if lib is not None and candidates:
        import ctypes

        xs = np.ascontiguousarray([c.x for c in candidates], np.int32)
        ys = np.ascontiguousarray([c.y for c in candidates], np.int32)
        out = np.zeros(len(candidates), np.int32)
        cnt = lib.sbm_select_scattered(
            len(candidates),
            xs.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            ys.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            int(num_features), ctypes.c_float(distance),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        return [candidates[i] for i in out[:cnt]]

    features = []
    distance_sq = distance * distance
    i = 0
    first_select = True
    while True:
        c = candidates[i]
        keep = True
        for f in features:
            dx = c.x - f.x
            dy = c.y - f.y
            if dx * dx + dy * dy < distance_sq:
                keep = False
                break
        if keep:
            features.append(c)
        i += 1
        if i == len(candidates):
            num_ok = len(features) >= num_features
            if first_select:
                if num_ok:
                    features = []
                    i = 0
                    distance += 1.0
                    distance_sq = distance * distance
                    continue
                first_select = False
            i = 0
            distance -= 1.0
            distance_sq = distance * distance
            if num_ok or distance < 3:
                break
    return features


def rotate_templates_batch(tp, thetas, center_xy, pyramid_levels: int,
                           n_ori: int = 8):
    """Batched addTemplate_rotate: derive ALL rotation angles of one base
    template in a handful of [A, N] numpy ops, crop included.

    Bit-identical to `crop_templates(rotate_template_features(tp, theta,
    ...))` per angle — same IEEE op sequence (f32 adds/subs, f64 rotate
    via math.cos/math.sin per angle so libm matches the scalar path, f32
    narrowing), same C-remainder even-origin crop. The per-call python
    overhead of the scalar path costs ~1.3 ms/rotation (~20 s on a
    10k-angle sweep — the reference's scalar C++ loop, line2Dup.cpp:
    1409-1451, is microseconds per template); here the sweep is one
    vectorized pass + object materialization. Returns a list of CROPPED
    TemplatePyramids in angle order."""
    import math

    f32 = np.float32
    thetas64 = np.asarray(thetas, np.float64)
    A = int(thetas64.shape[0])
    # math.cos/math.sin per angle, not np.cos/np.sin: numpy may route
    # f64 trig through a SIMD libm with last-ulp differences vs the
    # scalar path's libm calls
    cos_a = np.array([math.cos(-t / 180.0 * math.pi)
                      for t in thetas64.tolist()], np.float64)
    sin_a = np.array([math.sin(-t / 180.0 * math.pi)
                      for t in thetas64.tolist()], np.float64)
    th_f32 = thetas64.astype(f32)

    cx, cy = float(center_xy[0]), float(center_xy[1])
    per_level = []
    for l in range(pyramid_levels):
        if l > 0:
            cx = np.float32(np.float32(cx) / np.float32(2)).item()
            cy = np.float32(np.float32(cy) / np.float32(2)).item()
        src = tp[l]
        if src.features:
            px = (np.array([f.x for f in src.features], np.int64)
                  + src.tl_x).astype(f32)
            py = (np.array([f.y for f in src.features], np.int64)
                  + src.tl_y).astype(f32)
            dx = (px - f32(cx)).astype(np.float64)
            dy = (py - f32(cy)).astype(np.float64)
            rx = (cos_a[:, None] * dx[None, :]
                  - sin_a[:, None] * dy[None, :]).astype(f32)
            ry = (sin_a[:, None] * dx[None, :]
                  + cos_a[:, None] * dy[None, :]).astype(f32)
            nx = rx + f32(cx)
            ny = ry + f32(cy)
            fxs = np.trunc(nx + f32(0.5)).astype(np.int64)
            fys = np.trunc(ny + f32(0.5)).astype(np.int64)
            th0 = np.array([f.theta for f in src.features],
                           np.float64).astype(f32)
            th = (th0[None, :] - th_f32[:, None]).astype(f32)
            while np.any(th > 360):
                th = np.where(th > 360, th - f32(360), th).astype(f32)
            while np.any(th < 0):
                th = np.where(th < 0, th + f32(360), th).astype(f32)
            labels = (np.trunc(th * f32(2 * n_ori) / f32(360) + f32(0.5))
                      .astype(np.int64)) & (n_ori - 1)
        else:
            fxs = np.zeros((A, 0), np.int64)
            fys = np.zeros((A, 0), np.int64)
            labels = np.zeros((A, 0), np.int64)
            th = np.zeros((A, 0), f32)
        per_level.append((fxs, fys, labels, th))

    # vectorized crop_templates (template.py:76): joint bbox over levels
    # at level-0 scale, C-remainder even-origin force, per-level rebase
    big = np.int64(1) << 30
    min_x = np.full(A, big, np.int64)
    min_y = np.full(A, big, np.int64)
    max_x = np.full(A, -big, np.int64)
    max_y = np.full(A, -big, np.int64)
    for l, (fxs, fys, _, _) in enumerate(per_level):
        if fxs.shape[1]:
            min_x = np.minimum(min_x, (fxs << l).min(axis=1))
            min_y = np.minimum(min_y, (fys << l).min(axis=1))
            max_x = np.maximum(max_x, (fxs << l).max(axis=1))
            max_y = np.maximum(max_y, (fys << l).max(axis=1))
    min_x = np.where((min_x >= 0) & (min_x % 2 == 1), min_x - 1, min_x)
    min_y = np.where((min_y >= 0) & (min_y % 2 == 1), min_y - 1, min_y)

    out = []
    lvl = []
    for l, (fxs, fys, labels, th) in enumerate(per_level):
        tlx = (min_x >> l).astype(np.int64)
        tly = (min_y >> l).astype(np.int64)
        lvl.append((
            (fxs - tlx[:, None]).tolist(), (fys - tly[:, None]).tolist(),
            labels.tolist(), th.astype(np.float64).tolist(),
            ((max_x - min_x) >> l).tolist(), ((max_y - min_y) >> l).tolist(),
            tlx.tolist(), tly.tolist()))
    for a in range(A):
        tp_new = []
        for l in range(pyramid_levels):
            xs, ys, lbs, ths, ws, hs, tlxs, tlys = lvl[l]
            t = Template(pyramid_level=l, width=ws[a], height=hs[a],
                         tl_x=tlxs[a], tl_y=tlys[a])
            t.features = [Feature(x_, y_, l_, t_) for x_, y_, l_, t_
                          in zip(xs[a], ys[a], lbs[a], ths[a])]
            tp_new.append(t)
        out.append(tp_new)
    return out


def rotate_template_features(tp, theta: float, center_xy,
                             pyramid_levels: int, n_ori: int = 8):
    """addTemplate_rotate feature math (line2Dup.cpp:1395-1451), exact
    float32/double semantics of the C++ (Point2f stores float32; the rotation
    is computed in double then narrowed)."""
    import math

    cx, cy = float(center_xy[0]), float(center_xy[1])
    ang = -theta / 180.0 * math.pi
    cos_a, sin_a = math.cos(ang), math.sin(ang)

    f32 = np.float32
    out = []
    for l in range(pyramid_levels):
        if l > 0:
            # center /= 2 at each level (float division, line2Dup.cpp:1422)
            cx = np.float32(np.float32(cx) / np.float32(2)).item()
            cy = np.float32(np.float32(cy) / np.float32(2)).item()
        src = tp[l]
        t_new = Template(pyramid_level=l)
        if src.features:
            # vectorized over features with the same IEEE op sequence as
            # the scalar C++ (f32 adds/subs, f64 rotate, f32 narrowing) —
            # elementwise identical, ~50x faster for large rotation banks
            px = (np.array([f.x for f in src.features], np.int64)
                  + src.tl_x).astype(f32)
            py = (np.array([f.y for f in src.features], np.int64)
                  + src.tl_y).astype(f32)
            dx = px - f32(cx)
            dy = py - f32(cy)
            # rotate2d: double intermediate, float32 storage
            rx = (cos_a * dx.astype(np.float64)
                  - sin_a * dy.astype(np.float64)).astype(f32)
            ry = (sin_a * dx.astype(np.float64)
                  + cos_a * dy.astype(np.float64)).astype(f32)
            nx = rx + f32(cx)
            ny = ry + f32(cy)
            fxs = np.trunc(nx + f32(0.5)).astype(np.int64)  # toward zero
            fys = np.trunc(ny + f32(0.5)).astype(np.int64)

            th = (np.array([f.theta for f in src.features],
                           np.float64).astype(f32) - f32(theta))
            while np.any(th > 360):
                th = np.where(th > 360, th - f32(360), th).astype(f32)
            while np.any(th < 0):
                th = np.where(th < 0, th + f32(360), th).astype(f32)
            labels = (np.trunc(th * f32(2 * n_ori) / f32(360) + f32(0.5))
                      .astype(np.int64)) & (n_ori - 1)
            t_new.features = [
                Feature(int(fxs[i]), int(fys[i]), int(labels[i]),
                        float(th[i]))
                for i in range(len(src.features))
            ]
        out.append(t_new)
    return out
