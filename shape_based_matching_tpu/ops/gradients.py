"""Gradient extraction + 8-bin orientation quantization (LINE-2D front end).

Vectorized reformulation of the reference's hysteresisGradient /
quantizedOrientations (line2Dup.cpp:218-404):

* the scalar 3x3-histogram majority vote becomes a one-hot vote tensor summed
  over the 9 neighbor shifts — a handful of fused elementwise ops instead of a
  per-pixel loop;
* the color path's "use the channel with the largest squared magnitude"
  becomes a vectorized argmin-free select with the reference's exact tie
  rules (ch0 wins ties vs ch1/ch2; ch1 wins ties vs ch2; line2Dup.cpp:370-387);
* magnitudes stay *squared* (the reference never takes the sqrt; thresholds
  are compared squared: line2Dup.cpp:326,328).

Outputs match the C++ bit-for-bit given the bit-exact filters in filters.py
(up to the ~3e-5° fastAtan2 note in fastmath.py).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from .fastmath import phase_deg
from .filters import gaussian_blur7_u8, sobel3_f32, sobel3_i32


class QuantizedGradients(NamedTuple):
    """Per-level gradient state (mirror of ColorGradientPyramid fields,
    line2Dup.h:185-191)."""

    magnitude: jnp.ndarray  # [H, W] float32, SQUARED gradient magnitude
    angle: jnp.ndarray      # [H, W] uint8, single-bit quantized orientation
    angle_ori: jnp.ndarray  # [H, W] float32, raw angle in degrees


def orientation_bins(angle_deg: jnp.ndarray, n_ori: int = 8) -> jnp.ndarray:
    """Raw orientation bucket of each angle, before the border mask and
    the vote: convertTo(CV_8U/CV_16U, 2*n_ori/360) rounds half-to-even
    (cvRound)."""
    return jnp.round(angle_deg
                     * jnp.float32(2.0 * n_ori / 360.0)).astype(jnp.int32)


def hysteresis_quantize(magnitude: jnp.ndarray, angle_deg: jnp.ndarray,
                        threshold_sq: jnp.ndarray,
                        n_ori: int = 8,
                        patch_2843: bool = False) -> jnp.ndarray:
    """n_ori-bin quantization with 3x3 majority vote (line2Dup.cpp:218-311;
    n_ori=16 follows the ori_16bit_experiment fork:
    line2Dup_16bit_ori.cpp:216-297).

    1. bucket = round_half_even(angle * 2*n_ori/360), borders zeroed,
       & (n_ori-1).
    2. keep pixel only if magnitude > threshold_sq,
    3. 3x3 neighborhood vote: bin with most votes (lowest index wins ties)
       must have >= 5 of 9 votes; output is 1 << bin (uint8 for 8 bins,
       uint16 for 16), else 0.

    patch_2843 (the opencv_contrib #2843 variant, line2Dup.cpp:9,239-257,
    compile-time-disabled in the reference): neighbors whose magnitude is
    <= threshold vote in shadow bins that the argmax ignores, i.e. weak
    pixels contribute no orientation votes.
    """
    h, w = angle_deg.shape
    q16 = orientation_bins(angle_deg, n_ori)
    # Zero borders, then mask to 3 bits (16 -> 0 like the reference's &7).
    border = (
        (jnp.arange(h)[:, None] > 0)
        & (jnp.arange(h)[:, None] < h - 1)
        & (jnp.arange(w)[None, :] > 0)
        & (jnp.arange(w)[None, :] < w - 1)
    )
    q8 = jnp.where(border, q16 & (n_ori - 1), 0).astype(jnp.int32)
    if patch_2843:
        # weak pixels vote in ignored shadow bins == no vote at all
        weak = magnitude <= threshold_sq
        q8 = jnp.where(border & weak, q8 + n_ori, q8)

    # 3x3 neighborhood vote histogram, nibble-packed: bin counters live in
    # one uint32 (8 bins) or a pair of uint32s (16 bins) per pixel (counts
    # <= 9 < 16 never overflow a nibble), so the 9-tap accumulation is 9
    # shifted u32 adds instead of a [H, W, n_ori] one-hot tensor. Padding
    # contributes no votes, but padded taps are only visible at border
    # pixels, which are masked out anyway.
    def packed_votes(bins):
        packed = (jnp.uint32(1) << (jnp.uint32(4) * bins.astype(jnp.uint32)))
        p = jnp.pad(packed, ((1, 1), (1, 1)))
        return sum(p[i : i + h, j : j + w]
                   for i in range(3) for j in range(3))

    if patch_2843:
        # count votes only for the real (non-shadow) bins
        packed = jnp.where(
            q8 < n_ori,
            jnp.uint32(1) << (jnp.uint32(4) * (q8 % 8).astype(jnp.uint32)),
            jnp.uint32(0))
        if n_ori <= 8:
            p = jnp.pad(packed, ((1, 1), (1, 1)))
            votes = (sum(p[i : i + h, j : j + w]
                         for i in range(3) for j in range(3)),)
        else:
            plo = jnp.pad(jnp.where(q8 < 8, packed, jnp.uint32(0)),
                          ((1, 1), (1, 1)))
            phi = jnp.pad(jnp.where((q8 >= 8) & (q8 < 16), packed,
                                    jnp.uint32(0)), ((1, 1), (1, 1)))
            votes = (
                sum(plo[i : i + h, j : j + w]
                    for i in range(3) for j in range(3)),
                sum(phi[i : i + h, j : j + w]
                    for i in range(3) for j in range(3)),
            )
    elif n_ori <= 8:
        votes = (packed_votes(q8),)
    else:
        lo = jnp.where(q8 < 8, q8, 0)
        hi = jnp.where(q8 >= 8, q8 - 8, 0)
        # split votes: a pixel votes in exactly one half; the other half
        # must receive NO vote, so encode "no vote" via a zero add mask.
        packed_lo = jnp.where(
            q8 < 8, jnp.uint32(1) << (jnp.uint32(4) * lo.astype(jnp.uint32)),
            jnp.uint32(0))
        packed_hi = jnp.where(
            q8 >= 8, jnp.uint32(1) << (jnp.uint32(4) * hi.astype(jnp.uint32)),
            jnp.uint32(0))
        plo = jnp.pad(packed_lo, ((1, 1), (1, 1)))
        phi = jnp.pad(packed_hi, ((1, 1), (1, 1)))
        votes = (
            sum(plo[i : i + h, j : j + w] for i in range(3) for j in range(3)),
            sum(phi[i : i + h, j : j + w] for i in range(3) for j in range(3)),
        )

    # first max wins (C++ scans bins ascending with strict >)
    max_votes = jnp.zeros(votes[0].shape, dtype=jnp.uint32)
    best_bin = jnp.zeros(votes[0].shape, dtype=jnp.uint32)
    for b in range(n_ori):
        word = votes[b // 8]
        cnt = (word >> jnp.uint32(4 * (b % 8))) & jnp.uint32(15)
        better = cnt > max_votes
        max_votes = jnp.where(better, cnt, max_votes)
        best_bin = jnp.where(better, jnp.uint32(b), best_bin)

    ok = border & (magnitude > threshold_sq) & (max_votes >= 5)
    out = jnp.where(ok, (jnp.uint32(1) << best_bin), jnp.uint32(0))
    return out.astype(jnp.uint8 if n_ori <= 8 else jnp.uint16)


@partial(jax.jit, static_argnames=("n_ori", "patch_2843"))
def quantized_orientations_gray(src: jnp.ndarray,
                                weak_threshold: jnp.ndarray,
                                n_ori: int = 8,
                                patch_2843: bool = False
                                ) -> QuantizedGradients:
    """Gray path of quantizedOrientations (line2Dup.cpp:322-330)."""
    smoothed = gaussian_blur7_u8(src)
    dx = sobel3_f32(smoothed, dx=True)
    dy = sobel3_f32(smoothed, dx=False)
    magnitude = dx * dx + dy * dy
    ang = phase_deg(dx, dy)
    quant = hysteresis_quantize(magnitude, ang,
                                jnp.float32(weak_threshold) ** 2, n_ori,
                                patch_2843)
    return QuantizedGradients(magnitude, quant, ang)


@partial(jax.jit, static_argnames=("n_ori", "patch_2843"))
def quantized_orientations_color(src: jnp.ndarray,
                                 weak_threshold: jnp.ndarray,
                                 n_ori: int = 8,
                                 patch_2843: bool = False
                                 ) -> QuantizedGradients:
    """Color path: per-channel CV_16S Sobel, pick the max-|grad|^2 channel
    with the reference's exact tie-breaking (line2Dup.cpp:331-401)."""
    smoothed = gaussian_blur7_u8(src)
    dx3 = sobel3_i32(smoothed, dx=True)   # [H, W, 3] int32
    dy3 = sobel3_i32(smoothed, dx=False)
    mag3 = dx3 * dx3 + dy3 * dy3

    m0, m1, m2 = mag3[..., 0], mag3[..., 1], mag3[..., 2]
    pick0 = (m0 >= m1) & (m0 >= m2)
    pick1 = (~pick0) & (m1 >= m0) & (m1 >= m2)
    sel = jnp.where(pick0, 0, jnp.where(pick1, 1, 2))
    dx = jnp.take_along_axis(dx3, sel[..., None], axis=-1)[..., 0]
    dy = jnp.take_along_axis(dy3, sel[..., None], axis=-1)[..., 0]
    magnitude = jnp.take_along_axis(mag3, sel[..., None], axis=-1)[..., 0]
    magnitude = magnitude.astype(jnp.float32)

    ang = phase_deg(dx.astype(jnp.float32), dy.astype(jnp.float32))
    quant = hysteresis_quantize(magnitude, ang,
                                jnp.float32(weak_threshold) ** 2, n_ori,
                                patch_2843)
    return QuantizedGradients(magnitude, quant, ang)


def quantized_orientations(src: jnp.ndarray, weak_threshold: float,
                           n_ori: int = 8) -> QuantizedGradients:
    """Dispatch on channel count like modality->process (line2Dup.cpp:313)."""
    if src.ndim == 2:
        return quantized_orientations_gray(src, jnp.float32(weak_threshold),
                                           n_ori)
    if src.ndim == 3 and src.shape[-1] == 3:
        return quantized_orientations_color(src, jnp.float32(weak_threshold),
                                            n_ori)
    raise ValueError(f"expected [H,W] gray or [H,W,3] color, got {src.shape}")
