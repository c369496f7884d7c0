"""Replica of OpenCV's fastAtan2 so orientation bins match the reference.

cv::phase(dx, dy, degrees=true) (used at line2Dup.cpp:327,398) computes angles
with cv::fastAtan2 — a degree-7 polynomial approximation, NOT a true atan2.
Quantization into 16 buckets happens downstream via round(angle * 16/360), so
we must reproduce the same polynomial (max observed deviation vs cv2 is
~3e-5 degrees from FMA/ordering differences; a bucket flip requires the true
angle to sit within 3e-5° of a 22.5° boundary, which is negligible).
"""

from __future__ import annotations

import math

import jax.numpy as jnp
import numpy as np

# Plain Python floats (cast at use): jnp scalars would be captured
# closure constants, which Pallas kernels reject.
_P1 = float(np.float32(0.9997878412794807 * (180.0 / math.pi)))
_P3 = float(np.float32(-0.3258083974640975 * (180.0 / math.pi)))
_P5 = float(np.float32(0.1555786518463281 * (180.0 / math.pi)))
_P7 = float(np.float32(-0.04432655554792128 * (180.0 / math.pi)))
_DBL_EPS = 2.220446049250313e-16


def phase_deg(dx: jnp.ndarray, dy: jnp.ndarray) -> jnp.ndarray:
    """Angle in degrees in [0, 360), cv::fastAtan2 semantics, float32."""
    x = dx.astype(jnp.float32)
    y = dy.astype(jnp.float32)
    ax = jnp.abs(x)
    ay = jnp.abs(y)
    eps = jnp.float32(_DBL_EPS)
    c = jnp.where(ax >= ay, ay / (ax + eps), ax / (ay + eps))
    c2 = c * c
    a = (((jnp.float32(_P7) * c2 + jnp.float32(_P5)) * c2
          + jnp.float32(_P3)) * c2 + jnp.float32(_P1)) * c
    a = jnp.where(ax < ay, jnp.float32(90.0) - a, a)
    a = jnp.where(x < 0, jnp.float32(180.0) - a, a)
    a = jnp.where(y < 0, jnp.float32(360.0) - a, a)
    return a


def exact_ratio_f32(num: jnp.ndarray, den: jnp.ndarray) -> jnp.ndarray:
    """Correctly rounded float32 num / den for integers 0 <= num < 2**24,
    1 <= den < 2**16 — the IEEE quotient the reference's CPU computes
    for scores (raw * 100.f) / (4 * nfeat), line2Dup.cpp:1206.

    XLA on an NVIDIA GPU lowers float32 division to an approximate
    instruction (up to 2 ulp off: measured on an H100, 27% of score
    quotients differed by one ulp), which changes match scores and the
    threshold boundary. Here the quotient is formed by integer long
    division: X = floor(num / den * 2**F) with F chosen so that X has
    29-30 bits, the remainder ORed into its lowest bit as a sticky bit,
    then one correctly rounded int -> float conversion and an exact
    scale by 2**-F. Elementwise and unrolled (one fused kernel).
    """
    import jax

    num = num.astype(jnp.int32)
    den = den.astype(jnp.int32)
    approx = num.astype(jnp.float32) / den.astype(jnp.float32)
    _, e = jnp.frexp(approx)                 # approx in [2**(e-1), 2**e)
    F = jnp.where(num > 0, 30 - e, 0)        # 5 <= F <= 45 in range
    X = num // den
    r = num % den
    for i in range(46):
        active = i < F
        r2 = 2 * r
        ge = r2 >= den
        r = jnp.where(active, jnp.where(ge, r2 - den, r2), r)
        X = jnp.where(active, 2 * X + ge.astype(jnp.int32), X)
    X = X | (r != 0).astype(jnp.int32)
    scale = jax.lax.bitcast_convert_type((127 - F) << 23, jnp.float32)
    return X.astype(jnp.float32) * scale
