"""Bit-exact separable image filters in JAX.

These reproduce the exact integer/fixed-point arithmetic OpenCV uses on uint8
images so that downstream orientation quantization matches the C++ reference
(line2Dup.cpp:313-404) to the last bit:

* ``gaussian_blur7_u8`` — cv::GaussianBlur(ksize=7, sigma=0, BORDER_REPLICATE)
  on CV_8U runs OpenCV's bit-exact fixed-point path: the "small gaussian"
  kernel [2,7,14,18,14,7,2]/64 scaled to Q8 ([8,28,56,72,56,28,8]), full
  int32 accumulation, single final rounding ``(acc + 2^15) >> 16``.
* ``sobel3_*`` — cv::Sobel(ksize=3, BORDER_REPLICATE): separable
  smooth [1,2,1] ⊗ diff [-1,0,1]; exact in int32 / float32.
* ``pyr_down_u8`` — cv::pyrDown: 5-tap [1,4,6,4,1]/16 separable kernel,
  BORDER_REFLECT_101, fixed-point ``(acc + 128) >> 8``, take even pixels.
* ``resize_nearest`` — cv::resize INTER_NEAREST: src index = floor(i*scale).
* ``erode3_u8`` — cv::erode 3x3 rect kernel, BORDER_REPLICATE.

All functions are jittable with static shapes and use exact integer math.
They accept [H, W] or [H, W, C] arrays.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# OpenCV small-gaussian kernel for ksize=7 in Q8 fixed point (sums to 256).
_GAUSS7_Q8 = (8, 28, 56, 72, 56, 28, 8)
# cv::pyrDown 5-tap kernel (sums to 16).
_PYR5 = (1, 4, 6, 4, 1)


def _sep_axis(x: jnp.ndarray, taps, axis: int) -> jnp.ndarray:
    """Correlate `x` (already padded along `axis`) with integer taps."""
    n = len(taps)
    size = x.shape[axis] - (n - 1)
    acc = None
    for i, t in enumerate(taps):
        sl = jax.lax.slice_in_dim(x, i, i + size, axis=axis)
        term = sl if t == 1 else sl * t
        acc = term if acc is None else acc + term
    return acc


def _pad_axis(x: jnp.ndarray, k: int, axis: int, mode: str) -> jnp.ndarray:
    if mode == "reflect":
        # BORDER_REFLECT_101 via explicit slices (a concat of slices,
        # never a gather).
        lo = jax.lax.slice_in_dim(x, 1, k + 1, axis=axis)
        lo = jax.lax.rev(lo, (axis,))
        n = x.shape[axis]
        hi = jax.lax.slice_in_dim(x, n - k - 1, n - 1, axis=axis)
        hi = jax.lax.rev(hi, (axis,))
        return jnp.concatenate([lo, x, hi], axis=axis)
    pad = [(0, 0)] * x.ndim
    pad[axis] = (k, k)
    return jnp.pad(x, pad, mode=mode)


def gaussian_blur7_u8(img: jnp.ndarray) -> jnp.ndarray:
    """cv::GaussianBlur(img, 7x7, sigma=0, BORDER_REPLICATE) on uint8.

    Bit-exact vs OpenCV's fixed-point uint8 path (verified empirically against
    cv2 4.6/5.0). Reference call site: line2Dup.cpp:320.
    """
    x = img.astype(jnp.int32)
    x = _pad_axis(x, 3, 1, "edge")
    x = _sep_axis(x, _GAUSS7_Q8, 1)
    x = _pad_axis(x, 3, 0, "edge")
    x = _sep_axis(x, _GAUSS7_Q8, 0)
    return ((x + (1 << 15)) >> 16).astype(jnp.uint8)


def sobel3_f32(img_u8: jnp.ndarray, dx: bool) -> jnp.ndarray:
    """cv::Sobel(img, CV_32F, 1/0, 0/1, ksize=3, BORDER_REPLICATE).

    Used on the blurred gray image (line2Dup.cpp:324-325). Values are small
    integers; float32 holds them exactly.
    """
    x = img_u8.astype(jnp.int32)
    smooth = (1, 2, 1)
    diff = (-1, 0, 1)
    if dx:
        x = _sep_axis(_pad_axis(x, 1, 0, "edge"), smooth, 0)
        x = _sep_axis(_pad_axis(x, 1, 1, "edge"), diff, 1)
    else:
        x = _sep_axis(_pad_axis(x, 1, 1, "edge"), smooth, 1)
        x = _sep_axis(_pad_axis(x, 1, 0, "edge"), diff, 0)
    return x.astype(jnp.float32)


def sobel3_i32(img_u8: jnp.ndarray, dx: bool) -> jnp.ndarray:
    """cv::Sobel(..., CV_16S, ...) as int32 (identical values; no overflow).

    Used on the blurred color image per channel (line2Dup.cpp:343-344).
    """
    x = img_u8.astype(jnp.int32)
    smooth = (1, 2, 1)
    diff = (-1, 0, 1)
    if dx:
        x = _sep_axis(_pad_axis(x, 1, 0, "edge"), smooth, 0)
        x = _sep_axis(_pad_axis(x, 1, 1, "edge"), diff, 1)
    else:
        x = _sep_axis(_pad_axis(x, 1, 1, "edge"), smooth, 1)
        x = _sep_axis(_pad_axis(x, 1, 0, "edge"), diff, 0)
    return x


def _pyr_band(n_in: int, n_out: int) -> "np.ndarray":
    """[n_in, n_out] banded 5-tap pyrDown matrix with BORDER_REFLECT_101:
    out[j] = sum_k tap[k] * in[reflect(2j + k - 2)]."""
    import numpy as np

    B = np.zeros((n_in, n_out), np.float32)
    for j in range(n_out):
        for k, t in enumerate(_PYR5):
            x = 2 * j + k - 2
            if x < 0:
                x = -x
            elif x >= n_in:
                x = 2 * n_in - 2 - x
            B[x, j] += t
    return B


def pyr_down_u8(img: jnp.ndarray) -> jnp.ndarray:
    """cv::pyrDown(img, size/2) on uint8, bit-exact.

    Reference call site: line2Dup.cpp:433. Output size is (H//2, W//2)
    (the reference passes Size(cols/2, rows/2) explicitly).

    The filter+decimate is a pair of banded one-sided bf16 matmuls with
    f32 accumulation (measured slightly faster on an H100 than int32
    shifted adds with stride-2 taps; PERF.md). Bit-exactness:
    uint8 pixels and taps {1,4,6,4,1} are exact in bf16 and all integer
    partial sums stay < 2^24 (exact in the f32 accumulator); the horizontal
    result (<= 4080) is split hi/lo into two exact-bf16 factors for the
    vertical pass.
    """
    import numpy as np

    h, w = img.shape[:2]
    h2, w2 = h // 2, w // 2
    Hb = jnp.asarray(_pyr_band(w, w2), jnp.bfloat16)          # [W, W2]
    Vb = jnp.asarray(_pyr_band(h, h2).T, jnp.bfloat16)        # [H2, H]

    x = img.astype(jnp.bfloat16)
    if x.ndim == 3:
        x = jnp.moveaxis(x, 2, 0)                             # [C, H, W]
    t = jnp.matmul(x, Hb, preferred_element_type=jnp.float32)  # <= 4080
    t_hi = jnp.floor(t * jnp.float32(1 / 16))
    t_lo = t - t_hi * 16
    acc = (jnp.matmul(Vb, t_hi.astype(jnp.bfloat16),
                      preferred_element_type=jnp.float32) * 16
           + jnp.matmul(Vb, t_lo.astype(jnp.bfloat16),
                        preferred_element_type=jnp.float32))
    out = jnp.floor((acc + 128) * jnp.float32(1 / 256)).astype(jnp.uint8)
    if img.ndim == 3:
        out = jnp.moveaxis(out, 0, 2)
    return out


def resize_nearest(img: jnp.ndarray, out_hw) -> jnp.ndarray:
    """cv::resize(..., INTER_NEAREST): src = min(floor(dst*scale), src_len-1).

    Used for mask downsampling in the pyramid (line2Dup.cpp:439).
    """
    oh, ow = out_hw
    h, w = img.shape[:2]
    ys = jnp.minimum(jnp.floor(jnp.arange(oh) * (h / oh)).astype(jnp.int32), h - 1)
    xs = jnp.minimum(jnp.floor(jnp.arange(ow) * (w / ow)).astype(jnp.int32), w - 1)
    return img[ys][:, xs]


def erode3_u8(img: jnp.ndarray) -> jnp.ndarray:
    """cv::erode(img, Mat(), 1, BORDER_REPLICATE): 3x3 min filter.

    Reference call site: line2Dup.cpp:458 (template mask erosion).
    """
    x = _pad_axis(img, 1, 0, "edge")
    x = jnp.minimum(jnp.minimum(x[:-2], x[1:-1]), x[2:])
    x = _pad_axis(x, 1, 1, "edge")
    x = jnp.minimum(jnp.minimum(x[:, :-2], x[:, 1:-1]), x[:, 2:])
    return x
