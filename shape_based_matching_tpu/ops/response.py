"""Orientation spreading, cosine-response maps, and the linear layout.

Reference semantics (line2Dup.cpp:583-777):

* ``spread``: OR each pixel's orientation bitmask into every position of the
  T×T window *up-left* of it — i.e. dst[r,c] = OR_{0<=dr,dc<T} src[r+dr,c+dc]
  with zeros beyond the image. The reference runs T² full-image SIMD OR
  passes; OR is separable, so we do T row-shift ORs then T column-shift ORs
  (2T passes, fused by XLA).

* ``response_maps``: for orientation ``ori``, the 256-entry SIMILARITY_LUT
  (line2Dup.cpp:632-635) evaluates max over set bits b of w(dist(b, ori)) with
  w(0)=4, w(1)=3, else 0 (responses in {0,3,4}). Instead of a byte LUT +
  shuffle we compute it directly from three bit tests — pure uint8 ops.

* ``linearize``: the reference reorders each response map into T² rows of the
  T-decimated image so a template shift is a contiguous row read
  (line2Dup.cpp:749-777). Here this is a reshape/transpose to
  ``[8, T*T, H/T * W/T]``; the similarity scorers consume the flattened
  ``[8*T*T*M]`` view so the reference's flat-offset (row-wrapping) semantics
  are preserved exactly (line2Dup.cpp:825,949 keep wrapped positions).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp


def _shift_or_axis(x: jnp.ndarray, T: int, axis: int) -> jnp.ndarray:
    """acc[i] = OR_{0<=d<T} x[i+d] (zeros beyond) via log-doubling:
    ceil(log2 T) shifted ORs instead of T-1."""
    acc = x
    covered = 1
    while covered < T:
        d = min(covered, T - covered)
        if axis == 0:
            shifted = jnp.zeros_like(acc).at[: -d, :].set(acc[d:, :])
        else:
            shifted = jnp.zeros_like(acc).at[:, : -d].set(acc[:, d:])
        acc = acc | shifted
        covered += d
    return acc


@partial(jax.jit, static_argnames=("T",))
def spread(quantized: jnp.ndarray, T: int) -> jnp.ndarray:
    """OR orientations over the T×T window (line2Dup.cpp:616-630)."""
    return _shift_or_axis(_shift_or_axis(quantized, T, 0), T, 1)


@partial(jax.jit, static_argnames=("n_ori",))
def response_maps(spread_img: jnp.ndarray, n_ori: int = 8) -> jnp.ndarray:
    """[n_ori, H, W] uint8 cosine responses.

    n_ori=8 (line2Dup.cpp:637-747): response[ori] = 4 if bit ori set, else 3
    if an adjacent bit (ori±1 mod 8) is set, else 0 — exactly the
    SIMILARITY_LUT table semantics.

    n_ori=16: matches the COMPILED experiment exactly
    (tests/test_golden_16ori.py), including two facts discovered by
    compiling it:
    * the SIMILARITY_LUT it vendors (line2Dup_16bit_ori.cpp:575-608) maps
      circular bin distance d to 4 (d <= 2), 1 (d in {3, 4}), 0 (d >= 5)
      — NOT the graded 8..0 table LUT_gen.cpp emits (committed as
      LUT16.txt but never wired in);
    * its nibble split extracts the top segment with
      ``(src & (15 << 16)) >> 16`` (line2Dup_16bit_ori.cpp:639) — always
      zero for a ushort — so spread bits 12..15 NEVER contribute a
      response. Reproduced here by masking them out.
    """
    s = spread_img.astype(jnp.int32)  # [H, W]
    if n_ori == 8:
        oris = jnp.arange(8, dtype=jnp.int32)
        exact = (s[None] >> oris[:, None, None]) & 1
        left = (s[None] >> ((oris + 1) & 7)[:, None, None]) & 1
        right = (s[None] >> ((oris - 1) & 7)[:, None, None]) & 1
        adj = left | right
        resp = jnp.where(exact == 1, 4, jnp.where(adj == 1, 3, 0))
        return resp.astype(jnp.uint8)

    live = 0xFFF  # bits 12..15 are dead (the reference's 15<<16 bug)
    planes = []
    for ori in range(n_ori):
        near = 0  # live bits within distance 2 -> response 4
        for d in (-2, -1, 0, 1, 2):
            near |= 1 << ((ori + d) % n_ori)
        mid = 0  # live bits at distance 3..4 -> response 1
        for d in (-4, -3, 3, 4):
            mid |= 1 << ((ori + d) % n_ori)
        resp = jnp.where((s & (near & live)) > 0, 4,
                         jnp.where((s & (mid & live)) > 0, 1, 0))
        planes.append(resp)
    return jnp.stack(planes).astype(jnp.uint8)


@partial(jax.jit, static_argnames=("T",))
def linearize(resp: jnp.ndarray, T: int) -> jnp.ndarray:
    """[n, H, W] planes -> [n, T*T, M] linear memories, M = (H/T)*(W/T).

    Row (ty*T + tx) of plane `ori` holds resp[ori, ty::T, tx::T] flattened
    row-major — identical layout to the reference's linear memories so flat
    offsets agree byte-for-byte. A reshape/transpose: measured faster on
    an H100 than a one-hot selector matmul (PERF.md).
    """
    n_ori, h, w = resp.shape
    assert h % T == 0 and w % T == 0, (h, w, T)
    hd, wd = h // T, w // T
    x = resp.reshape(n_ori, hd, T, wd, T).transpose(0, 2, 4, 1, 3)
    return x.reshape(n_ori, T * T, hd * wd)


@partial(jax.jit, static_argnames=("T", "n_ori"))
def build_linear_memories(quantized: jnp.ndarray, T: int,
                          n_ori: int = 8) -> jnp.ndarray:
    """Fused quantized -> spread -> responses -> linear memories.

    Linearizes the ONE spread plane and applies the pointwise response
    to its [T*T, M] rows: linearize is a permutation and the response is
    pointwise, so the bytes equal ``linearize(response_maps(sp), T)``
    while moving n_ori x less data through the permutation."""
    sp = spread(quantized, T)
    return response_maps(linearize(sp[None], T)[0], n_ori)
