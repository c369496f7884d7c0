"""Coarse template scoring as one Pallas kernel on the Triton route.

Computes exactly what ``ops.similarity.coarse_similarity`` computes,

    S[k, j] = sum_n lmflat[off[k, n] + j]      for j < M,

with ``off`` the flat linear-memory offsets of ``_flat_offsets`` (the
reference's accessLinearMemory addressing, line2Dup.cpp:782-825, including
the deliberate wrap across image rows). The XLA route carries a [K, M]
int32 accumulator through device memory once per feature slot; here each
program owns one template x ``block_m`` positions tile, keeps its int32 sum
in registers over every feature slot, and stores the tile once.

* grid: (template, position block), one program per tile, all independent;
* a loop over feature slots, ``F_STEP`` slots per iteration: each slot is a
  contiguous byte load ``lmflat[off + j0 : off + j0 + block_m]`` (the
  [F_STEP, block_m] gather is one masked Triton load);
* loads and the store are masked at ``j < M``. Every offset is at most L
  (the zero row that invalid and out-of-image features point to) and the
  buffer holds L + M bytes, so masked reads never leave it for any M, a
  power of two or not;
* padded feature slots point at the zero row and add nothing.

The program ids are read at the kernel's top level: the interpreter used
by the CPU tests cannot lower ``pl.program_id`` inside a loop body.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

# Feature slots gathered per loop iteration, and the Triton launch
# settings (fixed: no program caller varies them).
F_STEP = 8
NUM_WARPS = 4
NUM_STAGES = 3
# Position-block bounds (powers of two, as Triton requires).
_BM_MAX = 512
_BM_MIN = 128
# Enough programs to give every one of an H100's 132 SMs a few tiles.
_MIN_PROGRAMS = 4 * 132


def block_m_for(K: int, M: int) -> int:
    """Position-block width: the widest power of two in
    [_BM_MIN, _BM_MAX] that still yields _MIN_PROGRAMS programs (small
    banks such as 8 templates x 8191 features need narrow tiles to fill
    the card)."""
    bm = _BM_MAX
    while bm > _BM_MIN and K * (-(-M // bm)) < _MIN_PROGRAMS:
        bm //= 2
    return bm


def _kernel(off_ref, pos_ref, lm_ref, out_ref, *, n_iter: int,
            block_m: int, M: int, mask_positions: bool):
    k = pl.program_id(0)
    j = pl.program_id(1) * block_m + jnp.arange(block_m, dtype=jnp.int32)
    live = j < M
    gmask = jnp.broadcast_to(live[None, :], (F_STEP, block_m))

    def body(i, acc):
        offs = plt.load(off_ref.at[k, pl.ds(i * F_STEP, F_STEP)])
        idx = offs[:, None] + j[None, :]
        v = plt.load(lm_ref.at[idx], mask=gmask, other=0)
        return acc + jnp.sum(v.astype(jnp.int32), axis=0)

    acc = jax.lax.fori_loop(0, n_iter, body,
                            jnp.zeros((block_m,), jnp.int32))
    store = live
    if mask_positions:
        acc = jnp.where(j < plt.load(pos_ref.at[k]), acc, 0)
    plt.store(out_ref.at[k, pl.ds(pl.program_id(1) * block_m, block_m)],
              acc, mask=store)


@partial(jax.jit, static_argnames=("M", "mask_positions", "block_m",
                                   "interpret"))
def coarse_scores_triton(off: jnp.ndarray, positions: jnp.ndarray,
                         lmflat: jnp.ndarray, M: int,
                         mask_positions: bool = True,
                         block_m: int | None = None,
                         interpret: bool = False) -> jnp.ndarray:
    """[K, N] flat offsets (invalid slots = L) -> [K, M] int32 scores.

    `lmflat` is the [L + M] uint8 linear-memory buffer whose last M bytes
    are zero. With `mask_positions`, positions j >= positions[k] read 0
    (coarse_similarity's masking)."""
    K, N = off.shape
    L = lmflat.shape[0] - M
    n_pad = -(-N // F_STEP) * F_STEP
    if n_pad != N:
        off = jnp.pad(off, ((0, 0), (0, n_pad - N)), constant_values=L)
    bm = block_m or block_m_for(K, M)
    kernel = partial(_kernel, n_iter=n_pad // F_STEP, block_m=bm, M=M,
                     mask_positions=mask_positions)
    return pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct((K, M), jnp.int32),
        grid=(K, -(-M // bm)),
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=NUM_WARPS,
                                           num_stages=NUM_STAGES),
        interpret=interpret,
        name="coarse_scores",
    )(off, positions.astype(jnp.int32), lmflat)
