"""Kernel-versus-XLA timings on the GPU, at the shapes the benchmark uses.

    python tools/kernel_ab.py [--small] [--out chiprun_out/kernel_ab.json]

For each coarse-scoring shape it checks the Triton kernel against the XLA
scan (exact int32 equality) and times both, plus a one-fusion gather-and-sum
form of the XLA route; it also times the whole match step with each scorer
and the frontend pyramid, and the kernel's position-block widths at
K=1000. Each check prints a line; the JSON record names the device and
the card's power limit.

`--small` runs tiny shapes on the CPU (kernel interpreted) to rehearse the
script; its times say nothing about the GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "no nvidia-smi"


def _time(fn, reps: int = 20, inner: int = 1) -> float:
    """Median ms per call: `inner` calls dispatched back to back, then one
    block_until_ready, repeated `reps` times."""
    import jax

    jax.block_until_ready(fn())
    jax.block_until_ready(fn())
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = None
        for _ in range(inner):
            out = fn()
        jax.block_until_ready(out)
        ts.append((time.perf_counter() - t0) * 1e3 / inner)
    return float(np.median(ts))


def _gather_sum(lmflat, off, M, positions, mask):
    import jax.numpy as jnp

    j = jnp.arange(M, dtype=jnp.int32)
    S = jnp.sum(lmflat[off[:, :, None] + j[None, None, :]], axis=1,
                dtype=jnp.int32)
    if mask:
        S = jnp.where(j[None, :] < positions[:, None], S, 0)
    return S


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out",
                                                  "kernel_ab.json"))
    args = ap.parse_args()

    import jax

    if args.small:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from shape_based_matching_tpu.models.detector import _build_lm_pyramid
    from shape_based_matching_tpu.ops.pallas.similarity_triton import (
        coarse_scores_triton)
    from shape_based_matching_tpu.ops.similarity import (
        _flat_offsets, _positions, coarse_similarity, gather_bank)
    from shape_based_matching_tpu.utils import dispatch
    from shape_based_matching_tpu.utils.synthetic import (
        build_rotated_detector, scene_caps, synthetic_scene)

    dev = jax.devices()[0]
    interp = args.small
    card = _card()
    rec = {"device": {"platform": dev.platform, "kind": dev.device_kind,
                      "count": len(jax.devices())},
           "card": card, "jax": jax.__version__, "rows": []}
    print(f"# {card} | {dev.platform} {dev.device_kind} jax {jax.__version__}",
          flush=True)

    def row(**kw):
        rec["rows"].append(kw)
        print(f"# {card} | " + json.dumps(kw), flush=True)

    side = 256 if args.small else 1024
    reps = 2 if args.small else 20

    banks_cfg = ([("rot24x63", dict(num_templates=24, num_features=63,
                                          size=96))]
                 if args.small else
                 [("rot360x63", dict(num_templates=360, num_features=63)),
                  ("rot1000x63", dict(num_templates=1000, num_features=63)),
                  ("rot10000x63", dict(num_templates=10000,
                                       num_features=63)),
                  ("rot1000x128", dict(num_templates=1000,
                                       num_features=128)),
                  ("rot8x8191", dict(num_templates=8, num_features=8191,
                                     size=768, dense=True)),
                  ("rot360x63_ori16", dict(num_templates=360,
                                           num_features=63, n_ori=16))])

    for name, cfg in banks_cfg:
        det, templ = build_rotated_detector(**cfg, cache=not args.small)
        scene = synthetic_scene(side, side, templ, n_instances=4)
        banks = det._get_banks("bench")
        T = det.T_at_level
        lms = _build_lm_pyramid(jnp.asarray(scene), jnp.zeros((1, 1),
                                jnp.uint8), True, False, T, 2,
                                jnp.float32(30.0), det.num_orientations)
        levels = [(1, banks[1], (side // 2, side // 2))]
        # fine-level map pass: D=64 distinct templates over the full frame
        K = int(banks[0].fx.shape[0])
        D = min(64, K)
        levels.append((0, gather_bank(banks[0], jnp.arange(D)), (side,
                                                                  side)))
        for lvl, bank, size in levels:
            t = T[lvl]
            lm, lmflat = lms[lvl]
            n_ori = int(lm.shape[0])
            W, H = size[0] // t, size[1] // t
            M = W * H
            off = _flat_offsets(bank, t, W, M, size, n_ori)
            pos = _positions(bank, t, W, H)
            ref, _ = coarse_similarity(lmflat, bank, t, size,
                                       mask_positions=False, n_ori=n_ori)
            got = coarse_scores_triton(off, pos, lmflat, M,
                                       mask_positions=False,
                                       interpret=interp)
            eq = bool(jnp.array_equal(ref, got))
            r = dict(stage="coarse" if lvl == 1 else "fine_map",
                     bank=name, K=int(bank.fx.shape[0]),
                     N=int(bank.fx.shape[1]), M=M, kernel_eq_xla=eq)
            if not args.small or lvl == 1:
                r["kernel_ms"] = _time(lambda: coarse_scores_triton(
                    off, pos, lmflat, M, mask_positions=False,
                    interpret=interp), reps, 5)
                r["xla_scan_ms"] = _time(lambda: coarse_similarity(
                    lmflat, bank, t, size, mask_positions=False,
                    n_ori=n_ori)[0], reps, 2)
                if int(bank.fx.shape[0]) * int(bank.fx.shape[1]) * M \
                        <= 2 ** 31:
                    gs = jax.jit(_gather_sum, static_argnums=(2, 4))
                    r["xla_gather_sum_eq"] = bool(jnp.array_equal(
                        ref, gs(lmflat, off, M, pos, False)))
                    r["xla_gather_sum_ms"] = _time(
                        lambda: gs(lmflat, off, M, pos, False), reps, 2)
            row(**r)
        if name == "rot1000x63":
            # position-block width at K=1000 (the launch settings are
            # fixed module constants)
            t = T[1]
            lmflat = lms[1][1]
            W = side // 2 // t
            M = W * W
            off = _flat_offsets(banks[1], t, W, M, (side // 2, side // 2))
            pos = _positions(banks[1], t, W, W)
            for bm in (128, 256, 512, 1024):
                row(stage="block_m", K=int(banks[1].fx.shape[0]),
                    block_m=bm, kernel_ms=_time(
                        lambda: coarse_scores_triton(
                            off, pos, lmflat, M, mask_positions=False,
                            block_m=bm, interpret=interp), reps, 5))

        # whole match step, each scorer. `match` runs with its default
        # candidate caps (frames over them re-run through the exact
        # escalating path, counted); the batched program runs at caps
        # that hold every candidate, and its timed output's overflow
        # flags are counted: a non-zero count marks a truncated result.
        if name in ("rot360x63", "rot1000x63", "rot10000x63", "rot8x8191",
                    "rot24x63"):
            cand, dist = scene_caps(det.num_templates())
            out = {}
            for up in (True, False):
                det.use_pallas = up
                det.pallas_interpret = interp
                det._banks.clear()
                det._bank_maxdims.clear()
                with dispatch.measure() as d:
                    ms_ = det.match(scene, 85.0)
                out[up] = sorted((m.template_id, m.x, m.y, m.similarity)
                                 for m in ms_)
                r = dict(stage="match", bank=name, use_kernel=up,
                         n_matches=len(ms_),
                         match_overflow_reruns=d.get("overflow_reruns", 0))
                r["match_ms"] = _time(lambda: det.match(scene, 85.0),
                                      reps)
                dframes = jnp.asarray(np.stack([scene] * 8))

                def batch():
                    return list(det.match_batch(
                        dframes, 85.0, cand_cap=cand, distinct_cap=dist,
                        as_matches=False).values())

                r["batch8_caps"] = [cand, dist]
                r["batch8_ms_per_frame"] = _time(batch, max(reps // 4, 2)
                                                 ) / 8
                r["batch8_overflow_frames"] = sum(
                    int(np.asarray(v[5]).sum()) for v in batch())
                row(**r)
            row(stage="match_parity", bank=name,
                kernel_eq_xla=out[True] == out[False])

    # the frontend pyramid, both levels
    det, templ = build_rotated_detector(num_templates=8, num_features=63,
                                        size=96 if args.small else 256,
                                        cache=not args.small)
    scene = jnp.asarray(synthetic_scene(side, side, templ, n_instances=4))
    pyr = jax.jit(lambda s: _build_lm_pyramid(
        s, jnp.zeros((1, 1), jnp.uint8), True, False, (4, 8), 2,
        jnp.float32(30.0)))
    row(stage="frontend", side=side, pyramid_ms=_time(lambda: pyr(scene),
                                                      reps, 10))

    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(rec, f, indent=1)
    print(json.dumps({"ok": True, "device": rec["device"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
