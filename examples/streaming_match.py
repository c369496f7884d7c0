"""Streaming batch matching: frames in, packed match arrays out.

The throughput pattern for production serving: keep frames device-
resident, run `Detector.match_batch(..., as_matches=False)` so nothing
syncs to the host until YOU decide, and pull one packed array per batch.
At 360 templates / 1024x1024 one H100 ran match_batch at about 0.3 ms
per frame in a B=8 batch (PERF.md; the reference's single-threaded CPU
match is ~15 fps).

Usage: python examples/streaming_match.py [n_batches]
"""

import sys
import time

import jax
import numpy as np

from shape_based_matching_tpu.utils.synthetic import (
    build_rotated_detector, synthetic_scene)
from shape_based_matching_tpu.utils.timer import CSVStat


def main(n_batches: int = 4, batch: int = 8, num_templates: int = 360,
         hw: int = 1024) -> None:
    det, templ_img = build_rotated_detector(num_templates=num_templates,
                                            num_features=63)
    frames = jax.device_put(np.stack([
        synthetic_scene(hw, hw, templ_img, n_instances=4, seed=s)
        for s in range(batch)
    ]))
    jax.block_until_ready(frames)

    # warm-up compiles the one-program batched match
    out = det.match_batch(frames, 85.0, as_matches=False)
    jax.block_until_ready(out)

    stat = CSVStat(["BATCH_MS", "FPS", "DETECTIONS"])
    for b in range(n_batches):
        t0 = time.perf_counter()
        packed = det.match_batch(frames, 85.0, as_matches=False)
        jax.block_until_ready(packed)
        dt = (time.perf_counter() - t0) * 1e3
        (k, x, y, sc, valid, overflow) = packed["bench"]
        n = int(valid.sum())
        stat.append([dt, batch / dt * 1e3, n])
        print(f"batch {b}: {dt:6.2f} ms  ({batch / dt * 1e3:6.1f} fps)  "
              f"{n} detections")
    print(stat.summary_csv())


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 4)
