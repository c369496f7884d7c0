"""Multi-chip matching: frames x template bank sharded over a mesh.

Runs the COMPLETE match pipeline under one shard_map — each chip builds
the pyramid for its data-shard frames, scores its slice of the template
bank, refines its own candidates, and the match lists are exchanged
with all_gather. Results are bit-identical to the single-device
Detector.match (asserted here).

On a single-host dev box this runs on 8 VIRTUAL CPU devices; on a host
with several GPUs, drop the platform override and the same code spans the
cards.

Usage: python examples/multichip_match.py [n_devices]
"""

import os
import sys


def main(n_devices: int = 8) -> None:
    # virtual-device bootstrap (must precede the first jax import)
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + f" --xla_force_host_platform_device_count={n_devices}")
    import jax

    jax.config.update("jax_platforms", "cpu")

    import numpy as np

    from shape_based_matching_tpu.parallel.mesh import (
        make_mesh, match_images_sharded)
    from shape_based_matching_tpu.utils.synthetic import (
        build_rotated_detector, synthetic_scene)

    det, templ_img = build_rotated_detector(num_templates=64,
                                            num_features=48, size=128)
    frames = np.stack([
        synthetic_scene(256, 256, templ_img, n_instances=2, seed=s)
        for s in range(2)
    ])

    mesh = make_mesh(n_devices)
    print(f"mesh: {dict(zip(mesh.axis_names, mesh.devices.shape))}")
    sharded = match_images_sharded(det, frames, threshold=85.0, mesh=mesh)
    single = [det.match(f, 85.0) for f in frames]

    for i, (a, b) in enumerate(zip(sharded, single)):
        assert [(m.template_id, m.x, m.y, m.similarity) for m in a] == \
               [(m.template_id, m.x, m.y, m.similarity) for m in b]
        print(f"frame {i}: {len(a)} matches — sharded == single-device")


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 8)
