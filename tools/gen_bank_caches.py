"""(Re)generate the committed bench_banks/ snapshots.

Every synthetic bank bench.py's metrics use is trained once here and
serialized (utils/synthetic.py:save_bank_cache) so bench metric
subprocesses and chip_smoke.py skip device training entirely.

Run on CPU (training is backend-bit-exact — asserted by
tests/test_bank_cache.py and by the golden training tests):

    JAX_PLATFORMS=cpu python tools/gen_bank_caches.py

Bump utils.synthetic._BANK_CACHE_V and rerun after ANY change to the
training math.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# All bench configs that go through build_rotated_detector with cache=True.
CONFIGS = [
    dict(num_templates=360, num_features=63),
    dict(num_templates=1000, num_features=63),
    dict(num_templates=10000, num_features=63),
    dict(num_templates=1000, num_features=128),
    dict(num_templates=8, num_features=8191, dense=True, size=768),
    dict(num_templates=1000, num_features=256, dense=True, size=256),
    dict(num_templates=360, num_features=63, n_ori=16),
]


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    os.environ["SBM_BANK_CACHE_WRITE"] = "1"
    os.environ["SBM_NO_BANK_CACHE"] = "1"  # always train live here

    from shape_based_matching_tpu.utils.synthetic import (
        _bank_cache_dir, _bank_cache_key, build_rotated_detector,
        save_bank_cache)

    for cfg in CONFIGS:
        t0 = time.perf_counter()
        # NO_BANK_CACHE forces live training; write the snapshot manually
        det, _ = build_rotated_detector(**cfg)
        key = _bank_cache_key(
            cfg.get("num_templates", 360), cfg.get("num_features", 63),
            cfg.get("T", (4, 8)), cfg.get("size", 256), cfg.get("seed", 0),
            cfg.get("dense", False), cfg.get("n_ori", 8))
        path = os.path.join(_bank_cache_dir(), key + ".npz")
        save_bank_cache(path, det.class_templates["bench"])
        kb = os.path.getsize(path) / 1024
        print(f"{key}: {time.perf_counter() - t0:.1f}s, {kb:.0f} KB")


if __name__ == "__main__":
    main()
