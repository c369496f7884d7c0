"""Installation and platform rules: the compile-cache rule, importing the
package without PyYAML, chip_smoke.py refusing hosts without a GPU, and no
Mosaic-only kernel code, interpret flag or route flag left in the program."""

import os
import re
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(code, env_extra=None, cwd=ROOT, drop=()):
    env = {k: v for k, v in os.environ.items() if k not in drop}
    env["PYTHONPATH"] = ROOT
    env.update(env_extra or {})
    return subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, cwd=cwd, timeout=300)


_CACHE_PROBE = (
    "import jax; jax.config.update('jax_platforms', 'cpu');"
    "from shape_based_matching_tpu.utils.compile_cache import "
    "enable_compile_cache;"
    "d = enable_compile_cache();"
    "print(d); print(jax.config.jax_compilation_cache_dir)")


def test_compile_cache_follows_env(tmp_path):
    d = str(tmp_path / "cache")
    out = _run(_CACHE_PROBE, {"JAX_COMPILATION_CACHE_DIR": d})
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == [d, d]


def test_compile_cache_default_is_repo_dir():
    out = _run(_CACHE_PROBE, drop=("JAX_COMPILATION_CACHE_DIR",))
    assert out.returncode == 0, out.stderr
    want = os.path.join(ROOT, ".jax_cache")
    assert out.stdout.split() == [want, want]


def test_detector_imports_without_yaml():
    """`from shape_based_matching_tpu import Detector` needs only numpy,
    scipy and JAX: PyYAML is imported lazily for persistence."""
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name == 'yaml' or name.startswith('yaml.'):\n"
        "            raise ImportError('yaml blocked')\n"
        "sys.meta_path.insert(0, Block())\n"
        "import jax; jax.config.update('jax_platforms', 'cpu')\n"
        "from shape_based_matching_tpu import Detector\n"
        "import numpy as np\n"
        "d = Detector(num_features=16)\n"
        "img = np.zeros((64, 64), np.uint8); img[16:48, 16:48] = 200\n"
        "d.add_template(img, 'c', np.full_like(img, 255))\n"
        "print(len(d.match(img, 50.0)), 'yaml' in sys.modules)\n")
    out = _run(code)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[-1] == "False"


def test_chip_smoke_refuses_cpu_host():
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "chip_smoke.py")],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "no GPU" in out.stderr


def test_chip_smoke_fails_without_the_program(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "chip_smoke.py"],
                         capture_output=True, text=True, timeout=300,
                         cwd=tmp_path, env=dict(env, JAX_PLATFORMS="cpu"))
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


_FORBIDDEN = re.compile(
    r"pallas\.[t]pu|pl[t]pu|vmem_limit_bytes|SBM_PALLAS_INTERPRET|"
    r"SBM_NO_(WIDE|CHAIN|WORDS_EXTRACT|COUNTED_EXTRACT)|==\s*\"[t]pu\"")


@pytest.mark.parametrize("where", ["shape_based_matching_tpu", "bench.py",
                                   "__graft_entry__.py", "chip_smoke.py"])
def test_no_mosaic_only_code(where):
    path = os.path.join(ROOT, where)
    files = ([path] if path.endswith(".py") else
             [os.path.join(d, f) for d, _, fs in os.walk(path)
              for f in fs if f.endswith(".py")])
    hits = [f"{f}:{i + 1}" for f in files
            for i, line in enumerate(open(f, encoding="utf-8"))
            if _FORBIDDEN.search(line)]
    assert not hits, hits
