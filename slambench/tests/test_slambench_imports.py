"""Nothing the harness or the port imports is JAX or the JAX package,
compared by whole top-level names (the port's name begins with the JAX
package's)."""

import subprocess
import sys

from slambench.tests.conftest import ROOT

PROBE = r"""
import importlib, pkgutil, sys
sys.path.insert(0, sys.argv[1])
import orb_slam2_commit_tpu_torch as port
for m in pkgutil.walk_packages(port.__path__, port.__name__ + "."):
    importlib.import_module(m.name)
for name in ("run", "cell", "control", "generator", "reference", "registry", "roofline",
             "trace"):
    importlib.import_module("slambench." + name)
from slambench import registry
for m in registry.benchmark()["per_layer"]:
    registry.reader(m["name"])
print(" ".join(sorted({m.split(".")[0] for m in sys.modules})))
"""

FORBIDDEN = {"jax", "jaxlib", "flax", "orb_slam2_commit_tpu"}


def test_no_jax_in_harness_or_port():
    out = subprocess.run([sys.executable, "-c", PROBE, str(ROOT)], capture_output=True,
                         text=True, timeout=600, env={"PATH": "/usr/bin:/bin",
                                                      "USE_FLAX": "0"})
    assert out.returncode == 0, out.stderr[-4000:]
    top = set(out.stdout.split())
    assert "orb_slam2_commit_tpu_torch" in top and "slambench" in top
    assert not top & FORBIDDEN, top & FORBIDDEN


def test_forbidden_names_compare_whole():
    from slambench import run

    before = dict(sys.modules)
    try:
        sys.modules["orb_slam2_commit_tpu_torch_x"] = sys
        assert "orb_slam2_commit_tpu" not in run.loaded_forbidden() or \
            "orb_slam2_commit_tpu" in {m.split(".")[0] for m in before}
        sys.modules["jaxlib.fake"] = sys
        assert "jaxlib" in run.loaded_forbidden()
    finally:
        for k in ("orb_slam2_commit_tpu_torch_x", "jaxlib.fake"):
            sys.modules.pop(k, None)
