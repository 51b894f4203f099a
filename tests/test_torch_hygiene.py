"""The port stands alone: importing every module of
orb_slam2_commit_tpu_torch (and chip_smoke.py) loads neither JAX nor the
JAX package, nor PIL, imageio or OpenCV (the card's machine has none of
them: the port reads and writes PNG itself, utils/png.py), and no source
of either names them in an import."""

import json
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "orb_slam2_commit_tpu_torch"

FORBIDDEN = re.compile(r"^(jax|jaxlib|orb_slam2_commit_tpu|PIL|imageio|cv2)(\.|$)")
IMPORT_LINE = re.compile(
    r"^\s*(?:from\s+(\S+)\s+import|import\s+([\w., ]+))", re.MULTILINE)


def _port_modules():
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def test_importing_the_port_loads_no_jax():
    modules = list(_port_modules())
    assert len(modules) >= 20
    # Forget anything the interpreter's start-up loaded, and refuse any
    # later import of a forbidden name.
    code = (
        "import importlib, json, re, sys\n"
        f"bad = re.compile({FORBIDDEN.pattern!r})\n"
        "for m in [m for m in sys.modules if bad.match(m)]: del sys.modules[m]\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if bad.match(name): raise ImportError('forbidden: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "before = set(sys.modules)\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        "import chip_smoke\n"
        "print(json.dumps(sorted(set(sys.modules) - before)))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
        timeout=120, check=True)
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert "orb_slam2_commit_tpu_torch.slam.jit_frontend" in loaded
    assert "orb_slam2_commit_tpu_torch.examples.run_dataset" in loaded
    for m in ("slam.viewer", "slam.ar", "examples.run_live", "examples.run_ar",
              "examples.run_synthetic_mono", "utils.profiling"):
        assert f"orb_slam2_commit_tpu_torch.{m}" in loaded
    bad = [m for m in loaded if FORBIDDEN.match(m)]
    assert not bad, bad


def test_sources_import_no_jax():
    for path in [*PORT.rglob("*.py"), ROOT / "chip_smoke.py"]:
        for m in IMPORT_LINE.finditer(path.read_text()):
            names = [m.group(1)] if m.group(1) else [
                n.split(" as ")[0].strip() for n in m.group(2).split(",")]
            for name in names:
                assert not FORBIDDEN.match(name), f"{path}: imports {name}"
