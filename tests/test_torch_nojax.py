"""The port never imports JAX (the machine with the card has none), nor
anything of the JAX package ``ndtpu``."""

import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]

_PROBE = """
import sys
sys.modules["jax"] = None          # any "import jax" now raises ImportError
sys.modules["ndtpu"] = None        # ... and any "import ndtpu[.x]"
sys.path.insert(0, {root!r})
import ndtpu_torch, ndtpu_torch.run, ndtpu_torch.kernels, ndtpu_torch.convert
import ndtpu_torch.slam.pipeline, ndtpu_torch.utils.metrics
import ndtpu_torch.loop, ndtpu_torch.loop.closure
import ndtpu_torch.solve_g2o, ndtpu_torch.graph.supernodal
import ndtpu_torch.data.g2o, ndtpu_torch.native
import ndtpu_torch.slam.merge, ndtpu_torch.dist.schur, ndtpu_torch.dist.mesh
import ndtpu_torch.dist.launch, ndtpu_torch.dist.gridmap
import ndtpu_torch.dist.registration, ndtpu_torch.dist.slam_dp
import ndtpu_torch.dist
import chip_smoke
from chip_smoke import box_sequence, sequence_hashes, dead_reckoning
from ndtpu_torch import kernels
assert kernels._lib is None        # importing built nothing
seq = box_sequence(0, 36)
assert seq.points.shape == (300, 36, 2)
assert not any(m in ("jax", "ndtpu") or m.startswith(("jax.", "ndtpu."))
               for m in sys.modules if sys.modules[m] is not None)
print("ok")
"""


def test_port_imports_without_jax():
    proc = subprocess.run([sys.executable, "-c", _PROBE.format(root=str(ROOT))],
                          capture_output=True, text=True, timeout=300,
                          cwd=str(ROOT))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("ok")


_IMPORT = re.compile(r"^\s*(import|from) (jax|ndtpu)(\.|\s|$)")


def test_no_jax_import_lines_in_port():
    """No line of the port, the smoke, the profiler or the card's kernel
    tests (run there without the JAX conftest) imports ``jax`` or
    ``ndtpu`` (``ndtpu_torch`` is not ``ndtpu``)."""
    assert _IMPORT.match("from ndtpu.config import X")
    assert _IMPORT.match("import ndtpu")
    assert not _IMPORT.match("from ndtpu_torch import kernels")
    offenders = []
    for path in [*sorted((ROOT / "ndtpu_torch").rglob("*.py")),
                 ROOT / "chip_smoke.py", ROOT / "profile_port.py",
                 ROOT / "tests" / "test_torch_kernels.py"]:
        for i, line in enumerate(path.read_text().splitlines(), 1):
            if _IMPORT.match(line):
                offenders.append(f"{path}:{i}")
    assert not offenders, offenders


_KERNEL_TESTS_PROBE = """
import importlib.util, sys
sys.modules["jax"] = None
sys.modules["ndtpu"] = None
sys.path.insert(0, {root!r})
spec = importlib.util.spec_from_file_location(
    "card_tests", {path!r})
spec.loader.exec_module(importlib.util.module_from_spec(spec))
import profile_port
assert not any(m in ("jax", "ndtpu") or m.startswith(("jax.", "ndtpu."))
               for m in sys.modules if sys.modules[m] is not None)
print("ok")
"""


def test_card_kernel_tests_import_without_jax_package():
    """``tests/test_torch_kernels.py`` (and ``profile_port``, which the
    smoke and those tests use) import with ``jax`` and ``ndtpu`` blocked,
    as on the machine with the card."""
    probe = _KERNEL_TESTS_PROBE.format(
        root=str(ROOT), path=str(ROOT / "tests" / "test_torch_kernels.py"))
    proc = subprocess.run([sys.executable, "-c", probe], capture_output=True,
                          text=True, timeout=300, cwd=str(ROOT))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("ok")


def test_chip_smoke_fails_without_card():
    """Without a card (or outside a checkout) the smoke exits non-zero and
    prints no result line."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                          capture_output=True, text=True, timeout=300,
                          cwd=str(ROOT))
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
