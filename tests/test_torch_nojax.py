"""The port never imports JAX (the machine with the card has none)."""

import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]

_PROBE = """
import sys
sys.modules["jax"] = None          # any "import jax" now raises ImportError
sys.path.insert(0, {root!r})
import ndtpu_torch, ndtpu_torch.run, ndtpu_torch.kernels, ndtpu_torch.convert
import ndtpu_torch.slam.pipeline, ndtpu_torch.utils.metrics
import ndtpu_torch.loop, ndtpu_torch.loop.closure
import chip_smoke
from chip_smoke import box_sequence, sequence_hashes, dead_reckoning
from ndtpu_torch import kernels
assert kernels._lib is None        # importing built nothing
seq = box_sequence(0, 36)
assert seq.points.shape == (300, 36, 2)
assert not any(m == "jax" or m.startswith("jax.") for m in sys.modules
               if sys.modules[m] is not None)
print("ok")
"""


def test_port_imports_without_jax():
    proc = subprocess.run([sys.executable, "-c", _PROBE.format(root=str(ROOT))],
                          capture_output=True, text=True, timeout=300,
                          cwd=str(ROOT))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("ok")


def test_no_jax_import_lines_in_port():
    offenders = []
    for path in [*sorted((ROOT / "ndtpu_torch").rglob("*.py")),
                 ROOT / "chip_smoke.py"]:
        for i, line in enumerate(path.read_text().splitlines(), 1):
            s = line.strip()
            if s.startswith(("import jax", "from jax")):
                offenders.append(f"{path}:{i}")
    assert not offenders, offenders


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
