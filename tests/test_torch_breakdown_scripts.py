"""The kernel breakdown scripts (``scripts/*_breakdown.py``) stay in step
with the sources they patch: each imports without jax or the ``repro``
package, and every text patch of every variant finds its target in the
current ``csrc/<name>.cu`` (the scripts run only on a card, so this is
their CPU check)."""
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]

_CHECK = r"""
import importlib, sys
sys.modules["jax"] = None          # any `import jax` now raises
sys.modules["repro"] = None        # ... and so does `import repro`
sys.path.insert(0, sys.argv[1])
import breakdown_common
mod = importlib.import_module(sys.argv[2])
name = sys.argv[3]
tables = [v for k, v in vars(mod).items()
          if k in ("PATCHES", "PHASES", "RESTARTS")]
n = 0
for table in tables:
    for variant in table:
        src = breakdown_common.apply(name, variant, table)
        assert src != "" and (variant == "shipped") == (
            src == (breakdown_common.CSRC / f"{name}.cu").read_text()), \
            variant
        n += 1
assert not any(k.split(".")[0] in ("jax", "jaxlib", "repro")
               for k, v in sys.modules.items() if v is not None)
print(n)
"""


@pytest.mark.parametrize("script,source", [
    ("sdv_breakdown", "sdv"), ("bseg_breakdown", "bseg"),
    ("conv1d_breakdown", "bseg1d"), ("qmm_breakdown", "quant_matmul"),
    ("dequant_breakdown", "packbits")])
def test_breakdown_patches_find_their_targets(script, source):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", _CHECK,
                           str(ROOT / "scripts"), script, source],
                          capture_output=True, text=True, env=env,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr + proc.stdout
    assert int(proc.stdout.split()[-1]) >= 5     # every variant patched
