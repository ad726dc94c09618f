"""The import guard: a run loads neither JAX nor the JAX package (top-level
names compared whole, since the port's name begins with the JAX
package's), and the reference loads nothing of the port."""

import json
import subprocess
import sys

import pytest

from conftest import BENCH, CELLS

FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "plastic_unet_tpu"}


def loaded_by(code: str) -> set:
    """Top-level names of the modules a fresh interpreter holds after ``code``."""
    prog = (f"import sys; sys.path[:0] = [{str(BENCH)!r}, {str(BENCH.parent)!r}]\n{code}\n"
            "import json; print(json.dumps(sorted({m.split('.')[0] for m in list(sys.modules)})))")
    out = subprocess.run([sys.executable, "-c", prog], capture_output=True, text=True, timeout=300, cwd=BENCH.parent)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


@pytest.mark.parametrize("name", CELLS)
def test_run_loads_no_jax(name):
    names = loaded_by("import runpy; run = runpy.run_path('benchmark/run.py')\n"
                      "from portbench import spec\n"
                      f"run['import_everything'](spec.load_cell({name!r}))")
    assert "plastic_unet_tpu_torch" in names and "portbench" in names
    assert not names & FORBIDDEN, names & FORBIDDEN


def test_reference_loads_nothing_of_the_port():
    """Every file under reference/ (each arch's, and any a later one adds)."""
    files = sorted(str(p) for p in (BENCH / "reference").glob("*.py"))
    assert {"common.py", "unet.py", "unet_res.py"} <= {p.rsplit("/", 1)[1] for p in files}
    names = loaded_by(f"import runpy\nfor p in {files!r}:\n    runpy.run_path(p)")
    assert "reference" in names
    assert "plastic_unet_tpu_torch" not in names and not names & FORBIDDEN


def test_forbidden_names_are_compared_whole():
    import runpy

    run = runpy.run_path(str(BENCH / "run.py"))
    before = dict(sys.modules)
    try:
        sys.modules["plastic_unet_tpu_torch_extra"] = sys  # a longer name is not the JAX package
        assert "plastic_unet_tpu" not in run["forbidden_modules"]()
        sys.modules["plastic_unet_tpu.models"] = sys
        assert "plastic_unet_tpu" in run["forbidden_modules"]()
    finally:
        for k in set(sys.modules) - set(before):
            del sys.modules[k]
