"""The PyTorch port stands alone: importing every module of
``repro_torch`` loads neither JAX nor anything of ``repro``, and no source
file of it imports them."""
import os
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import repro_torch

PKG_DIR = Path(repro_torch.__file__).resolve().parent


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        [str(PKG_DIR)], prefix="repro_torch."))


def test_port_has_the_slice_modules():
    mods = set(_modules())
    for name in ("bridge", "configs.registry", "configs.smollm_135m",
                 "kernels.ref", "kernels.flash_attention",
                 "kernels.decode_attention", "kernels.ops", "kernels.build",
                 "models.blocks", "models.transformer", "core.segments",
                 "core.task_model", "core.analysis", "core.policy",
                 "core.runlist", "core.ioctl", "core.audsley", "sched.job",
                 "sched.fault", "sched.faultinject", "sched.executor",
                 "sched.admission", "launch.serve"):
        assert f"repro_torch.{name}" in mods, name


def test_importing_every_module_loads_no_jax_and_no_repro():
    code = (
        "import importlib, sys\n"
        f"for m in {_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith(('jax.', 'jaxlib')) or m == 'repro' or "
        "m.startswith('repro.'))\n"
        "print(repr(bad))\n")
    env = dict(os.environ, PYTHONPATH=str(PKG_DIR.parent))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_no_source_file_imports_jax_or_repro():
    pattern = re.compile(
        r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro(\.|\s|$)|"
        r"from\s+repro(\.|\s))", re.M)
    offenders = [str(p.relative_to(PKG_DIR))
                 for p in PKG_DIR.rglob("*.py")
                 if pattern.search(p.read_text())]
    assert offenders == []
