"""After everything a run imports, no module's top-level name is ``jax``,
``jaxlib``, ``flax`` or ``airslam_tpu`` (compared whole: the port's
``airslam_tpu_torch`` begins with the JAX package's name)."""

import os
import subprocess
import sys

from _helpers import ROOT

SCRIPT = r"""
import glob, os, sys
sys.path.insert(0, ROOT)
import slambench.run
from slambench.drivers import vo, global_ba
from slambench.reference import vo_check, ba_check, ba_solver
from slambench.reference.nets import detector, matcher
from slambench.harness import common, probes
for path in glob.glob(os.path.join(ROOT, "slambench", "metrics", "*.py")):
    name = os.path.basename(path)[:-3]
    if not name.startswith("_"):
        common.load_reader(name)
import airslam_tpu_torch.backend.global_ba, airslam_tpu_torch.pipelines.map_builder
import airslam_tpu_torch.frontend.detector, airslam_tpu_torch.frontend.matcher
import airslam_tpu_torch.io.config, airslam_tpu_torch.core.camera
probes.Probes().remove()
print(sorted({m.split(".")[0] for m in sys.modules} & set(common.FORBIDDEN)))
print("airslam_tpu_torch" in sys.modules)
"""


def test_a_run_imports_no_jax_module():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", f"ROOT = {ROOT!r}\n" + SCRIPT], cwd=ROOT,
                         capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split("\n")[:2] == ["[]", "True"]


def test_forbidden_names_compare_whole_top_level_names():
    from slambench.harness.common import forbidden_modules

    assert forbidden_modules(["airslam_tpu_torch", "airslam_tpu_torch.ops", "jaxtyping"]) == []
    assert forbidden_modules(["airslam_tpu.core.lie", "jax.numpy", "flax"]) == [
        "airslam_tpu", "flax", "jax"]
