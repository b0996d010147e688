"""No module of tpubody_torch imports jax, flax, optax or tpubody, and
importing one builds no kernel.

One interpreter imports the modules one after another and reports, for
each, which forbidden packages first appeared in ``sys.modules`` with it
(the set only grows, so the module that brought one in is the one named);
each module is a case of its own."""
import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MODULES = [
    "tpubody_torch",
    "tpubody_torch.bench",
    "tpubody_torch.cli",
    "tpubody_torch.device",
    "tpubody_torch.geometry",
    "tpubody_torch.native",
    "tpubody_torch.core.fused_lbs",
    "tpubody_torch.core.lbs",
    "tpubody_torch.core.rotations",
    "tpubody_torch.core.skeleton",
    "tpubody_torch.dist.mesh",
    "tpubody_torch.dist.multihost",
    "tpubody_torch.fit.collision",
    "tpubody_torch.fit.joints",
    "tpubody_torch.fit.keypoints",
    "tpubody_torch.fit.lbfgs",
    "tpubody_torch.fit.mesh_collision",
    "tpubody_torch.fit.optim",
    "tpubody_torch.fit.priors",
    "tpubody_torch.fit.smplify",
    "tpubody_torch.fit.vposer",
    "tpubody_torch.image.boundary_match",
    "tpubody_torch.image.contours",
    "tpubody_torch.image.morphology",
    "tpubody_torch.image.mvc",
    "tpubody_torch.image.ops",
    "tpubody_torch.image.warp",
    "tpubody_torch.io.asf",
    "tpubody_torch.io.dataset",
    "tpubody_torch.io.motion",
    "tpubody_torch.mesh.bspline",
    "tpubody_torch.mesh.decimate",
    "tpubody_torch.mesh.gltf",
    "tpubody_torch.mesh.grid_mesh",
    "tpubody_torch.mesh.hands",
    "tpubody_torch.mesh.meshio",
    "tpubody_torch.mesh.rigging",
    "tpubody_torch.mesh.slicing",
    "tpubody_torch.mesh.smoothing",
    "tpubody_torch.mesh.stitch",
    "tpubody_torch.models.fused_resnet",
    "tpubody_torch.models.hmr",
    "tpubody_torch.models.hmr2",
    "tpubody_torch.models.hmr_quant",
    "tpubody_torch.models.hmr_train",
    "tpubody_torch.models.humanoid",
    "tpubody_torch.models.multihmr",
    "tpubody_torch.models.params",
    "tpubody_torch.models.pose2d",
    "tpubody_torch.models.sapiens",
    "tpubody_torch.models.smpl",
    "tpubody_torch.pipelines.animate",
    "tpubody_torch.pipelines.demo",
    "tpubody_torch.pipelines.gen_smplh",
    "tpubody_torch.pipelines.hmr_infer",
    "tpubody_torch.pipelines.pose_train",
    "tpubody_torch.pipelines.reconstruct",
    "tpubody_torch.pipelines.refine",
    "tpubody_torch.pipelines.serving",
    "tpubody_torch.render.bodymaps",
    "tpubody_torch.render.camera",
    "tpubody_torch.render.raster",
    "tpubody_torch.render.tiled_raster",
    "tpubody_torch.render.video",
    "tpubody_torch.render.viewer",
    "tpubody_torch.solve.normal2depth",
    "tpubody_torch.utils.cache",
    "tpubody_torch.utils.checkpoint",
    "tpubody_torch.utils.metrics",
    "tpubody_torch.utils.pose_eval",
    "tpubody_torch.utils.profiling",
]

CODE = r"""
import importlib, json, pkgutil, sys
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "tpubody")
def bad():
    return {m.split(".")[0] for m in sys.modules} & set(FORBIDDEN)
seen, report = set(), {}
for name in json.loads(sys.argv[1]):
    importlib.import_module(name)
    now = bad()
    report[name] = sorted(now - seen)
    seen |= now
import tpubody_torch
from tpubody_torch import geometry, native
found = sorted(m.name for m in pkgutil.walk_packages(
    tpubody_torch.__path__, "tpubody_torch.") if not m.ispkg)
print(json.dumps({"report": report, "found": found,
                  "lib_loaded": native._LIB is not None,
                  "geometry_loaded": geometry._LIB is not None,
                  "cv2": "cv2" in sys.modules}))
"""


@pytest.fixture(scope="module")
def imported():
    env = {k: v for k, v in os.environ.items() if k != "TPUBODY_CF_FUSED"}
    out = subprocess.run([sys.executable, "-c", CODE, json.dumps(MODULES)],
                         capture_output=True, text=True, timeout=300,
                         cwd=ROOT, env=env)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("module", MODULES)
def test_module_imports_nothing_of_jax(imported, module):
    assert imported["report"][module] == [], imported["report"][module]


def test_every_module_is_listed(imported):
    """A module added to the package gets its case above."""
    listed = set(MODULES) - {"tpubody_torch"}
    assert set(imported["found"]) == listed, \
        set(imported["found"]) ^ listed


def test_import_builds_and_loads_nothing(imported):
    """Kernels and the host-geometry helper are compiled, and cv2 is
    imported, at first use, never when a module is imported."""
    assert not imported["lib_loaded"]
    assert not imported["geometry_loaded"]
    assert not imported["cv2"]
