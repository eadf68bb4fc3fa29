"""Packaging of the PyTorch port: it imports without JAX or the JAX
package, and its numpy copies (config, synthetic data) agree with the
originals."""

import dataclasses
import pathlib
import subprocess
import sys

import numpy as np

REPO = pathlib.Path(__file__).resolve().parents[1]
PKG = REPO / "staticfusion_tpu_torch"

_BLOCKED_IMPORT = r"""
import importlib, importlib.abc, pathlib, sys

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        top = name.split(".")[0]
        if top in ("jax", "jaxlib", "staticfusion_tpu"):
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, Block())
root = pathlib.Path(sys.argv[1])
mods = sorted(".".join(p.relative_to(root.parent).with_suffix("").parts)
              for p in root.rglob("*.py"))
for m in mods:
    importlib.import_module(m.removesuffix(".__init__"))
assert not any(k.split(".")[0] in ("jax", "staticfusion_tpu")
               for k in sys.modules), "JAX leaked in"
print(len(mods))
"""


def test_every_module_imports_without_jax():
    proc = subprocess.run([sys.executable, "-c", _BLOCKED_IMPORT, str(PKG)],
                          cwd=REPO, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) == len(list(PKG.rglob("*.py")))


def test_no_jax_in_the_sources():
    for p in list(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]:
        for line in p.read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]):
                assert words[1].split(".")[0] not in (
                    "jax", "staticfusion_tpu"), (p, line)


def test_config_round_trips_the_jax_config():
    from staticfusion_tpu.config import (SFConfig, solver_preset_ctor,
                                         solver_preset_datasets)
    from staticfusion_tpu_torch import config as tconf

    for cfg in (SFConfig(), SFConfig().replace(solver=solver_preset_ctor()),
                SFConfig().replace(solver=solver_preset_datasets())):
        text = cfg.to_json()
        port = tconf.SFConfig.from_json(text)
        assert port.to_json() == text
        assert SFConfig.from_json(port.to_json()) == cfg
    for a, b in ((SFConfig(), tconf.SFConfig()),):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        assert (a.rows, a.cols, a.ctf_levels) == (b.rows, b.cols,
                                                  b.ctf_levels)


def test_synthetic_sequence_identical():
    from staticfusion_tpu.config import CameraConfig, SFConfig
    from staticfusion_tpu.io import synthetic as jsyn
    from staticfusion_tpu_torch.io import synthetic as tsyn

    cfg = SFConfig(camera=CameraConfig(width=160, height=120))
    twist = np.array([0.004, -0.002, 0.006, 0.0015, -0.001, 0.002],
                     np.float32)
    sphere = jsyn.Sphere(center=np.array([0.3, 0.0, 1.8]), radius=0.35,
                         velocity=np.array([-0.04, 0.0, 0.0]))
    for kw in ({}, {"sphere": sphere, "depth_noise": 0.002, "seed": 3}):
        fa, ga = jsyn.make_sequence(cfg, 4, twist, **kw)
        if "sphere" in kw:
            kw = dict(kw, sphere=tsyn.Sphere(**dataclasses.asdict(sphere)))
        fb, gb = tsyn.make_sequence(cfg, 4, twist, **kw)
        np.testing.assert_array_equal(ga, gb)
        for a, b in zip(fa, fb):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
