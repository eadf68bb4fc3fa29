"""Packaging of the PyTorch port: it imports without JAX or the JAX
package, its numpy copies (config, synthetic data) agree with the
originals, and its entry points default to the card."""

import dataclasses
import pathlib
import subprocess
import sys

import numpy as np
import pytest

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


@pytest.mark.parametrize("entry", ["SlamSystem", "state_from_numpy"])
def test_entry_points_default_to_the_card(entry):
    """The port's entry points run on the card unless the caller asks for
    the CPU; without a card the default raises and names the fix."""
    import torch

    from staticfusion_tpu_torch.config import (CameraConfig, FusionConfig,
                                               SFConfig)
    from staticfusion_tpu_torch.pipeline.state import (init_state,
                                                       state_from_numpy,
                                                       state_to_numpy)
    from staticfusion_tpu_torch.pipeline.system import SlamSystem

    cfg = SFConfig(camera=CameraConfig(width=40, height=30),
                   fusion=FusionConfig(capacity=1 << 10))
    if entry == "SlamSystem":
        def device_of(**kw):
            return SlamSystem(cfg, **kw).device
    else:
        tree = state_to_numpy(init_state(cfg, "cpu"))

        def device_of(**kw):
            return state_from_numpy(tree, **kw).curr_pose.device
    if torch.cuda.is_available():
        assert device_of().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            device_of()
    assert device_of(device="cpu").type == "cpu"


_STUB_NVCC = """#!/bin/sh
# Records its call; a compile (-c) waits until every compile has started.
out=""; prev=""
for a in "$@"; do [ "$prev" = "-o" ] && out="$a"; prev="$a"; done
case " $* " in
  *" -c "*)
    echo "compile $out" >> {log}
    i=0
    while [ "$(grep -c compile {log})" -lt {n} ] && [ $i -lt 400 ]; do
      sleep 0.05; i=$((i + 1))
    done
    [ "$(grep -c compile {log})" -ge {n} ] || exit 3 ;;
  *) echo "link $*" >> {log} ;;
esac
touch "$out"
"""


def test_kernel_build_starts_one_compiler_per_source(tmp_path, monkeypatch):
    """The build runs one nvcc per csrc/*.cu, all at once (a stub compiler
    stands in for nvcc: each compile waits for the others to start, so a
    build that ran them one by one would fail), links the objects into
    the library named by the sources' hash, and leaves no object behind."""
    from staticfusion_tpu_torch.kernels import _build

    srcs = sorted(_build.CSRC.glob("*.cu"))
    log = tmp_path / "calls.log"
    stub = tmp_path / "cuda" / "bin" / "nvcc"
    stub.parent.mkdir(parents=True)
    stub.write_text(_STUB_NVCC.format(log=log, n=len(srcs)))
    stub.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")

    lib = _build.build()
    assert lib == _build.library_path() and lib.exists()
    calls = log.read_text().splitlines()
    compiles = sorted(c.split()[1] for c in calls if c.startswith("compile"))
    assert [pathlib.Path(c).suffixes[-2:] for c in compiles] == [
        ["." + p.stem, ".o"] for p in srcs]
    links = [c for c in calls if c.startswith("link")]
    assert len(links) == 1 and "-shared" in links[0].split()
    assert sorted(w for w in links[0].split() if w.endswith(".o")) == compiles
    assert sorted(p.name for p in lib.parent.iterdir()) == [lib.name]


def test_csrc_is_declared_package_data():
    """pyproject.toml ships every csrc/*.cu and *.cuh and csrc/io/*.cpp
    with the package, so an installed port can build its kernels and its
    native I/O library, and lists every subpackage."""
    import fnmatch
    import tomllib

    meta = tomllib.loads((REPO / "pyproject.toml").read_text())
    tool = meta["tool"]["setuptools"]
    assert "staticfusion_tpu_torch" in tool["packages"]
    assert {f"staticfusion_tpu_torch.{p.parent.name}"
            for p in PKG.glob("*/__init__.py")} <= set(tool["packages"])
    globs = tool["package-data"]["staticfusion_tpu_torch"]
    assert sorted(globs) == ["csrc/*.cu", "csrc/*.cuh", "csrc/io/*.cpp"]
    sources = [p.relative_to(PKG).as_posix()
               for p in (PKG / "csrc").rglob("*") if p.is_file()]
    assert sources and all(any(fnmatch.fnmatch(s, g) for g in globs)
                           for s in sources)


@pytest.mark.parametrize("where", ["read_only_checkout", "installed"])
def test_kernel_build_falls_back_to_the_user_cache(where, tmp_path,
                                                   monkeypatch):
    """Outside a writable checkout (its build/ cannot be made, or the
    package sits in site-packages with no pyproject.toml above it) the
    library is built into $XDG_CACHE_HOME/staticfusion_tpu_torch/kernels
    (a stub compiler stands in for nvcc)."""
    from staticfusion_tpu_torch.kernels import _build

    srcs = sorted(_build.CSRC.glob("*.cu"))
    log = tmp_path / "calls.log"
    stub = tmp_path / "cuda" / "bin" / "nvcc"
    stub.parent.mkdir(parents=True)
    stub.write_text(_STUB_NVCC.format(log=log, n=len(srcs)))
    stub.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    if where == "read_only_checkout":
        blocker = tmp_path / "checkout"
        blocker.write_text("a file, so no directory can be made under it")
        monkeypatch.setattr(_build, "BUILD_DIR", blocker / "build")
    else:
        site = tmp_path / "site-packages"
        site.mkdir()
        monkeypatch.setattr(_build, "REPO_ROOT", site)
        monkeypatch.setattr(_build, "BUILD_DIR", site / "build")

    cache = tmp_path / "cache" / "staticfusion_tpu_torch" / "kernels"
    assert _build.build_dir() == cache
    lib = _build.build()
    assert lib.parent == cache and lib.exists()
    assert lib == _build.library_path()
    assert not (tmp_path / "site-packages" / "build").exists()


def test_kernel_build_failure_raises_with_the_compiler_output(tmp_path,
                                                              monkeypatch):
    from staticfusion_tpu_torch.kernels import _build

    stub = tmp_path / "cuda" / "bin" / "nvcc"
    stub.parent.mkdir(parents=True)
    stub.write_text("#!/bin/sh\necho 'error: no such intrinsic'\nexit 2\n")
    stub.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="no such intrinsic"):
        _build.build()
    assert not _build.library_path().exists()
