"""The port's checkpoints against the JAX package's (CPU, 160x120,
index_factor=1, capacity 1<<15: the configuration of
tests/test_torch_fusion_f1.py, whose JAX steps the compile cache holds).

Both packages write the same npz layout, so a JAX checkpoint loads in the
port and a port checkpoint loads in JAX with every leaf equal; one more
step from the loaded state matches the JAX step from the same state at
tests/test_torch_slice.py's tolerances; a config mismatch raises the JAX
package's error.
"""

import numpy as np
import pytest
import torch

import jax

from staticfusion_tpu.config import CameraConfig, FusionConfig, SFConfig
from staticfusion_tpu.io import synthetic
from staticfusion_tpu.pipeline.system import SlamSystem as JaxSlam
from staticfusion_tpu.utils import checkpoint as jckpt
from staticfusion_tpu_torch.config import SFConfig as TorchConfig
from staticfusion_tpu_torch.fusion.surfels import compact_map, next_tier
from staticfusion_tpu_torch.pipeline.state import state_to_numpy
from staticfusion_tpu_torch.pipeline.system import SlamSystem as TorchSlam
from staticfusion_tpu_torch.utils import checkpoint as tckpt

# The suite runs in parallel worker processes: a small intra-op pool per
# worker keeps them from oversubscribing the host's cores.
torch.set_num_threads(2)

CONFIG = SFConfig(camera=CameraConfig(width=160, height=120),
                  fusion=FusionConfig(capacity=1 << 15, index_factor=1))
TCONFIG = TorchConfig.from_json(CONFIG.to_json())
TWIST = np.array([0.004, -0.002, 0.006, 0.0015, -0.001, 0.002], np.float32)
N_SAVED = 3      # frames run before the checkpoint
STEP_POSE_TOL = 2e-3


@pytest.fixture(autouse=True)
def _drop_jax_caches():
    """Drop JAX's in-memory executables after every test, so the process's
    memory maps stay far below vm.max_map_count."""
    yield
    jax.clear_caches()


@pytest.fixture(scope="module")
def frames():
    return synthetic.make_sequence(CONFIG, N_SAVED + 1, TWIST)[0]


@pytest.fixture(scope="module")
def jax_run(frames, tmp_path_factory):
    """The JAX system after N_SAVED frames, its checkpoint, and its output
    of the next frame."""
    js = JaxSlam(CONFIG)
    for i, (rgb, d, _) in enumerate(frames[:N_SAVED]):
        js.process(rgb, d, i / 30.0)
    path = str(tmp_path_factory.mktemp("ckpt") / "jax.npz")
    jckpt.save_state(path, js.state, CONFIG)
    leaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(js.state)]
    rgb, d, _ = frames[N_SAVED]
    out = js.process(rgb, d, N_SAVED / 30.0)
    return path, leaves, out


@pytest.fixture(scope="module")
def port_run(frames, tmp_path_factory):
    """The port after N_SAVED frames on the CPU and its checkpoint, with a
    compacted copy of its map as the archive."""
    ts = TorchSlam(TCONFIG, device="cpu")
    for i, (rgb, d, _) in enumerate(frames[:N_SAVED]):
        ts.process(rgb, d, i / 30.0)
    smap = ts.state.smap
    archive = compact_map(smap, next_tier(int(smap.count())))
    path = str(tmp_path_factory.mktemp("ckpt") / "port.npz")
    tckpt.save_state(path, ts.state, TCONFIG, archive=archive)
    return path, ts.state, archive


def _port_leaves(tree):
    return jax.tree_util.tree_leaves(tuple(state_to_numpy(tree)))


def _assert_leaves_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_jax_checkpoint_loads_in_the_port(jax_run):
    path, leaves, _ = jax_run
    state = tckpt.load_state(path, TCONFIG, device="cpu")
    assert state.smap.pos.device.type == "cpu"
    _assert_leaves_equal(_port_leaves(state), leaves)
    assert tckpt.load_config(path) == TCONFIG
    assert tckpt.load_archive(path, device="cpu") is None


def test_port_checkpoint_loads_in_jax(port_run):
    path, state, archive = port_run
    jstate = jckpt.load_state(path, CONFIG)
    _assert_leaves_equal(jax.tree_util.tree_leaves(jstate),
                         _port_leaves(state))
    _assert_leaves_equal(jax.tree_util.tree_leaves(jckpt.load_archive(path)),
                         _port_leaves(archive))
    assert jckpt.load_config(path) == CONFIG
    # And back into the port.
    _assert_leaves_equal(
        _port_leaves(tckpt.load_state(path, TCONFIG, device="cpu")),
        _port_leaves(state))
    _assert_leaves_equal(
        _port_leaves(tckpt.load_archive(path, device="cpu")),
        _port_leaves(archive))


def test_step_from_the_loaded_state_matches_jax(jax_run, frames):
    """The port resumes from the JAX checkpoint and runs the next frame;
    the JAX system runs the same frame from the same state."""
    path, _, want = jax_run
    ts = TorchSlam(TCONFIG, device="cpu")
    ts.state = tckpt.load_state(path, TCONFIG, device="cpu")
    rgb, d, _ = frames[N_SAVED]
    out = ts.process(rgb, d, N_SAVED / 30.0)
    assert float(np.abs(np.asarray(want.curr_pose)
                        - out.curr_pose.numpy()).max()) < STEP_POSE_TOL
    nj, nt = int(want.surfel_count), int(out.surfel_count)
    assert abs(nj - nt) <= 0.01 * nj, (nj, nt)
    assert float(np.mean(np.abs(out.static_prob.numpy()
                                - np.asarray(want.static_prob)))) < 1e-2
    assert bool(out.dense) == bool(want.dense)
    assert int(ts.state.tick) == int(jckpt.load_state(path).tick) + 1


def test_config_mismatch_raises_as_in_jax(port_run):
    path = port_run[0]
    other = CONFIG.replace(camera=CameraConfig(width=80, height=60))
    with pytest.raises(ValueError) as jerr:
        jckpt.load_state(path, other)
    with pytest.raises(ValueError) as terr:
        tckpt.load_state(path, TorchConfig.from_json(other.to_json()),
                         device="cpu")
    assert str(terr.value) == str(jerr.value)
    assert "camera.width: saved=160 vs given=80" in str(terr.value)
    # The capacity is re-tiered at run time, so it may differ.
    bigger = CONFIG.replace(fusion=FusionConfig(capacity=1 << 16,
                                                index_factor=1))
    jckpt.load_state(path, bigger)
    tckpt.load_state(path, TorchConfig.from_json(bigger.to_json()),
                     device="cpu")


def test_load_state_defaults_to_the_card(port_run):
    path = port_run[0]
    if torch.cuda.is_available():
        assert tckpt.load_state(path).curr_pose.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            tckpt.load_state(path)


@pytest.mark.parametrize("count_key,prefix", [("n", "leaf_"),
                                              ("n_archive", "arch_")])
@pytest.mark.parametrize("delta", [1, -1])
def test_wrong_leaf_count_raises(port_run, tmp_path, count_key, prefix,
                                 delta):
    """A checkpoint with one leaf too many or too few is refused with both
    counts named, never loaded shifted onto the wrong fields."""
    data = dict(np.load(port_run[0]))
    n = int(data[count_key])
    if delta > 0:
        data[f"{prefix}{n}"] = data[f"{prefix}{n - 1}"]
    else:
        del data[f"{prefix}{n - 1}"]
    data[count_key] = np.asarray(n + delta)
    path = str(tmp_path / "bad.npz")
    np.savez_compressed(path, **data)
    load = (tckpt.load_state if count_key == "n" else tckpt.load_archive)
    with pytest.raises(ValueError, match=f"holds {n + delta} .* has {n}"):
        load(path, device="cpu")
