"""The timed path broken underneath, the rest of a run driven on the CPU
at 160x120 (the look for a card skipped): `correct` comes out false for
each fault that a SLAM cell can have, also where it touches one part of
the run only: the bootstrap, as few checked frames as the limits do not
forgive, a share of the surfels, or the tier check's repack.  On the CPU
the program runs the same plain code as the reference, so a sound run
reads 0 and a fault reads what it changed."""

import pytest
import torch

from sfbench import harness
from sfbench.reference import compare
from staticfusion_tpu_torch.pipeline import system
from staticfusion_tpu_torch.pipeline.step import Frame

CELL = "qvga_f4.walk"
SEED = 11


def _unchanged(step):
    """The step returns the state it was given, and outputs that agree
    with it."""
    def fault(state, frame, config, *a, **k):
        _, out = step(state, frame, config, *a, **k)
        return state, out._replace(curr_pose=state.curr_pose,
                                   static_prob=state.prev_static_prob)
    return fault


def _half_frame(step):
    """The lower half of the frame's depth left out."""
    def fault(state, frame, config, *a, **k):
        depth = frame.depth_mm.clone()
        depth[depth.shape[0] // 2:] = 0.0
        return step(state, Frame(frame.rgb, depth), config, *a, **k)
    return fault


def _moved_pose(new, out):
    pose = out.curr_pose.clone()
    pose[0, 3] += 0.01
    return new._replace(curr_pose=pose), out._replace(curr_pose=pose)


def _altered_pose(step):
    """The pose altered where it is produced: 1 cm along x."""
    def fault(state, frame, config, *a, **k):
        return _moved_pose(*step(state, frame, config, *a, **k))
    return fault


def _moved_surfels(new, share: float):
    """`share` of the map's slots, drawn at random, moved 1 mm along z."""
    pos = new.smap.pos.clone()
    g = torch.Generator().manual_seed(5)
    pick = torch.rand(pos.shape[0], generator=g) < share
    pos[pick.to(pos.device), 2] += 1e-3
    return new._replace(smap=new.smap._replace(pos=pos))


def _altered_map(step):
    """The fused map altered where it is produced: every surfel 1 mm
    along z."""
    def fault(state, frame, config, *a, **k):
        new, out = step(state, frame, config, *a, **k)
        return _moved_surfels(new, 1.0), out
    return fault


def _some_surfels(step):
    """30% of the surfels 1 mm along z, every frame."""
    def fault(state, frame, config, *a, **k):
        new, out = step(state, frame, config, *a, **k)
        return _moved_surfels(new, 0.3), out
    return fault


def _altered_conf(step):
    """Every surfel's confidence 1% higher, every frame."""
    def fault(state, frame, config, *a, **k):
        new, out = step(state, frame, config, *a, **k)
        smap = new.smap
        return new._replace(smap=smap._replace(conf=smap.conf * 1.01)), out
    return fault


def _killed_surfels(step):
    """30% of the slots, drawn at random anew each frame, dropped from
    the map."""
    calls = [0]

    def fault(state, frame, config, *a, **k):
        new, out = step(state, frame, config, *a, **k)
        valid = new.smap.valid.clone()
        calls[0] += 1
        g = torch.Generator().manual_seed(calls[0])
        valid &= (torch.rand(valid.shape[0], generator=g) >= 0.3).to(
            valid.device)
        return new._replace(smap=new.smap._replace(valid=valid)), out
    return fault


def _run(small, seconds=3.0):
    return harness.run_cell(CELL, SEED, seconds, False, device="cpu",
                            overrides=small)


def test_sound_run_is_correct(small):
    r = _run(small)
    assert r["correct"] is True
    assert all(c["value"] == 0.0 for c in r["checks"].values())
    assert r["checked"]["tier_checks"] >= 1


@pytest.mark.parametrize("fault", [_unchanged, _half_frame, _altered_pose,
                                   _altered_map, _some_surfels,
                                   _altered_conf, _killed_surfels])
def test_fault_is_not_correct(fault, monkeypatch, small):
    monkeypatch.setattr(system, "slam_step", fault(system.slam_step))
    r = _run(small)
    assert r["correct"] is False, r["checks"]
    assert system.slam_step.__name__ == "fault"  # the harness restored it


def test_fault_in_the_bootstrap_alone_is_not_correct(monkeypatch, small):
    boot = system.bootstrap_step

    def fault(*a, **k):
        new, out = boot(*a, **k)
        return _moved_surfels(new, 1.0), out
    monkeypatch.setattr(system, "bootstrap_step", fault)
    r = _run(small)
    assert r["correct"] is False
    assert r["checks"]["bootstrap.map_gap"]["value"] > 0
    assert r["checks"]["map_gap"]["value"] == 0.0


def _bootstrap_conf_high(new):
    smap = new.smap
    return new._replace(smap=smap._replace(conf=smap.conf * 1.01))


def _bootstrap_killed(new):
    valid = new.smap.valid.clone()
    g = torch.Generator().manual_seed(7)
    valid &= (torch.rand(valid.shape[0], generator=g) >= 0.3).to(
        valid.device)
    return new._replace(smap=new.smap._replace(valid=valid))


@pytest.mark.parametrize("alter", [
    lambda new: _moved_surfels(new, 0.3), _bootstrap_conf_high,
    _bootstrap_killed], ids=["moved_30pct", "conf_1pct_high", "killed_30pct"])
def test_fault_in_part_of_the_bootstrap_is_not_correct(alter, monkeypatch,
                                                      small):
    """30% of the bootstrap's surfels moved 1 mm or dropped, or its
    confidences 1% high, and nothing after it: a number of the
    bootstrap's own reads it."""
    boot = system.bootstrap_step

    def fault(*a, **k):
        new, out = boot(*a, **k)
        return alter(new), out
    monkeypatch.setattr(system, "bootstrap_step", fault)
    r = _run(small)
    assert r["correct"] is False
    assert any(c["value"] > c["limit"] for k, c in r["checks"].items()
               if k.startswith(compare.BOOTSTRAP)), r["checks"]


def test_fault_in_one_frame_more_than_forgiven_is_not_correct(monkeypatch,
                                                            small):
    """The pose altered in exactly one checked frame more than the limits
    forgive, and in no other."""
    spec = harness.load_cell(CELL)
    allow = int(spec["limits"].get(compare.FORGIVE, 0))
    traffic = dict(spec["traffic"], **small["traffic"])
    picks, _ = harness.draw_picks(SEED, traffic)
    assert len(picks) > allow
    # The warm-up's frames 0 and 1 bootstrap; each later one is a step.
    first = int(traffic["warmup_frames"]) - 2
    hit = {first + w + 1 for w in sorted(picks)[:allow + 1]}
    step, calls = system.slam_step, [0]

    def fault(state, frame, config, *a, **k):
        calls[0] += 1
        new, out = step(state, frame, config, *a, **k)
        return _moved_pose(new, out) if calls[0] in hit else (new, out)
    monkeypatch.setattr(system, "slam_step", fault)
    r = _run(small)
    assert r["correct"] is False, r["checks"]
    assert r["checks"]["pose_gap"]["value"] > 0.009


def _drop_one(smap):
    """One kept surfel left out."""
    valid = smap.valid.clone()
    valid[int(torch.nonzero(valid)[-1])] = False
    return smap._replace(valid=valid)


def _alter_conf(smap):
    """Every kept surfel's confidence raised by 1e-3."""
    return smap._replace(conf=torch.where(smap.valid, smap.conf + 1e-3,
                                          smap.conf))


@pytest.mark.parametrize("alter", [_drop_one, _alter_conf])
def test_fault_in_the_repack_is_not_correct(alter, monkeypatch, small):
    compact = system.compact_map
    monkeypatch.setattr(system, "compact_map",
                        lambda *a, **k: alter(compact(*a, **k)))
    r = _run(small)
    assert r["checked"]["tier_checks"] >= 1
    assert r["correct"] is False, r["checks"]
    assert r["checks"]["tier_mismatch"]["value"] > 0
