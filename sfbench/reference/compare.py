"""The comparison that decides `correct`.

A SLAM session is a chain: each frame's answer depends on the state that
the frames before it left.  Free-running, two float32 implementations
part within a few frames (texel-boundary ties in the fuse), so the
reference follows the program step by step: it starts from the program's
own state before a checked frame, steps it with the frozen plain step
(sf/), and compares the answers of that frame.  The start of the chain,
the bootstrap of frames 0 and 1, is checked by itself from the inputs
alone, and held to limits of its own.  Tensors of the program's state are
read, never written.

The numbers read from each checked frame (`frame_numbers`):

* pose_gap: the largest absolute difference of the 4x4 pose after the
  frame (metres in the translation column);
* map_gap: over the slots of surfels that the map held before the frame
  (below its high-water mark `used`; every slot for the bootstrap's new
  map) and that both sides updated in it, the MAP_QUANTILE quantile of
  the largest absolute position difference (inf when no slot qualifies:
  a step that updated nothing).  Slots appended in the frame are left
  out: one insert more or less on one side shifts every later append by
  a slot;
* map_diff_share: over the same older slots valid on either side, the
  share that differ: valid on one side only, or a position apart by
  more than POS_TOL_M, or a confidence by more than CONF_TOL relative.
  The bootstrap's map is frame 1's pixels, slot i pixel i, placed by the
  solved pose, with the 8-bit quantised static probability for
  confidence.  A bootstrap solve can part from the reference's by 5e-5
  in the pose, and by as much as the control's in the segmentation
  (PERF.md), which moves every surfel by about 5e-5 m and whole
  clusters' confidences by levels.  So its share counts validity and a
  position apart by more than BOOT_POS_TOL_M, and its confidences are
  held by conf_mismatch instead;
* conf_mismatch (the bootstrap only): the share of the map's valid slots
  whose confidence is not the 8-bit quantised static probability of
  its pixel, as the program's own static_prob output gives it: the map's
  rule, held exactly, on the program's segmentation;
* conf_gap, valid_share: the MAP_QUANTILE quantile of the relative
  confidence difference over the slots of map_gap, and the share of the
  older slots valid on one side only; bsegm_gap, static_prob_gap: the
  largest difference of the per-cluster static scores b_segm and the
  mean difference of the per-pixel static probability (these four are
  read, not held: PERF.md gives why).

The solver's convergence tests compare a step's size with a threshold
(`irls_delta_threshold`), and float summation order can put the program
and the reference on two sides of it, one IRLS step apart.  So a frame
that reads over a limit is stepped again by the reference with the
threshold TIE_NUDGE above and below, and is judged by the variant whose
pose is nearest the program's: a tie broken the other way, and nothing
else, is forgiven.

The tier check (`SlamSystem._maybe_resize_map`) is judged apart
(`tier_mismatch`): the surfels of the live map and of the archive after
a repack are compared, as multisets of their bits, with a plain repack of
the map before it.

A run's reading of a step-frame number is its worst checked frame, or,
where the limits file forgives n frames (FORGIVE), its (n+1)-th worst
(inf when fewer frames were checked).  Only the numbers with a limit in
the configuration's limits file decide `correct` (PERF.md gives the
readings they were set from).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
from typing import NamedTuple

import numpy as np
import torch

from sfbench.reference.sf.config import SFConfig
from sfbench.reference.sf.fusion import backend
from sfbench.reference.sf.fusion.predict import PredictedView
from sfbench.reference.sf.fusion.surfels import SurfelMap, quantize8
from sfbench.reference.sf.pipeline import step as ref_step
from sfbench.reference.sf.pipeline.state import RingBuffers, SlamState

STEP_NUMBERS = ("pose_gap", "map_gap", "map_diff_share", "conf_gap",
                "valid_share", "bsegm_gap", "static_prob_gap",
                "conf_mismatch")
BOOTSTRAP = "bootstrap."
FORGIVE = "forgive_frames"
MAP_QUANTILE = 0.97
DETAIL_QUANTILES = (0.5, 0.9, 0.95, 0.99)
TIE_NUDGE = 1e-3
POS_TOL_M = 1e-5
CONF_TOL = 1e-4
BOOT_POS_TOL_M = 1e-4
_NESTED = {"smap": SurfelMap, "rings": RingBuffers, "pred": PredictedView}
# The per-slot fields of a surfel, in the order of its row.
ROW_FIELDS = ("pos", "conf", "color", "hist", "init_time", "last_time",
              "normal", "radius")


class Sample(NamedTuple):
    """One checked frame: the program's state before it (None for the
    bootstrap), the inputs the harness handed over (host arrays), and
    the program's (state, outputs) after it."""
    kind: str        # "bootstrap" or "step"
    before: object
    inputs: tuple    # (rgb, depth_mm) or (rgb0, depth0, rgb1, depth1, pose)
    after: tuple     # (state, StepOutputs) of the program


class TierSample(NamedTuple):
    """One tier check that replaced the live map or the archive: the
    session's tick, and its live map and archive (None when empty)
    before and after the check."""
    tick: int
    before: tuple    # (live SurfelMap, archive SurfelMap or None)
    after: tuple


def reference_config(config_dict: dict) -> SFConfig:
    return SFConfig.from_json(json.dumps(config_dict))


@contextlib.contextmanager
def precision(tf32: bool):
    """Float32 matmuls and convolutions with TF32 off (the configuration's
    precision), or on (the control, one step below it)."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def as_reference_state(state) -> SlamState:
    """The program's state as the reference's types, field by field (the
    tensors are shared and only read)."""
    def build(cls, node):
        return cls(**{f: (build(_NESTED[f], getattr(node, f))
                          if f in _NESTED else getattr(node, f))
                      for f in cls._fields})
    return build(SlamState, state)


def _frame(rgb, depth_mm, device) -> ref_step.Frame:
    return ref_step.Frame(rgb=torch.as_tensor(rgb, device=device),
                          depth_mm=torch.as_tensor(depth_mm, device=device))


def nudged(config: SFConfig, factor: float) -> SFConfig:
    """The configuration with the convergence threshold times `factor`."""
    solver = dataclasses.replace(
        config.solver,
        irls_delta_threshold=config.solver.irls_delta_threshold * factor)
    return dataclasses.replace(config, solver=solver)


def reference_answer(sample: Sample, config: SFConfig, device,
                     tf32: bool = False) -> tuple:
    """(state, outputs) of the frozen step on the sample's inputs."""
    with precision(tf32), torch.no_grad():
        if sample.kind == "bootstrap":
            rgb0, d0, rgb1, d1, pose = sample.inputs
            return ref_step.bootstrap_step(
                _frame(rgb0, d0, device), _frame(rgb1, d1, device),
                torch.as_tensor(pose, dtype=torch.float32, device=device),
                config)
        rgb, depth = sample.inputs
        return ref_step.slam_step(as_reference_state(sample.before),
                                  _frame(rgb, depth, device), config)


def _diff(a, b, dev):
    """|a - b| in float64, 0 where both are NaN, inf where one is."""
    a = a.detach().to(dev, torch.float64)
    b = b.detach().to(torch.float64)
    d = torch.abs(a - b)
    d = torch.where(torch.isnan(a) & torch.isnan(b), torch.zeros_like(d), d)
    return torch.nan_to_num(d, nan=float("inf"))


def _quantile(d: torch.Tensor, q: float) -> float:
    """The q quantile of `d` (nearest rank), inf when it is empty."""
    if d.numel() == 0:
        return float("inf")
    s = torch.sort(d.reshape(-1)).values
    return float(s[min(s.numel() - 1, int(math.ceil(q * s.numel())) - 1)])


def map_numbers(a, b, n_old: int, detail: bool = False,
                pos_tol: float = POS_TOL_M,
                conf_tol: float = CONF_TOL) -> dict:
    """map_gap, map_diff_share, conf_gap and valid_share of map `a`
    against map `b` over their slots below `n_old` (see the module's
    docstring), slots apart by more than `pos_tol` or `conf_tol`
    differing; with `detail` also map_gap at DETAIL_QUANTILES, and the
    share at the other tolerances as map_diff_share_other."""
    if a.pos.shape != b.pos.shape:
        out = {"map_gap": float("inf"), "map_diff_share": 1.0,
               "conf_gap": float("inf"), "valid_share": 1.0}
        if detail:
            out.update({f"map_gap_q{int(100 * q)}": float("inf")
                        for q in DETAIL_QUANTILES})
        return out
    dev = b.pos.device
    old = torch.arange(b.valid.shape[0], device=dev) < n_old
    va, vb = a.valid.to(dev) & old, b.valid & old
    union = max(1, int(torch.sum((va | vb).to(torch.int64))))
    dpos = torch.amax(_diff(a.pos, b.pos, dev), dim=1)
    dconf = (_diff(a.conf, b.conf, dev)
             / torch.clamp(torch.abs(b.conf.to(torch.float64)), min=1.0))

    def share(p_tol, c_tol):
        differ = (va != vb) | (va & vb & ((dpos > p_tol) | (dconf > c_tol)))
        return float(torch.sum(differ.to(torch.int64))) / union
    if bool(torch.any(vb)):
        newest = torch.max(b.last_time[vb])
        both = (va & vb & (a.last_time.to(dev) == newest)
                & (b.last_time == newest))
    else:
        both = torch.zeros_like(vb)
    out = {"map_gap": _quantile(dpos[both], MAP_QUANTILE),
           "map_diff_share": share(pos_tol, conf_tol),
           "conf_gap": _quantile(dconf[both], MAP_QUANTILE),
           "valid_share": float(torch.sum((va != vb).to(torch.int64))) / union}
    if detail:
        out.update({f"map_gap_q{int(100 * q)}": _quantile(dpos[both], q)
                    for q in DETAIL_QUANTILES})
        out["updated"] = int(torch.sum(both.to(torch.int64)))
        other = ((BOOT_POS_TOL_M, math.inf) if pos_tol == POS_TOL_M
                 else (POS_TOL_M, CONF_TOL))
        out["map_diff_share_other"] = share(*other)
    return out


def frame_numbers(got: tuple, want: tuple, n_old: int,
                  detail: bool = False, bootstrap: bool = False) -> dict:
    """The numbers of one frame: `got` is the (state, outputs) judged,
    `want` the reference's; `n_old` the map's slots held before it; the
    bootstrap's map share at its own tolerances."""
    (s_got, o_got), (s_want, o_want) = got, want
    dev = o_want.curr_pose.device
    out = {"pose_gap": float(torch.max(_diff(o_got.curr_pose,
                                             o_want.curr_pose, dev))),
           "bsegm_gap": float(torch.max(_diff(o_got.b_segm, o_want.b_segm,
                                              dev))),
           "static_prob_gap": float(torch.mean(_diff(
               o_got.static_prob, o_want.static_prob, dev)))}
    tols = ((BOOT_POS_TOL_M, math.inf) if bootstrap
            else (POS_TOL_M, CONF_TOL))
    out.update(map_numbers(s_got.smap, s_want.smap, n_old, detail, *tols))
    return out


def conf_mismatch(got: tuple, config: SFConfig) -> float:
    """conf_mismatch of a bootstrap's (state, outputs) `got` (see the
    module's docstring); a valid slot past the routed grid's pixels
    counts as a mismatch too."""
    smap, sp = got[0].smap, got[1].static_prob
    rf = backend.effective_route_factor(config)
    sp = sp[::rf, ::rf].reshape(-1).to(smap.conf.device)
    n = min(sp.numel(), smap.valid.shape[0])
    valid = smap.valid[:n]
    bad = int(torch.sum((valid & (smap.conf[:n] != quantize8(sp[:n])))
                        .to(torch.int64)))
    bad += int(torch.sum(smap.valid[n:].to(torch.int64)))
    return bad / max(1, int(torch.sum(valid.to(torch.int64))))


def _held(limits: dict, prefix: str) -> dict:
    return {k[len(prefix):]: float(v) for k, v in limits.items()
            if k.startswith(prefix) and k[len(prefix):] in STEP_NUMBERS}


def _over(numbers: dict, held: dict) -> bool:
    return any(not (numbers[k] <= v) for k, v in held.items())


def judge_frame(sample: Sample, got: tuple, config: SFConfig, device,
                held: dict, detail: bool = False) -> dict:
    """The numbers of one checked frame.  The reference steps at the
    configured threshold; if that reads over a held limit (or with
    `detail`, always) also with the threshold nudged both ways, and the
    frame takes the variant whose pose is nearest `got`'s.  With `detail`
    the result also lists every variant's numbers."""
    boot = sample.before is None
    n_old = (got[0].smap.valid.shape[0] if boot
             else int(sample.before.smap.used))
    own = {"conf_mismatch": conf_mismatch(got, config)} if boot else {}
    variants = [dict(frame_numbers(got, reference_answer(sample, config,
                                                         device),
                                   n_old, detail, boot), **own)]
    if detail or _over(variants[0], held):
        for f in (1.0 + TIE_NUDGE, 1.0 - TIE_NUDGE):
            variants.append(dict(frame_numbers(
                got, reference_answer(sample, nudged(config, f), device),
                n_old, detail, boot), **own))
    best = min(range(len(variants)),
               key=lambda i: (variants[i]["pose_gap"], i))
    out = dict(variants[best], variant=best)
    if detail:
        out["variants"] = variants
    return out


# The tier check.

def _rows(smap) -> np.ndarray:
    """The valid surfels' rows (ROW_FIELDS), as int32 bit patterns on the
    host."""
    if smap is None:
        return np.zeros((0, 14), np.int32)
    v = smap.valid
    cols = [getattr(smap, f)[v].reshape(int(torch.sum(v)), -1)
            .to(torch.float32) for f in ROW_FIELDS]
    return torch.cat(cols, dim=1).contiguous().view(torch.int32).cpu().numpy()


def _multiset_gap(a: np.ndarray, b: np.ndarray) -> int:
    """Rows in one multiset and not the other, counted with multiplicity."""
    both = np.concatenate([a, b])
    if both.shape[0] == 0:
        return 0
    keys = np.ascontiguousarray(both).view(
        np.dtype((np.void, both.dtype.itemsize * both.shape[1]))).ravel()
    _, inv = np.unique(keys, return_inverse=True)
    inv = inv.reshape(-1)
    ca = np.bincount(inv[:a.shape[0]], minlength=inv.max() + 1)
    cb = np.bincount(inv[a.shape[0]:], minlength=inv.max() + 1)
    return int(np.abs(ca - cb).sum())


def tier_mismatch(sample: TierSample, config: SFConfig) -> float:
    """The share of the surfels that a plain repack keeps, and that the
    program's live map and archive after the check lack or hold in
    excess or altered (0 when exact).  The plain repack: where the
    program moved surfels to the archive (its archive changed), every
    surfel of the live map unseen for more than `time_delta` frames goes
    there and the rest stay; otherwise every surfel stays.  A valid slot
    at or past the live map's high-water mark `used` counts as one wrong
    surfel too."""
    (live0, arch0), (live1, arch1) = sample.before, sample.after
    stale = live0.valid & ((float(sample.tick) - live0.last_time)
                           > config.fusion.time_delta)
    archived = arch1 is not arch0
    keep = live0.valid & ~stale if archived else live0.valid
    want_live = _rows(live0._replace(valid=keep))
    bad = _multiset_gap(_rows(live1), want_live)
    total = want_live.shape[0]
    if archived:
        want_arch = np.concatenate(
            [_rows(arch0), _rows(live0._replace(valid=live0.valid & stale))])
        bad += _multiset_gap(_rows(arch1), want_arch)
        total += want_arch.shape[0]
    slots = torch.arange(live1.valid.shape[0], device=live1.valid.device)
    bad += int(torch.sum((live1.valid & (slots >= live1.used)).to(
        torch.int64)))
    return bad / max(1, total)


# A run's readings.

def judge(samples: list, tiers: list, config_dict: dict, device,
          limits: dict, control: bool = False, detail: bool = False):
    """(per-frame numbers, tier-check numbers, the run's readings of the
    held numbers).  The
    program's answers are judged, or with `control` the control's: the
    reference computed one step below the configuration's precision (TF32
    matmuls), put in the program's place (the tier check has no control
    and is left out)."""
    config = reference_config(config_dict)
    step_held = _held(limits, "")
    boot_held = _held(limits, BOOTSTRAP)
    rows = []
    for s in samples:
        got = (reference_answer(s, config, device, tf32=True) if control
               else s.after)
        held = boot_held if s.kind == "bootstrap" else step_held
        rows.append(dict(judge_frame(s, got, config, device, held, detail),
                         kind=s.kind))
        del got
    tier = [] if control else [tier_mismatch(t, config) for t in tiers]
    return rows, tier, readings(rows, tier, limits)


def readings(rows: list, tier: list, limits: dict) -> dict:
    """The run's reading of each number with a limit (see the module's
    docstring), from the checked frames' numbers and the tier checks'."""
    allow = int(limits.get(FORGIVE, 0))
    step = [r for r in rows if r["kind"] == "step"]
    boot = [r for r in rows if r["kind"] == "bootstrap"]
    step_held = _held(limits, "")
    out = {}
    for k in step_held:
        vals = sorted((r[k] for r in step), reverse=True)
        out[k] = vals[allow] if len(vals) > allow else float("inf")
    for k in _held(limits, BOOTSTRAP):
        out[BOOTSTRAP + k] = max([r[k] for r in boot] or [float("inf")])
    if "tier_mismatch" in limits:
        out["tier_mismatch"] = max(tier or [0.0])
    return out


def held_limits(limits: dict) -> dict:
    """The limits file's numbers with a limit (all but FORGIVE)."""
    return {k: float(v) for k, v in limits.items() if k != FORGIVE}


def is_correct(values: dict, limits: dict) -> bool:
    return all(k in values and math.isfinite(values[k]) and values[k] <= v
               for k, v in held_limits(limits).items())


def checked(rows: list, tiers: list) -> dict:
    """How many frames and tier checks a run's check covered."""
    return {"bootstrap": sum(r["kind"] == "bootstrap" for r in rows),
            "steps": sum(r["kind"] == "step" for r in rows),
            "tier_checks": len(tiers)}
