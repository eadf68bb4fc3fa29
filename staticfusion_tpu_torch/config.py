"""Configuration for the PyTorch port: plain frozen dataclasses.

A field-for-field copy of `staticfusion_tpu/config.py`: same names, same
defaults, same JSON form (tests/test_torch_package.py pins the round trip),
so one config file drives both packages.  It is copied rather than imported
because importing any module of the JAX package imports jax.
"""

from __future__ import annotations

import dataclasses
import json
import math
from typing import Optional, Tuple

NUM_CLUSTERS = 24  # StaticFusion.h:61


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Joint odometry + segmentation solver parameters.

    Defaults follow the datasets main (StaticFusion-datasets.cpp:79-94),
    which overrides the ctor defaults (FrontEnd.cpp:65-76).
    """

    k_photometric_res: float = 0.15     # weight of photometric vs geometric residuals
    irls_delta_threshold: float = 0.0015  # convergence on ||delta xi||_inf
    max_iter_irls: int = 6
    max_iter_per_level: int = 3
    kc_cauchy: float = 0.5
    kb: float = 1.5                      # static bias of the segmentation data term
    kb_bootstrap: float = 1.05           # lenient warm-up value (StaticFusion-datasets.cpp:121,158)
    kz: float = 1.5                      # depth-residual factor of the seg prior
    lambda_reg: float = 1.2              # spatial regularization between connected clusters. The reference ships 0.35 (StaticFusion-datasets.cpp:88), tuned for real TUM data; on the adversarial walker suite the measured optimum is far higher (round-4 chip sweep, 3 seeds, 40f walk: IoU 0.35-0.45 @ 0.35 -> 0.58 @ 0.9 -> 0.72-0.74 @ 1.2 with ATE 7x better; ACCURACY.md) - stronger coupling lets fully-static neighbor clusters pull mixed boundary clusters to coherent labels. Use solver_preset_ctor/datasets for reference-exact values.
    lambda_prior: float = 0.5            # temporal prior weight
    use_motion_filter: bool = True
    previous_speed_const_weight: float = 0.1
    previous_speed_eig_weight: float = 2.0
    level_twist_convergence: float = 0.04  # early exit ||xi_level|| (FrontEnd.cpp:1130)
    kmeans_iters: int = 10               # KMeans.cpp:142
    kmeans_tol: float = 1e-2             # KMeans.cpp:227
    kmeans_level: int = -1               # pyramid level the Lloyd iterations
                                         # run at; -1 = auto: shallowest
                                         # level with <=120 rows (level 1 at
                                         # QVGA — reference-exact there; the
                                         # reference's own rule is rows/2 of
                                         # its WORKING res, so VGA would be
                                         # 240 rows — auto level 2 at VGA is
                                         # a deliberate perf deviation; set
                                         # explicitly to restore rows/2)
    fused_irls: bool = True              # kept for config parity; the
                                         # port always runs the CUDA IRLS
                                         # kernel on CUDA tensors and the
                                         # plain loop on CPU tensors


@dataclasses.dataclass(frozen=True)
class FusionConfig:
    """Surfel-map backend parameters (reference: Reconstruction/GlobalModel/IndexMap)."""

    capacity: int = 1 << 20              # max surfels (reference VBO holds 3072^2 ~ 9.4M for VGA, GlobalModel.cpp:21; every per-surfel op scales with this, so size it to the scene)
    confidence_threshold: float = 0.25   # FrontEnd.cpp:167
    low_conf: float = 0.13               # Reconstruction.cpp:630
    depth_max: float = 4.5               # FrontEnd.cpp:168
    depth_min: float = 0.3               # depth_metric.frag:32 (300 mm gate)
    index_factor: int = 4                # index-map super-resolution factor; 4 matches the reference (IndexMap.cpp:21) and is the accuracy-best measured config (ACCURACY.md). Even F>1 runs the surfel-major sparse fuse (fusion/sparse.py); the port implements only that path
    post_factor: int = 2                 # texel factor of the post-merge clean window test + prediction splat in the sparse fuse; 0 = index_factor, 1 = camera res. Default 2: best measured walk-suite ATE/IoU across seeds (ACCURACY.md round 3). Ignored at index_factor 1.
    route_factor: int = 0                # F=1 dense-fuse routing stride: the fuse (render/associate/merge/clean/insert) runs on an (H/route, W/route) grid while the solver keeps native resolution. 0 = auto: cap the fuse grid at QVGA rows (1 at <=QVGA — no change; 2 at VGA). The reference runs EVERYTHING at QVGA (res_factor=2 in all mains, README.md:97). Set 1 to force full-resolution mapping. The port does not implement routed fusion yet.
    time_delta: int = 200                # Reconstruction.h (timeDelta window)
    velocity_weight_cap: float = 0.15    # Reconstruction.cpp:274
    velocity_weight_floor: float = 0.5   # Reconstruction.cpp:275
    new_unstable_conf: float = 0.08      # data.vert:179
    new_static_prob_gate: float = 0.5    # data.vert:178
    assoc_depth_gate: float = 0.05       # data.vert:142 (|lambda dz| < 0.05)
    assoc_normal_z_gate: float = 0.75    # data.vert:151
    assoc_angle_gate: float = 0.5        # data.vert:151 (radians)
    merge_radius_factor: float = 1.5     # update.vert:73 (newRadius < 1.5*oldRadius)
    clean_redundant_count: int = 6       # copy_unstable.vert:116 (count > 6)
    clean_free_space_count: int = 5      # copy_unstable.vert:116 (zCount > 5)
    clean_unstable_age: int = 10         # copy_unstable.vert:~118
    clean_unstable_conf: float = 0.5
    dense_threshold: float = 0.25        # Reconstruction.cpp:232
    dense_scale: int = 40                # imageBuff is rows/40 x cols/40 (Reconstruction.cpp:35)
    predict_z_min: float = 0.4           # splat.vert:50 near cull
    fillin_vertex_conf: float = 0.12     # fill_vertex.frag:52
    fillin_static_gate: float = 0.6      # fill_vertex.frag:50
    max_new_per_frame: int = 0           # 0 -> defaults to pixels per frame


@dataclasses.dataclass(frozen=True)
class CameraConfig:
    """Camera geometry. Defaults: TUM-style QVGA with the reference FOV model.

    The reference derives intrinsics from a fixed FOV (FrontEnd.cpp:57-63):
      fx = 0.5*cols/tan(fovh/2), fy = 0.5*rows/tan(fovv/2), c = (cols/2, rows/2).
    The CPU solver uses a separate pinhole with a single focal from fovh and
    principal point ((cols-1)/2, (rows-1)/2) (FrontEnd.cpp:377-380,537).
    """

    width: int = 320
    height: int = 240
    fovh_deg: float = 62.5
    fovv_deg: float = 48.5

    @property
    def fovh(self) -> float:
        return math.pi * self.fovh_deg / 180.0

    @property
    def fovv(self) -> float:
        return math.pi * self.fovv_deg / 180.0

    @property
    def fx(self) -> float:
        return 0.5 * self.width / math.tan(0.5 * self.fovh)

    @property
    def fy(self) -> float:
        return 0.5 * self.height / math.tan(0.5 * self.fovv)

    @property
    def cx(self) -> float:
        return self.width / 2.0

    @property
    def cy(self) -> float:
        return self.height / 2.0


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Device-mesh layout for the distributed build (no reference counterpart).

    axes: `pix` shards image rows for solver reductions; `map` shards surfel
    blocks for the fusion backend. Sizes multiply to the device count.
    """

    pix: int = 1
    map: int = 1

    @property
    def n_devices(self) -> int:
        return self.pix * self.map


@dataclasses.dataclass(frozen=True)
class LoopClosureConfig:
    """Keyframe loop closure (net-new: the reference logs its pose graph,
    Reconstruction.cpp:315, but never optimizes it)."""

    enabled: bool = False
    kf_interval: int = 10     # frames between stored keyframes
    capacity: int = 64        # keyframe slots (fixed shapes)
    min_gap: int = 30         # frames a match must be older than the query
    max_fp_dist: float = 0.3    # fingerprint acceptance — the CHEAP
                                # pre-filter only (false closures are
                                # rejected by max_residual below, which is
                                # what the negative tests pin).  The
                                # distance is the TRIMMED per-cell score
                                # (keyframes.query): a plain MSE is
                                # dominated by the moving object on
                                # genuine dynamic-scene revisits (measured
                                # walk_loop: same-pose pairs 0.43-0.58 vs
                                # the old 0.2 gate -> zero closures).
                                # Calibration on walk_loop seed 0:
                                # genuine revisits 0.13-0.26 trimmed,
                                # wrong-place pairs >= 0.39; clean-scene
                                # revisits remain ~1e-3.
    max_residual: float = 0.03  # joint depth+photometric verification
                                # gate (m).  Walk/room scenes: genuine
                                # matches ~5e-4, aliased same-texture/
                                # different-geometry pairs ~0.14.
                                # CORRIDOR calibration (round-5 chip run,
                                # 300-frame corridor_loop, 18 candidate
                                # closures): z-aliased pairs 1-5 m apart
                                # score 0.024-0.039 — side-wall depth is
                                # z-shift-invariant in a corridor, so
                                # only the texture term discriminates —
                                # while genuine return-leg revisits score
                                # 0.013-0.028.  The populations OVERLAP,
                                # so the residual alone cannot separate
                                # them (at the old 0.04 every false
                                # passed and corridor ATE got worse, 2.13
                                # vs 1.89 closure-off); the
                                # max_drift_rate budget below is the
                                # discriminating gate, and 0.03 admits
                                # the full genuine band..
    max_drift_rate: float = 0.02  # m/frame drift budget for closure
                                # acceptance: a closure implying a
                                # correction larger than
                                # max_drift_rate * (frames since the
                                # matched keyframe) + 0.05 is rejected as
                                # physically implausible.  Calibration
                                # (round-5 corridor chip runs): z-aliased
                                # false closures demand 1.5-2.1 m
                                # corrections 30-40 frames after their
                                # keyframe (budget 0.65-0.85 m) while
                                # genuine corridor revisits 240 frames
                                # out demand ~2 m against a 4.9 m budget
                                # and walk-suite closures demand
                                # 0.01-0.07 m against >=0.95 m; measured
                                # drift rates are ~0.002 (walk) and
                                # ~0.007 (corridor) m/frame, so the 0.02
                                # budget carries 3-10x margin.
    loop_weight: float = 4.0  # loop vs odometry constraint weight
    gn_iters: int = 10        # pose-graph Gauss-Newton iterations
    smooth_skip: int = 0      # periodic chain smoothing: on keyframe ticks
                              # with no closure, measure a skip constraint
                              # (keyframe count-skip -> current frame) and
                              # optimize the chain against it.  OFF by
                              # default: measured on the 100-frame walk
                              # suite it moved ATE {0.199->0.201,
                              # 0.216->0.234, 0.223->0.226} — the
                              # wide-baseline solve shares the walker
                              # contamination, so the extra constraint
                              # adds noise, not information (ACCURACY.md
                              # round 4); opt-in for static scenes
    smooth_weight: float = 1.0  # skip-constraint weight vs the chain
    deform_map: bool = True   # piecewise-rigid surfel-map correction on
                              # closure (keyframes.deform_map)


@dataclasses.dataclass(frozen=True)
class SFConfig:
    camera: CameraConfig = dataclasses.field(default_factory=CameraConfig)
    solver: SolverConfig = dataclasses.field(default_factory=SolverConfig)
    fusion: FusionConfig = dataclasses.field(default_factory=FusionConfig)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)
    loop: LoopClosureConfig = dataclasses.field(
        default_factory=LoopClosureConfig)
    num_clusters: int = NUM_CLUSTERS
    buffer_length: int = 5               # temporal residual ring (StaticFusion.h:96)
    rescue_residual_threshold: float = 0.017  # SegmentationBackground.cpp:190

    @property
    def rows(self) -> int:
        return self.camera.height

    @property
    def cols(self) -> int:
        return self.camera.width

    @property
    def ctf_levels(self) -> int:
        # FrontEnd.cpp:61 — log2(cols/40)+2; 5 levels at QVGA.
        return int(math.log2(self.cols / 40)) + 2

    def level_shape(self, level: int) -> Tuple[int, int]:
        """(rows, cols) of pyramid level `level` (0 = finest)."""
        s = 1 << level
        return self.rows // s, self.cols // s

    def replace(self, **kw) -> "SFConfig":
        return dataclasses.replace(self, **kw)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @staticmethod
    def from_json(text: str) -> "SFConfig":
        raw = json.loads(text)
        return SFConfig(
            camera=CameraConfig(**raw.get("camera", {})),
            solver=SolverConfig(**raw.get("solver", {})),
            fusion=FusionConfig(**raw.get("fusion", {})),
            mesh=MeshConfig(**raw.get("mesh", {})),
            loop=LoopClosureConfig(**raw.get("loop", {})),
            **{k: v for k, v in raw.items()
               if k not in ("camera", "solver", "fusion", "mesh", "loop")},
        )


def solver_preset_ctor() -> SolverConfig:
    """The reference ctor defaults (FrontEnd.cpp:65-76)."""
    return SolverConfig(
        irls_delta_threshold=1e-6,
        max_iter_irls=10,
        max_iter_per_level=2,
        previous_speed_const_weight=0.05,
        previous_speed_eig_weight=0.5,
        kb=1.25,
        lambda_reg=0.35,
        use_motion_filter=False,
    )


def solver_preset_datasets() -> SolverConfig:
    """The datasets main's overrides (StaticFusion-datasets.cpp:79-94).

    lambda_reg is pinned to the reference's 0.35 here; the repo default is
    the suite-measured optimum (see SolverConfig.lambda_reg)."""
    return SolverConfig(lambda_reg=0.35)
