"""Static configuration for the PyTorch port of the SLAM engine.

A copy of the JAX package's configuration dataclasses (the port imports
nothing of that package). Every knob lives in frozen dataclasses; the port
reads shapes and thresholds from them exactly as the JAX package does, so
one configuration drives both implementations identically.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class CameraConfig:
    """Pinhole camera intrinsics + image geometry.

    Mirrors the Camera.* block of the reference settings YAML
    (reference: src/Tracking.cc:53-117). Distortion is radial-tangential
    (k1, k2, p1, p2, k3); images are undistorted at the keypoint level.
    """

    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int
    fps: float = 30.0
    # Radial-tangential distortion (k1, k2, p1, p2, k3).
    k1: float = 0.0
    k2: float = 0.0
    p1: float = 0.0
    p2: float = 0.0
    k3: float = 0.0
    # Stereo: baseline times fx (reference "Camera.bf"), 0 for monocular.
    bf: float = 0.0
    # Close/far point threshold in baseline units (reference "ThDepth").
    th_depth: float = 35.0
    # RGB-D depth map scaling (reference "DepthMapFactor").
    depth_map_factor: float = 1.0

    @property
    def has_distortion(self) -> bool:
        return any(v != 0.0 for v in (self.k1, self.k2, self.p1, self.p2, self.k3))

    @property
    def baseline(self) -> float:
        return self.bf / self.fx if self.bf > 0 else 0.0

    @property
    def k_matrix(self) -> Tuple[Tuple[float, float, float], ...]:
        return (
            (self.fx, 0.0, self.cx),
            (0.0, self.fy, self.cy),
            (0.0, 0.0, 1.0),
        )


@dataclasses.dataclass(frozen=True)
class ORBConfig:
    """ORB extractor configuration.

    Mirrors the ORBextractor.* YAML block plus the C++ constants
    (reference: src/ORBextractor.cc:72-74,416-490). The per-level feature
    budget follows the same geometric series as the reference ctor.
    """

    n_features: int = 1000
    scale_factor: float = 1.2
    n_levels: int = 8
    ini_th_fast: int = 20
    min_th_fast: int = 7
    patch_size: int = 31
    half_patch_size: int = 15
    edge_threshold: int = 19
    # Spatial-balancing grid cell size in pixels at each level (the TPU
    # equivalent of the reference's 30px FAST cells + quadtree culling,
    # reference: src/ORBextractor.cc:851-915,562-815).
    cell_size: int = 32
    # Max candidate keypoints kept per cell before the global per-level top-K.
    cell_top_k: int = 8
    # Gradient-based subpixel corner refinement (ops/subpix.py). The
    # reference reports integer FAST corners; the +-0.5 px quantization is
    # the dominant map-depth error at init-scale baselines, so this is ON
    # by default (descriptor sampling stays at the integer location).
    subpixel_refine: bool = True

    def scale_factors(self) -> Tuple[float, ...]:
        return tuple(self.scale_factor ** i for i in range(self.n_levels))

    def inv_scale_factors(self) -> Tuple[float, ...]:
        return tuple(1.0 / s for s in self.scale_factors())

    def level_sigma2(self) -> Tuple[float, ...]:
        return tuple(s * s for s in self.scale_factors())

    def inv_level_sigma2(self) -> Tuple[float, ...]:
        return tuple(1.0 / s for s in self.level_sigma2())

    def features_per_level(self) -> Tuple[int, ...]:
        """Geometric-series per-level budgets summing to n_features.

        Same series as the reference ctor (src/ORBextractor.cc:416-455):
        level 0 gets the largest share, factor 1/scale_factor per level.
        """
        factor = 1.0 / self.scale_factor
        n_desired = (
            self.n_features * (1.0 - factor) / (1.0 - factor ** self.n_levels)
        )
        per_level = []
        total = 0
        for _ in range(self.n_levels - 1):
            n = int(round(n_desired))
            per_level.append(n)
            total += n
            n_desired *= factor
        per_level.append(max(self.n_features - total, 0))
        return tuple(per_level)

    def level_shapes(self, height: int, width: int) -> Tuple[Tuple[int, int], ...]:
        """Static (H, W) per pyramid level."""
        shapes = []
        for s in self.inv_scale_factors():
            shapes.append((int(round(height * s)), int(round(width * s))))
        return tuple(shapes)


@dataclasses.dataclass(frozen=True)
class MatcherConfig:
    """Descriptor matching thresholds (reference: src/ORBmatcher.cc:37-39)."""

    th_high: int = 100
    th_low: int = 50
    histo_length: int = 30
    nn_ratio_tracking: float = 0.9
    nn_ratio_bow: float = 0.75


@dataclasses.dataclass(frozen=True)
class TrackerConfig:
    """Tracking-pipeline gates (thresholds catalogued in SURVEY.md §2.1).

    Values mirror the constants scattered through src/Tracking.cc:
    - min inliers after pose optimization: 10 (src/Tracking.cc:968)
    - TrackLocalMap accept gates 50 / 30 (src/Tracking.cc:1194-1199)
    - projective search radii th=7 / 15 (src/Tracking.cc:1072-1092)
    - local keyframe cap 80 (src/Tracking.cc:1592)
    """

    min_matches_init: int = 100
    min_inliers_track: int = 10
    min_inliers_local_map: int = 30
    # Reference-faithful UpdateLastFrame pose re-anchoring + rebinding of
    # KF-spawning frames' trajectory entries to their own keyframe
    # (src/Tracking.cc:971-980, :554-585). The round-1 "fresh keyframe
    # local BA instability" that forced this off was float32 rotation
    # skew compounding through the re-anchor chain (utils/rotation.py);
    # with SO(3) projection at host boundaries the re-anchor is strictly
    # beneficial (0.43% vs 0.72% span ATE on the synthetic sweep).
    reanchor_last_frame: bool = True
    # Two-view init parallax gate, degrees (reference passes
    # minParallax=1.0 in Initializer::Initialize -> ReconstructF/H,
    # src/Initializer.cc:162-164; checked against the 51st-largest
    # per-point parallax, src/Initializer.cc:1276-1287). Slow sequences
    # that initialize at this floor produce ray-smeared structure (depth
    # errors correlated along rays through the init camera) that makes
    # rotation weakly observable and lets per-frame tracking drift
    # compound — see scripts/diag_rot.py / diag_initmap.py.
    init_min_parallax_deg: float = 1.0
    # Parallax gate for newly triangulated map points, degrees (reference
    # uses cosParallaxRays < 0.9998, i.e. ~1.1459 deg, src/LocalMapping.cc:417).
    tri_min_parallax_deg: float = 1.1459
    min_inliers_local_map_recent: int = 50
    search_radius_motion: float = 15.0
    search_radius_local_map: float = 3.0
    max_local_keyframes: int = 80
    max_local_points: int = 2048
    # Keyframe decision: min fraction of reference-KF points tracked
    # (reference thRefRatio, src/Tracking.cc:1264-1279).
    kf_ref_ratio_mono: float = 0.9
    kf_ref_ratio_stereo: float = 0.75
    kf_min_frames: int = 0
    kf_max_frames: int = 30
    # Baseline/view-angle keyframe trigger (beyond the reference). The
    # reference's only map-extension trigger is inliers < ratio*nRefMatches
    # (src/Tracking.cc:1264-1279); when matching is strong (low-noise
    # imagery) that never fires, the map stops growing, and structure laid
    # down by the short-baseline init is never refined by wide-baseline
    # triangulation + BA — measured: 1.8% frozen depth error, tracking
    # collapse once the camera leaves the init view cone. Insert a
    # keyframe whenever the camera has translated more than
    # kf_baseline_depth_ratio x (median tracked depth) or rotated more
    # than kf_view_angle_deg since the last keyframe (0 disables either).
    # Strictly additive: extra keyframes are reclaimed by the reference's
    # own redundancy culling (src/LocalMapping.cc:784-871).
    kf_baseline_depth_ratio: float = 0.025
    kf_view_angle_deg: float = 5.0
    # Local-BA window capacities. The reference's window is UNBOUNDED
    # (all covisible KFs + every second-ring observer,
    # src/Optimizer.cc:533-587); these caps bucket device shapes for
    # compile reuse. Truncation is logged, never silent.
    lba_max_free_kfs: int = 64
    lba_max_fixed_kfs: int = 64
    lba_max_points: int = 8192
    # Spatial guard for keyframe culling (beyond the reference). The
    # reference culls any keyframe whose observations are >=90% covered by
    # >=3 other keyframes at similar octaves (src/LocalMapping.cc:784-871);
    # when a scene is observed at one scale from everywhere, EVERY new
    # keyframe is instantly "redundant" and gets culled the round after
    # its creation — destroying exactly the wide-baseline observations
    # bundle adjustment needs to undo the short-baseline init's structure
    # warp (measured: a keyframe treadmill that froze the map at 5 KFs /
    # 0.06 units of baseline for a 1.5 m path). Keep a keyframe, however
    # observation-redundant, while no OTHER keyframe sits within
    # cull_min_spacing_ratio x (its median scene depth) of its camera
    # center. 0 restores pure reference behavior.
    cull_min_spacing_ratio: float = 0.02


@dataclasses.dataclass(frozen=True)
class MapConfig:
    """Fixed capacities for the array-of-struct map state."""

    max_keyframes: int = 512
    max_points: int = 65536
    # Covisibility edge threshold (shared points >= 15,
    # reference: src/KeyFrame.cc:424-447).
    covisibility_min_weight: int = 15
    # Feature grid for O(1) area queries (reference: include/Frame.h:38-39).
    grid_cols: int = 64
    grid_rows: int = 48


@dataclasses.dataclass(frozen=True)
class SystemConfig:
    """Pipeline architecture defaults.

    The reference unconditionally loads ORBvoc.txt and spawns the
    LocalMapping/LoopClosing/Viewer threads (src/System.cc:61-107); the
    same architecture is the out-of-box default here. Tests and
    deterministic tooling opt out via synthetic_config (sync mapping)."""

    # Run local mapping + loop closing on a background worker thread.
    async_mapping: bool = True
    # Load the bundled vocabulary (place recognition + loop closing on)
    # when System() is constructed without an explicit one.
    use_vocabulary: bool = True


@dataclasses.dataclass(frozen=True)
class SLAMConfig:
    """Top-level engine configuration."""

    camera: CameraConfig
    orb: ORBConfig = ORBConfig()
    matcher: MatcherConfig = MatcherConfig()
    tracker: TrackerConfig = TrackerConfig()
    map: MapConfig = MapConfig()
    system: SystemConfig = SystemConfig()
    sensor: str = "monocular"  # monocular | stereo | rgbd

    def __post_init__(self):
        if self.sensor not in ("monocular", "stereo", "rgbd"):
            raise ValueError(f"unknown sensor type: {self.sensor}")


def tum_fr1_config(sensor: str = "monocular", n_features: int = 1000) -> SLAMConfig:
    """TUM freiburg1 intrinsics and distortion, the values of the
    reference's Examples/*/TUM1.yaml (bf 40, ThDepth 40, DepthMapFactor
    5000)."""
    cam = CameraConfig(
        fx=517.306408, fy=516.469215, cx=318.643040, cy=255.313989,
        width=640, height=480, fps=30.0,
        k1=0.262383, k2=-0.953104, p1=-0.005358, p2=0.002628, k3=1.163314,
        bf=40.0, th_depth=40.0, depth_map_factor=5000.0,
    )
    return SLAMConfig(camera=cam, orb=ORBConfig(n_features=n_features), sensor=sensor)


def kitti_00_02_config(sensor: str = "stereo") -> SLAMConfig:
    """KITTI sequences 00-02, the values of the reference's
    Examples/Stereo/KITTI00-02.yaml: rectified, no distortion, bf 386.1448,
    ThDepth 35, 10 fps, 2000 features; the dataset's 1241x376 images."""
    cam = CameraConfig(
        fx=718.856, fy=718.856, cx=607.1928, cy=185.2157, width=1241, height=376,
        fps=10.0, bf=386.1448, th_depth=35.0,
    )
    orb = ORBConfig(n_features=2000, scale_factor=1.2, n_levels=8, ini_th_fast=20,
                    min_th_fast=7)
    return SLAMConfig(camera=cam, orb=orb, sensor=sensor)


# EuRoC's raw cameras, Examples/Stereo/EuRoC.yaml's LEFT.K / LEFT.D and
# RIGHT.K / RIGHT.D: ((fx, fy, cx, cy), (k1, k2, p1, p2, k3)).
EUROC_RAW_CAMERAS = {
    "LEFT": ((458.654, 457.296, 367.215, 248.375),
             (-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05, 0.0)),
    "RIGHT": ((457.587, 456.134, 379.999, 255.238),
              (-0.28368365, 0.07451284, -0.00010473, -3.555907e-05, 0.0)),
}


def euroc_stereo_config(sensor: str = "stereo") -> SLAMConfig:
    """EuRoC MAV, the values of the reference's Examples/Stereo/EuRoC.yaml:
    the rectified pinhole (its P matrices), bf 47.906, ThDepth 35, 20 fps,
    1200 features; the dataset's 752x480 images. The raw cameras the pairs
    are rectified from are EUROC_RAW_CAMERAS."""
    cam = CameraConfig(
        fx=435.2046959714599, fy=435.2046959714599, cx=367.4517211914062,
        cy=252.2008514404297, width=752, height=480, fps=20.0, bf=47.90639384423901,
        th_depth=35.0,
    )
    orb = ORBConfig(n_features=1200, scale_factor=1.2, n_levels=8, ini_th_fast=20,
                    min_th_fast=7)
    return SLAMConfig(camera=cam, orb=orb, sensor=sensor)


def synthetic_config(
    width: int = 640,
    height: int = 480,
    n_features: int = 1000,
    sensor: str = "monocular",
) -> SLAMConfig:
    """Distortion-free pinhole config for synthetic-sequence tests."""
    f = 0.8 * width
    # Stereo baseline 0.3 m: ~16 px disparity at 6 m depth with f = 0.8*w,
    # enough for subpixel-accurate metric depth in tests.
    cam = CameraConfig(
        fx=f, fy=f, cx=width / 2.0, cy=height / 2.0,
        width=width, height=height, fps=30.0,
        bf=0.3 * f if sensor != "monocular" else 0.0,
        th_depth=40.0,
    )
    return SLAMConfig(
        camera=cam, orb=ORBConfig(n_features=n_features), sensor=sensor,
        # Deterministic synchronous pipeline for tests/tools; the bundled
        # vocabulary (place recognition) stays on, matching the reference.
        system=SystemConfig(async_mapping=False),
        # Test maps are small; a tighter local-BA window keeps the f64 CPU
        # solves inside the test-time budget (production default: 64/64/8192).
        tracker=TrackerConfig(
            lba_max_free_kfs=32, lba_max_fixed_kfs=32, lba_max_points=4096,
        ),
    )
