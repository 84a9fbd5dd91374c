"""Config tree of the closed-loop rollouts.

A copy of the dataclasses of `thinktwice_tpu/config.py` that this package
reads (`SimConfig`, `BirdviewConfig`, `CameraConfig`, `LidarConfig`,
`ModelConfig`, `RoachConfig`, `TrainConfig` and the `Config` that holds
them), with the same field names and defaults, so a test can build one of
each from the same numbers. `ModelConfig` has the port's own fields besides,
`SPARSE_LIDAR_FIELDS`: the published sparse LiDAR encoder's, which the JAX
package does not have; their defaults leave the pillar encoder in place.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """World-step semantics (20 Hz tick, kinematic bicycle, IDM traffic)."""

    dt: float = 0.05
    max_vehicles: int = 128
    max_walkers: int = 32
    max_lights: int = 64
    max_stop_signs: int = 32
    max_route_len: int = 1024
    max_scenarios: int = 32

    # kinematic bicycle constants (World-on-Rails EgoModel)
    front_wb: float = -0.090769015
    rear_wb: float = 1.4178275
    steer_gain: float = 0.36848336
    brake_accel: float = -4.952399
    throt_accel: float = 0.5633837
    drag: float = 0.02

    # background-traffic policy
    npc_cruise_speed: float = 6.0
    npc_accel: float = 3.0
    npc_decel: float = 6.0
    npc_gap: float = 4.5
    npc_time_headway: float = 1.2
    npc_max_yaw_rate: float = 1.2
    npc_lookahead: float = 6.0
    tl_stop_distance: float = 24.0
    npc_recycle_s: float = 20.0
    courtesy_yield: bool = True

    # route progress / failure semantics
    blocked_speed: float = 0.1
    blocked_time: float = 90.0
    timeout_per_meter: float = 0.8
    timeout_base: float = 5.0
    offroute_allowance: float = 30.0
    offlane_allowed_dist: float = 1.3

    ego_extent_x: float = 2.45
    ego_extent_y: float = 1.06


@dataclasses.dataclass(frozen=True)
class BirdviewConfig:
    """Roach privileged BEV raster: 192 x 192 px at 5 px/m."""

    width: int = 192
    pixels_ev_to_bottom: int = 40
    pixels_per_meter: float = 5.0
    history_idx: Tuple[int, ...] = (-16, -11, -6, -1)
    history_len: int = 16
    scale_bbox: bool = True
    route_thickness: float = 8.0
    stopline_thickness: float = 3.0
    n_route_points: int = 80

    @property
    def n_channels(self) -> int:
        # road, route, lane, then vehicles, walkers, lights per history frame
        return 3 + 3 * len(self.history_idx)


@dataclasses.dataclass(frozen=True)
class CameraConfig:
    """Multi-camera raster: front, left, right and back pinhole cameras."""

    n_cams: int = 4
    height: int = 256
    width: int = 512
    fov_deg: float = 150.0
    cam_yaws: Tuple[float, ...] = (0.0, -90.0, 90.0, 180.0)  # deg from heading
    cam_height: float = 1.8          # mount height (m)
    max_depth: float = 60.0


@dataclasses.dataclass(frozen=True)
class LidarConfig:
    """Ray-cast lidar of 64 beams x 1024 azimuth steps."""

    n_beams: int = 64
    n_azimuth: int = 1024
    upper_fov: float = 10.0
    lower_fov: float = -30.0
    max_range: float = 85.0
    z_mount: float = 2.5


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """ThinkTwice student encoder and decoder widths."""

    bev_size: int = 21               # 21 x 21 BEV cells
    bev_x_min: float = -8.0
    bev_x_max: float = 30.4
    bev_y_min: float = -19.2
    bev_y_max: float = 19.2
    bev_channels: int = 256
    n_depth_bins: int = 80           # [1, 41) m at 0.5 m
    depth_min: float = 1.0
    depth_step: float = 0.5
    n_seg_classes: int = 12
    pred_len: int = 4                # future waypoint and control steps
    refine_num: int = 5              # cascaded decoder layers
    measurement_dim: int = 128
    feature_dim: int = 256
    n_attn_heads: int = 8
    n_attn_points: int = 8
    n_attn_levels: int = 4
    n_z_anchors: int = 15            # z levels of the look module's anchors
    img_height: int = 256
    img_width: int = 512
    lidar_pillar_grid: int = 336     # dense pillar grid edge
    # the LiDAR encoder: "pillar" (LidarNet, the dense pillar grid) or
    # "sparse" (SparseLidarNet: mmdet3d's hard voxelization, HardSimpleVFE,
    # SparseEncoder, SECOND and SECONDFPN). The sparse_* fields set the
    # sparse one, with mmdet3d's names in comments; "pillar" reads none.
    lidar_encoder: str = "pillar"
    sparse_voxel_size: Tuple[float, ...] = (38.4 / 672, 38.4 / 672, 0.2)   # voxel_size
    sparse_point_range: Tuple[float, ...] = (-8.0, -19.2, -5.0, 30.4, 19.2, 3.0)
    sparse_shape: Tuple[int, ...] = (41, 672, 672)    # z, y, x, as the middle encoder's
    sparse_max_points: int = 10                        # max_num_points
    sparse_max_voxels: int = 160_000                   # a world (the published test cap)
    sparse_base_channels: int = 16
    sparse_output_channels: int = 128
    sparse_encoder_channels: Tuple[Tuple[int, ...], ...] = (
        (16, 16, 32), (32, 32, 64), (64, 64, 128), (128, 128))
    sparse_encoder_paddings: Tuple[Tuple, ...] = (
        (0, 0, 1), (0, 0, 1), (0, 0, (0, 1, 1)), (0, 0))
    second_out_channels: Tuple[int, ...] = (128, 256)
    second_layer_nums: Tuple[int, ...] = (5, 5)
    second_layer_strides: Tuple[int, ...] = (1, 2)
    fpn_out_channels: Tuple[int, ...] = (256, 256)
    fpn_upsample_strides: Tuple[int, ...] = (1, 2)


SPARSE_LIDAR_FIELDS = tuple(
    f.name for f in dataclasses.fields(ModelConfig)
    if f.name == "lidar_encoder" or f.name.startswith(("sparse_", "second_", "fpn_")))


@dataclasses.dataclass(frozen=True)
class RoachConfig:
    """Privileged expert: XtMaCNN trunk plus Beta policy and value heads."""

    features_dim: int = 256
    states_neurons: Tuple[int, ...] = (256,)
    policy_head: Tuple[int, ...] = (256, 256)
    value_head: Tuple[int, ...] = (256, 256)
    action_dim: int = 2
    state_dim: int = 6


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Student training: AdamW with a warmup-cosine schedule and a global
    norm clip."""

    lr: float = 1e-4
    weight_decay: float = 0.01
    warmup_steps: int = 500
    total_steps: int = 60_000
    batch_size: int = 8              # examples per optimizer step
    grad_clip: float = 35.0
    seed: int = 0
    grad_accum: int = 1              # chunks the batch splits into, their
    # gradients averaged: the activations of one chunk live at a time


@dataclasses.dataclass(frozen=True)
class Config:
    sim: SimConfig = dataclasses.field(default_factory=SimConfig)
    birdview: BirdviewConfig = dataclasses.field(default_factory=BirdviewConfig)
    camera: CameraConfig = dataclasses.field(default_factory=CameraConfig)
    lidar: LidarConfig = dataclasses.field(default_factory=LidarConfig)
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    roach: RoachConfig = dataclasses.field(default_factory=RoachConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


def bench_config() -> Config:
    """The closed-loop bench's capacities: 120 background vehicles in 128
    slots, 8 walkers, 256 lights, 32 stop signs, 384-point routes and 8
    scenario slots."""
    return Config(
        sim=SimConfig(
            max_vehicles=128,
            max_walkers=8,
            max_lights=256,
            max_stop_signs=32,
            max_route_len=384,
            max_scenarios=8,
        )
    )


# The reference's two benchmark presets (route_scenario.py:492-497,
# statistics_manager.py:27-30).
def town05_long_config() -> Config:
    """Town05 Long: 128 vehicle slots, the rest at the defaults."""
    return Config(sim=SimConfig(max_vehicles=128))


def longest6_config() -> Config:
    """Longest6: 500 background vehicles (512 slots); the stop-sign penalty
    is waived in scoring (harness.statistics, stop_penalty=1.0)."""
    return Config(sim=SimConfig(max_vehicles=512))
