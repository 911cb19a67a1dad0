"""Configuration tree of the PyTorch port (inference and training).

Own copy of the dataclasses of ``rdmnet_tpu/config.py`` that single-pair
inference, the train and eval steps, serving and RANSAC read, with the same
field names and defaults so one set of numbers describes both
implementations. Frozen dataclasses, as there.

Left out: the dataset roots, the loader's worker count, and the n2p/p2p
score gates that no port path reads. ``PyramidConfig`` has no ``approx_recall``: PyTorch has no
counterpart of ``lax.approx_max_k``, so the port's radius search is always
exact.
"""

from __future__ import annotations

import dataclasses
import typing
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class PyramidConfig:
    """Static-shape multi-level pyramid spec."""

    num_stages: int = 5
    voxel_size: float = 0.3
    search_radius: float = 1.275
    caps: Tuple[int, ...] = (30720, 12288, 5120, 1792, 640)
    neighbor_limits: Tuple[int, ...] = (40, 40, 40, 40, 40)
    # decoder reads only column 0 of the upsampling tables: exact 1-NN
    upsampling_limit: Optional[int] = 1
    build_upsampling_from_level: int = 1
    # support rows one query chunk sees in the banded search (None = full)
    band_caps: Tuple[Optional[int], ...] = (7168, 3584, 2304, None, None)
    band_caps_fixed: bool = False
    band_chunk: int = 512

    def __post_init__(self):
        assert len(self.caps) == self.num_stages
        assert len(self.neighbor_limits) == self.num_stages
        if len(self.band_caps) != self.num_stages:
            fitted = (self.band_caps + (None,) * self.num_stages)[: self.num_stages]
            object.__setattr__(self, "band_caps", fitted)

    def sort_cell(self, lvl: int) -> float:
        """Granularity the level's x-major point order is monotone in."""
        return self.voxel_size * (2.0 ** max(lvl, 1))

    def band_chunk_for(self, q_lvl: int) -> int:
        """Query rows per banded chunk (a multiple of 64)."""
        return min(self.band_chunk,
                   max(128, ((self.caps[q_lvl] // 16 + 63) // 64) * 64))

    def scaled(self, factor: float, multiple: int = 128) -> "PyramidConfig":
        """Capacity bucket scaled by ``factor``, rounded up to ``multiple``."""
        caps = tuple(
            max(multiple, -(-int(c * factor) // multiple) * multiple)
            for c in self.caps
        )
        if self.band_caps_fixed:
            bands = self.band_caps
        else:
            bands = tuple(
                None if b is None
                else max(multiple, -(-int(b * factor) // multiple) * multiple)
                for b in self.band_caps
            )
        return dataclasses.replace(self, caps=caps, band_caps=bands)


@dataclasses.dataclass(frozen=True)
class BackboneConfig:
    """KPConv encoder/decoder."""

    num_stages: int = 5
    init_voxel_size: float = 0.3
    kernel_size: int = 15
    base_radius: float = 4.25
    base_sigma: float = 2.0
    group_norm: int = 32
    input_dim: int = 1
    init_dim: int = 64
    output_dim: int = 256
    # all-ones LiDAR input: the first conv's gathered features are the
    # neighbor-validity indicator, computed without a gather
    ones_input: bool = True
    # one geometric influence tensor per level (canonical kernel disposition)
    shared_influence: bool = True

    @property
    def init_radius(self) -> float:
        return self.base_radius * self.init_voxel_size

    @property
    def init_sigma(self) -> float:
        return self.base_sigma * self.init_voxel_size


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    ground_truth_matching_radius: float = 0.6
    num_points_in_patch: int = 128
    num_sinkhorn_iterations: int = 100
    ground_truth_corres_radius: float = 2.4
    # coarse transformer family: "thdroformer", "geotransformer" or "ape"
    coarse_module: str = "thdroformer"


@dataclasses.dataclass(frozen=True)
class CoarseMatchingConfig:
    num_targets: int = 128
    overlap_threshold: float = 0.1
    num_correspondences: int = 256
    dual_normalization: bool = True


@dataclasses.dataclass(frozen=True)
class ThDRoFormerConfig:
    input_dim: int = 2048
    hidden_dim: int = 128
    output_dim: int = 256
    num_heads: int = 4
    num_layers: int = 4
    input_dim2: int = 256
    num_layers2: int = 4
    # sparse top-k attention schedule for stage 2 (None = dense): the
    # fraction of the nodes each self-attention layer keeps per query
    k2: Optional[Tuple[float, ...]] = None


@dataclasses.dataclass(frozen=True)
class VoteConfig:
    model_use_vote: bool = True
    inference_use_vote: bool = True
    max_translate_range: Tuple[float, float, float] = (3.0, 3.0, 3.0)
    mlps: Tuple[int, ...] = (512, 256)
    nms_radius: float = 2.4
    # None = exact full-radius NMS adjacency; an int truncates it to the
    # nearest ``nms_neighbor_limit`` entries (self included)
    nms_neighbor_limit: Optional[int] = None
    n2n_overlap_threshold: float = 1.2
    n2p_overlap_threshold: float = 0.6
    p2p_overlap_threshold: float = 0.6


@dataclasses.dataclass(frozen=True)
class GeoTransformerConfig:
    """The GeoTransformer stack (``coarse_module="geotransformer"``)."""

    input_dim: int = 2048
    hidden_dim: int = 128
    output_dim: int = 256
    num_heads: int = 4
    blocks: Tuple[str, ...] = ("self", "cross", "self", "cross", "self", "cross")
    sigma_d: float = 4.8
    sigma_a: float = 15.0
    angle_k: int = 3
    reduction_a: str = "max"


@dataclasses.dataclass(frozen=True)
class FineMatchingConfig:
    topk: int = 1
    acceptance_radius: float = 0.6
    mutual: bool = False
    confidence_threshold: float = 0.0
    use_dustbin: bool = True
    use_global_score: bool = False
    correspondence_threshold: int = 3
    correspondence_limit: Optional[int] = None
    num_refinement_steps: int = 5


@dataclasses.dataclass(frozen=True)
class CoarseLossConfig:
    """Weighted circle loss on node features."""

    positive_margin: float = 0.1
    negative_margin: float = 1.4
    positive_optimal: float = 0.1
    negative_optimal: float = 1.4
    log_scale: float = 40.0
    positive_overlap: float = 0.1


@dataclasses.dataclass(frozen=True)
class GapLossConfig:
    """Score-gap hinge loss on the transport plan."""

    positive_radius: float = 0.6
    triplet_loss_gamma: float = 0.5


@dataclasses.dataclass(frozen=True)
class LossWeights:
    weight_coarse_loss: float = 1.0
    weight_vote_loss: float = 1.0
    weight_gap_loss: float = 5.0


@dataclasses.dataclass(frozen=True)
class EvalConfig:
    acceptance_overlap: float = 0.0
    acceptance_radius: float = 0.6
    inlier_ratio_threshold: float = 0.05
    rre_threshold: float = 5.0   # degrees
    rte_threshold: float = 2.0   # meters


@dataclasses.dataclass(frozen=True)
class RansacConfig:
    """RANSAC re-solve of predicted correspondences (``ops/ransac.py``)."""

    distance_threshold: float = 0.3
    num_points: int = 4
    num_iterations: int = 50000


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    """Adam with coupled L2 decay and an LR schedule counted in applied
    updates: "step" (x lr_decay every lr_decay_steps epochs) or
    "warmup_cosine" (linear warmup from eta_init x lr over warmup_steps
    micro steps, then a half cosine to eta_min x lr at max_epoch)."""

    lr: float = 1e-4
    lr_decay: float = 0.95
    lr_decay_steps: int = 4      # epochs per decay step
    weight_decay: float = 1e-6
    max_epoch: int = 160
    grad_acc_steps: int = 1
    scheduler: str = "step"
    warmup_steps: int = 0
    eta_init: float = 0.1
    eta_min: float = 0.1


@dataclasses.dataclass(frozen=True)
class TrainDataConfig:
    """Training data: batch, per-cloud point limit, augmentation."""

    batch_size: int = 1
    point_limit: int = 30000
    use_augmentation: bool = True
    augmentation_noise: float = 0.01
    augmentation_min_scale: float = 0.8
    augmentation_max_scale: float = 1.2
    augmentation_shift: float = 2.0
    augmentation_rotation: float = 1.0


@dataclasses.dataclass(frozen=True)
class TestDataConfig:
    """Test data: batch and per-cloud point limit (None keeps every point)."""

    batch_size: int = 1
    point_limit: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    """Data parallelism over ``torch.distributed`` (``parallel/``)."""

    dp: int = 1                  # ranks: N, -1 = the whole world, 1 = one process
    scale_lr_by_dp: bool = True  # lr x dp, as the reference under DDP


@dataclasses.dataclass(frozen=True)
class Config:
    seed: int = 7351
    # dtype of the backbone and ThDRoFormer products ("float32" or
    # "bfloat16"); weights, norms, softmax, geometry, Sinkhorn and pose stay
    # float32 (nn/precision.py)
    compute_dtype: str = "float32"
    train: TrainDataConfig = dataclasses.field(default_factory=TrainDataConfig)
    test: TestDataConfig = dataclasses.field(default_factory=TestDataConfig)
    pyramid: PyramidConfig = dataclasses.field(default_factory=PyramidConfig)
    backbone: BackboneConfig = dataclasses.field(default_factory=BackboneConfig)
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    coarse_matching: CoarseMatchingConfig = dataclasses.field(default_factory=CoarseMatchingConfig)
    thdroformer: ThDRoFormerConfig = dataclasses.field(default_factory=ThDRoFormerConfig)
    vote: VoteConfig = dataclasses.field(default_factory=VoteConfig)
    geotransformer: GeoTransformerConfig = dataclasses.field(default_factory=GeoTransformerConfig)
    fine_matching: FineMatchingConfig = dataclasses.field(default_factory=FineMatchingConfig)
    eval: EvalConfig = dataclasses.field(default_factory=EvalConfig)
    ransac: RansacConfig = dataclasses.field(default_factory=RansacConfig)
    optim: OptimConfig = dataclasses.field(default_factory=OptimConfig)
    coarse_loss: CoarseLossConfig = dataclasses.field(default_factory=CoarseLossConfig)
    gap_loss: GapLossConfig = dataclasses.field(default_factory=GapLossConfig)
    loss: LossWeights = dataclasses.field(default_factory=LossWeights)
    parallel: ParallelConfig = dataclasses.field(default_factory=ParallelConfig)


def config_from_dict(cls, values: dict):
    """Inverse of ``dataclasses.asdict`` for the config tree (JSON lists back
    to tuples). Unknown keys raise."""
    hints = typing.get_type_hints(cls)
    kwargs = {}
    for name, value in values.items():
        if dataclasses.is_dataclass(hints.get(name)):
            value = config_from_dict(hints[name], value)
        elif isinstance(value, list):
            value = tuple(value)
        kwargs[name] = value
    return cls(**kwargs)


def check_geometry_consistent(cfg: Config) -> None:
    """Raise when the coupled pyramid/backbone geometry constants disagree."""
    if abs(cfg.pyramid.voxel_size - cfg.backbone.init_voxel_size) > 1e-9:
        raise ValueError(
            f"pyramid.voxel_size={cfg.pyramid.voxel_size} != "
            f"backbone.init_voxel_size={cfg.backbone.init_voxel_size}: "
            "override both together"
        )
    expected = cfg.backbone.base_radius * cfg.backbone.init_voxel_size
    if abs(cfg.pyramid.search_radius - expected) > 1e-6:
        raise ValueError(
            f"pyramid.search_radius={cfg.pyramid.search_radius} != "
            f"base_radius*voxel_size={expected}: override in lockstep"
        )


def make_cfg(**overrides) -> Config:
    """The default KITTI config."""
    cfg = Config(**overrides)
    check_geometry_consistent(cfg)
    return cfg


def make_parity_cfg(**overrides) -> Config:
    """The config the upstream RDMNet checkpoints were trained under, for
    weights converted by ``utils/torch_convert``: the neighbour limits the
    upstream code calibrates on KITTI, (65, 63, 69, 71, 81); a kernel
    disposition per KPConv layer (each restores its own ``kernel_points``);
    and the NMS adjacency cut to the last limit, 81, as upstream cuts it.
    The search is exact, as always in the port."""
    cfg = Config(**overrides)
    return dataclasses.replace(
        cfg,
        pyramid=dataclasses.replace(cfg.pyramid, neighbor_limits=(65, 63, 69, 71, 81)),
        backbone=dataclasses.replace(cfg.backbone, shared_influence=False),
        vote=dataclasses.replace(cfg.vote, nms_neighbor_limit=81),
    )


def make_tiny_cfg() -> Config:
    """Miniature config for tests: same topology, tiny capacities."""
    return Config(
        pyramid=PyramidConfig(
            caps=(512, 256, 128, 64, 32),
            neighbor_limits=(16, 16, 16, 16, 16),
        ),
        model=ModelConfig(num_points_in_patch=16, num_sinkhorn_iterations=10),
        coarse_matching=CoarseMatchingConfig(num_targets=16, num_correspondences=32),
        thdroformer=ThDRoFormerConfig(num_layers=1, num_layers2=1),
        vote=VoteConfig(mlps=(64, 32)),
        fine_matching=FineMatchingConfig(num_refinement_steps=2),
    )
