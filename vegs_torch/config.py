"""Configuration tree (port of vegs_tpu/config.py): the parameter groups
with the reference CLI's names and defaults, as dataclasses serialized to
JSON (`cfg_args.json` written by either package loads in the other), and
the CLI flags reflected from them (`add_group_args`, `parse_config`)."""

from __future__ import annotations

import argparse
import dataclasses
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional


@dataclass
class ModelParams:
    sh_degree: int = 3
    source_path: str = ""
    model_path: str = ""
    images: str = "images"
    preload_image: bool = False
    resolution: int = -1
    white_background: bool = False
    eval: bool = False
    output_dir: str = "./output"
    data_type: str = "kitti360"
    cache_dir: str = ""
    save_results_as_images: bool = False
    seed: int = 7


@dataclass
class PipelineParams:
    convert_SHs_python: bool = False
    compute_cov3D_python: bool = False
    debug: bool = False
    # rasterizer knobs (no reference analog):
    backend: str = "auto"          # rasterizer blend backend ('auto' = kernels)
    k_cap: int = 1 << 20           # tile-instance capacity (auto-grows on overflow)
    clamp_radius: int = 0


@dataclass
class OptimizationParams:
    iterations: int = 100_000
    position_lr_init: float = 0.000016
    position_lr_final: float = 0.0000016
    box_lr_mult: float = 0.5
    position_lr_delay_mult: float = 0.01
    position_lr_max_steps: int = 30_000
    feature_lr: float = 0.0025
    opacity_lr: float = 0.05
    scaling_lr: float = 0.001
    rotation_lr: float = 0.001
    percent_dense: float = 0.01
    lambda_dssim: float = 0.2
    lambda_dssim_guidance: float = 0.0
    densification_interval: int = 100
    opacity_reset_interval: int = 3000
    densify_from_iter: int = 500
    densify_until_iter: int = 15_000
    densify_until_iter_box: int = 50_000
    densify_grad_threshold: float = 0.0002
    lambda_dnormal: float = 1e-3


@dataclass
class KITTI360DataParams:
    start_frame: int = 3972
    end_frame: int = 4258
    seq: str = "2013_05_28_drive_0009_sync"
    exclude_lidar: bool = False
    exclude_colmap: bool = False
    colmap_data_type: str = "_processed"


@dataclass
class BoxModelParams:
    boxmodel_lr: float = 0.005
    boxmodel_lambda_reg: float = 0.001
    gaussian_box_model_init_opacity: float = 0.1


@dataclass
class SDRegularizationParams:
    guidance_mode: str = "score-matching"
    start_guiding_from_iter: int = 97_500
    end_guiding_at_iter: int = 100_000
    sd_image_size: int = 512
    global_crop: bool = False
    lora_model_dir: str = "lora/models"
    lora_checkpoint_iter: Optional[int] = None
    sd_model_key: str = "stabilityai/stable-diffusion-2-1-base"
    prompts: str = "a photography of a suburban street"
    negative_prompts: str = ""
    sd_guidance_scale: float = 7.5
    sd_min_step: int = 0
    sd_max_step: int = 50
    sm_lambda: float = 1e-13
    sds_grad_scale: float = 1.0
    yaw_start: float = 30
    yaw_end: float = 90
    yaw_eval: float = 60
    pitch_eval: float = 0
    pitch_start: float = 0
    pitch_end: float = 0
    trans_z_range: float = 0.5
    trans_z_eval: float = 0
    perceptual_loss: bool = False
    perceptual_loss_lambda: float = 1.0


@dataclass
class VegsConfig:
    model: ModelParams = field(default_factory=ModelParams)
    pipeline: PipelineParams = field(default_factory=PipelineParams)
    opt: OptimizationParams = field(default_factory=OptimizationParams)
    data: KITTI360DataParams = field(default_factory=KITTI360DataParams)
    box: BoxModelParams = field(default_factory=BoxModelParams)
    sd: SDRegularizationParams = field(default_factory=SDRegularizationParams)

    # ---- (de)serialization ------------------------------------------------
    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @staticmethod
    def from_json(text: str) -> "VegsConfig":
        raw = json.loads(text)
        return VegsConfig(
            model=ModelParams(**raw.get("model", {})),
            pipeline=PipelineParams(**raw.get("pipeline", {})),
            opt=OptimizationParams(**raw.get("opt", {})),
            data=KITTI360DataParams(**raw.get("data", {})),
            box=BoxModelParams(**raw.get("box", {})),
            sd=SDRegularizationParams(**raw.get("sd", {})),
        )

    def save(self, path) -> None:
        Path(path).write_text(self.to_json())

    @staticmethod
    def load(path) -> "VegsConfig":
        return VegsConfig.from_json(Path(path).read_text())


def add_group_args(parser: argparse.ArgumentParser, cfg_cls, prefix: str = "") -> None:
    """Reflect a dataclass into argparse flags (the reference's ParamGroup
    pattern): a bool is a store_true flag; an int, float or str field takes
    that type, any other annotation a string."""
    for f in dataclasses.fields(cfg_cls):
        name = f"--{prefix}{f.name}"
        default = f.default if f.default is not dataclasses.MISSING else None
        if f.type in ("bool", bool):
            parser.add_argument(name, action="store_true", default=default)
        else:
            typ = {"int": int, "float": float, "str": str}.get(str(f.type), str)
            if f.type in (int, float, str):
                typ = f.type
            parser.add_argument(name, type=typ, default=default)


def parse_config(argv=None) -> VegsConfig:
    """Build a VegsConfig from CLI flags (flat names, groups merged).

    Only the flags it knows are taken (parse_known_args), so the training
    CLI's own flags pass through. `--config` starts from a JSON config; a
    flag then overrides its value only when it differs from the field's
    default (a flag given at its default leaves the JSON's value)."""
    parser = argparse.ArgumentParser("vegs_torch")
    parser.add_argument("--config", type=str, default=None,
                        help="JSON config to start from")
    for cls in (ModelParams, PipelineParams, OptimizationParams,
                KITTI360DataParams, BoxModelParams, SDRegularizationParams):
        add_group_args(parser, cls)
    args, _ = parser.parse_known_args(argv)

    cfg = VegsConfig.load(args.config) if args.config else VegsConfig()
    for group_name, cls in (
        ("model", ModelParams), ("pipeline", PipelineParams),
        ("opt", OptimizationParams), ("data", KITTI360DataParams),
        ("box", BoxModelParams), ("sd", SDRegularizationParams),
    ):
        group = getattr(cfg, group_name)
        for f in dataclasses.fields(cls):
            v = getattr(args, f.name, None)
            if v is not None and v != f.default:
                setattr(group, f.name, v)
    return cfg
