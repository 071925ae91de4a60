"""Dataclass config tree with CLI override and checkpoint-side persistence
(the port's own copy of fmvfi_tpu/utils/config.py: `save` writes the same
config.json).

One system replacing the reference's per-script argparse forests +
SimpleNamespace cross-calls + config.txt re-parsing (SURVEY §5 "Config").
`add_to_parser`/`from_args` map dataclass fields to --flags; `save`/`load`
persist JSON next to checkpoints (the reference dumped argparse to config.txt
at train/train.py:107-111 and re-parsed it at
adacof/interpolate_twoframe.py:38-53).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
from typing import Any, Optional, Type, TypeVar

T = TypeVar("T")


@dataclasses.dataclass
class AdaCoFConfig:
    kernel_size: int = 5
    dilation: int = 1
    checkpoint: str = ""


@dataclasses.dataclass
class PhaseNetConfig:
    num_img: int = 2
    nbands: int = 4
    checkpoint: str = ""


@dataclasses.dataclass
class FusionNetConfig:
    uncertainty_maps: int = 3
    variant: int = 0
    checkpoint: str = ""


@dataclasses.dataclass
class TrainConfig:
    epochs: int = 10
    batch_size: int = 8
    lr: float = 1e-3
    weight_decay: float = 0.0
    optimizer: str = "adam"
    loss: str = "1*Charb+0.01*g_Spatial+0.005*g_Occlusion"
    crop: int = 256
    seed: int = 0
    out_dir: str = "./output"
    data_dir: str = ""
    log_every: int = 50
    ckpt_every: int = 500


@dataclasses.dataclass
class EvalConfig:
    dim: int = 512
    max_num: int = 10
    out_dir: str = "./results"
    test_sets: str = "synthetic"  # comma-separated paths or 'synthetic'


@dataclasses.dataclass
class Config:
    adacof: AdaCoFConfig = dataclasses.field(default_factory=AdaCoFConfig)
    phase_net: PhaseNetConfig = dataclasses.field(default_factory=PhaseNetConfig)
    fusion_net: FusionNetConfig = dataclasses.field(default_factory=FusionNetConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    eval: EvalConfig = dataclasses.field(default_factory=EvalConfig)


def add_to_parser(parser: argparse.ArgumentParser, cls: Type = Config, prefix=""):
    import typing

    hints = typing.get_type_hints(cls)
    for f in dataclasses.fields(cls):
        t = hints.get(f.name, f.type)
        if dataclasses.is_dataclass(t):
            add_to_parser(parser, t, prefix=f"{prefix}{f.name}.")
        else:
            default = f.default if f.default is not dataclasses.MISSING else None
            parser.add_argument(
                f"--{prefix}{f.name}",
                type=type(default) if default is not None else str,
                default=None,
                help=f"(default: {default})",
            )


def from_args(args: argparse.Namespace, base: Optional[Config] = None) -> Config:
    cfg = base or Config()

    def apply(obj, prefix=""):
        for f in dataclasses.fields(obj):
            val = getattr(obj, f.name)
            if dataclasses.is_dataclass(val):
                apply(val, prefix=f"{prefix}{f.name}.")
            else:
                arg = getattr(args, f"{prefix}{f.name}".replace(".", "_"), None) if hasattr(
                    args, f"{prefix}{f.name}".replace(".", "_")
                ) else None
                if arg is None:
                    arg = vars(args).get(f"{prefix}{f.name}")
                if arg is not None:
                    setattr(obj, f.name, arg)

    apply(cfg)
    return cfg


def save(cfg: Config, path: str) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(dataclasses.asdict(cfg), f, indent=2)


def load(path: str) -> Config:
    with open(path) as f:
        raw = json.load(f)

    def build(cls, d):
        import typing

        hints = typing.get_type_hints(cls)  # resolves string annotations
        kwargs = {}
        for fld in dataclasses.fields(cls):
            if fld.name in d:
                v = d[fld.name]
                t = hints.get(fld.name, fld.type)
                kwargs[fld.name] = build(t, v) if dataclasses.is_dataclass(t) else v
        return cls(**kwargs)

    return build(Config, raw)
