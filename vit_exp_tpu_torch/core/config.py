"""Typed experiment config loaded from the reference YAML schema (the
port's own copy of vit_exp_tpu/core/config.py, which imports no JAX; the
port imports nothing of the JAX package, so it keeps this copy, field for
field).

Schema mirrors configs/train_from_scratch/*.yaml in the reference
(SURVEY.md §2.7; e.g. ct_clip_vit_open_seg_hpc_v5_1_80g.yaml): reference
config files load unchanged.  Unknown keys are preserved in `.extra` and the
reference's `dict.get(key, default)` backward-compat convention is kept by
giving every field a default.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import yaml


def _sub(d: Dict[str, Any], key: str) -> Dict[str, Any]:
    v = d.get(key) or {}
    if not isinstance(v, dict):
        raise ValueError(f"config section {key!r} must be a mapping, got {type(v)}")
    return v


@dataclasses.dataclass
class ArchConfig:
    """Vision-tower architecture (reference `arch` block, run_train.py:36-54)."""

    arch_name: str = "ctvit_3d"
    dim: int = 768
    image_size: int = 480
    patch_size: int = 20
    temporal_size: int = 240
    temporal_patch_size: int = 10
    transformer_blocks: int = 8
    dim_head: int = 32
    heads: int = 8
    use_flash_attention: bool = True
    channels: int = 1

    @property
    def grid(self) -> tuple[int, int, int]:
        return (
            self.temporal_size // self.temporal_patch_size,
            self.image_size // self.patch_size,
            self.image_size // self.patch_size,
        )

    @property
    def num_tokens(self) -> int:
        t, h, w = self.grid
        return t * h * w

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ArchConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        kwargs = {k: v for k, v in d.items() if k in known}
        if "arch_name" in kwargs:
            # reference yamls write "CTViT3D" (run_train.py:36); the
            # factory asserts the lowercase spelling
            kwargs["arch_name"] = str(kwargs["arch_name"]).lower()
        return cls(**kwargs)


@dataclasses.dataclass
class HeadConfig:
    """MLP head (reference create_head kwargs, ct_clip.py:736-750)."""

    n_layers: int = 2
    layer_type: str = "mlp"
    in_dim: int = 256
    mid_dim: int = 128
    out_dim: int = 16

    @classmethod
    def from_dict(cls, d: Dict[str, Any], **defaults) -> "HeadConfig":
        base = dataclasses.asdict(cls(**defaults))
        known = set(base)
        base.update({k: v for k, v in d.items() if k in known})
        # the reference sometimes prefixes keys with head_ (seg_head block)
        base.update(
            {k[5:]: v for k, v in d.items() if k.startswith("head_") and k[5:] in known}
        )
        return cls(**base)


@dataclasses.dataclass
class CTClipArchConfig:
    """`ct_clip_arch` block (ct_clip.py:654-714 config reads)."""

    fix_text_encoder: bool = False
    use_seg: bool = False
    seg_head: HeadConfig = dataclasses.field(
        default_factory=lambda: HeadConfig(out_dim=22)
    )
    use_open_seg: bool = False
    open_seg_head: HeadConfig = dataclasses.field(default_factory=HeadConfig)
    open_text_head: HeadConfig = dataclasses.field(
        default_factory=lambda: HeadConfig(in_dim=768)
    )
    open_seg_loss_type: str = "cos_sim_l2"
    open_seg_loss_down_factor: int = 1
    open_seg_loss_hyper_config: Dict[str, Any] = dataclasses.field(default_factory=dict)
    fusion_head: Optional[HeadConfig] = None
    # decoupled contrastive learning (ct_clip.py:497,639, applied at
    # ct_clip.py:1366-1368): masks the positive pair out of the InfoNCE
    # denominator.  No shipped reference config sets it, but it is a ctor
    # capability — reachable here end-to-end via this flag.
    decoupled_contrastive_learning: bool = False
    # SSL heads — defaulted off in every reference config (run_train.py:150,
    # ct_clip.py:577-610) but reachable end-to-end via these flags
    use_mlm: bool = False
    use_visual_ssl: bool = False
    visual_ssl_type: str = "simsiam"  # "simsiam" | "simclr"
    text_ssl_loss_weight: float = 0.05
    image_ssl_loss_weight: float = 0.05
    mlm_mask_prob: float = 0.15
    mlm_mask_token_id: int = 103  # BERT [MASK]

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "CTClipArchConfig":
        fusion = None
        fusion_block = d.get("fusion_head") or {}
        if fusion_block.get("type") == "mlp":
            fusion = HeadConfig.from_dict(
                _sub(fusion_block, "mlp"), in_dim=16, mid_dim=16, out_dim=1
            )
        return cls(
            fix_text_encoder=d.get("fix_text_encoder", False),
            use_seg=d.get("use_seg", False),
            seg_head=HeadConfig.from_dict(_sub(d, "seg_head"), out_dim=22),
            use_open_seg=d.get("use_open_seg", False),
            open_seg_head=HeadConfig.from_dict(_sub(d, "open_seg_head")),
            open_text_head=HeadConfig.from_dict(_sub(d, "open_text_head"), in_dim=768),
            open_seg_loss_type=d.get("open_seg_loss_type", "cos_sim_l2"),
            open_seg_loss_down_factor=int(d.get("open_seg_loss_down_factor", 1)),
            open_seg_loss_hyper_config=d.get("open_seg_loss_hyper_config", {}) or {},
            fusion_head=fusion,
            decoupled_contrastive_learning=d.get(
                "decoupled_contrastive_learning", False),
            use_mlm=d.get("use_mlm", False),
            use_visual_ssl=d.get("use_visual_ssl", False),
            visual_ssl_type=d.get("visual_ssl_type", "simsiam"),
            text_ssl_loss_weight=float(d.get("text_ssl_loss_weight", 0.05)),
            image_ssl_loss_weight=float(d.get("image_ssl_loss_weight", 0.05)),
            mlm_mask_prob=float(d.get("mlm_mask_prob", 0.15)),
            mlm_mask_token_id=int(d.get("mlm_mask_token_id", 103)),
        )


@dataclasses.dataclass
class TrainerConfig:
    """`trainer` block (CTCLIPTrainer.py:318-416 config reads)."""

    lr: float = 1.25e-6
    wd: float = 0.0
    num_train_steps: int = 200_000
    max_grad_norm: float = 0.5
    gradient_accumulation_steps: int = 1
    save_results_every: int = 1000
    save_model_every: int = 1000
    eval_model_every: int = 2000
    sample_val_every: int = 1000
    vis_train_every: List[int] = dataclasses.field(default_factory=list)
    vis_val_every: int = 0
    balance_loss_weight: List[float] = dataclasses.field(default_factory=list)
    warmup_steps: int = 0

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "TrainerConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        kwargs = {k: v for k, v in d.items() if k in known}
        # YAML 1.1 parses "1e-4" (no dot) as a STRING — coerce numerics
        for k in ("lr", "wd", "max_grad_norm"):
            if k in kwargs:
                kwargs[k] = float(kwargs[k])
        for k in ("num_train_steps", "gradient_accumulation_steps",
                  "save_results_every", "save_model_every",
                  "eval_model_every", "sample_val_every", "vis_val_every",
                  "warmup_steps"):
            if k in kwargs:
                kwargs[k] = int(kwargs[k])
        if "balance_loss_weight" in kwargs:
            kwargs["balance_loss_weight"] = [
                float(w) for w in kwargs["balance_loss_weight"]
            ]
        return cls(**kwargs)


@dataclasses.dataclass
class DatasetSamplerConfig:
    """`DatasetSampler` block (CTCLIPTrainer.py:232-268)."""

    type: str = "Combined"  # "Combined" | "Random"
    acc_steps_list: List[int] = dataclasses.field(default_factory=lambda: [1])
    ratio_list: List[float] = dataclasses.field(default_factory=lambda: [1.0])

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "DatasetSamplerConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


_FLAT_ARCH_KEYS = (
    "arch_name", "dim", "image_size", "patch_size", "temporal_size",
    "temporal_patch_size", "transformer_blocks", "dim_head", "heads",
    "use_flash_attention", "channels",
)
_FLAT_TRAINER_KEYS = (
    "lr", "wd", "num_train_steps", "max_grad_norm",
    "gradient_accumulation_steps", "save_results_every", "save_model_every",
    "eval_model_every", "sample_val_every", "warmup_steps",
)
_FLAT_REPORT_DATA_KEYS = (
    "reports_file_train", "reports_file_valid", "metadata_train",
    "data_train", "data_valid", "labels",
)
_FLAT_SEG_DATA_KEYS = (
    "seg_data_train", "seg_data_valid", "seg_mask_train", "seg_mask_valid",
)


def _normalize_flat_schema(d: Dict[str, Any]) -> Dict[str, Any]:
    """Lift the reference's OLD flat schema into the nested one.

    18 of the 70 reference yamls (e.g. ct_clip_vit_hpc_v3_1.yaml:1-31,
    ct_clip_ori_hpc_1.yaml) predate the nested layout: arch fields, trainer
    fields and CT-RATE paths sit at the top level, and 4 of them add flat
    seg keys (`use_seg`, `seg_data_train`, `seg_head_*` —
    ct_clip_vit_seg_30_v1.yaml).  The reference reads both layouts through
    `config.get(...)` fallbacks (run_train.py:36-54); here the flat form is
    rewritten into the nested one so the rest of the loader sees a single
    schema.  No-op for nested configs.
    """
    if "arch" in d or "trainer" in d or "train_data_list" in d:
        return d
    d = dict(d)
    arch = {k: d.pop(k) for k in _FLAT_ARCH_KEYS if k in d}
    if arch:
        d["arch"] = arch
    trainer = {k: d.pop(k) for k in _FLAT_TRAINER_KEYS if k in d}
    if trainer:
        d["trainer"] = trainer
    data_list: List[Dict[str, Any]] = []
    report = {k: d[k] for k in _FLAT_REPORT_DATA_KEYS if k in d}
    if report:
        report.update({
            "name": "CT-RATE", "type": "imagereport",
            "batch_size": d.get("batch_size", 1),
            "num_workers": d.get("num_workers", 0),
        })
        data_list.append(report)
    seg = {k: d[k] for k in _FLAT_SEG_DATA_KEYS if k in d}
    if seg and d.get("use_seg"):
        seg.update({
            "name": "TotalSegmentator", "type": "imageseg",
            "batch_size": d.get("batch_size", 1),
            "num_workers": d.get("num_workers", 0),
        })
        data_list.append(seg)
    if data_list:
        d["train_data_list"] = data_list
    ct: Dict[str, Any] = {}
    if "use_seg" in d:
        ct["use_seg"] = d["use_seg"]
    seg_head = {k: v for k, v in d.items() if k.startswith("seg_head_")}
    if seg_head:
        # seg_head_n_layers → head-config n_layers (HeadConfig strips the
        # head_ prefix; here the prefix is seg_head_)
        ct["seg_head"] = {k[len("seg_head_"):]: v for k, v in seg_head.items()}
    if ct:
        d["ct_clip_arch"] = ct
    return d


@dataclasses.dataclass
class ExperimentConfig:
    random_seed: int = 42
    results_folder: str = "./results"
    project_name: str = "vit_exp_tpu"
    exp_name: str = "default"
    trainer: TrainerConfig = dataclasses.field(default_factory=TrainerConfig)
    arch: ArchConfig = dataclasses.field(default_factory=ArchConfig)
    ct_clip_arch: CTClipArchConfig = dataclasses.field(default_factory=CTClipArchConfig)
    train_data_list: List[Dict[str, Any]] = dataclasses.field(default_factory=list)
    valid_data_list: List[Dict[str, Any]] = dataclasses.field(default_factory=list)
    valid_test_list: List[str] = dataclasses.field(default_factory=list)
    sample_test_list: List[str] = dataclasses.field(default_factory=list)
    dataset_sampler: DatasetSamplerConfig = dataclasses.field(
        default_factory=DatasetSamplerConfig
    )
    extra: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ExperimentConfig":
        d = _normalize_flat_schema(d)
        known = {
            "random_seed",
            "results_folder",
            "project_name",
            "exp_name",
            "train_data_list",
            "valid_data_list",
            "valid_test_list",
            "sample_test_list",
        }
        kwargs: Dict[str, Any] = {k: d[k] for k in known if k in d}
        kwargs["trainer"] = TrainerConfig.from_dict(_sub(d, "trainer"))
        arch_block = dict(_sub(d, "arch"))
        kwargs["arch"] = ArchConfig.from_dict(arch_block)
        ct_block = dict(_sub(d, "ct_clip_arch"))
        # two reference yamls misplace use_seg/seg_head inside the `arch`
        # block (ct_clip_vit_seg_30_v1.yaml); the reference reads them via
        # config.get fallbacks — lift them to where they are consumed
        for key in ("use_seg", "seg_head"):
            if key in arch_block and key not in ct_block:
                ct_block[key] = arch_block[key]
        kwargs["ct_clip_arch"] = CTClipArchConfig.from_dict(ct_block)
        kwargs["dataset_sampler"] = DatasetSamplerConfig.from_dict(
            _sub(d, "DatasetSampler")
        )
        handled = known | {"trainer", "arch", "ct_clip_arch", "DatasetSampler"}
        kwargs["extra"] = {k: v for k, v in d.items() if k not in handled}
        return cls(**kwargs)


def load_config(path: str) -> ExperimentConfig:
    with open(path) as f:
        return ExperimentConfig.from_dict(yaml.safe_load(f) or {})
