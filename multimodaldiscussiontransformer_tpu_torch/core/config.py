"""Config dataclasses of the PyTorch port.

A copy of ``multimodaldiscussiontransformer_tpu/core/config.py``: the same
classes, field names and defaults, so a config written for one package means
the same model in the other. Defaults reproduce the canonical published run
(``bash run_train.sh 8 4 5 2 2 0``): 8 fusion layers, 4 bottleneck tokens,
spatial_pos_max 5, graph stack 2, fusion stack 2, d=768, 12 heads, FFN 768.

Some fields select behaviour the port does not have yet; building a model
with them raises ``NotImplementedError`` (``models/mdt.py::check_supported``).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class BertTowerConfig:
    """HF ``bert-base-uncased`` geometry."""

    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    pad_token_id: int = 0
    # encoder swap: RoBERTa uses pad-offset position ids
    hidden_act: str = "gelu"  # gelu | gelu_new | quick_gelu
    position_offset: int = 0  # RoBERTa: padding_idx + 1 = 2
    use_token_type: bool = True
    # fused tower attention: the masked-attention kernels (ops/masked_attention.py)
    use_pallas_attention: bool = False

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads


@dataclass(frozen=True)
class ViTTowerConfig:
    """HF ``google/vit-base-patch16-224`` geometry."""

    image_size: int = 224
    patch_size: int = 16
    num_channels: int = 3
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    layer_norm_eps: float = 1e-12
    hidden_dropout_prob: float = 0.0
    attention_probs_dropout_prob: float = 0.0
    # encoder swap: CLIP-ViT uses QuickGELU, a pre-embedding layernorm and a
    # bias-free patch conv
    hidden_act: str = "gelu"  # gelu | quick_gelu
    embeddings_layernorm: bool = False
    patch_bias: bool = True
    # fused tower attention: the masked-attention kernels (ops/masked_attention.py)
    use_pallas_attention: bool = False

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def seq_len(self) -> int:
        return self.num_patches + 1  # + CLS

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads


@dataclass(frozen=True)
class ModelConfig:
    """Full mDT model geometry (field names follow the reference CLI)."""

    # graphormer featurizer vocab sizes
    num_atoms: int = 512 * 9
    num_edges: int = 512 * 3
    num_in_degree: int = 512
    num_out_degree: int = 512
    num_spatial: int = 512
    num_edge_dis: int = 128
    edge_type: str = "multi_hop"
    multi_hop_max_dist: int = 5

    # fusion / graph interleave
    num_bottleneck_tokens: int = 4
    num_fusion_layers: int = 8
    num_fusion_stack: int = 2
    num_graph_stack: int = 2

    # transformer geometry
    encoder_embed_dim: int = 768
    encoder_ffn_embed_dim: int = 768
    encoder_attention_heads: int = 12
    encoder_layers: int = 4  # vestigial in the reference too

    # regularization (unused by the port's inference-only forward)
    dropout: float = 0.4
    attention_dropout: float = 0.3
    act_dropout: float = 0.3

    activation_fn: str = "gelu"
    # graph-only ablation: no image tower and no ViT fusion halves
    use_image_tower: bool = True
    encoder_normalize_before: bool = True
    pre_layernorm: bool = False
    apply_graphormer_init: bool = False
    freeze_initial_encoders: bool = True

    # classifier head
    num_classes: int = 2

    # tower configs
    text_tower: BertTowerConfig = field(default_factory=BertTowerConfig)
    image_tower: ViTTowerConfig = field(default_factory=ViTTowerConfig)
    text_encoder_name: str = "bert-base-uncased"
    image_encoder_name: str = "google/vit-base-patch16-224"

    # reference-quirk fidelity switches:
    # the reference builds len(fusion)+1 graph stacks but never runs the
    # second-to-last one; True reproduces that (the dead stack has no params)
    reproduce_dead_graph_stack: bool = True
    # the reference adds the base attention bias twice
    double_add_attn_bias: bool = True

    # compute policy: matmuls in ``dtype``, params stored in ``param_dtype``
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    # graph attention through the compact (template, ids, lut) bias and the
    # hand-written tree-attention kernel; False assembles the dense
    # (B, H, S, S) bias and runs plain attention
    use_pallas_attention: bool = True
    # the graph attention as a ring over an sp group, once the model is laid
    # out on one (parallel/mesh.py::apply_sequence_parallel); one device otherwise
    sequence_parallel: bool = False
    # rematerialise the fusion and graph stacks (models/remat.py)
    remat: bool = False
    remat_policy: str = "full"
    # the scan param layout (utils/scan_params.py); the modules run unrolled
    scan_layers: bool = False

    @property
    def num_fusion_stacks(self) -> int:
        """Number of GraphFusionStack modules: ceil((F+1)/num_fusion_stack)."""
        total = self.num_fusion_layers + 1
        return -(-total // self.num_fusion_stack)

    @property
    def num_graph_stacks(self) -> int:
        return self.num_fusion_stacks + 1

    @property
    def num_bottom_text_layers(self) -> int:
        """BERT layers left in the bottom tower after the top
        ``num_fusion_layers+1`` are split off into fusion stacks."""
        return self.text_tower.num_hidden_layers - (self.num_fusion_layers + 1)

    @property
    def num_bottom_image_layers(self) -> int:
        return self.image_tower.num_hidden_layers - (
            self.num_fusion_layers + 1
        )

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


def roberta_tower_config(**overrides) -> BertTowerConfig:
    """``roberta-base`` geometry for the encoder-swap ablation."""
    cfg = BertTowerConfig(
        vocab_size=50265,
        max_position_embeddings=514,
        type_vocab_size=1,
        layer_norm_eps=1e-5,
        pad_token_id=1,
        position_offset=2,
        use_token_type=True,
    )
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def clip_vit_tower_config(**overrides) -> ViTTowerConfig:
    """``openai/clip-vit-base-patch32`` vision-tower geometry."""
    cfg = ViTTowerConfig(
        image_size=224,
        patch_size=32,
        layer_norm_eps=1e-5,
        hidden_act="quick_gelu",
        embeddings_layernorm=True,
        patch_bias=False,
    )
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def tiny_model_config(**overrides) -> ModelConfig:
    """A small config for tests: 4-layer towers, d=64, 2 fusion layers."""
    text = BertTowerConfig(
        vocab_size=128,
        hidden_size=64,
        num_hidden_layers=4,
        num_attention_heads=4,
        intermediate_size=128,
        max_position_embeddings=64,
    )
    image = ViTTowerConfig(
        image_size=32,
        patch_size=16,
        hidden_size=64,
        num_hidden_layers=4,
        num_attention_heads=4,
        intermediate_size=128,
    )
    cfg = ModelConfig(
        num_in_degree=16,
        num_out_degree=16,
        num_spatial=64,
        num_bottleneck_tokens=2,
        num_fusion_layers=2,
        num_fusion_stack=1,
        num_graph_stack=1,
        encoder_embed_dim=64,
        encoder_ffn_embed_dim=64,
        encoder_attention_heads=4,
        dropout=0.0,
        attention_dropout=0.0,
        act_dropout=0.0,
        text_tower=text,
        image_tower=image,
        dtype="float32",
        remat=False,
    )
    return cfg.replace(**overrides) if overrides else cfg


@dataclass(frozen=True)
class TaskConfig:
    dataset_name: str = "hateful_discussions"
    num_classes: int = 2
    max_nodes: int = 10000
    dataset_source: str = "pyg"
    spatial_pos_max: int = 5
    seed: int = 1
    train_epoch_shuffle: bool = True
    user_data_dir: str = ""


@dataclass(frozen=True)
class DataConfig:
    """Static-shape bucketing policy of the collator."""

    batch_size: int = 12
    batch_size_is_per_replica: bool = True
    max_text_len: int = 100
    text_len_buckets: Tuple[int, ...] = (32, 64, 100)
    length_grouped: bool = False
    # per-graph node-count buckets (graphs padded up to the nearest)
    node_buckets: Tuple[int, ...] = (8, 16, 32, 64, 128, 256)
    # total real-node capacity buckets for the flattened text tower
    node_capacity_buckets: Tuple[int, ...] = (32, 64, 128, 256, 512, 1024)
    # image-count capacity buckets for the ViT tower
    image_capacity_buckets: Tuple[int, ...] = (0, 8, 16, 32, 64)
    # labelled-node capacity buckets for the loss
    label_capacity_buckets: Tuple[int, ...] = (8, 16, 32, 64, 128)
    drop_last: bool = True
    num_workers: int = 0


@dataclass(frozen=True)
class OptimConfig:
    lr: float = 3e-5
    end_learning_rate: float = 3e-7
    warmup_updates: int = 3246
    total_num_update: int = 10820
    adam_betas: Tuple[float, float] = (0.9, 0.999)
    adam_eps: float = 1e-8
    weight_decay: float = 0.01
    update_freq: int = 3
    scan_microbatches: bool = True
    clip_norm: float = 0.0
    power: float = 1.0
    bf16_adam_state: bool = False


@dataclass(frozen=True)
class TrainConfig:
    criterion: str = "node_cross_entropy"
    task: str = "node_prediction"
    arch: str = "multi_graphormer_base"
    max_epoch: int = 37
    validate_interval_updates: int = 300
    save_dir: str = "checkpoints"
    save_interval: int = 1
    save_interval_updates: int = 0
    profile_trace_dir: Optional[str] = None
    profile_trace_steps: int = 5
    profile_trace_start: int = 2
    restore_file: Optional[str] = None
    reset_optimizer: bool = False
    seed: int = 1
    log_interval: int = 50
    positive_weight: float = 1.5
    negative_weight: float = 1.0
    soft_negative_weight: float = 0.0
    adaptive_soft_negative_weight: bool = True
    multiplication_scale: float = 20.0
    dp_size: int = -1
    tp_size: int = 1
    sp_size: int = 1
    num_slices: int = 1
    fast_dropout_rng: bool = True
    fsdp: bool = False
    optim: OptimConfig = field(default_factory=OptimConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    data: DataConfig = field(default_factory=DataConfig)
    task_cfg: TaskConfig = field(default_factory=TaskConfig)

    def replace(self, **kw) -> "TrainConfig":
        return dataclasses.replace(self, **kw)
