"""HF tower weights into the port: HF BERT, ViT, RoBERTa and CLIP-ViT state
dicts -> the port's state_dict, with the surface of the JAX package's
``utils/hf_import.py``.

The reference builds its towers by loading
``AutoModelForSequenceClassification('bert-base-uncased')`` and
``AutoModel('google/vit-base-patch16-224')`` and splitting the top
``num_fusion_layers + 1`` encoder layers off into the fusion stacks
(mDT/src/modules/multigraphormer_graph_encoder.py:233-278). ``import_towers``
does the same on state dicts: the bottom layers feed ``text_model`` /
``vit_model``, the top layers feed the fusion stacks in order, and the
pooler and classifier feed the output head.

HF's modules and the port's are both torch modules, so a tensor keeps its
layout (``nn.Linear`` (out, in), ``nn.Conv2d`` OIHW): the mapping renames.
The one reshape is CLIP's, whose class embedding (D,) and position table
(P, D) become the port's (1, 1, D) ``cls_token`` and (1, P, D)
``position_embeddings``. The per-layer mappers return the port's names
relative to the layer (``attention.query.weight``, ...). The reference's
vestigial parameters (masked_lm_pooler, lm_head_transform_weight,
embed_out, lm_output_learned_bias, the fusion projections) have no
destination.

Inputs are plain dicts of numpy arrays or tensors. ``transformers`` is
never imported: ``state_dicts_from_pretrained`` reads a checkpoint that is
already on disk (a directory, or a name in the local HF cache) with torch
and numpy, and fetches nothing.
"""

from __future__ import annotations

import json
import mmap
import os
import re
import zipfile
from typing import Any, Dict, Iterator, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from multimodaldiscussiontransformer_tpu_torch.core.config import ModelConfig
from multimodaldiscussiontransformer_tpu_torch.utils.scan_params import (
    _stack_sizes,
    scanned_state_dict,
    state_dict_layout,
    unrolled_state_dict,
)

# (HF suffix, port suffix) of one layer's linear and layer-norm modules
BERT_LAYER = (
    ("attention.self.query", "attention.query"),
    ("attention.self.key", "attention.key"),
    ("attention.self.value", "attention.value"),
    ("attention.output.dense", "attention_output_dense"),
    ("attention.output.LayerNorm", "attention_output_layernorm"),
    ("intermediate.dense", "intermediate_dense"),
    ("output.dense", "output_dense"),
    ("output.LayerNorm", "output_layernorm"),
)
VIT_LAYER = (
    ("layernorm_before", "layernorm_before"),
    ("attention.attention.query", "attention.query"),
    ("attention.attention.key", "attention.key"),
    ("attention.attention.value", "attention.value"),
    ("attention.output.dense", "attention_output_dense"),
    ("layernorm_after", "layernorm_after"),
    ("intermediate.dense", "intermediate_dense"),
    ("output.dense", "output_dense"),
)
CLIP_LAYER = (
    ("layer_norm1", "layernorm_before"),
    ("self_attn.q_proj", "attention.query"),
    ("self_attn.k_proj", "attention.key"),
    ("self_attn.v_proj", "attention.value"),
    ("self_attn.out_proj", "attention_output_dense"),
    ("layer_norm2", "layernorm_after"),
    ("mlp.fc1", "intermediate_dense"),
    ("mlp.fc2", "output_dense"),
)
BERT_EMBEDDINGS = (
    ("word_embeddings", "word_embeddings"),
    ("position_embeddings", "position_embeddings"),
    ("token_type_embeddings", "token_type_embeddings"),
    ("LayerNorm", "layernorm"),
)


def tensor(x) -> torch.Tensor:
    """``x`` (numpy array or tensor) as a CPU tensor of its own dtype."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    return torch.from_numpy(np.array(x))


def _modules(sd: Mapping[str, Any], prefix: str, pairs: Sequence[Tuple[str, str]]) -> Dict[str, torch.Tensor]:
    """``{port}.weight`` / ``{port}.bias`` from ``{prefix}.{hf}.weight`` /
    ``.bias`` (``{hf}...`` for an empty prefix) for each (hf, port) pair; a
    missing bias is skipped."""
    base = f"{prefix}." if prefix else ""
    out = {}
    for src, dst in pairs:
        out[f"{dst}.weight"] = tensor(sd[f"{base}{src}.weight"])
        if f"{base}{src}.bias" in sd:
            out[f"{dst}.bias"] = tensor(sd[f"{base}{src}.bias"])
    return out


def _under(prefix: str, tree: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {f"{prefix}.{k}": v for k, v in tree.items()}


def bert_layer_params(sd: Mapping[str, Any], prefix: str) -> Dict[str, torch.Tensor]:
    """One HF ``BertLayer`` -> the port's ``models.bert.BertLayer``."""
    return _modules(sd, prefix, BERT_LAYER)


def vit_layer_params(sd: Mapping[str, Any], prefix: str) -> Dict[str, torch.Tensor]:
    """One HF ``ViTLayer`` -> the port's ``models.vit.ViTLayer``."""
    return _modules(sd, prefix, VIT_LAYER)


def bert_embeddings_params(sd: Mapping[str, Any], prefix: str = "bert.embeddings") -> Dict[str, torch.Tensor]:
    return _modules(sd, prefix, BERT_EMBEDDINGS)


def vit_embeddings_params(sd: Mapping[str, Any], prefix: str = "vit.embeddings") -> Dict[str, torch.Tensor]:
    return {
        **_modules(sd, prefix, (("patch_embeddings.projection", "patch_embeddings"),)),
        "cls_token": tensor(sd[f"{prefix}.cls_token"]),
        "position_embeddings": tensor(sd[f"{prefix}.position_embeddings"]),
    }


def roberta_embeddings_params(sd: Mapping[str, Any], prefix: str = "roberta.embeddings") -> Dict[str, torch.Tensor]:
    """RoBERTa's embeddings have BERT's structure (a one-row token-type
    table); the position-id offset is the tower config's
    (``core.config.roberta_tower_config``)."""
    return bert_embeddings_params(sd, prefix)


def clip_vit_embeddings_params(sd: Mapping[str, Any], prefix: str = "vision_model.embeddings") -> Dict[str, torch.Tensor]:
    """HF ``CLIPVisionEmbeddings`` -> the port's ``ViTEmbeddings`` (no patch
    bias)."""
    conv = tensor(sd[f"{prefix}.patch_embedding.weight"])
    d = conv.shape[0]
    return {
        "patch_embeddings.weight": conv,
        "cls_token": tensor(sd[f"{prefix}.class_embedding"]).reshape(1, 1, d),
        "position_embeddings": tensor(sd[f"{prefix}.position_embedding.weight"])[None],
    }


def clip_vit_layer_params(sd: Mapping[str, Any], prefix: str) -> Dict[str, torch.Tensor]:
    """HF ``CLIPEncoderLayer`` -> the port's ``ViTLayer``."""
    return _modules(sd, prefix, CLIP_LAYER)


def clip_vit_tower_params(sd: Mapping[str, Any], num_layers: int, prefix: str = "vision_model") -> Dict[str, torch.Tensor]:
    """The bottom CLIP vision tower with its ``pre_layrnorm``; CLIP's
    ``post_layernorm`` becomes the tower's final layer norm, as ViT's does."""
    out = _under("embeddings", clip_vit_embeddings_params(sd, f"{prefix}.embeddings"))
    out.update(_under("embeddings", _modules(sd, prefix, (("pre_layrnorm", "pre_layernorm"),))))
    for i in range(num_layers):
        out.update(_under(f"layer_{i}", clip_vit_layer_params(sd, f"{prefix}.encoder.layers.{i}")))
    out.update(_modules(sd, prefix, (("post_layernorm", "layernorm"),)))
    return out


def put(state_dict: Dict[str, torch.Tensor], updates: Mapping[str, torch.Tensor]) -> None:
    """Write ``updates`` into ``state_dict`` in place, each in its target's
    dtype; raise for a name the state_dict lacks or a shape it disagrees
    with."""
    unknown = sorted(set(updates) - set(state_dict))
    if unknown:
        raise KeyError(f"no such tensors in the model: {unknown[:5]}")
    for key, value in updates.items():
        target = state_dict[key]
        if tuple(value.shape) != tuple(target.shape):
            raise ValueError(f"{key}: shape {tuple(value.shape)}, the model's is {tuple(target.shape)}")
        state_dict[key] = value.to(target.dtype)


def import_towers(
    state_dict: Mapping[str, torch.Tensor],
    cfg: ModelConfig,
    bert_sd: Mapping[str, Any],
    vit_sd: Optional[Mapping[str, Any]],
    bert_prefix: str = "bert",
    vit_prefix: str = "vit",
) -> Dict[str, torch.Tensor]:
    """A copy of the port's ``state_dict`` whose tower, fusion and head
    tensors come from the HF state dicts, with the reference's layer split
    (multigraphormer_graph_encoder.py:249-260). Either param layout: a
    scan-layout state_dict is unrolled for the mapping and restacked."""
    scanned = state_dict_layout(state_dict) == "scanned"
    out = unrolled_state_dict(state_dict, cfg)
    n_split = cfg.num_fusion_layers + 1
    n_text = cfg.text_tower.num_hidden_layers
    n_image = cfg.image_tower.num_hidden_layers
    with_vit = cfg.use_image_tower and vit_sd is not None

    new = _under("graph_encoder.text_model.embeddings", bert_embeddings_params(bert_sd, f"{bert_prefix}.embeddings"))
    for i in range(n_text - n_split):
        new.update(_under(f"graph_encoder.text_model.layer_{i}",
                          bert_layer_params(bert_sd, f"{bert_prefix}.encoder.layer.{i}")))
    if with_vit:
        new.update(_under("graph_encoder.vit_model.embeddings",
                          vit_embeddings_params(vit_sd, f"{vit_prefix}.embeddings")))
        for i in range(n_image - n_split):
            new.update(_under(f"graph_encoder.vit_model.layer_{i}",
                              vit_layer_params(vit_sd, f"{vit_prefix}.encoder.layer.{i}")))
        new.update(_under("graph_encoder.vit_model", _modules(vit_sd, vit_prefix, (("layernorm", "layernorm"),))))

    # the top layers -> the fusion stacks, in order (ref 145-168)
    k = 0
    for si, size in enumerate(_stack_sizes(n_split, cfg.num_fusion_stack)):
        for j in range(size):
            dst = f"graph_encoder.fusion_stack_{si}.fusion_{j}"
            new.update(_under(f"{dst}.bert_encoder",
                              bert_layer_params(bert_sd, f"{bert_prefix}.encoder.layer.{n_text - n_split + k}")))
            if with_vit:
                new.update(_under(f"{dst}.vit_encoder",
                                  vit_layer_params(vit_sd, f"{vit_prefix}.encoder.layer.{n_image - n_split + k}")))
            k += 1

    # the output head: BERT's pooler and sequence classifier
    # (multigraphormer_graph_encoder.py:241-246,264-265)
    new.update(_modules(bert_sd, bert_prefix, (("pooler.dense", "text_pooler.dense"),)))
    if "classifier.weight" in bert_sd:
        new.update(_modules(bert_sd, "", (("classifier", "node_classifier"),)))
    if with_vit and f"{vit_prefix}.pooler.dense.weight" in vit_sd and "vit_pooler.dense.weight" in out:
        new.update(_modules(vit_sd, vit_prefix, (("pooler.dense", "vit_pooler.dense"),)))
    put(out, new)
    return scanned_state_dict(out, cfg) if scanned else out


# -- reading a pretrained checkpoint without transformers ---------------------
#
# What ``AutoModelForSequenceClassification.from_pretrained(name)`` (the text
# tower) and ``AutoModel.from_pretrained(name)`` (the image tower) hand the
# JAX package, rebuilt from the files (transformers 4.57.6, offline): the
# directory or the cache snapshot, ``config.json``, the weight files in
# transformers' order of preference, its key fixes, its rule for the base
# model's prefix, and the heads it draws at random.

SAFE_WEIGHTS = "model.safetensors"
SAFE_WEIGHTS_INDEX = "model.safetensors.index.json"
TORCH_WEIGHTS = "pytorch_model.bin"
TORCH_WEIGHTS_INDEX = "pytorch_model.bin.index.json"
WEIGHT_FILES = (SAFE_WEIGHTS, SAFE_WEIGHTS_INDEX, TORCH_WEIGHTS, TORCH_WEIGHTS_INDEX)

SAFETENSORS_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
    "I64": torch.int64, "I32": torch.int32, "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
    "BOOL": torch.bool,
}

# huggingface_hub's repo-id rule: "name" or "namespace/name"
_REPO_ID = re.compile(r"^(?:[\w\-.]+/)?[\w\-.]+$")


def hub_cache_dir() -> str:
    """The HF hub cache as ``huggingface_hub`` finds it: ``$HF_HUB_CACHE``,
    else ``$HUGGINGFACE_HUB_CACHE``, else ``$HF_HOME/hub``, else
    ``$XDG_CACHE_HOME/huggingface/hub`` (``~/.cache/huggingface/hub``).
    Read at each call, not at import."""
    env = os.environ
    home = env.get("HF_HOME") or os.path.join(env.get("XDG_CACHE_HOME") or os.path.join("~", ".cache"), "huggingface")
    path = env.get("HF_HUB_CACHE") or env.get("HUGGINGFACE_HUB_CACHE") or os.path.join(home, "hub")
    return os.path.expanduser(os.path.expandvars(path))


def resolve_pretrained(name_or_path: str) -> str:
    """The directory of a pretrained checkpoint: ``name_or_path`` itself if
    it is a directory, else the snapshot of the repo ``name_or_path`` in the
    HF hub cache (``models--{org}--{name}/refs/main`` names the snapshot
    under ``snapshots/``). Nothing is fetched: a checkpoint found in
    neither place raises ``FileNotFoundError`` naming where it was looked
    for."""
    path = str(name_or_path)
    if os.path.isdir(path):
        return path
    cache = hub_cache_dir()
    if not _REPO_ID.match(path) or "--" in path or ".." in path:
        raise FileNotFoundError(f"{path!r} is not a directory, nor a model name to look up in the HF cache {cache}")
    repo = os.path.join(cache, "models--" + path.replace("/", "--"))
    rev = "main"
    ref = os.path.join(repo, "refs", rev)
    if os.path.isfile(ref):
        with open(ref) as f:
            rev = f.read().strip()
    snapshot = os.path.join(repo, "snapshots", rev)
    if not os.path.isdir(snapshot):
        raise FileNotFoundError(
            f"{path!r} is not a directory, and the HF cache has no snapshot of it: looked for {snapshot} "
            f"(cache {cache}; set HF_HUB_CACHE or HF_HOME, or pass a local directory). Nothing is downloaded.")
    return snapshot


def read_config(directory: str) -> Dict[str, Any]:
    path = os.path.join(directory, "config.json")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no config.json in {directory}")
    with open(path) as f:
        return json.load(f)


def weight_files(directory: str) -> List[str]:
    """The checkpoint's weight files in transformers' order of preference:
    ``model.safetensors``, the shards of ``model.safetensors.index.json``,
    ``pytorch_model.bin``, the shards of ``pytorch_model.bin.index.json``."""
    for name in WEIGHT_FILES:
        path = os.path.join(directory, name)
        if not os.path.isfile(path):
            continue
        if not name.endswith(".index.json"):
            return [path]
        with open(path) as f:
            shards = sorted(set(json.load(f)["weight_map"].values()))
        missing = [s for s in shards if not os.path.isfile(os.path.join(directory, s))]
        if missing:
            raise FileNotFoundError(f"{path} names shards that are not in {directory}: {missing[:3]}")
        return [os.path.join(directory, s) for s in shards]
    raise FileNotFoundError(f"no weights in {directory}: looked for {', '.join(WEIGHT_FILES)}")


def read_safetensors(path: str) -> Iterator[Tuple[str, torch.Tensor]]:
    """(name, float32 tensor) of each floating tensor of a safetensors file
    (integer tensors as stored), read by hand: 8 bytes of little-endian
    header length, a JSON header of ``dtype``, ``shape`` and
    ``data_offsets`` (``__metadata__`` aside), then the raw bytes. Each
    tensor is viewed in a copy-on-write memory map and copied once into its
    own float32 memory."""
    with open(path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(n))
        header.pop("__metadata__", None)
        if not header:
            return
        mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
    try:
        for name, info in header.items():
            dtype = SAFETENSORS_DTYPES.get(info["dtype"])
            if dtype is None:
                raise ValueError(f"{path}: {name} has dtype {info['dtype']}, which the reader does not take")
            start, end = info["data_offsets"]
            shape = tuple(info["shape"])
            out_dtype = torch.float32 if dtype.is_floating_point else dtype
            out = torch.empty(shape, dtype=out_dtype)
            if end > start:
                view = torch.frombuffer(mm, dtype=dtype, count=(end - start) // dtype.itemsize, offset=8 + n + start)
                out.copy_(view.view(shape))
                del view
            yield name, out
    finally:
        mm.close()


def read_torch_bin(path: str) -> Iterator[Tuple[str, torch.Tensor]]:
    """(name, float32 tensor) of each tensor of a ``pytorch_model.bin``
    (``torch.load(weights_only=True)``, memory-mapped where the file is a
    zip archive)."""
    # the legacy (pre-zip) format, that of old checkpoints, cannot be memory-mapped
    sd = torch.load(path, map_location="cpu", weights_only=True, mmap=zipfile.is_zipfile(path))
    for name in list(sd):
        t = sd.pop(name)
        yield name, (t.to(torch.float32, copy=True) if t.is_floating_point() else t.clone())


def read_checkpoint(directory: str) -> Dict[str, torch.Tensor]:
    """Every tensor of the directory's weight files by its stored name.
    Floating tensors come back in float32: what ``from_pretrained`` gives by
    default (the default dtype) for F32, F16 and BF16 files alike."""
    out: Dict[str, torch.Tensor] = {}
    for path in weight_files(directory):
        reader = read_safetensors if path.endswith(".safetensors") else read_torch_bin
        out.update(reader(path))
    return out


def fix_key(key: str) -> str:
    """``PreTrainedModel._fix_state_dict_key_on_load`` for BERT and ViT:
    the TF-era ``LayerNorm.gamma`` / ``LayerNorm.beta`` become ``.weight``
    / ``.bias`` (its weight-norm renames concern speech models only)."""
    if key.endswith("LayerNorm.beta"):
        return key.replace("LayerNorm.beta", "LayerNorm.bias")
    if key.endswith("LayerNorm.gamma"):
        return key.replace("LayerNorm.gamma", "LayerNorm.weight")
    return key


def _linear_shapes(name: str, n_out: int, n_in: int, bias: bool = True) -> Dict[str, Tuple[int, ...]]:
    out = {f"{name}.weight": (n_out, n_in)}
    if bias:
        out[f"{name}.bias"] = (n_out,)
    return out


def _norm_shapes(name: str, d: int) -> Dict[str, Tuple[int, ...]]:
    return {f"{name}.weight": (d,), f"{name}.bias": (d,)}


def num_labels(config: Mapping[str, Any]) -> int:
    """``PretrainedConfig.num_labels``: the size of ``id2label``, else
    ``num_labels``, else 2."""
    if config.get("id2label"):
        return len(config["id2label"])
    return int(config.get("num_labels") or 2)


def bert_expected_shapes(config: Mapping[str, Any]) -> Dict[str, Tuple[int, ...]]:
    """Name -> shape of ``BertForSequenceClassification``'s state dict for a
    BERT ``config.json`` (BertConfig's defaults where a key is absent)."""
    d = int(config.get("hidden_size", 768))
    ffn = int(config.get("intermediate_size", 3072))
    shapes = {
        "bert.embeddings.word_embeddings.weight": (int(config.get("vocab_size", 30522)), d),
        "bert.embeddings.position_embeddings.weight": (int(config.get("max_position_embeddings", 512)), d),
        "bert.embeddings.token_type_embeddings.weight": (int(config.get("type_vocab_size", 2)), d),
        **_norm_shapes("bert.embeddings.LayerNorm", d),
    }
    for i in range(int(config.get("num_hidden_layers", 12))):
        p = f"bert.encoder.layer.{i}"
        for hf, _ in BERT_LAYER:
            if hf.endswith("LayerNorm"):
                shapes.update(_norm_shapes(f"{p}.{hf}", d))
            elif hf == "intermediate.dense":
                shapes.update(_linear_shapes(f"{p}.{hf}", ffn, d))
            elif hf == "output.dense":
                shapes.update(_linear_shapes(f"{p}.{hf}", d, ffn))
            else:
                shapes.update(_linear_shapes(f"{p}.{hf}", d, d))
    shapes.update(_linear_shapes("bert.pooler.dense", d, d))
    shapes.update(_linear_shapes("classifier", num_labels(config), d))
    return shapes


def vit_expected_shapes(config: Mapping[str, Any]) -> Dict[str, Tuple[int, ...]]:
    """Name -> shape of ``ViTModel``'s state dict for a ViT ``config.json``,
    without the pooler (the port's model has no place for it)."""
    d = int(config.get("hidden_size", 768))
    ffn = int(config.get("intermediate_size", 3072))
    patch, image = int(config.get("patch_size", 16)), int(config.get("image_size", 224))
    qkv_bias = bool(config.get("qkv_bias", True))
    shapes = {
        "embeddings.cls_token": (1, 1, d),
        "embeddings.position_embeddings": (1, (image // patch) ** 2 + 1, d),
        "embeddings.patch_embeddings.projection.weight": (d, int(config.get("num_channels", 3)), patch, patch),
        "embeddings.patch_embeddings.projection.bias": (d,),
    }
    for i in range(int(config.get("num_hidden_layers", 12))):
        p = f"encoder.layer.{i}"
        for hf, _ in VIT_LAYER:
            if hf.startswith("layernorm"):
                shapes.update(_norm_shapes(f"{p}.{hf}", d))
            elif hf == "intermediate.dense":
                shapes.update(_linear_shapes(f"{p}.{hf}", ffn, d))
            elif hf == "output.dense":
                shapes.update(_linear_shapes(f"{p}.{hf}", d, ffn))
            else:
                shapes.update(_linear_shapes(f"{p}.{hf}", d, d, bias=qkv_bias or "attention.attention" not in hf))
    shapes.update(_norm_shapes("layernorm", d))
    return shapes


def match_model(checkpoint: Mapping[str, torch.Tensor], prefix: str, model_has_prefix: bool) -> Dict[str, torch.Tensor]:
    """transformers' prefix rule (``_load_pretrained_model``): the file has
    the base model's prefix if any key starts with ``prefix``. A task model
    (``model_has_prefix``) given a base checkpoint prefixes every key (a key
    that belongs to the task's head alone, like ``classifier.weight``, makes
    the file corrupt: ValueError); a base model given a task checkpoint
    keeps the keys under ``prefix.`` and strips it. Keys are fixed first."""
    fixed = {fix_key(k): v for k, v in checkpoint.items()}
    has_prefix = any(k.startswith(prefix) for k in fixed)
    if model_has_prefix and not has_prefix:
        if any(k.startswith("classifier.") for k in fixed):
            raise ValueError("the state dictionary of the checkpoint is corrupted: a base-model checkpoint "
                             "holds the task head 'classifier'")
        return {f"{prefix}.{k}": v for k, v in fixed.items()}
    if not model_has_prefix and has_prefix:
        return {k[len(prefix) + 1:]: v for k, v in fixed.items() if k.startswith(prefix + ".")}
    return fixed


def take_expected(name: str, loaded: Mapping[str, torch.Tensor], expected: Mapping[str, Tuple[int, ...]],
                  drawable: Sequence[str], initializer_range: float, generator: torch.Generator) -> Dict[str, np.ndarray]:
    """The model's tensors from ``loaded`` (extras dropped, as transformers
    drops unexpected keys), a shape that differs from the config's raising
    as ``from_pretrained`` does without ``ignore_mismatched_sizes``. The
    linear heads of ``drawable`` that the file lacks are drawn as
    transformers' ``_init_weights`` draws them: weight ~ normal(0,
    initializer_range), bias 0. Any other missing tensor raises: the towers
    never start at random."""
    out: Dict[str, np.ndarray] = {}
    missing = []
    for key, shape in expected.items():
        if key in loaded:
            t = loaded[key]
            if tuple(t.shape) != tuple(shape):
                raise ValueError(f"{name}: {key} has shape {tuple(t.shape)} in the checkpoint, the config "
                                 f"asks for {tuple(shape)}")
            out[key] = t.numpy()
        elif any(key.startswith(head + ".") for head in drawable):
            if key.endswith(".bias"):
                out[key] = np.zeros(shape, np.float32)
            else:
                out[key] = (torch.randn(shape, generator=generator) * initializer_range).numpy()
        else:
            missing.append(key)
    if missing:
        raise KeyError(f"{name}: the checkpoint lacks {len(missing)} tensors of the model, e.g. {missing[:3]}")
    return out


def text_state_dict(name_or_path: str, seed: int = 0) -> Dict[str, np.ndarray]:
    """``AutoModelForSequenceClassification.from_pretrained(name_or_path)``'s
    state dict (BERT) as numpy float32, read from the files."""
    directory = resolve_pretrained(name_or_path)
    config = read_config(directory)
    if config.get("model_type") != "bert":
        raise ValueError(f"{directory}: model_type {config.get('model_type')!r}; the text tower reads 'bert'")
    loaded = match_model(read_checkpoint(directory), "bert", model_has_prefix=True)
    return take_expected(name_or_path, loaded, bert_expected_shapes(config), ("classifier", "bert.pooler.dense"),
                         float(config.get("initializer_range", 0.02)), torch.Generator().manual_seed(seed))


def image_state_dict(name_or_path: str) -> Dict[str, np.ndarray]:
    """``AutoModel.from_pretrained(name_or_path)``'s state dict (``ViTModel``)
    as numpy float32 with the ``vit.`` prefix that ``import_towers`` reads,
    without the pooler, which transformers draws at random when the file
    is an image classifier's and the port's model has no place for."""
    directory = resolve_pretrained(name_or_path)
    config = read_config(directory)
    if config.get("model_type") != "vit":
        raise ValueError(f"{directory}: model_type {config.get('model_type')!r}; the image tower reads 'vit'")
    loaded = match_model(read_checkpoint(directory), "vit", model_has_prefix=False)
    sd = take_expected(name_or_path, loaded, vit_expected_shapes(config), (), 0.0, torch.Generator())
    return {"vit." + k: v for k, v in sd.items()}


def check_pretrained(name_or_path: str) -> str:
    """The checkpoint's directory and what it holds, in a line
    (``readiness.check_hf_checkpoint``); raises naming what is missing."""
    directory = resolve_pretrained(name_or_path)
    config = read_config(directory)
    files = weight_files(directory)
    return f"{directory}: {config.get('model_type')} config + {len(files)} weight file(s) ({os.path.basename(files[0])})"


def state_dicts_from_pretrained(
    text_name: str = "bert-base-uncased",
    image_name: str = "google/vit-base-patch16-224",
    attention_dropout: float = 0.3,
    hidden_dropout: float = 0.3,
    seed: int = 0,
):
    """The pretrained towers' state dicts as numpy float32, equal to those
    the JAX package's ``state_dicts_from_pretrained`` builds through
    ``transformers`` for the same checkpoint: the text tower as
    ``BertForSequenceClassification`` (a ``classifier`` the file lacks is
    drawn from ``seed``, so its values are not those the JAX package
    draws), the image tower as ``ViTModel`` with keys under ``vit.``. Each name is a
    local directory or a name in the HF cache (``resolve_pretrained``);
    nothing is downloaded. ``attention_dropout`` and ``hidden_dropout``
    only change the HF modules' config in the JAX package (the port's
    towers take their rates from ``ModelConfig``): they are accepted and
    not used."""
    del attention_dropout, hidden_dropout
    return text_state_dict(text_name, seed), image_state_dict(image_name)
