"""The port's reference (FairSeq mDT) import and export
(``utils/reference_import.py``) against the JAX package's, on the tiny
config with the port's seeded weights carried to JAX by
``utils/flax_import.py``: the port's export equals JAX's key for key and
value for value; the port's import of JAX's export (raw FairSeq dict or
plain state dict, tensors or numpy, with vestigial keys) gives back the
source state dict bit for bit, in either param layout; the legacy fused
qkv split matches JAX's; the imported model scores like the source."""

import numpy as np
import pytest
import torch

from multimodaldiscussiontransformer_tpu.core import config as jconfig
from multimodaldiscussiontransformer_tpu.utils import reference_import as jri
from multimodaldiscussiontransformer_tpu_torch.core import config as pconfig
from multimodaldiscussiontransformer_tpu_torch.data.collator import collate, to_tensors
from multimodaldiscussiontransformer_tpu_torch.data.synthetic import synthetic_batch_items
from multimodaldiscussiontransformer_tpu_torch.models.mdt import MDTModel
from multimodaldiscussiontransformer_tpu_torch.utils import reference_import as pri
from multimodaldiscussiontransformer_tpu_torch.utils.flax_import import to_flax_params
from multimodaldiscussiontransformer_tpu_torch.utils.scan_params import scanned_state_dict, unrolled_state_dict

torch.set_num_threads(2)

IMG = (3, 32, 32)


def _model(seed, scan=False):
    return MDTModel(pconfig.tiny_model_config(scan_layers=scan), generator=torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("scan", [False, True])
def test_export_matches_jax(scan):
    model = _model(0, scan)
    sd = model.state_dict()
    got = pri.export_reference_state_dict(scanned_state_dict(sd, model.config) if scan else sd, model.config)
    want = jri.export_reference_state_dict(to_flax_params(model), jconfig.tiny_model_config(scan_layers=scan))
    assert set(got) == set(want)
    assert "encoder.graph_encoder.layers.0.layers.0.self_attn.q_proj.weight" in got
    assert "encoder.graph_encoder.fusion_layers.0.fusion_layers.0.bert_encoder.attention.self.query.weight" in got
    for k, v in want.items():
        assert got[k].dtype == v.dtype and np.array_equal(got[k], v), k


@pytest.mark.parametrize("wrap", ["fairseq", "plain", "tensors"])
@pytest.mark.parametrize("scan", [False, True])
def test_import_of_jax_export_gives_the_source_back(wrap, scan):
    """JAX's export of the seed-0 weights, with the reference's vestigial
    keys added, imported into a model of other weights."""
    src = _model(0)
    d = src.config.encoder_embed_dim
    ref = jri.export_reference_state_dict(to_flax_params(src), jconfig.tiny_model_config())
    ref.update({
        "encoder.embed_out.weight": np.zeros((2, d), np.float32),
        "encoder.lm_output_learned_bias": np.zeros((1,), np.float32),
        "encoder.masked_lm_pooler.weight": np.zeros((d, d), np.float32),
        "encoder.graph_encoder.fusion_layers.0.fusion_layers.0.bert_projection.weight": np.zeros((d, d), np.float32),
        "encoder.graph_encoder.graph_node_feature.atom_encoder.weight": np.zeros((16, d), np.float32),
        "encoder.graph_encoder.layers.2.layers.0.fc1.weight": np.zeros((d, d), np.float32),  # the dead stack
    })
    if wrap == "tensors":
        ref = {k: torch.from_numpy(v) for k, v in ref.items()}
    ckpt = {"model": ref, "args": None, "optimizer_history": []} if wrap == "fairseq" else ref
    dst = _model(1, scan)
    sd = dst.state_dict()
    target = scanned_state_dict(sd, dst.config) if scan else sd
    got = pri.import_reference_checkpoint(target, dst.config, ckpt)
    assert set(got) == set(target)
    got = unrolled_state_dict(got, dst.config)
    for k, v in src.state_dict().items():
        assert torch.equal(got[k], v), k
        assert got[k].is_contiguous()


def test_import_raises_for_a_missing_tensor():
    src = _model(0)
    ref = pri.export_reference_state_dict(src.state_dict(), src.config)
    del ref["encoder.graph_encoder.bottle_neck.weight"]
    with pytest.raises(KeyError, match="bottle_neck"):
        pri.import_reference_checkpoint(src.state_dict(), src.config, ref)
    del ref["encoder.graph_encoder.emb_layer_norm.weight"]  # optional: kept from the model
    ref["encoder.graph_encoder.bottle_neck.weight"] = src.state_dict()["graph_encoder.bottle_neck"].numpy()
    pri.import_reference_checkpoint(src.state_dict(), src.config, ref)


def test_legacy_qkv_split_matches_jax():
    rng = np.random.default_rng(0)
    d = 8
    base = "encoder.graph_encoder.layers.0.layers.0.self_attn."
    sd = {base + "in_proj_weight": rng.standard_normal((3 * d, d)).astype(np.float32),
          base + "in_proj_bias": rng.standard_normal(3 * d).astype(np.float32),
          base + "out_proj.weight": rng.standard_normal((d, d)).astype(np.float32),
          "encoder.other.in_proj_weight": rng.standard_normal((3 * d, d)).astype(np.float32)}
    got, want = pri.upgrade_legacy_qkv(sd), jri.upgrade_legacy_qkv(sd)
    assert set(got) == set(want) and base + "in_proj_weight" not in got
    for k, v in want.items():
        assert np.array_equal(np.asarray(got[k]), v), k
    torch_in = pri.upgrade_legacy_qkv({k: torch.from_numpy(v) for k, v in sd.items()})
    assert all(torch.equal(torch.as_tensor(torch_in[k]), torch.from_numpy(np.asarray(v))) for k, v in want.items())


def test_legacy_checkpoint_scores_like_the_source():
    """A reference export with one layer's q/k/v fused back into the legacy
    ``in_proj_weight`` / ``in_proj_bias``, imported into a fresh model:
    the scores equal the source model's bit for bit."""
    src = _model(0)
    ref = pri.export_reference_state_dict(src.state_dict(), src.config)
    base = "encoder.graph_encoder.layers.1.layers.0.self_attn."
    for leaf in ("weight", "bias"):
        ref[f"{base}in_proj_{leaf}"] = np.concatenate([ref.pop(f"{base}{p}_proj.{leaf}") for p in "qkv"])
    dst = _model(5)
    dst.load_state_dict(pri.import_reference_checkpoint(dst.state_dict(), dst.config, {"model": ref}))
    batch = collate(synthetic_batch_items(3, seed=7, seq_len=12, vocab_size=128, image_shape=IMG, max_nodes=6,
                                          image_prob=0.5), spatial_pos_max=5, image_shape=IMG)
    with torch.no_grad():
        a = src(to_tensors(batch, "cpu")).logits
        b = dst(to_tensors(batch, "cpu")).logits
    assert torch.equal(a, b)
