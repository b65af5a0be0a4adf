"""The port's HF tower import (``utils/hf_import.py``) against the JAX
package's, on ``transformers`` BERT, ViT, RoBERTa and CLIP-vision models
built from tiny configs with random init (no download): JAX
``import_towers`` carried to the port through ``utils/flax_import.py``
equals the port's ``import_towers`` tensor for tensor, in the unrolled and
the scan layout, and the tower-level mappers agree the same way. One tiny
forward per swapped tower (RoBERTa text, CLIP image) against the HF model
itself within 1e-5 (float32). ``state_dicts_from_pretrained`` keeps its
``transformers`` import inside (it downloads)."""

import dataclasses

import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from multimodaldiscussiontransformer_tpu.core import config as jconfig  # noqa: E402
from multimodaldiscussiontransformer_tpu.utils import hf_import as jhf  # noqa: E402
from multimodaldiscussiontransformer_tpu_torch.core import config as pconfig  # noqa: E402
from multimodaldiscussiontransformer_tpu_torch.models.bert import BertBottomTower  # noqa: E402
from multimodaldiscussiontransformer_tpu_torch.models.mdt import MDTModel  # noqa: E402
from multimodaldiscussiontransformer_tpu_torch.models.vit import ViTBottomTower  # noqa: E402
from multimodaldiscussiontransformer_tpu_torch.utils import hf_import as phf  # noqa: E402
from multimodaldiscussiontransformer_tpu_torch.utils.flax_import import flax_to_state_dict, to_flax_params  # noqa: E402
from multimodaldiscussiontransformer_tpu_torch.utils.scan_params import scanned_state_dict, unrolled_state_dict  # noqa: E402

torch.set_num_threads(2)

HIDDEN, HEADS = 64, 4


def hf_bert():
    cfg = transformers.BertConfig(vocab_size=128, hidden_size=HIDDEN, num_hidden_layers=4, num_attention_heads=HEADS,
                                  intermediate_size=128, max_position_embeddings=64, num_labels=2)
    torch.manual_seed(0)
    return {k: v.numpy() for k, v in transformers.BertForSequenceClassification(cfg).state_dict().items()}


def hf_vit():
    cfg = transformers.ViTConfig(image_size=32, patch_size=16, num_channels=3, hidden_size=HIDDEN, num_hidden_layers=4,
                                 num_attention_heads=HEADS, intermediate_size=128)
    torch.manual_seed(1)
    return {"vit." + k: v for k, v in transformers.ViTModel(cfg).state_dict().items()}  # tensors, as given


def _tiny(mod, scan: bool):
    return mod.tiny_model_config(scan_layers=scan)


@pytest.mark.parametrize("scan", [False, True])
def test_import_towers_matches_jax(scan):
    """Tiny config: 4-layer towers, 3 layers split into the fusion stacks.
    Every tensor the mapping writes equals JAX's result, every other tensor
    keeps the model's own; the scan layout comes back scanned."""
    bert_sd, vit_sd = hf_bert(), hf_vit()
    model = MDTModel(_tiny(pconfig, scan), generator=torch.Generator().manual_seed(2))
    own = model.state_dict()
    sd = scanned_state_dict(own, model.config) if scan else own
    got = phf.import_towers(sd, model.config, bert_sd, vit_sd)
    assert set(got) == set(sd)
    assert any(k.startswith("graph_encoder.scan_pairs") for k in got) == scan
    jparams = jhf.import_towers(to_flax_params(model), _tiny(jconfig, scan),
                                {k: v for k, v in bert_sd.items()}, {k: v.numpy() for k, v in vit_sd.items()})
    want = flax_to_state_dict(jparams)
    # JAX adds the HF ViT's pooler as a ``vit_pooler`` subtree that its model
    # has no parameter for and never reads; the port's model has no such
    # tensor, so the port leaves it out
    assert set(want) - set(own) == {"vit_pooler.dense.weight", "vit_pooler.dense.bias"}
    want = {k: v for k, v in want.items() if k in own}
    got = unrolled_state_dict(got, model.config)
    assert set(got) == set(want) == set(own)
    changed = 0
    for k, v in want.items():
        assert got[k].dtype == own[k].dtype and torch.equal(got[k], v), k
        changed += not torch.equal(v, own[k])
    assert changed > 50  # layer norms start at 1 and 0 on both sides
    assert torch.equal(got["node_classifier.weight"], torch.from_numpy(bert_sd["classifier.weight"]))
    top = got["graph_encoder.fusion_stack_2.fusion_0.bert_encoder.output_dense.weight"]
    assert torch.equal(top, torch.from_numpy(bert_sd["bert.encoder.layer.3.output.dense.weight"]))


def test_import_checks_names_and_shapes():
    bert_sd, vit_sd = hf_bert(), hf_vit()
    model = MDTModel(pconfig.tiny_model_config())
    bad = dict(bert_sd, **{"bert.embeddings.word_embeddings.weight": np.zeros((7, HIDDEN), np.float32)})
    with pytest.raises(ValueError, match="word_embeddings"):
        phf.import_towers(model.state_dict(), model.config, bad, vit_sd)
    no_vit = phf.import_towers(model.state_dict(), model.config, bert_sd, None)
    assert torch.equal(no_vit["graph_encoder.vit_model.layernorm.weight"],
                       model.state_dict()["graph_encoder.vit_model.layernorm.weight"])


def _flax_rel(tree):
    return {k: v for k, v in flax_to_state_dict(tree).items()}


def test_roberta_tower_matches_jax_mapping_and_hf_forward():
    layers = 3
    cfg = transformers.RobertaConfig(vocab_size=200, hidden_size=HIDDEN, num_hidden_layers=layers,
                                     num_attention_heads=HEADS, intermediate_size=128, max_position_embeddings=66,
                                     hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0, pad_token_id=1,
                                     type_vocab_size=1, layer_norm_eps=1e-5)
    torch.manual_seed(3)
    hf = transformers.RobertaModel(cfg, add_pooling_layer=False).eval()
    sd = {"roberta." + k: v.numpy() for k, v in hf.state_dict().items()}
    mapped = phf._under("embeddings", phf.roberta_embeddings_params(sd))
    jtree = {"embeddings": jhf.roberta_embeddings_params(sd)}
    for i in range(layers):
        mapped.update(phf._under(f"layer_{i}", phf.bert_layer_params(sd, f"roberta.encoder.layer.{i}")))
        jtree[f"layer_{i}"] = jhf.bert_layer_params(sd, f"roberta.encoder.layer.{i}")
    want = _flax_rel(jtree)
    assert set(mapped) == set(want)
    for k, v in want.items():
        assert torch.equal(mapped[k], v), k

    tower_cfg = pconfig.roberta_tower_config(vocab_size=200, hidden_size=HIDDEN, num_hidden_layers=layers,
                                            num_attention_heads=HEADS, intermediate_size=128,
                                            max_position_embeddings=66, hidden_dropout_prob=0.0,
                                            attention_probs_dropout_prob=0.0)
    tower = BertBottomTower(tower_cfg, layers, torch.float32)
    tower.load_state_dict(mapped, strict=True)
    rng = np.random.default_rng(0)
    ids = rng.integers(2, 200, size=(3, 12))
    ids[1, 8:] = 1
    mask = (ids != 1).astype(np.int64)
    with torch.no_grad():
        want = hf(input_ids=torch.tensor(ids), attention_mask=torch.tensor(mask)).last_hidden_state.numpy()
        got = tower(torch.tensor(ids), torch.zeros(3, 12, dtype=torch.long), torch.tensor(mask)).numpy()
    m = mask.astype(bool)
    np.testing.assert_allclose(got[m], want[m], rtol=1e-5, atol=1e-5)


def test_clip_tower_matches_jax_mapping_and_hf_forward():
    layers = 3
    cfg = transformers.CLIPVisionConfig(image_size=32, patch_size=16, hidden_size=HIDDEN, num_hidden_layers=layers,
                                        num_attention_heads=HEADS, intermediate_size=128, hidden_act="quick_gelu",
                                        layer_norm_eps=1e-5, attention_dropout=0.0)
    torch.manual_seed(4)
    hf = transformers.CLIPVisionModel(cfg).eval()
    sd = dict(hf.state_dict())
    mapped = phf.clip_vit_tower_params(sd, layers)
    want = _flax_rel(jhf.clip_vit_tower_params({k: v.numpy() for k, v in sd.items()}, layers))
    assert set(mapped) == set(want)
    for k, v in want.items():
        assert torch.equal(mapped[k], v), k

    tower_cfg = pconfig.clip_vit_tower_config(image_size=32, patch_size=16, hidden_size=HIDDEN,
                                             num_hidden_layers=layers, num_attention_heads=HEADS,
                                             intermediate_size=128)
    tower_cfg = dataclasses.replace(tower_cfg, hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    tower = ViTBottomTower(tower_cfg, layers, torch.float32)
    tower.load_state_dict(mapped, strict=True)
    px = torch.from_numpy(np.random.default_rng(1).standard_normal((2, 3, 32, 32)).astype(np.float32))
    with torch.no_grad():
        # CLIP applies post_layernorm to the pooled token only; the tower
        # applies it to every token (ViT's last_hidden_state)
        want = hf.vision_model.post_layernorm(hf(px).last_hidden_state).numpy()
        got = tower(px).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_pretrained_loader_imports_transformers_lazily():
    import inspect

    src = inspect.getsource(phf)
    head = src[: src.index("def state_dicts_from_pretrained")]
    assert "import transformers" not in head and "from transformers" not in head
    assert "from transformers import AutoModel" in inspect.getsource(phf.state_dicts_from_pretrained)


def test_hf_init_flag_still_exits_2_naming_what_is_missing(capsys):
    """``--hf-init`` needs the pretrained weights, which are not in the
    repository: the launcher exits 2 and says that the mapping exists."""
    from multimodaldiscussiontransformer_tpu_torch.train import launch

    with pytest.raises(SystemExit) as e:
        launch.main(["--synthetic", "--tiny", "--device", "cpu", "--no-save", "--hf-init"])
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert "--hf-init is not ported yet" in err and "pretrained BERT/ViT weights" in err
    assert "utils/hf_import.py" in err
