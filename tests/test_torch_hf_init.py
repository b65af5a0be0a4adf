"""``--hf-init`` in the port: pretrained BERT / ViT towers read from a local
HF directory or the HF cache without ``transformers``
(``utils/hf_import.py``), held against the JAX package, whose
``state_dicts_from_pretrained`` loads the same files through
``transformers`` (offline, from local directories):

- the reader: bit-equal arrays on every key the file provides, for
  safetensors (single and sharded), ``pytorch_model.bin`` (single and
  sharded), TF-era ``LayerNorm.gamma`` / ``.beta`` names, a base-model
  BERT checkpoint and a head-model ViT one, and F16 / BF16 files; the
  classifier transformers draws is drawn with its shape, a zero bias and a
  std within 25% of ``initializer_range``; a classifier of other
  ``num_labels`` than the config's raises, as ``from_pretrained`` does;
- the cache: a name resolves through ``models--*/refs/main`` to the
  snapshot ``huggingface_hub`` finds; a missing name raises naming the
  cache;
- ``import_towers`` on both sides' results, unrolled and scan layout;
- the launcher: ``--tiny`` ignores the flag, ``hf_init_state`` writes the
  file's tensors into the trainer's state in one process and under a
  two-rank gloo FSDP layout, a ``--restore-file`` overrides the towers;
- the comment-only baseline's ``--hf-init`` from a cache, and the
  readiness gate's HF check, with ``transformers`` unimportable on the
  port's side.

Tiny models written by ``save_pretrained`` into ``tmp_path``, each from a
seed."""

import inspect
import os
import subprocess
import sys
import textwrap

os.environ.setdefault("USE_TF", "0")  # transformers would import TensorFlow for nothing
os.environ.setdefault("HF_HUB_OFFLINE", "1")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

transformers = pytest.importorskip("transformers")

from multimodaldiscussiontransformer_tpu.core import config as jconfig  # noqa: E402
from multimodaldiscussiontransformer_tpu.experiments.hateful_discussions import readiness as jreadiness  # noqa: E402
from multimodaldiscussiontransformer_tpu.utils import hf_import as jhf  # noqa: E402
from multimodaldiscussiontransformer_tpu_torch.core import config as pconfig  # noqa: E402
from multimodaldiscussiontransformer_tpu_torch.experiments.hateful_discussions import readiness  # noqa: E402
from multimodaldiscussiontransformer_tpu_torch.models.mdt import MDTModel  # noqa: E402
from multimodaldiscussiontransformer_tpu_torch.train import launch  # noqa: E402
from multimodaldiscussiontransformer_tpu_torch.train.trainer import Trainer  # noqa: E402
from multimodaldiscussiontransformer_tpu_torch.utils import hf_import as phf  # noqa: E402
from multimodaldiscussiontransformer_tpu_torch.utils.checkpoints import Checkpointer  # noqa: E402
from multimodaldiscussiontransformer_tpu_torch.utils.flax_import import flax_to_state_dict, to_flax_params  # noqa: E402
from multimodaldiscussiontransformer_tpu_torch.utils.scan_params import scanned_state_dict, unrolled_state_dict  # noqa: E402

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEXT, IMAGE = "bert-base-uncased", "google/vit-base-patch16-224"
# the towers of tiny_model_config()
BERT = dict(vocab_size=128, hidden_size=64, num_hidden_layers=4, num_attention_heads=4, intermediate_size=128,
            max_position_embeddings=64)
VIT = dict(image_size=32, patch_size=16, hidden_size=64, num_hidden_layers=4, num_attention_heads=4,
           intermediate_size=128)


def save_bert(path, seed, cls="BertForPreTraining", dtype=torch.float32, bert=None, **save_kw):
    torch.manual_seed(seed)
    config = transformers.BertConfig(**(bert or BERT), **({"num_labels": 3} if "Sequence" in cls else {}))
    getattr(transformers, cls)(config).to(dtype).save_pretrained(path, **save_kw)
    return str(path)


def save_vit(path, seed, cls="ViTForImageClassification", dtype=torch.float32, **save_kw):
    torch.manual_seed(seed)
    extra = {"num_labels": 10} if cls == "ViTForImageClassification" else {}
    getattr(transformers, cls)(transformers.ViTConfig(**VIT, **extra)).to(dtype).save_pretrained(path, **save_kw)
    return str(path)


def rename_layer_norms(path):
    """The checkpoint rewritten with the TF-era ``LayerNorm.gamma`` /
    ``.beta`` names (the published bert-base-uncased's)."""
    from safetensors.torch import load_file, save_file

    file = os.path.join(path, "model.safetensors")
    sd = load_file(file)
    renamed = {k.replace("LayerNorm.weight", "LayerNorm.gamma").replace("LayerNorm.bias", "LayerNorm.beta"): v
               for k, v in sd.items()}
    assert sum(k.endswith("gamma") for k in renamed) == 2 * BERT["num_hidden_layers"] + 2
    save_file(renamed, file, metadata={"format": "pt"})
    return path


def to_cache(cache, name, directory, sha="0123abcd"):
    """``directory``'s files as the snapshot of ``name`` in an HF cache."""
    repo = os.path.join(cache, "models--" + name.replace("/", "--"))
    os.makedirs(os.path.join(repo, "refs"), exist_ok=True)
    with open(os.path.join(repo, "refs", "main"), "w") as f:
        f.write(sha)
    os.renames(directory, os.path.join(repo, "snapshots", sha))
    return str(cache)


def write_cache(cache, seed=0, bert=None):
    to_cache(cache, TEXT, save_bert(os.path.join(cache, "t"), seed, bert=bert))
    return to_cache(cache, IMAGE, save_vit(os.path.join(cache, "i"), seed + 1, safe_serialization=False))


def drawn(key):
    return key.startswith("classifier.")


TEXT_CASES = {
    "safetensors": lambda p: save_bert(p, 0),
    "safetensors_sharded": lambda p: save_bert(p, 1, max_shard_size="40KB"),
    "bin": lambda p: save_bert(p, 2, safe_serialization=False),
    "bin_sharded": lambda p: save_bert(p, 8, safe_serialization=False, max_shard_size="40KB"),
    "gamma_beta": lambda p: rename_layer_norms(save_bert(p, 3)),
    "base_model": lambda p: save_bert(p, 4, cls="BertModel"),
    "head_with_classifier": lambda p: save_bert(p, 5, cls="BertForSequenceClassification"),
    "float16": lambda p: save_bert(p, 6, dtype=torch.float16),
    "bfloat16": lambda p: save_bert(p, 7, dtype=torch.bfloat16),
}
IMAGE_CASES = {
    "safetensors": lambda p: save_vit(p, 10),
    "safetensors_sharded": lambda p: save_vit(p, 11, max_shard_size="40KB"),
    "bin": lambda p: save_vit(p, 12, safe_serialization=False),
    "bin_sharded": lambda p: save_vit(p, 13, safe_serialization=False, max_shard_size="40KB"),
    "base_model": lambda p: save_vit(p, 14, cls="ViTModel"),
    "head_with_classifier": lambda p: save_vit(p, 15),
    "gamma_beta": lambda p: save_vit(p, 18),
    "float16": lambda p: save_vit(p, 16, dtype=torch.float16),
    "bfloat16": lambda p: save_vit(p, 17, dtype=torch.bfloat16),
}
assert TEXT_CASES.keys() == IMAGE_CASES.keys()


@pytest.mark.parametrize("case", sorted(TEXT_CASES))
def test_reader_matches_jax_bit_for_bit(tmp_path, case):
    """The same files through JAX's loader (transformers) and the port's:
    the same keys (but the ViT pooler transformers draws, which the port's
    model has no place for), float32, and equal bits wherever the file
    holds the tensor; the file format chosen is transformers' first."""
    text_dir = TEXT_CASES[case](tmp_path / "text")
    image_dir = IMAGE_CASES[case](tmp_path / "image")
    files = sorted(os.listdir(text_dir)) + sorted(os.listdir(image_dir))
    assert ("index.json" in " ".join(files)) == ("sharded" in case)
    j_bert, j_vit = jhf.state_dicts_from_pretrained(text_dir, image_dir)
    p_bert, p_vit = phf.state_dicts_from_pretrained(text_dir, image_dir)
    assert set(p_bert) == set(j_bert)
    assert set(j_vit) - set(p_vit) == {"vit.pooler.dense.weight", "vit.pooler.dense.bias"}
    assert set(p_vit) < set(j_vit)
    in_file = case == "head_with_classifier"
    for key, want in [*j_bert.items(), *((k, v) for k, v in j_vit.items() if k in p_vit)]:
        got = (p_bert if key in p_bert else p_vit)[key]
        assert got.dtype == want.dtype == np.float32 and got.shape == want.shape, key
        if drawn(key) and key in j_bert and not in_file:
            continue  # drawn at random on both sides
        assert np.array_equal(got, want), key
    if not in_file:
        assert not p_bert["classifier.bias"].any() and p_bert["classifier.weight"].shape == (2, BERT["hidden_size"])


def test_drawn_classifier_has_hf_shape_zero_bias_and_std():
    """A pretraining checkpoint has no classifier: it is drawn with the
    config's ``num_labels`` and ``initializer_range``, from the seed."""
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        torch.manual_seed(20)
        config = transformers.BertConfig(**{**BERT, "hidden_size": 128, "num_attention_heads": 4},
                                         num_labels=8, initializer_range=0.05)
        transformers.BertForPreTraining(config).save_pretrained(d)
        j_bert = jhf.state_dicts_from_pretrained(d, save_vit(os.path.join(d, "v"), 21))[0]
        a, b = phf.text_state_dict(d, seed=3), phf.text_state_dict(d, seed=3)
        c = phf.text_state_dict(d, seed=4)
    w = a["classifier.weight"]
    assert w.shape == j_bert["classifier.weight"].shape == (8, 128)
    assert not a["classifier.bias"].any() and a["classifier.bias"].shape == (8,)
    assert abs(float(w.std()) - 0.05) <= 0.25 * 0.05 and abs(float(w.mean())) < 0.05
    assert np.array_equal(w, b["classifier.weight"]) and not np.array_equal(w, c["classifier.weight"])


def test_classifier_of_other_labels_raises_as_transformers_does(tmp_path):
    """A file's classifier whose rows disagree with its config's labels
    raises (``from_pretrained`` without ``ignore_mismatched_sizes``)."""
    from safetensors.torch import load_file, save_file

    d = save_bert(tmp_path / "t", 22, cls="BertForSequenceClassification")  # 3 labels
    sd = load_file(os.path.join(d, "model.safetensors"))
    sd["classifier.weight"], sd["classifier.bias"] = sd["classifier.weight"][:2], sd["classifier.bias"][:2]
    save_file(sd, os.path.join(d, "model.safetensors"), metadata={"format": "pt"})
    with pytest.raises(RuntimeError, match="size mismatch"):
        transformers.AutoModelForSequenceClassification.from_pretrained(d)
    with pytest.raises(ValueError, match="classifier.weight has shape"):
        phf.text_state_dict(d)


@pytest.mark.parametrize("env", ["HF_HUB_CACHE", "HF_HOME"])
def test_cache_name_resolves_as_huggingface_hub_does(tmp_path, monkeypatch, env):
    from huggingface_hub import try_to_load_from_cache

    cache = tmp_path / "hub"
    write_cache(str(cache), seed=30)
    for var in ("HF_HUB_CACHE", "HUGGINGFACE_HUB_CACHE", "HF_HOME"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv(env, str(cache) if env == "HF_HUB_CACHE" else str(tmp_path))  # $HF_HOME/hub
    for name in (TEXT, IMAGE):
        snapshot = phf.resolve_pretrained(name)
        hub = try_to_load_from_cache(name, "config.json", cache_dir=str(cache))
        assert snapshot == os.path.dirname(hub) and snapshot.endswith(os.path.join("snapshots", "0123abcd"))
    by_name = phf.state_dicts_from_pretrained(TEXT, IMAGE)
    by_dir = phf.state_dicts_from_pretrained(phf.resolve_pretrained(TEXT), phf.resolve_pretrained(IMAGE))
    for a, b in zip(by_name, by_dir):
        assert a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)
    with pytest.raises(FileNotFoundError) as e:
        phf.resolve_pretrained("no-such-org/no-such-model")
    assert str(cache) in str(e.value) and "models--no-such-org--no-such-model" in str(e.value)
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(FileNotFoundError, match="no config.json"):
        phf.state_dicts_from_pretrained(str(empty), IMAGE)


@pytest.mark.parametrize("scan", [False, True])
def test_import_towers_of_both_readers_bit_equal(tmp_path, scan):
    """JAX's loader + JAX's ``import_towers`` against the port's, on a
    gamma/beta BERT file and a ViT classifier: every tower, fusion and
    pooler tensor equal (the classifier is drawn on each side)."""
    text_dir = rename_layer_norms(save_bert(tmp_path / "t", 40))
    image_dir = save_vit(tmp_path / "i", 41, safe_serialization=False)
    model = MDTModel(pconfig.tiny_model_config(scan_layers=scan), generator=torch.Generator().manual_seed(42))
    own = model.state_dict()
    sd = scanned_state_dict(own, model.config) if scan else own
    got = phf.import_towers(sd, model.config, *phf.state_dicts_from_pretrained(text_dir, image_dir))
    assert any(k.startswith("graph_encoder.scan_pairs") for k in got) == scan
    want = flax_to_state_dict(jhf.import_towers(to_flax_params(model), jconfig.tiny_model_config(scan_layers=scan),
                                                *jhf.state_dicts_from_pretrained(text_dir, image_dir)))
    got = unrolled_state_dict(got, model.config)
    changed = 0
    for k, v in own.items():
        if k.startswith("node_classifier."):
            continue
        assert torch.equal(got[k], want[k]), k
        changed += not torch.equal(got[k], v)
    assert changed > 50  # layer norms start at 1 and 0, biases at 0, on both sides


def _fit_capture(monkeypatch, seen):
    """``Trainer.fit`` replaced by one that keeps the state's params and
    stops the run before its first update."""
    def fit(self, dataset, state=None, **kw):
        seen.append({k: v.detach().clone() for k, v in state.model.state_dict().items()})
        self.stopped = True
        return state
    monkeypatch.setattr(Trainer, "fit", fit)


TINY = ["--synthetic", "--tiny", "--device", "cpu", "--batch-size", "4", "--no-save"]


def test_tiny_ignores_the_flag(tmp_path, monkeypatch):
    """As in JAX (``args.hf_init and not args.tiny``): the same weights as a
    run without the flag, with no checkpoint anywhere."""
    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path / "empty"))
    seen = []
    _fit_capture(monkeypatch, seen)
    assert launch.main(TINY + ["--save-dir", str(tmp_path / "a")]) == 0
    assert launch.main(TINY + ["--save-dir", str(tmp_path / "b"), "--hf-init"]) == 0
    assert seen[0].keys() == seen[1].keys() and all(torch.equal(seen[0][k], seen[1][k]) for k in seen[0])


def _tiny_train_cfg(cache_names=(TEXT, IMAGE), **kw):
    cfg = pconfig.TrainConfig(
        model=pconfig.tiny_model_config().replace(text_encoder_name=cache_names[0], image_encoder_name=cache_names[1]),
        data=pconfig.DataConfig(batch_size=4, max_text_len=16, node_buckets=(8,), node_capacity_buckets=(128,),
                                image_capacity_buckets=(64,), label_capacity_buckets=(64,)),
        task_cfg=pconfig.TaskConfig(dataset_name="synthetic", seed=0), **kw)
    return cfg


def _expected_params(cfg, text_dir, image_dir):
    fresh = MDTModel(cfg.model, generator=torch.Generator().manual_seed(cfg.seed)).state_dict()
    return phf.import_towers(fresh, cfg.model, *phf.state_dicts_from_pretrained(text_dir, image_dir, seed=cfg.seed))


def test_hf_init_state_puts_the_files_into_the_state(tmp_path, monkeypatch):
    """One process: the launcher's ``hf_init_state`` gives the fresh
    model with the files' towers written in, and a file tensor lands
    where the reference's layer split puts it."""
    monkeypatch.setenv("HF_HUB_CACHE", write_cache(str(tmp_path / "hub"), seed=50))
    cfg = _tiny_train_cfg()
    trainer = Trainer(cfg, image_shape=(3, 32, 32), device="cpu")
    state = launch.hf_init_state(trainer, cfg)
    got = state.model.state_dict()
    want = _expected_params(cfg, phf.resolve_pretrained(TEXT), phf.resolve_pretrained(IMAGE))
    assert got.keys() == want.keys() and all(torch.equal(got[k], want[k]) for k in got)
    bert = phf.text_state_dict(TEXT)
    top = got["graph_encoder.fusion_stack_2.fusion_0.bert_encoder.output_dense.weight"]
    assert torch.equal(top, torch.from_numpy(bert["bert.encoder.layer.3.output.dense.weight"]))


FSDP_RANK = textwrap.dedent("""
    import os, sys
    import torch, torch.distributed as dist
    sys.path.insert(0, {root!r})
    torch.set_num_threads(1)
    rank = int(sys.argv[1])
    dist.init_process_group("gloo", init_method="tcp://127.0.0.1:{port}", rank=rank, world_size=2)
    from torch.distributed.tensor import DTensor
    from multimodaldiscussiontransformer_tpu_torch.core import config as pconfig
    from multimodaldiscussiontransformer_tpu_torch.train import launch
    from multimodaldiscussiontransformer_tpu_torch.train.trainer import Trainer
    TEXT, IMAGE = {names!r}
    cfg = _tiny_train_cfg(dp_size=2, fsdp=True)
    trainer = Trainer(cfg, image_shape=(3, 32, 32), device="cpu")
    state = launch.hf_init_state(trainer, cfg)
    sharded = sum(isinstance(p, DTensor) for p in state.model.parameters())
    full = state.layout.full_state_dict(state.model)
    if rank == 0:
        torch.save({{"full": full, "sharded": sharded}}, {out!r})
    dist.barrier()
    dist.destroy_process_group()
""")


def test_hf_init_state_under_two_rank_fsdp(tmp_path):
    """fsdp over dp=2 on gloo: the towers go into the full params before
    FSDP2 shards them; the gathered state equals one process's."""
    import socket

    cache = write_cache(str(tmp_path / "hub"), seed=60)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    out = str(tmp_path / "rank0.pt")
    script = FSDP_RANK.format(root=ROOT, names=(TEXT, IMAGE), port=port, out=out).replace(
        "\ncfg = _tiny_train_cfg(", "\n" + inspect.getsource(_tiny_train_cfg) + "\ncfg = _tiny_train_cfg(")
    env = {**os.environ, "HF_HUB_CACHE": cache, "OMP_NUM_THREADS": "1", "JAX_PLATFORMS": "cpu"}
    procs = [subprocess.Popen([sys.executable, "-c", script, str(r)], env=env, cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(2)]
    logs = [p.communicate(timeout=120)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), logs
    res = torch.load(out, weights_only=False)
    assert res["sharded"] > 50
    cfg = _tiny_train_cfg()
    os.environ["HF_HUB_CACHE"], prev = cache, os.environ.get("HF_HUB_CACHE")
    try:
        want = _expected_params(cfg, phf.resolve_pretrained(TEXT), phf.resolve_pretrained(IMAGE))
    finally:
        os.environ.pop("HF_HUB_CACHE") if prev is None else os.environ.__setitem__("HF_HUB_CACHE", prev)
    got = unrolled_state_dict(res["full"], cfg.model)
    assert got.keys() == want.keys() and all(torch.equal(got[k], want[k]) for k in got)


def test_restore_file_overrides_the_towers(tmp_path, monkeypatch, capsys):
    """Through ``launch.main`` with the flag applied at tiny width: the
    towers go in ("initialized towers from HF checkpoints"), and with
    ``--restore-file`` the restored weights win, as in JAX's order."""
    monkeypatch.setenv("HF_HUB_CACHE", write_cache(str(tmp_path / "hub"), seed=70))
    ck = str(tmp_path / "ck")
    assert launch.main(TINY[:-1] + ["--max-updates", "1", "--save-dir", ck]) == 0
    restored = Checkpointer(ck).restore()["params"]
    monkeypatch.setattr(launch, "hf_init_requested", lambda args: args.hf_init)
    seen = []
    _fit_capture(monkeypatch, seen)
    capsys.readouterr()
    assert launch.main(TINY + ["--hf-init", "--save-dir", str(tmp_path / "a")]) == 0
    assert "initialized towers from HF checkpoints" in capsys.readouterr().out
    assert launch.main(TINY + ["--hf-init", "--restore-file", ck, "--save-dir", str(tmp_path / "b")]) == 0
    out = capsys.readouterr().out
    assert "initialized towers from HF checkpoints" in out and f"restored from {ck}" in out
    cfg = launch.config_from_args(launch.build_parser().parse_args(TINY))
    want = _expected_params(cfg, phf.resolve_pretrained(TEXT), phf.resolve_pretrained(IMAGE))
    assert all(torch.equal(seen[0][k], want[k]) for k in want)
    restored = unrolled_state_dict(restored, cfg.model)
    assert all(torch.equal(seen[1][k], restored[k].to(seen[1][k].dtype)) for k in restored)
    assert not torch.equal(seen[1]["graph_encoder.text_model.layer_0.output_dense.weight"],
                           seen[0]["graph_encoder.text_model.layer_0.output_dense.weight"])


def test_missing_checkpoint_exits_1_naming_it(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path / "hub"))
    monkeypatch.setattr(launch, "hf_init_requested", lambda args: args.hf_init)
    assert launch.main(TINY + ["--hf-init", "--save-dir", str(tmp_path / "a")]) == 1
    err = capsys.readouterr().err
    assert "error: --hf-init" in err and "models--bert-base-uncased" in err and str(tmp_path / "hub") in err


@pytest.fixture
def no_transformers(monkeypatch):
    monkeypatch.setitem(sys.modules, "transformers", None)  # import raises ImportError


def test_trainval_hf_init_trains_from_a_cache(tmp_path, monkeypatch, no_transformers):
    """``trainval --hf-init`` reads bert-base-uncased from the cache
    (``state_dicts_from_pretrained()`` with its default names, as JAX's
    trainval does) and trains 3 steps."""
    pd = pytest.importorskip("pandas")
    from multimodaldiscussiontransformer_tpu_torch.core.config import BertTowerConfig
    from multimodaldiscussiontransformer_tpu_torch.experiments.comment_only import text_bert, trainval

    tower = dict(vocab_size=30522, hidden_size=32, num_hidden_layers=2, num_attention_heads=4, intermediate_size=64,
                 max_position_embeddings=128)
    monkeypatch.setenv("HF_HUB_CACHE", write_cache(str(tmp_path / "hub"), seed=80, bert=tower))
    words = "the a post reply thanks point fair agree scum filth vermin".split()
    vocab = tmp_path / "vocab.txt"
    vocab.write_text("\n".join(["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + words) + "\n")
    rng = np.random.RandomState(0)
    for part, n in (("train", 12), ("test", 6)):
        labels = rng.randint(0, 2, n)
        texts = [" ".join(rng.choice(words[:8] if y == 0 else words[5:], 6)) for y in labels]
        pd.DataFrame({"text": texts, "label": labels}).to_parquet(
            tmp_path / f"HatefulDiscussions_dataset_{part}-split-0.parquet")
    monkeypatch.setenv("MDT_BERT_VOCAB", str(vocab))
    small = BertTowerConfig(**tower, hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    monkeypatch.setattr(text_bert.TextBertConfig, "__post_init__", lambda self: setattr(self, "tower", self.tower or small))
    loaded = []
    real_train = text_bert.train
    monkeypatch.setattr(text_bert, "train", lambda *a, **k: loaded.append(k["hf_state_dict"]) or real_train(*a, **k))
    out = tmp_path / "out"
    rc = trainval.main(["-s", "0", "--data-dir", str(tmp_path), "--output-dir", str(out), "--max-steps", "3",
                        "--eval-steps", "2", "--batch-size", "4", "--warmup-steps", "1", "--device", "cpu",
                        "--hf-init"])
    assert rc == 0 and (out / "predictions.parquet").exists()
    want = phf.text_state_dict(TEXT)
    assert loaded[0].keys() == want.keys() and all(np.array_equal(loaded[0][k], want[k]) for k in want)
    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path / "none"))
    with pytest.raises(SystemExit) as e:
        trainval.main(["--hf-init", "--device", "cpu"])
    assert e.value.code == 1


def test_readiness_hf_check_gives_jax_verdict(tmp_path, monkeypatch):
    """``check_hf_checkpoint`` on a present directory, a present cache name
    and a missing checkpoint: JAX's ``ok`` (through ``transformers``), the
    port's without it."""
    present = save_bert(tmp_path / "bert", 90)
    cache = write_cache(str(tmp_path / "hub"), seed=91)
    missing = str(tmp_path / "nothing-here")
    want = {p: jreadiness.check_hf_checkpoint(p, "text")["ok"] for p in (present, missing)}
    assert want == {present: True, missing: False}
    monkeypatch.setitem(sys.modules, "transformers", None)
    monkeypatch.setenv("HF_HUB_CACHE", cache)
    for path, ok in want.items():
        got = readiness.check_hf_checkpoint(path, "text")
        assert got["ok"] == ok, got
    assert readiness.check_hf_checkpoint(TEXT, "text")["ok"]
    got = readiness.check_hf_checkpoint(missing, "text")
    assert "text checkpoint unavailable" in got["detail"] and missing in got["detail"]
    os.remove(os.path.join(present, "model.safetensors"))
    got = readiness.check_hf_checkpoint(present, "text")
    assert not got["ok"] and "no weights" in got["detail"] and "model.safetensors" in got["detail"]
