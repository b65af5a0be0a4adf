"""The port's readiness gate (``experiments/hateful_discussions/
readiness.py``) on the CPU, on stand-in assets that the port's generator
writes (``two_stage.generate_mini_corpus``: the reference schema and a
covering vocab):

- it passes (rc 0, the verdict last on stdout) with a 2-update smoke;
- it fails loudly with no assets, and rejects malformed trees;
- with ``transformers`` made unimportable, the HF checks resolve the
  checkpoints as ``--hf-init`` does and report each missing one (not ok,
  naming it), and the gate still passes."""

import json
import os
import sys

import pytest

from multimodaldiscussiontransformer_tpu_torch.experiments.hateful_discussions import readiness
from multimodaldiscussiontransformer_tpu_torch.experiments.hateful_discussions.two_stage import generate_mini_corpus


def _assets(tmp_path, n_trees=10):
    assets = tmp_path / "assets"
    paths = generate_mini_corpus(str(assets), n_trees=n_trees, seed=0, image_px=224, image_prob=0.3,
                                 image_format="npy")
    os.rename(paths["raw"], str(assets / "pruned-with-images.json"))
    return assets


def _verdict(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.fixture
def no_transformers(monkeypatch):
    monkeypatch.setitem(sys.modules, "transformers", None)  # import raises ImportError


def test_gate_passes_on_stand_in_assets(tmp_path, capsys, monkeypatch, no_transformers):
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    monkeypatch.setenv("MDT_BERT_VOCAB", "")  # the smoke sets it; restored after the test
    rc = readiness.main(["--assets", str(_assets(tmp_path)), "--out", str(tmp_path / "smoke"), "--smoke-trees", "8",
                         "--smoke-updates", "2", "--device", "cpu"])
    v = _verdict(capsys)
    assert rc == 0 and v["ok"], v
    c = v["checks"]
    assert c["vocab"]["ok"] and c["trees"]["ok"] and c["images"]["ok"] and c["smoke"]["ok"]
    assert "2 updates" in c["smoke"]["detail"]
    for kind, name in (("hf_text", "bert-base-uncased"), ("hf_image", "vit-base-patch16-224")):
        assert not c[kind]["ok"] and c[kind]["detail"].startswith(f"{kind[3:]} checkpoint unavailable"), c[kind]
        assert name in c[kind]["detail"], c[kind]


def test_gate_fails_loudly_without_assets(tmp_path, capsys):
    empty = tmp_path / "none"
    empty.mkdir()
    rc = readiness.main(["--assets", str(empty), "--no-smoke", "--device", "cpu"])
    v = _verdict(capsys)
    assert rc == 1 and not v["ok"]
    assert not v["checks"]["vocab"]["ok"] and not v["checks"]["trees"]["ok"]
    assert "smoke" not in v["checks"]


def test_gate_rejects_malformed_trees(tmp_path, capsys):
    assets = tmp_path / "assets"
    assets.mkdir()
    (assets / "vocab.txt").write_text("[PAD]\n[UNK]\n[CLS]\n[SEP]\nhello\n")
    (assets / "pruned-with-images.json").write_text(json.dumps({"data": {}, "images": []}) + "\n")
    rc = readiness.main(["--assets", str(assets), "--no-smoke", "--device", "cpu"])
    v = _verdict(capsys)
    assert rc == 1 and v["checks"]["vocab"]["ok"] and not v["checks"]["trees"]["ok"]
    assert "missing key 'id'" in v["checks"]["trees"]["detail"]


def test_hf_check_without_transformers_is_optional_absent(tmp_path, no_transformers):
    """Without ``transformers`` the check still runs (the port reads the
    files itself): a directory with no config is not ok, naming what is
    missing."""
    got = readiness.check_hf_checkpoint(str(tmp_path), "text")
    assert got == {"ok": False, "detail": got["detail"]} and got["detail"].startswith("text checkpoint unavailable")
    assert "no config.json" in got["detail"] and str(tmp_path) in got["detail"]
