"""The scan param layout in the port (``utils/scan_params.py``): its
transforms bit-equal to the JAX package's, scan-layout Flax trees imported
like the unrolled ones, scan-layout checkpoints written under
``scan_layers``, resumed, re-laid-out by ``load_params`` and served by
``DiscussionScorer.from_checkpoint``."""

import jax
import numpy as np
import pytest
import torch

from multimodaldiscussiontransformer_tpu.core import config as jconfig
from multimodaldiscussiontransformer_tpu.utils import scan_params as jscan
from multimodaldiscussiontransformer_tpu_torch.core import config as pconfig
from multimodaldiscussiontransformer_tpu_torch.data.synthetic import synthetic_batch_items
from multimodaldiscussiontransformer_tpu_torch.models.mdt import MDTModel
from multimodaldiscussiontransformer_tpu_torch.serve.incremental import DiscussionScorer
from multimodaldiscussiontransformer_tpu_torch.train.trainer import Trainer
from multimodaldiscussiontransformer_tpu_torch.utils import checkpoints as ckpt
from multimodaldiscussiontransformer_tpu_torch.utils import scan_params as pscan
from multimodaldiscussiontransformer_tpu_torch.utils.flax_import import flax_to_state_dict, load_flax_params, to_flax_params

torch.set_num_threads(2)
IMG = (3, 32, 32)


def leaves(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def assert_trees_equal(a, b):
    la, lb = leaves(a), leaves(b)
    assert set(la) == set(lb)
    for k, v in lb.items():
        assert la[k].dtype == v.dtype and la[k].shape == v.shape, k
        np.testing.assert_array_equal(la[k], v, err_msg=k)


@pytest.fixture(scope="module")
def model():
    return MDTModel(pconfig.tiny_model_config(), generator=torch.Generator().manual_seed(0))


@pytest.mark.parametrize("wrapped", [True, False])
def test_transforms_bit_equal_to_jax(model, wrapped):
    """``to_scanned``, ``to_unrolled``, ``adapt_params`` and
    ``params_layout`` on the tiny tree (2 scanned pairs, one stacked layer
    per tower), with and without the ``{"params": ...}`` wrapper."""
    tree = to_flax_params(model)
    tree = tree if wrapped else tree["params"]
    jc, pc = jconfig.tiny_model_config(), pconfig.tiny_model_config()
    assert pscan.scan_plan(pc) == jscan.scan_plan(jc) == {"n_pairs_scanned": 2, "text_layers": 1, "image_layers": 1}
    scanned = pscan.to_scanned(tree, pc)
    assert_trees_equal(scanned, jscan.to_scanned(tree, jc))
    assert pscan.params_layout(scanned) == jscan.params_layout(scanned) == "scanned"
    assert pscan.params_layout(tree) == "unrolled"
    assert_trees_equal(pscan.to_unrolled(scanned, pc), jscan.to_unrolled(scanned, jc))
    assert_trees_equal(pscan.to_unrolled(scanned), tree)  # the counts read off the stacked axes
    js, ps = jc.replace(scan_layers=True), pc.replace(scan_layers=True)
    assert_trees_equal(pscan.adapt_params(tree, ps), jscan.adapt_params(tree, js))
    assert_trees_equal(pscan.adapt_params(scanned, pc), jscan.adapt_params(scanned, jc))


def test_flax_scan_tree_imports_like_the_unrolled_one(model):
    """A JAX scan-layout tree through ``flax_to_state_dict`` and
    ``load_flax_params`` gives the unrolled tree's state_dict; the port
    emits the scan layout for a ``scan_layers`` model."""
    tree = to_flax_params(model)
    scanned = jscan.to_scanned(tree, jconfig.tiny_model_config())
    want = flax_to_state_dict(tree)
    got = flax_to_state_dict(scanned)
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    other = load_flax_params(MDTModel(pconfig.tiny_model_config()), scanned)
    for k, v in other.state_dict().items():
        assert torch.equal(v, want[k]), k
    scan_model = MDTModel(pconfig.tiny_model_config(scan_layers=True))
    scan_model.load_state_dict(model.state_dict())
    assert_trees_equal(to_flax_params(scan_model), scanned)


def test_from_checkpoint_serves_a_scan_layout_checkpoint(model, tmp_path):
    """A params-only checkpoint in the scan layout scores exactly as the
    unrolled one."""
    sd = model.state_dict()
    stacked = pscan.scanned_state_dict(sd, model.config)
    assert any(k.startswith("graph_encoder.scan_pairs.") for k in stacked)
    assert pscan.state_dict_layout(stacked) == "scanned"
    ckpt.save_params(str(tmp_path / "unrolled"), sd)
    ckpt.save_params(str(tmp_path / "scanned"), stacked)
    items = [it for it in synthetic_batch_items(3, seed=4, min_nodes=3, max_nodes=8, seq_len=16, vocab_size=128,
                                                  image_prob=0.5, image_shape=IMG)]
    scores = []
    for name in ("unrolled", "scanned"):
        scorer = DiscussionScorer.from_checkpoint(str(tmp_path / name), model_cfg=pconfig.tiny_model_config(),
                                                  device="cpu", image_shape=IMG)
        scores.append(scorer.score_items(items))
    for a, b in zip(*scores):
        np.testing.assert_array_equal(a, b)


def test_scan_layers_checkpoints_resume_and_adapt(tmp_path):
    """Under ``scan_layers`` a saved state holds the scan layout; restoring
    it gives back every parameter, and ``load_params`` takes either layout
    into either config."""
    cfg = pconfig.TrainConfig(model=pconfig.tiny_model_config(scan_layers=True))
    trainer = Trainer(cfg, image_shape=IMG, device="cpu")
    state = trainer.init_state()
    saver = ckpt.Checkpointer(str(tmp_path))
    saver.save(state, 1)
    saver.wait()
    restored = saver.restore(state)
    assert pscan.state_dict_layout(restored["params"]) == "scanned"
    fresh = ckpt.restore_params_into_state(trainer, Trainer(cfg, image_shape=IMG, device="cpu").init_state(seed=9),
                                           restored, reset_optimizer=False)
    for (k, a), b in zip(state.model.state_dict().items(), fresh.model.state_dict().values()):
        assert torch.equal(a, b), k
    unrolled = Trainer(pconfig.TrainConfig(model=pconfig.tiny_model_config()), image_shape=IMG, device="cpu")
    other = unrolled.load_params(unrolled.init_state(seed=9), restored["params"])
    for (k, a), b in zip(state.model.state_dict().items(), other.model.state_dict().values()):
        assert torch.equal(a, b), k
