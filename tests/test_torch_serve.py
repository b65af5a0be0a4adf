"""The port's serving layer: ``DiscussionScorer`` against the JAX package's
on the same discussions and weights, request-batch padding, the batching
scorer and the HTTP endpoint, all on the CPU.

Tolerance for port vs JAX probabilities: atol 1e-5 (float32 on both sides;
XLA and PyTorch sum in different orders)."""

import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from multimodaldiscussiontransformer_tpu.core.config import DataConfig as JaxDataConfig
from multimodaldiscussiontransformer_tpu.core.config import tiny_model_config as jax_tiny_config
from multimodaldiscussiontransformer_tpu.models.mdt import MDTModel as JaxMDTModel
from multimodaldiscussiontransformer_tpu.serve import incremental as jserve
from multimodaldiscussiontransformer_tpu_torch.core.config import DataConfig, tiny_model_config
from multimodaldiscussiontransformer_tpu_torch.data.collator import collate
from multimodaldiscussiontransformer_tpu_torch.models.mdt import MDTModel
from multimodaldiscussiontransformer_tpu_torch.serve.incremental import (
    Discussion,
    DiscussionScorer,
    _batch_bucket,
)
from multimodaldiscussiontransformer_tpu_torch.serve.server import BatchingScorer, ScoreServer
from multimodaldiscussiontransformer_tpu_torch.utils.flax_import import to_flax_params

torch.set_num_threads(2)
IMG = (3, 32, 32)
BUCKETS = dict(
    batch_size=1,
    node_buckets=(8, 16),
    node_capacity_buckets=(8, 16, 32),
    image_capacity_buckets=(0, 4),
    label_capacity_buckets=(8,),
)


def _grow(d: Discussion, rng, n: int, image_at=()):
    for _ in range(n):
        nid = d.num_nodes
        parent = -1 if nid == 0 else int(rng.integers(0, nid))
        image = rng.standard_normal(IMG).astype(np.float32) if nid in image_at else None
        d.add_node(parent, rng.integers(1, 120, 12).astype(np.int32), image=image)
    return d


def _to_jax_discussion(d: Discussion) -> jserve.Discussion:
    j = jserve.Discussion()
    for i, p in enumerate(d.parents):
        j.add_node(p, d.input_ids[i], d.attention_mask[i], d.token_type_ids[i], d.images.get(i))
    return j


@pytest.fixture(scope="module")
def scorer():
    return DiscussionScorer(
        MDTModel(tiny_model_config(), generator=torch.Generator().manual_seed(5)),
        device="cpu", data_cfg=DataConfig(**BUCKETS), image_shape=IMG,
    )


def test_scorer_matches_jax_as_discussion_grows():
    """Same weights, same discussions: a root, then replies, then a reply
    with an image."""
    # the port's init carried to the Flax layout (a jitted Flax init costs
    # seconds here)
    port = MDTModel(tiny_model_config(), generator=torch.Generator().manual_seed(2))
    params = jax.tree.map(jnp.asarray, to_flax_params(port))
    jax_scorer = jserve.DiscussionScorer(JaxMDTModel(jax_tiny_config()), params, JaxDataConfig(**BUCKETS),
                                         image_shape=IMG)
    port_scorer = DiscussionScorer(port, device="cpu", data_cfg=DataConfig(**BUCKETS), image_shape=IMG)

    rng = np.random.default_rng(0)
    d = _grow(Discussion(), rng, 1)
    for grow, image_at in ((0, ()), (3, ()), (2, (5,))):
        _grow(d, rng, grow, image_at)
        got = port_scorer.score(d)
        want = jax_scorer.score(_to_jax_discussion(d))
        assert got.shape == (d.num_nodes, 2)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert len(d.images) == 1


def test_batch_bucket_padding_is_inert(scorer):
    """A 3-discussion request pads to the 4-bucket with zero-node pad
    graphs; each real item scores as it does alone."""
    assert [_batch_bucket(n, "pow2") for n in (1, 2, 3, 4, 5, 16)] == [1, 2, 4, 4, 8, 16]
    assert _batch_bucket(3, (2, 6)) == 6
    assert _batch_bucket(7, None) == 7
    with pytest.raises(ValueError):
        _batch_bucket(9, (2, 4))

    rng = np.random.default_rng(1)
    discussions = [_grow(Discussion(), rng, n) for n in (1, 3, 2)]
    items = [d.to_item(i) for i, d in enumerate(discussions)]
    batched = scorer.score_items(items)
    for got, d in zip(batched, discussions):
        np.testing.assert_allclose(got, scorer.score(d), rtol=1e-4, atol=1e-5)

    shapes = []
    for reqs in (items[:1] * 3, items[:1] * 4):
        b = collate(
            list(reqs), pad_to_graphs=_batch_bucket(len(reqs), "pow2"),
            node_buckets=BUCKETS["node_buckets"], node_capacity_buckets=BUCKETS["node_capacity_buckets"],
            image_capacity_buckets=BUCKETS["image_capacity_buckets"],
            label_capacity_buckets=BUCKETS["label_capacity_buckets"], image_shape=IMG,
        )
        shapes.append({k: v.shape for k, v in b.asdict().items()})
    assert shapes[0] == shapes[1]


def test_batching_scorer_concurrent_requests(scorer):
    rng = np.random.default_rng(2)
    discussions = [_grow(Discussion(), rng, 2 + i % 3, image_at=(1,) if i == 2 else ()) for i in range(6)]
    direct = [scorer.score(d) for d in discussions]
    batching = BatchingScorer(scorer, max_batch=8, max_wait_ms=20.0)
    results = [None] * len(discussions)

    def worker(i):
        results[i] = batching.score(discussions[i])

    try:
        threads = [threading.Thread(target=worker, args=(i,)) for i in range(len(discussions))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
    finally:
        batching.close()
    for got, want in zip(results, direct):
        assert got is not None
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    with pytest.raises(RuntimeError):
        batching.score(discussions[0])


def _post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as resp:
        return resp.status, json.loads(resp.read())


def test_score_server_round_trip(scorer):
    rng = np.random.default_rng(3)
    d = _grow(Discussion(), rng, 3, image_at=(2,))
    server = ScoreServer(("127.0.0.1", 0), scorer, max_batch=4, max_wait_ms=5.0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        with urllib.request.urlopen(base + "/healthz", timeout=30) as resp:
            assert json.loads(resp.read()) == {"ok": True}
        payload = {"discussions": [{
            "parents": d.parents,
            "input_ids": [ids.tolist() for ids in d.input_ids],
            "images": {str(k): v.tolist() for k, v in d.images.items()},
        }]}
        status, body = _post(base + "/v1/score", payload)
        assert status == 200
        np.testing.assert_allclose(np.asarray(body["probs"][0]), scorer.score(d), rtol=1e-5, atol=1e-6)
        with pytest.raises(urllib.error.HTTPError):
            _post(base + "/v1/score", {"discussions": []})
    finally:
        server.close()
        thread.join(timeout=10)


def test_scorer_defaults_to_the_card(monkeypatch):
    """Without ``device=`` the scorer wants CUDA and raises where there is
    none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        DiscussionScorer(MDTModel(tiny_model_config()))
