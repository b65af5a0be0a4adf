"""The port's input runtime on the CPU: the prefetch thread
(``data/loader.py::ThreadedPrefetcher``) yields the plain iterator's groups,
``Trainer.fit`` through it equals hand-driven ``train_step``s, an early stop
leaves no thread and a thread's exception reaches the consumer; worker
processes (``data/worker_loader.py``) yield ``iterate_batches``'s batches, as
the JAX package's ``tests/test_grain_loader.py`` holds its Grain loader."""

import dataclasses
import threading

import numpy as np
import pytest
import torch

from multimodaldiscussiontransformer_tpu_torch.core import config as pconfig
from multimodaldiscussiontransformer_tpu_torch.data.collator import to_tensors
from multimodaldiscussiontransformer_tpu_torch.data.dataset import batch_index_chunks, iterate_batches
from multimodaldiscussiontransformer_tpu_torch.data.loader import (
    ThreadedPrefetcher,
    cast_images_for_transfer,
    stack_microbatches,
)
from multimodaldiscussiontransformer_tpu_torch.data.synthetic import synthetic_dataset
from multimodaldiscussiontransformer_tpu_torch.data.worker_loader import worker_batches
from multimodaldiscussiontransformer_tpu_torch.experiments.hateful_discussions.dataset import create_hatespeech_dataset
from multimodaldiscussiontransformer_tpu_torch.experiments.hateful_discussions.ingest import save_graph_npz
from multimodaldiscussiontransformer_tpu_torch.models.mdt import MDTModel
from multimodaldiscussiontransformer_tpu_torch.train.trainer import Trainer

torch.set_num_threads(2)
IMG = (3, 32, 32)
SYN = dict(seq_len=16, vocab_size=128, image_shape=IMG, max_nodes=8)


def train_cfg(**kw):
    """The tiny model with dropout on, batch 4 x update_freq 3, single-entry
    ladders."""
    m = pconfig.tiny_model_config(dropout=0.1, attention_dropout=0.3)
    base = dict(
        model=m,
        data=pconfig.DataConfig(batch_size=4, max_text_len=16, node_buckets=(8,), node_capacity_buckets=(64,),
                                image_capacity_buckets=(16,), label_capacity_buckets=(32,)),
        optim=pconfig.OptimConfig(lr=1e-3, warmup_updates=2, total_num_update=20, update_freq=3),
        task_cfg=pconfig.TaskConfig(dataset_name="synthetic", seed=0),
        log_interval=100, validate_interval_updates=0,
    )
    base.update(kw)
    return pconfig.TrainConfig(**base)


def test_prefetcher_yields_the_plain_groups_bit_equal():
    ds = synthetic_dataset(num_graphs=40, seed=3, **SYN)
    trainer = Trainer(train_cfg(), image_shape=IMG, device="cpu")
    plain = list(stack_microbatches(trainer.train_batches(ds, 2), 3, pad_tail=True))
    groups = stack_microbatches(trainer.train_batches(ds, 2), 3, pad_tail=True)
    staged = [item.ready() for item in trainer.prefetch(groups, trainer.stage)]
    assert len(staged) == len(plain) == 3
    for got, want in zip(staged, plain):
        assert set(got) == set(want)
        for k, v in want.items():
            assert torch.equal(got[k], to_tensors({k: v}, "cpu")[k]), k


def test_fit_equals_hand_driven_train_steps():
    """``fit`` (prefetch thread, staging) against ``train_step`` over the
    plain iterator's groups from the same state: every parameter and both
    generators bit-equal after 4 updates across an epoch boundary."""
    ds = synthetic_dataset(num_graphs=40, seed=3, **SYN)
    trainer = Trainer(train_cfg(), image_shape=IMG, device="cpu")
    fitted = trainer.fit(ds, max_updates=4, log_fn=lambda m: None)
    assert len(trainer.input_waits) == 4
    hand = trainer.init_state()
    done = 0
    for epoch in (1, 2):
        for group in stack_microbatches(trainer.train_batches(ds, epoch), 3, pad_tail=True):
            if done < 4:
                trainer.train_step(hand, group)
                done += 1
    assert done == 4 and fitted.num_updates == hand.num_updates == 4
    for (k, a), b in zip(fitted.model.state_dict().items(), hand.model.state_dict().values()):
        assert torch.equal(a, b), k
    assert torch.equal(fitted.host_rng.get_state(), hand.host_rng.get_state())
    assert torch.equal(fitted.device_rng.get_state(), hand.device_rng.get_state())


def _prefetch_threads():
    return [t for t in threading.enumerate() if t.name == "mdt-prefetch" and t.is_alive()]


def test_early_stop_leaves_no_thread():
    """``fit`` stopping mid-epoch (``max_updates``) and a consumer that
    breaks off both stop and join the prefetch thread."""
    ds = synthetic_dataset(num_graphs=60, seed=3, **SYN)
    trainer = Trainer(train_cfg(), image_shape=IMG, device="cpu")
    trainer.fit(ds, max_updates=1, log_fn=lambda m: None)
    assert not _prefetch_threads()
    endless = ({"x": np.full(3, i)} for i in range(10**6))
    pre = ThreadedPrefetcher(endless, lambda h: h, depth=2)
    for i, item in enumerate(pre):
        if i == 2:
            break
    assert not _prefetch_threads()


def test_thread_exception_reaches_the_consumer():
    def batches():
        yield {"x": np.zeros(2)}
        raise RuntimeError("collation failed")

    got = []
    with pytest.raises(RuntimeError, match="collation failed"):
        for item in ThreadedPrefetcher(batches(), lambda h: h):
            got.append(item)
    assert len(got) == 1 and not _prefetch_threads()

    with pytest.raises(ZeroDivisionError):
        list(ThreadedPrefetcher(iter([1, 0]), lambda h: 1 / h))


def test_image_cast_for_transfer_changes_no_bf16_forward():
    """Images cast to bf16 on the host: the bf16 model's forward is bit-equal
    to the one on float32 images, and the images' bytes halve."""
    ds = synthetic_dataset(num_graphs=8, seed=1, **{**SYN, "image_shape": IMG})
    trainer = Trainer(train_cfg(), image_shape=IMG, device="cpu")
    host = next(iter(iterate_batches(ds, ds.train_idx, trainer.cfg.data, trainer.cfg.task_cfg, image_shape=IMG))).asdict()
    assert host["images"].shape[0] > 0
    cast = cast_images_for_transfer(host, torch.bfloat16)
    assert cast["images"].dtype == torch.bfloat16 and host["images"].dtype == np.float32
    assert cast["images"].numel() * cast["images"].element_size() == host["images"].nbytes // 2
    model = MDTModel(pconfig.tiny_model_config(dtype="bfloat16"), generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        a = model(to_tensors(host, "cpu")).logits
        b = model(to_tensors(cast, "cpu")).logits
    assert torch.equal(a, b)


def _assert_same_batches(got, want):
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        for k, v in b.asdict().items():
            np.testing.assert_array_equal(a.asdict()[k], v, err_msg=k)


def test_worker_batches_equal_iterate_batches(tmp_path):
    """Two spawned workers over a ``hateful_discussions`` npz directory (lazy
    items, pickled to the workers): the shuffled, length-grouped training
    order and the padded eval tail, bit-equal to the in-process iterator."""
    src = synthetic_dataset(num_graphs=22, seed=2, **SYN)
    for i in range(len(src)):
        save_graph_npz(str(tmp_path / f"graph-{i}.npz"), src.get(i))
    ds = create_hatespeech_dataset(root=str(tmp_path), seed=1)
    data = dataclasses.replace(train_cfg().data, length_grouped=True, num_workers=2)
    task = pconfig.TaskConfig(seed=1)
    common = dict(image_shape=IMG, batch_size=4)
    train = dict(epoch=2, shuffle=True, **common)
    chunks = batch_index_chunks(ds, ds.train_idx, data, task, epoch=2, shuffle=True, batch_size=4)
    want = list(iterate_batches(ds, ds.train_idx, data, task, **train))
    assert [list(b.idx) for b in want] == [list(c) for c in chunks]
    _assert_same_batches(list(worker_batches(ds, ds.train_idx, data, task, **train)), want)
    tail = dict(drop_last=False, pad_tail_to_batch=True, **common)
    _assert_same_batches(list(worker_batches(ds, ds.test_idx, data, task, **tail)),
                         list(iterate_batches(ds, ds.test_idx, data, task, **tail)))
    with pytest.raises(ValueError, match="num_workers >= 1"):
        next(worker_batches(ds, ds.train_idx, data, task, num_workers=0, **train))


def test_fit_with_workers_equals_in_process():
    """``num_workers=2`` changes where the batches are collated, nothing
    else: the same parameters after 2 updates."""
    ds = synthetic_dataset(num_graphs=30, seed=3, **SYN)
    states = []
    for workers in (0, 2):
        cfg = train_cfg()
        cfg = cfg.replace(data=dataclasses.replace(cfg.data, num_workers=workers))
        states.append(Trainer(cfg, image_shape=IMG, device="cpu").fit(ds, max_updates=2, log_fn=lambda m: None))
    for (k, a), b in zip(states[0].model.state_dict().items(), states[1].model.state_dict().values()):
        assert torch.equal(a, b), k
