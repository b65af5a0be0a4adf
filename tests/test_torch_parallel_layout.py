"""The port's per-rank input and mesh layout against the JAX package, in one
process: ``parallel/input.py`` and the collator's ``shard_multiple`` bit
for bit, the per-rank loading of every data-parallel rank, the mesh
geometry on torch's fake process group, and the parameters that tp shards
(and on which dim) against JAX ``param_sharding`` over the Flax tree, with
and without the scan layout."""

import dataclasses

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore

from multimodaldiscussiontransformer_tpu.core import config as jconfig
from multimodaldiscussiontransformer_tpu.data import collator as jcollator
from multimodaldiscussiontransformer_tpu.data import synthetic as jsyn
from multimodaldiscussiontransformer_tpu.data.grain_loader import grain_batches
from multimodaldiscussiontransformer_tpu.parallel import input as jinput
from multimodaldiscussiontransformer_tpu.parallel import mesh as jmesh
from multimodaldiscussiontransformer_tpu_torch.core import config as pconfig
from multimodaldiscussiontransformer_tpu_torch.data import collator as pcollator
from multimodaldiscussiontransformer_tpu_torch.data import synthetic as psyn
from multimodaldiscussiontransformer_tpu_torch.data.dataset import iterate_batches
from multimodaldiscussiontransformer_tpu_torch.models.mdt import MDTModel
from multimodaldiscussiontransformer_tpu_torch.parallel import input as pinput
from multimodaldiscussiontransformer_tpu_torch.parallel import mesh as pmesh
from multimodaldiscussiontransformer_tpu_torch.utils.flax_import import to_flax_params
from multimodaldiscussiontransformer_tpu_torch.utils.scan_params import scanned_state_dict

torch.set_num_threads(2)
SYN = dict(seq_len=16, vocab_size=128, image_shape=(3, 32, 32), max_nodes=8)


def data_cfg(mod):
    return mod.DataConfig(batch_size=4, max_text_len=16, node_buckets=(8,), node_capacity_buckets=(32, 128),
                          image_capacity_buckets=(0, 16, 64), label_capacity_buckets=(16, 64),
                          text_len_buckets=(8, 16))


def assert_batches_equal(a, b):
    a = a.asdict() if hasattr(a, "asdict") else a
    b = b.asdict() if hasattr(b, "asdict") else b
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("shard_multiple", [1, 2, 3, 4])
def test_collate_shard_multiple_matches_jax(shard_multiple):
    items_p = psyn.synthetic_batch_items(5, seed=1, **SYN)
    items_j = jsyn.synthetic_batch_items(5, seed=1, **SYN)
    kw = dict(node_buckets=(8,), node_capacity_buckets=(30, 64), image_capacity_buckets=(0, 9, 16),
              label_capacity_buckets=(10, 32), image_shape=SYN["image_shape"], shard_multiple=shard_multiple)
    assert_batches_equal(pcollator.collate(items_p, **kw), jcollator.collate(items_j, **kw))
    assert pcollator._bucket(7, (6, 9, 12), shard_multiple) == jcollator._bucket(7, (6, 9, 12), shard_multiple)


def test_input_functions_match_jax():
    for n, i in ((4, 1), (8, 3)):
        assert pinput.host_graph_slice(i, n, 16) == jinput.host_graph_slice(i, n, 16)
    with pytest.raises(ValueError):
        pinput.host_graph_slice(0, 3, 16)
    for n in (1, 2, 4):
        p = dataclasses.asdict(pinput.host_data_config(data_cfg(pconfig), n))
        j = dataclasses.asdict(jinput.host_data_config(data_cfg(jconfig), n))
        assert {k: p[k] for k in j} == j
    cfg = pinput.host_data_config(data_cfg(pconfig), 2)
    items = psyn.synthetic_batch_items(8, seed=2, **SYN)
    kw = dict(node_buckets=cfg.node_buckets, node_capacity_buckets=cfg.node_capacity_buckets,
              image_capacity_buckets=cfg.image_capacity_buckets, label_capacity_buckets=cfg.label_capacity_buckets,
              image_shape=SYN["image_shape"])
    locals_ = [pcollator.collate(items[:4], **kw).asdict(), pcollator.collate(items[4:], **kw).asdict()]
    assert_batches_equal(pinput.assemble_global_batch(locals_), jinput.assemble_global_batch(locals_))
    for i, local in enumerate(locals_):
        assert_batches_equal(pinput.local_batch_with_global_indices(local, i, 2),
                             jinput.local_batch_with_global_indices(local, i, 2))
        pinput.check_host_shapes(local, cfg)
    grown = dict(locals_[0], input_ids=np.zeros((65, 16), np.int32))
    for mod in (pinput, jinput):
        with pytest.raises(ValueError, match="overflowed"):
            mod.check_host_shapes(grown, cfg)


@pytest.mark.parametrize("split", ["train", "test"])
def test_per_rank_batches_match_jax_grain_loader(split):
    """Every data-parallel rank's batches of an epoch (a training epoch with
    drop_last; an evaluation split whose ragged tail is padded, so that rank
    1's last slice is all pad) equal the JAX ``grain_batches`` of that host
    with the global sample count, bit for bit."""
    pds = psyn.synthetic_dataset(num_graphs=40, seed=0, **SYN)
    jds = jsyn.synthetic_dataset(num_graphs=40, seed=0, **SYN)
    kw = dict(epoch=1, shuffle=split == "train", batch_size=8, shard_multiple=2, image_shape=SYN["image_shape"])
    if split == "test":
        kw.update(drop_last=False, pad_tail_to_batch=True)
    for rank in (0, 1):
        idx_p, idx_j = getattr(pds, f"{split}_idx"), getattr(jds, f"{split}_idx")
        got = list(iterate_batches(pds, idx_p, data_cfg(pconfig), pconfig.TaskConfig(seed=0), host_index=rank,
                                   host_count=2, **kw))
        want = list(grain_batches(jds, idx_j, data_cfg(jconfig), jconfig.TaskConfig(seed=0), host_index=rank,
                                  host_count=2, global_nsamples=True, **kw))
        assert len(got) == len(want) > 0
        for a, b in zip(got, want):
            assert_batches_equal(a, b)


@pytest.fixture
def fake_group():
    """A fake 8-rank default group (this process is rank 3), torn down after."""
    assert not dist.is_initialized()
    dist.init_process_group("fake", store=FakeStore(), rank=3, world_size=8)
    yield
    dist.destroy_process_group()


@pytest.mark.parametrize(
    "kw, shape, coords",
    [
        (dict(), {"dp": 8, "tp": 1}, {"dp": 3, "tp": 0}),
        (dict(tp_size=2), {"dp": 4, "tp": 2}, {"dp": 1, "tp": 1}),
        (dict(dp_size=2, tp_size=4), {"dp": 2, "tp": 4}, {"dp": 0, "tp": 3}),
        (dict(num_slices=2), {"dcn": 2, "dp": 4, "tp": 1}, {"dcn": 0, "dp": 3, "tp": 0}),
        (dict(num_slices=2, tp_size=2), {"dcn": 2, "dp": 2, "tp": 2}, {"dcn": 0, "dp": 1, "tp": 1}),
    ],
)
def test_mesh_geometry_on_a_fake_group(fake_group, kw, shape, coords):
    """``make_mesh`` on 8 ranks: JAX's axes and sizes, row-major ranks, the
    data group (every rank of this tp index across dcn and dp), FSDP's
    (dcn, dp) mesh for HSDP."""
    mesh = pmesh.make_mesh(**kw)
    assert mesh.shape == shape and mesh.coords == coords
    jax_shape = dict(jmesh.make_mesh(devices=jax.devices()[:8], **kw).shape)
    assert jax_shape == shape
    assert pmesh.data_parallel_size(mesh) == mesh.data_size == shape.get("dcn", 1) * shape["dp"]
    assert pmesh.data_axes(mesh) == (("dcn", "dp") if "dcn" in shape else ("dp",))
    assert dist.get_world_size(mesh.data_group) == mesh.data_size
    assert dist.get_world_size(mesh.tp_group) == shape["tp"]
    assert mesh.fsdp_mesh.ndim == (2 if "dcn" in shape else 1)
    assert mesh.data_rank == coords.get("dcn", 0) * shape["dp"] + coords["dp"]


@pytest.mark.parametrize("kw", [dict(dp_size=3), dict(tp_size=3), dict(num_slices=3), dict(dp_size=2, tp_size=2)])
def test_mesh_size_errors(fake_group, kw):
    with pytest.raises(ValueError):
        pmesh.make_mesh(**kw)


def test_sequence_parallel_mesh_is_not_ported(fake_group):
    """The sp axis is ported: on 8 ranks ``make_mesh(tp_size=2,
    sp_size=2)`` is JAX's (dp 2, tp 2, sp 2) with sp innermost, its sp,
    data (dp x sp at one tp index) and batch (dp at one tp and sp index)
    groups of the right sizes; a layout JAX refuses raises ValueError."""
    mesh = pmesh.make_mesh(tp_size=2, sp_size=2)
    jm = jmesh.make_mesh(tp_size=2, sp_size=2, devices=jax.devices()[:8])
    assert mesh.shape == dict(jm.shape) == {"dp": 2, "tp": 2, "sp": 2}
    rank = dist.get_rank()
    assert mesh.coords == {"dp": rank // 4, "tp": rank // 2 % 2, "sp": rank % 2}
    assert dist.get_world_size(mesh.sp_group) == 2 and dist.get_world_size(mesh.data_group) == 4
    assert dist.get_world_size(mesh.batch_group) == 2 and mesh.stream_rank == mesh.data_rank * 2 + mesh.sp_rank
    with pytest.raises(ValueError):
        pmesh.make_mesh(tp_size=2, sp_size=3)


def _jax_tp_dims(model, scan: bool):
    """{port state-dict key: torch dim} that JAX ``param_sharding`` shards
    over tp on a (dp=4, tp=2) mesh, read off the Flax tree of ``model``."""
    tree = to_flax_params(model)
    shardings = jmesh.param_sharding(jmesh.make_mesh(tp_size=2, devices=jax.devices()[:8]), tree)
    out = {}
    for path, s in jax.tree_util.tree_flatten_with_path(shardings)[0]:
        spec = tuple(s.spec)
        if "tp" not in spec:
            continue
        parts = [str(getattr(p, "key", p)) for p in path][1:]  # drop "params"
        leaf = {"kernel": "weight", "scale": "weight", "embedding": "weight"}.get(parts[-1], parts[-1])
        d = spec.index("tp")
        node = tree["params"]
        for p in parts:
            node = node[p]
        ndim = node.ndim
        if parts[-1] == "kernel":  # Flax (..., in, out) -> torch (..., out, in)
            d = ndim - 1 if d == ndim - 2 else ndim - 2
        out[".".join(parts[:-1] + [leaf])] = d
    assert out, "JAX shards something"
    return out


@pytest.mark.parametrize("scan", [False, True], ids=["unrolled", "scan_layers"])
def test_tp_shards_what_jax_shards(scan):
    """The port's ``tp_shard_dim`` over its state dict (unrolled, or in the
    scan layout with the stack axis replicated) equals JAX ``param_sharding``
    over the Flax tree: the same parameters, on the same dim."""
    cfg = pconfig.tiny_model_config(scan_layers=scan)
    model = MDTModel(cfg, generator=torch.Generator().manual_seed(0))
    sd = model.state_dict()
    if scan:
        sd = scanned_state_dict(sd, cfg)
    port = {k: d for k, v in sd.items() if (d := pmesh.tp_shard_dim(k, tuple(v.shape), 2)) is not None}
    assert port == _jax_tp_dims(model, scan)
    assert any(".scan_layers." in k for k in port) == scan


def test_apply_tensor_parallel_shards_the_planned_dims(fake_group):
    """On a (dp=4, tp=2) mesh the model keeps this rank's half of exactly the
    tensors ``tp_shard_dim`` names, on that dim (FSDP then shards over dp)."""
    cfg = pconfig.tiny_model_config()
    full = MDTModel(cfg, generator=torch.Generator().manual_seed(0))
    model = MDTModel(cfg, generator=torch.Generator().manual_seed(0))
    mesh = pmesh.make_mesh(tp_size=2)
    plan = pmesh.apply_tensor_parallel(model, mesh)
    want = {k: d for k, v in full.state_dict().items() if (d := pmesh.tp_shard_dim(k, tuple(v.shape), 2)) is not None}
    assert plan == want
    for k, v in model.state_dict().items():
        ref = full.state_dict()[k]
        if k in plan:
            torch.testing.assert_close(v, ref.chunk(2, plan[k])[mesh.tp_rank], rtol=0, atol=0)
        else:
            assert torch.equal(v, ref), k
    assert model.graph_encoder.graph_attn_bias.tp is not None
