"""The mesh of a run across ranks and the model's layout on it: the port's
counterpart of the JAX package's ``parallel/mesh.py``.

``make_mesh`` lays the ranks out as a ``([dcn,] dp, tp[, sp])`` device mesh
(``torch.distributed.device_mesh.init_device_mesh``), with JAX's size rules
(``dp_size=-1`` takes the ranks left over; ``num_slices > 1`` adds the
outermost ``dcn`` axis, dp then counts per slice; ``sp_size > 1`` adds the
innermost ``sp`` axis). The batch shards over the data axes ``([dcn,] dp)``
(``data_axes``, ``data_parallel_size``).

Sequence parallelism (``sp``): the ranks of an sp group hold one data
rank's batch, each its strip of the graph grid's node axis and its share of
the flat node, image and label capacity (``parallel/input.py::sp_share``);
the graph attention runs as a ring over the group (``ops/ring_attention.py``,
``apply_sequence_parallel``). Parameters are replicated over sp, so the
gradients, the sample size and the logging outputs are summed over the
data axes and sp together (``data_group``: every rank of this rank's tp
index), with one division by the global sample size. ``batch_group`` (the
data axes alone, at this rank's tp and sp index) is the group that gathers
per-graph rows (the contrastive embeddings). With fsdp, sp is a replicate
dimension beside the dp shard dimension (HSDP's form). Under tp x sp the
ring takes the rank's H/tp heads as it is.

The layout reads JAX's ``param_sharding`` rules as they stand:
- **tp** (``_TP_RULES``, over the port's parameter names, which are
  Flax's): column-parallel query/key/value/q_proj/k_proj/v_proj/
  intermediate_dense/fc1 (output features sharded), row-parallel
  attention_output_dense/out_proj/output_dense/fc2 (input features
  sharded, bias replicated, outputs summed over tp). A projection pair
  whose heads (or FFN width) do not divide by tp stays replicated, as JAX
  leaves a dim that does not divide. Each rank runs its H/tp heads: the
  attention modules slice the per-head bias (the tree LUT, the dense bias,
  ``graph_token_virtual_distance``) through ``copy_to_group``, so that the
  replicated bias parameters get the gradient of every head. The stack axis
  of the scan layout stays replicated (``tp_shard_dim``).
- **fsdp**: FSDP2 ``fully_shard`` of every transformer layer and of the root
  over dp; on a mesh with ``dcn`` the shards replicate across slices (HSDP,
  a 2-D mesh), as JAX's docstring says its params never shard over dcn.
  Gradients are summed, not averaged (``set_gradient_divide_factor(1)``):
  the trainer divides by the global sample size.
- **dp without fsdp**: the trainer sums the accumulated gradients over the
  data axes with one bucketed ``all_reduce`` per update
  (``Layout.all_reduce_grads``).

On NCCL, ``make_mesh`` starts the communicator of every group the mesh
holds (its dims, the data and batch groups, an sp run's FSDP mesh) with one
all-reduce each before it returns (``distributed.start_communicators``), so
that none starts inside FSDP2's first all-gather on FSDP2's own streams.

``Layout`` turns tensors between the rank-local layout and the full
tensors the port's checkpoints hold (``full`` / ``local``), and computes
the global gradient norm over shards.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence

import torch
import torch.distributed as dist
from torch import nn

from multimodaldiscussiontransformer_tpu_torch.parallel.comm import all_reduce_, gather_dim
from multimodaldiscussiontransformer_tpu_torch.parallel.distributed import start_communicators

DP_AXIS = "dp"
TP_AXIS = "tp"
SP_AXIS = "sp"
DCN_AXIS = "dcn"

# all-reduce buckets of the dp gradient sum, in elements (64 MB of f32)
GRAD_BUCKET = 16 * 1024 * 1024


@dataclass(frozen=True)
class SPInfo:
    """A module's sequence-parallel group: this rank's strip ``rank`` of
    ``size``, and ``shard``, its data-parallel shard (folded into the ring's
    dropout seeds)."""

    group: object
    rank: int
    size: int
    shard: int = 0


@dataclass(frozen=True)
class TPInfo:
    """A module's tensor-parallel group: this rank's index among ``size``."""

    group: object
    rank: int
    size: int

    def span(self, n: int) -> slice:
        """This rank's block of ``n`` heads (or features)."""
        per = n // self.size
        return slice(self.rank * per, (self.rank + 1) * per)


@dataclass
class Mesh:
    """The ranks laid out on named axes: ``shape`` (axis -> size, outermost
    first), this rank's ``coords``, the torch ``DeviceMesh``, the groups the
    trainer reduces over (``data_group``: every rank of this rank's tp
    index, across dcn, dp and sp; ``tp_group``), the mesh FSDP shards over
    (with sp: a function that builds it, on every rank), the ``sp_group``
    (None without sp) and ``batch_group`` (the data axes at this rank's tp
    and sp index: ``data_group`` without sp)."""

    shape: Dict[str, int]
    coords: Dict[str, int]
    device_mesh: object
    data_group: object
    tp_group: object
    fsdp_mesh: object
    sp_group: object = None
    batch_group: object = None

    @property
    def data_rank(self) -> int:
        return self.coords.get(DCN_AXIS, 0) * self.shape[DP_AXIS] + self.coords[DP_AXIS]

    @property
    def data_size(self) -> int:
        return data_parallel_size(self)

    @property
    def tp_rank(self) -> int:
        return self.coords[TP_AXIS]

    @property
    def tp_size(self) -> int:
        return self.shape[TP_AXIS]

    @property
    def sp_rank(self) -> int:
        return self.coords.get(SP_AXIS, 0)

    @property
    def sp_size(self) -> int:
        return self.shape.get(SP_AXIS, 1)

    @property
    def stream_rank(self) -> int:
        """The index of this rank's dropout streams: (data rank, sp rank)
        in row-major order (the data rank without sp)."""
        return self.data_rank * self.sp_size + self.sp_rank

    @property
    def stream_size(self) -> int:
        return self.data_size * self.sp_size


def make_mesh(dp_size: int = -1, tp_size: int = 1, sp_size: int = 1, num_slices: int = 1,
              device_type: str = "cpu") -> Mesh:
    """A ``([dcn,] dp, tp[, sp])`` mesh over the ranks of the default
    process group (one rank, unstarted, when there is none), ranks in
    row-major order, sp innermost (JAX ``make_mesh``). ``dp_size=-1`` uses
    the ranks left over (per slice when ``num_slices > 1``). The mesh must
    use every rank."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if num_slices > 1 and world % num_slices:
        raise ValueError(f"{world} devices not divisible by num_slices={num_slices}")
    per_slice = world // max(num_slices, 1)
    if dp_size == -1:
        if per_slice % (tp_size * sp_size):
            raise ValueError(f"{per_slice} devices not divisible by tp={tp_size} x sp={sp_size}")
        dp_size = per_slice // (tp_size * sp_size)
    need = dp_size * tp_size * sp_size
    if need > per_slice:
        raise ValueError(f"mesh {dp_size}x{tp_size}x{sp_size} needs {need} devices, have {per_slice}")
    if need * max(num_slices, 1) != world:
        raise ValueError(
            f"mesh {'%dx' % num_slices if num_slices > 1 else ''}{dp_size}x{tp_size}x{sp_size} uses "
            f"{need * max(num_slices, 1)} ranks; the process group has {world}"
        )
    shape = {DCN_AXIS: num_slices} if num_slices > 1 else {}
    shape.update({DP_AXIS: dp_size, TP_AXIS: tp_size})
    if sp_size > 1:
        shape[SP_AXIS] = sp_size
    rank = dist.get_rank() if dist.is_initialized() else 0
    coords, rest = {}, rank
    for axis in reversed(list(shape)):
        coords[axis] = rest % shape[axis]
        rest //= shape[axis]
    coords = {axis: coords[axis] for axis in shape}
    if not dist.is_initialized():
        return Mesh(shape, coords, None, None, None, None)
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

    device = torch.device(device_type, torch.cuda.current_device()) if device_type == "cuda" else torch.device(device_type)
    dm = init_device_mesh(device_type, tuple(shape.values()), mesh_dim_names=tuple(shape))
    dim_groups = [dm.get_group(axis) for axis in shape]
    if sp_size == 1:
        # the joint data group: every rank with this rank's tp index
        groups = [[r for r in range(world) if r % tp_size == t] for t in range(tp_size)]
        data_group = dm.get_group(DP_AXIS) if num_slices <= 1 else dist.new_subgroups_by_enumeration(groups)[0]
        # the FSDP mesh's groups are dims of dm (a slice keeps its parent's)
        fsdp_mesh = dm[(DCN_AXIS, DP_AXIS)] if num_slices > 1 else dm[DP_AXIS]
        start_communicators(device, dim_groups + [data_group])
        return Mesh(shape, coords, dm, data_group, dm.get_group(TP_AXIS), fsdp_mesh, None, data_group)
    grid = torch.arange(world).view(tuple(shape.values()))
    dims = list(shape)
    tp_last = grid.movedim(dims.index(TP_AXIS), -1)  # (..., tp)
    # every rank of one tp index, in rank order (dcn, dp, sp): gradients and logs
    data_group = dist.new_subgroups_by_enumeration(
        [tp_last[..., t].flatten().tolist() for t in range(tp_size)])[0]
    # every rank of one (tp, sp) index, in rank order (dcn, dp): per-graph rows
    by_tp_sp = grid.movedim((dims.index(TP_AXIS), dims.index(SP_AXIS)), (-2, -1))
    batch_group = dist.new_subgroups_by_enumeration(
        [by_tp_sp[..., t, r].flatten().tolist() for t in range(tp_size) for r in range(sp_size)])[0]
    # FSDP's (replicate, shard) mesh: (dcn x sp) replicate, dp shards, one
    # per tp index; built when apply_fsdp asks for it (on every rank)
    fsdp_grid = grid.permute(*[dims.index(a) for a in (TP_AXIS,) + ((DCN_AXIS,) if num_slices > 1 else ())
                               + (SP_AXIS, DP_AXIS)]).reshape(tp_size, -1, dp_size)

    def fsdp_mesh():
        meshes = [DeviceMesh(device_type, fsdp_grid[t], mesh_dim_names=("replicate", "shard")) for t in range(tp_size)]
        mine = meshes[coords[TP_AXIS]]
        start_communicators(device, [mine.get_group("replicate"), mine.get_group("shard")])
        return mine

    start_communicators(device, dim_groups + [data_group, batch_group])
    return Mesh(shape, coords, dm, data_group, dm.get_group(TP_AXIS), fsdp_mesh, dm.get_group(SP_AXIS), batch_group)


def data_axes(mesh: Mesh) -> tuple:
    """The mesh axes the batch shards over: ``(dcn, dp)`` or ``(dp,)``."""
    return (DCN_AXIS, DP_AXIS) if DCN_AXIS in mesh.shape else (DP_AXIS,)


def data_parallel_size(mesh: Mesh) -> int:
    """The data-parallel degree (the product over ``data_axes``)."""
    return mesh.shape.get(DCN_AXIS, 1) * mesh.shape[DP_AXIS]


# ---------------------------------------------------------------------------
# tp rules over parameter paths ("/"-joined, Flax leaf names): JAX's
# (pattern, spec by leaf) with the axis each spec shards, in Flax's (in, out)
# kernel layout
# ---------------------------------------------------------------------------

_COLUMN = ("query", "key", "value", "q_proj", "k_proj", "v_proj", "intermediate_dense", "fc1")
_ROW = ("attention_output_dense", "out_proj", "output_dense", "fc2")
_TP_RULES = (
    (re.compile(r"(%s)/(kernel|bias)$" % "|".join(_COLUMN)), {"kernel": (None, TP_AXIS), "bias": (TP_AXIS,)}),
    (re.compile(r"(%s)/kernel$" % "|".join(_ROW)), {"kernel": (TP_AXIS, None), "bias": ()}),
)


def _spec_for_path(path: str, ndim: Optional[int] = None) -> tuple:
    """JAX's ``_spec_for_path``: the partition of a Flax param path (a
    leading stack axis of the scan layout stays replicated)."""
    leaf = path.rsplit("/", 1)[-1]
    for pat, by_leaf in _TP_RULES:
        if pat.search(path):
            s = by_leaf.get(leaf, ())
            if ndim is not None and len(s) > 0 and ndim == len(s) + 1:
                s = (None,) + tuple(s)
            return tuple(s)
    return ()


def tp_shard_dim(name: str, shape: Sequence[int], tp: int) -> Optional[int]:
    """The dim of a port state-dict tensor (``weight`` (out, in), ``bias``;
    unrolled or in the scan layout) that tp shards, or None: the rule of
    ``_spec_for_path`` with a Dense ``weight`` read as Flax's transposed
    ``kernel``; None where the dim does not divide by ``tp``."""
    module, _, leaf = name.rpartition(".")
    flax_leaf = {"weight": "kernel", "bias": "bias"}.get(leaf)
    if flax_leaf is None or tp <= 1:
        return None
    spec = _spec_for_path(module.replace(".", "/") + "/" + flax_leaf, len(shape))
    if TP_AXIS not in spec:
        return None
    d = spec.index(TP_AXIS)
    if flax_leaf == "kernel":  # Flax (..., in, out) is torch (..., out, in)
        d = len(shape) - 1 if d == len(shape) - 2 else len(shape) - 2
    return d if shape[d] % tp == 0 else None


def _shard_dense(dense: nn.Module, mode: str, info: TPInfo) -> None:
    """Keep this rank's block of a Dense: rows of a column-parallel weight
    and its bias, columns of a row-parallel weight (its bias stays whole)."""
    dim = 0 if mode == "col" else 1
    w = dense.weight
    dense.weight = nn.Parameter(w.detach().chunk(info.size, dim)[info.rank].clone(), requires_grad=w.requires_grad)
    if mode == "col" and dense.bias is not None:
        b = dense.bias
        dense.bias = nn.Parameter(b.detach().chunk(info.size, 0)[info.rank].clone(), requires_grad=b.requires_grad)
    dense.tp_mode, dense.tp = mode, info


def apply_tensor_parallel(model: nn.Module, mesh: Mesh) -> Dict[str, int]:
    """Shard ``model``'s projections over ``mesh``'s tp axis in place (before
    any optimizer exists); the state-dict names it sharded -> the dim."""
    from multimodaldiscussiontransformer_tpu_torch.models.bert import BertLayer
    from multimodaldiscussiontransformer_tpu_torch.models.graphormer import GraphAttnBias, GraphormerGraphEncoderLayer
    from multimodaldiscussiontransformer_tpu_torch.models.vit import ViTLayer

    if mesh.tp_size <= 1:
        return {}
    info = TPInfo(mesh.tp_group, mesh.tp_rank, mesh.tp_size)
    tp = info.size
    for mod in model.modules():
        if isinstance(mod, (BertLayer, ViTLayer)):
            attn = mod.attention
            if attn.num_heads % tp == 0:
                for d in (attn.query, attn.key, attn.value):
                    _shard_dense(d, "col", info)
                _shard_dense(mod.attention_output_dense, "row", info)
                attn.tp = info
                attn.attn_dropout.shard = (1, info)
            if mod.intermediate_dense.out_features % tp == 0:
                _shard_dense(mod.intermediate_dense, "col", info)
                _shard_dense(mod.output_dense, "row", info)
                mod.tp_ffn = info
        elif isinstance(mod, GraphormerGraphEncoderLayer):
            attn = mod.self_attn
            if attn.config.encoder_attention_heads % tp == 0:
                for d in (attn.q_proj, attn.k_proj, attn.v_proj):
                    _shard_dense(d, "col", info)
                _shard_dense(attn.out_proj, "row", info)
                attn.tp = info
                attn.dropout.shard = (1, info)
            if mod.fc1.out_features % tp == 0:
                _shard_dense(mod.fc1, "col", info)
                _shard_dense(mod.fc2, "row", info)
                mod.tp_ffn = info
                mod.activation_dropout.shard = (-1, info)
        elif isinstance(mod, GraphAttnBias) and mod.config.encoder_attention_heads % tp == 0:
            mod.tp = info
    plan = {}
    for name, p in model.named_parameters():
        module = model.get_submodule(name.rpartition(".")[0])
        if getattr(module, "tp", None) is not None and getattr(module, "tp_mode", None) is not None:
            if module.tp_mode == "col" or name.endswith(".weight"):
                plan[name] = 0 if module.tp_mode == "col" else 1
    return plan


def apply_sequence_parallel(model: nn.Module, mesh: Mesh) -> None:
    """Lay ``model`` out on ``mesh``'s sp axis in place: the encoder holds
    strips of the graph grid and every graph attention runs as a ring over
    the sp group. The model must be built with ``sequence_parallel`` and the
    compact bias (``use_pallas_attention``): the ring takes the compact bias
    only, as JAX's does."""
    from multimodaldiscussiontransformer_tpu_torch.models.graphormer import BiasedMultiheadAttention
    from multimodaldiscussiontransformer_tpu_torch.models.mdt import MultiGraphormerGraphEncoder

    if mesh.sp_size <= 1:
        return
    cfg = model.config
    if not (cfg.sequence_parallel and cfg.use_pallas_attention):
        raise ValueError("an sp axis needs a model with sequence_parallel=True and use_pallas_attention=True "
                         "(the ring runs on the compact bias); the launcher's --sp-size sets the first")
    info = SPInfo(mesh.sp_group, mesh.sp_rank, mesh.sp_size, mesh.data_rank)
    for mod in model.modules():
        if isinstance(mod, (MultiGraphormerGraphEncoder, BiasedMultiheadAttention)):
            mod.sp = info


def apply_fsdp(model: nn.Module, mesh: Mesh) -> nn.Module:
    """FSDP2 ``fully_shard`` of each transformer layer and of the root over
    ``mesh.fsdp_mesh`` (dp; (dcn, dp) or (dcn x sp, dp): HSDP), gradients
    summed."""
    from torch.distributed.fsdp import FSDPModule, fully_shard

    from multimodaldiscussiontransformer_tpu_torch.models.bert import BertLayer
    from multimodaldiscussiontransformer_tpu_torch.models.graphormer import GraphormerGraphEncoderLayer
    from multimodaldiscussiontransformer_tpu_torch.models.vit import ViTLayer

    layers = [m for m in model.modules() if isinstance(m, (BertLayer, ViTLayer, GraphormerGraphEncoderLayer))]
    if callable(mesh.fsdp_mesh):  # built on first use (an sp mesh's)
        mesh.fsdp_mesh = mesh.fsdp_mesh()
    for layer in layers:
        fully_shard(layer, mesh=mesh.fsdp_mesh)
    fully_shard(model, mesh=mesh.fsdp_mesh)
    for m in model.modules():
        if isinstance(m, FSDPModule):
            m.set_gradient_divide_factor(1.0)
            # plain SUM collectives (gloo has no PREMUL_SUM)
            m.set_force_sum_reduction_for_comms(True)
    return model


def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


@dataclass
class Layout:
    """A model's layout on a mesh: the tp plan (state-dict name -> dim) and
    whether FSDP shards the params (they are then ``DTensor``s)."""

    mesh: Mesh
    tp_plan: Dict[str, int] = field(default_factory=dict)
    fsdp: bool = False

    # -- full tensors <-> this rank's --------------------------------------

    def full(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """The whole tensor of parameter ``name`` (or of a tensor laid out as
        it: a moment, a gradient); collective over the ranks that share it."""
        if _is_dtensor(t):
            t = t.full_tensor()
        if name in self.tp_plan:
            t = gather_dim(t.detach().contiguous(), self.tp_plan[name], self.mesh.tp_group)
        return t.detach()

    def local(self, name: str, full: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        """This rank's part of ``full`` laid out as ``like`` (parameter
        ``name``'s tensor on this rank), on its device and in its dtype."""
        t = full
        if name in self.tp_plan:
            t = t.chunk(self.mesh.tp_size, self.tp_plan[name])[self.mesh.tp_rank]
        t = t.to(device=like.device, dtype=like.dtype)
        if _is_dtensor(like):
            from torch.distributed.tensor import distribute_tensor

            t = distribute_tensor(t.contiguous(), like.device_mesh, like.placements, src_data_rank=None)
        return t

    def full_state_dict(self, model: nn.Module) -> Dict[str, torch.Tensor]:
        return {n: self.full(n, t) for n, t in model.state_dict().items()}

    def load_full_state_dict(self, model: nn.Module, full: Dict[str, torch.Tensor]) -> None:
        """Copy whole tensors into the model's local parts (strict names)."""
        own = model.state_dict()
        if set(own) != set(full):
            raise ValueError(f"state dict does not fit: missing {sorted(set(own) - set(full))[:5]}, "
                             f"unexpected {sorted(set(full) - set(own))[:5]}")
        with torch.no_grad():
            for n, t in own.items():
                src = self.local(n, full[n], t)
                (t.to_local() if _is_dtensor(t) else t).copy_(src.to_local() if _is_dtensor(src) else src)

    # -- gradients -----------------------------------------------------------

    def _groups(self, name: str, t: torch.Tensor) -> tuple:
        """The groups over which ``t``'s local part is one block of many."""
        groups = []
        if _is_dtensor(t):
            groups += [t.device_mesh.get_group(i) for i, p in enumerate(t.placements) if p.is_shard()]
        if name in self.tp_plan:
            groups.append(self.mesh.tp_group)
        return tuple(groups)

    def grad_norm(self, params: Sequence[torch.Tensor], names: Sequence[str]) -> torch.Tensor:
        """The global L2 norm (f32) of the gradients of ``params``: each
        local square sum counted once over the ranks that hold blocks of it."""
        parts: Dict[tuple, torch.Tensor] = {}
        for p, n in zip(params, names):
            if p.grad is None:
                continue
            g = p.grad.to_local() if _is_dtensor(p.grad) else p.grad
            key = self._groups(n, p)
            sq = g.float().square().sum()
            parts[key] = parts[key] + sq if key in parts else sq
        total = None
        for groups, sq in parts.items():
            for g in groups:
                all_reduce_(sq, g)
            total = sq if total is None else total + sq
        return total.sqrt() if total is not None else torch.zeros(())

    def all_reduce_grads(self, params: Iterable[torch.Tensor]) -> None:
        """Sum the gradients over the data axes and sp (without fsdp): flat
        buckets of ``GRAD_BUCKET`` elements per dtype, one all_reduce each."""
        grads = [p.grad for p in params if p.grad is not None]
        by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
        for g in grads:
            by_dtype.setdefault(g.dtype, []).append(g)
        for gs in by_dtype.values():
            start = 0
            while start < len(gs):
                end, size = start, 0
                while end < len(gs) and (end == start or size + gs[end].numel() <= GRAD_BUCKET):
                    size += gs[end].numel()
                    end += 1
                bucket, start = gs[start:end], end
                flat = all_reduce_(torch.cat([b.reshape(-1) for b in bucket]), self.mesh.data_group)
                torch._foreach_copy_(bucket, [x.view_as(b) for x, b in zip(flat.split([b.numel() for b in bucket]), bucket)])
