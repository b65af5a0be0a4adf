"""The training loop: the port's copy of the JAX package's
``train/trainer.py`` on one device, for the node task and the contrastive
task (the criterion the task names).

By default (``scan_microbatches``) one update takes the ``update_freq``
microbatches of a group (stacked on a leading k axis by
``data/loader.py::stack_microbatches``) with the JAX package's scan-step
semantics (FairSeq's update-freq math):
- each microbatch's forward runs with dropout (``deterministic=False``) and
  its SUMMED, unnormalized loss is back-propagated into the accumulated
  ``.grad`` of the trainable parameters;
- the accumulated gradients are divided once by max(total sample size, 1);
- one AdamW update follows, with the lr the schedule gives this update;
- ``gnorm`` is the norm of the normalized trainable gradients.
Frozen towers get no gradient and no update. Trainable parameters that got
no gradient in an update (e.g. the ViT halves of the fusion layers when no
microbatch holds an image, or the heads under the contrastive loss) get a
zero gradient, so that AdamW still decays them and advances their moments,
as optax does for every trainable leaf.

With ``update_freq > 1`` and ``scan_microbatches`` off, the loop steps one
microbatch at a time with optax ``MultiSteps`` semantics
(``train_microstep``): each microbatch's gradient is divided by its own
sample size and folded into a running mean (``acc + (g - acc) / (n + 1)``);
every k-th microbatch, clipping and AdamW act on that mean and the mean
restarts at zero. No pad microbatch completes a short epoch: the partial
mean carries into the next epoch, and a checkpoint taken mid-way holds it.

Across ranks (a started process group, ``parallel/distributed.py``; one
process per device) the trainer lays the model out on a
``parallel/mesh.py`` mesh of ``cfg.dp_size/tp_size/num_slices`` and gives
the update JAX computes over the global batch of ``batch_size`` x dp:
- each data-parallel rank collates its slice of every global batch
  (``parallel/input.py``); tp ranks of one slice collate the same slice;
- each microbatch's summed loss is back-propagated locally; the gradients
  are summed over the data axes (one bucketed all-reduce per update, or
  FSDP2's reduce-scatter on the last microbatch under ``fsdp``) and divided
  by the global sample size, which is all-reduced with the logging outputs;
- under MultiSteps each microbatch's global sample size is all-reduced
  before its backward and its gradient is summed at once, so that the
  running mean and the logged ``gnorm`` are the global ones;
- ``gnorm`` and clipping use the global norm over shards
  (``Layout.grad_norm``);
- the contrastive loss is the (B, B) matrix over the GLOBAL batch: each
  rank's rows against every rank's embeddings (a differentiable gather);
- ``evaluate`` sums the logging outputs over the data axes, ``predict``
  gathers the rows in the global batch order, and ``fit`` logs, writes
  metrics and traces on rank 0 only and agrees on a stop request (one MAX
  all-reduce per update), so that every rank saves at the same update;
- dropout masks differ across data-parallel ranks (the generators are
  seeded from (seed, data rank)).
Under sequence parallelism (``cfg.sp_size > 1``, a model with
``sequence_parallel``) the ranks of an sp group take one data rank's batch:
each stages its share (``parallel/input.py::sp_share``: its strip of the
graph grid, its block of the node slots, the images and labels of its
nodes; ``local``), the model runs the graph attention as a ring over the
group (``parallel/mesh.py::apply_sequence_parallel``), the gradients and
the logging outputs are summed over the data axes and sp, and the
contrastive rows count on sp rank 0 only. Dropout generators are seeded
from (seed, data rank, sp rank) (``Mesh.stream_rank``), the prediction rows
are gathered over the data axes and sp (the one-device order), and params
being replicated over sp, checkpoints hold them once.
Without a process group there is no mesh: one process drives one device.

``fit``, ``evaluate`` and ``predict`` take their batches through
``data/loader.py::ThreadedPrefetcher``: a background thread collates (or, with ``data.num_workers > 0``, takes from
worker processes, ``data/worker_loader.py``), stacks and stages the next
groups on the device while the current update runs. ``fit`` saves through a
``utils/checkpoints.py::Checkpointer`` (asynchronous saves; it waits for
the last one before it returns), resumes mid-epoch from a restored state
(``resume_position``) and, with ``profile_trace_dir``, traces
``profile_trace_steps`` updates after the first ``profile_trace_start``
(``utils/profiling.py``), where each microbatch's forward and backward,
each optimizer step and each checkpoint save is a named range
(``microbatch``, ``optimizer``, ``checkpoint_save``).
"""

from __future__ import annotations

import csv
import itertools
import os
import sys
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from multimodaldiscussiontransformer_tpu_torch.core.config import TrainConfig
from multimodaldiscussiontransformer_tpu_torch.data.collator import to_tensors
from multimodaldiscussiontransformer_tpu_torch.data.dataset import DiscussionDataset, iterate_batches
from multimodaldiscussiontransformer_tpu_torch.data.loader import ThreadedPrefetcher, Staged, stack_microbatches, stage
from multimodaldiscussiontransformer_tpu_torch.data.worker_loader import worker_batches
from multimodaldiscussiontransformer_tpu_torch.models.fast_dropout import dropout_rngs, fold_seed
from multimodaldiscussiontransformer_tpu_torch.models.mdt import MDTModel
from multimodaldiscussiontransformer_tpu_torch.parallel.comm import all_reduce_, any_rank
from multimodaldiscussiontransformer_tpu_torch.parallel.input import sp_share
from multimodaldiscussiontransformer_tpu_torch.parallel.mesh import (
    Layout,
    apply_fsdp,
    apply_sequence_parallel,
    apply_tensor_parallel,
    make_mesh,
)
from multimodaldiscussiontransformer_tpu_torch.serve.incremental import resolve_device
from multimodaldiscussiontransformer_tpu_torch.tasks.task import build_criterion
from multimodaldiscussiontransformer_tpu_torch.train.metrics import MetricAccumulator, MetricsWriter
from multimodaldiscussiontransformer_tpu_torch.train.optimizer import (
    apply_freeze,
    clip_by_global_norm_,
    make_optimizer,
    polynomial_decay_schedule,
    trainable_gnorm,
)
from multimodaldiscussiontransformer_tpu_torch.utils import profiling
from multimodaldiscussiontransformer_tpu_torch.utils.scan_params import unrolled_state_dict


@dataclass
class TrainState:
    """What a run carries between updates."""

    model: MDTModel
    optimizer: torch.optim.Optimizer
    trainable: List[torch.nn.Parameter]
    host_rng: torch.Generator  # CPU: one attention-dropout seed per call site
    device_rng: torch.Generator  # on the device: FastDropout masks
    step: int = 0  # microbatches consumed (pads included)
    num_updates: int = 0
    epoch: int = 0  # completed epochs
    # MultiSteps only: the running mean of this update's microbatch
    # gradients (one per trainable parameter) and how many it holds
    acc_grads: Optional[List[torch.Tensor]] = None
    mini_step: int = 0
    # across ranks: the model's layout on the mesh (None on one device)
    layout: Optional[Layout] = None


def resume_position(step: int, epoch: int, micro_per_epoch: int, k: int) -> Tuple[int, int]:
    """(first epoch to run, accumulation groups of it to skip) for a state
    that has consumed ``step`` microbatches and completed ``epoch`` epochs
    of ``micro_per_epoch`` microbatches each (0: unknown, no skipping).

    The JAX trainer's mid-epoch resume (``train/trainer.py:700-720``): the
    per-epoch order is deterministic, so skipping what the epoch already
    consumed replays nothing. One difference: a state saved after the last
    group of an epoch, before the epoch was counted (``max_updates`` or a
    stop request there), starts at the next epoch here; the JAX trainer
    runs that epoch again."""
    start = epoch + 1
    done = step - epoch * micro_per_epoch
    if micro_per_epoch <= 0 or done <= 0:
        return start, 0
    return start + done // micro_per_epoch, (done % micro_per_epoch) // k


def check_supported(cfg: TrainConfig) -> None:
    """Raise ``ValueError`` for an sp axis without a sequence-parallel model
    on the compact bias (the ring runs on it, as JAX's does)."""
    if cfg.sp_size > 1 and not (cfg.model.sequence_parallel and cfg.model.use_pallas_attention):
        raise ValueError("sp_size > 1 needs a model with sequence_parallel=True and use_pallas_attention=True "
                         "(the launcher's --sp-size sets the first)")


def _null_log(message: str) -> None:
    pass


class _NullWriter:
    """The metric sink of every rank but rank 0."""

    def write(self, split: str, step: int, metrics: Dict[str, float]) -> None:
        pass

    def close(self) -> None:
        pass


class Trainer:
    """The training loop on one device (``"cuda"`` unless the caller passes
    another), or on this rank's device of the mesh the config lays out
    when a process group is started, for the task ``cfg.task`` names.

    ``TrainConfig.fast_dropout_rng`` picks a JAX PRNG implementation and has
    no meaning here: the port's dropout bits come from ``torch.Generator``s
    and the kernels' Philox."""

    def __init__(
        self,
        cfg: TrainConfig,
        model: Optional[MDTModel] = None,
        criterion: Optional[Callable] = None,
        image_shape=(3, 224, 224),
        device=None,
    ):
        check_supported(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        mesh = None
        if (dist.is_initialized() or cfg.dp_size not in (-1, 1) or cfg.tp_size > 1 or cfg.sp_size > 1
                or cfg.num_slices > 1 or cfg.fsdp):
            if cfg.fsdp and not dist.is_initialized():
                raise ValueError("fsdp needs a started process group (parallel/distributed.py::initialize)")
            mesh = make_mesh(cfg.dp_size, cfg.tp_size, cfg.sp_size, cfg.num_slices, self.device.type)
        self.mesh = mesh
        self.dp = mesh.data_size if mesh is not None else 1
        self.sp = mesh.sp_size if mesh is not None else 1
        self.is_main = not dist.is_initialized() or dist.get_rank() == 0
        self.model = model
        self.criterion = criterion if criterion is not None else build_criterion(cfg)
        if mesh is not None and self.dp > 1 and hasattr(self.criterion, "data_group"):
            self.criterion.data_group = mesh.batch_group  # the contrastive matrix over the global batch
        if self.sp > 1 and hasattr(self.criterion, "replica"):
            self.criterion.replica = mesh.sp_rank != 0  # per-graph rows count on sp rank 0
        self.image_shape = image_shape
        # --batch-size is per data-parallel replica (JAX train/trainer.py:84-98)
        if cfg.data.batch_size_is_per_replica:
            self.global_batch_size = cfg.data.batch_size * self.dp
        elif cfg.data.batch_size % self.dp:
            raise ValueError(f"global batch_size {cfg.data.batch_size} is not divisible by dp={self.dp}")
        else:
            self.global_batch_size = cfg.data.batch_size
        self.contrastive = cfg.task == "contrastive_learning"
        # optax MultiSteps semantics: one microbatch per step
        self.multi_steps = cfg.optim.update_freq > 1 and not cfg.optim.scan_microbatches
        # the images cross to the card in the compute dtype when it is bf16
        self.image_dtype = torch.bfloat16 if cfg.model.dtype == "bfloat16" else None
        self._copy_stream = None
        # seconds fit waited for each step's input (the prefetcher's waits)
        self.input_waits: List[float] = []
        # set by fit: whether it returned on an (agreed) stop request
        self.stopped = False

    # -- state ---------------------------------------------------------------

    def init_state(self, seed: Optional[int] = None, params: Optional[Dict[str, torch.Tensor]] = None) -> TrainState:
        """A fresh model (random init from a CPU generator seeded with
        ``seed``, default ``cfg.seed``; or the model given to the trainer),
        freeze, AdamW, and the dropout generators. With ``params`` (a full
        state_dict) a new model is built on the meta device and takes them:
        no random init, and the host generator is not advanced by one."""
        seed = self.cfg.seed if seed is None else seed
        host = torch.Generator().manual_seed(seed)
        if params is not None:
            with torch.device("meta"):
                model = MDTModel(self.cfg.model)
            model.load_state_dict(unrolled_state_dict(params, self.cfg.model), strict=True, assign=True)
        else:
            model = self.model if self.model is not None else MDTModel(self.cfg.model, generator=host)
        model = model.to(self.device)
        trainable = apply_freeze(model, self.cfg.model.freeze_initial_encoders)
        layout = None
        if self.mesh is not None:
            layout = Layout(self.mesh, apply_tensor_parallel(model, self.mesh), self.cfg.fsdp)
            apply_sequence_parallel(model, self.mesh)
            if self.cfg.fsdp:
                apply_fsdp(model, self.mesh)
            trainable = [p for p in model.parameters() if p.requires_grad]
        # dropout streams differ across data-parallel and sp ranks (rank 0
        # keeps the one-device stream)
        rank = self.mesh.stream_rank if self.mesh is not None else 0
        if rank:
            host.manual_seed(fold_seed(seed, rank))
        return TrainState(
            model=model,
            optimizer=make_optimizer(self.cfg.optim, trainable),
            trainable=trainable,
            host_rng=host,
            device_rng=torch.Generator(device=self.device).manual_seed(fold_seed(seed, rank)),
            acc_grads=self._fresh_accumulator(trainable),
            layout=layout,
        )

    def _fresh_accumulator(self, trainable: List[torch.nn.Parameter]) -> Optional[List[torch.Tensor]]:
        return [torch.zeros_like(p) for p in trainable] if self.multi_steps else None

    def load_params(self, state: TrainState, state_dict: Dict[str, torch.Tensor]) -> TrainState:
        """Swap in other weights (in either param layout) and start the
        optimizer (and a MultiSteps accumulation) afresh (the JAX
        ``load_params``, i.e. ``--reset-optimizer``)."""
        load_model_state(state, unrolled_state_dict(state_dict, self.cfg.model))
        state.optimizer = make_optimizer(self.cfg.optim, state.trainable)
        state.acc_grads, state.mini_step = self._fresh_accumulator(state.trainable), 0
        return state

    # -- steps ---------------------------------------------------------------

    def train_step(self, state: TrainState, group: Dict[str, Any], return_grads: bool = False) -> Dict[str, torch.Tensor]:
        """One update from a (k, ...)-stacked group (numpy arrays, or
        tensors already on the device); the summed logging outputs of its
        microbatches plus ``gnorm`` (and, with ``return_grads``, ``grads``:
        the normalized gradients by parameter name). Under sp a numpy group
        is the data rank's, of which the rank takes its share."""
        model, opt, layout = state.model, state.optimizer, state.layout
        group = self.local(group, stacked=True)
        k = int(group["idx"].shape[0])
        opt.zero_grad(set_to_none=True)
        total = torch.zeros((), dtype=torch.float32, device=self.device)
        sums: Dict[str, torch.Tensor] = {}
        with dropout_rngs(state.host_rng, state.device_rng):
            for i in range(k):
                if layout is not None and layout.fsdp:  # reduce-scatter once, on the last microbatch
                    model.set_requires_gradient_sync(i == k - 1)
                with profiling.named_scope("microbatch"):
                    batch = to_tensors({key: v[i] for key, v in group.items()}, self.device)
                    loss, ssz, logs = self.criterion(model(batch, deterministic=False), batch)
                    loss.backward()
                total = total + ssz.float()
                for key, v in logs.items():
                    sums[key] = sums[key] + v if key in sums else v
        if layout is not None:
            total, sums = self._sum_over_data(total, sums)
            if not layout.fsdp:
                layout.all_reduce_grads(state.trainable)
        denom = total.clamp_min(1.0)
        for p in state.trainable:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            else:
                p.grad.div_(denom.to(p.grad.dtype))
        sums["gnorm"] = self.grad_norm(state)
        if return_grads:
            sums["grads"] = {n: self._full(state, n, p.grad) for n, p in zip(trainable_names(state), state.trainable)}
        self._apply_update(state)
        state.step += k
        return sums

    def _apply_update(self, state: TrainState) -> None:
        """Clip (``clip_norm > 0``) and one AdamW step on the trainable
        ``.grad``s, with the lr the schedule gives this update."""
        with profiling.named_scope("optimizer"):
            if self.cfg.optim.clip_norm and self.cfg.optim.clip_norm > 0:
                clip_by_global_norm_(state.trainable, self.cfg.optim.clip_norm, self.grad_norm(state))
            lr = self.lr_schedule()(state.num_updates)
            for group in state.optimizer.param_groups:
                group["lr"] = lr
            state.optimizer.step()
        state.num_updates += 1

    def train_microstep(self, state: TrainState, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """One microbatch with optax ``MultiSteps`` semantics (JAX
        ``_make_train_step`` under ``MultiSteps``): the gradient of the loss
        divided by this microbatch's own sample size joins the running mean
        ``acc + (g - acc) / (n + 1)``; on the k-th microbatch clipping and
        AdamW act on the mean and it restarts at zero. Returns the
        microbatch's logging outputs and ``gnorm``, the norm of its own
        normalized gradient."""
        model, k, layout = state.model, self.cfg.optim.update_freq, state.layout
        batch = self.local(batch)
        state.optimizer.zero_grad(set_to_none=True)
        with dropout_rngs(state.host_rng, state.device_rng), profiling.named_scope("microbatch"):
            b = to_tensors(batch, self.device)
            loss, ssz, logs = self.criterion(model(b, deterministic=False), b)
            ssz = ssz.float()
            if layout is not None:  # the global sample size, before the backward
                ssz, logs = self._sum_over_data(ssz, logs)
            (loss / ssz.clamp_min(1.0)).backward()
        if layout is not None and not layout.fsdp:
            layout.all_reduce_grads(state.trainable)
        logs = dict(logs, gnorm=self.grad_norm(state))
        n = state.mini_step
        for acc, p in zip(state.acc_grads, state.trainable):
            g = torch.zeros_like(p) if p.grad is None else p.grad
            acc.add_((g - acc) / (n + 1))
        state.step += 1
        if n == k - 1:
            for p, acc in zip(state.trainable, state.acc_grads):
                p.grad = acc.clone()
                acc.zero_()
            self._apply_update(state)
            state.mini_step = 0
        else:
            state.mini_step = n + 1
        return logs

    # -- across ranks ------------------------------------------------------

    def local(self, host: Dict[str, Any], stacked: bool = False) -> Dict[str, Any]:
        """This rank's part of a data rank's host batch (or, ``stacked``,
        group): its sp share (``parallel/input.py::sp_share``) under
        sequence parallelism; without sp, or for tensors already staged,
        ``host`` itself."""
        if self.sp <= 1 or not isinstance(host.get("idx"), np.ndarray):
            return host
        return sp_share(host, self.mesh.sp_rank, self.sp, stacked)

    def _sum_over_data(self, total: torch.Tensor, sums: Dict[str, torch.Tensor]):
        """(total, sums) summed over the data axes: one all-reduce."""
        keys = list(sums)
        vec = torch.stack([total.double()] + [sums[k].double().reshape(()) for k in keys])
        all_reduce_(vec, self.mesh.data_group)
        return vec[0].to(total.dtype), {k: vec[i + 1].to(sums[k].dtype) for i, k in enumerate(keys)}

    def grad_norm(self, state: TrainState) -> torch.Tensor:
        """The global L2 norm of the trainable gradients (over shards)."""
        if state.layout is None:
            return trainable_gnorm(state.trainable)
        return state.layout.grad_norm(state.trainable, trainable_names(state)).to(self.device)

    def _full(self, state: TrainState, name: str, t: torch.Tensor) -> torch.Tensor:
        return t.detach().clone() if state.layout is None else state.layout.full(name, t)

    def _comm_device(self) -> torch.device:
        """Where a scalar collective's tensor lives: the card under NCCL,
        the CPU under gloo."""
        return self.device if dist.get_backend() == "nccl" else torch.device("cpu")

    def lr_schedule(self) -> Callable[[int], float]:
        o = self.cfg.optim
        return polynomial_decay_schedule(o.lr, o.end_learning_rate, o.warmup_updates, o.total_num_update, o.power)

    # -- batches -------------------------------------------------------------

    def _batches(self, dataset: DiscussionDataset, idx, **kw) -> Iterator:
        """The in-process iterator, or worker processes when
        ``data.num_workers > 0``: the same batches in the same order."""
        make = worker_batches if self.cfg.data.num_workers > 0 else iterate_batches
        if self.dp > 1:  # this data-parallel rank's slice of every global batch
            kw.update(host_index=self.mesh.data_rank, host_count=self.dp)
        if self.dp > 1 or self.sp > 1:  # capacities that every data and sp rank's share divides
            kw.update(shard_multiple=self.dp * self.sp)
        return make(dataset, idx, self.cfg.data, self.cfg.task_cfg, image_shape=self.image_shape,
                    batch_size=self.global_batch_size, contrastive=self.contrastive, **kw)

    def train_batches(self, dataset: DiscussionDataset, epoch: int) -> Iterator:
        return self._batches(dataset, dataset.train_idx, epoch=epoch, shuffle=self.cfg.task_cfg.train_epoch_shuffle)

    def eval_batches(self, dataset: DiscussionDataset, split: str = "valid") -> Iterator:
        idx = dataset.valid_idx if split == "valid" else dataset.test_idx
        return self._batches(dataset, idx, epoch=1, shuffle=False, drop_last=False, pad_tail_to_batch=True)

    def stage(self, host: Dict[str, Any]) -> Staged:
        """A host batch or group on the device (on the card: pinned memory,
        a side stream, images in the compute dtype when it is bf16)."""
        if self.device.type == "cuda" and self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(self.device)
        return stage(host, self.device, self.image_dtype, self._copy_stream)

    def prefetch(self, items: Iterable, put: Callable[[Any], Any]) -> ThreadedPrefetcher:
        """``put`` over ``items`` on a background thread, two items ahead."""
        return ThreadedPrefetcher(items, put, depth=2, device=self.device)

    def evaluate(self, state: TrainState, dataset: DiscussionDataset, split: str = "valid") -> Dict[str, float]:
        """The deterministic forward over a split; the reduced metrics (the
        logging outputs summed over the data axes first). The pad graphs of
        a ragged last batch count nowhere (the contrastive criterion masks
        them by ``grid_mask``)."""
        acc = MetricAccumulator(self.criterion.reduce_metrics)
        with torch.no_grad(), self.prefetch(self.eval_batches(dataset, split),
                                            lambda b: self.stage(self.local(b.asdict()))) as staged:
            for item in staged:
                batch = item.ready()
                _, _, logs = self.criterion(state.model(batch, deterministic=True), batch)
                acc.update(logs)
        if self.mesh is not None:
            acc.sum_over(self.mesh.data_group, self._comm_device())
        return acc.reduce()

    def predict(self, state: TrainState, dataset: DiscussionDataset, split: str = "valid") -> Dict[str, np.ndarray]:
        """Per-node rows for every real node of ``split`` (the JAX
        ``Trainer.predict`` on one process): equal-length numpy columns
        ``graph_idx`` (dataset index), ``node`` (position in its graph),
        ``logit_<k>`` and ``prob_<k>`` per class, ``pred`` (argmax),
        ``label`` (-1: unlabelled) and ``labeled``. Write them with
        ``write_predictions``. The contrastive task has per-graph targets
        and raises ``ValueError``. Across ranks every rank returns the
        whole table, in the one-device row order: each global batch's rows
        rank by rank (the JAX ``_allgather_columns`` orders them by host)."""
        if self.contrastive:
            raise ValueError("predict() exports per-node rows; the contrastive task has per-graph targets — "
                             "use evaluate() for its metrics")
        parts: Dict[str, list] = {}
        num_classes: Optional[int] = None

        def put(b):
            host = self.local(b.asdict())
            return host, self.stage(host)

        with torch.no_grad(), self.prefetch(self.eval_batches(dataset, split), put) as staged:
            for host, item in staged:
                logits = state.model(item.ready(), deterministic=True).logits.float().cpu().numpy()
                if num_classes is None:
                    num_classes = logits.shape[1]
                    parts = {
                        key: []
                        for key in ["graph_idx", "node", "label", "labeled", "pred"]
                        + [f"logit_{k}" for k in range(num_classes)]
                        + [f"prob_{k}" for k in range(num_classes)]
                    }
                slots = np.nonzero(host["node_mask"].astype(bool))[0]
                label_full = np.full(logits.shape[0], -1, dtype=np.int64)
                lmask = host["y_slot_mask"].astype(bool)
                label_full[host["y_node"][lmask]] = host["y"][lmask]
                lg = logits[slots]
                z = lg - lg.max(axis=1, keepdims=True)
                prob = np.exp(z)
                prob /= prob.sum(axis=1, keepdims=True)
                parts["graph_idx"].append(host["idx"][host["node_graph"][slots]])
                parts["node"].append(host["node_pos"][slots])
                parts["label"].append(label_full[slots])
                parts["labeled"].append(label_full[slots] >= 0)
                parts["pred"].append(lg.argmax(axis=1))
                for k in range(num_classes):
                    parts[f"logit_{k}"].append(lg[:, k])
                    parts[f"prob_{k}"].append(prob[:, k])
        if num_classes is None:  # empty split
            return {key: np.asarray([]) for key in ("graph_idx", "node", "label", "labeled", "pred")}
        if self.dp > 1 or self.sp > 1:  # rank by rank: data ranks, then sp ranks within each
            parts = _gather_batches(parts, self.mesh.data_group)
        return {key: np.concatenate(v) for key, v in parts.items()}

    # -- the loop ------------------------------------------------------------

    def has_train_batches(self, dataset: DiscussionDataset) -> bool:
        """Whether an epoch yields a batch (``drop_last`` drops a short one)."""
        n = len(dataset.train_idx)
        return n >= max(self.global_batch_size, 1) if self.cfg.data.drop_last else n > 0

    def micro_per_epoch(self, dataset: DiscussionDataset) -> int:
        """Microbatches an epoch consumes: its full batches (0 without
        ``drop_last``, where resume does not skip), padded up to whole
        groups of ``update_freq`` in scan mode (MultiSteps adds no pad)."""
        k = 1 if self.multi_steps else max(self.cfg.optim.update_freq, 1)
        bpe = len(dataset.train_idx) // max(self.global_batch_size, 1) if self.cfg.data.drop_last else 0
        return -(-bpe // k) * k

    def _epoch_steps(self, state: TrainState, dataset: DiscussionDataset, epoch: int, skip: int) -> Iterator:
        """(logging outputs, graphs) of each step of ``epoch`` after the
        first ``skip``: one scan update per group of ``update_freq`` (a
        ragged tail padded with all-pad microbatches), or one MultiSteps
        microbatch per batch. The prefetch thread collates, stacks and
        stages the steps' inputs (the skipped ones are collated, never
        staged); closing this generator closes it."""
        if self.multi_steps:
            items = (b.asdict() for b in self.train_batches(dataset, epoch))
            step = self.train_microstep
        else:
            items = stack_microbatches(self.train_batches(dataset, epoch), max(self.cfg.optim.update_freq, 1),
                                       pad_tail=True)
            step = self.train_step

        def graphs(host) -> int:  # the global batch's real graphs
            return int(np.asarray(host["nsamples"]).sum())

        with self.prefetch(itertools.islice(items, skip, None),
                           lambda h: (self.stage(self.local(h, stacked=not self.multi_steps)), graphs(h))) as staged:
            for item, n in staged:
                self.input_waits.append(staged.waits[-1])
                yield step(state, item.ready()), n

    def fit(
        self,
        dataset: DiscussionDataset,
        state: Optional[TrainState] = None,
        max_epoch: Optional[int] = None,
        max_updates: Optional[int] = None,
        writer: Optional[MetricsWriter] = None,
        checkpointer=None,
        log_fn: Callable[[str], None] = print,
        should_stop: Optional[Callable[[], bool]] = None,
    ) -> TrainState:
        """Train until ``max_epoch`` epochs or ``max_updates`` updates, with
        a log line every ``log_interval`` updates (reduced metrics, lr,
        updates/s, discussions/s) and validation every
        ``validate_interval_updates``.

        A restored ``state`` resumes where it stopped, skipping the groups
        its epoch already consumed (``resume_position``). With a
        ``checkpointer`` (the JAX ``Trainer.fit``'s saves):
        - each validation that improves ``f1`` (else lowers ``loss``) saves
          the best step;
        - every ``save_interval_updates`` updates, at ``max_updates``, and at
          every ``save_interval``-th epoch end and the last one, a save;
        - when ``should_stop()`` turns true (SIGTERM), a save at the update
          boundary, then return.
        Across ranks every rank runs ``fit`` (evaluations and saves are
        collective); logging, the metric writer and the trace are rank 0's,
        and a stop request on any rank stops every rank at the same update
        boundary (``self.stopped``). A save at the same microbatch and epoch
        as the previous one is skipped: the state has not changed. Under
        MultiSteps every check follows each microbatch, as in the JAX loop, so an epoch-end or
        stop save may hold a partial accumulation. ``fit`` waits for the
        last save to be on disk before it returns.

        With ``profile_trace_dir``, a trace starts once ``profile_trace_start``
        updates are done and stops ``profile_trace_steps`` updates later (or
        when ``fit`` returns), logging "profile trace written to <dir>"."""
        cfg = self.cfg
        max_epoch = cfg.max_epoch if max_epoch is None else max_epoch
        if state is None:
            if not self.has_train_batches(dataset):
                raise ValueError(
                    f"training split yields ZERO batches: {len(dataset.train_idx)} train items < batch "
                    f"{self.global_batch_size} with drop_last; shrink the batch or grow the dataset"
                )
            state = self.init_state()
        if not self.is_main:
            writer, log_fn = _NullWriter(), _null_log
        writer = writer if writer is not None else MetricsWriter(cfg.save_dir)
        self.stopped = False
        k = 1 if self.multi_steps else max(cfg.optim.update_freq, 1)
        acc = MetricAccumulator(self.criterion.reduce_metrics)
        lr_fn = self.lr_schedule()
        last_logged = last_validated = last_saved = state.num_updates
        best_metric = None
        saved_at = None
        window_t0, window_graphs = time.perf_counter(), 0
        self.input_waits = []
        prof = {"session": None, "start": 0, "done": cfg.profile_trace_dir is None or not self.is_main}

        def profile_window(n: int) -> None:
            if prof["done"]:
                return
            if prof["session"] is None:
                if n >= cfg.profile_trace_start:
                    prof["session"], prof["start"] = profiling.start_trace(cfg.profile_trace_dir), n
            elif n >= prof["start"] + cfg.profile_trace_steps:
                finish_profile()

        def finish_profile() -> None:
            if prof["session"] is not None:
                profiling.stop_trace(prof["session"])
                log_fn(f"profile trace written to {cfg.profile_trace_dir}")
            prof["session"], prof["done"] = None, True

        def finish() -> TrainState:
            finish_profile()
            if checkpointer is not None:
                checkpointer.wait()
            return state

        def save(best: bool = False) -> None:
            nonlocal saved_at
            at = (state.step, state.epoch)
            if checkpointer is None or (at == saved_at and not best):
                return
            with profiling.named_scope("checkpoint_save"):
                checkpointer.save(state, state.num_updates, best=best)
            saved_at = at

        start_epoch, skip_groups = resume_position(state.step, state.epoch, self.micro_per_epoch(dataset), k)
        state.epoch = start_epoch - 1  # an epoch consumed but not yet counted counts now
        try:
            for epoch in range(start_epoch, max_epoch + 1):
                steps = self._epoch_steps(state, dataset, epoch, skip_groups if epoch == start_epoch else 0)
                try:
                    for logs, graphs in steps:
                        acc.update(logs)
                        window_graphs += graphs
                        n = state.num_updates
                        profile_window(n)
                        if n - last_logged >= cfg.log_interval:
                            last_logged = n
                            m = acc.reduce()  # copies the window to the host: a sync
                            acc.reset()
                            dt = time.perf_counter() - window_t0
                            m["lr"] = lr_fn(max(n - 1, 0))
                            m["ups"] = round(cfg.log_interval / dt, 3)
                            m["discussions_per_sec"] = round(window_graphs / dt, 2)
                            window_t0, window_graphs = time.perf_counter(), 0
                            writer.write("train", n, m)
                            log_fn(f"epoch {epoch} update {n}: {m}")
                        if (
                            cfg.validate_interval_updates
                            and n - last_validated >= cfg.validate_interval_updates
                            and len(dataset.valid_idx) > 0
                        ):
                            last_validated = n
                            vm = self.evaluate(state, dataset, "valid")
                            writer.write("valid", n, vm)
                            log_fn(f"valid @ {n}: {vm}")
                            key = "f1" if "f1" in vm else "loss"
                            if best_metric is None or (vm[key] > best_metric if key == "f1" else vm[key] < best_metric):
                                best_metric = vm[key]
                                save(best=True)
                        if cfg.save_interval_updates and n - last_saved >= cfg.save_interval_updates:
                            last_saved = n
                            save()
                        if max_updates is not None and n >= max_updates:
                            save()
                            return finish()
                        if self._stop_agreed(should_stop):
                            self.stopped = True
                            log_fn(f"stop requested at update {n}: checkpointing and exiting")
                            save()
                            return finish()
                finally:
                    steps.close()  # stops the prefetch thread of an epoch left early
                state.epoch = epoch
                if epoch % max(cfg.save_interval, 1) == 0 or epoch == max_epoch:
                    save()
        finally:
            finish_profile()  # also when an update raises
        return finish()

    def _stop_agreed(self, should_stop: Optional[Callable[[], bool]]) -> bool:
        """Whether a stop was requested, on any rank (one MAX all-reduce per
        update across ranks)."""
        local = should_stop is not None and should_stop()
        if not dist.is_initialized():
            return local
        return any_rank(local, None, self._comm_device())


def trainable_names(state: TrainState) -> List[str]:
    """The names of ``state.trainable``, in order."""
    names = {id(p): n for n, p in state.model.named_parameters()}
    return [names[id(p)] for p in state.trainable]


def load_model_state(state: TrainState, full: Dict[str, torch.Tensor]) -> None:
    """Whole tensors into ``state.model`` (its local parts across ranks)."""
    if state.layout is None:
        state.model.load_state_dict(full, strict=True)
    else:
        state.layout.load_full_state_dict(state.model, full)


def _gather_batches(parts: Dict[str, list], group) -> Dict[str, list]:
    """Every rank's per-batch column lists merged batch by batch, rank by
    rank: the row order of one device over the global batches."""
    ranks: List[Optional[Dict[str, list]]] = [None] * dist.get_world_size(group)
    dist.all_gather_object(ranks, parts, group=group)
    return {key: [r[key][i] for i in range(len(parts[key])) for r in ranks] for key in parts}


def _csv_fields(column) -> np.ndarray:
    """A column's CSV fields as pandas' ``to_csv`` writes them: numpy's
    ``str`` of each value (the dtype's shortest repr for floats, so a
    float32 0.7 is ``0.7``; ``inf``, ``-inf``, ``True``, ``False``) and an
    empty field for NaN (pandas' ``na_rep``)."""
    values = np.asarray(column)
    fields = values.astype(str).astype(object)
    if values.dtype.kind == "f":
        fields[np.isnan(values)] = ""
    return fields


def write_predictions(path: str, columns: Dict[str, np.ndarray]) -> str:
    """Write ``Trainer.predict`` columns as a table: parquet through pandas,
    or CSV for a ``.csv`` path. Without pandas or a parquet engine, CSV next
    to the path asked for, with a warning. The CSV holds the bytes of the
    JAX package's ``pd.DataFrame(columns).to_csv(path, index=False)``
    (``_csv_fields``, ``\\n`` line ends) without needing pandas. Returns
    the path written."""
    if not path.endswith(".csv"):
        try:
            import pandas as pd

            pd.DataFrame(columns).to_parquet(path)
            return path
        except (ImportError, ValueError) as e:
            alt = os.path.splitext(path)[0] + ".csv"
            print(f"warning: parquet engine unavailable ({e!r}); wrote {alt}", file=sys.stderr)
            path = alt
    with open(path, "w", newline="") as f:
        out = csv.writer(f, lineterminator="\n")
        out.writerow(list(columns))
        out.writerows(zip(*(_csv_fields(v) for v in columns.values())))
    return path
