"""Checkpoints of the port: save, resume and checkpoint transforms, with the
surface of the JAX package's ``utils/checkpoints.py`` in torch.

Replaces the reference's FairSeq checkpoint surface: ``--save-dir`` /
``--restore-file`` / ``--reset-optimizer`` (run_train.sh:57-63) and the
contrastive -> node-prediction head reset (node_prediction.py:44-54).

Layout, as the JAX store's: ``save_dir/<step>/state.pt`` for the rolling
saves (keep the newest ``keep``), ``save_dir/best/<step>/state.pt`` for
the best one, and ``save_dir/best_step.txt``. A step's file is written by
``torch.save`` into a temporary directory that ``os.replace`` then moves to
``<step>``, so a run killed mid-save leaves no step that ``latest_step``
would pick. The port's format is its own. The JAX package's Orbax
checkpoints come in through ``tools/orbax_to_npz.py``, which runs where JAX
runs and writes one step as an ``.npz`` that ``load_flax_npz`` reads
(``restore_file``: ``--restore-file X.npz`` and
``DiscussionScorer.from_checkpoint("X.npz")``); its layout:
- ``params/<Flax path>``: the params (either param layout), mapped through
  ``utils/flax_import.py``;
- ``opt/mu/<Flax path>``, ``opt/nu/<Flax path>`` and ``opt/count``: optax's
  AdamW moments of the trainable params and its count;
- ``step`` (microbatches), ``num_updates``, ``epoch`` and, where the run
  had one, ``best_step``;
- ``__bf16__``: the names of the bfloat16 leaves, stored as their uint16
  bits (so numpy reads them without ``ml_dtypes``).

A saved state is a dict of tensors, ints, floats, strings, lists and
dicts, read back with ``torch.load(..., weights_only=True)``:
- ``params``: the model's whole ``state_dict`` (frozen towers included) on
  the CPU;
- ``optimizer``: the AdamW ``state_dict`` on the CPU (bf16 moments stay
  bf16 under ``bf16_adam_state`` and bf16 params);
- ``step`` (microbatches), ``num_updates`` and ``epoch`` (completed);
- ``host_rng`` and ``device_rng``: the two dropout generators' states
  (CPU byte tensors, a CUDA generator's included);
- under MultiSteps (``scan_microbatches`` off) ``acc_grads``, the running
  mean of the current update's microbatch gradients, and ``mini_step``,
  how many it holds: as the JAX state keeps them in its optimizer state,
  so that a save between two microbatches of one update resumes into the
  uninterrupted run.
A params-only checkpoint (``save_params``) holds ``params`` alone. Under
``ModelConfig.scan_layers`` the params are stored in the scan layout
(``utils/scan_params.py``); every loader here unstacks either layout.

Saves are asynchronous by default, as the JAX store's Orbax saves are:
``save`` snapshots the state into host memory (pinned, through a side CUDA
stream, for tensors on the card; a copy for tensors on the CPU) at the
moment it is called and returns; a writer thread then waits for the copy
and writes the step. The compute stream waits for the snapshot's copies, so
the next update cannot overwrite a tensor before it is copied. A save waits
for the one before it; ``wait``/``close`` wait for the last one, and a
writer's exception is raised on the caller's thread at the next ``save``,
``wait`` or ``close``. A watchdog (``async_timeout_sec``) bounds each wait:
a write that has not finished by then is abandoned with a warning, its step
is listed in ``suspect_steps.txt``, and the run continues with synchronous
saves (the JAX ``Checkpointer``'s ``_timed`` / ``_downgrade_to_sync``).

Across ranks the format stays this one file of whole tensors, so that a
checkpoint of any world size and layout restores into any other, and into
``DiscussionScorer.from_checkpoint``: every rank gathers the whole params,
AdamW moments and MultiSteps accumulator (``parallel/mesh.py::Layout``,
collectively), and only rank 0's ``Checkpointer`` (``writer``) writes them,
on its writer thread. ``data_rank_rngs`` holds every data-parallel (and
sp) rank's dropout generators; a rank that finds no entry of its own
(another world size) derives its streams from rank 0's. Params are
replicated over sp, so an sp run's checkpoint is one process's. Every rank restores; averaging,
keep-K and the best store are rank 0's.
"""

from __future__ import annotations

import os
import shutil
import sys
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from multimodaldiscussiontransformer_tpu_torch.models.mdt import _lecun_normal
from multimodaldiscussiontransformer_tpu_torch.train.trainer import load_model_state, trainable_names
from multimodaldiscussiontransformer_tpu_torch.utils.scan_params import _nest, scanned_state_dict, unrolled_state_dict

STATE_FILE = "state.pt"


def _to_cpu(obj: Any) -> Any:
    """``obj`` with every tensor detached onto the CPU (containers rebuilt)."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


def _host_copy(obj: Any, non_blocking: bool = True) -> Any:
    """``obj`` with every tensor copied into host memory: a tensor on the
    card into pinned memory on the current stream (``non_blocking``: the
    host does not wait for it), a CPU tensor by a clone (containers
    rebuilt)."""
    if isinstance(obj, torch.Tensor):
        t = obj.detach()
        if t.device.type == "cpu":
            return t.clone()
        dst = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        dst.copy_(t, non_blocking=non_blocking)
        return dst
    if isinstance(obj, dict):
        return {k: _host_copy(v, non_blocking) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_host_copy(v, non_blocking) for v in obj)
    return obj


def _full_optimizer_state(state) -> Dict[str, Any]:
    """The optimizer's state_dict with whole moments (collective across
    ranks; the optimizer's own without a layout)."""
    sd = state.optimizer.state_dict()
    if state.layout is None:
        return sd
    names = trainable_names(state)
    return {
        "state": {
            i: {k: state.layout.full(names[i], v) if isinstance(v, torch.Tensor) and v.dim() > 0 else v
                for k, v in st.items()}
            for i, st in sd["state"].items()
        },
        "param_groups": sd["param_groups"],
    }


def _rank_rngs(state) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Every data-parallel (and sp) rank's (host, device) generator states,
    in ``Mesh.stream_rank`` order (collective over every rank)."""
    import torch.distributed as dist

    mesh = state.layout.mesh
    every: List[Any] = [None] * dist.get_world_size()
    dist.all_gather_object(every, (mesh.stream_rank, mesh.tp_rank, state.host_rng.get_state(), state.device_rng.get_state()))
    return [(host, dev) for _, tp, host, dev in sorted(every, key=lambda e: e[0]) if tp == 0]


def _state_tensors(state) -> Dict[str, Any]:
    """What a checkpoint stores of a ``TrainState``, where it lives (whole
    tensors across ranks: collective)."""
    layout = state.layout
    params = state.model.state_dict() if layout is None else layout.full_state_dict(state.model)
    config = state.model.config
    out = {
        "params": scanned_state_dict(params, config) if config.scan_layers else params,
        "optimizer": _full_optimizer_state(state),
        "step": int(state.step),
        "num_updates": int(state.num_updates),
        "epoch": int(state.epoch),
        "host_rng": state.host_rng.get_state(),
        "device_rng": state.device_rng.get_state(),
    }
    if layout is not None:
        rngs = _rank_rngs(state)
        out["host_rng"], out["device_rng"] = rngs[0]
        out["data_rank_rngs"] = [list(r) for r in rngs]
    if state.acc_grads is not None:
        if layout is None:
            out["acc_grads"] = state.acc_grads
        else:
            out["acc_grads"] = [layout.full(n, a) for n, a in zip(trainable_names(state), state.acc_grads)]
        out["mini_step"] = int(state.mini_step)
    return out


def state_dict_of(state) -> Dict[str, Any]:
    """What a checkpoint stores of a ``TrainState``, on the CPU."""
    return _to_cpu(_state_tensors(state))


def _snapshot(state) -> Tuple[Dict[str, Any], Optional[torch.cuda.Event]]:
    """(what a checkpoint stores of ``state`` in host memory, the event its
    copies complete at). Tensors on the card are copied into pinned memory
    on a side stream that first waits for the compute stream; the compute
    stream then waits for the copies, so that no later update overwrites a
    tensor before it is copied. The host does not wait: read the payload
    only after the event (None when every tensor is on the CPU)."""
    device = next(state.model.parameters()).device
    if device.type != "cuda":
        return _host_copy(_state_tensors(state)), None
    compute = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(compute)
    with torch.cuda.stream(side):
        payload = _host_copy(_state_tensors(state))
        copied = torch.cuda.Event()
        copied.record(side)
    compute.wait_stream(side)
    return payload, copied


def _steps(directory: str) -> List[int]:
    """The complete steps under ``directory``: numeric names holding a
    state file (a temporary directory, or a step dir without its file, is
    never one)."""
    if not os.path.isdir(directory):
        return []
    return sorted(
        int(name) for name in os.listdir(directory)
        if name.isdigit() and os.path.isfile(os.path.join(directory, name, STATE_FILE))
    )


def _write_step(directory: str, step: int, payload: Optional[Dict[str, Any]] = None, link_from: Optional[str] = None) -> str:
    """Write ``directory/<step>/state.pt`` atomically: into a temporary
    directory first (``torch.save`` of ``payload``, or a hard link to the
    file ``link_from``), then ``os.replace`` into place. An existing step is
    overwritten. Returns the step file's path."""
    os.makedirs(directory, exist_ok=True)
    tmp = os.path.join(directory, f".tmp-{step}")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    path = os.path.join(tmp, STATE_FILE)
    if link_from is None:
        torch.save(payload, path)
    else:
        try:
            os.link(link_from, path)
        except OSError:  # no hard links here: copy the bytes
            shutil.copyfile(link_from, path)
    final = os.path.join(directory, str(step))
    if os.path.exists(final):
        # a directory is only replaced when empty: move the old step aside
        # first, so a kill in between loses the step rather than leaving
        # half of one
        old = os.path.join(directory, f".old-{step}")
        shutil.rmtree(old, ignore_errors=True)
        os.replace(final, old)
        os.replace(tmp, final)
        shutil.rmtree(old, ignore_errors=True)
    else:
        os.replace(tmp, final)
    return os.path.join(final, STATE_FILE)


def _prune(directory: str, keep: int) -> None:
    for step in _steps(directory)[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(directory, str(step)), ignore_errors=True)


def _load(directory: str, step: int) -> Dict[str, Any]:
    return torch.load(os.path.join(directory, str(step), STATE_FILE), map_location="cpu", weights_only=True)


class Checkpointer:
    """Save and restore with keep-last-``keep`` retention of the rolling
    saves and a separate best store (keep 1), so that retention never
    deletes the best step. Saves are asynchronous unless ``async_save`` is
    off (see the module docstring); ``async_timeout_sec`` bounds the wait
    for a write before the watchdog downgrades to synchronous saves."""

    def __init__(self, save_dir: str, keep: int = 3, async_save: bool = True, async_timeout_sec: float = 600.0,
                 writer: bool = True):
        self.save_dir = os.path.abspath(save_dir)
        # across ranks only rank 0 writes; the others take part in the gather
        self._writer = bool(writer)
        if self._writer:
            os.makedirs(self.save_dir, exist_ok=True)
        self._keep = keep
        self._best_dir = os.path.join(self.save_dir, "best")
        self._async = bool(async_save)
        self._async_timeout = float(async_timeout_sec)
        self._pending: Optional[Tuple[threading.Thread, dict, int]] = None

    def save(self, state, step: int, best: bool = False) -> None:
        """Save ``state`` (a ``TrainState``, or a dict in the stored format)
        as ``step``; with ``best`` also as the best step. Saving a step that
        exists overwrites it. Returns once the state is snapshotted (the
        write itself runs on a writer thread unless saves are synchronous).
        Across ranks every rank calls it (the whole tensors are gathered
        collectively); a non-writer then drops them."""
        self._finish_pending()
        if not self._writer:
            if not isinstance(state, dict):
                _state_tensors(state)
            return
        if isinstance(state, dict):
            payload, copied = _host_copy(state, non_blocking=False), None
        else:
            payload, copied = _snapshot(state)

        def write():
            if copied is not None:
                copied.synchronize()
            self._write(payload, step, best)

        if not self._async:
            write()
            return
        box: dict = {}

        def run():
            try:
                write()
            except BaseException as e:  # raised on the training thread at the next save / wait / close
                box["err"] = e

        # not a daemon: the interpreter waits for a write in flight at exit
        thread = threading.Thread(target=run, name=f"ckpt-save-{step}")
        self._pending = (thread, box, step)
        thread.start()

    def _write(self, payload: Dict[str, Any], step: int, best: bool) -> None:
        path = _write_step(self.save_dir, step, payload)
        _prune(self.save_dir, self._keep)
        if best:
            # the same bytes: a hard link, not a second write
            _write_step(self._best_dir, step, link_from=path)
            _prune(self._best_dir, 1)
            with open(os.path.join(self.save_dir, "best_step.txt"), "w") as f:
                f.write(str(step))

    def _finish_pending(self) -> None:
        """Wait for the write in flight, at most ``async_timeout_sec``; raise
        its exception. On timeout, warn, list its step in
        ``suspect_steps.txt`` (the abandoned thread may still write it) and
        make every later save synchronous."""
        if self._pending is None:
            return
        thread, box, step = self._pending
        thread.join(self._async_timeout)
        self._pending = None
        if thread.is_alive():
            print(
                f"WARNING: async checkpoint save of step {step} did not finish within {self._async_timeout:.0f}s "
                "— abandoning it and downgrading to synchronous saves for the rest of the run",
                file=sys.stderr, flush=True,
            )
            self._async = False
            with open(os.path.join(self.save_dir, "suspect_steps.txt"), "a") as f:
                f.write(f"{step}\n")
            return
        if "err" in box:
            raise box["err"]

    def wait(self) -> None:
        """Block until the last save is on disk (or the watchdog gives up)."""
        self._finish_pending()

    def close(self) -> None:
        self._finish_pending()

    def all_steps(self) -> List[int]:
        self._finish_pending()
        return _steps(self.save_dir)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def best_step(self) -> Optional[int]:
        """The best step, else the latest."""
        self._finish_pending()
        steps = _steps(self._best_dir)
        return steps[-1] if steps else self.latest_step()

    def restore(self, state=None, step: Optional[int] = None, best: bool = False) -> Optional[Dict[str, Any]]:
        """The stored dict of ``step`` (default: the latest) from the
        rolling store, or with ``best`` from the best store, falling back
        to the rolling store's latest when there is no best step. None when
        there is no checkpoint. With ``state`` (a ``TrainState``) the
        checkpoint's params must carry the same names as its model's."""
        self._finish_pending()
        directory = self._best_dir if best else self.save_dir
        steps = _steps(directory)
        if step is None:
            if not steps:
                return self.restore(state, None, False) if best else None
            step = steps[-1]
        elif step not in steps:
            raise FileNotFoundError(f"step {step} is not under {directory} (steps: {steps})")
        restored = _load(directory, step)
        if state is not None:
            want = set(state.model.state_dict())
            got = set(unrolled_state_dict(restored["params"], state.model.config))
            if want != got:
                raise ValueError(
                    f"checkpoint step {step} under {directory} does not fit the model: missing "
                    f"{sorted(want - got)[:5]}, unexpected {sorted(got - want)[:5]}"
                )
        return restored


FLAX_NPZ_BF16 = "__bf16__"


def is_flax_npz(path: str) -> bool:
    """Whether ``path`` names a converted JAX step (an ``.npz`` file) rather
    than a checkpoint directory."""
    return str(path).endswith(".npz") and os.path.isfile(path)


def _npz_tree(arrays: Dict[str, np.ndarray], prefix: str) -> Dict[str, Any]:
    """The entries under ``prefix`` as a nested dict, split at "/" (no
    Flax name holds a ".")."""
    return _nest({k[len(prefix):].replace("/", "."): v for k, v in arrays.items() if k.startswith(prefix)})


def load_flax_npz(path: str) -> Dict[str, Any]:
    """A converted JAX step (module docstring) as a restored dict:
    ``params`` (the port's state_dict, unrolled), ``adam`` (``count`` and
    the moments ``exp_avg`` / ``exp_avg_sq`` by parameter name) where the
    file has them, and the counters."""
    from multimodaldiscussiontransformer_tpu_torch.utils.flax_import import flax_to_state_dict

    with np.load(path, allow_pickle=False) as z:
        bf16 = set(z[FLAX_NPZ_BF16].tolist()) if FLAX_NPZ_BF16 in z.files else set()
        arrays = {k: z[k] for k in z.files if k != FLAX_NPZ_BF16}
    for key in bf16:  # uint16 bits: flax_import reads them as bf16
        arrays[key] = arrays[key].view(np.uint16)
    out: Dict[str, Any] = {"params": flax_to_state_dict(_npz_tree(arrays, "params/"))}
    if "opt/count" in arrays:
        out["adam"] = {
            "count": int(arrays["opt/count"]),
            "exp_avg": flax_to_state_dict(_npz_tree(arrays, "opt/mu/")),
            "exp_avg_sq": flax_to_state_dict(_npz_tree(arrays, "opt/nu/")),
        }
    for key in ("step", "num_updates", "epoch", "best_step"):
        if key in arrays:
            out[key] = int(arrays[key])
    return out


def save_flax_npz(path: str, state) -> None:
    """Write ``state`` (a ``TrainState`` whose optimizer has taken a step or
    none) in the layout ``tools/orbax_to_npz.py`` writes from a JAX step:
    the port's side of that file, for round trips where JAX cannot run."""
    from multimodaldiscussiontransformer_tpu_torch.utils.flax_import import _flatten, to_flax_params

    model = state.model
    names = {id(p): n for n, p in model.named_parameters()}
    arrays: Dict[str, np.ndarray] = {}
    bf16: List[str] = []

    def put(prefix: str, tensors: Dict[str, torch.Tensor]) -> None:
        as_bf16 = any(t.dtype == torch.bfloat16 for t in tensors.values())
        tree = to_flax_params(model, {k: t.detach().float() for k, t in tensors.items()})["params"]
        for path, leaf in _flatten(tree).items():
            key = prefix + "/".join(path)
            if as_bf16:  # float32 copies of bf16 values: their top 16 bits are the bf16 bits
                leaf = (np.ascontiguousarray(leaf, np.float32).view(np.uint32) >> 16).astype(np.uint16)
                bf16.append(key)
            arrays[key] = leaf

    put("params/", dict(model.named_parameters()))
    opt = state.optimizer
    # before the first step the moments are optax's initial zeros
    dtype = getattr(opt, "state_dtype", None)
    moments = {
        names[id(p)]: opt.state[p] if opt.state.get(p) else
        {"step": 0, "exp_avg": torch.zeros_like(p, dtype=dtype or p.dtype),
         "exp_avg_sq": torch.zeros_like(p, dtype=dtype or p.dtype)}
        for p in state.trainable
    }
    put("opt/mu/", {n: st["exp_avg"] for n, st in moments.items()})
    put("opt/nu/", {n: st["exp_avg_sq"] for n, st in moments.items()})
    count = int(next(iter(moments.values()))["step"]) if moments else 0
    arrays.update({"opt/count": np.asarray(count, np.int32), "step": np.asarray(state.step, np.int32),
                   "num_updates": np.asarray(count, np.int32), "epoch": np.asarray(state.epoch, np.int32)})
    arrays[FLAX_NPZ_BF16] = np.asarray(sorted(bf16), dtype=str)
    np.savez(path, **arrays)


def restore_file(path: str, state=None, best: bool = False) -> Optional[Dict[str, Any]]:
    """``--restore-file``: a converted JAX step (``.npz``) or the port's
    checkpoint directory (its best step with ``best``, else its latest)."""
    if is_flax_npz(path):
        return load_flax_npz(path)
    return Checkpointer(path).restore(state, best=best)


def _load_adam_moments(state, adam: Dict[str, Any]) -> None:
    """Give ``state.optimizer`` optax's AdamW moments and count (a converted
    JAX step's ``adam``), one entry per trainable parameter."""
    opt = state.optimizer
    names = {id(p): n for n, p in state.model.named_parameters()}
    trainable = [names[id(p)] for p in state.trainable]
    if set(trainable) != set(adam["exp_avg"]):
        raise ValueError(
            f"the AdamW moments do not fit the trainable parameters: missing "
            f"{sorted(set(trainable) - set(adam['exp_avg']))[:5]}, unexpected {sorted(set(adam['exp_avg']) - set(trainable))[:5]}"
        )

    def count():
        # torch.optim.AdamW keeps one float32 tensor per parameter (advanced
        # in place), OptaxAdamW an int
        if hasattr(opt, "state_dtype"):
            return int(adam["count"])
        return torch.tensor(float(adam["count"]), dtype=torch.float32)

    per_param = {
        i: {"step": count(), "exp_avg": adam["exp_avg"][n], "exp_avg_sq": adam["exp_avg_sq"][n]}
        for i, n in enumerate(trainable)
    }
    opt.load_state_dict(_local_optimizer_state(state, {"state": per_param, "param_groups": opt.state_dict()["param_groups"]}))


def restore_params_into_state(trainer, state, restored: Optional[Dict[str, Any]], reset_optimizer: bool):
    """Apply a restored checkpoint to ``state``: the whole state (resume),
    or with ``reset_optimizer`` the params alone with a fresh optimizer (the
    ``--reset-optimizer`` fine-tune path, run_train.sh:63). A converted JAX
    step resumes with its AdamW moments and counters; its run's dropout
    generators are JAX's, so ``state`` keeps its own."""
    if restored is None:
        return state
    if reset_optimizer:
        return trainer.load_params(state, restored["params"])
    if "optimizer" not in restored and "adam" not in restored:
        raise ValueError("a params-only checkpoint cannot resume a run: restore it with reset_optimizer")
    load_model_state(state, unrolled_state_dict(restored["params"], state.model.config))
    state.step = int(restored["step"])
    state.num_updates = int(restored["num_updates"])
    state.epoch = int(restored.get("epoch", 0))
    if "adam" in restored:
        _load_adam_moments(state, restored["adam"])
        return state
    state.optimizer.load_state_dict(_local_optimizer_state(state, restored["optimizer"]))
    _restore_rngs(state, restored)
    if state.acc_grads is not None and "acc_grads" in restored:
        for n, acc, saved in zip(trainable_names(state), state.acc_grads, restored["acc_grads"]):
            _copy_local(acc, saved if state.layout is None else state.layout.local(n, saved, acc))
        state.mini_step = int(restored["mini_step"])
    return state


def _copy_local(dst: torch.Tensor, src: torch.Tensor) -> None:
    """``dst.copy_(src)``, on the local parts of FSDP's ``DTensor``s."""
    from torch.distributed.tensor import DTensor

    with torch.no_grad():
        (dst.to_local() if isinstance(dst, DTensor) else dst).copy_(src.to_local() if isinstance(src, DTensor) else src)


def _local_optimizer_state(state, sd: Dict[str, Any]) -> Dict[str, Any]:
    """A saved optimizer state_dict laid out as this rank's parameters."""
    if state.layout is None:
        return sd
    names = trainable_names(state)
    return {
        "state": {
            i: {k: state.layout.local(names[i], v, state.trainable[i]).to(v.dtype)
                if isinstance(v, torch.Tensor) and v.dim() > 0 else v for k, v in st.items()}
            for i, st in sd["state"].items()
        },
        "param_groups": sd["param_groups"],
    }


def _restore_rngs(state, restored: Dict[str, Any]) -> None:
    """This rank's dropout generators: its own saved entry, else (another
    data-parallel or sp degree, or a one-device checkpoint on a rank > 0)
    rank 0's states, from which a stream rank > 0 draws a seed folded with
    its rank."""
    from multimodaldiscussiontransformer_tpu_torch.models.fast_dropout import fold_seed

    mesh = state.layout.mesh if state.layout is not None else None
    rank, size = (mesh.stream_rank, mesh.stream_size) if mesh is not None else (0, 1)
    saved = restored.get("data_rank_rngs")
    if saved is not None and len(saved) == size:
        state.host_rng.set_state(saved[rank][0])
        state.device_rng.set_state(saved[rank][1])
        return
    state.host_rng.set_state(restored["host_rng"])
    state.device_rng.set_state(restored["device_rng"])
    if rank:
        seed = fold_seed(int(torch.randint(0, 2**62, (), generator=state.host_rng)), rank)
        state.host_rng.manual_seed(seed)
        state.device_rng.manual_seed(seed)


def reset_classifier_head(state_dict: Dict[str, torch.Tensor], generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """A new state_dict whose ``node_classifier`` weight is drawn afresh
    (LeCun normal, truncated, from the CPU ``generator``) and whose bias is
    0: the intended transfer-time head reset (node_prediction.py:47-54).
    The input dict and its tensors are untouched."""
    out = dict(state_dict)
    for key, value in state_dict.items():
        module, _, leaf = key.rpartition(".")
        if module.rsplit(".", 1)[-1] != "node_classifier":
            continue
        if leaf == "weight":
            w = torch.empty(value.shape, dtype=torch.float32)
            _lecun_normal(w, generator)
            out[key] = w.to(value.device, value.dtype)
        elif leaf == "bias":
            out[key] = torch.zeros_like(value)
    return out


def average_checkpoints(save_dir: str, steps: Optional[List[int]] = None, last_k: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """The mean ``params`` of several steps of one save dir (FairSeq's
    ``scripts/average_checkpoints.py``): ``steps`` names them, ``last_k``
    takes the newest K, and by default every retained step. Float tensors
    are averaged in float64 and cast back to their dtype; other tensors
    come from the newest chosen step."""
    avail = _steps(save_dir)
    if not avail:
        raise FileNotFoundError(f"no checkpoints under {save_dir}")
    if steps is not None:
        missing = [s for s in steps if s not in avail]
        if missing:
            raise ValueError(f"steps {missing} not in {save_dir} (available: {avail})")
        chosen = sorted(int(s) for s in steps)
    elif last_k is not None:
        if int(last_k) <= 0:
            raise ValueError(f"last_k must be positive, got {last_k}")
        chosen = avail[-int(last_k):]
    else:
        chosen = avail
    acc: Dict[str, torch.Tensor] = {}
    for s in chosen:
        for key, value in _load(save_dir, s)["params"].items():
            if value.is_floating_point():
                acc[key] = acc[key] + value.double() if key in acc else value.double()
    newest = _load(save_dir, chosen[-1])["params"]
    n = float(len(chosen))
    return {
        key: (acc[key] / n).to(value.dtype) if value.is_floating_point() else value
        for key, value in newest.items()
    }


def save_params(save_dir: str, params: Dict[str, torch.Tensor], step: int = 0) -> None:
    """A params-only checkpoint, loadable by ``DiscussionScorer.from_checkpoint``
    and by ``--restore-file`` with ``--reset-optimizer``."""
    Checkpointer(save_dir, async_save=False).save({"params": _to_cpu(params)}, step)
