"""Training CLI of the port, with the JAX package's flag names
(``MIGRATION.md``; the reference ``fairseq-train`` surface).

The canonical run (``bash run_train.sh 8 4 5 2 2 0``) on synthetic
discussions, on the card:

    python -m multimodaldiscussiontransformer_tpu_torch.train.launch --synthetic \\
        --num-fusion-layers 8 --num-bottleneck-tokens 4 --spatial-pos-max 5 \\
        --num-graph-stack 2 --num-fusion-stack 2 --batch-size 12 --update-freq 3 \\
        --positive-weight 1.5 --freeze-initial-encoders --max-updates 20 --no-save

Quick run on the CPU:

    python -m multimodaldiscussiontransformer_tpu_torch.train.launch --synthetic \\
        --tiny --max-updates 2 --no-save --device cpu

The reference's two stages: contrastive pre-training (``--task
contrastive_learning``), then the node task from its checkpoint with a new
head (``--restore-file <save dir> --reset-optimizer``).

Checkpoints go to ``--save-dir`` (``utils/checkpoints.py``) unless
``--no-save``; a relaunch with the same ``--save-dir`` resumes from its
latest step, and SIGTERM saves at the next update boundary and exits 0.
``--eval-only`` scores a checkpoint (best, latest or the average of the
last K) and ``--predict-output`` writes its per-node predictions. Without
``--synthetic`` the data is the ``hateful_discussions`` directory of
``--data-root``.

The training runtime: ``--num-workers N`` collates in N worker processes;
``--remat --remat-policy P`` rematerialises the fusion and graph stacks;
``--scan-layers`` stores params in the scan layout; ``--profile-trace DIR
--profile-steps N`` traces N updates after the first 2 into DIR;
``--tensorboard-logdir DIR`` and ``--wandb-project NAME`` (default
``$WANDB_PROJECT``) add metric sinks beside ``metrics.jsonl``.

Across ranks, one process per card (FairSeq's layout; in the JAX launcher
``--distributed-world-size`` counts hosts instead):

    torchrun --nproc-per-node 4 -m multimodaldiscussiontransformer_tpu_torch.train.launch --synthetic ...
    python -m multimodaldiscussiontransformer_tpu_torch.train.launch --distributed-world-size 4 \
        --distributed-rank R --distributed-init-method tcp://HOST:PORT --synthetic ...   # once per rank

``--batch-size`` is per data-parallel replica (the global batch is
batch-size x dp); ``--dp-size``, ``--tp-size``, ``--sp-size``,
``--num-slices`` and ``--fsdp`` lay the ranks out (``parallel/mesh.py``).
``--sp-size N`` (which turns ``sequence_parallel`` on, as the JAX launcher
does) cuts every discussion's node axis into N strips, one per rank of an
sp group, with the graph attention a ring over the group: on the CPU, e.g.
``--device cpu --distributed-backend gloo --distributed-world-size 2
--sp-size 2`` once per rank. NCCL carries a
``--device cuda`` run, gloo a ``--device cpu`` one; ranks that share one
card pass ``--distributed-backend gloo``. Rank 0 logs, writes the metrics,
the checkpoints and the predictions; a SIGTERM to any rank stops every rank
at the same update, after a save.

``--hf-init`` starts the towers from pretrained BERT and ViT checkpoints
(``--text-encoder`` / ``--image-encoder``: a local directory, or a name in
the HF cache, ``$HF_HUB_CACHE`` or ``$HF_HOME/hub``), read without
``transformers`` and never downloaded; a checkpoint that is not there exits
1 naming where it was looked for. ``--tiny`` ignores the flag, as the JAX
launcher does; ``--restore-file`` and a resume override the towers.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import signal
import sys

def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", default="cuda", help="torch device to train on (default cuda; cpu for a quick run)")
    # task / criterion / arch
    p.add_argument("--task", default="node_prediction", choices=["node_prediction", "contrastive_learning"])
    p.add_argument("--criterion", default="node_cross_entropy")
    p.add_argument("--arch", default="multi_graphormer_base")
    p.add_argument("--user-data-dir", default="")
    p.add_argument("--dataset-name", default="hateful_discussions")
    p.add_argument("--data-root", default=None, help="processed dataset root (default $MDT_DATA_ROOT)")
    p.add_argument("--num-classes", type=int, default=2)
    p.add_argument("--split", type=int, default=0)
    p.add_argument("--seed", type=int, default=1)
    # model geometry (the reference's underscore spellings are aliases)
    p.add_argument("--num-fusion-layers", "--num_fusion_layers", type=int, default=8)
    p.add_argument("--num-bottleneck-tokens", "--num_bottleneck_tokens", type=int, default=4)
    p.add_argument("--num-graph-stack", "--num_graph_stack", type=int, default=2)
    p.add_argument("--num-fusion-stack", "--num_fusion_stack", type=int, default=2)
    p.add_argument("--spatial-pos-max", type=int, default=5)
    p.add_argument("--max-nodes", type=int, default=10000)
    p.add_argument("--encoder-embed-dim", type=int, default=768)
    p.add_argument("--encoder-ffn-embed-dim", type=int, default=768)
    p.add_argument("--encoder-attention-heads", type=int, default=12)
    # vestigial, as in the reference and JAX: run_train.sh passes it, nothing reads it
    p.add_argument("--encoder-layers", type=int, default=12)
    p.add_argument("--activation-fn", default=None)
    p.add_argument("--pre-layernorm", action="store_true", default=None)
    p.add_argument("--encoder-normalize-before", action="store_true", default=None)
    p.add_argument("--apply-graphormer-init", action="store_true", default=None)
    # regularization: unset flags resolve to the reference recipe (0.4 /
    # 0.3 / 0.3) for real archs and to the preset's values under --tiny
    p.add_argument("--dropout", type=float, default=None)
    p.add_argument("--attention-dropout", type=float, default=None)
    p.add_argument("--act-dropout", type=float, default=None)
    # optimization
    p.add_argument("--optimizer", default="adam", choices=["adam"])
    p.add_argument("--lr-scheduler", default="polynomial_decay", choices=["polynomial_decay"])
    p.add_argument("--lr", type=float, default=3e-5)
    p.add_argument("--end-learning-rate", type=float, default=3e-7)
    p.add_argument("--power", type=float, default=1.0)
    p.add_argument("--warmup-updates", type=int, default=3246)
    p.add_argument("--total-num-update", type=int, default=10820)
    p.add_argument("--adam-eps", type=float, default=1e-8)
    p.add_argument("--adam-betas", default="(0.9, 0.999)")
    p.add_argument("--weight-decay", type=float, default=0.01)
    p.add_argument("--clip-norm", type=float, default=0.0)
    p.add_argument("--batch-size", type=int, default=12)
    p.add_argument("--required-batch-size-multiple", type=int, default=1)
    p.add_argument("--update-freq", type=int, default=3)
    p.add_argument("--no-scan-microbatches", action="store_true", default=False)
    p.add_argument("--bf16-adam-state", action="store_true", default=False)
    p.add_argument("--max-epoch", type=int, default=37)
    p.add_argument("--max-updates", type=int, default=None)
    p.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"])
    p.add_argument("--fp16", action="store_true", default=False, help="the reference's --fp16, mapped to bfloat16")
    # criterion weights
    p.add_argument("--positive-weight", type=float, default=1.5)
    p.add_argument("--negative-weight", type=float, default=1.0)
    p.add_argument("--soft-negative-weight", type=float, default=0.0)
    p.add_argument("--multiplication-scale", type=float, default=20.0)
    p.add_argument("--freeze-initial-encoders", "--freeze_initial_encoders", action="store_true", default=False)
    # checkpointing and logging
    p.add_argument("--save-dir", default="checkpoints")
    p.add_argument("--restore-file", default=None)
    p.add_argument("--reset-optimizer", action="store_true", default=False)
    p.add_argument("--validate-interval-updates", type=int, default=300)
    p.add_argument("--save-interval", type=int, default=1)
    p.add_argument("--save-interval-updates", type=int, default=0)
    p.add_argument("--no-save", action="store_true", default=False,
                   help="never write checkpoints (also disables auto-resume)")
    p.add_argument("--log-interval", type=int, default=50)
    p.add_argument("--wandb-project", default=os.environ.get("WANDB_PROJECT"))
    p.add_argument("--tensorboard-logdir", default=None)
    p.add_argument("--profile-trace", default=None,
                   help="directory for a torch.profiler trace (Chrome/TensorBoard JSON) of steady-state updates")
    p.add_argument("--profile-steps", type=int, default=5)
    # parallelism
    p.add_argument("--dp-size", type=int, default=-1, help="data-parallel ranks (per slice); -1: the ranks left over")
    p.add_argument("--tp-size", type=int, default=1, help="tensor-parallel ranks (attention heads and FFN split)")
    p.add_argument("--sp-size", type=int, default=1,
                   help="sequence-parallel ranks: the graph grid's node axis cut into strips, ring attention")
    p.add_argument("--fsdp", action="store_true", default=False,
                   help="shard params, gradients and optimizer state over dp (FSDP2; HSDP with --num-slices)")
    p.add_argument("--distributed-world-size", type=int, default=1,
                   help="number of RANKS, one process per card (FairSeq's meaning; the JAX launcher counts hosts)")
    p.add_argument("--distributed-rank", type=int, default=0, help="this process's rank in [0, world-size)")
    p.add_argument("--distributed-init-method", default=None,
                   help="rendezvous, tcp://HOST:PORT or HOST:PORT (torchrun's environment needs none)")
    p.add_argument("--distributed-backend", default=None, choices=("nccl", "gloo"),
                   help="default: nccl for --device cuda, gloo for cpu; gloo for ranks that share one card")
    p.add_argument("--num-slices", type=int, default=1,
                   help="outermost dcn axis: data parallel across slices, fsdp/tp within one")
    p.add_argument("--hf-init", action="store_true", default=False)
    p.add_argument("--text-encoder", default="bert-base-uncased")
    p.add_argument("--image-encoder", default="google/vit-base-patch16-224")
    # data loading and batching
    p.add_argument("--num-workers", type=int, default=0)
    p.add_argument("--length-grouped", action="store_true", default=False)
    p.add_argument("--node-buckets", default=None)
    p.add_argument("--node-capacity-buckets", default=None)
    p.add_argument("--image-capacity-buckets", default=None)
    p.add_argument("--label-capacity-buckets", default=None)
    p.add_argument("--text-len-buckets", default=None)
    # compute policy
    p.add_argument("--remat", action="store_true", default=False,
                   help="rematerialise the fusion and graph stacks in the backward (less memory, more compute)")
    p.add_argument("--remat-policy", default="full",
                   choices=("full", "dots", "dots_saveable", "names", "names_heavy"),
                   help="what remat saves: full = block inputs only; dots / dots_saveable = also the matmul outputs "
                        "without / with batch dims; names = the layers' attention and FFN outputs; names_heavy = "
                        "also the attention projection and the FFN intermediate")
    p.add_argument("--scan-layers", action="store_true", default=False,
                   help="store params in the scan layout (uniform layers stacked on a leading axis); "
                        "the modules and the numbers are the same")
    p.add_argument("--use-pallas-attention", action=argparse.BooleanOptionalAction, default=True,
                   help="graph attention through the compact bias and the tree-attention kernels")
    # evaluation only
    p.add_argument("--eval-only", action="store_true", default=False,
                   help="no training: restore (--restore-file, else --save-dir) and evaluate --valid-subset")
    p.add_argument("--valid-subset", default="valid,test", help="comma-separated splits to score with --eval-only")
    p.add_argument("--load-best", action="store_true", default=False,
                   help="evaluate the best checkpoint instead of the latest")
    p.add_argument("--predict-output", default=None, metavar="DIR",
                   help="with --eval-only: also write per-node predictions-<split>.parquet under DIR")
    p.add_argument("--average-last", type=int, default=None,
                   help="evaluate the average of the newest K checkpoints")
    # smoke-run conveniences
    p.add_argument("--synthetic", action="store_true", default=False)
    p.add_argument("--synthetic-graphs", type=int, default=None)
    p.add_argument("--tiny", action="store_true", default=False)
    return p


def config_from_args(args):
    """The TrainConfig of the parsed flags, resolved as the JAX launcher
    resolves them."""
    from multimodaldiscussiontransformer_tpu_torch.core import registry
    from multimodaldiscussiontransformer_tpu_torch.core.config import (
        DataConfig,
        ModelConfig,
        OptimConfig,
        TaskConfig,
        TrainConfig,
        tiny_model_config,
    )

    if args.fp16:
        args.dtype = "bfloat16"
    if args.tiny:
        model = tiny_model_config(freeze_initial_encoders=args.freeze_initial_encoders, dtype="float32")
        for name in ("dropout", "act_dropout", "attention_dropout"):
            if getattr(args, name) is not None:
                model = model.replace(**{name: getattr(args, name)})
        tower_kw = {}
        if args.act_dropout is not None:
            tower_kw["hidden_dropout_prob"] = args.act_dropout
        if args.attention_dropout is not None:
            tower_kw["attention_probs_dropout_prob"] = args.attention_dropout
        if tower_kw:
            model = model.replace(
                text_tower=dataclasses.replace(model.text_tower, **tower_kw),
                image_tower=dataclasses.replace(model.image_tower, **tower_kw),
            )
    else:
        registry.populate()
        arch = registry.ARCHITECTURES
        model = arch.get(args.arch)() if args.arch in arch else ModelConfig()
        # the reference rebuilds the towers with the model-level dropout
        # flags; unset flags take the recipe's values
        args.dropout = 0.4 if args.dropout is None else args.dropout
        args.attention_dropout = 0.3 if args.attention_dropout is None else args.attention_dropout
        args.act_dropout = 0.3 if args.act_dropout is None else args.act_dropout
        tower_kw = dict(hidden_dropout_prob=args.act_dropout, attention_probs_dropout_prob=args.attention_dropout)
        model = model.replace(
            num_bottleneck_tokens=args.num_bottleneck_tokens,
            num_fusion_layers=args.num_fusion_layers,
            num_fusion_stack=args.num_fusion_stack,
            num_graph_stack=args.num_graph_stack,
            encoder_embed_dim=args.encoder_embed_dim,
            encoder_ffn_embed_dim=args.encoder_ffn_embed_dim,
            encoder_attention_heads=args.encoder_attention_heads,
            dropout=args.dropout,
            attention_dropout=args.attention_dropout,
            act_dropout=args.act_dropout,
            freeze_initial_encoders=args.freeze_initial_encoders,
            num_classes=args.num_classes if args.num_classes > 1 else 2,
            dtype=args.dtype,
            use_pallas_attention=args.use_pallas_attention,
            text_encoder_name=args.text_encoder,
            image_encoder_name=args.image_encoder,
            text_tower=dataclasses.replace(model.text_tower, **tower_kw),
            image_tower=dataclasses.replace(model.image_tower, **tower_kw),
        )
    for name in ("activation_fn", "pre_layernorm", "encoder_normalize_before", "apply_graphormer_init"):
        if getattr(args, name) is not None:
            model = model.replace(**{name: getattr(args, name)})
    if args.sp_size > 1:  # the JAX launcher turns the ring on with an sp axis
        model = model.replace(sequence_parallel=True)
    if args.scan_layers:
        model = model.replace(scan_layers=True)
    if args.remat and not model.remat:
        model = model.replace(remat=True)
    if args.remat and model.remat_policy != args.remat_policy:
        model = model.replace(remat_policy=args.remat_policy)

    def ladder(spec, default):
        return default if spec is None else tuple(int(x) for x in str(spec).split(",") if x.strip())

    if args.tiny:
        data = DataConfig(
            batch_size=args.batch_size, length_grouped=args.length_grouped, num_workers=args.num_workers,
            max_text_len=16,
            node_buckets=ladder(args.node_buckets, (8, 16)),
            node_capacity_buckets=ladder(args.node_capacity_buckets, (32, 64, 128)),
            image_capacity_buckets=ladder(args.image_capacity_buckets, (0, 8, 16)),
            label_capacity_buckets=ladder(args.label_capacity_buckets, (8, 16, 32, 64)),
        )
    else:
        data = DataConfig(
            batch_size=args.batch_size, length_grouped=args.length_grouped, num_workers=args.num_workers,
            node_buckets=ladder(args.node_buckets, DataConfig.node_buckets),
            node_capacity_buckets=ladder(args.node_capacity_buckets, DataConfig.node_capacity_buckets),
            image_capacity_buckets=ladder(args.image_capacity_buckets, DataConfig.image_capacity_buckets),
            label_capacity_buckets=ladder(args.label_capacity_buckets, DataConfig.label_capacity_buckets),
            text_len_buckets=ladder(args.text_len_buckets, DataConfig.text_len_buckets),
        )
    return TrainConfig(
        criterion=args.criterion,
        task=args.task,
        arch=args.arch,
        max_epoch=args.max_epoch,
        validate_interval_updates=args.validate_interval_updates,
        save_dir=args.save_dir,
        save_interval=args.save_interval,
        save_interval_updates=args.save_interval_updates,
        profile_trace_dir=args.profile_trace,
        profile_trace_steps=args.profile_steps,
        restore_file=args.restore_file,
        reset_optimizer=args.reset_optimizer,
        seed=args.seed,
        log_interval=args.log_interval,
        positive_weight=args.positive_weight,
        negative_weight=args.negative_weight,
        soft_negative_weight=args.soft_negative_weight,
        multiplication_scale=args.multiplication_scale,
        dp_size=args.dp_size,
        tp_size=args.tp_size,
        sp_size=args.sp_size,
        num_slices=args.num_slices,
        fsdp=args.fsdp,
        optim=OptimConfig(
            lr=args.lr,
            end_learning_rate=args.end_learning_rate,
            warmup_updates=args.warmup_updates,
            total_num_update=args.total_num_update,
            adam_eps=args.adam_eps,
            adam_betas=tuple(float(x) for x in args.adam_betas.strip("()[] ").split(",")),
            weight_decay=args.weight_decay,
            update_freq=args.update_freq,
            scan_microbatches=not args.no_scan_microbatches,
            bf16_adam_state=args.bf16_adam_state,
            clip_norm=args.clip_norm,
            power=args.power,
        ),
        model=model,
        data=data,
        task_cfg=TaskConfig(
            dataset_name="synthetic" if args.synthetic else args.dataset_name,
            num_classes=args.num_classes,
            spatial_pos_max=args.spatial_pos_max,
            max_nodes=args.max_nodes,
            seed=args.seed,
            user_data_dir=args.user_data_dir,
        ),
    )


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    from multimodaldiscussiontransformer_tpu_torch.parallel import distributed

    # the process group (and the rank's card) before anything touches a card
    layout = distributed.rank_layout(args.distributed_world_size, args.distributed_rank,
                                     args.distributed_init_method)
    device = distributed.initialize(layout, args.device, args.distributed_backend)
    if layout.world_size > 1 or layout.init_method is not None:
        print(f"distributed: rank {layout.rank}/{layout.world_size} on {device} "
              f"({distributed.choose_backend(args.device, args.distributed_backend)})", flush=True)
    try:
        rc = _run(args, device, layout.rank == 0)
    except BaseException:
        distributed.abandon()  # no barrier: the other ranks may be inside a collective
        raise
    distributed.shutdown()
    return rc


def _run(args, device, is_main: bool) -> int:
    say = print if is_main else (lambda *a, **k: None)
    if args.required_batch_size_multiple > 1 and args.batch_size % args.required_batch_size_multiple:
        print(
            f"error: --batch-size {args.batch_size} is not a multiple of "
            f"--required-batch-size-multiple {args.required_batch_size_multiple}",
            file=sys.stderr,
        )
        return 2
    cfg = config_from_args(args)
    hf_init = hf_init_requested(args)
    if hf_init:  # before any work: a checkpoint that is not there is never replaced by random towers
        from multimodaldiscussiontransformer_tpu_torch.utils.hf_import import check_pretrained

        try:
            for name in (cfg.model.text_encoder_name, cfg.model.image_encoder_name):
                check_pretrained(name)
        except (OSError, ValueError) as e:
            print(f"error: --hf-init: {e}", file=sys.stderr)
            return 1

    from multimodaldiscussiontransformer_tpu_torch.core import registry
    from multimodaldiscussiontransformer_tpu_torch.train.metrics import MetricsWriter
    from multimodaldiscussiontransformer_tpu_torch.utils.checkpoints import (
        Checkpointer,
        restore_file,
        restore_params_into_state,
    )

    registry.populate()
    task = registry.TASKS.get(cfg.task)(cfg)
    cfg = task.cfg
    if args.synthetic:
        img = (3, 32, 32) if args.tiny else (3, 224, 224)
        factory_kwargs = dict(
            num_graphs=args.synthetic_graphs if args.synthetic_graphs is not None else max(4 * cfg.data.batch_size, 32),
            seed=cfg.seed,
            contrastive=task.contrastive,
            seq_len=cfg.data.max_text_len,
            vocab_size=cfg.model.text_tower.vocab_size,
            image_shape=img,
            max_nodes=8 if args.tiny else 24,
        )
    else:
        img = (3, cfg.model.image_tower.image_size, cfg.model.image_tower.image_size)
        factory_kwargs = {"split": args.split, "seed": cfg.seed}
        if args.data_root:
            factory_kwargs["root"] = args.data_root
    dataset = task.load_dataset(**factory_kwargs)
    say(
        f"dataset: {len(dataset)} graphs (train {len(dataset.train_idx)} / valid {len(dataset.valid_idx)} "
        f"/ test {len(dataset.test_idx)})"
    )
    trainer = task.build_trainer(image_shape=img, device=device)
    if not trainer.has_train_batches(dataset):  # the same answer on every rank
        print(
            f"error: the train split yields no batches: {len(dataset.train_idx)} train graphs < batch "
            f"{trainer.global_batch_size} with drop_last; lower --batch-size or provide more data",
            file=sys.stderr,
        )
        return 1
    if args.eval_only:
        return evaluate_checkpoint(args, cfg, trainer, dataset, say, is_main)

    ckpt = None if args.no_save else Checkpointer(cfg.save_dir, writer=is_main)

    def fresh_state():
        # JAX's order: the towers go into the fresh state, which a restore
        # then overrides
        if not hf_init:
            return trainer.init_state()
        state = hf_init_state(trainer, cfg)
        say("initialized towers from HF checkpoints")
        return state

    if cfg.restore_file:
        state = fresh_state()
        restored = restore_file(cfg.restore_file, state)
        if restored is not None:
            if cfg.task == "node_prediction" and cfg.reset_optimizer:  # a transfer: the head starts afresh
                restored = {**restored, "params": task.transfer_from_contrastive(restored["params"], seed=cfg.seed)}
            state = restore_params_into_state(trainer, state, restored, cfg.reset_optimizer)
            say(f"restored from {cfg.restore_file}")
    elif ckpt is not None and ckpt.latest_step() is not None:
        restored = ckpt.restore()
        state = restore_params_into_state(trainer, trainer.init_state(params=restored["params"]), restored, False)
        say(f"auto-resumed from step {ckpt.latest_step()}")
    else:
        state = fresh_state()

    writer = MetricsWriter(cfg.save_dir, wandb_project=args.wandb_project, config=dataclasses.asdict(cfg),
                           tensorboard_logdir=args.tensorboard_logdir) if is_main else None
    # preemption: the handler only sets a flag; fit saves at the next update
    # boundary and returns, and a relaunch auto-resumes from that step
    stop = {"requested": False}

    def request_stop(signum, frame):
        stop["requested"] = True
        # os.write, not print: the signal may land inside another print
        os.write(2, f"signal {signum}: finishing current update, then checkpoint + exit\n".encode())

    prev_term = signal.signal(signal.SIGTERM, request_stop)
    try:
        state = trainer.fit(
            dataset, state=state, max_updates=args.max_updates, writer=writer, checkpointer=ckpt,
            should_stop=lambda: stop["requested"],
        )
    finally:
        signal.signal(signal.SIGTERM, prev_term)
        if ckpt is not None:
            ckpt.close()
    if trainer.stopped:  # requested here or on another rank: every rank stopped at this update
        saved = "checkpoint saved" if ckpt is not None else "no-save"
        print(f"preempted: {saved} at step {state.num_updates}", flush=True)
        if writer is not None:
            writer.close()
        return 0
    if len(dataset.test_idx):
        test_metrics = trainer.evaluate(state, dataset, "test")
        if writer is not None:
            writer.write("test", state.num_updates, test_metrics)
        say("test:", json.dumps(test_metrics))
    if writer is not None:
        writer.close()
    return 0


def hf_init_requested(args) -> bool:
    """``--hf-init`` applies, as in the JAX launcher, unless ``--tiny``
    (whose towers no published checkpoint fits)."""
    return args.hf_init and not args.tiny


def hf_init_state(trainer, cfg):
    """``--hf-init``: the trainer's fresh state with the towers, the fusion
    layers, the text pooler and the classifier read from
    ``cfg.model.text_encoder_name`` / ``image_encoder_name``
    (``utils/hf_import.py``), written into the full params on the host
    before the trainer lays them out over its mesh (FSDP2 shards them
    there); every other tensor is the random init of a run without the
    flag."""
    from multimodaldiscussiontransformer_tpu_torch.utils import hf_import

    bert_sd, vit_sd = hf_import.state_dicts_from_pretrained(
        cfg.model.text_encoder_name, cfg.model.image_encoder_name,
        attention_dropout=cfg.model.attention_dropout, hidden_dropout=cfg.model.act_dropout, seed=cfg.seed)
    return trainer.init_state(edit=lambda sd: hf_import.import_towers(sd, cfg.model, bert_sd, vit_sd))


def evaluate_checkpoint(args, cfg, trainer, dataset, say=print, is_main: bool = True) -> int:
    """``--eval-only``: load the average of the last ``--average-last``
    steps, or the best (``--load-best``) or latest checkpoint, of
    ``--restore-file`` (else ``--save-dir``), then score each split of
    ``--valid-subset`` and, with ``--predict-output``, write its per-node
    predictions. Every rank runs it; rank 0 prints and writes."""
    from multimodaldiscussiontransformer_tpu_torch.train.trainer import write_predictions
    from multimodaldiscussiontransformer_tpu_torch.utils.checkpoints import average_checkpoints, restore_file

    src = cfg.restore_file or cfg.save_dir
    if args.average_last is not None:
        state = trainer.init_state(params=average_checkpoints(src, last_k=args.average_last))
        say(f"evaluating average of last {args.average_last} checkpoints from {src}")
    else:
        restored = restore_file(src, best=args.load_best)
        if restored is None:
            print(f"error: no checkpoint under {src}", file=sys.stderr)
            return 1
        state = trainer.init_state(params=restored["params"])
        say(f"evaluating {'best' if args.load_best else 'latest'} checkpoint from {src}")
    results = {}
    for split in args.valid_subset.split(","):
        split = split.strip()
        if split not in ("valid", "test"):
            print(f"error: unknown split {split!r} (valid,test)", file=sys.stderr)
            return 1
        if not len(getattr(dataset, f"{split}_idx")):
            continue
        results[split] = trainer.evaluate(state, dataset, split)
        say(f"{split}:", json.dumps(results[split]))
        if args.predict_output:
            if trainer.contrastive:
                print("error: --predict-output needs the node task (contrastive targets are per-graph)", file=sys.stderr)
                return 1
            cols = trainer.predict(state, dataset, split)
            if is_main:
                os.makedirs(args.predict_output, exist_ok=True)
                out_path = write_predictions(os.path.join(args.predict_output, f"predictions-{split}.parquet"), cols)
                print(f"wrote {len(cols['graph_idx'])} per-node rows -> {out_path}")
    return 0 if results else 1


if __name__ == "__main__":
    sys.exit(main())
