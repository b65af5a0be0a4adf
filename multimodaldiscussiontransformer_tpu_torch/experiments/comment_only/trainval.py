"""Comment-only baseline CLI, the port's copy of the JAX package's
``experiments/comment_only/trainval.py`` (reference Comment-Only
Experiments/trainval.py:5-41 and run.sh:1-3):

    python -m multimodaldiscussiontransformer_tpu_torch.experiments.comment_only.trainval \
        -d mm-reddit -e text -s 0 --data-dir ./data/mm-reddit/big

Trains on the card unless ``--device cpu``. The tokenizer is the offline
WordPiece over ``$MDT_BERT_VOCAB`` (``ingest.make_tokenizer``).
``--hf-init`` starts the classifier from the pretrained
``bert-base-uncased`` (a name in the HF cache, ``$HF_HUB_CACHE`` or
``$HF_HOME/hub``), read without ``transformers`` and never downloaded
(``utils/hf_import.py``); a checkpoint that is not there exits 1 naming
where it was looked for.
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("-d", "--dataset", default="mm-reddit")
    p.add_argument("-e", "--experiment", default="text", choices=["text"])
    p.add_argument("-s", "--split", type=int, default=0)
    p.add_argument("--data-dir", default=None)
    p.add_argument("--output-dir", default=None)
    p.add_argument("--max-steps", type=int, default=5000)
    p.add_argument("--eval-steps", type=int, default=500)
    p.add_argument("--batch-size", type=int, default=48)
    p.add_argument("--lr", type=float, default=3e-5)
    p.add_argument("--warmup-steps", type=int, default=400)
    p.add_argument("--hf-init", action="store_true", default=False)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    hf_sd = None
    if args.hf_init:  # before any work, as the launcher's --hf-init
        from multimodaldiscussiontransformer_tpu_torch.utils.hf_import import state_dicts_from_pretrained

        try:
            hf_sd, _ = state_dicts_from_pretrained()
        except (OSError, ValueError) as e:
            p.exit(1, f"error: --hf-init: {e}\n")

    from multimodaldiscussiontransformer_tpu_torch.experiments.comment_only import text_bert
    from multimodaldiscussiontransformer_tpu_torch.experiments.hateful_discussions.ingest import make_tokenizer

    data_dir = args.data_dir or f"./data/{args.dataset}/big"
    output_dir = args.output_dir or f"./output/{args.dataset}-{args.experiment}-{args.split}"
    cfg = text_bert.TextBertConfig(
        lr=args.lr,
        batch_size=args.batch_size,
        max_steps=args.max_steps,
        warmup_steps=args.warmup_steps,
        eval_steps=args.eval_steps,
        output_dir=output_dir,
    )
    train_df, valid_df = text_bert.load_parquet_split(data_dir, args.split)
    tokenizer = make_tokenizer("bert-base-uncased")
    train_data = text_bert.tokenize_frame(train_df, tokenizer, cfg.max_length)
    valid_data = text_bert.tokenize_frame(valid_df, tokenizer, cfg.max_length)
    _, best, logits = text_bert.train(cfg, train_data, valid_data, hf_state_dict=hf_sd, device=args.device)
    text_bert.save_predictions(output_dir, logits, valid_data["label"])
    print("best valid:", json.dumps(best))
    return 0


if __name__ == "__main__":
    sys.exit(main())
