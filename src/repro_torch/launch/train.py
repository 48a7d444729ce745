"""Training CLI: end-to-end driver over the public API.

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
      --steps 200 --batch 8 --seq 256 --ckpt CKPT_DIR [--device cpu]

The port of ``repro/launch/train.py``, with the same flags and
``--device`` (the card unless it says otherwise): corpus -> SeqCDC dedup
ingest -> token loader -> train step -> CDC incremental checkpoints with
restart support.  With --reduced (the default) the family-preserving
smoke config is used; --full takes the published configuration.
"""
from __future__ import annotations

import argparse

import numpy as np


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--corpus-mb", type=int, default=8)
    ap.add_argument("--dedup", action="store_true", default=True)
    ap.add_argument("--no-dedup", dest="dedup", action="store_false")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config, get_reduced
    from repro_torch.data import DedupIngest, LoaderConfig, PipelineConfig, TokenLoader
    from repro_torch.data.corpus import load_dataset
    from repro_torch.train import LoopConfig, OptConfig, Trainer

    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    if cfg.input_mode != "tokens":
        raise SystemExit(f"{args.arch} needs a modality frontend; train an LM arch")

    corpus = load_dataset("DEB", args.corpus_mb)
    if args.dedup:
        ing = DedupIngest(PipelineConfig(avg_chunk=8192, segment_bytes=1 << 20),
                          device=args.device)
        corpus = np.concatenate(list(ing.unique_bytes(corpus)))
        print(f"dedup ingest: {ing.savings:.1%} duplicate bytes removed; "
              f"{corpus.nbytes >> 20} MiB remain")
    corpus = np.minimum(corpus, cfg.vocab_size - 1).astype(np.uint8)

    loader = TokenLoader(corpus, LoaderConfig(batch_size=args.batch, seq_len=args.seq))
    ckpt = (CheckpointManager(args.ckpt, device=args.device) if args.ckpt
            else None)
    trainer = Trainer(
        cfg,
        OptConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 1),
                  total_steps=args.steps),
        LoopConfig(total_steps=args.steps, ckpt_every=args.ckpt_every),
        loader,
        ckpt,
        device=args.device,
    )
    trainer.run(torch.Generator(device=args.device).manual_seed(0))
    final = trainer.history[-1]["loss"] if trainer.history else None
    print(f"final loss {final:.4f} ({len(trainer.history)} steps run)"
          if final is not None else "no step run (already at --steps)")
    if ckpt:
        print(f"checkpoint store savings: {ckpt.dedup_savings:.1%}")
    if trainer.monitor.events:
        print(f"straggler events: {len(trainer.monitor.events)}")
    return {"history": trainer.history,
            "savings": ckpt.dedup_savings if ckpt else None}


if __name__ == "__main__":
    main()
