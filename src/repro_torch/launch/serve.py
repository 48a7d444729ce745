"""Serving CLI: batched generation with the continuous-batching engine.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \\
      --requests 8 --max-new 32 [--device cpu]

The port of ``repro/launch/serve.py``: the same flags and the same reduced
configuration of any registered ``--arch`` of the ``tokens`` input mode
(``llama3.2-1b``, ``granite-8b``, ``phi3-medium-14b``, ``qwen2-72b``,
``qwen3-moe-30b-a3b``, ``deepseek-v3-671b``, ``recurrentgemma-2b``,
``xlstm-125m``), random
weights from seed 0, on the card unless ``--device`` says otherwise.
``musicgen-large`` and ``llava-next-34b`` take embeddings from a frontend
stub: the CLI exits naming their input mode.
"""
from __future__ import annotations

import argparse
import time

import numpy as np


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--cache-len", type=int, default=256)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from repro_torch.configs import get_reduced
    from repro_torch.models import lm
    from repro_torch.serve import Engine, ServeConfig
    from repro_torch.serve.engine import check_input_mode

    cfg = get_reduced(args.arch)
    try:
        check_input_mode(cfg)
    except ValueError as e:
        raise SystemExit(str(e)) from None
    gen = torch.Generator(device=args.device).manual_seed(0)
    params = lm.init_params(cfg, gen, device=args.device)
    eng = Engine(cfg, params, ServeConfig(
        max_slots=args.slots, cache_len=args.cache_len,
        max_new_tokens=args.max_new,
    ), device=args.device)
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    for _ in range(args.requests):
        plen = int(rng.integers(4, 48))
        eng.submit(rng.integers(0, cfg.vocab_size, plen))
    out = eng.run()
    dt = time.perf_counter() - t0
    total = sum(len(v) for v in out.values())
    print(f"served {len(out)} requests / {total} tokens in {dt:.2f}s "
          f"({total/dt:.1f} tok/s on {args.slots} slots, {args.device})")
    return out


if __name__ == "__main__":
    main()
