"""Training CLI: the PAOTA round step on one device, the port's
counterpart of ``repro.launch.train``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
        --demo --rounds 5 [--clients K] [--device cuda|cpu]

The reference's flags (``--arch``, ``--shape``, ``--rounds``, ``--demo``,
``--lr``, ``--local-steps``, ``--checkpoint``), plus ``--clients``, the
client count K that the reference's mesh gave (default 1, as on its 1 x 1
demo mesh), and ``--device`` (default cuda; without a GPU it raises
rather than fall back to the CPU). ``--demo`` runs the reduced config
with block remat on 8 sequences of 128 tokens; otherwise the published
config under ``runtime_config`` (bf16, block remat) at ``--shape``. Each
round: K clients, each ``--local-steps`` SGD steps on batches of
``token_stream`` (the vlm family adds random patch embeddings, the audio
family random frames with ``mask_prob`` masked and the stream's tokens as
targets), a mask of participants drawn at 0.8 (at least one), powers 15,
the noise keyed on the round. It prints one line a round (loss,
participants, seconds) and with ``--checkpoint`` writes the stacked params
in the reference's npz layout. On the card every family trains through
the port's kernels: the attention families through ``swa_attention`` and
its backward, the ssm and hybrid families through ``ssd_chunk`` and its
backward (``ssd_chunk_bwd``; the hybrid through both pairs).
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch


def _batch(cfg, shapes, tokens, rng, device):
    """The round's (K, M, mb, ...) batch on ``device``: the stream's tokens,
    and the family's other inputs from ``rng``."""
    out = {}
    for name, (shape, dtype) in shapes.items():
        if name in ("tokens", "targets"):
            x = tokens.reshape(shape)
        elif name == "mask_indicator":
            x = (rng.random(shape) < cfg.mask_prob).astype(np.int32)
        else:
            x = rng.standard_normal(shape).astype(np.float32)
        out[name] = torch.from_numpy(x).to(device=device, dtype=dtype)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--demo", action="store_true",
                    help="reduced config + tiny shapes")
    ap.add_argument("--lr", type=float, default=1e-2)
    ap.add_argument("--local-steps", type=int, default=5)
    ap.add_argument("--checkpoint", default="")
    ap.add_argument("--clients", type=int, default=1,
                    help="K, the client count the reference's mesh gave")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    from repro_torch.checkpoint.io import save_checkpoint
    from repro_torch.configs import get_config, get_reduced
    from repro_torch.data.synthetic import token_stream
    from repro_torch.device import full_f32_matmul, resolve_device
    from repro_torch.launch.shapes import SHAPES, InputShape
    from repro_torch.launch.steps import (make_paota_train_step,
                                          runtime_config, stack_params,
                                          train_batch_shapes)
    from repro_torch.models import init_model

    dev = resolve_device(args.device)
    full_f32_matmul()
    if args.demo:
        cfg = dataclasses.replace(get_reduced(args.arch), remat="block")
        shape = InputShape("demo", seq_len=128, global_batch=8, kind="train")
    else:
        shape = SHAPES[args.shape]
        cfg = runtime_config(get_config(args.arch), shape)
    k, m = args.clients, args.local_steps
    model = init_model(cfg, seed=0, device=dev)
    step = make_paota_train_step(model, shape, k, lr=args.lr, local_steps=m)
    stacked = stack_params(model, k)
    shapes = train_batch_shapes(cfg, shape, k, m)
    tok_shape = shapes["tokens" if "tokens" in shapes else "targets"][0]
    stream = token_stream(cfg.vocab_size, int(np.prod(tok_shape[:3])),
                          tok_shape[3], args.rounds)
    rng = np.random.default_rng(0)
    for r, tok in enumerate(stream):
        batch = _batch(cfg, shapes, tok["tokens"], rng, dev)
        mask = (rng.random(k) < 0.8).astype(np.float32)
        if mask.sum() == 0:
            mask[0] = 1.0
        powers = torch.full((k,), 15.0, device=dev)
        t0 = time.perf_counter()
        stacked, metrics = step(stacked, batch, powers,
                                torch.from_numpy(mask).to(dev), r)
        loss = float(metrics["loss"])
        print(f"round {r}: loss={loss:.4f} "
              f"participants={int(metrics['participants'])} "
              f"({time.perf_counter() - t0:.1f}s)", flush=True)
    if args.checkpoint:
        save_checkpoint(args.checkpoint, stacked, step=args.rounds)
        print(f"checkpoint -> {args.checkpoint}")


if __name__ == "__main__":
    main()
