"""Serving CLI: batched greedy decoding on the port, after an optional
prefill of a random prompt.

    PYTHONPATH=src python -m repro_torch.launch.serve [--arch smollm-135m] \\
        [--batch 4] [--steps 16] [--cache 128] [--demo] \\
        [--prompt-len T] [--device cuda|cpu]

``--arch`` defaults to ``smollm-135m``, as the reference's CLI does; the
port runs the dense family (``smollm-135m``, ``olmo-1b``, ``minicpm-2b``,
``granite-3-8b``), the moe family (``mixtral-8x22b``,
``llama4-maverick-400b-a17b``), ``mamba2-370m``, ``zamba2-7b`` and the
vlm ``internvl2-1b``; the encoder-only ``hubert-xlarge`` has no decode
path and exits naming it, as the reference's does.
``--cache`` sizes the KV rings: a full-attention arch's ring keeps the
last ``--cache`` tokens (a longer prompt and decode wrap it, as in the
reference); a windowed arch's (zamba2-7b, mixtral-8x22b) is at most its
4,096-token window.

The port's counterpart of ``repro.launch.serve`` / ``examples/
serve_decode.py``, with their flags (``--demo`` runs the reduced config).
``--prompt-len 0`` (the default) decodes from one random token, as the
reference does. ``--prompt-len T`` first runs the prefill step on T random
tokens, hands its caches to decode with ``cache_from_prefill`` and decodes
greedily from the prefill's own next token; for ``internvl2-1b`` the
prompt is [``num_patches`` random patch embeddings; T tokens] and decode
starts at index ``num_patches`` + T. Weights are random, from
seed 0 as in the reference. It prints the reference's lines (arch, params, ms/step, tok/s,
sampled ids) and, with a prompt, the prefill's ms. The default device is
cuda; without a GPU it raises rather than fall back to the CPU.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, get_reduced
from repro_torch.device import full_f32_matmul, resolve_device
from repro_torch.launch.steps import prefill, serve
from repro_torch.models import init_model, param_count


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def generate(model, prompt, steps: int, cache: int, patches=None):
    """Prefill ``prompt`` (B, T) when T > 1 (after ``patches`` (B, P, F),
    the vlm family's patch embeddings), else start from its one token;
    then ``steps`` greedy decode steps. Returns (tokens (B, 1 + steps),
    prefill seconds or None, seconds of the first step, seconds per step
    after it)."""
    dev = model.device
    b, t = prompt.shape
    t_pre = None
    batch = {"tokens": prompt}
    if patches is not None:
        batch["patch_embeds"] = patches
    n_pre = t + (0 if patches is None else patches.shape[1])
    start = n_pre if t > 1 else 0      # the index of the first decoded token
    if t > 1:
        _sync(dev)
        t0 = time.perf_counter()
        logits, caches = prefill(model, batch)
        state = model.cache_from_prefill(caches, b, cache, n_pre)
        tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
        _sync(dev)
        t_pre = time.perf_counter() - t0
    else:
        state = model.init_decode_state(b, cache)
        tok = prompt
    seqs = [tok]
    _sync(dev)
    t0 = time.perf_counter()
    t_first = 0.0
    for i in range(steps):
        tok, state = serve(model, seqs[-1], state, start + i)
        seqs.append(tok)
        if i == 0:
            _sync(dev)
            t_first = time.perf_counter() - t0
            t0 = time.perf_counter()
    _sync(dev)
    per_step = (time.perf_counter() - t0) / max(steps - 1, 1)
    return torch.cat(seqs, dim=1), t_pre, t_first, per_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--cache", type=int, default=128)
    ap.add_argument("--demo", action="store_true",
                    help="use the smoke-test-sized variant")
    ap.add_argument("--prompt-len", type=int, default=0,
                    help="prefill this many random tokens first (0: decode "
                         "from one random token)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_reduced(args.arch) if args.demo else get_config(args.arch)
    if not cfg.supports_decode:
        raise SystemExit(f"{args.arch} is encoder-only: no decode path")
    dev = resolve_device(args.device)
    full_f32_matmul()
    print(f"arch={cfg.name} layers={cfg.num_layers} d={cfg.d_model} "
          f"vocab={cfg.vocab_size} device={dev}")

    t0 = time.perf_counter()
    model = init_model(cfg, seed=0, device=dev)
    _sync(dev)
    print(f"init {param_count(model) / 1e6:.1f}M params in "
          f"{time.perf_counter() - t0:.1f}s")

    rng = np.random.default_rng(0)
    prompt = torch.as_tensor(
        rng.integers(0, cfg.vocab_size,
                     (args.batch, max(args.prompt_len, 1))),
        dtype=torch.int32, device=dev)
    patches = None
    if cfg.modality == "vision_text" and args.prompt_len > 1:
        patches = torch.as_tensor(
            rng.standard_normal((args.batch, cfg.num_patches,
                                 cfg.frontend_dim)), dtype=torch.float32,
            device=dev)
    out, t_pre, t_first, per_step = generate(model, prompt, args.steps,
                                             args.cache, patches)
    if t_pre is not None:
        what = (f"{args.prompt_len} tokens" if patches is None else
                f"{cfg.num_patches} patches + {args.prompt_len} tokens")
        print(f"prefill: {what} x batch {args.batch} in "
              f"{t_pre * 1e3:.1f} ms")
    print(f"first step: {t_first:.1f}s")
    print(f"steady-state: {per_step * 1e3:.0f} ms/step, batch {args.batch} "
          f"-> {args.batch / per_step:.1f} tok/s")
    print("sampled ids:", out.cpu().numpy()[:, :10])
    return out


if __name__ == "__main__":
    main()
