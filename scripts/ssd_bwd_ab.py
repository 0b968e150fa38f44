"""Time the SSD backward kernel of one or more checkouts in turns, on one
card, at mamba2-370m's and zamba2-7b's train shapes.

    python3 scripts/ssd_bwd_ab.py DIR [DIR ...]

Each DIR is a checkout of this repo (for an A/B, the parent commit and the
change unpacked with ``git archive`` under the ignored ``build/``, given as
parent, change, change, parent). Each DIR in turn runs in a process of its
own with ``DIR/src`` first on the path: it builds that checkout's
``csrc/ssd_chunk_bwd.cu`` (into ``DIR/build/``), draws the inputs of
``chip_smoke.py``'s first two ``SSD_BWD_CASES`` (B and C views of the conv
output, ``ssd_chunk.grouped_bwd_example``) in f32 and bf16, holds
``ssd_intra_chunk_grouped_bwd_cuda`` against the twin (the error relative
to each gradient's largest |value|) and times it: the median of 20 calls,
CUDA events, the L2 flushed before each (``bench.timing.time_ms``). One
JSON line per checkout, shape and dtype; the card's name and power limit
first.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

# chip_smoke.py SSD_BWD_CASES's model shapes: name, Bz, NC, Q, H, G, N, P,
# offset of B in the conv output, log-decay steepness
CASES = (("mamba2-370m", 2, 16, 256, 32, 1, 128, 64, 2048, 0.2),
         ("zamba2-7b", 1, 16, 256, 112, 1, 64, 64, 7168, 0.2))
RUNS = 20


def child(turn: int, checkout: str) -> None:
    import torch
    from repro_torch.bench.timing import l2_flush, time_ms
    from repro_torch.kernels import ssd_chunk as sc
    dev = torch.device("cuda")
    flush = l2_flush(dev)
    for name, bz, nc, q, h, g, n, p, offset, steep in CASES:
        for dtype in (torch.float32, torch.bfloat16):
            args = sc.grouped_bwd_example(bz, nc, q, h, g, n, p,
                                          offset=offset, steep=steep,
                                          dtype=dtype, seed=q + h + n + p,
                                          device=dev)
            got = sc.ssd_intra_chunk_grouped_bwd_cuda(*args)
            want = sc.ssd_intra_chunk_grouped_bwd_plain(*args)
            rel = max(float((a.float() - w.float()).abs().max())
                      / max(1.0, float(w.float().abs().max()))
                      for a, w in zip(got, want))
            ms = time_ms(lambda: sc.ssd_intra_chunk_grouped_bwd_cuda(*args),
                         flush, RUNS)
            print(json.dumps({"turn": turn, "checkout": checkout,
                              "case": name, "dtype": str(dtype)[6:],
                              "ms": ms, "max_rel_err": rel}), flush=True)
            del args, got, want


def main(argv: list[str]) -> int:
    if len(argv) > 2 and argv[0] == "--child":
        child(int(argv[1]), argv[2])
        return 0
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(json.dumps({"card": smi}), flush=True)
    for turn, checkout in enumerate(argv):
        root = os.path.abspath(checkout)
        env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
        subprocess.run([sys.executable, os.path.abspath(__file__), "--child",
                        str(turn), checkout], env=env, cwd=root, check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
