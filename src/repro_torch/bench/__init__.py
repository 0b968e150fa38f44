"""The paper's harness and the port's benches (the reference's
``benchmarks/``, torch form): the Theorem-1 bound, Fig. 3-4, Table I and
the ablations, the kernel, engine, fused-round and round-perf benches,
the artifact differ and the ``python -m repro_torch.bench.run`` entry
point. Artifacts go to ``$REPRO_BENCH_OUT``, by default
``experiments/bench_torch``."""
