"""Benchmark harness, algorithms, and retrieval evaluation."""

from acoss_jax.benchmarking.evaluation import (  # noqa: F401
    EvalStats,
    eval_statistics,
)
