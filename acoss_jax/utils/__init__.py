"""Logging, timing and fault-tolerance utilities."""

from acoss_jax.utils.logging import ErrorFile, get_logger, timeit  # noqa: F401
