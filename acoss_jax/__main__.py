"""`python -m acoss_jax` -> the CLI (benchmark / extract)."""

from acoss_jax.cli import main

if __name__ == "__main__":
    raise SystemExit(main())
