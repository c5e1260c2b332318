"""`python -m` under the package's former name -> the acoss_jax CLI."""

from acoss_jax.cli import main

if __name__ == "__main__":
    raise SystemExit(main())
