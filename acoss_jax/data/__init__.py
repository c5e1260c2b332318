"""Dataset layer: feature store, manifests, synthetic fixtures."""

from acoss_jax.data.store import FeatureSet, pad_stack  # noqa: F401
from acoss_jax.data.synthetic import make_synthetic_dataset  # noqa: F401
