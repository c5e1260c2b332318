"""Dataset analytics (the reference's coverstats layer, L5)."""

from acoss_jax.analytics.coverstats import (  # noqa: F401
    get_cover_pairs,
    key_stats,
    key_table,
    tag_f_measure,
    tag_stats,
    tempo_stats,
    tempo_table,
)
from acoss_jax.analytics.onset_timing import (  # noqa: F401
    get_onset_means,
    lower_star_persistence,
    onset_pi_descriptor,
    onset_stdev_study,
    onset_timing_study,
    persistence_image,
)
from acoss_jax.analytics.song_structure import (  # noqa: F401
    get_shape_dna,
    shape_dna_study,
)
from acoss_jax.analytics.studies import (  # noqa: F401
    ALL_STUDIES,
    run_coverstats,
)
