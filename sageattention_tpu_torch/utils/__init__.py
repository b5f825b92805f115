"""Accuracy comparators, the stage dumper and the profiling helpers: the
names of the JAX package's ``utils``, plus ``max_abs_err``."""

from sageattention_tpu_torch.utils.compare import (  # noqa: F401
    compare_report,
    cosine_similarity,
    max_abs_err,
    per_axis_cosine,
    rel_err_rate,
)
from sageattention_tpu_torch.utils.dump import StageDumper, load_dump  # noqa: F401
from sageattention_tpu_torch.utils.profiling import (  # noqa: F401
    StageTimer,
    trace,
)
