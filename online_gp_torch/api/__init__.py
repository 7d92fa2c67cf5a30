"""Task-level API wrappers (the L5 surface): ``fit(x, y, num_epochs,
test_dataset)``, ``update(x, y, ...)``, ``predict(x)``, ``evaluate(x, y)``,
``set_lr(...)``, as in ``online_gp_tpu.api``: the stems,
``OnlineSKIRegression`` and ``OnlineSKIClassifier`` (each the dense core, or
the rank-capped one it routes to), ``OnlineSKILowRankRegression`` and
``OnlineSKILowRankClassifier``."""

from online_gp_torch.api.classification import OnlineSKIClassifier
from online_gp_torch.api.lowrank_classification import OnlineSKILowRankClassifier
from online_gp_torch.api.lowrank_regression import OnlineSKILowRankRegression
from online_gp_torch.api.regression import OnlineSKIRegression
from online_gp_torch.api.stems import IdentityStem, LinearStem, MLPStem, make_stem

__all__ = [
    "IdentityStem",
    "LinearStem",
    "MLPStem",
    "make_stem",
    "OnlineSKIClassifier",
    "OnlineSKILowRankClassifier",
    "OnlineSKILowRankRegression",
    "OnlineSKIRegression",
]
