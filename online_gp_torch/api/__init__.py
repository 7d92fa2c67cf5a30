"""Task-level API wrappers (the L5 surface): ``fit(x, y, num_epochs,
test_dataset)``, ``update(x, y, ...)``, ``predict(x)``, ``evaluate(x, y)``,
``set_lr(...)``, as in ``online_gp_tpu.api``: the stems,
``OnlineSKIRegression`` and ``OnlineSKIClassifier`` (each the dense core, or
the rank-capped one it routes to), ``OnlineSKILowRankRegression`` and
``OnlineSKILowRankClassifier``, and the online baselines: O-SVGP
(``OnlineSVGPRegression``, ``OnlineSVGPClassifier``), O-SGPR
(``OnlineSGPRegression``), the online exact GP (``OnlineExactRegression``,
``OnlineExactClassifier``) and the local-GP mixture
(``OnlineLocalGPRegression``)."""

from online_gp_torch.api.classification import OnlineSKIClassifier
from online_gp_torch.api.exact import OnlineExactClassifier, OnlineExactRegression
from online_gp_torch.api.localgp import OnlineLocalGPRegression
from online_gp_torch.api.lowrank_classification import OnlineSKILowRankClassifier
from online_gp_torch.api.lowrank_regression import OnlineSKILowRankRegression
from online_gp_torch.api.regression import OnlineSKIRegression
from online_gp_torch.api.sgpr_regression import OnlineSGPRegression
from online_gp_torch.api.stems import IdentityStem, LinearStem, MLPStem, make_stem
from online_gp_torch.api.svgp import OnlineSVGPClassifier, OnlineSVGPRegression

__all__ = [
    "IdentityStem",
    "LinearStem",
    "MLPStem",
    "make_stem",
    "OnlineExactClassifier",
    "OnlineExactRegression",
    "OnlineLocalGPRegression",
    "OnlineSGPRegression",
    "OnlineSKIClassifier",
    "OnlineSKILowRankClassifier",
    "OnlineSKILowRankRegression",
    "OnlineSKIRegression",
    "OnlineSVGPClassifier",
    "OnlineSVGPRegression",
]
