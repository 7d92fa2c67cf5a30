"""Datasets and their preprocessing (the port's own copies of
``online_gp_tpu/data``; numpy only, nothing is downloaded): the synthetic
generators, the UCI loaders with their flagged surrogates, the extra
classification sets, malaria and the file-format readers."""

from online_gp_torch.data.banana import banana_dataset
from online_gp_torch.data.classification_extra import criteo_dataset, svmguide1_dataset
from online_gp_torch.data.malaria import MalariaData, malaria_dataset
from online_gp_torch.data.preprocessing import balance_classes, minmax_scale, train_test_split, zscore
from online_gp_torch.data.synthetic import sin_cos_dataset, streaming_friedman
from online_gp_torch.data.uci import UCI_DATASETS, DatasetBundle, load_uci

__all__ = [
    "DatasetBundle",
    "MalariaData",
    "UCI_DATASETS",
    "balance_classes",
    "banana_dataset",
    "criteo_dataset",
    "load_uci",
    "malaria_dataset",
    "minmax_scale",
    "sin_cos_dataset",
    "streaming_friedman",
    "svmguide1_dataset",
    "train_test_split",
    "zscore",
]
