"""Datasets the port's tests and smoke run need, generated with numpy alone
(the port's own copies; nothing is downloaded)."""

from online_gp_torch.data.banana import banana_dataset
from online_gp_torch.data.preprocessing import minmax_scale, train_test_split
from online_gp_torch.data.synthetic import sin_cos_dataset, streaming_friedman

__all__ = ["banana_dataset", "minmax_scale", "sin_cos_dataset", "streaming_friedman", "train_test_split"]
