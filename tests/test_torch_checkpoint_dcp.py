"""The orbax role on ``torch.distributed.checkpoint``
(``online_gp_torch/utils/checkpoint.py``, ``backend="dcp"``), on the CPU.

- A tree of tensors (float32, float64, int64), numbers, strings, None, a
  NamedTuple, a list and a tuple round-trips bit for bit, exemplar-free
  and with ``like=``; a mismatched exemplar raises.
- Switching the backend at one path removes the other backend's payload,
  as the JAX package does for npz and orbax.
- A row-sharded WISKI state (DTensors from ``parallel.grid``) saved from 2
  spawned gloo ranks, one shard a rank, loads whole in this process, bit
  for bit the state the ranks sharded.
- ``backend="orbax"``, and a checkpoint the JAX package wrote through
  orbax, raise ValueError naming "dcp".

The spawned ranks import this module, so JAX is imported inside the tests
only.
"""

import json
import os
from typing import NamedTuple

import numpy as np
import pytest
import torch

from online_gp_torch.parallel.launch import spawn_ranks
from online_gp_torch.utils.checkpoint import load_pytree, save_pytree


class Pair(NamedTuple):
    a: torch.Tensor
    b: object


def _tree():
    g = torch.Generator().manual_seed(0)
    return {
        "x": torch.randn((3, 4), generator=g),
        "y": torch.randn((5,), generator=g, dtype=torch.float64),
        "pair": Pair(torch.arange(6).reshape(2, 3), None),
        "items": [1.5, "name", (torch.tensor(7), 3)],
    }


def _assert_same(got, want):
    if torch.is_tensor(want):
        assert torch.is_tensor(got) and got.dtype == want.dtype and torch.equal(got, want)
    elif isinstance(want, dict):
        assert list(got) == list(want)
        for k in want:
            _assert_same(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want)
        for a, b in zip(got, want):
            _assert_same(a, b)
    elif isinstance(want, str) or want is None:
        assert got == want
    else:
        assert float(got) == float(want)


def test_dcp_round_trip_is_bitwise(tmp_path):
    tree = _tree()
    path = str(tmp_path / "ckpt")
    save_pytree(path, tree, backend="dcp")
    assert os.path.isdir(path + ".dcp") and not os.path.exists(path + ".npz")
    with open(path + ".structure.json") as f:
        assert json.load(f)["backend"] == "dcp"
    _assert_same(load_pytree(path, device="cpu"), tree)
    _assert_same(load_pytree(path, like=tree, device="cpu"), tree)
    with pytest.raises(ValueError, match="structure mismatch"):
        load_pytree(path, like={"x": tree["x"]}, device="cpu")


def test_switching_backend_removes_the_stale_payload(tmp_path):
    tree = _tree()
    path = str(tmp_path / "ckpt")
    save_pytree(path, tree)
    save_pytree(path, tree, backend="dcp")
    assert not os.path.exists(path + ".npz") and os.path.isdir(path + ".dcp")
    save_pytree(path, tree, backend="npz")
    assert os.path.exists(path + ".npz") and not os.path.exists(path + ".dcp")
    _assert_same(load_pytree(path, device="cpu"), tree)


def test_orbax_raises_naming_dcp(tmp_path):
    from online_gp_tpu.utils.checkpoint import save_pytree as jax_save

    with pytest.raises(ValueError, match="dcp"):
        save_pytree(str(tmp_path / "a"), _tree(), backend="orbax")
    jax_save(str(tmp_path / "jax"), {"w": np.ones(3, np.float32)}, backend="orbax")
    with pytest.raises(ValueError, match="dcp"):
        load_pytree(str(tmp_path / "jax"), device="cpu")


def _state():
    from online_gp_torch.kernels.base import RBFKernel
    from online_gp_torch.models.wiski import WiskiModel, wiski_init
    from online_gp_torch.ops.grid import Grid

    rng = np.random.default_rng(3)
    grid = Grid.create([(-1.1, 1.1)], 16, dtype=torch.float64, device="cpu")
    model = WiskiModel(RBFKernel(), grid, num_outputs=1)
    x = torch.from_numpy(rng.uniform(-1, 1, (24, 1)))
    return wiski_init(model, x, torch.sin(2 * x), torch.ones((24, 1), dtype=torch.float64))


def _save_rank(rank, world, path):
    from online_gp_torch.parallel.grid import shard_wiski_state
    from online_gp_torch.parallel.mesh import make_mesh

    state = shard_wiski_state(_state(), make_mesh(axis_name="tp", device_type="cpu"), "tp")
    save_pytree(path, state, backend="dcp")
    return state.roots.root.to_local().shape


def test_row_sharded_state_saved_by_two_ranks_loads_whole(tmp_path):
    path = str(tmp_path / "state")
    shapes = spawn_ranks(_save_rank, 2, (path,), store=str(tmp_path / "store"))
    assert [tuple(s) for s in shapes] == [(1, 8, 16), (1, 8, 16)]
    assert len([f for f in os.listdir(path + ".dcp") if f.endswith(".distcp")]) == 2  # one file a rank
    want = _state()
    got = load_pytree(path, like=want, device="cpu")
    assert got.num_data == want.num_data and isinstance(got.num_data, int)
    for name in ("wty", "ydy", "d_logdet"):
        _assert_same(getattr(got, name), getattr(want, name))
    for a, b in zip(got.roots, want.roots):
        _assert_same(a, b)
