"""BayesOpt model adapters (port of ``online_gp_tpu/models/wiski_bayesopt.py``).

The reference's ``OnlineSKIBotorchModel`` is the object botorch
acquisitions talk to: ``posterior(X)``, ``fantasize(X, sampler)``
(mean-noise fantasies) and ``condition_on_observations``. The adapter
here exposes the same verbs over the functional WISKI core, and
:class:`SVGPBayesOptModel` the posterior of the SVGP core.

Draws: where the JAX adapter takes a PRNG key, ``sample`` and
``fantasize`` take the standard normals themselves (``base_samples``) or
a ``generator`` they are drawn from (on its own device, then moved).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch

from online_gp_torch.config import DEFAULT_CONFIG, SolverConfig
from online_gp_torch.models.svgp import svgp_predict
from online_gp_torch.models.wiski import (
    WiskiModel,
    WiskiState,
    wiski_condition,
    wiski_fantasize,
    wiski_mll,
    wiski_predict,
    wiski_predict_root,
)
from online_gp_torch.ops.chol import psd_safe_cholesky
from online_gp_torch.ops.root_update import RootCache


class WiskiPosterior(NamedTuple):
    mean: torch.Tensor  # (B, n)
    variance: torch.Tensor  # (B, n)
    cov_root: Optional[torch.Tensor]  # (B, n, k) joint-covariance root

    def sample(self, num_samples: int, base_samples: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """(S, B, n) posterior samples: joint through ``cov_root`` (base
        samples (S, B, k)), else independent marginals (base samples
        (S, B, n))."""
        width = self.mean.shape[-1] if self.cov_root is None else self.cov_root.shape[-1]
        shape = (num_samples, self.mean.shape[0], width)
        if base_samples is None:
            if generator is None:
                raise ValueError("sample needs base_samples or a generator")
            base_samples = torch.randn(shape, generator=generator, dtype=self.mean.dtype, device=generator.device)
        eps = base_samples.to(dtype=self.mean.dtype, device=self.mean.device)
        if self.cov_root is None:
            return self.mean[None] + torch.sqrt(self.variance)[None] * eps
        return self.mean[None] + torch.einsum("sbm,bnm->sbn", eps, self.cov_root)


def _flatten_fantasies(a: torch.Tensor, F: int, B: int) -> torch.Tensor:
    return a.reshape((F * B,) + tuple(a.shape[2:]))


class WiskiBayesOptModel:
    """Stateful adapter: posterior / fantasize / condition over the WISKI
    state. On the card ``condition_on_observations`` absorbs a single
    point through kernel K2, in place: the adapter it is called on gives
    its state up to the one it returns."""

    def __init__(self, model: WiskiModel, params: Dict, state: WiskiState, cfg: SolverConfig = DEFAULT_CONFIG):
        self.model = model
        self.params = params
        self.state = state
        self.cfg = cfg

    @property
    def num_outputs(self) -> int:
        return self.model.num_outputs

    def posterior(self, X, observation_noise: bool = False, joint: bool = False) -> WiskiPosterior:
        X = torch.as_tensor(X)
        if joint:
            mean, root = wiski_predict_root(self.model, self.params, self.state, X, self.cfg)
            var = torch.sum(root**2, dim=-1)
        else:
            mean, var = wiski_predict(self.model, self.params, self.state, X, self.cfg)
            root = None
        if observation_noise and self.model.learn_additional_noise:
            var = var + torch.exp(self.params["raw_second_noise"])[:, None]
        return WiskiPosterior(mean=mean, variance=var, cov_root=root)

    def fantasize(self, X, num_fantasies: int = 16, noise: Optional[torch.Tensor] = None,
                  base_samples: Optional[torch.Tensor] = None, generator: Optional[torch.Generator] = None):
        """Sample fantasy observations at X (from the joint posterior) and
        return an adapter whose output batch is the flattened F*B fantasy
        product (mean-noise fantasies), its model ``num_outputs=F*B``.
        Reshape its posteriors to (F, B, ...) with ``num_fantasies``."""
        X = torch.as_tensor(X)
        post = self.posterior(X, joint=True)
        samples = post.sample(num_fantasies, base_samples, generator)  # (F, B, q)
        q = X.shape[0]
        F, B = num_fantasies, self.num_outputs
        if noise is None:
            noise = torch.ones((q, B), dtype=X.dtype, device=X.device)
        fx = X[None].expand(F, *X.shape)
        fy = samples.transpose(-1, -2)  # (F, q, B)
        fn = noise[None].expand(F, q, B)
        st = wiski_fantasize(self.model, self.state, fx, fy, fn)
        flat = lambda a: None if a is None else _flatten_fantasies(a, F, B)
        flat_state = WiskiState(
            wty=flat(st.wty), ydy=flat(st.ydy),
            roots=RootCache(mat=flat(st.roots.mat), root=flat(st.roots.root), inv_root=flat(st.roots.inv_root)),
            d_logdet=flat(st.d_logdet), num_data=st.num_data,
        )
        flat_model = self.model._replace(num_outputs=F * B)

        def tile(tree):
            if isinstance(tree, dict):
                return {k: tile(v) for k, v in tree.items()}
            return tree[None].expand(F, *tree.shape).reshape((F * B,) + tuple(tree.shape[1:]))

        return WiskiBayesOptModel(flat_model, tile(self.params), flat_state, self.cfg)

    def condition_on_observations(self, X, Y, noise: Optional[torch.Tensor] = None) -> "WiskiBayesOptModel":
        X = torch.as_tensor(X)
        Y = torch.as_tensor(Y).reshape(X.shape[0], self.num_outputs)
        if noise is None:
            noise = torch.ones_like(Y)
        new_state = wiski_condition(self.model, self.state, X, Y, noise)
        return WiskiBayesOptModel(self.model, self.params, new_state, self.cfg)

    def mll(self) -> torch.Tensor:
        return wiski_mll(self.model, self.params, self.state, self.cfg)


class SVGPBayesOptModel:
    """Posterior adapter over the SVGP core, the reference's
    ``ApproximateGPyTorchModel``: the ``posterior(X, observation_noise=...)``
    that acquisition code needs of a variational model."""

    def __init__(self, model, params, cfg: SolverConfig = DEFAULT_CONFIG):
        self.model = model
        self.params = params
        self.cfg = cfg

    @property
    def num_outputs(self) -> int:
        return 1

    def posterior(self, X, observation_noise: bool = False, joint: bool = False) -> WiskiPosterior:
        X = torch.as_tensor(X)
        if joint:
            mean, cov = svgp_predict(self.model, self.params, X, self.cfg, full_cov=True)
            root = psd_safe_cholesky(cov, jitter=self.model.jitter)
            var = torch.diagonal(cov, dim1=-2, dim2=-1)
            post = WiskiPosterior(mean=mean[None], variance=var[None], cov_root=root[None])
        else:
            mean, var = svgp_predict(self.model, self.params, X, self.cfg)
            post = WiskiPosterior(mean=mean[None], variance=var[None], cov_root=None)
        if observation_noise and "raw_noise" in self.params:
            post = post._replace(variance=post.variance + torch.exp(self.params["raw_noise"]))
        return post
