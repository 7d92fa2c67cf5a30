"""Online / streaming SVGP (O-SVGP): the unwhitened variational GP core
(port of ``online_gp_tpu/models/svgp.py``).

The variational distribution is a plain parameter dict,

  params = { kernel hypers, mean_const, raw_noise (Gaussian likelihood),
             z (M, d) inducing points, var_mean (M,), var_chol (M, M) }

with pure functions for the unwhitened predictive, the (streaming) ELBO
and Bui et al.'s (1705.07131) streaming pieces:

- :func:`svgp_streaming_correction`: (KL[q_new(a) || q_old(a)] -
  KL[q_new(a) || p_old(a)]) * beta / n, with q_new(a) the current
  predictive at the old inducing points;
- :func:`svgp_snapshot`: the old variational and prior distributions at
  the old z (both floored by 1e-5 I);
- :func:`svgp_closed_form_update`: the O-SVGP moment update from
  pseudo-observations, and :func:`svgp_exact_estep`, the batch E-step.

Where the JAX package stops gradients, the port detaches.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from online_gp_torch.config import DEFAULT_CONFIG, SolverConfig
from online_gp_torch.kernels.base import Kernel
from online_gp_torch.likelihoods.bernoulli import bernoulli_probit_expected_log_prob
from online_gp_torch.ops.chol import cho_solve, chol_logdet, sym_psd_safe_cholesky, tri_solve
from online_gp_torch.ops.precision import f32_matmuls

LOG_2PI = 1.8378770664093453


class SVGPModel(NamedTuple):
    kernel: Kernel
    likelihood: str = "gaussian"  # or "bernoulli"
    jitter: float = 1e-5
    constant_mean: bool = False

    def init_params(self, inducing_points, num_dims: Optional[int] = None, dtype=torch.float32, device="cuda",
                    **kw) -> Dict:
        z = torch.as_tensor(inducing_points, dtype=dtype, device=device).clone()
        M, d = z.shape
        params = {
            "kernel": self.kernel.init_params(num_dims or d, (), dtype=dtype, device=device, **kw),
            "z": z,
            "var_mean": torch.zeros((M,), dtype=dtype, device=device),
            "var_chol": torch.eye(M, dtype=dtype, device=device),
        }
        if self.likelihood == "gaussian":
            params["raw_noise"] = torch.tensor(math.log(1.0), dtype=dtype, device=device)
        if self.constant_mean:
            params["mean_const"] = torch.zeros((), dtype=dtype, device=device)
        return params


def svgp_init_variational_to_prior(model: SVGPModel, params: Dict) -> Dict:
    """q(u) = p(u): var_chol becomes the factor of K_zz (gpytorch's
    unwhitened strategy at its first forward)."""
    z = params["z"]
    out = dict(params)
    out["var_chol"] = sym_psd_safe_cholesky(model.kernel.matrix(params["kernel"], z, z), jitter=model.jitter)
    return out


class SVGPOldState(NamedTuple):
    """The frozen snapshot the streaming correction reads."""

    z: torch.Tensor  # (M, d)
    var_mean: torch.Tensor  # (M,)
    var_cov: torch.Tensor  # (M, M)
    prior_mean: torch.Tensor  # (M,)
    prior_cov: torch.Tensor  # (M, M)


def _mean_fn(model: SVGPModel, params: Dict, x: torch.Tensor) -> torch.Tensor:
    if model.constant_mean:
        return params["mean_const"].expand(x.shape[0])
    return torch.zeros((x.shape[0],), dtype=x.dtype, device=x.device)


def _var_cov(params: Dict) -> torch.Tensor:
    L = torch.tril(params["var_chol"])
    return L @ L.T


@f32_matmuls
def svgp_predict(
    model: SVGPModel,
    params: Dict,
    x: torch.Tensor,
    cfg: SolverConfig = DEFAULT_CONFIG,
    full_cov: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The unwhitened predictive q(f(x)) = N(mu + Kxz Kzz^-1 (m - mu_z),
    Kxx - Kxz Kzz^-1 (Kzz - S) Kzz^-1 Kzx): mean (n,) and variance (n,), or
    the (n, n) covariance with ``full_cov``."""
    z = params["z"]
    Kzz = model.kernel.matrix(params["kernel"], z, z)
    Kxz = model.kernel.matrix(params["kernel"], x, z)
    Lz = sym_psd_safe_cholesky(Kzz, jitter=model.jitter)
    m_res = params["var_mean"] - _mean_fn(model, params, z)
    A = cho_solve(Lz, Kxz.T)
    mean = _mean_fn(model, params, x) + A.T @ m_res

    S = _var_cov(params)
    half = tri_solve(Lz, Kxz.T)
    SA = S @ A
    if full_cov:
        Kxx = model.kernel.matrix(params["kernel"], x, x)
        return mean, Kxx - half.T @ half + A.T @ SA
    kxx_diag = model.kernel.outputscale(params["kernel"]) * torch.ones(x.shape[0], dtype=x.dtype, device=x.device)
    var = kxx_diag - torch.sum(half * half, dim=0) + torch.sum(A * SA, dim=0)
    return mean, torch.clamp(var, min=1e-10)


def gaussian_expected_log_prob(y, mean, var, noise):
    """E_q[log N(y | f, noise)] per point, the noise floored at 1e-7."""
    noise = torch.clamp(noise, min=1e-7)
    return -0.5 * (LOG_2PI + torch.log(noise) + ((y - mean) ** 2 + var) / noise)


@f32_matmuls
def svgp_kl_to_prior(model: SVGPModel, params: Dict) -> torch.Tensor:
    """KL(q(u) || p(u)) with p(u) = N(mu_z, Kzz)."""
    z = params["z"]
    Lp = sym_psd_safe_cholesky(model.kernel.matrix(params["kernel"], z, z), jitter=model.jitter)
    Lq = torch.tril(params["var_chol"])
    m_res = (params["var_mean"] - _mean_fn(model, params, z))[:, None]
    half = tri_solve(Lp, Lq)
    trace = torch.sum(half * half)
    quad = torch.sum(tri_solve(Lp, m_res) ** 2)
    logdet_q = 2.0 * torch.sum(torch.log(torch.abs(torch.diagonal(Lq)) + 1e-20))
    return 0.5 * (trace + quad - z.shape[0] + chol_logdet(Lp) - logdet_q)


@f32_matmuls
def svgp_elbo(
    model: SVGPModel,
    params: Dict,
    x: torch.Tensor,
    y: torch.Tensor,
    num_data,
    beta: float = 1.0,
    cfg: SolverConfig = DEFAULT_CONFIG,
) -> torch.Tensor:
    """The scaled ELBO / num_data (gpytorch's ``VariationalELBO``: the mean
    expected log-likelihood minus beta * KL / num_data)."""
    mean, var = svgp_predict(model, params, x, cfg)
    if model.likelihood == "gaussian":
        ell = gaussian_expected_log_prob(y.reshape(-1), mean, var, torch.exp(params["raw_noise"]))
    else:
        ell = bernoulli_probit_expected_log_prob(y.reshape(-1), mean, var)
    return torch.mean(ell) - beta * svgp_kl_to_prior(model, params) / num_data


@f32_matmuls
def svgp_snapshot(model: SVGPModel, params: Dict) -> SVGPOldState:
    """Freeze the current variational and prior distributions at z, each
    covariance floored by 1e-5 I (an f32 Gram over clustered inducing points
    is indefinite at about that scale)."""
    z = params["z"].detach().clone()  # the optimizers move the params in place
    eye = torch.eye(z.shape[0], dtype=z.dtype, device=z.device)
    Kzz = model.kernel.matrix(params["kernel"], z, z) + 1e-5 * eye
    return SVGPOldState(
        z=z,
        var_mean=params["var_mean"].detach().clone(),
        var_cov=(_var_cov(params) + 1e-5 * eye).detach(),
        prior_mean=_mean_fn(model, params, z).detach(),
        prior_cov=Kzz.detach(),
    )


@f32_matmuls
def svgp_streaming_correction(
    model: SVGPModel,
    params: Dict,
    old: SVGPOldState,
    batch_size,
    online_beta: float = 1.0,
    cfg: SolverConfig = DEFAULT_CONFIG,
) -> torch.Tensor:
    """(KL[q_new(a) || q_old(a)] - KL[q_new(a) || p_old(a)]) * beta / n,
    computed as one difference: the -logdet of q_new's projected covariance
    S0 cancels, so S0 (often numerically singular) is never factored, only
    traces linear in it."""
    mean, cov = svgp_predict(model, params, old.z, cfg, full_cov=True)
    L_q = sym_psd_safe_cholesky(old.var_cov, jitter=1e-8)
    L_p = sym_psd_safe_cholesky(old.prior_cov, jitter=1e-8)
    eye = torch.eye(cov.shape[-1], dtype=cov.dtype, device=cov.device)
    tr_q = torch.sum(cho_solve(L_q, cov) * eye)
    tr_p = torch.sum(cho_solve(L_p, cov) * eye)
    quad_q = torch.sum(tri_solve(L_q, (old.var_mean - mean)[:, None]) ** 2)
    quad_p = torch.sum(tri_solve(L_p, (old.prior_mean - mean)[:, None]) ** 2)
    diff = 0.5 * ((tr_q - tr_p) + (quad_q - quad_p) + chol_logdet(L_q) - chol_logdet(L_p))
    return diff * online_beta / batch_size


def _noise(params: Dict, like: torch.Tensor) -> torch.Tensor:
    raw = params.get("raw_noise")
    if raw is None:
        return torch.ones((), dtype=like.dtype, device=like.device)
    return torch.exp(raw.detach())


@f32_matmuls
def svgp_closed_form_update(
    model: SVGPModel,
    params: Dict,
    new_x: torch.Tensor,
    new_y: torch.Tensor,
    new_z: Optional[torch.Tensor] = None,
) -> Dict:
    """Closed-form O-SVGP update (Bui et al.) in its explicitly PSD natural
    form:

      A   = K_bb + K_bx K_xb / sigma^2 + K_ba S_a^-1 K_ab - K_ba K_aa^-1 K_ab
      rhs = K_bx y / sigma^2 + K_ba S_a^-1 m_a
      m_b = K_bb A^-1 rhs,    S_b = K_bb A^-1 K_bb

    and, where z_b = z_a, A = K_ax K_xa / sigma^2 + K_aa S_a^-1 K_aa (the
    first and last terms cancel). Nothing reaches the gradient."""
    jitter = model.jitter
    z_a = params["z"].detach()
    kp = {k: v.detach() for k, v in params["kernel"].items()}
    noise = _noise(params, z_a)
    eye_a = torch.eye(z_a.shape[0], dtype=z_a.dtype, device=z_a.device)
    L_S = torch.tril(params["var_chol"].detach())
    m_a = params["var_mean"].detach()[:, None]
    K_aa = model.kernel.matrix(kp, z_a, z_a) + jitter * eye_a

    y = new_y.reshape(-1, 1)
    if new_z is None:
        z_b = z_a
        K_bx = model.kernel.matrix(kp, z_a, new_x)
        K_bb = K_aa
        W = tri_solve(L_S, K_aa)
        A = (K_bx @ K_bx.T) / noise + W.T @ W
        rhs = K_bx @ y / noise + K_aa @ cho_solve(L_S, m_a)
    else:
        z_b = torch.as_tensor(new_z)
        eye_b = torch.eye(z_b.shape[0], dtype=z_b.dtype, device=z_b.device)
        K_bx = model.kernel.matrix(kp, z_b, new_x)
        K_bb = model.kernel.matrix(kp, z_b, z_b) + jitter * eye_b
        K_ba = model.kernel.matrix(kp, z_b, z_a)
        L_K = sym_psd_safe_cholesky(K_aa, jitter=jitter)
        W = tri_solve(L_S, K_ba.T)
        V = tri_solve(L_K, K_ba.T)
        A = K_bb + (K_bx @ K_bx.T) / noise + W.T @ W - V.T @ V
        rhs = K_bx @ y / noise + K_ba @ cho_solve(L_S, m_a)

    A = 0.5 * (A + A.T)
    L_A = sym_psd_safe_cholesky(A, jitter=jitter, tries=5)
    new_mean = (K_bb @ cho_solve(L_A, rhs))[:, 0]
    T = tri_solve(L_A, K_bb)
    new_cov = T.T @ T
    new_cov = 0.5 * (new_cov + new_cov.T)

    out = dict(params)
    out["z"] = z_b
    out["var_mean"] = new_mean
    out["var_chol"] = sym_psd_safe_cholesky(new_cov, jitter=jitter, tries=5)
    return out


@f32_matmuls
def svgp_exact_estep(model: SVGPModel, params: Dict, x: torch.Tensor, y: torch.Tensor) -> Dict:
    """The batch-optimal q(u) at the current hypers (the variational-EM
    E-step): with Sigma = Kzz + Kzf Kfz / sigma^2,

      S = Kzz Sigma^-1 Kzz,   m = Kzz Sigma^-1 Kzf y / sigma^2

    (Titsias' collapsed posterior). Nothing reaches the gradient."""
    z = params["z"].detach()
    kp = {k: v.detach() for k, v in params["kernel"].items()}
    noise = _noise(params, z)
    eye = torch.eye(z.shape[0], dtype=z.dtype, device=z.device)
    Kzz = model.kernel.matrix(kp, z, z) + model.jitter * eye
    Kzf = model.kernel.matrix(kp, z, x)
    Sigma = Kzz + (Kzf @ Kzf.T) / noise
    Ls = sym_psd_safe_cholesky(Sigma, jitter=model.jitter)
    S = Kzz @ cho_solve(Ls, Kzz)
    m = (Kzz @ cho_solve(Ls, Kzf @ y.reshape(-1, 1))) / noise
    out = dict(params)
    out["var_mean"] = m[:, 0]
    out["var_chol"] = sym_psd_safe_cholesky(0.5 * (S + S.T), jitter=model.jitter, tries=5)
    return out
