"""Streaming SGPR (O-SGPR): Bui et al.'s collapsed streaming sparse GP
(port of ``online_gp_tpu/models/sgpr.py``).

The frozen quantities of the previous round are an explicit old state
carried through a pure :func:`sgpr_absorb` transition:

  C_b = K_bf K_fb / sigma^2 + (K_aa_old^-1 K_ab)^T C_a (K_aa_old^-1 K_ab)
  c_b = K_bf y / sigma^2 + K_ba K_aa_old^-1 m_a
        + (K_aa_old^-1 K_ab)^T C_a K_aa_old^-1 m_a
  m_b = K_bb (K_bb + C_b)^-1 c_b,  S_b = K_bb (K_bb + C_b)^-1 K_bb

with the collapsed streaming evidence bound :func:`sgpr_bound` as the
hyperparameter objective. Where the JAX package stops gradients, the port
detaches.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from online_gp_torch.kernels.base import Kernel
from online_gp_torch.ops.chol import cho_solve, chol_logdet, sym_psd_safe_cholesky, tri_solve
from online_gp_torch.ops.precision import f32_matmuls

LOG_2PI = 1.8378770664093453


class SGPRModel(NamedTuple):
    kernel: Kernel
    jitter: float = 1e-4

    def init_params(self, inducing_points, num_dims: Optional[int] = None, dtype=torch.float32, device="cuda",
                    **kw) -> Dict:
        z = torch.as_tensor(inducing_points, dtype=dtype, device=device).clone()
        return {
            "kernel": self.kernel.init_params(num_dims or z.shape[-1], (), dtype=dtype, device=device, **kw),
            "z": z,
            "raw_noise": torch.zeros((), dtype=dtype, device=device),
        }


class SGPROldState(NamedTuple):
    """The previous round's quantities, detached."""

    z: torch.Tensor  # (M, d)
    var_mean: torch.Tensor  # (M,)
    kernel_params: Dict  # the old kernel hypers
    C: torch.Tensor  # (M, M)
    c: torch.Tensor  # (M, 1) accumulated information vector


class SGPRMoments(NamedTuple):
    var_mean: torch.Tensor  # (M,)
    var_chol: torch.Tensor  # (M, M) lower Cholesky of S_b


def _jeye(n, like, eps):
    return eps * torch.eye(n, dtype=like.dtype, device=like.device)


def _frozen(tree):
    """A detached copy (the optimizers move the params in place)."""
    if isinstance(tree, dict):
        return {k: _frozen(v) for k, v in tree.items()}
    return tree.detach().clone()


def _projection(model: SGPRModel, params: Dict, old: SGPROldState, like: torch.Tensor):
    """(La, K_ab): the lower factor of K_aa_old + jitter and K(z_a, z_b)."""
    Kaa_old = model.kernel.matrix(old.kernel_params, old.z, old.z)
    Kaa_old = Kaa_old + _jeye(old.z.shape[0], like, model.jitter)
    La = sym_psd_safe_cholesky(Kaa_old, jitter=model.jitter)
    return La, model.kernel.matrix(params["kernel"], old.z, params["z"])


@f32_matmuls
def sgpr_c_matrix(model: SGPRModel, params: Dict, old: Optional[SGPROldState], x: torch.Tensor) -> torch.Tensor:
    """C_b (M, M): the reference's ``current_C_matrix``."""
    sigma2 = torch.exp(params["raw_noise"])
    Kbf = model.kernel.matrix(params["kernel"], params["z"], x)
    C = Kbf @ Kbf.T / sigma2
    if old is not None:
        La, Kab = _projection(model, params, old, C)
        P = cho_solve(La, Kab)
        C = C + P.T @ old.C @ P
    return C


@f32_matmuls
def sgpr_c_vec(model: SGPRModel, params: Dict, old: Optional[SGPROldState], x: torch.Tensor,
               y: torch.Tensor) -> torch.Tensor:
    """c_b (M, 1): the reference's ``current_c_vec``."""
    sigma2 = torch.exp(params["raw_noise"])
    Kbf = model.kernel.matrix(params["kernel"], params["z"], x)
    c = Kbf @ y.reshape(-1, 1) / sigma2
    if old is not None:
        La, Kab = _projection(model, params, old, c)
        Kaa_inv_ma = cho_solve(La, old.var_mean[:, None])
        P = cho_solve(La, Kab)
        c = c + Kab.T @ Kaa_inv_ma + P.T @ (old.C @ Kaa_inv_ma)
    return c


@f32_matmuls
def sgpr_pseudotargets(model: SGPRModel, old: SGPROldState) -> torch.Tensor:
    """K_aa_old C_old^-1 m_a + m_a, (M_a, 1)."""
    Kaa_old = model.kernel.matrix(old.kernel_params, old.z, old.z)
    Lc = sym_psd_safe_cholesky(old.C + _jeye(old.C.shape[0], old.C, model.jitter), jitter=model.jitter)
    ma = old.var_mean[:, None]
    return Kaa_old @ cho_solve(Lc, ma) + ma


@f32_matmuls
def sgpr_moments_from(model: SGPRModel, params: Dict, C: torch.Tensor, c: torch.Tensor) -> SGPRMoments:
    """m_b = K_bb (K_bb + C)^-1 c and the lower factor of
    S_b = K_bb (K_bb + C)^-1 K_bb."""
    z_b = params["z"]
    Kbb = model.kernel.matrix(params["kernel"], z_b, z_b)
    L = sym_psd_safe_cholesky(Kbb + C, jitter=model.jitter)
    m_b = (Kbb @ cho_solve(L, c))[:, 0]
    S_b = Kbb @ cho_solve(L, Kbb)
    return SGPRMoments(var_mean=m_b, var_chol=sym_psd_safe_cholesky(S_b, jitter=model.jitter))


@f32_matmuls
def sgpr_moments(model: SGPRModel, params: Dict, old: Optional[SGPROldState], x: torch.Tensor,
                 y: torch.Tensor) -> SGPRMoments:
    """The closed-form (m_b, S_b) on (x, y) after the old state."""
    C = sgpr_c_matrix(model, params, old, x)
    c = sgpr_c_vec(model, params, old, x, y)
    return sgpr_moments_from(model, params, C, c)


@f32_matmuls
def sgpr_absorb(
    model: SGPRModel,
    params: Dict,
    old: Optional[SGPROldState],
    moments: Optional[SGPRMoments],
    x: torch.Tensor,
    y: torch.Tensor,
    new_z: Optional[torch.Tensor] = None,
    rebase: bool = True,
) -> Tuple[Dict, SGPROldState, SGPRMoments]:
    """Absorb (x, y): returns (params, the next old state, the moments).

    ``rebase`` (or a first round) re-expresses the stored information
    through the K_aa_old^-1 projections, for hypers or z that moved since
    the last absorb; otherwise information adds exactly (C_total = C_old +
    K_bf K_fb / sigma^2, c_total likewise). ``new_z`` moves the inducing set
    and projects (m_a, C_a) onto it with an empty-batch round. ``moments``
    is unused, as in the JAX package.
    """
    del moments
    if rebase or old is None:
        C_total = sgpr_c_matrix(model, params, old, x).detach()
        c_total = sgpr_c_vec(model, params, old, x, y).detach()
    else:
        sigma2 = torch.exp(params["raw_noise"])
        Kbf = model.kernel.matrix(params["kernel"], params["z"], x)
        C_total = (old.C + Kbf @ Kbf.T / sigma2).detach()
        c_total = (old.c + Kbf @ y.reshape(-1, 1) / sigma2).detach()
    new_moments = sgpr_moments_from(model, params, C_total, c_total)
    new_old = SGPROldState(
        z=_frozen(params["z"]),
        var_mean=new_moments.var_mean.detach(),
        kernel_params=_frozen(params["kernel"]),
        C=C_total,
        c=c_total,
    )
    new_params = dict(params)
    if new_z is not None:
        new_params["z"] = torch.as_tensor(new_z)
        empty_x = torch.zeros((0, new_z.shape[-1]), dtype=x.dtype, device=x.device)
        empty_y = torch.zeros((0,), dtype=y.dtype, device=y.device)
        C_new = sgpr_c_matrix(model, new_params, new_old, empty_x).detach()
        c_new = sgpr_c_vec(model, new_params, new_old, empty_x, empty_y).detach()
        new_moments = sgpr_moments_from(model, new_params, C_new, c_new)
        new_old = SGPROldState(
            z=new_params["z"],
            var_mean=new_moments.var_mean.detach(),
            kernel_params=new_old.kernel_params,
            C=C_new,
            c=c_new,
        )
    return new_params, new_old, new_moments


@f32_matmuls
def sgpr_predict(model: SGPRModel, params: Dict, moments: SGPRMoments,
                 x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The unwhitened predictive f-moments at x from the stored (m_b, S_b)."""
    z = params["z"]
    Kzz = model.kernel.matrix(params["kernel"], z, z) + _jeye(z.shape[0], x, model.jitter)
    Kxz = model.kernel.matrix(params["kernel"], x, z)
    Lz = sym_psd_safe_cholesky(Kzz, jitter=model.jitter)
    A = cho_solve(Lz, Kxz.T)
    mean = A.T @ moments.var_mean
    half = tri_solve(Lz, Kxz.T)
    SA = torch.tril(moments.var_chol).T @ A
    kxx_diag = model.kernel.outputscale(params["kernel"]) * torch.ones(x.shape[0], dtype=x.dtype, device=x.device)
    var = kxx_diag - torch.sum(half * half, dim=0) + torch.sum(SA * SA, dim=0)
    return mean, torch.clamp(var, min=1e-10)


@f32_matmuls
def sgpr_bound(
    model: SGPRModel,
    params: Dict,
    old: Optional[SGPROldState],
    x: torch.Tensor,
    y: torch.Tensor,
    combine_terms: bool = True,
):
    """The collapsed streaming evidence bound (the reference's
    ``StreamingSGPRBound``). First round: log N(y; 0, Q1 + sigma^2 I) / n
    minus the trace correction. Later rounds: the log-prob of
    [y; pseudotargets] under blockdiag(Q1 + sigma^2 I, Q2 + Sigma2) and both
    trace terms. ``combine_terms=False`` returns (logp, trace, t1 / N,
    t2 / N)."""
    jitter = model.jitter
    sigma2 = torch.exp(params["raw_noise"])
    z_b = params["z"]
    n = x.shape[0]
    Kbf = model.kernel.matrix(params["kernel"], z_b, x)
    Kbb = model.kernel.matrix(params["kernel"], z_b, z_b) + _jeye(z_b.shape[0], x, jitter)
    Lb = sym_psd_safe_cholesky(Kbb, jitter=jitter)
    Q1 = Kbf.T @ cho_solve(Lb, Kbf)

    kff_diag = model.kernel.outputscale(params["kernel"]) * torch.ones(n, dtype=x.dtype, device=x.device)
    t1 = torch.sum(kff_diag - torch.diagonal(Q1)) / sigma2

    def logprob(cov, resid):
        L = sym_psd_safe_cholesky(cov + _jeye(cov.shape[0], cov, jitter), jitter=jitter)
        quad = torch.sum(tri_solve(L, resid[:, None]) ** 2)
        return -0.5 * (quad + chol_logdet(L) + resid.shape[0] * LOG_2PI)

    if old is None:
        covar = Q1 + sigma2 * torch.eye(n, dtype=x.dtype, device=x.device)
        logp = logprob(covar, y.reshape(-1)) / n
        trace = -t1 / 2.0 / n
        if combine_terms:
            return logp + trace
        return logp, trace, t1 / n, torch.zeros((), dtype=logp.dtype, device=logp.device)

    z_a = old.z
    Kba = model.kernel.matrix(params["kernel"], z_b, z_a)
    Kaa_old = model.kernel.matrix(old.kernel_params, z_a, z_a)
    Q2 = Kba.T @ cho_solve(Lb, Kba)
    Lc = sym_psd_safe_cholesky(old.C + _jeye(old.C.shape[0], x, jitter), jitter=jitter)
    Sigma2 = Kaa_old @ cho_solve(Lc, Kaa_old) + _jeye(z_a.shape[0], x, jitter)

    M_a = z_a.shape[0]
    zeros = torch.zeros((n, M_a), dtype=x.dtype, device=x.device)
    Q = torch.cat([torch.cat([Q1, zeros], 1), torch.cat([zeros.T, Q2], 1)], 0)
    eye_n = sigma2 * torch.eye(n, dtype=x.dtype, device=x.device)
    Sigma = torch.cat([torch.cat([eye_n, zeros], 1), torch.cat([zeros.T, Sigma2], 1)], 0)
    pseudo = sgpr_pseudotargets(model, old)[:, 0]
    y_hat = torch.cat([y.reshape(-1), pseudo])
    num_data = n + M_a
    logp = logprob(Q + Sigma, y_hat) / num_data

    LS2 = sym_psd_safe_cholesky(Sigma2, jitter=jitter)
    Kaa = model.kernel.matrix(params["kernel"], z_a, z_a)
    t2 = torch.trace(cho_solve(LS2, Kaa)) - torch.trace(cho_solve(LS2, Q2))
    trace = -(t1 + t2) / 2.0 / num_data
    if combine_terms:
        return logp + trace
    return logp, trace, t1 / num_data, t2 / num_data


def sgpr_resample_z(params: Dict, x_new: torch.Tensor, resample_ratio: float,
                    generator: torch.Generator) -> torch.Tensor:
    """The inducing-point refresh on absorb: a U(-1e-4, 1e-4) perturbation,
    then a ``resample_ratio`` share of z swapped for new inputs, every draw
    from ``generator`` (on the CPU; the result goes to z's device)."""
    z = params["z"].detach()
    noise = torch.rand(z.shape, generator=generator, dtype=z.dtype) * 2e-4 - 1e-4
    z = z + noise.to(z.device)
    num = int(min(resample_ratio * z.shape[0], x_new.shape[0]))
    if num <= 0:
        return z
    z_idx = torch.randperm(z.shape[0], generator=generator)[:num].to(z.device)
    x_idx = torch.randperm(x_new.shape[0], generator=generator)[:num].to(x_new.device)
    z = z.clone()
    z[z_idx] = x_new[x_idx].to(z.dtype)
    return z
