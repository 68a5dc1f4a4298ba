"""Spectral-norm / Lipschitz-constant estimation (counterpart of
``decomp_tpu.ops.spectral``).

ISTA/FISTA need L = lambda_max(A A^H). The default is power iteration from
a deterministic start, with a small safety margin so that the 1/L step is
valid even when the estimate is slightly low, capped by the Gershgorin
bound; ``method='eigh'`` is the exact dense eigensolver.
"""

import torch

from decomp_tpu_torch.utils.dtypes import real_dtype


def spectral_norm_psd(gram, *, iters: int = 60, method: str = "power",
                      safety: float = 1.02):
    """Largest eigenvalue of a Hermitian PSD matrix ``gram`` (n, n).

    method='power': ``iters`` power-iteration steps from the normalised
    ``linspace(1, 2, n)`` ramp, then the ||gram v||/||v|| bound scaled by
    ``safety`` and capped by the Hermitian inf-norm (Gershgorin) upper
    bound; if the gap between that bound and the Rayleigh quotient exceeds
    1% (the iteration has not converged), the upper bound is returned.
    method='eigh': exact ``torch.linalg.eigvalsh`` (no safety factor).

    For an adversarial gram whose top eigenvector is orthogonal to the
    start vector the estimate can undershoot undetected; pass an explicit
    ``lipschitz=`` to the solvers or use method='eigh' for such matrices.

    Returns a 0-d tensor of the real dtype of ``gram``.
    """
    rdt = real_dtype(gram.dtype)
    if method == "eigh":
        return torch.linalg.eigvalsh(gram)[-1].to(rdt)
    if method != "power":
        raise ValueError(f"unknown spectral-norm method {method!r}")

    n = gram.shape[-1]
    tiny = torch.tensor(torch.finfo(rdt).tiny, dtype=rdt, device=gram.device)
    ramp = torch.linspace(1.0, 2.0, n, dtype=rdt, device=gram.device)
    v = (ramp / torch.linalg.vector_norm(ramp)).to(gram.dtype)
    for _ in range(int(iters)):
        w = gram @ v
        v = w / torch.maximum(torch.linalg.vector_norm(w), tiny).to(rdt)
    # Guard the denominators: a zero gram drives v to 0, and 0/0 would
    # poison the solver with NaN instead of the harmless L = tiny.
    w = gram @ v
    vv = torch.maximum(torch.vdot(v, v).real, tiny)
    # Two lower bounds on lambda_max: the Rayleigh quotient and
    # ||gram v|| / ||v|| (>= Rayleigh, equal iff v is an eigenvector);
    # their relative gap certifies the power iteration.
    rayleigh = torch.vdot(v, w).real / vv
    matvec = torch.linalg.vector_norm(w).to(rdt) / torch.sqrt(vv)
    ub = torch.maximum(torch.max(torch.sum(torch.abs(gram), dim=-1)).to(rdt),
                       tiny)
    not_converged = (matvec - rayleigh) > 0.01 * torch.maximum(rayleigh, tiny)
    lam = torch.where(not_converged, ub, torch.minimum(matvec * safety, ub))
    return torch.maximum(lam, tiny).to(rdt)


def lipschitz_gram(a, *, iters: int = 60, method: str = "power",
                   safety: float = 1.02):
    """L = lambda_max(A A^H) for a dictionary ``a`` of shape (n_feat, n_ch),
    the Lipschitz constant of the gradient of 1/2 ||y - x A||^2."""
    gram = a @ a.conj().T
    return spectral_norm_psd(gram, iters=iters, method=method, safety=safety)
