"""Learnable log-domain Sinkhorn optimal transport
(twin of ``rdmnet_tpu/nn/sinkhorn.py``).

The iterations run in ``ops/kernels/sinkhorn``; ``log_sinkhorn`` is the
plain iteration under the JAX package's public name. Inference (``use_kernel``):
the fused CUDA kernel for CUDA tensors, its plain version for CPU tensors.
Training: the plain version under autograd on either device, as the JAX
package trains through its scan. Float32 throughout.
"""

from __future__ import annotations

import torch
from torch import nn

from benchmark.reference.kernels import sinkhorn, sinkhorn_plain

INF = 1.0e12  # masks are -1e12, not -inf: fully masked patches stay finite


def log_sinkhorn(scores: torch.Tensor, log_mu: torch.Tensor, log_nu: torch.Tensor,
                 num_iterations: int) -> torch.Tensor:
    """The plain log-domain iteration on any leading dims, no dustbin:
    (*, M, N), (*, M), (*, N) -> (*, M, N). Plain PyTorch on every device
    (the JAX package's ``lax.scan`` path); the kernel route is
    ``LearnableLogOptimalTransport``."""
    return sinkhorn_plain(scores, log_mu, log_nu, num_iterations)


class LearnableLogOptimalTransport(nn.Module):
    """Scores (P, M, N) + row/col validity -> (P, M+1, N+1) log transport
    plan with a learnable dustbin score ``alpha``."""

    def __init__(self, num_iterations: int):
        super().__init__()
        self.num_iterations = num_iterations
        self.alpha = nn.Parameter(torch.tensor(1.0))

    def forward(self, scores: torch.Tensor, row_valid: torch.Tensor,
                col_valid: torch.Tensor, use_kernel: bool = True) -> torch.Tensor:
        p, num_row, num_col = scores.shape
        ones = torch.ones((p, 1), dtype=torch.bool, device=scores.device)
        pad_row_valid = torch.cat([row_valid, ones], dim=1)  # dustbin always valid
        pad_col_valid = torch.cat([col_valid, ones], dim=1)

        padded = torch.nn.functional.pad(scores, (0, 1, 0, 1))
        alpha = self.alpha.to(scores.dtype)
        padded[:, :, -1] = alpha  # in-place writes keep alpha's gradient
        padded[:, -1, :] = alpha
        valid_mat = pad_row_valid[:, :, None] & pad_col_valid[:, None, :]
        padded = torch.where(valid_mat, padded, torch.full_like(padded, -INF))

        # eps guards: fully masked (padded) correspondences must not give NaN
        nr = torch.clamp_min(row_valid.float().sum(dim=1), 1e-9)
        nc = torch.clamp_min(col_valid.float().sum(dim=1), 1e-9)
        norm = -torch.log(nr + nc)                                   # (P,)
        log_mu = norm[:, None].expand(p, num_row + 1).clone()
        log_mu[:, -1] = torch.log(nc) + norm
        log_nu = norm[:, None].expand(p, num_col + 1).clone()
        log_nu[:, -1] = torch.log(nr) + norm
        log_mu = torch.where(pad_row_valid, log_mu, torch.full_like(log_mu, -INF))
        log_nu = torch.where(pad_col_valid, log_nu, torch.full_like(log_nu, -INF))

        out = sinkhorn(padded, log_mu, log_nu, self.num_iterations, use_kernel=use_kernel)
        return out - norm[:, None, None]
