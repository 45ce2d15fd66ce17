"""The Lambda minimax-game weightings of the CGL/CAP/Mix family.

Port of ``cglgan_tpu/algos/game.py``, batched: ``l`` and ``beta`` are
``(..., N)`` (one row per edge server), ``lam`` is ``(...)``; every softmax
runs over the last axis.  All inputs are detached.  See the reference
module for the formula of each mode.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class GameOut(NamedTuple):
    w: torch.Tensor          # constant per-client weights for the G objective
    lam_new: torch.Tensor    # updated Lambda
    f_beta: torch.Tensor     # diagnostics (0 where the variant defines none)
    f_gamma: torch.Tensor
    lam_coeff: torch.Tensor  # coefficient of -Lambda in F (0.0 or 0.001)


def game_step(mode: str, l, beta, lam, lr_lambda: float = 0.1) -> GameOut:
    l = l.detach()
    beta = torch.as_tensor(beta, dtype=l.dtype, device=l.device)
    lam = torch.as_tensor(lam, dtype=l.dtype, device=l.device)
    lam_b = lam.unsqueeze(-1)
    zero = torch.zeros_like(lam)
    coeff = torch.full_like(lam, 0.001)
    soft = lambda x: torch.softmax(x, dim=-1)
    dot = lambda a, b: torch.sum(a * b, dim=-1)

    if mode == "cgl_mean_game":
        gamma = soft(lam_b * l)
        f_gamma = dot(gamma, l)
        w = (beta + gamma) / 2.0
        grad = dot(l * l, gamma) - dot(l, gamma) * f_gamma
        return GameOut(w, lam + 10.0 * grad, dot(beta, l), f_gamma, zero)

    if mode == "cap_exp":
        inner = soft(lam_b * l)
        w = soft(inner * beta)
        return GameOut(w, lam + lr_lambda * 0.001, dot(beta, l),
                       dot(inner, l), coeff)

    if mode == "mix_bll":
        w = soft(beta * lam_b * l)
        return GameOut(w, lam + lr_lambda * 0.001, dot(beta, l), zero, coeff)

    if mode == "beta_gamma":
        gamma = soft(lam_b * l)
        w = soft(beta * gamma)
        return GameOut(w, lam + lr_lambda * 0.001, dot(beta, l),
                       dot(gamma, l), coeff)

    if mode == "beta":
        return GameOut(beta.expand_as(l), lam, dot(beta, l), zero, zero)

    if mode == "gamma":
        gamma = soft(lam_b * l)
        return GameOut(gamma, lam + lr_lambda * 0.001, zero, dot(gamma, l),
                       coeff)

    if mode == "mean":
        return GameOut(torch.ones_like(l), lam, zero, zero, zero)

    raise ValueError(f"unknown weighting mode {mode!r}")
