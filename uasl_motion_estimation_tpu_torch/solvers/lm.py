"""Gauss-Newton / Levenberg-Marquardt engine as a batched masked loop.

Port of ``uasl_motion_estimation_tpu/solvers/lm.py``. The JAX solver is a
``lax.while_loop`` that callers ``vmap`` over independent problems; under
``vmap`` every problem stops on its own and its carry freezes from then on.
Here the batch is a leading dimension of ``x0`` and the loop keeps that
contract explicitly: each problem has its own stop code and iteration count,
a step updates only problems still active, and a frozen problem's state never
changes again. The loop leaves early once no problem is active: that test
reads one flag back from the device once per outer iteration (and once per
LM damping retry).
"""

from __future__ import annotations

import enum
from typing import Callable, NamedTuple

import torch

from ..utils import profiling


class StopCondition(enum.IntEnum):
    """Same set as the reference's StopCondition (rotation_utils.h:20)."""

    NO_STOP = 0
    SMALL_GRADIENT = 1
    SMALL_INCREMENT = 2
    MAX_ITERATIONS = 3
    SMALL_DECREASE_FUNCTION = 4
    SMALL_REPROJ_ERROR = 5
    NO_CONVERGENCE = 6


class LMConfig(NamedTuple):
    """Solver knobs; defaults mirror OptimisationParams (optimisation.h:31)
    and VisualOdometry::parameters (VisualOdometry.h:15-33)."""

    max_iter: int = 20
    use_lm: bool = True  # False -> pure Gauss-Newton
    minimize: bool = True  # False maximizes (MI scale optimiser)
    tau: float = 1e-3
    mu0: float = 1e-20
    v0: float = 2.0
    abs_tol: float = 1e-4  # e1: mean squared residual
    grad_tol: float = 1e-4  # e2: inf-norm of J^T r
    incr_tol: float = 1e-3  # e3: |dx| <= e3 * |x|
    rel_tol: float = 1e-4  # e4: squared cost decrease vs cost
    max_inner: int = 10  # LM damping retries per outer iteration


class LMResult(NamedTuple):
    x: torch.Tensor  # (..., K)
    cost: torch.Tensor  # (...)
    stop: torch.Tensor  # (...) int32 StopCondition value
    n_iter: torch.Tensor  # (...) int32
    success: torch.Tensor  # (...) bool


def _sel(mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """where(mask, a, b) with ``mask`` over the batch dims of a and b."""
    return torch.where(mask.reshape(mask.shape + (1,) * (a.ndim - mask.ndim)), a, b)


def _code(stop: StopCondition, like: torch.Tensor) -> torch.Tensor:
    return torch.full_like(like, int(stop))


def masked_solve(A: torch.Tensor, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched LU solve without a host check: (dx zeroed where not ok, ok).
    A singular system is not ok, as jnp.linalg.solve's inf/nan would be."""
    dx, info = torch.linalg.solve_ex(A, b[..., None])
    dx = dx[..., 0]
    ok = torch.all(torch.isfinite(dx), dim=-1) & (info == 0)
    return torch.where(ok[..., None], dx, torch.zeros_like(dx)), ok


def lm_solve(
    normal_eq_fn: Callable[[torch.Tensor], tuple[torch.Tensor, torch.Tensor, torch.Tensor]],
    x0: torch.Tensor,
    config: LMConfig = LMConfig(),
    update_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor] | None = None,
    cost_fn: Callable[[torch.Tensor], torch.Tensor] | None = None,
) -> LMResult:
    """Minimize (or maximize) a nonlinear least-squares objective for a batch
    of independent problems.

    Args:
      normal_eq_fn: x (..., K) -> (JJ (..., K, K), Jr (..., K), cost (...)).
        The step solves (JJ + mu I) dx = Jr.
      x0: initial parameters (..., K); leading dims are the batch.
      update_fn: manifold retraction; default additive.
      cost_fn: optional x -> cost only, for the LM trial steps.
    """
    update = update_fn or (lambda x, dx: x + dx)
    eval_cost = cost_fn or (lambda x: normal_eq_fn(x)[2])
    cfg = config
    sign = 1.0 if cfg.minimize else -1.0
    NO_STOP = int(StopCondition.NO_STOP)

    x = x0
    batch = x0.shape[:-1]
    k_dim = x0.shape[-1]
    dev, dtype = x0.device, x0.dtype
    cost = torch.full(batch, torch.inf, dtype=dtype, device=dev)
    mu = torch.full(batch, cfg.mu0, dtype=dtype, device=dev)
    v = torch.full(batch, cfg.v0, dtype=dtype, device=dev)
    stop = torch.zeros(batch, dtype=torch.int32, device=dev)
    k = torch.zeros(batch, dtype=torch.int32, device=dev)
    eye = torch.eye(k_dim, dtype=dtype, device=dev)

    trips = reads = 0
    for _ in range(cfg.max_iter):
        active = (stop == NO_STOP) & (k < cfg.max_iter)
        reads += 1
        if not bool(active.any()):
            break
        trips += 1
        JJ, Jr, cost_b = normal_eq_fn(x)
        stop_b = stop
        if cfg.minimize:
            stop_b = torch.where(cost_b < cfg.abs_tol,
                                 _code(StopCondition.SMALL_REPROJ_ERROR, stop_b), stop_b)
        stop_b = torch.where(torch.amax(torch.abs(Jr), dim=-1) < cfg.grad_tol,
                             _code(StopCondition.SMALL_GRADIENT, stop_b), stop_b)
        if cfg.use_lm:
            diag_max = torch.amax(torch.diagonal(JJ, dim1=-2, dim2=-1), dim=-1)
            mu_b = torch.where(k == 0, cfg.tau * torch.clamp(diag_max, min=cfg.mu0), mu)
        else:
            mu_b = mu

        if not cfg.use_lm:
            dx, ok = masked_solve(JJ, Jr)
            small_incr = (torch.linalg.norm(dx, dim=-1)
                          <= cfg.incr_tol * torch.linalg.norm(x, dim=-1))
            new_stop = torch.where(~ok, _code(StopCondition.NO_CONVERGENCE, stop_b), stop_b)
            new_stop = torch.where(ok & small_incr & (new_stop == NO_STOP),
                                   _code(StopCondition.SMALL_INCREMENT, new_stop), new_stop)
            take = ok & ~small_incr & (stop_b == NO_STOP)
            x_b = _sel(take, update(x, dx), x)
            v_b = v
        else:
            x_b, mu_b, v_b, new_stop = _lm_inner(
                JJ, Jr, cost_b, x, mu_b, v, stop_b, active, eye, update, eval_cost,
                cfg, sign)

        x = _sel(active, x_b, x)
        cost = torch.where(active, cost_b, cost)
        mu = torch.where(active, mu_b, mu)
        v = torch.where(active, v_b, v)
        stop = torch.where(active, new_stop, stop)
        k = k + active.to(torch.int32)

    stop = torch.where(stop == NO_STOP, _code(StopCondition.MAX_ITERATIONS, stop), stop)
    _, _, final_cost = normal_eq_fn(x)
    success = ((stop != int(StopCondition.NO_CONVERGENCE))
               & (stop != int(StopCondition.MAX_ITERATIONS)))
    profiling.count("lm.calls")
    profiling.count("lm.trips", trips)
    profiling.count("sync.lm", reads)
    return LMResult(x=x, cost=final_cost, stop=stop, n_iter=k, success=success)


def _lm_inner(JJ, Jr, cost, x, mu, v, stop, active, eye, update, eval_cost,
              cfg: LMConfig, sign: float):
    """LM damping loop (optimisation.cpp:236-270) for every problem at once;
    a problem leaves it when a step is accepted, it gives up, or it stops."""
    NO_STOP = int(StopCondition.NO_STOP)
    done = (stop != NO_STOP) | ~active
    inner_k = 0
    while not bool(done.all()):
        dx, ok = masked_solve(JJ + mu[..., None, None] * eye, Jr)
        small_incr = (torch.linalg.norm(dx, dim=-1)
                      <= cfg.incr_tol * torch.linalg.norm(x, dim=-1))
        x_test = update(x, dx)
        cost_test = eval_cost(x_test)
        denom = torch.sum(dx * (mu[..., None] * dx + Jr), dim=-1)
        rho = sign * (cost - cost_test) / torch.where(
            denom == 0, torch.full_like(denom, 1e-30), denom)
        accept = ok & (rho > 0) & ~small_incr

        small_dec = (cost - cost_test) ** 2 < cfg.rel_tol * torch.abs(cost)
        new_stop = torch.where(accept & small_dec,
                               _code(StopCondition.SMALL_DECREASE_FUNCTION, stop), stop)
        new_stop = torch.where(~ok, _code(StopCondition.NO_CONVERGENCE, new_stop), new_stop)
        new_stop = torch.where(ok & small_incr,
                               _code(StopCondition.SMALL_INCREMENT, new_stop), new_stop)
        mu_next = torch.where(
            accept, mu * torch.clamp(1.0 - (2.0 * rho - 1.0) ** 3, min=0.333), mu * v)
        v_next = torch.where(accept, torch.full_like(v, cfg.v0), 2.0 * v)
        x_next = _sel(accept, x_test, x)
        give_up = inner_k + 1 >= cfg.max_inner
        if give_up:
            new_stop = torch.where(~accept & (new_stop == NO_STOP),
                                   _code(StopCondition.NO_CONVERGENCE, new_stop), new_stop)
        done_next = accept | give_up | (new_stop != NO_STOP)

        live = ~done
        mu = torch.where(live, mu_next, mu)
        v = torch.where(live, v_next, v)
        x = _sel(live, x_next, x)
        stop = torch.where(live, new_stop, stop)
        done = done | done_next
        inner_k += 1
    profiling.count("lm.inner_trips", inner_k)
    profiling.count("sync.lm_inner", inner_k + 1)  # the loop leaves through its read
    return x, mu, v, stop
