"""Multi-restart MAP fitting of GP hyperparameters: one batched, lock-step
L-BFGS (``scamlgp_tpu/models/fit.py``).

The reference runs ``optax.lbfgs(memory_size=10)`` with
``scale_by_zoom_linesearch(max_linesearch_steps=20)`` under ``vmap`` for a
fixed number of steps and keeps the best finite iterate.  ``lbfgs_minimize``
is that algorithm (optax 0.2.6) written out over a batch: every batch
element (study x task x restart) has its own memory, step size and line
search, and all advance together.  A line-search trip evaluates the
objective once for the whole batch and syncs with the host once, to test
whether every element has finished.  With ``fixed_trips`` every line
search runs all ``max_linesearch_steps`` trips instead, the finished
elements frozen by the same mask, and nothing reads a tensor on the host:
the results are the same bits, and the fit can be captured in a CUDA
graph.  ``torch.optim.LBFGS`` serves one problem at a time, so it does
not serve here.

The objective maps a (B, P) tensor of flat raw parameters to (B,) values;
element b's value must depend on row b only.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

# optax.scale_by_zoom_linesearch defaults
_SLOPE_RTOL = 1e-4
_CURV_RTOL = 0.9
_APPROX_DEC_RTOL = 1e-6
_INTERVAL_THRESHOLD = 1e-5
_INCREASE_FACTOR = 2.0


class FitResult(NamedTuple):
    params: Any                   # best raw parameters (no restart axis)
    objective: torch.Tensor       # final objective of the winner
    all_objectives: torch.Tensor  # (..., R) final objectives


# ---------------------------------------------------------------------------
# parameter trees (NamedTuples of tensors, possibly nested)
# ---------------------------------------------------------------------------

def _is_node(tree) -> bool:
    return isinstance(tree, tuple) and hasattr(tree, "_fields")


def tree_leaves(tree) -> list:
    """The leaves of a tree, in order; plain tuples and lists (a function's
    several results) are walked as NamedTuples are."""
    if isinstance(tree, (tuple, list)):
        return [leaf for sub in tree for leaf in tree_leaves(sub)]
    return [tree]


def tree_map(fn: Callable, tree, *rest):
    if _is_node(tree):
        return type(tree)(*[tree_map(fn, *subs) for subs in zip(tree, *rest)])
    return fn(tree, *rest)


def flatten(tree, batch_ndim: int) -> torch.Tensor:
    """Concatenate the leaves behind their ``batch_ndim`` leading axes:
    (*batch, P)."""
    leaves = tree_leaves(tree)
    batch = leaves[0].shape[:batch_ndim]
    return torch.cat([leaf.reshape(batch + (-1,)) for leaf in leaves], dim=-1)


def unflatten(flat: torch.Tensor, like, batch_ndim: int):
    """Inverse of ``flatten`` with the leaf shapes of ``like``."""
    batch = flat.shape[:-1]
    leaves = tree_leaves(like)
    out, at = [], 0
    for leaf in leaves:
        tail = leaf.shape[batch_ndim:]
        size = 1
        for s in tail:
            size *= s
        out.append(flat[..., at:at + size].reshape(batch + tail))
        at += size
    it = iter(out)
    return tree_map(lambda _: next(it), like)


# ---------------------------------------------------------------------------
# batched L-BFGS with the zoom line search
# ---------------------------------------------------------------------------

def _vdot(a, b):
    return torch.sum(a * b, dim=-1)


def _value_and_grad(objective, x):
    x = x.detach().requires_grad_(True)
    with torch.enable_grad():
        v = objective(x)
        g, = torch.autograd.grad(v.sum(), x)
    return v.detach(), g.detach()


def _decrease_error(stepsize, value, slope, value_init, slope_init):
    dec = value - value_init - _SLOPE_RTOL * stepsize * slope_init
    approx = slope - (2 * _SLOPE_RTOL - 1.0) * slope_init
    delta = value - value_init - _APPROX_DEC_RTOL * torch.abs(value_init)
    dec = torch.minimum(torch.maximum(approx, delta), dec)
    dec = torch.clamp_min(dec, 0.0)
    return torch.where(torch.isnan(dec), torch.inf, dec)


def _curvature_error(slope, slope_init):
    curv = torch.clamp_min(torch.abs(slope) - _CURV_RTOL * torch.abs(slope_init),
                           0.0)
    return torch.where(torch.isnan(curv), torch.inf, curv)


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    C = fpa
    db = b - a
    dc = c - a
    denom = (db * dc) ** 2 * (db - dc)
    r0 = fb - fa - C * db
    r1 = fc - fa - C * dc
    A = (dc**2 * r0 + -(db**2) * r1) / denom
    B = (-(dc**3) * r0 + db**3 * r1) / denom
    radical = B * B - 3.0 * A * C
    return a + (-B + torch.sqrt(radical)) / (3.0 * A)


def _quadmin(a, fa, fpa, b, fb):
    db = b - a
    B = (fb - fa - fpa * db) / (db**2)
    return a - fpa / (2.0 * B)


def _where(cond, a, b):
    if a.ndim > cond.ndim:
        cond = cond[..., None]
    return torch.where(cond, a, b)


def _zoom_linesearch(objective, x, u, value, grad, stepsize_guess,
                     max_steps: int, fixed_trips: bool = False):
    """optax's zoom line search along u from x, per batch element.
    Returns the accepted (stepsize, value, grad) of each element.

    Every element is done or has failed after ``max_steps`` trips.  The
    loop ends when all are, or, with ``fixed_trips``, after ``max_steps``
    trips without a host sync; a finished element's state is kept either
    way, so both give the same bits."""
    B = x.shape[0]
    zeros = torch.zeros(B, dtype=x.dtype, device=x.device)
    false = torch.zeros(B, dtype=torch.bool, device=x.device)
    slope = _vdot(u, grad)
    value_init, slope_init = value, slope
    st = dict(stepsize=zeros, value=value, grad=grad, slope=slope,
              decrease_error=zeros + torch.inf, curvature_error=zeros + torch.inf,
              interval_found=false, done=false, failed=false,
              low=zeros, value_low=value, slope_low=slope,
              high=zeros, value_high=value, slope_high=slope,
              cubic_ref=zeros, value_cubic_ref=value,
              safe_stepsize=zeros, safe_value=value, safe_grad=grad)

    for count in range(max_steps):
        active = ~(st["done"] | st["failed"])
        if not fixed_trips and not bool(active.any()):   # the trip's sync
            break
        low, high = st["low"], st["high"]
        vlow, vhigh = st["value_low"], st["value_high"]
        slow, shigh = st["slope_low"], st["slope_high"]

        # search-interval candidate
        t_search = (stepsize_guess if count == 0
                    else _INCREASE_FACTOR * st["stepsize"])
        # zoom candidate
        delta = torch.abs(high - low)
        left = torch.minimum(high, low)
        right = torch.maximum(high, low)
        mc = _cubicmin(low, vlow, slow, high, vhigh, st["cubic_ref"],
                       st["value_cubic_ref"])
        use_cubic = (mc > left + 0.2 * delta) & (mc < right - 0.2 * delta)
        mq = _quadmin(low, vlow, slow, high, vhigh)
        use_quad = ~use_cubic & (mq > left + 0.1 * delta) & (
            mq < right - 0.1 * delta)
        use_bis = ~use_cubic & ~use_quad
        middle = torch.where(use_cubic, mc, st["cubic_ref"])
        middle = torch.where(use_quad, mq, middle)
        middle = torch.where(use_bis, (low + high) / 2.0, middle)

        zoom = st["interval_found"]
        t = torch.where(zoom, middle, t_search)
        v, g = _value_and_grad(objective, x + t[:, None] * u)
        s = _vdot(g, u)
        dec = _decrease_error(t, v, s, value_init, slope_init)
        curv = _curvature_error(s, slope_init)
        err = torch.maximum(dec, curv)
        done = err <= 0.0

        # search-interval branch (optax _search_interval)
        prev_t, prev_v, prev_s = st["stepsize"], st["value"], st["slope"]
        safe_dec = dec <= 0.0
        s_safe_t = torch.where(safe_dec, t, st["safe_stepsize"])
        s_safe_v = torch.where(safe_dec, v, st["safe_value"])
        s_safe_g = _where(safe_dec, g, st["safe_grad"])
        high_new = (dec > 0.0) | ((v >= prev_v) & (count > 0))
        low_new = (s >= 0.0) & ~high_new
        s_low = torch.where(low_new, t, prev_t)
        s_vlow = torch.where(low_new, v, prev_v)
        s_slow = torch.where(low_new, s, prev_s)
        s_high = torch.where(low_new, prev_t, t)
        s_vhigh = torch.where(low_new, prev_v, v)
        s_shigh = torch.where(low_new, prev_s, s)
        s_found = high_new | low_new | done
        s_failed = torch.full_like(done, count + 1 >= max_steps) & ~done

        # zoom branch (optax _zoom_into_interval)
        upd_safe = safe_dec & (v < st["safe_value"])
        z_safe_t = torch.where(upd_safe, t, st["safe_stepsize"])
        z_safe_v = torch.where(upd_safe, v, st["safe_value"])
        z_safe_g = _where(upd_safe, g, st["safe_grad"])
        high_to_mid = (dec > 0.0) | (v >= vlow)
        high_to_low = (s * (high - low) >= 0.0) & ~high_to_mid
        low_to_mid = ~high_to_mid
        h1 = torch.where(high_to_mid, t, high)
        vh1 = torch.where(high_to_mid, v, vhigh)
        sh1 = torch.where(high_to_mid, s, shigh)
        z_high = torch.where(high_to_low, low, h1)
        z_vhigh = torch.where(high_to_low, vlow, vh1)
        z_shigh = torch.where(high_to_low, slow, sh1)
        z_low = torch.where(low_to_mid, t, low)
        z_vlow = torch.where(low_to_mid, v, vlow)
        z_slow = torch.where(low_to_mid, s, slow)
        moved_high = high_to_mid | high_to_low
        z_cref = torch.where(moved_high, high, low)
        z_vcref = torch.where(moved_high, vhigh, vlow)
        too_small = delta <= _INTERVAL_THRESHOLD
        z_failed = ((count + 1 >= max_steps) | (too_small & (z_safe_t > 0.0))
                    ) & ~done

        new_low = torch.where(zoom, z_low, s_low)
        new_vlow = torch.where(zoom, z_vlow, s_vlow)
        new = dict(
            stepsize=t, value=v, grad=g, slope=s,
            decrease_error=dec, curvature_error=curv,
            interval_found=torch.where(zoom, zoom, s_found),
            done=done,
            failed=torch.where(zoom, z_failed, s_failed),
            low=new_low, value_low=new_vlow,
            slope_low=torch.where(zoom, z_slow, s_slow),
            high=torch.where(zoom, z_high, s_high),
            value_high=torch.where(zoom, z_vhigh, s_vhigh),
            slope_high=torch.where(zoom, z_shigh, s_shigh),
            cubic_ref=torch.where(zoom, z_cref, new_low),
            value_cubic_ref=torch.where(zoom, z_vcref, new_vlow),
            safe_stepsize=torch.where(zoom, z_safe_t, s_safe_t),
            safe_value=torch.where(zoom, z_safe_v, s_safe_v),
            safe_grad=_where(zoom, z_safe_g, s_safe_g),
        )
        # a failed search falls back to the safe step where there is one,
        # or where even the first step left the domain (optax _try_safe_step)
        take_safe = new["failed"] & ((new["safe_stepsize"] > 0.0)
                                     | torch.isinf(dec))
        new["stepsize"] = torch.where(take_safe, new["safe_stepsize"], t)
        new["value"] = torch.where(take_safe, new["safe_value"], v)
        new["grad"] = _where(take_safe, new["safe_grad"], g)

        for k, val in new.items():
            st[k] = _where(active, val, st[k])
    return st["stepsize"], st["value"], st["grad"]


def _lbfgs_direction(grad, dW, dU, rho, identity_scale, memory_idx: int):
    """Two-loop recursion of optax ``_precondition_by_lbfgs``."""
    m = rho.shape[0]
    order = [(memory_idx + i) % m for i in range(m)]
    vec = grad
    alphas = {}
    for idx in reversed(order):
        a = rho[idx] * _vdot(dW[idx], vec)
        vec = vec - a[:, None] * dU[idx]
        alphas[idx] = a
    vec = identity_scale[:, None] * vec
    for idx in order:
        b = rho[idx] * _vdot(dU[idx], vec)
        vec = vec + (alphas[idx] - b)[:, None] * dW[idx]
    return vec


def lbfgs_minimize(objective: Callable, x0: torch.Tensor, num_steps: int,
                   memory_size: int = 10, max_linesearch_steps: int = 20,
                   fixed_trips: bool = False):
    """``num_steps`` L-BFGS iterations from x0 (B, P), every row its own
    problem.  Returns (best params (B, P), objective there (B,)).
    ``fixed_trips``: every line search runs ``max_linesearch_steps`` trips
    and no step syncs with the host (``_zoom_linesearch``).

    As in the reference, the iterate kept is the one produced by the step
    taken from the best finite value seen.
    """
    B, P = x0.shape
    dt, dev = x0.dtype, x0.device
    x = x0.detach().clone()
    dW = torch.zeros(memory_size, B, P, dtype=dt, device=dev)
    dU = torch.zeros(memory_size, B, P, dtype=dt, device=dev)
    rho = torch.zeros(memory_size, B, dtype=dt, device=dev)
    prev_x = torch.zeros_like(x)
    prev_g = torch.zeros_like(x)
    lr = torch.ones(B, dtype=dt, device=dev)
    best_x = x.clone()
    best_v = torch.full((B,), torch.inf, dtype=dt, device=dev)
    value = grad = None
    for step in range(num_steps):
        if step == 0:
            value, grad = _value_and_grad(objective, x)
        # L-BFGS memory update (optax scale_by_lbfgs)
        memory_idx = step % memory_size
        prev_idx = (step - 1) % memory_size
        if step > 0:
            d_params = x - prev_x
            d_updates = grad - prev_g
            vd = _vdot(d_updates, d_params)
            weight = torch.where(vd == 0.0, torch.zeros_like(vd), 1.0 / vd)
            dW[prev_idx], dU[prev_idx], rho[prev_idx] = d_params, d_updates, weight
            den = _vdot(d_updates, d_updates)
            scale = torch.where(den > 0.0, vd / den, torch.ones_like(vd))
        else:
            scale = torch.clamp_max(1.0 / torch.sqrt(_vdot(grad, grad)), 1.0)
        u = -_lbfgs_direction(grad, dW, dU, rho, scale, memory_idx)
        prev_x, prev_g = x, grad
        lr, new_value, new_grad = _zoom_linesearch(
            objective, x, u, value, grad, lr, max_linesearch_steps,
            fixed_trips)
        x_new = x + lr[:, None] * u
        better = torch.isfinite(value) & (value < best_v)
        best_x = _where(better, x_new, best_x)
        best_v = torch.where(better, value, best_v)
        x, value, grad = x_new, new_value, new_grad
    with torch.no_grad():
        final = objective(best_x)
    return best_x, final


def fit_map_restarts(objective: Callable, init_stack, num_steps: int = 60,
                     memory_size: int = 10, batch_ndim: int = 0,
                     fixed_trips: bool = False) -> FitResult:
    """Minimize ``objective`` from a stack of initial points and keep, per
    batch element, the restart with the best final objective.

    Args:
        objective: fn(params) -> values, where params' leaves carry the
            leading (*batch, R) axes and values are (*batch, R).
        init_stack: parameters with leading (*batch, R) axes; restart 0 is
            conventionally the warm start.
        batch_ndim: number of batch axes in front of the restart axis.
        fixed_trips: ``lbfgs_minimize``'s, with no host sync.
    """
    x0 = flatten(init_stack, batch_ndim + 1)
    lead = x0.shape[:-1]

    def flat_objective(x):
        return objective(unflatten(x.reshape(lead + x.shape[-1:]),
                                   init_stack, batch_ndim + 1)).reshape(-1)

    best, values = lbfgs_minimize(flat_objective, x0.reshape(-1, x0.shape[-1]),
                                  num_steps, memory_size,
                                  fixed_trips=fixed_trips)
    values = values.reshape(lead)
    values = torch.where(torch.isfinite(values), values, torch.inf)
    idx = torch.argmin(values, dim=-1, keepdim=True)            # (*batch, 1)
    best = best.reshape(lead + best.shape[-1:])
    best = torch.gather(best, -2, idx[..., None].expand(
        idx.shape + best.shape[-1:])).squeeze(-2)
    like = tree_map(lambda leaf: leaf.select(batch_ndim, 0), init_stack)
    return FitResult(params=unflatten(best, like, batch_ndim),
                     objective=torch.gather(values, -1, idx).squeeze(-1),
                     all_objectives=values)


def stack_restarts(warm_params, sampled_params_stack, batch_ndim: int = 0):
    """Put a warm start in front of a prior-sampled restart stack, on the
    restart axis that follows the ``batch_ndim`` batch axes."""
    return tree_map(
        lambda w, s: torch.cat([w.unsqueeze(batch_ndim), s], dim=batch_ndim),
        warm_params, sampled_params_stack)
