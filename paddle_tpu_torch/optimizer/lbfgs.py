"""L-BFGS with an optional strong-Wolfe line search (counterpart of
``paddle_tpu/optimizer/lbfgs.py``).

``step(closure)`` re-evaluates the loss through the caller's closure; a
two-loop recursion over the (s, y) history approximates the inverse
Hessian. The iteration is sequential on the host by nature: each
direction depends on the last loss and gradient, so the loop runs in
Python over one flat f32 vector of every parameter, the vector algebra
on the parameters' device and the scalar loss and convergence tests
read back, as in the JAX package.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from .optimizer import Optimizer

__all__ = ["LBFGS"]


def _cubic_interpolate(x1, f1, g1, x2, f2, g2, bounds=None):
    """Minimum of the cubic through (x1, f1, g1) and (x2, f2, g2),
    clipped to ``bounds``: the interpolation step of the strong-Wolfe
    zoom."""
    if bounds is not None:
        lo, hi = bounds
    else:
        lo, hi = min(x1, x2), max(x1, x2)
    d1 = g1 + g2 - 3 * (f1 - f2) / (x1 - x2)
    sq = d1 * d1 - g1 * g2
    if sq >= 0:
        d2 = np.sqrt(sq)
        if x1 <= x2:
            t = x2 - (x2 - x1) * ((g2 + d2 - d1) / (g2 - g1 + 2 * d2))
        else:
            t = x1 - (x1 - x2) * ((g1 + d2 - d1) / (g1 - g2 + 2 * d2))
        return min(max(t, lo), hi)
    return (lo + hi) / 2.0


def _dot(a, b) -> float:
    return float(torch.dot(a, b))


def _value(loss) -> float:
    return float(loss.detach()) if torch.is_tensor(loss) else float(loss)


def _strong_wolfe(obj_func, t, d, f, g, gtd, c1=1e-4, c2=0.9,
                  tolerance_change=1e-9, max_ls=25):
    """A step size along ``d`` meeting the strong Wolfe conditions
    (sufficient decrease and curvature): bracketing, then a zoom by cubic
    interpolation. ``obj_func(t)`` gives the loss and flat gradient at
    step ``t``. Returns ``(f_new, g_new, t, n_evals)``."""
    d_norm = float(d.abs().max())
    f0, g0, gtd0 = f, g, gtd
    t_prev, f_prev, g_prev, gtd_prev = 0.0, f0, g0, gtd0
    ls_iter = 0
    # bracketing
    while ls_iter < max_ls:
        f_new, g_new = obj_func(t)
        gtd_new = _dot(g_new, d)
        ls_iter += 1
        if f_new > f0 + c1 * t * gtd0 or (ls_iter > 1 and f_new >= f_prev):
            bracket = [(t_prev, f_prev, g_prev, gtd_prev),
                       (t, f_new, g_new, gtd_new)]
            break
        if abs(gtd_new) <= -c2 * gtd0:
            return f_new, g_new, t, ls_iter
        if gtd_new >= 0:
            bracket = [(t, f_new, g_new, gtd_new),
                       (t_prev, f_prev, g_prev, gtd_prev)]
            break
        t_next = _cubic_interpolate(t_prev, f_prev, gtd_prev, t, f_new,
                                    gtd_new, bounds=(2 * t, 10 * t))
        t_prev, f_prev, g_prev, gtd_prev = t, f_new, g_new, gtd_new
        t = t_next
    else:
        bracket = [(0.0, f0, g0, gtd0), (t, f_new, g_new, gtd_new)]
    # zoom
    while ls_iter < max_ls:
        lo, hi = (bracket[0], bracket[1]) \
            if bracket[0][1] <= bracket[1][1] else (bracket[1], bracket[0])
        if abs(hi[0] - lo[0]) * d_norm < tolerance_change:
            break
        t = _cubic_interpolate(bracket[0][0], bracket[0][1], bracket[0][3],
                               bracket[1][0], bracket[1][1], bracket[1][3])
        f_new, g_new = obj_func(t)
        gtd_new = _dot(g_new, d)
        ls_iter += 1
        if f_new > f0 + c1 * t * gtd0 or f_new >= lo[1]:
            bracket = [lo, (t, f_new, g_new, gtd_new)]
        else:
            if abs(gtd_new) <= -c2 * gtd0:
                return f_new, g_new, t, ls_iter
            if gtd_new * (hi[0] - lo[0]) >= 0:
                bracket = [(t, f_new, g_new, gtd_new), lo]
            else:
                bracket = [(t, f_new, g_new, gtd_new), hi]
    lo = bracket[0] if bracket[0][1] <= bracket[1][1] else bracket[1]
    return lo[1], lo[2], lo[0], ls_iter


class LBFGS(Optimizer):
    """``step(closure)`` minimizes the closure's loss with L-BFGS. The
    closure clears the gradients, computes the loss, calls
    ``backward()`` and returns the loss."""

    def __init__(self, learning_rate=1.0, max_iter=20, max_eval=None,
                 tolerance_grad=1e-7, tolerance_change=1e-9,
                 history_size=100, line_search_fn: Optional[str] = None,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay,
                         grad_clip, name)
        if line_search_fn not in (None, "strong_wolfe"):
            raise ValueError(
                f"line_search_fn must be None or 'strong_wolfe', "
                f"got {line_search_fn!r}")
        self._max_iter = max_iter
        self._max_eval = max_eval if max_eval is not None \
            else max_iter * 5 // 4
        self._tol_grad = tolerance_grad
        self._tol_change = tolerance_change
        self._history_size = history_size
        self._line_search_fn = line_search_fn
        # one quasi-Newton state over the flat vector, not per parameter
        self._state = {"n_func_evals": 0, "n_iter": 0,
                       "old_sk": [], "old_yk": [], "ro": [],
                       "d": None, "t": None, "prev_flat_grad": None,
                       "H_diag": 1.0}

    # ---- the flat vector ----
    def _flat_params(self):
        return torch.cat([p.detach().float().reshape(-1)
                          for p in self._parameter_list])

    def _flat_grad(self):
        return torch.cat([
            torch.zeros(p.numel(), dtype=torch.float32, device=p.device)
            if p.grad is None else p.grad.float().reshape(-1)
            for p in self._parameter_list])

    def _set_flat_params(self, flat):
        off = 0
        for p in self._parameter_list:
            n = p.numel()
            p.data.copy_(flat[off:off + n].reshape(p.shape))
            off += n

    def _evaluate(self, closure, x, t, d):
        """Loss and flat gradient at ``x + t * d``."""
        self._set_flat_params(x + t * d)
        return _value(closure()), self._flat_grad()

    @torch.no_grad()
    def step(self, closure: Callable = None):  # noqa: C901
        if closure is None:
            raise ValueError("LBFGS.step requires a closure that "
                             "re-evaluates the model and returns the loss")

        def run_closure():
            with torch.enable_grad():
                return closure()

        st = self._state
        lr = self.get_lr()
        orig_loss = run_closure()
        loss_f = _value(orig_loss)
        st["n_func_evals"] += 1
        current_evals = 1
        flat_grad = self._flat_grad()
        if float(flat_grad.abs().max()) <= self._tol_grad:
            return orig_loss

        n_iter = 0
        while n_iter < self._max_iter:
            n_iter += 1
            st["n_iter"] += 1
            # direction: the two-loop recursion over the history
            if st["n_iter"] == 1 or st["d"] is None:
                # d is None when an earlier step() stopped at the
                # directional-derivative test before its first move
                d = -flat_grad
                st["old_sk"], st["old_yk"], st["ro"] = [], [], []
                st["H_diag"] = 1.0
            else:
                y = flat_grad - st["prev_flat_grad"]
                s = st["d"] * st["t"]
                ys = _dot(y, s)
                if ys > 1e-10:
                    if len(st["old_yk"]) >= self._history_size:
                        st["old_yk"].pop(0)
                        st["old_sk"].pop(0)
                        st["ro"].pop(0)
                    st["old_yk"].append(y)
                    st["old_sk"].append(s)
                    st["ro"].append(1.0 / ys)
                    st["H_diag"] = ys / _dot(y, y)
                num = len(st["old_yk"])
                q = -flat_grad
                al = [0.0] * num
                for i in range(num - 1, -1, -1):
                    al[i] = _dot(st["old_sk"][i], q) * st["ro"][i]
                    q = q - al[i] * st["old_yk"][i]
                d = q * st["H_diag"]
                for i in range(num):
                    be_i = _dot(st["old_yk"][i], d) * st["ro"][i]
                    d = d + st["old_sk"][i] * (al[i] - be_i)
            st["prev_flat_grad"] = flat_grad

            # step size
            if st["n_iter"] == 1:
                t = min(1.0, 1.0 / float(flat_grad.abs().sum())) * lr
            else:
                t = lr
            gtd = _dot(flat_grad, d)
            if gtd > -self._tol_change:
                break

            if self._line_search_fn == "strong_wolfe":
                x_init = self._flat_params()
                loss_f, flat_grad, t, ls_evals = _strong_wolfe(
                    lambda tt: self._evaluate(run_closure, x_init, tt, d),
                    t, d, loss_f, flat_grad, gtd,
                    tolerance_change=self._tol_change)
                self._set_flat_params(x_init + t * d)
                current_evals += ls_evals
                st["n_func_evals"] += ls_evals
            else:
                self._set_flat_params(self._flat_params() + t * d)
                if n_iter != self._max_iter:
                    loss_f = _value(run_closure())
                    flat_grad = self._flat_grad()
                    current_evals += 1
                    st["n_func_evals"] += 1
            st["d"], st["t"] = d, t

            # convergence
            if current_evals >= self._max_eval:
                break
            if float(flat_grad.abs().max()) <= self._tol_grad:
                break
            if float((d * t).abs().max()) <= self._tol_change:
                break
        return orig_loss

    def state_dict(self):
        """The quasi-Newton state, whole: counters, ``H_diag``, ``ro``,
        the histories as ``old_sk_{i}``/``old_yk_{i}``, ``d``,
        ``prev_flat_grad`` and ``t``."""
        st = self._state
        sd = {"n_func_evals": st["n_func_evals"], "n_iter": st["n_iter"],
              "H_diag": st["H_diag"], "ro": list(st["ro"]),
              "global_step": self._global_step}
        for k in ("old_sk", "old_yk"):
            for i, v in enumerate(st[k]):
                sd[f"{k}_{i}"] = v.clone()
        for k in ("d", "prev_flat_grad"):
            if st[k] is not None:
                sd[k] = st[k].clone()
        if st["t"] is not None:
            sd["t"] = st["t"]
        return sd

    def set_state_dict(self, sd):
        st = self._state
        st["n_func_evals"] = int(sd.get("n_func_evals", 0))
        st["n_iter"] = int(sd.get("n_iter", 0))
        st["H_diag"] = float(sd.get("H_diag", 1.0))
        st["ro"] = list(sd.get("ro", []))
        self._global_step = int(sd.get("global_step", 0))
        for k in ("old_sk", "old_yk"):
            vals, i = [], 0
            while f"{k}_{i}" in sd:
                vals.append(torch.as_tensor(sd[f"{k}_{i}"]).clone())
                i += 1
            st[k] = vals
        for k in ("d", "prev_flat_grad"):
            if k in sd:
                st[k] = torch.as_tensor(sd[k]).clone()
        if "t" in sd:
            st["t"] = float(sd["t"])

    set_dict = set_state_dict
