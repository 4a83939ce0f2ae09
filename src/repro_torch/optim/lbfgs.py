"""L-BFGS with two-loop recursion — the port of ``repro.optim.lbfgs``, the
paper's inner optimizer for the parallel PETSc experiments (§5.2).

History is stored as fixed-size (m, d) ring buffers on the device, with
the number of pairs stored (``count``) a device tensor too: a pair is
written with ``index_copy`` under ``torch.where(write, ...)``, and the two
loops of the recursion run over all m slots in Python with validity
masks, so a step never reads a value back to the host.  History is dropped
on ``reset_memory`` (batch expansion invalidates curvature pairs gathered
on the old objective).
"""
from __future__ import annotations

import dataclasses

import torch

from .api import BatchOptimizer, Objective, armijo_line_search, tree_axpy


@dataclasses.dataclass(frozen=True)
class LBFGS(BatchOptimizer):
    name: str = "lbfgs"
    history: int = 10
    max_ls_steps: int = 30

    def init(self, params):
        flat = params.reshape(-1).float()
        m, d, dev = self.history, flat.shape[0], flat.device
        return {
            "s": torch.zeros((m, d), dtype=torch.float32, device=dev),
            "y": torch.zeros((m, d), dtype=torch.float32, device=dev),
            "rho": torch.zeros((m,), dtype=torch.float32, device=dev),
            # pairs stored so far (saturates at m in use, not in value)
            "count": torch.zeros((), dtype=torch.int64, device=dev),
            "prev_flat": flat,
            "prev_grad": torch.zeros_like(flat),
            "have_prev": torch.zeros((), dtype=torch.bool, device=dev),
        }

    def reset_memory(self, state):
        return {**state,
                "s": torch.zeros_like(state["s"]),
                "y": torch.zeros_like(state["y"]),
                "rho": torch.zeros_like(state["rho"]),
                "count": torch.zeros_like(state["count"]),
                "have_prev": torch.zeros_like(state["have_prev"])}

    def _two_loop(self, state, g_flat):
        m = self.history
        count = state["count"]
        i = torch.arange(m, device=g_flat.device)
        # slot of the i-th newest pair: the ring's newest lives at
        # (count - 1) mod m; pairs beyond the stored ones are masked out
        order = torch.remainder(count - 1 - i, m)
        valid = i < torch.clamp(count, max=m)
        S, Y = state["s"].index_select(0, order), state["y"].index_select(0, order)
        rho = state["rho"].index_select(0, order)
        q = g_flat
        alphas = []
        for k in range(m):                      # newest to oldest
            a = torch.where(valid[k], rho[k] * torch.dot(S[k], q), 0.0)
            q = q - a * Y[k] * valid[k]
            alphas.append(a)
        # initial Hessian scaling gamma = s·y / y·y of the newest pair
        yy = torch.dot(Y[0], Y[0])
        gamma = torch.where((count > 0) & (yy > 1e-30),
                            torch.dot(S[0], Y[0]) / torch.clamp(yy, min=1e-30),
                            1.0)
        r = gamma * q
        for k in reversed(range(m)):            # oldest to newest
            b = torch.where(valid[k], rho[k] * torch.dot(Y[k], r), 0.0)
            r = r + (alphas[k] - b) * S[k] * valid[k]
        return r

    def step(self, params, state, objective: Objective, data):
        flat = params.reshape(-1).float()
        f0, g = objective.value_and_grad(params, data)
        g_flat = g.reshape(-1).float()

        # update history with the pair from the previous step
        s_vec = flat - state["prev_flat"]
        y_vec = g_flat - state["prev_grad"]
        sy = torch.dot(s_vec, y_vec)
        write = state["have_prev"] & (sy > 1e-12)
        idx = torch.remainder(state["count"], self.history).reshape(1)
        st = {**state,
              "s": torch.where(write, state["s"].index_copy(0, idx, s_vec[None]),
                               state["s"]),
              "y": torch.where(write, state["y"].index_copy(0, idx, y_vec[None]),
                               state["y"]),
              "rho": torch.where(write, state["rho"].index_copy(
                  0, idx, (1.0 / torch.clamp(sy, min=1e-30)).reshape(1)),
                  state["rho"]),
              "count": torch.where(write, state["count"] + 1, state["count"])}

        d_flat = -self._two_loop(st, g_flat)
        # descent safeguard
        descent = torch.dot(d_flat, g_flat) < 0
        d_flat = torch.where(descent, d_flat, -g_flat)
        direction = d_flat.reshape(params.shape)

        alpha, f_new, _ = armijo_line_search(
            objective, params, data, direction, g, f0=f0,
            alpha0=1.0, max_steps=self.max_ls_steps)
        new_params = tree_axpy(alpha, direction, params)
        # store the point at which g was evaluated, so next step's pair is
        # (x_{k+1}-x_k, g_{k+1}-g_k)
        new_state = {**st, "prev_flat": flat, "prev_grad": g_flat,
                     "have_prev": torch.ones_like(state["have_prev"])}
        return new_params, new_state, {"f": f_new, "alpha": alpha}
