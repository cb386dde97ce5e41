"""The fit examples on the port (counterparts of `examples/fit_*.py`):
BRDF tables, sensor pose and scene geometry recovered by gradient descent
through `simulate_chunk` on the packet walk (K4 on the card).

Each module has ``build_problem(device)`` (the loss and the starting
parameters), ``fit(steps, device)`` and ``main(steps, device="cuda")``,
and runs as ``python -m lidar_brdf_tpu_torch.examples.<name>``.
"""

from __future__ import annotations

import time

import torch


def adam_fit(loss_fn, params0: torch.Tensor, lr: float, steps: int,
             report=None) -> dict:
    """``steps`` steps of `torch.optim.Adam` (optax.adam's defaults) on a
    leaf copy of ``params0``.  ``report(i, loss, params)`` is called after
    step ``i``.  Returns the final parameters, the loss before each
    step and the seconds per step (to a synchronize)."""
    p = params0.detach().clone().requires_grad_(True)
    opt = torch.optim.Adam([p], lr=lr)
    sync = ((lambda: torch.cuda.synchronize(p.device)) if p.is_cuda
            else (lambda: None))
    losses = []
    sync()
    t0 = time.perf_counter()
    for i in range(steps):
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(p)
        loss.backward()
        opt.step()
        losses.append(loss.detach())
        if report is not None:
            report(i, loss.detach(), p.detach())
    sync()
    seconds = time.perf_counter() - t0
    return dict(params=p.detach(), losses=[float(v) for v in losses],
                s_per_step=seconds / max(steps, 1))
