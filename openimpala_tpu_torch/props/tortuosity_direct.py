"""Explicit baseline tortuosity solver, FTCS pseudo-time relaxation
(counterpart of ``openimpala_tpu/props/tortuosity_direct.py``; reference
``OpenImpala::TortuosityDirect``, ``src/props/TortuosityDirect.{H,cpp}``,
``Tortuosity_poisson_3d.F90``, ``Tortuosity_filcc.F90``; the reference
keeps it as a baseline, not wired into the app, ``TortuosityDirect.H:
30-33``):

* cell types: free = (phase == id) (``tortuosity_filct``);
* initial condition: the linear ramp on free cells, 0 elsewhere
  (``tortuosity_filic``);
* ghost fill: ``ext_dir`` vlo / vhi on the flow-direction faces,
  ``reflect_even`` on the side walls (``TortuosityDirect.cpp:397-408``).
  The reference fills every component with vlo / vhi at the ``ext_dir``
  faces, the cell type too (``tortuosity_filbc``), so the inlet ghost's
  cell type is ``nint(vlo)``: kept;
* face fluxes ``+d(phi)/dx``, zero where either cell is blocked
  (``tortuosity_poisson_flux``);
* forward Euler ``phi += dt * div(F)``, ``dt = 0.5 * min(dx^2) / 6``
  (``TortuosityDirect.cpp:160-164``);
* stop when the L1 change over free cells of one step is below ``eps``,
  measured after every ``plot_interval`` steps by one more step, so each
  check advances ``plot_interval + 1`` steps (``TortuosityDirect.cpp:
  172-200, 367-392``);
* tau = vf / rel_diff with the reference's placeholder vf = 1.0
  (``TortuosityDirect.cpp:129``), rel_diff = -avg_flux_density * L / dV.

The reference quirks are kept on purpose, as the JAX package keeps them:
``vlo = 0`` blocks the inlet (its ghost cell type is 0), and with the flux
sign ``+d(phi)/dx`` and vlo < vhi tau comes out NEGATIVE (the reference
warns and returns it, ``TortuosityDirect.cpp:143-146``).  Full-pore
discrete value: -(N + 1) / N.

No Pallas kernel stands behind this solver: plain PyTorch is its port.
The cell types and the blocked-face masks do not change across steps and
are made once.  On CUDA the ``plot_interval`` steps and the measuring step
run as one CUDA graph (``utils/graphs.py``, the counterpart of the JAX
package's jitted ``while_loop``) with one host read of (residual, done)
per replay.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..utils import graphs
from ..utils.common import parse_direction, resolve_device
from ..utils.profiling import request

CT_BLOCKED = 0  # Tortuosity_filcc.F90:15-16
CT_FREE = 1


@dataclasses.dataclass
class TortuosityDirectResult:
    value: float
    flux_in: float
    flux_out: float
    iterations: int
    residual: float
    converged: bool
    phi: object = None


def _ghost_pad(phi, ct, direction, vlo, vhi):
    """Pad with the reference's ghost values: ``ext_dir`` vlo / vhi along
    ``direction`` (phi AND ct: the filbc quirk), ``reflect_even``
    elsewhere.  ``ct`` may be None (phi alone)."""
    for ax in range(3):
        if ax == direction:
            shape = list(phi.shape)
            shape[ax] = 1
            lo = torch.full(shape, vlo, dtype=phi.dtype, device=phi.device)
            hi = torch.full(shape, vhi, dtype=phi.dtype, device=phi.device)
            phi = torch.cat([lo, phi, hi], dim=ax)
            if ct is not None:
                ct = torch.cat([torch.full(shape, int(round(vlo)),
                                           dtype=ct.dtype, device=ct.device),
                                ct,
                                torch.full(shape, int(round(vhi)),
                                           dtype=ct.dtype, device=ct.device)],
                               dim=ax)
        else:
            n = phi.shape[ax]
            phi = torch.cat([phi.narrow(ax, 0, 1), phi,
                             phi.narrow(ax, n - 1, 1)], dim=ax)
            if ct is not None:
                ct = torch.cat([ct.narrow(ax, 0, 1), ct,
                                ct.narrow(ax, n - 1, 1)], dim=ax)
    return phi, ct


def _faces(ax):
    """The (hi, lo) cell slices of the N + 1 faces along ``ax`` of a
    ghost-padded volume (the interior on the other axes)."""
    hi = [slice(1, -1)] * 3
    lo = [slice(1, -1)] * 3
    hi[ax] = slice(1, None)
    lo[ax] = slice(0, -1)
    return tuple(hi), tuple(lo)


def _blocked_faces(ct_p):
    """Per axis, the faces where either adjacent cell is blocked."""
    out = []
    for ax in range(3):
        hi, lo = _faces(ax)
        out.append((ct_p[hi] == CT_BLOCKED) | (ct_p[lo] == CT_BLOCKED))
    return out


def _face_fluxes(phi_p, blocked, dxinv):
    """Face-centred fluxes (N + 1 faces per axis), zero on a blocked face
    (``tortuosity_poisson_flux``)."""
    fluxes = []
    for ax in range(3):
        hi, lo = _faces(ax)
        d = dxinv[ax] * (phi_p[hi] - phi_p[lo])
        fluxes.append(torch.where(blocked[ax],
                                  torch.zeros((), dtype=d.dtype,
                                              device=d.device), d))
    return fluxes


def _divergence(fluxes, dxinv, dt):
    out = 0.0
    for ax, f in enumerate(fluxes):
        n = f.shape[ax]
        out = out + dt * dxinv[ax] * (f.narrow(ax, 1, n - 1)
                                      - f.narrow(ax, 0, n - 1))
    return out


def _step(phi, direction, vlo, vhi, blocked, dxinv, dt):
    phi_p, _ = _ghost_pad(phi, None, direction, vlo, vhi)
    return phi + _divergence(_face_fluxes(phi_p, blocked, dxinv), dxinv, dt)


def _interval(phi, free, direction, vlo, vhi, blocked, dxinv, dt, eps,
              interval: int):
    """``interval`` steps, then one more to measure the L1 change over free
    cells.  Returns the new phi, the residual and done."""
    for _ in range(interval):
        phi = _step(phi, direction, vlo, vhi, blocked, dxinv, dt)
    nxt = _step(phi, direction, vlo, vhi, blocked, dxinv, dt)
    res = torch.sum(torch.where(free, torch.abs(nxt - phi),
                                torch.zeros((), dtype=phi.dtype,
                                            device=phi.device)))
    return nxt, res, res < eps


def _solve_loop(free, phi0, direction, vlo, vhi, dxinv, dt, eps,
                n_steps: int, plot_interval: int, _graph=None):
    """The relaxation to ``eps`` or ``n_steps``, then the boundary flux
    sums (``tortuosity_poisson_fio``).  Returns ``(phi, steps, residual,
    done, flux_in, flux_out)``."""
    ct = torch.where(free, CT_FREE, CT_BLOCKED).to(torch.int8)
    _, ct_p = _ghost_pad(free.to(phi0.dtype), ct, direction, vlo, vhi)
    blocked = _blocked_faces(ct_p)  # the same at every step
    del ct, ct_p
    interval = max(1, int(plot_interval))
    eps_t = torch.full((), eps, dtype=phi0.dtype, device=phi0.device)

    def step(phi, res_t, done_t, eps_t):
        nxt, res, done = _interval(phi, free, direction, vlo, vhi, blocked,
                                   dxinv, dt, eps_t, interval)
        phi.copy_(nxt)
        res_t.copy_(res)
        done_t.copy_(done)

    def tail(phi, res_t, done_t, eps_t):
        return (torch.stack([res_t, done_t.to(res_t.dtype)]),)

    state = (phi0.clone(), torch.zeros((), dtype=torch.float64,
                                       device=phi0.device),
             torch.zeros((), dtype=torch.bool, device=phi0.device))
    it, res, done = 0, math.inf, False
    with graphs.solve_graph(phi0.device, _graph) as holder:
        if holder:
            holder.load(("direct", id(free), interval), step, tail, state,
                        (eps_t,))
        while not done and it < n_steps:
            if holder:
                (probe,) = holder.run()
            else:
                step(*state, eps_t)
                (probe,) = tail(*state, eps_t)
            res, done_v = probe.tolist()  # ONE read per interval
            done = done_v > 0
            it += interval + 1
        phi = (holder.state if holder else state)[0].clone()

    phi_p, _ = _ghost_pad(phi, None, direction, vlo, vhi)
    f = _face_fluxes(phi_p, blocked, dxinv)[direction]
    n = f.shape[direction]
    flux_in = torch.sum(f.narrow(direction, 0, 1))
    flux_out = torch.sum(f.narrow(direction, n - 1, 1))
    return phi, it, res, done, flux_in, flux_out


@request("tortuosity_direct")
def tortuosity_direct(
    phase,
    phase_id: int,
    direction,
    vlo: float = -1.0,
    vhi: float = 1.0,
    eps: float = 1e-6,
    n_steps: int = 100000,
    plot_interval: int = 100,
    dx=(1.0, 1.0, 1.0),
    dtype=torch.float64,
    return_fields: bool = False,
    device=None,
) -> TortuosityDirectResult:
    """Tortuosity of ``phase_id`` along ``direction`` of the (X, Y, Z)
    volume ``phase`` (numpy array or tensor) by explicit relaxation, with
    the reference's quirks (module docstring).  ``device``: None means
    CUDA, and raises where there is none; pass ``"cpu"`` to run on the
    CPU.  ``iterations`` counts the steps taken (a multiple of
    ``plot_interval + 1``); past ``n_steps`` without convergence the value
    is NaN."""
    dev = resolve_device(device)
    direction = parse_direction(direction)
    if not isinstance(phase, torch.Tensor):
        phase = torch.as_tensor(phase)
    free = (phase.to(dev) == phase_id).contiguous()
    shape = tuple(free.shape)

    n = shape[direction]
    extent = n - 1
    coord = torch.arange(n, dtype=dtype, device=dev)
    factor = 0.0 if extent == 0 else 1.0 / extent
    ramp = vlo + coord * factor * (vhi - vlo)
    ramp = ramp.reshape([-1 if a == direction else 1 for a in range(3)])
    phi0 = torch.where(free, ramp.expand(shape),
                       torch.zeros((), dtype=dtype, device=dev)).contiguous()

    dxinv = torch.tensor([1.0 / d for d in dx], dtype=dtype, device=dev)
    min_dx_sq = min(float(d) * float(d) for d in dx)
    dt = torch.tensor(0.5 * min_dx_sq / (2.0 * 3), dtype=dtype,
                      device=dev)  # TortuosityDirect.cpp:164

    phi, it, res, done, flux_in, flux_out = _solve_loop(
        free, phi0, direction, float(vlo), float(vhi), dxinv, dt, float(eps),
        int(n_steps), int(plot_interval))
    flux_in, flux_out = float(flux_in), float(flux_out)
    field = phi if return_fields else None

    if not done:
        return TortuosityDirectResult(
            value=math.nan, flux_in=flux_in, flux_out=flux_out,
            iterations=int(it), residual=float(res), converged=False,
            phi=field)

    fx = 0.5 * (flux_in + flux_out)
    others = [a for a in range(3) if a != direction]
    area = shape[others[0]] * shape[others[1]]  # cells, TortuosityDirect.cpp:108-113
    avg_flux_density = fx / area
    tol = 1e-15
    if abs(avg_flux_density) < tol:
        value = math.inf
    else:
        vf = 1.0  # the reference's placeholder, TortuosityDirect.cpp:129
        length = shape[direction] * float(dx[direction])
        dv = vhi - vlo
        if abs(dv) < tol or length <= 0:
            value = math.nan
        else:
            rel_diff = -avg_flux_density * length / dv
            value = math.inf if abs(rel_diff) < tol else vf / rel_diff

    return TortuosityDirectResult(
        value=value, flux_in=flux_in, flux_out=flux_out,
        iterations=int(it), residual=float(res), converged=True, phi=field)
