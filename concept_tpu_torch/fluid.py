"""Fluid solvers: Kurganov-Tadmor and MacCormack, with the vacuum
corrections (port of concept_tpu/fluid.py; reference src/fluid.py:
kurganov_tadmor :103, flux limiters :590-688, maccormack :724, vacuum
handling :1079-1363).

The fluid equations in CONCEPT's comoving variables
(ϱ = a^{3(1+w_eff)}ρ, J = a⁴(ρ+c⁻²P)u; reference fluid.py:230, 310):

  ∂ₜϱ  = −a^{3w_eff−2} ∂ₘJᵐ                       (flux, this module)
        + 3(ȧ/a)(wϱ − c⁻²𝒫)                        (internal source)
  ∂ₜJᵐ = −a^{3w_eff−2} ∂ⁿ(JᵐJₙ/(ϱ + c⁻²𝒫))        (flux)
        −a^{−3w_eff} ∂ᵐ𝒫 − a^{−3w_eff} ∂ⁿςᵐₙ      (flux)
        −a^{−3w_eff}(ϱ + c⁻²𝒫) ∂ᵐφ                (gravity source)

Whole-grid MUSCL reconstructions on periodic ``torch.roll`` shifts with
the central-upwind (Rusanov) flux and the flux-limiter family, RK2
staged as the reference does.  The fields that share an axis's
reconstruction (ϱ, 𝒫, the three Jᵐ and ς) go through it stacked, one
batch of elementwise passes a field set; each element's arithmetic is
the JAX package's.  Coefficients and step sizes are host floats.

Over the ranks of a ``-n N`` run (``dist``, grid/fft.GridDistribution)
each rank holds its x-rows of every grid (``dist.rows``, which need not
split evenly).  The solvers then run the same whole-grid arithmetic on
the rows padded with the neighbours' rows (parallel/step.halo_rows) as
far as one evaluation reaches along x, and crop the halo: 2 rows a KT
evaluation (the interface state at i−½ reads i−2 … i+1, the divergence
adds i+½), 1 a MacCormack stage, 2 a vacuum pass.  Each RK or
predictor-corrector stage exchanges again on its own state, so every
cell sees the values and the order of operations of the whole grid, and
the rows are the whole grid's bit for bit.  The vacuum clamp
(:func:`vacuum_correct`) is pointwise and needs no halo.
"""

from __future__ import annotations

import torch

from concept_tpu_torch.parallel.step import halo_rows

_EPS = 1e-30
# packed shear components (xx, xy, xz, yy, yz, zz)
SIGMA_INDEX = {(0, 0): 0, (0, 1): 1, (0, 2): 2, (1, 1): 3, (1, 2): 4, (2, 2): 5}


# ----------------------------------------------------------------------- #
# Flux limiters (reference fluid.py:590-688)
# ----------------------------------------------------------------------- #
def _lim_minmod(r):
    return torch.clamp(torch.clamp(r, max=1.0), min=0.0)


def _lim_mc(r):
    return torch.clamp(torch.clamp(torch.minimum(2 * r, 0.5 * (1 + r)), max=2.0), min=0.0)


def _lim_ospre(r):
    return torch.clamp(1.5 * (r * r + r) / (r * r + r + 1), min=0.0)


def _lim_superbee(r):
    return torch.clamp(torch.maximum(torch.clamp(2 * r, max=1.0), torch.clamp(r, max=2.0)),
                       min=0.0)


def _lim_sweby(r, beta=1.5):
    return torch.clamp(torch.maximum(torch.clamp(beta * r, max=1.0),
                                     torch.clamp(r, max=beta)), min=0.0)


def _lim_umist(r):
    return torch.clamp(torch.minimum(torch.minimum(2 * r, 0.25 + 0.75 * r),
                                     torch.clamp(0.75 + 0.25 * r, max=2.0)), min=0.0)


def _lim_vanalbada(r):
    return torch.clamp((r * r + r) / (r * r + 1), min=0.0)


def _lim_vanleer(r):
    return (r + r.abs()) / (1 + r.abs())


def _lim_koren(r):
    return torch.clamp(torch.clamp(torch.minimum(2 * r, (1 + 2 * r) / 3), max=2.0), min=0.0)


FLUX_LIMITERS = {
    "minmod": _lim_minmod,
    "monotonizedcentral": _lim_mc,
    "mc": _lim_mc,
    "ospre": _lim_ospre,
    "superbee": _lim_superbee,
    "sweby": _lim_sweby,
    "umist": _lim_umist,
    "vanalbada": _lim_vanalbada,
    "vanleer": _lim_vanleer,
    "muscl": _lim_vanleer,
    "harmonic": _lim_vanleer,
    "koren": _lim_koren,
}


def _nonzero(d):
    """d, with |d| ≤ 1e-30 replaced by ±1e-30 of its sign."""
    return torch.where(d.abs() > _EPS, d, torch.where(d >= 0, _EPS, -_EPS).to(d.dtype))


def _interface_states(u, dim: int, limiter):
    """MUSCL left/right states at the interface i−½ along tensor dim
    ``dim`` (leading dims are a batch of fields):

      u_L = u[i−1] + ½φ(r_{i−1})(u[i] − u[i−1]),
      u_R = u[i]   − ½φ(r_i)(u[i+1] − u[i]),
      r_i = (u[i] − u[i−1])/(u[i+1] − u[i])."""
    um1 = torch.roll(u, 1, dim)
    um2 = torch.roll(u, 2, dim)
    up1 = torch.roll(u, -1, dim)
    d_m = um1 - um2
    d_c = u - um1
    d_p = up1 - u
    r_L = d_m / _nonzero(d_c)
    r_R = d_c / _nonzero(d_p)
    uL = um1 + 0.5 * limiter(r_L) * d_c
    uR = u - 0.5 * limiter(r_R) * d_p
    return uL, uR


def _kt_flux(uL, uR, fL, fR, vL, vR):
    """Central-upwind (Rusanov) flux: ½(f_L+f_R) − ½ max(v)(u_R−u_L)."""
    vmax = torch.maximum(vL, vR)
    return 0.5 * (fL + fR) - 0.5 * vmax * (uR - uL)


def _divergence(F, dim: int, dx: float):
    """(F[i+½] − F[i−½])/Δx of interface fluxes F stored at i−½."""
    return (torch.roll(F, -1, dim) - F) / dx


def kurganov_tadmor_update(varrho, J, P, dt, coef_flux: float, coef_pressure: float,
                           boxsize: float, soundspeed: float, c2_inv: float,
                           limiter: str = "mc", sigma=None):
    """One explicit KT evaluation: (Δϱ, ΔJ) per unit time from the flux
    terms.  J is (3, n, n, n) or a list of three grids; sigma the packed
    (6, n, n, n) shear or None.

    coef_flux     = ᔑa^{3w_eff−2}dt / ᔑdt  (time-averaged coefficient)
    coef_pressure = ᔑa^{−3w_eff}dt / ᔑdt
    soundspeed    = c·√w/a (global bound; reference fluid.py:131-137)
    c2_inv        = 1/c² (for ϱ + c⁻²𝒫 denominators)"""
    lim = FLUX_LIMITERS[limiter]
    n = varrho.shape[-1]  # x may hold a rank's rows with their halo
    dx = boxsize / n
    J = torch.stack(list(J)) if isinstance(J, (list, tuple)) else J
    fields = [varrho[None], P[None], J]
    if sigma is not None:
        fields.append(sigma)
    U = torch.cat(fields)  # ϱ, 𝒫, J⁰, J¹, J², (ς)
    drho = torch.zeros_like(varrho)
    dJ = torch.zeros_like(J)
    for axis in range(3):
        dim = axis - 3
        UL, UR = _interface_states(U, dim, lim)
        rhoL, rhoR, PL, PR = UL[0], UR[0], UL[1], UR[1]
        JL, JR = UL[2:5], UR[2:5]
        JnL, JnR = JL[axis], JR[axis]
        denL = rhoL + c2_inv * PL
        denR = rhoR + c2_inv * PR
        vL = (coef_flux * JnL / denL).abs() + soundspeed
        vR = (coef_flux * JnR / denR).abs() + soundspeed
        # continuity: the flux of ϱ along axis is coef_flux·Jₙ
        F = _kt_flux(rhoL, rhoR, coef_flux * JnL, coef_flux * JnR, vL, vR)
        drho = drho - _divergence(F, dim, dx)
        # Euler: the flux of Jᵐ along axis is coef_flux·JᵐJₙ/(ϱ+c⁻²𝒫),
        # + coef_pressure·𝒫 where m = axis, + coef_pressure·ςᵐₙ
        fL = coef_flux * JL * JnL / denL
        fR = coef_flux * JR * JnR / denR
        fL[axis] = fL[axis] + coef_pressure * PL
        fR[axis] = fR[axis] + coef_pressure * PR
        if sigma is not None:
            rows = [5 + SIGMA_INDEX[tuple(sorted((m, axis)))] for m in range(3)]
            fL = fL + coef_pressure * UL[rows]
            fR = fR + coef_pressure * UR[rows]
        F = _kt_flux(JL, JR, fL, fR, vL, vR)
        dJ = dJ - _divergence(F, dim, dx)
    return drho, dJ


def _on_rows(fn, fields: list, h: int, dist):
    """fn(*fields) on one device; over the ranks of ``dist`` fn of the
    fields' x-rows padded by h rows a side (:func:`halo_rows`, one
    exchange for the stacked fields), its outputs cropped back to the
    rows.  Each field is (R, n, n) or (c, R, n, n); None stays None."""
    if dist is None:
        return fn(*fields)
    present = [f for f in fields if f is not None]
    stacked = halo_rows(torch.cat([f.reshape(-1, *f.shape[-3:]) for f in present]), h, dist)
    pieces = iter(torch.split(stacked, [f.reshape(-1, *f.shape[-3:]).shape[0]
                                        for f in present]))
    padded = [None if f is None else next(pieces).reshape(*f.shape[:-3], -1, *f.shape[-2:])
              for f in fields]
    R = fields[0].shape[-3]
    return tuple(x[..., h:h + R, :, :] for x in fn(*padded))


def kt_step(varrho, J, P, dt, coef_flux, coef_pressure, boxsize: float, soundspeed,
            c2_inv: float, limiter: str = "mc", rk_order: int = 2,
            approx_P_eq_wrho: bool = False, w: float = 0.0, light_speed: float = 1.0,
            sigma=None, dist=None):
    """A full KT drift step (reference fluid.py:103-228): RK order 1, or
    2 (half step onto the starred state, full step evaluated there).
    With ``approx_P_eq_wrho`` the pressure is w·c²·ϱ of each stage, else
    P as given; sigma (packed) enters the momentum fluxes.  Returns
    (ϱ, J, 𝒫).  With ``dist`` the grids are this rank's x-rows, and each
    evaluation exchanges a halo of 2 rows of its own stage's state."""
    wc2 = w * light_speed**2

    def get_P(rho):
        return wc2 * rho if approx_P_eq_wrho else P

    def evaluate(rho, JJ, PP, ss):
        return kurganov_tadmor_update(rho, JJ, PP, dt, coef_flux, coef_pressure,
                                      boxsize, soundspeed, c2_inv, limiter, sigma=ss)

    def update(rho, JJ):
        JJ = torch.stack(list(JJ)) if isinstance(JJ, (list, tuple)) else JJ
        return _on_rows(evaluate, [rho, JJ, get_P(rho), sigma], 2, dist)

    drho, dJ = update(varrho, J)
    if rk_order == 1:
        rho1 = varrho + dt * drho
        return rho1, J + dt * dJ, get_P(rho1)
    drho2, dJ2 = update(varrho + 0.5 * dt * drho, J + 0.5 * dt * dJ)
    rho1 = varrho + dt * drho2
    return rho1, J + dt * dJ2, get_P(rho1)


# ----------------------------------------------------------------------- #
# MacCormack predictor-corrector (reference fluid.py:724-1078)
# ----------------------------------------------------------------------- #
def _upwind_diff(u, dim: int, direction: int):
    """One-sided difference: forward u[i+1]−u[i] (direction > 0) or
    backward u[i]−u[i−1]."""
    if direction > 0:
        return torch.roll(u, -1, dim) - u
    return u - torch.roll(u, 1, dim)


def _mc_flux_divergence(varrho, J, P, coef_flux, coef_pressure, dx, c2_inv, directions):
    """Σₙ ∂ₙ(fluxes) with one-sided differences per axis."""
    denom = varrho + c2_inv * P
    drho = torch.zeros_like(varrho)
    dJ = torch.zeros_like(J)
    for axis in range(3):
        dim = axis - 3
        d = directions[axis]
        drho = drho - _upwind_diff(coef_flux * J[axis], dim, d) / dx
        f = coef_flux * J * J[axis] / denom
        f[axis] = f[axis] + coef_pressure * P
        dJ = dJ - _upwind_diff(f, dim, d) / dx
    return drho, dJ


def maccormack_step(varrho, J, P, dt, coef_flux, coef_pressure, boxsize: float,
                    c2_inv: float, step_parity: int = 0, approx_P_eq_wrho: bool = True,
                    w: float = 0.0, light_speed: float = 1.0, dist=None):
    """One MacCormack predictor-corrector drift step: forward differences
    in the predictor and backward in the corrector, swapped on odd
    ``step_parity`` (the reference alternates them across steps).
    Returns (ϱ, J, 𝒫).  With ``dist`` the grids are this rank's x-rows,
    and each stage exchanges a halo of 1 row of its own state."""
    n = varrho.shape[-1]
    dx = boxsize / n
    wc2 = w * light_speed**2

    def get_P(rho):
        return wc2 * rho if approx_P_eq_wrho else P

    d_pred = [1 - 2 * (step_parity & 1)] * 3
    d_corr = [-d for d in d_pred]

    def stage(rho, JJ, directions):
        return _on_rows(lambda r, j, p: _mc_flux_divergence(r, j, p, coef_flux, coef_pressure,
                                                             dx, c2_inv, directions),
                        [rho, JJ, get_P(rho)], 1, dist)

    drho, dJ = stage(varrho, J, d_pred)
    rho_s = varrho + dt * drho
    J_s = J + dt * dJ
    drho2, dJ2 = stage(rho_s, J_s, d_corr)
    rho1 = 0.5 * (varrho + rho_s + dt * drho2)
    J1 = 0.5 * (J + J_s + dt * dJ2)
    return rho1, J1, get_P(rho1)


def vacuum_correct(varrho, J, rho_floor):
    """Clamp densities below ``rho_floor`` to it and zero J there (the
    non-conservative fallback after :func:`vacuum_redistribute`)."""
    ok = varrho >= rho_floor
    return torch.clamp(varrho, min=rho_floor), torch.where(ok[None], J, 0.0)


def vacuum_redistribute(varrho, J, rho_vacuum, smoothing: float = 1.0, passes: int = 2,
                        dist=None):
    """Mass-conserving vacuum correction (reference MacCormack vacuum
    machinery, fluid.py:1079-1363): cells below ``rho_vacuum`` and their
    6 face neighbours exchange symmetric diffusion fluxes, J smoothed the
    same way, for a fixed number of ``passes``.  Σϱ is conserved exactly
    (antisymmetric pair fluxes); what stays below is clamped by the
    caller.  With ``dist`` the grids are this rank's x-rows, and each
    pass exchanges a halo of 2 rows (``need`` is read at ±2 along x)."""
    rho, Jc = varrho, J
    for _ in range(passes):
        rho, Jc = _on_rows(lambda r, j: _vacuum_pass(r, j, rho_vacuum, smoothing),
                           [rho, Jc], 2, dist)
    return rho, Jc


def _vacuum_pass(rho, Jc, rho_vacuum, smoothing: float):
    """One pass of :func:`vacuum_redistribute` on whole (or padded) grids."""
    fac = smoothing / 12.0  # ≤ 1/12 per pair keeps the diffusion stable
    need = rho < rho_vacuum
    act = need
    for dim in (-3, -2, -1):
        act = act | torch.roll(need, 1, dim) | torch.roll(need, -1, dim)
    w = act.to(rho.dtype) * fac
    new_rho, new_J = rho, Jc
    for dim in (-3, -2, -1):
        for shift in (1, -1):
            w_pair = torch.maximum(w, torch.roll(w, shift, dim))
            new_rho = new_rho + w_pair * (torch.roll(rho, shift, dim) - rho)
            new_J = new_J + w_pair[None] * (torch.roll(Jc, shift, dim) - Jc)
    return new_rho, new_J


def hubble_source_rho(varrho, P, int_adot_over_a, w: float, c2_inv: float):
    """Internal source: Δϱ = 3ᔑ(ȧ/a)dt (wϱ − c⁻²𝒫) (reference
    fluid.py:701 via apply_internal_sources)."""
    return 3.0 * int_adot_over_a * (w * varrho - c2_inv * P)
