"""Phong shading as Pallas kernels compiled through Triton: forward, and the
analytic backward.

XLA splits the plain shade (``shading.phong_core``, reference
raytrace_compute.glsl:789-840) and its autodiff transpose into a dozen
fusions that pass (rays, 4) per-light intermediates through device memory;
in the trace of the c3 fwd+bwd step they took 4x the time their bytes take
at the card's peak bandwidth. Here each program shades BR rays in
registers: the material row, hit point, normal, ray direction and occlusion
bits are read once and only the RGB (forward) or the cotangents (backward)
are written. The backward recomputes the Phong chain and emits the
hand-derived cotangents in one pass — per-ray material-row, hit-point,
normal and direction gradients, and per-program light-parameter partial
sums (reduced in XLA). Rows are read in their (rays, C) layout with strided
column loads, so no transpose runs around the kernels.

Gradients match jax.vjp(phong_core) almost everywhere: max/select gates
take the strict-inequality branch, identical away from measure-zero ties.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from openglraytracer_tpu.ops.intersect import _SQRT_EPS
from openglraytracer_tpu.ops.pallas_culled import (BLOCK_RAYS, _triton_call,
                                                   _whole)
from openglraytracer_tpu.ops.shading import _POW_EPS

# light table row (16): [pos(3) pad amb(4) diff(4) spec(4)]; the backward's
# per-light partial sums use the same layout (slot 3 unused)
_LG = 16


def _lights(lpos, lamb, ldiff, lspec):
    lg = jnp.zeros((lpos.shape[0], _LG), lpos.dtype)
    return (lg.at[:, 0:3].set(lpos).at[:, 4:8].set(lamb)
            .at[:, 8:12].set(ldiff).at[:, 12:16].set(lspec))


def _light_terms(lg_ref, j, px, py, pz, nx, ny, nz, vx, vy, vz, m_shin):
    """The per-light Phong chain; returns every intermediate the backward
    needs."""
    tlx = lg_ref[j, 0] - px
    tly = lg_ref[j, 1] - py
    tlz = lg_ref[j, 2] - pz
    stl = tlx * tlx + tly * tly + tlz * tlz
    inv_tl = jax.lax.rsqrt(jnp.maximum(stl, _SQRT_EPS))
    ldx, ldy, ldz = tlx * inv_tl, tly * inv_tl, tlz * inv_tl
    # reflect(-l, n), then _safe_normalize
    dn = -(ldx * nx + ldy * ny + ldz * nz)
    rx0 = -ldx - 2.0 * dn * nx
    ry0 = -ldy - 2.0 * dn * ny
    rz0 = -ldz - 2.0 * dn * nz
    sr = rx0 * rx0 + ry0 * ry0 + rz0 * rz0
    inv_r = jax.lax.rsqrt(jnp.maximum(sr, _SQRT_EPS))
    rx, ry, rz = rx0 * inv_r, ry0 * inv_r, rz0 * inv_r
    ct_raw = ldx * nx + ldy * ny + ldz * nz
    cos_phi = vx * rx + vy * ry + vz * rz
    # _safe_pow: pow(max(base, eps), e), gated to 0 at base <= 0
    sb = jnp.maximum(cos_phi, _POW_EPS)
    logsb = jnp.log(sb)
    val = jnp.exp(m_shin * logsb)
    powv = jnp.where(cos_phi > 0.0, val, 0.0)
    return dict(stl=stl, inv_tl=inv_tl, ld=(ldx, ldy, ldz), dn=dn, sr=sr,
                inv_r=inv_r, r=(rx, ry, rz), ct_raw=ct_raw,
                cos_theta=jnp.maximum(ct_raw, 0.0), cos_phi=cos_phi, sb=sb,
                logsb=logsb, val=val, powv=powv)


def _phong(lg_ref, terms, m_amb, m_dif, m_spe, m_emi):
    """ambient + diffuse + specular + emissive, each summed over the lights
    in phong_core's order (so the kernel rounds like the XLA path); also
    stores each light's lit * cos_theta and lit * pow terms."""
    zero = jnp.zeros_like(m_amb[0])
    amb, dif, spe = [zero] * 4, [zero] * 4, [zero] * 4
    for j, t in enumerate(terms):
        t["lit_ct"] = t["lit"] * t["cos_theta"]
        t["lit_pw"] = t["lit"] * t["powv"]
        for c in range(4):
            amb[c] = amb[c] + lg_ref[j, 4 + c] * m_amb[c]
            dif[c] = dif[c] + t["lit"] * lg_ref[j, 8 + c] * m_dif[c] \
                * t["cos_theta"]
            spe[c] = spe[c] + t["lit"] * lg_ref[j, 12 + c] * m_spe[c] \
                * t["powv"]
    return [amb[c] + dif[c] + spe[c] + m_emi[c] for c in range(4)]


def _load_rays(mat_ref, d_ref, p_ref, n_ref):
    cols = [mat_ref[:, c] for c in range(17)]
    dx, dy, dz = d_ref[:, 0], d_ref[:, 1], d_ref[:, 2]
    sd = dx * dx + dy * dy + dz * dz
    inv_d = jax.lax.rsqrt(jnp.maximum(sd, _SQRT_EPS))
    view = (-dx * inv_d, -dy * inv_d, -dz * inv_d)   # normalize(-d) (:827)
    p = (p_ref[:, 0], p_ref[:, 1], p_ref[:, 2])
    n = (n_ref[:, 0], n_ref[:, 1], n_ref[:, 2])
    return cols, sd, inv_d, view, p, n


def _shade_kernel(n_lights: int, lg_ref, mat_ref, d_ref, p_ref, n_ref,
                  occ_ref, out_ref):
    cols, _, _, (vx, vy, vz), (px, py, pz), (nx, ny, nz) = _load_rays(
        mat_ref, d_ref, p_ref, n_ref)
    m_amb, m_dif, m_spe, m_emi = (cols[0:4], cols[4:8], cols[8:12],
                                  cols[12:16])
    terms = []
    for j in range(n_lights):
        t = _light_terms(lg_ref, j, px, py, pz, nx, ny, nz, vx, vy, vz,
                         cols[16])
        t["lit"] = jnp.where(occ_ref[:, j], 0.0, 1.0)
        terms.append(t)
    ph = _phong(lg_ref, terms, m_amb, m_dif, m_spe, m_emi)
    for c in range(3):
        out_ref[:, c] = ph[c] * ph[3]                 # rgb * alpha (:839)


def _shade_bwd_kernel(n_lights: int, lg_ref, mat_ref, d_ref, p_ref, n_ref,
                      occ_ref, g_ref, gmat_ref, gd_ref, gp_ref, gn_ref,
                      glg_ref):
    cols, sd, inv_d, (vx, vy, vz), (px, py, pz), (nx, ny, nz) = _load_rays(
        mat_ref, d_ref, p_ref, n_ref)
    m_amb, m_dif, m_spe, m_emi = (cols[0:4], cols[4:8], cols[8:12],
                                  cols[12:16])
    m_shin = cols[16]
    zero = jnp.zeros_like(vx)

    # ---- forward replay, keeping per-light intermediates
    terms = []
    for j in range(n_lights):
        t = _light_terms(lg_ref, j, px, py, pz, nx, ny, nz, vx, vy, vz,
                         m_shin)
        t["lit"] = jnp.where(occ_ref[:, j], 0.0, 1.0)
        terms.append(t)
    ph = _phong(lg_ref, terms, m_amb, m_dif, m_spe, m_emi)

    # ---- backward of rgb * alpha
    g0, g1, g2 = g_ref[:, 0], g_ref[:, 1], g_ref[:, 2]
    g_ph = [g0 * ph[3], g1 * ph[3], g2 * ph[3],
            g0 * ph[0] + g1 * ph[1] + g2 * ph[2]]

    g_amb = [zero] * 4
    g_dif = [zero] * 4
    g_spe = [zero] * 4
    g_shin = zero
    gv = [zero] * 3
    gp = [zero] * 3
    gn = [zero] * 3
    n = (nx, ny, nz)
    for j, t in enumerate(terms):
        lit, lit_ct, lit_pw = t["lit"], t["lit_ct"], t["lit_pw"]
        g_lit_ct = zero
        g_lit_pw = zero
        for c in range(4):
            g_amb[c] = g_amb[c] + lg_ref[j, 4 + c] * g_ph[c]
            g_dif[c] = g_dif[c] + lg_ref[j, 8 + c] * lit_ct * g_ph[c]
            g_spe[c] = g_spe[c] + lg_ref[j, 12 + c] * lit_pw * g_ph[c]
            g_lit_ct = g_lit_ct + lg_ref[j, 8 + c] * m_dif[c] * g_ph[c]
            g_lit_pw = g_lit_pw + lg_ref[j, 12 + c] * m_spe[c] * g_ph[c]

        cos_phi, val, sb = t["cos_phi"], t["val"], t["sb"]
        g_val = jnp.where(cos_phi > 0.0, lit * g_lit_pw, 0.0)
        g_shin = g_shin + g_val * val * t["logsb"]
        g_cos_phi = jnp.where(cos_phi > _POW_EPS,
                              g_val * val * m_shin / sb, 0.0)
        g_ct_raw = jnp.where(t["ct_raw"] > 0.0, lit * g_lit_ct, 0.0)

        r, ld, dn = t["r"], t["ld"], t["dn"]
        view = (vx, vy, vz)
        # cos_phi = view . rhat
        grh = [g_cos_phi * view[i] for i in range(3)]
        gv = [gv[i] + g_cos_phi * r[i] for i in range(3)]
        # rhat = r0 / |r0| (normalize VJP, gated where |r0|^2 <= eps)
        rdot = r[0] * grh[0] + r[1] * grh[1] + r[2] * grh[2]
        gate_r = jnp.where(t["sr"] > _SQRT_EPS, 1.0, 0.0)
        gr0 = [t["inv_r"] * (grh[i] - gate_r * r[i] * rdot)
               for i in range(3)]
        # r0 = -l - 2 dn n, with dn = -(l . n); ct_raw = l . n
        g_dn = -2.0 * (n[0] * gr0[0] + n[1] * gr0[1] + n[2] * gr0[2])
        gl = [-gr0[i] - g_dn * n[i] + g_ct_raw * n[i] for i in range(3)]
        gn = [gn[i] - 2.0 * dn * gr0[i] - g_dn * ld[i] + g_ct_raw * ld[i]
              for i in range(3)]
        # l = tl / |tl|, tl = lpos - p
        ldot = ld[0] * gl[0] + ld[1] * gl[1] + ld[2] * gl[2]
        gate_tl = jnp.where(t["stl"] > _SQRT_EPS, 1.0, 0.0)
        gtl = [t["inv_tl"] * (gl[i] - gate_tl * ld[i] * ldot)
               for i in range(3)]
        gp = [gp[i] - gtl[i] for i in range(3)]

        for i in range(3):
            glg_ref[j, i] = jnp.sum(gtl[i])
        for c in range(4):
            glg_ref[j, 4 + c] = jnp.sum(m_amb[c] * g_ph[c])
            glg_ref[j, 8 + c] = jnp.sum(m_dif[c] * lit_ct * g_ph[c])
            glg_ref[j, 12 + c] = jnp.sum(m_spe[c] * lit_pw * g_ph[c])

    # view = u / |u| with u = -d (normalize VJP), then g_d = -g_u
    vdot = vx * gv[0] + vy * gv[1] + vz * gv[2]
    gate_d = jnp.where(sd > _SQRT_EPS, 1.0, 0.0)
    view = (vx, vy, vz)
    for i in range(3):
        gd_ref[:, i] = -(inv_d * (gv[i] - gate_d * view[i] * vdot))
        gp_ref[:, i] = gp[i]
        gn_ref[:, i] = gn[i]
    for c in range(4):
        gmat_ref[:, c] = g_amb[c]
        gmat_ref[:, 4 + c] = g_dif[c]
        gmat_ref[:, 8 + c] = g_spe[c]
        gmat_ref[:, 12 + c] = g_ph[c]                # emissive
    gmat_ref[:, 16] = g_shin
    for c in range(17, 20):
        gmat_ref[:, c] = zero


def _pad_rays(xs, r_pad: int):
    r = xs[0].shape[0]
    if r_pad == r:
        return xs
    return [jnp.pad(x, ((0, r_pad - r), (0, 0))) for x in xs]


def _row_spec(br: int, width: int):
    return pl.BlockSpec((br, width), lambda i: (i, 0))


def _shade_fwd(lg, mat_rows, dirs, p, n, occ):
    r = dirs.shape[0]
    br = BLOCK_RAYS
    r_pad = pl.cdiv(r, br) * br
    mat_rows, dirs, p, n, occ = _pad_rays([mat_rows, dirs, p, n, occ], r_pad)
    n_lights = lg.shape[0]
    out = _triton_call(
        functools.partial(_shade_kernel, n_lights), "phong_shade",
        (r_pad // br,),
        [_whole(lg), _row_spec(br, 20)] + [_row_spec(br, 3)] * 3
        + [_row_spec(br, n_lights)],
        _row_spec(br, 3), jax.ShapeDtypeStruct((r_pad, 3), dirs.dtype),
        lg, mat_rows, dirs, p, n, occ)
    return out[:r]


def _shade_bwd(lg, mat_rows, dirs, p, n, occ, g):
    r = dirs.shape[0]
    br = BLOCK_RAYS
    r_pad = pl.cdiv(r, br) * br
    mat_rows, dirs, p, n, occ, g = _pad_rays(
        [mat_rows, dirs, p, n, occ, g], r_pad)
    n_lights = lg.shape[0]
    n_prog = r_pad // br
    dtype = dirs.dtype
    rows3 = jax.ShapeDtypeStruct((r_pad, 3), dtype)
    g_mat, g_d, g_p, g_n, g_lg = _triton_call(
        functools.partial(_shade_bwd_kernel, n_lights), "phong_shade_bwd",
        (n_prog,),
        [_whole(lg), _row_spec(br, 20)] + [_row_spec(br, 3)] * 3
        + [_row_spec(br, n_lights), _row_spec(br, 3)],
        [_row_spec(br, 20)] + [_row_spec(br, 3)] * 3
        + [pl.BlockSpec((None, n_lights, _LG), lambda i: (i, 0, 0))],
        [jax.ShapeDtypeStruct((r_pad, 20), dtype), rows3, rows3, rows3,
         jax.ShapeDtypeStruct((n_prog, n_lights, _LG), dtype)],
        lg, mat_rows, dirs, p, n, occ, g)
    g_lg = jnp.sum(g_lg, axis=0)
    return (g_mat[:r], g_lg[:, 0:3], g_lg[:, 4:8], g_lg[:, 8:12],
            g_lg[:, 12:16], g_d[:r], g_p[:r], g_n[:r])


@jax.custom_vjp
def phong_kernel(mat_rows, lpos, lamb, ldiff, lspec, dirs, p, n, occluded):
    """shading.phong_core through the Triton kernels: same arguments (occluded
    (R, L) bool), same (R, 3) result, analytic backward kernel."""
    return _shade_fwd(_lights(lpos, lamb, ldiff, lspec), mat_rows, dirs, p,
                      n, occluded)


def _pk_fwd(mat_rows, lpos, lamb, ldiff, lspec, dirs, p, n, occluded):
    out = phong_kernel(mat_rows, lpos, lamb, ldiff, lspec, dirs, p, n,
                       occluded)
    return out, (mat_rows, lpos, lamb, ldiff, lspec, dirs, p, n, occluded)


def _pk_bwd(res, g):
    mat_rows, lpos, lamb, ldiff, lspec, dirs, p, n, occluded = res
    grads = _shade_bwd(_lights(lpos, lamb, ldiff, lspec), mat_rows, dirs, p,
                       n, occluded, g)
    return grads + (None,)


phong_kernel.defvjp(_pk_fwd, _pk_bwd)


def shade(scene, dirs, hit, occluded, mat_rows):
    """Drop-in for shading.phong_shade_lit(..., mat_rows=mat_rows)."""
    lights = scene.lights
    return phong_kernel(mat_rows, lights.position, lights.ambient,
                        lights.diffuse, lights.specular, dirs, hit.p, hit.n,
                        occluded)
