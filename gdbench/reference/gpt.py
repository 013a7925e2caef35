"""Plain gradient-domain path tracer (G-PT, Kettunen et al. 2015) for the
reference, on scenes whose every surface is diffuse and whose only lights
are area lights.

Each lane traces a base path through its pixel and four offset paths
through the neighbours (+x, -x, +y, -y) with the same random numbers.
On diffuse scenes an offset reconnects to the base path's second vertex
(the reconnection shift: its own primary hit, then the base's next
vertex if both are diffuse and mutually visible, with the Jacobian
cos_o / d_o^2 over cos_b / d_b^2); from there it shares the base suffix,
whose throughput and pdf ratio stay constant, so the rest of the
gradient factorizes as (rho - 1) / (1 + r^2) times the base's remaining
radiance.  Each contribution of the base and an offset is weighted by
the four-technique balance of light and BSDF sampling on both paths
(gpt.cpp's pair MIS).  A shift that cannot reconnect dies.

Outputs per lane: primal (the base path's radiance but the depth-1
emission), very_direct (that depth-1 emission) and the four gradients.
The film keeps primal and very_direct per pixel, and dx / dy on the
pixel lattice: dx[y, x] = g(+x)[y, x] - g(-x)[y, x+1], dy[y, x] =
g(+y)[y, x] - g(-y)[y+1, x], each averaged over the samples.
"""
from __future__ import annotations

import torch

from . import rng
from .common import (diffuse_eval, diffuse_pdf, diffuse_sample, dot, frame,
                     mis, offset, to_local, to_world)

OFFSETS = ((1.0, 0.0), (-1.0, 0.0), (0.0, 1.0), (0.0, -1.0))
NONE, RECENT, DONE = 0, 1, 2


def _b(x):
    return x[..., None]


def _expand(hit, k=4):
    """A hit record broadcast to k offsets."""
    return type(hit)(**{f: getattr(hit, f)[None].expand(
        (k,) + getattr(hit, f).shape) for f in hit.__dataclass_fields__})


def _stack4(ds, o, d, maxt):
    """Closest hits of [4, N] rays."""
    N = o.shape[1]
    h = ds.trace(o.reshape(-1, 3), d.reshape(-1, 3), maxt.reshape(-1))
    return type(h)(**{f: getattr(h, f).reshape((4, N) + getattr(
        h, f).shape[1:]) for f in h.__dataclass_fields__})


def _bounce(ds, s, b, seed, pixel, sample, offsets, conn0):
    """One lockstep bounce of the base path and, with offsets, of the four
    offset paths (conn0: offsets may still be unconnected)."""
    rs, dt = ds.rs, ds.dtype
    N = pixel.shape[0]
    eps = ds.eps
    depth = b + 1
    hit = s["hit"]
    alive = s["alive"] & hit.valid
    tp, primal, grad = s["tp"], s["primal"], s["grad"]
    o_hit, o_wi, o_tp, o_r, o_conn = (s["o_hit"], s["o_wi"], s["o_tp"],
                                      s["o_r"], s["o_conn"])
    o_alive = s["o_alive"] & alive[None]

    ss, ts = frame(hit.ns)
    wi = to_local(-s["d"], ss, ts, hit.ns)
    if offsets:
        ss_o, ts_o = frame(o_hit.ns)
        wi_o = to_local(o_wi, ss_o, ts_o, o_hit.ns)
        wi_o_main = to_local(o_wi, ss[None], ts[None], hit.ns[None])
    ext = alive & (depth < rs.max_depth) if rs.max_depth > 0 else alive

    # ---- light sampling -------------------------------------------------
    u_sel = rng.uniform(seed, pixel, sample,
                        rng.bounce_dim(b, rng.D_LIGHT_SELECT), dt)
    u_pos = rng.uniform2(seed, pixel, sample,
                         rng.bounce_dim(b, rng.D_LIGHT_UV), dt)
    lt = ds.sample_light(hit.p, u_sel, u_pos)
    conv = (torch.clamp_min(-dot(lt["d"], lt["n"]), 0.0) /
            torch.clamp_min(lt["dist"] ** 2, 1e-12))
    pe = lt["pdf_area"]
    wo_l = to_local(lt["d"], ss, ts, hit.ns)
    f_m = diffuse_eval(hit.refl, wi, wo_l)
    pb_m = diffuse_pdf(wi, wo_l) * conv
    nee_m = ext & lt["valid"] & (pe > 0)
    maxt_m = torch.where(nee_m, lt["dist"] - 2 * eps / torch.clamp_min(
        dot(lt["d"], lt["n"]).abs(), 1e-3), -1.0)
    sh_m = offset(hit.p, hit.ng, lt["d"], eps)
    if offsets and conn0:
        to_l = lt["p"][None] - o_hit.p
        dist_o = torch.sqrt(torch.clamp_min(dot(to_l, to_l), 1e-12))
        d_o = to_l / _b(dist_o)
        conv_o0 = (torch.clamp_min(-dot(d_o, lt["n"][None]), 0.0) /
                   torch.clamp_min(dist_o ** 2, 1e-12))
        wo_o0 = to_local(d_o, ss_o, ts_o, o_hit.ns)
        f_o0 = diffuse_eval(o_hit.refl, wi_o, wo_o0)
        pb_o0 = diffuse_pdf(wi_o, wo_o0) * conv_o0
        nee_o = o_alive & (o_conn == NONE) & nee_m[None]
        maxt_o = torch.where(nee_o, dist_o - 2 * eps / torch.clamp_min(
            dot(d_o, lt["n"][None]).abs(), 1e-3), -1.0)
        occ5 = ds.occluded(
            torch.cat([sh_m[None], offset(o_hit.p, o_hit.ng, d_o, eps)]
                      ).reshape(-1, 3),
            torch.cat([lt["d"][None], d_o]).reshape(-1, 3),
            torch.cat([maxt_m[None], maxt_o]).reshape(-1)).reshape(5, N)
        occ_m, occ_o0 = occ5[0], occ5[1:]
    else:
        occ_m = ds.occluded(sh_m, lt["d"], maxt_m)
        f_o0 = torch.zeros_like(o_tp)
        pb_o0 = conv_o0 = torch.zeros_like(o_r)
        occ_o0 = torch.ones_like(o_alive)
    vis_m = nee_m & ~occ_m
    c_m = torch.where(_b(vis_m), tp * f_m * lt["radiance"] * _b(
        conv / torch.clamp_min(pe, 1e-30)), 0.0)
    primal = primal + c_m * _b(mis(pe, pb_m))
    if offsets:
        f_o1 = diffuse_eval(hit.refl[None], wi_o_main, wo_l[None])
        pb_o1 = diffuse_pdf(wi_o_main, wo_l[None]) * conv[None]
        is0, is1 = o_conn == NONE, o_conn == RECENT
        f_o = torch.where(_b(is0), f_o0, torch.where(_b(is1), f_o1,
                                                     f_m[None]))
        pb_o = torch.where(is0, pb_o0, torch.where(is1, pb_o1, pb_m[None]))
        conv_o = torch.where(is0, conv_o0, conv[None])
        vis_o = torch.where(is0, ~occ_o0, ~occ_m[None])
        ok_o = o_alive & vis_o & vis_m[None]
        c_o = torch.where(_b(ok_o), o_tp * f_o * lt["radiance"][None] * _b(
            conv_o / torch.clamp_min(pe, 1e-30)[None]), 0.0)
        r_eff = torch.where(ok_o, o_r, 0.0)
        pe2 = (pe * pe)[None]
        den = pe2 + (pb_m * pb_m)[None] + r_eff * r_eff * (pe2 + pb_o * pb_o)
        w = torch.where(vis_m[None] | ok_o,
                        pe2 / torch.clamp_min(den, 1e-30), 0.0)
        grad = grad + _b(w) * (c_o - c_m[None])

    # ---- BSDF sampling --------------------------------------------------
    u2 = rng.uniform2(seed, pixel, sample, rng.bounce_dim(b, rng.D_BSDF_UV),
                      dt)
    wo, weight, pdf_sa, valid = diffuse_sample(hit.refl, wi, u2)
    cont = ext & valid
    wo_w = to_world(wo, ss, ts, hit.ns)
    tp_n = torch.where(_b(cont), tp * weight, 0.0)
    nh = ds.trace(offset(hit.p, hit.ng, wo_w, eps), wo_w,
                  torch.where(cont, 3e38, -1.0).to(dt))
    conv_seg = torch.where(nh.valid, dot(nh.ng, wo_w).abs() /
                           torch.clamp_min(nh.t ** 2, 1e-12), 1.0)
    pb_seg = pdf_sa * conv_seg
    is_em, rad_n = ds.emission(nh, wo_w)
    area = ds.em_area[torch.clamp_min(nh.emitter, 0)]
    pe_n = torch.where(is_em, 1.0 / (torch.clamp_min(area, 1e-12) *
                                     ds.n_area), 0.0)
    esc = cont & ~nh.valid
    pb_mis = torch.where(esc, pdf_sa, pb_seg)
    has_em = cont & (is_em | esc)
    c_mb = torch.where(_b(has_em), tp_n * torch.where(_b(is_em), rad_n, 0.0),
                       0.0)
    primal = primal + c_mb * _b(mis(pb_mis, pe_n))

    if offsets:
        is0, is1, is2 = (o_conn == NONE, o_conn == RECENT, o_conn == DONE)
        f_o1 = diffuse_eval(hit.refl[None], wi_o_main, wo[None])
        pb_o1 = diffuse_pdf(wi_o_main, wo[None])
        ok1 = f_o1.abs().amax(-1) >= 0
        recon = hit.valid[None] & o_hit.valid & (nh.valid | esc)[None]
        wo_w4 = wo_w[None].expand(o_wi.shape)
        if conn0:
            to_n = nh.p[None] - o_hit.p
            dist2 = torch.clamp_min(dot(to_n, to_n), 1e-12)
            dist_o = torch.sqrt(dist2)
            dir_rc = to_n / _b(dist_o)
            cos_n_o = dot(nh.ng[None], dir_rc).abs()
            conv_rc = cos_n_o / dist2
            jac = conv_rc / torch.clamp_min(conv_seg[None], 1e-30)
            wo_rc = to_local(dir_rc, ss_o, ts_o, o_hit.ns)
            f_rc = diffuse_eval(o_hit.refl, wi_o, wo_rc)
            pb_rc = diffuse_pdf(wi_o, wo_rc)
            live = o_alive & is0 & recon & ~esc[None] & nh.valid[None]
            occ = ds.occluded(
                offset(o_hit.p, o_hit.ng, dir_rc, eps).reshape(-1, 3),
                dir_rc.reshape(-1, 3),
                torch.where(live, dist_o - 2 * eps / torch.clamp_min(
                    cos_n_o, 1e-3), -1.0).reshape(-1)).reshape(4, N)
            ok_rc = recon & nh.valid[None] & ~occ & (f_rc.amax(-1) > 0)
        else:
            dir_rc = wo_w4
            conv_rc = conv_seg[None].expand(o_r.shape)
            jac = torch.ones_like(o_r)
            f_rc = torch.zeros_like(o_tp)
            pb_rc = torch.zeros_like(o_r)
            ok_rc = torch.zeros_like(o_alive)
        use_rc = is0 & recon & ~esc[None]
        pb_base = torch.clamp_min(pdf_sa, 1e-30)[None]
        fac0 = torch.where(_b(use_rc), f_rc * _b(jac), 0.0) / _b(pb_base)
        r_fac0 = torch.where(use_rc, pb_rc * jac, 0.0) / pb_base
        pb_conn = torch.clamp_min(pdf_sa, 1e-30)[None]
        fac = torch.where(_b(is2), weight[None], torch.where(
            _b(is1), f_o1 / _b(pb_conn), fac0))
        r_fac = torch.where(is2, 1.0, torch.where(is1, pb_o1 / pb_conn,
                                                  r_fac0))
        ok = torch.where(is2, cont[None], torch.where(
            is1, ok1 & cont[None], use_rc & ok_rc))
        o_alive2 = o_alive & ok
        o_tp2 = torch.where(_b(o_alive2), o_tp * fac, 0.0)
        o_r2 = torch.where(o_alive2, o_r * r_fac, 0.0)
        dir_in = torch.where(_b(use_rc), dir_rc, wo_w4)
        hit_em_o = (nh.valid[None] & (nh.emitter[None] >= 0) &
                    (dot(nh.ns[None], -dir_in) > 0))
        off_emit = torch.where(_b(hit_em_o), rad_n[None], 0.0)
        pe_o = torch.where(nh.valid & (nh.emitter >= 0), 1.0 / (
            torch.clamp_min(area, 1e-12) * ds.n_area), 0.0)
        off_pe = torch.where(esc[None], 0.0, pe_o[None])
        off_pb = torch.where(is2, (pdf_sa * conv_seg)[None], torch.where(
            is1, pb_o1 * conv_seg[None], torch.where(
                use_rc, pb_rc * conv_rc, 0.0)))
        conn2 = torch.where(is2 | is1, DONE, torch.where(use_rc, RECENT,
                                                         NONE))
        conn2 = torch.where(o_alive2, conn2.to(o_conn.dtype), o_conn)
        o_wi2 = torch.where(_b(use_rc & o_alive2), -dir_rc, -wo_w4)

        has_pair = has_em | (o_alive2 & (dot(off_emit, off_emit) > 0))
        r_b = torch.where(o_alive2, o_r2, 0.0)
        num = (pb_mis * pb_mis)[None]
        den = num + (pe_n * pe_n)[None] + r_b * r_b * (off_pb * off_pb +
                                                       off_pe * off_pe)
        w_b = torch.where(has_pair, num / torch.clamp_min(den, 1e-30), 0.0)
        c_ob = torch.where(_b(o_alive2), o_tp2 * off_emit, 0.0)
        grad = grad + _b(w_b) * (c_ob - c_mb[None])

    # ---- Russian roulette (one decision for all five paths) ---------------
    u_rr = rng.uniform(seed, pixel, sample, rng.bounce_dim(b, rng.D_RR), dt)
    q = torch.clamp_max(tp_n.amax(-1), 0.95)
    if depth + 1 >= rs.rr_depth:
        survive = u_rr < q
        inv_q = 1.0 / torch.clamp_min(q, 1e-9)
    else:
        survive = torch.ones_like(cont)
        inv_q = torch.ones_like(q)
    tp_n = tp_n * _b(inv_q)
    alive_n = cont & nh.valid & survive & (tp_n.amax(-1) > 0)
    out = dict(s, d=wo_w, hit=nh, tp=tp_n, alive=alive_n, primal=primal,
               grad=grad)
    if offsets:
        out.update(o_hit=_expand(nh), o_wi=o_wi2, o_tp=o_tp2 * inv_q[None,
                                                                      :, None],
                   o_r=o_r2, o_conn=conn2, o_alive=o_alive2 & alive_n[None])
    return out


def trace_lanes(ds, seed, pixel, sample):
    """(primal [N, 3], very_direct [N, 3], grad [4, N, 3]) of the lanes."""
    rs, dt, dev = ds.rs, ds.dtype, ds.device
    N = pixel.shape[0]
    W = rs.width
    jit = rng.uniform2(seed, pixel, sample, rng.PIXEL_JITTER, dt)
    pos = torch.stack([(pixel % W).to(dt), (pixel // W).to(dt)], -1) + jit
    o_m, d_m = ds.camera_ray(pos)
    offs = torch.tensor(OFFSETS, dtype=dt, device=dev)
    o_o, d_o = ds.camera_ray((pos[None] + offs[:, None]).reshape(-1, 2))
    o_o, d_o = o_o.reshape(4, N, 3), d_o.reshape(4, N, 3)
    inf = torch.full((N,), 3e38, dtype=dt, device=dev)
    hit = ds.trace(o_m, d_m, inf)
    o_hit = _stack4(ds, o_o, d_o, inf[None].expand(4, N))
    is_em, rad = ds.emission(hit, d_m)
    very = torch.where(is_em[..., None], rad, 0.0)
    z3 = torch.zeros((N, 3), dtype=dt, device=dev)
    s = dict(d=d_m, hit=hit, tp=torch.ones_like(z3), alive=hit.valid,
             primal=z3, o_hit=o_hit, o_wi=-d_o,
             o_tp=torch.ones((4, N, 3), dtype=dt, device=dev),
             o_r=torch.ones((4, N), dtype=dt, device=dev),
             o_alive=o_hit.valid & hit.valid[None],
             o_conn=torch.zeros((4, N), dtype=torch.int32, device=dev),
             grad=torch.zeros((4, N, 3), dtype=dt, device=dev))
    n_b = rs.max_depth - 1 if rs.max_depth > 0 else 40
    if n_b > 0:
        s = _bounce(ds, s, 0, seed, pixel, sample, True, True)
    if n_b > 1:
        s = _bounce(ds, s, 1, seed, pixel, sample, True, False)
    if n_b > 2:
        # every live offset now shares the base suffix
        rho = torch.where(_b(s["o_alive"]), s["o_tp"] / torch.clamp_min(
            s["tp"], 1e-30)[None], 0.0)
        r_c = torch.where(s["o_alive"], s["o_r"], 0.0)
        coeff = torch.where(_b(s["o_alive"] | s["alive"][None]),
                            (rho - 1.0) / _b(1.0 + r_c * r_c), 0.0)
        rest = dict(s, primal=torch.zeros_like(z3))
        for b in range(2, n_b):
            rest = _bounce(ds, rest, b, seed, pixel, sample, False, False)
        s["primal"] = s["primal"] + rest["primal"]
        s["grad"] = s["grad"] + coeff * rest["primal"][None]
    return s["primal"], very, s["grad"]


def render_rows(ds, seed, spp, rows, lanes=1 << 16):
    """The film buffers of the given film rows: dict of primal,
    very_direct, dx, dy, each [len(rows), W, 3].  Traces the rows and the
    rows below them (dy needs the -y offsets of row y + 1)."""
    rs, dev = ds.rs, ds.device
    W, H = rs.width, rs.height
    rows = torch.as_tensor(rows, device=dev)
    need = torch.unique(torch.cat([rows, torch.clamp_max(rows + 1, H - 1)]))
    pixels = (need[:, None] * W + torch.arange(W, device=dev)).reshape(-1)
    P = pixels.shape[0]
    acc = {k: torch.zeros(shape, dtype=torch.float32, device=dev)
           for k, shape in (("primal", (P, 3)), ("very", (P, 3)),
                            ("grad", (4, P, 3)))}
    pix = pixels.repeat(spp)
    smp = torch.arange(spp, device=dev).repeat_interleave(P)
    slot = torch.arange(P, device=dev).repeat(spp)
    for a in range(0, pix.shape[0], lanes):
        pr, vd, g = trace_lanes(ds, seed, pix[a:a + lanes], smp[a:a + lanes])
        sl = slot[a:a + lanes]
        acc["primal"].index_add_(0, sl, pr.float())
        acc["very"].index_add_(0, sl, vd.float())
        acc["grad"].index_add_(1, sl, g.float())
    R = need.shape[0]
    g = acc["grad"].reshape(4, R, W, 3) / spp
    at = {int(r): i for i, r in enumerate(need.tolist())}
    pick = torch.tensor([at[int(r)] for r in rows.tolist()], device=dev)
    below = torch.tensor([at.get(int(r) + 1, -1) for r in rows.tolist()],
                         device=dev)
    dx = g[0, pick].clone()
    dx[:, :-1] -= g[1, pick][:, 1:]
    dy = g[2, pick].clone()
    has = below >= 0
    dy[has] -= g[3, below[has]]
    return dict(primal=acc["primal"].reshape(R, W, 3)[pick] / spp,
                very_direct=acc["very"].reshape(R, W, 3)[pick] / spp,
                dx=dx, dy=dy)
