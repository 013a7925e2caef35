"""Preetham sun/sky emitters baked to a lat-long environment map.

TPU-native replacement for src/emitters/{sun,sky,sunsky}.cpp: the
reference implements the Preetham analytic sky as a dedicated emitter
plugin with its own sampling code; here the model is evaluated ONCE on
the host into the framework's standard envmap grid, so the device-side
path (2D-CDF importance sampling, eval_env, BDPT env subpaths, G-PT
environment shifts) is shared with every other environment light — no
new device code, and the bright sun disk is importance-sampled exactly
like any other bright texel.  Deviations, documented:

  - radiance is evaluated at the RGB primaries via xyY -> XYZ -> linear
    sRGB (the reference integrates tabulated spectra); absolute scaling
    uses the photopic 683 lm/W convention as sky.cpp does
  - the sun's spectral attenuation uses a compact Angstrom-turbidity +
    Rayleigh air-mass model at three representative wavelengths rather
    than the reference's full k_o/k_g/k_wa tables; total disk power is
    conserved against the painted texel footprint, so coarse maps stay
    energy-correct
  - `resolution` picks the bake grid (default 512 rows)

Solar position from (year, month, day, hour, latitude, longitude,
timezone) follows the Preetham appendix formulas, or `sunDirection` is
taken verbatim when given.
"""
from __future__ import annotations

import numpy as np

SUN_APP_RADIUS_DEG = 0.5358 / 2.0  # apparent solar radius (sun.cpp)

# xyY -> XYZ -> linear sRGB (Rec.709 primaries, D65)
_XYZ_TO_RGB = np.array([
    [3.240479, -1.537150, -0.498535],
    [-0.969256, 1.875991, 0.041556],
    [0.055648, -0.204043, 1.057311]], np.float64)

# Perez-function coefficient tables (Preetham et al. 1999, Table 1)
_PEREZ_Y = np.array([[0.1787, -1.4630], [-0.3554, 0.4275],
                     [-0.0227, 5.3251], [0.1206, -2.5771],
                     [-0.0670, 0.3703]])
_PEREZ_x = np.array([[-0.0193, -0.2592], [-0.0665, 0.0008],
                     [-0.0004, 0.2125], [-0.0641, -0.8989],
                     [-0.0033, 0.0452]])
_PEREZ_y = np.array([[-0.0167, -0.2608], [-0.0950, 0.0092],
                     [-0.0079, 0.2102], [-0.0441, -1.6537],
                     [-0.0109, 0.0529]])

_ZENITH_x = np.array([[0.00166, -0.00375, 0.00209, 0.0],
                      [-0.02903, 0.06377, -0.03202, 0.00394],
                      [0.11693, -0.21196, 0.06052, 0.25886]])
_ZENITH_y = np.array([[0.00275, -0.00610, 0.00317, 0.0],
                      [-0.04214, 0.08970, -0.04153, 0.00516],
                      [0.15346, -0.26756, 0.06670, 0.26688]])


def solar_direction(props: dict) -> np.ndarray:
    """World-space unit vector toward the sun (+y up, like the
    reference's default frame).  `sunDirection` wins; otherwise the
    Preetham appendix solar-position formula from date/time/location
    (defaults mirror sunsky.cpp: 2010-07-10 15:00, lat 35.6894,
    lon 139.6917, UTC+9)."""
    sd = props.get("sunDirection")
    if sd is not None:
        v = np.asarray(sd, np.float64)
        return v / np.linalg.norm(v)
    year = int(props.get("year", 2010))
    month = int(props.get("month", 7))
    day = int(props.get("day", 10))
    hour = float(props.get("hour", 15.0))
    minute = float(props.get("minute", 0.0))
    sec = float(props.get("second", 0.0))
    lat = np.deg2rad(float(props.get("latitude", 35.6894)))
    lon = np.deg2rad(float(props.get("longitude", 139.6917)))
    tz = float(props.get("timezone", 9.0))

    # Julian date (standard calendar conversion)
    if month <= 2:
        year -= 1
        month += 12
    a = year // 100
    b = 2 - a + a // 4
    jd = (int(365.25 * (year + 4716)) + int(30.6001 * (month + 1)) +
          day + b - 1524.5)
    decimal_hours = hour + minute / 60.0 + sec / 3600.0 - tz
    elapsed_jd = jd + decimal_hours / 24.0 - 2451545.0

    # Preetham appendix / PSA algorithm
    omega = 2.1429 - 0.0010394594 * elapsed_jd
    mean_lon = 4.8950630 + 0.017202791698 * elapsed_jd
    mean_anom = 6.2400600 + 0.0172019699 * elapsed_jd
    ecl_lon = (mean_lon + 0.03341607 * np.sin(mean_anom) +
               0.00034894 * np.sin(2 * mean_anom) - 0.0001134 -
               0.0000203 * np.sin(omega))
    obliquity = (0.4090928 - 6.2140e-9 * elapsed_jd +
                 0.0000396 * np.cos(omega))
    ra = np.arctan2(np.cos(obliquity) * np.sin(ecl_lon), np.cos(ecl_lon))
    ra = ra % (2 * np.pi)
    decl = np.arcsin(np.sin(obliquity) * np.sin(ecl_lon))
    gmst = 6.6974243242 + 0.0657098283 * elapsed_jd + decimal_hours
    lmst = np.deg2rad(gmst * 15) + lon
    hour_angle = lmst - ra
    theta = np.arccos(np.clip(
        np.cos(lat) * np.cos(hour_angle) * np.cos(decl) +
        np.sin(lat) * np.sin(decl), -1.0, 1.0))
    dy = -np.cos(decl) * np.sin(hour_angle)
    dx = (np.tan(decl) * np.cos(lat) - np.sin(lat) * np.cos(hour_angle))
    azimuth = np.arctan2(dy, dx)
    # parallax correction
    theta += 4.263521e-5 * np.sin(theta)
    # world frame: +y up, azimuth measured from +x toward +z
    st, ct = np.sin(theta), np.cos(theta)
    return np.array([st * np.cos(azimuth), ct, st * np.sin(azimuth)])


def _perez(theta, gamma, coeffs):
    A, B, C, D, E = coeffs
    cos_t = np.maximum(np.cos(theta), 1e-3)
    return ((1.0 + A * np.exp(B / cos_t)) *
            (1.0 + C * np.exp(D * gamma) + E * np.cos(gamma) ** 2))


def _coeffs(table, T):
    return table @ np.array([T, 1.0])


def sky_radiance_grid(res_h, turbidity, sun_dir, scale=1.0, stretch=1.0,
                      albedo_unused=None):
    """[res_h, 2*res_h, 3] linear-RGB radiance of the Preetham sky.
    Directions below the horizon are held at the horizon value (the
    reference's extend/stretch behavior with its default extend=true)."""
    H, W = res_h, 2 * res_h
    theta_s = np.arccos(np.clip(sun_dir[1], -1.0, 1.0))
    theta_s = min(theta_s, np.deg2rad(89.0))  # keep zenith formulas sane
    phi_s = np.arctan2(sun_dir[2], sun_dir[0])

    T = float(turbidity)
    chi = (4.0 / 9.0 - T / 120.0) * (np.pi - 2 * theta_s)
    # zenith luminance in cd/m^2 (the formula yields Kcd/m^2)
    Yz = ((4.0453 * T - 4.9710) * np.tan(chi) - 0.2155 * T + 2.4192) * 1e3
    Yz = max(Yz, 1e-3)
    tvec = np.array([T * T, T, 1.0])
    svec = np.array([theta_s ** 3, theta_s ** 2, theta_s, 1.0])
    xz = float(tvec @ _ZENITH_x @ svec)
    yz = float(tvec @ _ZENITH_y @ svec)

    cY = _coeffs(_PEREZ_Y, T)
    cx = _coeffs(_PEREZ_x, T)
    cy = _coeffs(_PEREZ_y, T)

    # texel-center directions of the lat-long grid (+y up; u wraps phi)
    tt = (np.arange(H) + 0.5) / H * np.pi
    pp = (np.arange(W) + 0.5) / W * 2 * np.pi
    TT, PP = np.meshgrid(tt, pp, indexing="ij")
    # stretch>1 compresses the sky toward the horizon (sky.cpp stretch)
    TT_eval = np.minimum(TT * stretch, np.pi / 2 - 1e-3)
    d = np.stack([np.sin(TT_eval) * np.cos(PP), np.cos(TT_eval),
                  np.sin(TT_eval) * np.sin(PP)], -1)
    cos_gamma = np.clip(d @ sun_dir, -1.0, 1.0)
    gamma = np.arccos(cos_gamma)

    def ratio(coeffs, zenith):
        return zenith * (_perez(TT_eval, gamma, coeffs) /
                         _perez(0.0, theta_s, coeffs))

    Y = ratio(cY, Yz)
    x = ratio(cx, xz)
    y = ratio(cy, yz)
    y = np.clip(y, 1e-4, 1.0)
    X = x / y * Y
    Z = (1.0 - x - y) / y * Y
    XYZ = np.stack([X, Y, Z], -1)
    rgb = XYZ @ _XYZ_TO_RGB.T
    # photopic conversion cd/m^2 -> W/(sr m^2): 1/683, as sky.cpp
    rgb = np.maximum(rgb, 0.0) / 683.0 * float(scale)
    return rgb.astype(np.float32)


def sun_direct_radiance(turbidity, theta_s):
    """Approximate linear-RGB radiance of the solar disk after clear-sky
    attenuation: Rayleigh + Angstrom-aerosol optical depth at three
    representative wavelengths (0.62/0.55/0.46 um).  Returns (rgb
    radiance W/(sr m^2), disk solid angle)."""
    theta_deg = np.rad2deg(theta_s)
    if theta_deg >= 90.0:
        return np.zeros(3), 2 * np.pi * (1 - np.cos(
            np.deg2rad(SUN_APP_RADIUS_DEG)))
    # relative optical air mass (Kasten-Young style, Preetham appendix)
    m = 1.0 / (np.cos(theta_s) + 0.15 *
               (93.885 - theta_deg) ** -1.253)
    lam = np.array([0.62, 0.55, 0.46])  # um
    beta = 0.04608 * turbidity - 0.04586
    tau_a = beta * lam ** -1.3          # Angstrom aerosol
    tau_r = 0.008735 * lam ** -4.08     # Rayleigh
    transm = np.exp(-m * (tau_a + tau_r))
    # top-of-atmosphere solar constant split across sRGB bands (approx.
    # 5778K blackbody weights over the visible bands)
    E0 = 1361.0 * np.array([0.42, 0.35, 0.23])
    omega = 2 * np.pi * (1 - np.cos(np.deg2rad(SUN_APP_RADIUS_DEG)))
    L = E0 * transm / omega
    return L, omega


def add_sun_disk(env_map, sun_dir, turbidity, scale=1.0, radius_scale=1.0):
    """Paint the solar disk into a lat-long map, conserving total power
    against the actual painted texel footprint (coarse grids stay
    energy-correct even when the disk covers less than one texel)."""
    H, W = env_map.shape[:2]
    theta_s = np.arccos(np.clip(sun_dir[1], -1.0, 1.0))
    L, omega = sun_direct_radiance(turbidity, theta_s)
    L = L * float(scale)
    r = np.deg2rad(SUN_APP_RADIUS_DEG) * float(radius_scale)
    omega = 2 * np.pi * (1 - np.cos(r))
    if not np.isfinite(L).all() or L.max() <= 0:
        return env_map

    tt = (np.arange(H) + 0.5) / H * np.pi
    pp = (np.arange(W) + 0.5) / W * 2 * np.pi
    TT, PP = np.meshgrid(tt, pp, indexing="ij")
    d = np.stack([np.sin(TT) * np.cos(PP), np.cos(TT),
                  np.sin(TT) * np.sin(PP)], -1)
    cos_g = np.clip(d @ sun_dir, -1.0, 1.0)
    inside = cos_g >= np.cos(r)
    texel_sa = (2 * np.pi / W) * (np.pi / H) * np.sin(TT)
    if not inside.any():
        # sub-texel sun: all power into the nearest texel
        j, i = np.unravel_index(np.argmax(cos_g), cos_g.shape)
        inside = np.zeros_like(cos_g, bool)
        inside[j, i] = True
    painted_sa = float(texel_sa[inside].sum())
    power_scale = omega / max(painted_sa, 1e-12)
    out = env_map.copy()
    out[inside] += (L * power_scale)[None, :].astype(np.float32)
    return out


def bake(em_type: str, props: dict):
    """Build the lat-long radiance map for a sun/sky/sunsky plugin node.
    Returns ([H, W, 3] f32, scale_rgb) for the envmap machinery."""
    res = int(props.get("resolution", 512)) // 2 * 2
    res = max(res, 32)
    H = res // 2
    turb = float(props.get("turbidity", 3.0))
    sun_dir = solar_direction(props)
    stretch = float(props.get("stretch", 1.0))
    sun_scale = float(props.get("sunScale", props.get("scale", 1.0)))
    sky_scale = float(props.get("skyScale", props.get("scale", 1.0)))
    if em_type in ("sky", "sunsky"):
        env = sky_radiance_grid(H, turb, sun_dir, scale=sky_scale,
                                stretch=stretch)
    else:
        env = np.zeros((H, 2 * H, 3), np.float32)
    if em_type in ("sun", "sunsky"):
        env = add_sun_disk(env, sun_dir, turb, scale=sun_scale,
                           radius_scale=float(
                               props.get("sunRadiusScale", 1.0)))
    return env
