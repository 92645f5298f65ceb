"""CPU reference rasterizer (the golden oracle), frozen for the benchmark.

A copy of the port's ``based_renderer_tpu_torch/reference/oracle.py``
(numpy only), unchanged but for this paragraph.  The benchmark keeps its
own copy so that a later edit of the program cannot move its yardstick;
``benchmark/reference/raster.py`` restates it in vectorised torch, and
``benchmark/tests/test_reference.py`` holds the two equal.  Module
references below (``ops/fixedpoint.py``, ``ops/setup.py``) name the spec
modules of the program.

A deliberately simple, loop-based numpy implementation of the rasterization
spec in ``ops/fixedpoint.py``.  The reference repo has no tests at all
(SURVEY.md §4); this oracle is the verification backbone the TPU build adds:
device rasterizers must produce *bit-identical* coverage (winning triangle
per pixel) and depth against it.

Numerical contract (shared with ops/setup.py — mirrored, not imported, so
this stays an independent implementation):
  * All edge-function math in exact integers (numpy int64 is exact for the
    <= ~2^40 ranges the guard band allows).
  * Clip -> screen front-end in float32 with the exact op order of the
    device path: inv_w = 1/w; ndc = x * inv_w; s = (ndc*0.5 + 0.5) * extent;
    snap = rint(s * 16).
  * Depth via the integer quantized-plane spec of ops/fixedpoint.py: 24-bit
    quantized vertex depth + 6 fractional bits, int32 per-pixel gradients,
    plane evaluated from canonical 128-px tile anchors.  Every float step is
    a single multiplication (FMA-proof); all accumulation is integer.
  * Triangles drawn in index order; depth compare decides survivors, ties
    ("equal" under the compare op) keep the earlier fragment for "less"/
    "greater" compares since the later fragment fails the strict test.

The rasterizer stage contract starts at *clip space*: vertex transforms on
the MXU are not IEEE-f32 dot products, so full-pipeline comparisons are
approximate while clip-space-onward comparisons are exact.
"""

from __future__ import annotations

import numpy as np

SUBPIXEL_BITS = 4
SUBPIXEL_SCALE = 16
HALF_PIXEL = 8
GUARD_BAND_PIX = 8192
GUARD_LO = -GUARD_BAND_PIX * SUBPIXEL_SCALE
GUARD_HI = GUARD_BAND_PIX * SUBPIXEL_SCALE - 1
DEPTH_LSB_BITS = 24
DEPTH_FRAC_BITS = 6
DEPTH_ONE_Q = 1 << 30
DEPTH_VERTEX_CLAMP = 1 << 29
# Must match ops/fixedpoint.py DEPTH_GRAD_CLAMP: the value-exactness proof
# there needs in-tile variation 2*clamp*127 < 2^29, i.e. clamp < 2^21.
DEPTH_GRAD_CLAMP = (1 << 21) - 1
DEPTH_TILE = 128

_COMPARES = {
    "never": lambda z, d: np.zeros_like(z, dtype=bool),
    "less": lambda z, d: z < d,
    "equal": lambda z, d: z == d,
    "less_equal": lambda z, d: z <= d,
    "greater": lambda z, d: z > d,
    "not_equal": lambda z, d: z != d,
    "greater_equal": lambda z, d: z >= d,
    "always": lambda z, d: np.ones_like(z, dtype=bool),
}


def _recip_f32_exact(x) -> np.ndarray:
    """Mirror of the device's exactly-specified reciprocal (ops/fixedpoint.py
    recip_f32_exact): q = floor(2^47 / mantissa) computed with big integers,
    result = f32(q) * 2^(103 - biased_exponent)."""
    x = np.asarray(x, np.float32)
    bits = x.view(np.int32)
    e = (bits >> 23) & np.int32(0xFF)
    mw = ((bits & np.int32(0x7FFFFF)) | np.int32(0x800000)).astype(np.int64)
    q = ((1 << 47) // mw).astype(np.float32)  # exact: f32 holds ints <= 2^24
    exp_s = np.clip(np.int32(230) - e, 1, 254).astype(np.int32)
    scale = (exp_s << 23).view(np.float32)
    return np.float32(q * scale)


def _stencil_apply_op(op, sbuf, ref):
    """numpy mirror of ops/raster_xla.stencil_apply_op (VkStencilOp)."""
    if op == "keep":
        return sbuf
    if op == "zero":
        return np.zeros_like(sbuf)
    if op == "replace":
        return np.full_like(sbuf, np.int32(ref))
    if op == "increment_clamp":
        return np.minimum(sbuf + 1, np.int32(255))
    if op == "decrement_clamp":
        return np.maximum(sbuf - 1, np.int32(0))
    if op == "invert":
        return (~sbuf) & np.int32(0xFF)
    if op == "increment_wrap":
        return (sbuf + 1) & np.int32(0xFF)
    if op == "decrement_wrap":
        return (sbuf - 1) & np.int32(0xFF)
    raise ValueError(op)


def _i64_pair_to_f32(v) -> np.ndarray:
    """Mirror of the device's deterministic int64 -> f32 conversion
    (signed-low-word split: exact for |v| < 2^31, see ops/setup.py)."""
    v = np.asarray(v, np.int64)
    lo_s = (v & np.int64(0xFFFFFFFF)).astype(np.uint32).view(np.int32)
    hi_adj = ((v >> np.int64(32)).astype(np.int32) + (lo_s < 0)).astype(np.float32)
    return np.float32(hi_adj * np.float32(4294967296.0) + lo_s.astype(np.float32))


# MSAA-4x sample offsets from the pixel center, 1/16-px units (must match
# ops/fixedpoint.py MSAA4_OFFSETS — the Vulkan standard 4x rotated grid).
MSAA4_OFFSETS = ((-2, -6), (6, -2), (-6, 2), (2, 6))


def rasterize(
    clip_pos: np.ndarray,
    width: int,
    height: int,
    cull_mode: str = "none",
    front_face: str = "ccw",
    depth_test: bool = True,
    depth_compare: str = "less",
    depth_write: bool = True,
    depth_clear: float = 1.0,
    depth_clip=True,
    w_eps: float = 1e-6,
    stencil=None,
    stencil_clear: int = 0,
    depth_bias=None,
):
    """Rasterize triangles, returning coverage/depth/barycentric buffers.

    ``depth_clip`` accepts True (discard z outside [0,1]), False, or
    "clamp" (clamp z into [0,1] — the depthClampEnable analog).
    ``depth_bias`` is an optional (constant, slope, clamp) triple applied
    per-triangle on the quantized vertex depths (the depthBiasEnable
    analog; spec note in ops/setup.py).

    Args:
      clip_pos: (T, 3, 4) float32 clip-space positions.
    Returns dict with:
      tri_id:  (H, W) int32 — winning triangle index, -1 where uncovered.
      depth_q: (H, W) int32 — final quantized depth buffer (1.0 == 2^30).
      depth:   (H, W) float32 — depth_q converted to [0, 1].
      bary:    (H, W, 3) float32 — barycentric weights of the winner.
    """
    out = _rasterize_samples(
        clip_pos,
        width,
        height,
        ((0, 0),),
        cull_mode,
        front_face,
        depth_test,
        depth_compare,
        depth_write,
        depth_clear,
        depth_clip,
        w_eps,
        stencil,
        stencil_clear,
        depth_bias,
    )
    return {k: v[0] for k, v in out.items()}


def rasterize_msaa4(
    clip_pos: np.ndarray,
    width: int,
    height: int,
    cull_mode: str = "none",
    front_face: str = "ccw",
    depth_test: bool = True,
    depth_compare: str = "less",
    depth_write: bool = True,
    depth_clear: float = 1.0,
    depth_clip=True,
    w_eps: float = 1e-6,
    stencil=None,
    stencil_clear: int = 0,
    depth_bias=None,
):
    """MSAA-4x rasterization: per-SAMPLE coverage and depth, per-PIXEL
    attributes.

    Coverage and the depth test run independently at the four standard
    sample positions (MSAA4_OFFSETS); per-sample depth is the quantized
    plane value stepped by ((dzdx_q*ddx + dzdy_q*ddy) >> 4) per the proof
    extension in ops/fixedpoint.py.  Barycentrics (the attribute-
    interpolation inputs) are evaluated once at the pixel CENTER of each
    sample's winner — true multisampling semantics (shade once per
    fragment), unlike 2x2 supersampling.

    Returns dict of (4, H, W[, 3]) per-sample buffers.
    """
    return _rasterize_samples(
        clip_pos,
        width,
        height,
        MSAA4_OFFSETS,
        cull_mode,
        front_face,
        depth_test,
        depth_compare,
        depth_write,
        depth_clear,
        depth_clip,
        w_eps,
        stencil,
        stencil_clear,
        depth_bias,
    )


def _rasterize_samples(
    clip_pos,
    width,
    height,
    sample_offsets,
    cull_mode,
    front_face,
    depth_test,
    depth_compare,
    depth_write,
    depth_clear,
    depth_clip,
    w_eps,
    stencil=None,
    stencil_clear=0,
    depth_bias=None,
):
    clip_pos = np.asarray(clip_pos, np.float32)
    num_tris = clip_pos.shape[0]
    ns = len(sample_offsets)
    tri_id = np.full((ns, height, width), -1, np.int32)
    depth_buf = np.full(
        (ns, height, width), np.int32(round(depth_clear * DEPTH_ONE_Q)), np.int32
    )
    bary_buf = np.zeros((ns, height, width, 3), np.float32)
    use_stencil = stencil is not None and stencil.enable
    stencil_buf = (
        np.full((ns, height, width), np.int32(stencil_clear & 0xFF), np.int32)
        if use_stencil
        else None
    )
    cmp_fn = _COMPARES[depth_compare]

    for t in range(num_tris):
        x = clip_pos[t, :, 0]
        y = clip_pos[t, :, 1]
        z = clip_pos[t, :, 2]
        w = clip_pos[t, :, 3]
        if np.any(w <= np.float32(w_eps)):
            continue
        inv_w = _recip_f32_exact(w)
        ndc_x = x * inv_w
        ndc_y = y * inv_w
        ndc_z = z * inv_w
        # FMA-proof viewport+snap: xf = rint(ndc_x * 8W) + 8W (see setup.py).
        lim = np.float32(1 << 30)
        tx = np.clip(ndc_x * np.float32(8 * width), -lim, lim)
        tyv = np.clip(ndc_y * np.float32(8 * height), -lim, lim)
        xf = np.rint(tx).astype(np.int64) + np.int64(8 * width)
        yf = np.rint(tyv).astype(np.int64) + np.int64(8 * height)
        xf = np.clip(xf, GUARD_LO, GUARD_HI)
        yf = np.clip(yf, GUARD_LO, GUARD_HI)

        # Edge coefficients; E_i(p) = A_i*(p.x - x_i) + B_i*(p.y - y_i),
        # edge i from v_i to v_{i+1 mod 3}.
        a = yf - np.roll(yf, -1)
        b = np.roll(xf, -1) - xf
        d1 = (xf[1] - xf[0], yf[1] - yf[0])
        d2 = (xf[2] - xf[0], yf[2] - yf[0])
        area2 = int(d1[0] * d2[1] - d1[1] * d2[0])
        if area2 == 0:
            continue
        is_front = (area2 < 0) if front_face == "ccw" else (area2 > 0)
        if cull_mode == "back" and not is_front:
            continue
        if cull_mode == "front" and is_front:
            continue
        if area2 < 0:  # winding normalization: interior = all E >= 0
            a, b, area2 = -a, -b, -area2
        bias = np.where((a < 0) | ((a == 0) & (b < 0)), np.int64(0), np.int64(-1))

        # Pixel bbox (pixel center px+0.5 covered iff px*16+8 within extent),
        # widened by the sample extent for multisampling (samples reach up
        # to |pad| subpixel units beyond the pixel center).
        pad = max(max(abs(dx), abs(dy)) for dx, dy in sample_offsets)
        x0 = max(0, -(-(int(xf.min()) - pad - HALF_PIXEL) // SUBPIXEL_SCALE))
        y0 = max(0, -(-(int(yf.min()) - pad - HALF_PIXEL) // SUBPIXEL_SCALE))
        x1 = min(width, (int(xf.max()) + pad - HALF_PIXEL) // SUBPIXEL_SCALE + 1)
        y1 = min(height, (int(yf.max()) + pad - HALF_PIXEL) // SUBPIXEL_SCALE + 1)
        if x1 <= x0 or y1 <= y0:
            continue

        inv_area = _recip_f32_exact(_i64_pair_to_f32(area2))

        # Integer quantized-depth plane (see ops/fixedpoint.py spec).
        zq = np.clip(
            np.rint(ndc_z * np.float32(1 << DEPTH_LSB_BITS)).astype(np.int64),
            -DEPTH_VERTEX_CLAMP,
            DEPTH_VERTEX_CLAMP,
        )
        num_x = a[1] * zq[0] + a[2] * zq[1] + a[0] * zq[2]  # exact int64
        num_y = b[1] * zq[0] + b[2] * zq[1] + b[0] * zq[2]
        gx = np.float32(_i64_pair_to_f32(num_x) * inv_area)
        gy = np.float32(_i64_pair_to_f32(num_y) * inv_area)
        # Adaptive exponent (zshift) from the slope's f32 biased exponent.
        slope = np.float32(max(abs(gx), abs(gy)) * np.float32(SUBPIXEL_SCALE))
        eb = int(slope.view(np.int32) >> 23) & 0xFF
        zshift = int(np.clip(eb - 141, 0, 24))
        unit_scale = np.int32((133 - zshift) << 23).view(np.float32)
        gclamp = np.float32(DEPTH_GRAD_CLAMP)
        gx16 = np.float32(gx * np.float32(SUBPIXEL_SCALE))
        gy16 = np.float32(gy * np.float32(SUBPIXEL_SCALE))
        dzdx_q = np.int64(np.rint(np.clip(np.float32(gx16 * unit_scale), -gclamp, gclamp)))
        dzdy_q = np.int64(np.rint(np.clip(np.float32(gy16 * unit_scale), -gclamp, gclamp)))

        if depth_bias is not None:
            # Mirror of ops/setup.py: o = rint(slope * m) + rint(constant)
            # in quantized-LSB units, bounded by the bias clamp; single f32
            # multiply, then integer arithmetic only.
            bias_c, bias_s, bias_cl = depth_bias
            blim = np.float32(1 << 29)
            m_slope = np.float32(max(abs(gx16), abs(gy16)))
            o = int(
                np.rint(np.clip(np.float32(m_slope * np.float32(bias_s)), -blim, blim))
            ) + int(round(float(bias_c)))
            if bias_cl > 0:
                o = min(o, int(round(float(bias_cl) * (1 << DEPTH_LSB_BITS))))
            elif bias_cl < 0:
                o = max(o, int(round(float(bias_cl) * (1 << DEPTH_LSB_BITS))))
            zq = np.clip(zq + np.int64(o), -DEPTH_VERTEX_CLAMP, DEPTH_VERTEX_CLAMP)

        # Exact per-pixel edge values over the bbox: e[i] has shape (bh, bw).
        px = np.arange(x0, x1, dtype=np.int64) * SUBPIXEL_SCALE + HALF_PIXEL
        py = np.arange(y0, y1, dtype=np.int64) * SUBPIXEL_SCALE + HALF_PIXEL
        dx = px[None, :] - xf[:, None]  # (3, bw)
        dy = py[None, :] - yf[:, None]  # (3, bh)
        e = a[:, None, None] * dx[:, None, :] + b[:, None, None] * dy[:, :, None]
        # Per-sample coverage: step the exact pixel-center edge values by
        # the sample offsets (ddx, ddy), still exact int64.
        covered_s = np.stack(
            [
                np.all(
                    e
                    + (a * np.int64(ddx) + b * np.int64(ddy))[:, None, None]
                    + bias[:, None, None]
                    >= 0,
                    axis=0,
                )
                for ddx, ddy in sample_offsets
            ]
        )  # (S, bh, bw)
        if not covered_s.any():
            continue

        # Per-pixel quantized depth from canonical 128-px tile anchors.
        pxs = np.arange(x0, x1, dtype=np.int64)
        pys = np.arange(y0, y1, dtype=np.int64)
        anchor_x = (pxs // DEPTH_TILE) * DEPTH_TILE
        anchor_y = (pys // DEPTH_TILE) * DEPTH_TILE
        lim = np.float32(1 << 30)
        ax_fp = anchor_x * SUBPIXEL_SCALE + HALF_PIXEL
        ay_fp = anchor_y * SUBPIXEL_SCALE + HALF_PIXEL
        dxf = (ax_fp - xf[0]).astype(np.float32)
        dyf = (ay_fp - yf[0]).astype(np.float32)
        tx = np.rint(np.clip(np.float32(gx * dxf) * unit_scale, -lim, lim)).astype(np.int64)
        ty = np.rint(np.clip(np.float32(gy * dyf) * unit_scale, -lim, lim)).astype(np.int64)
        mid_u = np.int64((1 << 29) >> zshift)
        base = (int(zq[0]) >> max(0, zshift - DEPTH_FRAC_BITS)) * (
            1 << max(0, DEPTH_FRAC_BITS - zshift)
        ) - mid_u
        zt = np.int64(base) + tx[None, :] + ty[:, None]
        clampv = mid_u + np.int64(1 << 29)
        z_tile = np.clip(zt, -clampv, clampv)
        z_u = (
            z_tile
            + dzdx_q * (pxs - anchor_x)[None, :]
            + dzdy_q * (pys - anchor_y)[:, None]
        )
        hi_c = mid_u + 1
        # Barycentrics at the pixel CENTER (attribute interpolation inputs;
        # not part of the bit-identity contract but computed with the same
        # deterministic formula as the device path).  MSAA semantics: every
        # sample a fragment wins shades with pixel-center attributes.
        e_f = _i64_pair_to_f32(e)
        b0 = e_f[1] * inv_area
        b1 = e_f[2] * inv_area
        b2 = e_f[0] * inv_area
        bary_t = np.stack([b0, b1, b2], axis=-1)

        for s, (ddx, ddy) in enumerate(sample_offsets):
            # Per-sample quantized depth (spec: ops/fixedpoint.py MSAA
            # proof extension — arithmetic shift = floor).
            dz_s = (dzdx_q * np.int64(ddx) + dzdy_q * np.int64(ddy)) >> np.int64(4)
            zpix = ((np.clip(z_u + dz_s, -hi_c, hi_c) << zshift) + np.int64(1 << 29)).astype(
                np.int32
            )
            covered = covered_s[s]
            if depth_clip == "clamp":
                zpix = np.clip(zpix, 0, DEPTH_ONE_Q)
            elif depth_clip:
                covered = covered & (zpix >= 0) & (zpix <= DEPTH_ONE_Q)
            window_d = depth_buf[s, y0:y1, x0:x1]
            d_pass = cmp_fn(zpix, window_d) if depth_test else np.ones_like(covered)
            if use_stencil:
                # VkStencilOpState: test (ref & mask) OP (stencil & mask);
                # update op by fail / depth-fail / pass, under write_mask.
                window_s = stencil_buf[s, y0:y1, x0:x1]
                cm = np.int32(stencil.compare_mask)
                s_pass = _COMPARES[stencil.compare](
                    np.full_like(window_s, np.int32(stencil.ref) & cm), window_s & cm
                )
                nv = np.where(
                    s_pass,
                    np.where(
                        d_pass,
                        _stencil_apply_op(stencil.pass_op, window_s, stencil.ref),
                        _stencil_apply_op(stencil.depth_fail_op, window_s, stencil.ref),
                    ),
                    _stencil_apply_op(stencil.fail_op, window_s, stencil.ref),
                )
                wm = np.int32(stencil.write_mask)
                merged = (window_s & ~wm) | (nv & wm)
                window_s[covered] = merged[covered]
                passes = covered & s_pass & d_pass
            else:
                passes = covered & d_pass
            tri_id[s, y0:y1, x0:x1][passes] = t
            if depth_write:
                window_d[passes] = zpix[passes]
            bw = bary_buf[s, y0:y1, x0:x1]
            bw[passes] = bary_t[passes]

    out = {
        "tri_id": tri_id,
        "depth_q": depth_buf,
        "depth": depth_buf.astype(np.float32) * np.float32(1.0 / DEPTH_ONE_Q),
        "bary": bary_buf,
    }
    if use_stencil:
        out["stencil"] = stencil_buf
    return out
