"""Phong shading, tone mapping, and framebuffer composition.

Replaces the reference's shading/clear kernels (``TEST_Dungeonrun/
Camera.cu:12-87``) with fused elementwise jnp — XLA fuses the whole stage
into the surrounding computation, the analogue of "fused intersect+shade".

Semantics match ``color_cam_cuda`` (Camera.cu:19-69) with the constants
promoted to `PhongParams`:

  L        = normalize(light_pos - hit_point)
  dot_r_n  = L . N
  r        = (L - 2 dot_r_n N) * ray_dir      (componentwise product!)
  diffuse  = kd * |dot_r_n|
  spec     = ks * |sum(r)| ** exponent
  rgb      = tri_color * diffuse * light_color + light_color * spec
  tonemap: rgb / max(rgb) * 255 per pixel     (Camera.cu:56-59)
  miss pixels keep the background fill        (set_cam_cuda, Camera.cu:12-18)

Documented divergence: the reference computes dot_r_n with ``norm.x`` passed
twice (y component bug, Camera.cu:38). We use the correct dot product; see
SURVEY.md §7.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..models.scene import PhongParams
from . import vecmath


def phong_radiance(hit_point: jax.Array, normal: jax.Array,
                   ray_dir: jax.Array, tri_color: jax.Array,
                   params: PhongParams) -> jax.Array:
    """Per-pixel Phong radiance (R, 3). All inputs world-space (R, 3)."""
    l = vecmath.normalize(params.light_pos[None, :] - hit_point)
    dot_r_n = vecmath.dot(l, normal)                      # (R,)
    r = (l - 2.0 * dot_r_n[..., None] * normal) * ray_dir  # (R, 3)
    diffuse = params.diffuse * jnp.abs(dot_r_n)
    spec = params.specular * jnp.abs(jnp.sum(r, axis=-1)) ** params.exponent
    return (tri_color * diffuse[..., None] * params.light_color[None, :]
            + params.light_color[None, :] * spec[..., None])


def phong_radiance_c(hit_point, normal, ray_dir, tri_color,
                     params: PhongParams):
    """Componentized `phong_radiance`: hit_point/normal/ray_dir/tri_color
    are (px, py, pz)-style tuples of flat (R,) arrays and the return is a
    flat (rr, rg, rb) tuple: under jax.grad the residuals saved for the
    backward pass are exactly these intermediates, and the componentized
    form keeps every one a dense (R,) array."""
    px, py, pz = hit_point
    nx, ny, nz = normal
    dx, dy, dz = ray_dir
    cr, cg, cb = tri_color
    lx = params.light_pos[0] - px
    ly = params.light_pos[1] - py
    lz = params.light_pos[2] - pz
    inv_len = jax.lax.rsqrt(lx * lx + ly * ly + lz * lz)
    lx, ly, lz = lx * inv_len, ly * inv_len, lz * inv_len
    dot_r_n = lx * nx + ly * ny + lz * nz                    # (R,)
    rsum = ((lx - 2.0 * dot_r_n * nx) * dx
            + (ly - 2.0 * dot_r_n * ny) * dy
            + (lz - 2.0 * dot_r_n * nz) * dz)
    diffuse = params.diffuse * jnp.abs(dot_r_n)
    spec = params.specular * jnp.abs(rsum) ** params.exponent
    lc = params.light_color
    return (cr * diffuse * lc[0] + lc[0] * spec,
            cg * diffuse * lc[1] + lc[1] * spec,
            cb * diffuse * lc[2] + lc[2] * spec)


def tonemap_maxnorm(radiance: jax.Array) -> jax.Array:
    """Per-pixel max-channel normalize to [0, 1] (Camera.cu:56-59).

    Divides by the true peak whenever it is positive (reference semantics:
    the brightest channel of every hit pixel maps to 255, however dim);
    exactly-zero pixels stay zero instead of NaN."""
    peak = jnp.max(radiance, axis=-1, keepdims=True)
    return radiance / jnp.where(peak > 0, peak, 1.0)


def compose_framebuffer(radiance: jax.Array, hit_mask: jax.Array,
                        background_rgb) -> jax.Array:
    """uint8 (R, 3) image: tonemapped hits over a constant background fill.

    The reference achieves this with a clear kernel each frame
    (set_cam_cuda + SET_COLOR_TAG fallthrough, Camera.cu:77-84); here it is
    a single select.
    """
    # round, don't truncate: XLA lowers x/peak to x*(1/peak), so the peak
    # channel can land at 254.9999 — rounding restores the reference's
    # "max channel = 255" invariant (Camera.cu:56-59).
    shaded = jnp.clip(jnp.round(tonemap_maxnorm(radiance) * 255.0),
                      0.0, 255.0)
    bg = jnp.asarray(background_rgb, radiance.dtype)
    rgb = jnp.where(hit_mask[..., None], shaded, bg[None, :])
    return rgb.astype(jnp.uint8)


def pack_bgra(rgb_u8: jax.Array) -> jax.Array:
    """(R, 3) uint8 -> (R,) uint32 packed BGRA, the reference's framebuffer
    layout (Color.h:4-13: union over u32 with argb view; DIB blit at
    WinMain.cpp:217)."""
    r = rgb_u8[..., 0].astype(jnp.uint32)
    g = rgb_u8[..., 1].astype(jnp.uint32)
    b = rgb_u8[..., 2].astype(jnp.uint32)
    return b | (g << 8) | (r << 16)
